"""The dense-family model on torch tensors: layers, attention, model assembly, and the JAX-params converter."""
