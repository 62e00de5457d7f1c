"""repro_torch: the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

Same module names as the JAX package, same tensor layouts at public
functions, and hand-written Hopper kernels (``csrc/``) for the attention
kernels on the serving path. The port imports neither JAX nor ``repro``.

float32 matrix products and convolutions run in full float32 on the card:
TF32 keeps about three decimal digits, which would miss the 2e-5 float32
parity tolerance against the JAX reference. Both switches are set here, at
package import, rather than relying on PyTorch's defaults (cuDNN's is on).
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
