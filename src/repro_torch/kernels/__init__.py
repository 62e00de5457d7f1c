"""Hopper kernels for the serving path, their plain versions, the device
dispatch, and the autotuner with its timer."""
