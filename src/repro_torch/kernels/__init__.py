"""Hopper kernels for the serving path, their plain versions, and the device dispatch."""
