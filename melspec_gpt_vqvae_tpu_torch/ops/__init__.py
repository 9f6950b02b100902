"""Plain PyTorch ops and the wrappers of the Hopper kernels."""
