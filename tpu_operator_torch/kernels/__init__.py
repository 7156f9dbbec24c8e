"""Hand-written CUDA kernels for Hopper, each beside its plain PyTorch
version.  A wrapper runs the plain version only for a tensor on the CPU; for
a CUDA tensor it launches its kernel or raises."""
