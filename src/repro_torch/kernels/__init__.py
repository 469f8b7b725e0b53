"""The CUDA kernels of the build-and-search path and their plain
PyTorch versions."""
