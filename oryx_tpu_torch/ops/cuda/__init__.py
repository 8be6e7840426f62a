"""Hand-written CUDA kernels, their wrappers and plain twins, and the
nvcc build that compiles them at first use."""
