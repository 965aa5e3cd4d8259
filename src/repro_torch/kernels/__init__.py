"""Hand-written CUDA kernels, their build, wrappers and plain PyTorch versions."""
