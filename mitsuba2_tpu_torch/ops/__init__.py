"""Hand-written CUDA kernels, their plain PyTorch twins and the build."""
