"""Hand-written CUDA kernels: each wrapper launches its kernel on CUDA
tensors and runs its plain PyTorch version on CPU tensors."""
