"""The port's kernels: each hand-written CUDA kernel's wrapper sits beside
its plain PyTorch version (CPU tensors take the plain version, CUDA tensors
the kernel), plus the plain matmul-form DFT helpers."""
