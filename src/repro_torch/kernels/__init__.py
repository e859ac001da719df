"""Hand-written CUDA kernels (`csrc/`) with their plain PyTorch versions.

`ops` is the public layer: it launches a kernel for CUDA tensors and
runs the plain version for CPU tensors. Modules import nothing from
CUDA at import time; the kernels are built by `nvcc` at first launch.
"""
