"""Hand-written Hopper kernels of the port (CUDA C++ in ``csrc/``, built by
:mod:`._build`), each beside its plain PyTorch version.

A wrapper runs the plain version only for tensors on the CPU; for CUDA
tensors it launches its kernel or raises. There is no flag and no fallback
between the two.
"""
