"""Hand-written CUDA kernels for the hot solver paths.

Each kernel module holds the ctypes wrapper, a launch counter and the plain
PyTorch version of the same function.  A wrapper takes the plain version
only for CPU tensors; for CUDA tensors it launches its kernel or raises.
The sources live in `csrc/` and build at first use (`_build.py`).
"""
