"""Hand-written CUDA kernels (``csrc/``) with their plain PyTorch versions.

The build module ``_build`` is imported lazily by the CUDA branches only.
"""
