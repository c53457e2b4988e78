"""dsdiff_torch: the PyTorch / CUDA port of the JAX package, for NVIDIA Hopper.

Each module mirrors one module of the JAX package (same names, same public
layouts: NHWC images, ``[B, N, heads, D]`` attention). The hot kernels are
written by hand for ``sm_90a`` under ``ops/csrc/`` and built with ``nvcc`` at
first use; on CPU tensors every op runs its plain PyTorch version.
"""
