"""PyTorch/CUDA port of tetris_piclim_tpu for NVIDIA Hopper GPUs.

Plain tensor code is PyTorch; the two kernels the JAX package wrote in
Pallas are CUDA C++ (``csrc/``), built with nvcc at first use and bound
with ctypes (``ops/_build.py``). Every kernel has a plain PyTorch version
beside it, which the CPU runs and the tests hold against the JAX package.
This package imports neither jax nor ``tetris_piclim_tpu``.
"""
