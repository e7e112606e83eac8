"""PyTorch port of the V1T framework for NVIDIA Hopper GPUs.

The JAX package ``v1t_tpu`` is the reference; this package imports nothing
from it. Every Pallas kernel on the serving path has a hand-written CUDA
counterpart under ``csrc/``, built with ``nvcc`` at first use
(``v1t_tpu_torch/_build.py``) and bound with ``ctypes``; beside each one sits
a plain PyTorch version that CPU tensors take.
"""
