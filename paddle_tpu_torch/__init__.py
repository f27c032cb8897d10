"""paddle_tpu_torch: the PyTorch + CUDA port of paddle_tpu for NVIDIA Hopper.

A second package beside the JAX one (which stays the reference). It never
imports jax or paddle_tpu. Entry points run on the CUDA card unless the
caller passes ``device="cpu"``; the hot kernels are written by hand for
Hopper (``csrc/``) and built at first use.
"""
from .device import resolve_device  # noqa: F401
from .framework.flags import define_flag, flag, get_flags, set_flags  # noqa: F401

__version__ = "0.1.0"
