"""PyTorch/CUDA port of diffsplitting_tpu for NVIDIA Hopper (H100).

Modules mirror the JAX package's paths and names. The JAX package stays the
reference: every module here is held against its counterpart by a CPU test.
Plain tensor code is PyTorch; every Pallas kernel on a ported path is a
hand-written CUDA kernel under `csrc/`, built at first use by
`kernels/build.py`.

The package imports torch, numpy and the standard library only. It never
imports jax or diffsplitting_tpu.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
