"""repro_torch: DB-LSH (Tian, Zhao, Zhou — ICDE 2022) on PyTorch and CUDA.

The PyTorch port of the ``repro`` package.  Module names mirror
``repro`` so that each counterpart is easy to find; the port imports
neither JAX nor anything of ``repro``.  Entry points run on the CUDA
device unless the caller passes ``device="cpu"``; without a CUDA device
and without an explicit device they raise.
"""

from .device import full_fp32, resolve_device

__version__ = "0.1.0"

__all__ = ["full_fp32", "resolve_device"]
