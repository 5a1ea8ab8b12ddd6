"""Device resolution and fp32 matmul precision for the port's entry points."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

__all__ = ["resolve_device", "full_fp32", "as_tensor", "upload"]


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA device; anything else is taken as given.

    There is no silent CPU fallback: without CUDA, the caller must ask
    for ``device="cpu"`` explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on the CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


@contextlib.contextmanager
def full_fp32():
    """Run float32 matrix products in full float32 (TF32 off) inside the
    block, restoring the caller's setting after.  TF32 keeps ~3 decimal
    digits, which would move projections and distances away from the
    reference's float32 arithmetic."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def as_tensor(x, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    """A tensor or array-like as a ``dtype`` tensor on ``device``.  A
    read-only numpy array (for example a view of a JAX array) is copied
    first: torch does not take non-writable buffers."""
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()
    return torch.as_tensor(x, dtype=dtype).to(device)


def upload(x, device: torch.device) -> torch.Tensor:
    """A host array or CPU tensor on ``device`` without a host wait.

    On CUDA it goes through page-locked memory from torch's caching host
    allocator (a pinned tensor is used as it is) and is copied with
    ``non_blocking``: a copy from pageable memory synchronises the stream
    first, which would make the host wait for all the work queued before
    it.  The allocator keeps the pinned block until the copy is done.
    Elsewhere the tensor is moved as usual."""
    t = torch.as_tensor(x)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
