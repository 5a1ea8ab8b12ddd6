"""Production mesh construction.

Single pod: 16 x 16 = 256 devices, axes (data, model).
Multi-pod:  2 x 16 x 16 = 512 devices, axes (pod, data, model).

A FUNCTION, not a module-level constant.  The meshes are
single-controller meshes (``core.distributed.Mesh``): one process drives
every entry, and entries may repeat.  Their devices are the CUDA devices,
cycled over the grid, unless the caller names one: the dry run passes
``device="meta"`` (shapes only, nothing allocated), the tests
``device="cpu"``.
"""

from __future__ import annotations

import torch

from ..core.distributed import make_mesh

__all__ = ["make_production_mesh", "make_local_mesh"]


def _grid(shape, axes, device):
    n = 1
    for s in shape:
        n *= s
    return make_mesh(shape, axes, devices=None if device is None else [device] * n)


def make_production_mesh(*, multi_pod: bool = False, device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _grid(shape, axes, device)


def make_local_mesh(multi_pod: bool = False, device=None):
    """Degenerate mesh over however many devices exist: every CUDA device
    by default, or one entry of ``device`` when named."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_local_mesh builds over the CUDA devices by default and "
                               "none is available; pass device='cpu'")
        n = torch.cuda.device_count()
    else:
        n = 1
    shape = (1, 1, n) if multi_pod else (1, n)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _grid(shape, axes, device)
