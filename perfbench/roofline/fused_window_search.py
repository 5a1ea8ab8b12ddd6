"""Work of one launch of kernel B1 (``repro_torch.kernels.fused_window_search``;
the CUDA symbol ``fused_window_search_kernel``), as ``chip_smoke.py``'s
``work()`` counts it: each input byte read once -- of the blocks only the
rows of the distinct valid blocks the launch selects -- and each output
byte written once.  Operations per admitted-or-not slot: ``3K`` for its
window halfwidth, ``2d`` for the norm-form dot and ``steps`` compares, in
float32 (the quantized modes: the ``2d`` at the card's bf16 / int8 rate)."""

from __future__ import annotations

import torch

WRAPPER = "fused_window_search"
KERNEL = "fused_window_search_kernel"
_XBYTES = {"bf16": 2, "int8": 1}
_RATE = {"bf16": "bf16_flops", "int8": "int8_ops"}  # keys of perfbench/peaks.py


def record(args: tuple, kwargs: dict) -> dict:
    """What ``work`` needs of one call, kept while the window runs (a
    reference to the block ids; nothing is computed on the card)."""
    blk, halves, proj, x = args[0], args[1], args[2], args[3]
    g, q = args[6], args[7]
    return {"blk": blk, "lnb": proj.shape[0], "B": proj.shape[1], "K": g.shape[-1],
            "d": q.shape[-1], "Q": q.shape[0], "steps": halves.shape[0], "ks": kwargs["ks"],
            "mode": kwargs.get("mode", "norm"), "small": (halves.numel() + g.numel()
                                                         + q.numel()) * 4}


def work(rec: dict) -> tuple[int, int, dict]:
    """(input bytes, output bytes, operations by rate) of one launch."""
    blk, lnb, B, K, d = rec["blk"], rec["lnb"], rec["B"], rec["K"], rec["d"]
    mode = rec["mode"]
    valid = blk[(blk >= 0) & (blk < lnb)]
    rows = int(torch.unique(valid).numel()) * B
    slots = int(valid.numel()) * B
    xbytes = _XBYTES.get(mode, 4)
    scale = 4 if mode in _XBYTES else 0
    in_bytes = blk.numel() * 4 + rows * ((K + 2) * 4 + d * xbytes + scale) + rec["small"]
    out_bytes = rec["Q"] * rec["steps"] * (rec["ks"] * 8 + 4)
    dot = slots * 2 * d
    rest = slots * (3 * K + rec["steps"])
    if mode in _XBYTES:
        return in_bytes, out_bytes, {"fp32_flops": rest, _RATE[mode]: dot}
    return in_bytes, out_bytes, {"fp32_flops": rest + dot}
