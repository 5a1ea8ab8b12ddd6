#!/usr/bin/env python3
"""Phase 24 of ``chip_smoke.py`` (the mesh) alone, in a fresh process on one
GPU: (a) Arctic-480B at its width, 2 of 35 layers, expert-parallel on a
(data 2, model 4) mesh (drawn here: in ``chip_smoke.py`` the part runs on
phase 19's weights), (b) GPipe over the 'pod' axis with Yi-9B, 8 of 48
layers, (c) MiniCPM-2B, 20 of 40 layers, through the int8 error-feedback
exchange across two pods, and (d) the dry run's cells on the meta device.
Every mesh is a single-controller mesh over the card.

    PYTHONPATH=src python3 tools/mesh_phase.py [--parts abcd]

Prints the phase's lines; exits 1 if a gate failed, 2 without a CUDA
device.  No kernel is built: no TPU kernel lies on these paths.
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> int:
    # a fixed cuBLAS workspace before torch starts cuBLAS (see train_step)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("mesh_phase: no CUDA device is available", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--parts", default="abcd", help="the parts of phase 24 to run")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs

    card = cs.card_line()
    print(card, flush=True)
    dev = torch.device("cuda")
    t = [time.perf_counter()]

    def phase_s() -> float:
        now = time.perf_counter()
        out, t[0] = now - t[0], now
        return out

    try:
        if "a" in args.parts:
            arch, width, n_layers, _ = cs.ARCTIC
            arctic = cs.lm_model(torch, dev, "arctic", arch, width, n_layers)
            cs.mesh_ep(torch, np, dev, card, arctic, phase_s)
            del arctic
            cs.free_card(torch)
        cs.mesh_phase(torch, np, dev, card, phase_s, parts=args.parts)
    except Exception:
        import traceback

        traceback.print_exc()
        print("phase 24 failed", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
