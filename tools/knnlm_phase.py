#!/usr/bin/env python3
"""Phase 17 of ``chip_smoke.py`` (kNN-LM serving with a full-width Yi-9B)
alone, in a fresh process on one GPU.

    PYTHONPATH=src python3 tools/knnlm_phase.py [--profile-first]

Builds the kernels, then runs ``chip_smoke.knnlm_phase`` with its gates
and prints its lines and the two kernel records (``<wrapper>@knnlm``).
In ``chip_smoke.py`` the phase runs after sixteen others, some of which
open ``torch.profiler`` sessions with CUDA activity; ``--profile-first``
opens one such session (a few spin kernels) before the phase, so that
the decode-step times of the two starts can be compared.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile-first", action="store_true",
                    help="open a torch.profiler session with CUDA activity first")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("knnlm_phase: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke
    from repro_torch import kernels
    from repro_torch.kernels import _build, ref

    _build.build()
    _build.load()
    card = chip_smoke.card_line()
    print(card, flush=True)
    if args.profile_first:
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
            for _ in range(8):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        print("[knnlm] a profiler session with CUDA activity ran first", flush=True)
    wrappers = {n: getattr(kernels, n) for n in chip_smoke.KERNELS}
    twins = {n: getattr(ref, f"{n}_ref") for n in chip_smoke.KERNELS}
    t = [time.perf_counter()]

    def phase_s() -> float:
        now = time.perf_counter()
        out, t[0] = now - t[0], now
        return out

    records = []
    chip_smoke.knnlm_phase(torch, np, torch.device("cuda"), card, kernels, wrappers, twins,
                           records, phase_s)
    print(json.dumps({"kernels": records}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
