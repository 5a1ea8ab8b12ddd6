#!/usr/bin/env python3
"""The LM phases of ``chip_smoke.py`` alone, in a fresh process on one GPU:
17 (kNN-LM serving with a full-width Yi-9B), 18 (the same with
Mamba2-1.3B), 19 (Arctic-480B at full width, 2 layers) and 20 (Hymba-1.5B
on the batch path).

    PYTHONPATH=src python3 tools/knnlm_phase.py [--phases 17 18 19 20] [--profile-first]

Builds the kernels, then runs each phase with its gates and prints its
lines and the kernel records (``<wrapper>@<tag>``).  A phase that fails
prints its error and the next one runs; the exit code is 1 if any failed.
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
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--phases", type=int, nargs="+", default=[17], choices=(17, 18, 19, 20))
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

    records, failed = [], []
    dev = torch.device("cuda")
    phases = {
        17: lambda: chip_smoke.knnlm_phase(torch, np, dev, card, kernels, wrappers, twins,
                                           records, phase_s),
        18: lambda: chip_smoke.knnlm_phase(torch, np, dev, card, kernels, wrappers, twins,
                                           records, phase_s, tag="mamba"),
        19: lambda: chip_smoke.arctic_phase(torch, np, dev, card, kernels, wrappers, twins,
                                            records, phase_s),
        20: lambda: chip_smoke.hybrid_phase(torch, np, dev, card, phase_s),
    }
    for n in args.phases:
        try:
            phases[n]()
        except Exception:
            traceback.print_exc()
            print(f"phase {n} failed", flush=True)
            failed.append(n)
            chip_smoke.free_card(torch)
        phase_s()
    print(json.dumps({"kernels": records}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
