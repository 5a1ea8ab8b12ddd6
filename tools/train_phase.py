#!/usr/bin/env python3
"""Phase 23 of ``chip_smoke.py`` (training) alone, in a fresh process on one
GPU: (a) MiniCPM-2B at its published width and depth taking 8 AdamW steps
of 2 x 4096 tokens, (b) the width cut to 2 layers (remat, accumulation,
the fp32 step against the CPU, descent, a supervised restart) and (c)
``launch.train`` with ``--smoke``.

    PYTHONPATH=src python3 tools/train_phase.py [--profile]

Prints the phase's lines; exits 1 if a gate failed, 2 without a CUDA
device.  No kernel is built: no TPU kernel lies on the training path.
``--profile`` instead profiles one step of (a), after two unprofiled
ones, and prints its wall ms, the card's busy share and the device ms by
kind of kernel (``torch.profiler``, CUDA activity).
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


# kinds of kernel, by a part of the kernel's name, in the order they are tried
KINDS = (("gemm", ("gemm", "xmma", "cutlass", "sm90_", "nvjet")),
         ("softmax", ("softmax", "SoftMax")), ("fill", ("FillFunctor",)),
         ("reduce", ("reduce",)), ("index", ("index", "scatter", "gather")),
         ("copy", ("copy", "cat", "Cat")), ("elementwise", ("elementwise", "vectorized")))


def profile_step(torch, card) -> None:
    """One profiled step of phase 23 (a): its device ms by kind of kernel."""
    import chip_smoke as cs
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticTokens, make_batch_fn
    from repro_torch.models.registry import build_model
    from repro_torch.train import init_train_state, make_optimizer, make_train_step
    from repro_torch.train.optimizer import cosine_schedule

    cfg = get_config(cs.TRAIN[0])
    model = build_model(cfg)
    opt = make_optimizer("adamw", cosine_schedule(*cs.TRAIN_LR))
    state = init_train_state(model, opt, torch.Generator(device="cuda").manual_seed(0))
    step = make_train_step(model, opt, accum_steps=cs.TRAIN_ACCUM)
    batches = make_batch_fn(SyntheticTokens(cfg.vocab_size, cs.TRAIN_SEQ, cs.TRAIN_BATCH,
                                            seed=cs.SEED))
    for s in range(2):
        state, metrics = step(state, batches(s))
        float(metrics["loss"])
    batch = batches(2)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(8):  # the first records of a session can go missing
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        float(metrics["loss"])
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"
               and e.time_range.start >= 0 and "sleep" not in e.name]
    by_kind: dict = {}
    for e in kernels:
        kind = next((k for k, parts in KINDS if any(p in e.name for p in parts)), "other")
        ms, n = by_kind.get(kind, (0.0, 0))
        by_kind[kind] = (ms + e.self_device_time_total / 1e3, n + 1)
    busy = sum(ms for ms, _ in by_kind.values())
    top = sorted(by_kind.items(), key=lambda kv: -kv[1][0])
    print(f"[train-profile] one step of {cs.TRAIN_BATCH} x {cs.TRAIN_SEQ} tokens ({card}): wall "
          f"{wall_ms:.1f} ms, device {busy:.1f} ms in {len(kernels)} kernels, idle "
          f"{1 - busy / wall_ms:.3f}; by kind (ms, kernels): "
          + ", ".join(f"{k} {ms:.1f} ({n})" for k, (ms, n) in top), flush=True)
    names: dict = {}
    for e in kernels:
        names[e.name[:90]] = names.get(e.name[:90], 0.0) + e.self_device_time_total / 1e3
    for name, ms in sorted(names.items(), key=lambda kv: -kv[1])[:12]:
        print(f"[train-profile]   {ms:9.1f} ms  {name}", flush=True)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("train_phase: no CUDA device is available", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="profile one step of (a) instead of running the phase")
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke

    card = chip_smoke.card_line()
    print(card, flush=True)
    t = [time.perf_counter()]

    def phase_s() -> float:
        now = time.perf_counter()
        out, t[0] = now - t[0], now
        return out

    try:
        if args.profile:
            profile_step(torch, card)
        else:
            chip_smoke.train_phase(torch, np, torch.device("cuda"), card, phase_s)
    except Exception:
        import traceback

        traceback.print_exc()
        print("phase 23 failed", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
