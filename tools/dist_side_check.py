#!/usr/bin/env python3
"""Side check of the pool kernels B4/B5 (``csrc/dist.cu``) on one GPU:
this tree's kernels against another version of the same source.

    PYTHONPATH=src python3 tools/dist_side_check.py --against DIR [--turns N]

DIR is the root of another checkout of the repository (for example an
earlier commit unpacked from ``git archive``); its
``src/repro_torch/kernels/csrc/dist.cu`` is built beside this tree's
library, into ``build/dist_side_check/``.

Inputs: ``chip_smoke.main_workload`` (n = 1,000,000, d = 64, K = 10,
L = 5, B = 64, M = 5) from the script's seed, and, at Q = 64 and 1024 in
the norm and exact forms, the B4/B5 calls of ``chip_smoke.pool_inputs``
(phase 9's inputs).  For each kernel, batch and form: the d2 and hw of the
other library must be ``torch.equal`` to this tree's wrapper (the run
fails otherwise); device µs (the profiler's, as ``chip_smoke.device_us``)
in turns — the other version, this tree, this tree, the other version;
the host µs of one call (``chip_smoke.host_us``) through this tree's
wrapper and through the bare ctypes launch of each library (the outputs,
q2 and the launch, no checks), which splits the wrapper's host time into
its checks and the launch.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

OUT = ROOT / "build" / "dist_side_check"


def compile_other(src_dir: Path):
    """The other tree's dist.cu as a ctypes library."""
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    so = OUT / "other.so"
    proc = subprocess.run([_build._nvcc(), *_build._FLAGS, "-shared", "-o", str(so),
                           str(src_dir / "dist.cu")], capture_output=True, text=True)
    out = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise SystemExit(f"the other dist.cu: nvcc failed\n{out}")
    regs = [ln.strip() for ln in out.splitlines() if "registers" in ln or "stack" in ln]
    print(f"[side] built the other dist.cu in {time.perf_counter() - t0:.1f} s: "
          f"{' | '.join(regs)}", flush=True)
    lib = ctypes.CDLL(str(so))
    for fn in ("window_dist_launch", "candidate_dist_launch"):
        getattr(lib, fn).argtypes, getattr(lib, fn).restype = _build._SIGNATURES[fn]
    return lib


def run(torch, lib, name: str, a: tuple, k: dict):
    """One launch of ``name`` from ``lib`` on the captured call (a, k), with
    the outputs and q2 as the wrapper makes them."""
    q = a[-1]
    Qn = q.shape[0]
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in a]
    q2 = torch.sum(torch.square(q), dim=-1)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    exact = int(k.get("exact", False))
    if name == "window_dist":
        blk, proj, vec = a[:3]
        lnb, B, K = proj.shape
        S, L = blk.shape[1], a[4].shape[1]
        d2 = torch.empty((Qn, S * B), device=q.device)
        hw = torch.empty_like(d2)
        err = lib.window_dist_launch(*ptrs, ctypes.c_void_p(q2.data_ptr()),
                                     ctypes.c_void_p(d2.data_ptr()),
                                     ctypes.c_void_p(hw.data_ptr()), Qn, S, k["M"], lnb, B,
                                     K, vec.shape[-1], L, exact, stream)
    else:
        cp, cv = a[:2]
        _, L, Ct, K = cp.shape
        d2 = torch.empty((Qn, L * Ct), device=q.device)
        hw = torch.empty_like(d2)
        err = lib.candidate_dist_launch(*ptrs, ctypes.c_void_p(q2.data_ptr()),
                                        ctypes.c_void_p(d2.data_ptr()),
                                        ctypes.c_void_p(hw.data_ptr()), Qn, L, Ct, K,
                                        cv.shape[-1], exact, stream)
    if err != 0:
        raise SystemExit(f"{name}: CUDA error {err}")
    return d2, hw


def main() -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", type=Path, required=True,
                    help="root of another checkout whose dist.cu is compared")
    ap.add_argument("--turns", type=int, default=2, help="timing turns (each runs both ways)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dist_side_check: no CUDA device is available", file=sys.stderr)
        return 2

    import chip_smoke as cs
    from repro_torch import kernels
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(cs.card_line(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    libs = {"this": _build.load(),
            "other": compile_other(args.against.resolve() / "src" / "repro_torch" / "kernels"
                                   / "csrc")}

    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    _, queries, _, index = cs.main_workload(gen, dev)
    kw = dict(k=cs.K_NN, r0=cs.R0, steps=cs.STEPS, with_stats=True, device=dev)
    wrappers = {n: getattr(kernels, n) for n in (*cs.POOL, "fused_window_search")}
    failed = []
    for Qn, exact in itertools.product((cs.N_QUERIES, cs.N_QUERIES_LARGE), (False, True)):
        form = "exact" if exact else "norm"
        _, calls = cs.pool_inputs(kernels, wrappers, index, queries[:Qn].contiguous(), exact,
                                  kw)
        for name, (a, k) in calls.items():
            new = wrappers[name](*a, **k)
            old = run(torch, libs["other"], name, a, k)
            torch.cuda.synchronize()
            equal = torch.equal(old[0], new[0]) and torch.equal(old[1], new[1])
            fns = {"other": lambda: run(torch, libs["other"], name, a, k),
                   "this": lambda: wrappers[name](*a, **k)}
            times = {v: [] for v in fns}
            for _ in range(args.turns):
                for v in ("other", "this", "this", "other"):
                    times[v].append(cs.device_us(torch, fns[v], f"{name}_kernel", calls=20)[0])
            host = {"wrapper": cs.host_us(torch, fns["this"]),
                    **{f"launch[{v}]": cs.host_us(torch, lambda lib=lib: run(torch, lib, name,
                                                                             a, k))
                       for v, lib in libs.items()}}
            in_b, out_b, _, _ = cs.work(torch, name, a, k)
            bound = (in_b + out_b) / cs.HBM_BYTES_PER_S * 1e6
            means = {v: round(statistics.mean(t), 2) for v, t in times.items()}
            turns = {v: [round(x, 2) for x in t] for v, t in times.items()}
            print(f"[side] {name}@{Qn} {form}: torch.equal to the other {equal}; device us "
                  f"mean {means}, per turn {turns}; "
                  f"bound {bound:.2f} us; host us/call "
                  f"{({v: round(h, 1) for v, h in host.items()})}", flush=True)
            if not equal:
                failed.append(f"{name}@{Qn} {form}")
    if failed:
        print(f"[side] not torch.equal: {failed}", flush=True)
        return 1
    print("[side] ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
