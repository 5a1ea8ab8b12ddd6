#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing a line (with its seconds) when it passes:

1. build       — compiles the CUDA kernels from
                 ``src/repro_torch/kernels/csrc`` (one nvcc per source, in
                 parallel) and prints the build time and the card;
2. twins       — holds each kernel against its plain PyTorch twin on the
                 same CUDA tensors: B1/B2 at the shapes of
                 tests/test_kernels.py (invalid block ids, steps 1/4/8,
                 modes norm/exact, ragged Ct) and at ks = 50; B6/B7 at
                 C in {64, 256, 100, 32} (odd d, k == C), the dedup and
                 all-masked cases, invalid block ids and M == nb;
3. main        — the repo's large search workload (BENCH_search_hotpath_large:
                 n = 1,000,000, d = 64, K = 10, L = 5, B = 64, M = 5, 64
                 queries, steps = 8, r0 = 0.5) through the one-pass
                 ``search_batch_fixed`` with engines torch, kernel and
                 inline; checks that B1/B2 ran, that the kernel engines
                 return the torch engine's id sets (all of them with
                 exact=True, >= 98 % in norm form), recall@10 >= 0.5 against
                 brute force, and each kernel against its twin on the inputs
                 the main path gave it;
4. multipass   — the same workload through the multi-pass oracle
                 ``search_batch_fixed_ref``, all three engines: B6 (inline)
                 and B7 (kernel) launch L·steps = 40 times per search,
                 recall@10 >= 0.5, the kernel engines' id sets equal the
                 torch engine's up to near-ties at the k-th distance, stats
                 equal across engines, and B6/B7 against their twins on the
                 path's own inputs;
5. oracle      — a small index (n = 2048, d = 24, K = 8, L = 3, max_blocks
                 == nb): one-pass exact=True equals the multi-pass oracle
                 bit for bit on the kernel and inline engines, at steps
                 1/4/8; on the torch engine, equal id sets and distances
                 within 2 float32 ulps (and whether it is bit-equal);
6. termination — on the main workload, each engine: C2-only termination
                 (early exit on and off) bit-equal to the fixed schedule,
                 stats included; the default Termination() runs no more
                 steps and fetches no more candidates; explain's step slots
                 sum to the candidates; the dispatch handle's result is
                 bit-equal to the synchronous call;
7. times       — median CUDA-event times of each kernel and its twin at the
                 shapes its path gives it, beside the least time the card
                 could take; median wall times of the one-pass search, the
                 multi-pass search and the one-pass search under
                 Termination(), per engine, at 64 and 1024 queries;
8. profile     — one one-pass and one multi-pass search per engine and
                 batch under torch.profiler: device busy time against the
                 wall time, device ops, device time per one-pass stage
                 (project, select, verify, merge) and the top device ops.

Any failure raises, and the run exits non-zero.  The last three lines are
the card's name and power limit as nvidia-smi reports them, the kernels'
JSON record, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

SEED = 7
N, D, N_QUERIES, N_QUERIES_LARGE = 1_000_000, 64, 64, 1024
K_NN, STEPS, R0 = 10, 8, 0.5
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
KERNELS = {  # wrapper -> (source, the TPU kernel it replaces)
    "fused_window_search": ("src/repro_torch/kernels/csrc/fused_search.cu",
                            "src/repro/kernels/window_verify.py:328"),
    "fused_cand_search": ("src/repro_torch/kernels/csrc/fused_search.cu",
                          "src/repro/kernels/window_verify.py:374"),
    "window_verify": ("src/repro_torch/kernels/csrc/window_verify.cu",
                      "src/repro/kernels/window_verify.py:143"),
    "candidate_verify": ("src/repro_torch/kernels/csrc/window_verify.cu",
                         "src/repro/kernels/window_verify.py:113"),
}
FUSED = ("fused_window_search", "fused_cand_search")
VERIFY = ("window_verify", "candidate_verify")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke failed: {msg}")


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]


def bins_err(torch, got, want, atol: float = 1e-5, rtol: float = 1e-5,
             edge_ties: bool = False) -> float:
    """tests/test_kernels.py::_assert_bins_equal on the card: counts
    equal, distances within tolerance, id sets equal per finite (query,
    bin).  With ``edge_ties`` an id may differ where its distance lies
    within the tolerance of the bin's last kept distance (a near-tie at
    the ks cut).  Returns the largest distance difference."""
    gd, gi, gc = (x.cpu() for x in got)
    wd, wi, wc = (x.cpu() for x in want)
    check(torch.equal(gc, wc), "bin counts differ from the twin")
    fin = torch.isfinite(wd)
    check(torch.equal(fin, torch.isfinite(gd)), "filled bin slots differ from the twin")
    err = float((gd[fin] - wd[fin]).abs().max()) if fin.any() else 0.0
    check(torch.allclose(gd[fin], wd[fin], rtol=rtol, atol=atol),
          f"bin distances differ from the twin by {err} (rtol {rtol}, atol {atol})")
    check(torch.equal(gi[~fin], wi[~fin]), "unfilled bin ids differ from the twin")
    Qn, steps, _ = gd.shape
    for q in range(Qn):
        for j in range(steps):
            f = fin[q, j]
            a, b = set(gi[q, j][f].tolist()), set(wi[q, j][f].tolist())
            if a == b:
                continue
            check(edge_ties, f"bin ids differ from the twin at query {q}, bin {j}")
            edge = float(wd[q, j][f].max())
            dist = dict(zip(wi[q, j][f].tolist(), wd[q, j][f].tolist()))
            dist.update(zip(gi[q, j][f].tolist(), gd[q, j][f].tolist()))
            check(all(abs(dist[i] - edge) <= atol + rtol * edge for i in a ^ b),
                  f"bin ids differ from the twin at query {q}, bin {j}, off the ks edge")
    return err


def window_case(torch, gen, Q, L, M, nb, B, K, d, steps, dev):
    """tests/test_kernels.py::_mk_window on the card: each table holds each
    id at most once, ids >= n are +inf-padded slots, and block ids include
    the invalid sentinel L*nb."""
    lnb = L * nb
    n = lnb * B - 3
    data = torch.randn((n, d), generator=gen, device=dev)
    ids = torch.randperm(lnb * B, generator=gen, device=dev).reshape(lnb, B)
    valid = ids < n
    vec = torch.where(valid[..., None], data[ids.clamp(max=n - 1)], 0.0)
    nrm = torch.where(valid, (vec * vec).sum(-1), torch.inf)
    proj = torch.where(valid[..., None],
                       torch.randn((lnb, B, K), generator=gen, device=dev) * 2.0, torch.inf)
    blk = torch.randint(0, lnb + 1, (Q, L * M), generator=gen, device=dev)
    g = torch.randn((Q, L, K), generator=gen, device=dev)
    q = torch.randn((Q, d), generator=gen, device=dev)
    halves = torch.tensor([0.4 * 1.5 ** j for j in range(steps)], device=dev)
    args = (blk.int(), halves, proj.contiguous(), vec.contiguous(), nrm.contiguous(),
            ids.int(), g, q)
    return args, n


def cand_case(torch, gen, Q, L, Ct, K, d, steps, dev, n=4096):
    """tests/test_kernels.py's gathered inputs: every 7th slot invalid."""
    cp = torch.randn((Q, L, Ct, K), generator=gen, device=dev) * 2.0
    cx = torch.randn((Q, L, Ct, d), generator=gen, device=dev)
    cn = (cx * cx).sum(-1)
    ci = torch.randint(0, n, (Q, L, Ct), generator=gen, device=dev).int()
    cp[:, :, ::7, :] = torch.inf
    cn[:, :, ::7] = torch.inf
    g = torch.randn((Q, L, K), generator=gen, device=dev)
    q = torch.randn((Q, d), generator=gen, device=dev)
    halves = torch.tensor([0.4 * 1.5 ** j for j in range(steps)], device=dev)
    return (cp, cx, cn.contiguous(), ci, halves, g, q), n


def topk_err(torch, got, want, n: int, atol: float = 1e-5, rtol: float = 1e-5,
             edge_ties: bool = False) -> float:
    """tests/test_kernels.py::_assert_topk_equal on the card, for the
    per-radius verify kernels: filled slots equal, distances within
    tolerance, id sets equal per query, unfilled ids ``n``.  With
    ``edge_ties`` an id may differ where its distance lies within the
    tolerance of the query's last kept distance.  Returns the largest
    distance difference."""
    gd, gi = (x.cpu() for x in got)
    wd, wi = (x.cpu() for x in want)
    fin = torch.isfinite(wd)
    check(torch.equal(fin, torch.isfinite(gd)), "filled top-k slots differ from the twin")
    err = float((gd[fin] - wd[fin]).abs().max()) if fin.any() else 0.0
    check(torch.allclose(gd[fin], wd[fin], rtol=rtol, atol=atol),
          f"top-k distances differ from the twin by {err} (rtol {rtol}, atol {atol})")
    check(bool((gi[~fin] == n).all()) and bool((wi[~fin] == n).all()),
          "unfilled top-k ids are not n")
    for q in range(gd.shape[0]):
        f = fin[q]
        a, b = set(gi[q][f].tolist()), set(wi[q][f].tolist())
        if a == b:
            continue
        check(edge_ties, f"top-k ids differ from the twin at query {q}")
        edge = float(wd[q][f].max())
        dist = dict(zip(wi[q][f].tolist(), wd[q][f].tolist()))
        dist.update(zip(gi[q][f].tolist(), gd[q][f].tolist()))
        check(all(abs(dist[i] - edge) <= atol + rtol * edge for i in a ^ b),
              f"top-k ids differ from the twin at query {q}, off the k edge")
    return err


def verify_cand_case(torch, gen, Q, C, K, d, dev, n=1000):
    """tests/test_kernels.py::_mk_candidates on the card: ids in [0, n],
    so some slots carry the invalid id n."""
    cp = torch.randn((Q, C, K), generator=gen, device=dev) * 2.0
    cv = torch.randn((Q, C, d), generator=gen, device=dev)
    ci = torch.randint(0, n + 1, (Q, C), generator=gen, device=dev).int()
    g = torch.randn((Q, K), generator=gen, device=dev)
    q = torch.randn((Q, d), generator=gen, device=dev)
    return (cp, cv, ci, g, q), n


def verify_window_case(torch, gen, Q, M, nb, B, K, d, dev):
    """tests/test_kernels.py::test_window_verify_matches_ref's inputs on
    the card, with invalid block ids: the sentinel nb, -1 and 2^20."""
    n = nb * B - 3
    proj = torch.randn((nb, B, K), generator=gen, device=dev) * 2.0
    vec = torch.randn((nb, B, d), generator=gen, device=dev)
    ids = torch.randperm(nb * B, generator=gen, device=dev).reshape(nb, B).int()
    blk = torch.randint(0, nb + 1, (Q, M), generator=gen, device=dev).int()
    blk[0, -1] = -1
    blk[-1, 0] = 1 << 20
    g = torch.randn((Q, K), generator=gen, device=dev)
    q = torch.randn((Q, d), generator=gen, device=dev)
    return (blk, proj, vec, ids, g, q), n


def work(torch, name: str, a: tuple, k: dict):
    """(input bytes, output bytes, float32 operations) one call needs on
    these inputs: each input read once — for B1 and B6 only the rows of
    the distinct valid blocks they select — and each output written once.
    Operations per slot: 3K for hw, 2d for the norm-form dot (B1/B2, plus
    ``steps`` compares) or 3d for the diff form (B6/B7)."""
    if name in VERIFY:
        g, q = a[-3], a[-2]  # the last argument is the window width
        Qn, K, d = q.shape[0], g.shape[-1], q.shape[-1]
        small = (g.numel() + q.numel()) * 4
        out_bytes = Qn * k["k"] * 8
        if name == "window_verify":
            blk, proj = a[0], a[1]
            nb, B = proj.shape[0], proj.shape[1]
            valid = blk[(blk >= 0) & (blk < nb)]
            rows = int(torch.unique(valid).numel()) * B
            in_bytes = blk.numel() * 4 + rows * (K + d + 1) * 4 + small
            slots = int(valid.numel()) * B
        else:
            in_bytes = sum(t.numel() * 4 for t in a[:3]) + small
            slots = a[0].numel() // K
        return in_bytes, out_bytes, slots * (3 * K + 3 * d)
    window = name == "fused_window_search"
    halves, g, q = (a[1], a[6], a[7]) if window else (a[4], a[5], a[6])
    Qn, K, d, steps = q.shape[0], g.shape[-1], q.shape[-1], halves.shape[0]
    small = (halves.numel() + g.numel() + q.numel()) * 4
    out_bytes = Qn * steps * (k["ks"] * 8 + 4)
    if window:
        blk, proj = a[0], a[2]
        lnb, B = proj.shape[0], proj.shape[1]
        valid = blk[(blk >= 0) & (blk < lnb)]
        rows = int(torch.unique(valid).numel()) * B
        in_bytes = blk.numel() * 4 + rows * (K + d + 2) * 4 + small
        slots = int(valid.numel()) * B
    else:
        in_bytes = sum(t.numel() * 4 for t in a[:4]) + small
        slots = a[0].numel() // K
    return in_bytes, out_bytes, slots * (3 * K + 2 * d + steps)


def capture_calls(kernels, wrappers, name, fn):
    """Run ``fn`` with ``kernels.<name>`` wrapped so that the arguments of
    its last call are kept; returns them as (args, kwargs)."""
    captured = {}

    def wrapper(*a, **k):
        captured["call"] = (a, k)
        return wrappers[name](*a, **k)

    setattr(kernels, name, wrapper)
    try:
        fn()
    finally:
        setattr(kernels, name, wrappers[name])
    return captured["call"]


def idsets(torch, d, i):
    """Per query, the set of ids with a finite distance."""
    d, i = d.cpu(), i.cpu()
    return [set(i[q][torch.isfinite(d[q])].tolist()) for q in range(d.shape[0])]


def bit_equal(torch, a, b) -> bool:
    return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def cuda_ms(torch, fn, iters: int) -> float:
    """Median milliseconds of one call over ``iters`` calls, each timed by
    its own pair of CUDA events, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(iters)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(start.elapsed_time(end) for start, end in pairs)


def wall_ms(torch, fn, repeats: int) -> float:
    """Median wall milliseconds of a call that ends in a device sync."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the repro_torch package is missing under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch import kernels
    from repro_torch.core import (
        DBLSHParams,
        Termination,
        brute_force,
        build,
        search_batch_fixed,
        search_batch_fixed_dispatch,
        search_batch_fixed_ref,
    )
    from repro_torch.data import make_clustered, normalize_scale
    from repro_torch.kernels import _build, ref

    dev = torch.device("cuda")
    wrappers = {name: getattr(kernels, name) for name in KERNELS}
    twins = {name: getattr(ref, f"{name}_ref") for name in KERNELS}
    max_err = {name: 0.0 for name in KERNELS}
    engines = ("torch", "kernel", "inline")
    t_phase = time.perf_counter()

    def phase_s() -> float:
        nonlocal t_phase
        now = time.perf_counter()
        out, t_phase = now - t_phase, now
        return out

    # ------------------------------------------------------------ 1. build
    card = card_line()
    t0 = time.perf_counter()
    so = _build.build()
    _build.load()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in so.with_suffix(".log").read_text().splitlines()
             if "registers" in ln or "spill" in ln]
    print(f"[build] ok: {so.name} in {build_s:.1f} s; ptxas: {' | '.join(ptxas)}")
    print(card)
    print(f"[build] torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)} ({phase_s():.1f} s)", flush=True)

    # ------------------------------------------------ 2. kernels vs twins
    gen = torch.Generator(device=dev).manual_seed(SEED)
    n_cases = 0
    window_shapes = [(2, 2, 4, 8, 32, 4, 16, 5), (1, 3, 8, 8, 64, 12, 96, 20),
                     (8, 3, 8, 8, 64, 12, 24, 50)]
    for Q, L, M, nb, B, K, d, ks in window_shapes:
        for steps in (1, 4, 8):
            for mode in ("norm", "exact"):
                args, n = window_case(torch, gen, Q, L, M, nb, B, K, d, steps, dev)
                got = kernels.fused_window_search(*args, M=M, ks=ks, n=n, mode=mode)
                torch.cuda.synchronize()
                want = ref.fused_window_search_ref(*args, M=M, ks=ks, n=n, mode=mode)
                err = bins_err(torch, got, want)
                max_err["fused_window_search"] = max(max_err["fused_window_search"], err)
                n_cases += 1
    cand_shapes = [(2, 3, 64, 4, 16, 5), (1, 2, 300, 12, 96, 20), (4, 3, 320, 10, 24, 50)]
    for Q, L, Ct, K, d, ks in cand_shapes:
        for steps in (1, 6):
            for mode in ("norm", "exact"):
                args, n = cand_case(torch, gen, Q, L, Ct, K, d, steps, dev)
                got = kernels.fused_cand_search(*args, ks=ks, n=n, mode=mode)
                torch.cuda.synchronize()
                want = ref.fused_cand_search_ref(*args, ks=ks, n=n, mode=mode)
                err = bins_err(torch, got, want)
                max_err["fused_cand_search"] = max(max_err["fused_cand_search"], err)
                n_cases += 1

    def verify_vs_twin(name, args, w, n, k):
        got = wrappers[name](*args, w, n=n, k=k)
        torch.cuda.synchronize()
        err = topk_err(torch, got, twins[name](*args, w, n=n, k=k), n)
        max_err[name] = max(max_err[name], err)
        return got

    # tests/test_kernels.py:55-113: C in {64, 256, 100, 32}, odd d, k == C
    for Q, C, K, d, k in ((1, 64, 4, 16, 5), (3, 256, 12, 128, 50), (2, 100, 8, 33, 10),
                          (4, 32, 2, 8, 32)):
        args, n = verify_cand_case(torch, gen, Q, C, K, d, dev)
        for w in (2.5, 1e6):
            verify_vs_twin("candidate_verify", args, w, n, k)
            n_cases += 1
    # dedup: one candidate repeated 8x in the window; all masked: far boxes
    (cp, cv, ci, g, q), n = verify_cand_case(torch, gen, 1, 64, 4, 16, dev, n=100)
    ci[ci == 7] = 8
    cp[:, :8] = g[:, None, :]
    cv[:, :8] = 0.5
    ci[:, :8] = 7
    dd, di = verify_vs_twin("candidate_verify", (cp, cv, ci, g, q), 100.0, n, 64)
    check(int((di[0][torch.isfinite(dd[0])] == 7).sum()) == 1, "B7 kept a duplicate")
    (cp, cv, ci, g, q), n = verify_cand_case(torch, gen, 2, 64, 4, 16, dev, n=50)
    dd, di = verify_vs_twin("candidate_verify", (cp + 100.0, cv, ci, g, q), 0.5, n, 5)
    check(bool(torch.isinf(dd).all()) and bool((di == n).all()), "B7 filled an empty window")
    n_cases += 2
    # tests/test_kernels.py:95-98 (M == nb in the second), invalid block ids
    for Q, M, nb, B, K, d, k in ((2, 4, 16, 32, 4, 16, 5), (1, 8, 8, 64, 12, 96, 20),
                                 (4, 8, 8, 64, 12, 96, 64)):
        args, n = verify_window_case(torch, gen, Q, M, nb, B, K, d, dev)
        for w in (3.0, 1e6):
            verify_vs_twin("window_verify", args, w, n, k)
            n_cases += 1
    print(f"[twins] ok: {n_cases} kernel-vs-twin cases agree (counts equal, "
          f"rtol = atol = 1e-5, id sets per bin / per query); max |err| {max_err} "
          f"({phase_s():.1f} s)", flush=True)

    # -------------------------------------------------------- 3. main path
    t0 = time.perf_counter()
    pts = make_clustered(gen, N + N_QUERIES_LARGE, D, n_clusters=N // 4000,
                         spread=0.02, device=dev)
    data, queries, _ = normalize_scale(pts[:N], pts[N:])
    del pts
    params = DBLSHParams.derive(n=N, d=D, c=1.5, t=64, k=K_NN, K=10, L=5,
                                inline_vectors=True)
    index = build(data, params, generator=gen, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    check((params.block_size, params.max_blocks) == (64, 5),
          f"unexpected derived B, M: {params.block_size}, {params.max_blocks}")
    print(f"[main] index: n={N} d={D} K={params.K} L={params.L} B={params.block_size} "
          f"M={params.max_blocks} nb={index.nb}, {index.memory_bytes() / 1e9:.2f} GB "
          f"on the card (+{data.numel() * 4 / 1e9:.2f} GB data), data+build "
          f"{setup_s:.1f} s", flush=True)

    Q64 = queries[:N_QUERIES].contiguous()
    Q1k = queries[:N_QUERIES_LARGE].contiguous()
    kw = dict(k=K_NN, r0=R0, steps=STEPS, with_stats=True, device=dev)

    def run_counted(calls):
        """Run (engine, fn) pairs with every count at 0 just before; the
        launches per kernel and engine, and the results."""
        kernels.reset_launches()
        results, per_engine = {}, {}
        for key, fn in calls:
            before = dict(kernels.launches)
            results[key] = fn()
            eng = per_engine.setdefault(key[0], {name: 0 for name in KERNELS})
            for name in KERNELS:
                eng[name] += kernels.launches[name] - before[name]
        torch.cuda.synchronize()
        return results, per_engine, dict(kernels.launches)

    results, per_engine, onepass_launches = run_counted(
        [((e, x), (lambda e=e, x=x: search_batch_fixed(index, Q64, engine=e, exact=x, **kw)))
         for e in engines for x in (False, True)])
    for name in FUSED:
        check(onepass_launches[name] > 0, f"the main path never launched {name}")
    print(f"[main] launches on the one-pass path (2 searches per engine: norm, exact): "
          f"{json.dumps(per_engine)}", flush=True)

    _, gt = brute_force(data, Q64, k=K_NN, device=dev)
    gt_sets = [set(r) for r in gt.cpu().tolist()]
    ref_exact = idsets(torch, *results["torch", True][:2])
    ref_norm = idsets(torch, *results["torch", False][:2])
    onepass_recall = {}
    for engine in engines:
        for exact in (False, True):
            dd, ii, stats = results[engine, exact]
            check(tuple(dd.shape) == (N_QUERIES, K_NN) and tuple(ii.shape) == (N_QUERIES, K_NN),
                  f"{engine}: result shape {tuple(dd.shape)}")
            check(bool(torch.isfinite(dd[:, 0]).all()), f"{engine}: a query found nothing")
            check(bool((stats["candidates"] > 0).all()), f"{engine}: zero candidates")
        sets_exact = idsets(torch, *results[engine, True][:2])
        sets_norm = idsets(torch, *results[engine, False][:2])
        par_exact = sum(a == b for a, b in zip(sets_exact, ref_exact)) / N_QUERIES
        par_norm = sum(a == b for a, b in zip(sets_norm, ref_norm)) / N_QUERIES
        recall = sum(len(a & b) for a, b in zip(sets_norm, gt_sets)) / (N_QUERIES * K_NN)
        onepass_recall[engine] = recall
        print(f"[main] {engine:6s}: recall@{K_NN} {recall:.4f}, id-set parity with "
              f"torch: exact {par_exact:.4f}, norm {par_norm:.4f}", flush=True)
        check(par_exact == 1.0, f"{engine}: exact-mode id sets differ from the torch engine")
        check(par_norm >= 0.98, f"{engine}: norm-mode id-set parity {par_norm} < 0.98")
        check(recall >= 0.5, f"{engine}: recall@{K_NN} {recall} < 0.5")
    s = results["torch", False][2]
    check(all(torch.equal(results[e, False][2][key], s[key])
              for e in engines for key in s), "stats differ across engines")

    # the kernels on the inputs the main path gives them, vs their twins
    captured = {}
    for name, engine in (("fused_window_search", "inline"), ("fused_cand_search", "kernel")):
        captured[name] = capture_calls(
            kernels, wrappers, name,
            lambda: search_batch_fixed(index, Q64, engine=engine, **kw))
        a, k = captured[name]
        # the norm form's d2 = ||x||^2 - 2<q,x> + ||q||^2 cancels: its
        # rounding scales with the norms (~1e3 after normalize_scale), not
        # with d2, and the kernel and the twin sum the dot in different
        # orders; the diff form has no cancellation
        nrm, q = (a[4], a[7]) if name == "fused_window_search" else (a[2], a[6])
        scale = float(nrm[torch.isfinite(nrm)].max()) + float((q * q).sum(-1).max())
        for mode, atol in (("norm", 4e-6 * scale), ("exact", 1e-5)):
            kk = dict(k, mode=mode)
            err = bins_err(torch, wrappers[name](*a, **kk), twins[name](*a, **kk),
                           atol=atol, edge_ties=True)
            max_err[name] = max(max_err[name], err)
    torch.cuda.synchronize()
    print(f"[main] ok: kernels agree with their twins on the main path's inputs "
          f"(norm form atol 4e-6 x {scale:.1f}, exact form 1e-5); max |err| {max_err} "
          f"({phase_s():.1f} s)", flush=True)

    # --------------------------------------------------- 4. multi-pass path
    multi, per_engine, multi_launches = run_counted(
        [((e,), (lambda e=e: search_batch_fixed_ref(index, Q64, engine=e, **kw)))
         for e in engines])
    want = {"torch": {}, "kernel": {"candidate_verify": params.L * STEPS},
            "inline": {"window_verify": params.L * STEPS}}
    for engine in engines:
        for name in KERNELS:
            got = per_engine[engine][name]
            check(got == want[engine].get(name, 0),
                  f"multi-pass {engine}: {name} launched {got} times, want "
                  f"{want[engine].get(name, 0)}")
    print(f"[multipass] launches per search (L*steps = {params.L * STEPS}): "
          f"{json.dumps(per_engine)}", flush=True)
    md, mi, ms = multi["torch",]
    ref_sets = idsets(torch, md, mi)
    kth = md[:, K_NN - 1].cpu()
    for engine in engines:
        dd, ii, stats = multi[engine,]
        check(tuple(dd.shape) == (N_QUERIES, K_NN), f"multi-pass {engine}: shape")
        check(bool(torch.isfinite(dd[:, 0]).all()), f"multi-pass {engine}: a query found nothing")
        for key in ms:
            check(torch.equal(stats[key], ms[key]), f"multi-pass {engine}: {key} differs")
        sets = idsets(torch, dd, ii)
        # an id may differ only at a near-tie with the query's k-th distance
        dist = {}
        for q_, (a_d, a_i, b_d, b_i) in enumerate(zip(dd.cpu(), ii.cpu(), md.cpu(), mi.cpu())):
            if sets[q_] == ref_sets[q_]:
                continue
            dist = dict(zip(a_i.tolist(), a_d.tolist()))
            dist.update(zip(b_i.tolist(), b_d.tolist()))
            edge = float(kth[q_])
            check(all(abs(dist[i] - edge) <= 1e-5 * edge for i in sets[q_] ^ ref_sets[q_]),
                  f"multi-pass {engine}: ids differ from torch at query {q_}, off the k edge")
        same = sum(a == b for a, b in zip(sets, ref_sets)) / N_QUERIES
        recall = sum(len(a & b) for a, b in zip(sets, gt_sets)) / (N_QUERIES * K_NN)
        print(f"[multipass] {engine:6s}: recall@{K_NN} {recall:.4f} (one-pass "
              f"{onepass_recall[engine]:.4f}), id sets equal to torch's: {same:.4f}, "
              f"mean candidates {float(stats['candidates'].float().mean()):.1f}", flush=True)
        check(recall >= 0.5, f"multi-pass {engine}: recall@{K_NN} {recall} < 0.5")
    for name, engine in (("window_verify", "inline"), ("candidate_verify", "kernel")):
        captured[name] = capture_calls(
            kernels, wrappers, name,
            lambda: search_batch_fixed_ref(index, Q64, engine=engine, **kw))
        a, k = captured[name]
        err = topk_err(torch, wrappers[name](*a, **k), twins[name](*a, **k), k["n"],
                       edge_ties=True)
        max_err[name] = max(max_err[name], err)
    torch.cuda.synchronize()
    print(f"[multipass] ok: B6/B7 agree with their twins on the path's inputs "
          f"(rtol = atol = 1e-5); max |err| {max_err} ({phase_s():.1f} s)", flush=True)

    # --------------------------------- 5. one-pass vs the multi-pass oracle
    small_gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    pts = make_clustered(small_gen, 2080, 24, n_clusters=12, spread=0.02, device=dev)
    sdata, squeries, _ = normalize_scale(pts[:2048], pts[2048:])
    sparams = DBLSHParams.derive(n=2048, d=24, c=1.5, t=48, k=10, K=8, L=3,
                                 inline_vectors=True, max_blocks=32)
    sindex = build(sdata, sparams, generator=small_gen, device=dev)
    check(sparams.max_blocks == sindex.nb, "the oracle index must not truncate selection")
    torch_bit_equal, max_ulps = True, 0.0
    for steps in (1, 4, 8):
        okw = dict(k=8, r0=0.5, steps=steps, device=dev)
        for engine in engines:
            one = search_batch_fixed(sindex, squeries, engine=engine, exact=True, **okw)
            oracle = search_batch_fixed_ref(sindex, squeries, engine=engine, **okw)
            if engine != "torch":
                check(bit_equal(torch, one, oracle),
                      f"one-pass {engine} (exact) is not bit-equal to the oracle at steps={steps}")
                continue
            check(idsets(torch, *one) == idsets(torch, *oracle),
                  f"one-pass torch: id sets differ from the oracle at steps={steps}")
            a_d, b_d = one[0].cpu().numpy(), oracle[0].cpu().numpy()
            fin = np.isfinite(b_d)
            check(np.array_equal(fin, np.isfinite(a_d)), "one-pass torch: filled slots differ")
            ulps = np.abs(a_d[fin] - b_d[fin]) / np.spacing(np.abs(b_d[fin]))
            max_ulps = max(max_ulps, float(ulps.max()) if ulps.size else 0.0)
            check(max_ulps <= 2.0, f"one-pass torch: distances {max_ulps} ulps from the oracle")
            torch_bit_equal = torch_bit_equal and bit_equal(torch, one, oracle)
    print(f"[oracle] ok: n=2048 d=24 K=8 L=3 max_blocks=nb={sindex.nb}, steps 1/4/8: "
          f"one-pass exact=True bit-equal to the multi-pass oracle on kernel and inline; "
          f"torch engine: id sets equal, max {max_ulps:.1f} ulps, bit-equal: "
          f"{torch_bit_equal} ({phase_s():.1f} s)", flush=True)

    # ------------------------------------------------------ 6. termination
    term_summary = {}
    for engine in engines:
        ekw = dict(kw, engine=engine)
        fixed = search_batch_fixed(index, Q64, **ekw)
        for early in (False, True):
            c2 = search_batch_fixed(index, Q64, termination=Termination(use_c1=False,
                                                                        early_exit=early), **ekw)
            check(bit_equal(torch, fixed, c2) and all(torch.equal(fixed[2][key], c2[2][key])
                                                      for key in fixed[2]),
                  f"{engine}: C2-only termination (early_exit={early}) differs from fixed")
        d_, i_, st_, ex = search_batch_fixed(index, Q64, termination=Termination(),
                                             with_explain=True, **ekw)
        check(bool((st_["radius_steps"] <= fixed[2]["radius_steps"]).all()),
              f"{engine}: Termination() ran more steps than the fixed schedule")
        check(bool((st_["candidates"] <= fixed[2]["candidates"]).all()),
              f"{engine}: Termination() fetched more candidates than the fixed schedule")
        check(torch.equal(ex["step_slots"].sum(dim=1, dtype=torch.int32), st_["candidates"]),
              f"{engine}: explain step slots do not sum to the candidates")
        pending = search_batch_fixed_dispatch(index, Q64, termination=Termination(),
                                              with_explain=True, **ekw)
        pd_, pi_, pst = pending.result()
        check(pending.ready() and bit_equal(torch, (d_, i_), (pd_, pi_))
              and all(torch.equal(pst[key], st_[key]) for key in pst)
              and all(torch.equal(pending.explain[key], ex[key]) for key in ex),
              f"{engine}: the dispatch result differs from the synchronous call")
        causes = torch.bincount(ex["term_cause"].long(), minlength=3).tolist()
        term_summary[engine] = {
            "mean_radius_steps": float(st_["radius_steps"].float().mean()),
            "mean_candidates": float(st_["candidates"].float().mean()),
            "fixed_mean_candidates": float(fixed[2]["candidates"].float().mean()),
            "causes_exhausted_c1_c2": causes}
    print(f"[termination] ok: C2-only (early exit on/off) bit-equal to fixed, stats "
          f"included; Termination() <= fixed; explain slots sum to candidates; dispatch "
          f"bit-equal. {json.dumps(term_summary)} ({phase_s():.1f} s)", flush=True)

    # ------------------------------------------------------------ 7. times
    records = []
    path_launches = {**{n_: onepass_launches[n_] for n_ in FUSED},
                     **{n_: multi_launches[n_] for n_ in VERIFY}}
    for name, (source, replaces) in KERNELS.items():
        a, k = captured[name]
        ms = cuda_ms(torch, lambda: wrappers[name](*a, **k), iters=50)
        plain_ms = cuda_ms(torch, lambda: twins[name](*a, **k), iters=5)
        in_bytes, out_bytes, ops = work(torch, name, a, k)
        bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / FP32_FLOPS * 1e3
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        records.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": path_launches[name], "max_abs_err": max_err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": bound_by, "library_ms": None,
        })
        print(f"[times] {name}: median {ms:.4f} ms/launch at Q={N_QUERIES} (twin {plain_ms:.3f} "
              f"ms), bound {max(bytes_ms, ops_ms) * 1e3:.2f} us by {bound_by} "
              f"({(in_bytes + out_bytes) / 1e6:.2f} MB, {ops / 1e6:.1f} Mflop)", flush=True)

    # wall times: for each batch, engines in turns, each path timed alone
    wall = {}
    searches = {
        "onepass": lambda Qb, e: search_batch_fixed(index, Qb, engine=e, **kw),
        "multipass": lambda Qb, e: search_batch_fixed_ref(index, Qb, engine=e, **kw),
        "terminated": lambda Qb, e: search_batch_fixed(index, Qb, engine=e,
                                                       termination=Termination(), **kw),
    }
    for Qn, Qb in ((N_QUERIES, Q64), (N_QUERIES_LARGE, Q1k)):
        for engine in engines:
            for path, fn in searches.items():
                wall[f"{path}:{engine}@{Qn}"] = wall_ms(torch, lambda: fn(Qb, engine),
                                                        repeats=10 if path != "multipass" or
                                                        Qn == N_QUERIES else 5)
    print(f"[times] median wall ms (10 runs; 5 for multipass@{N_QUERIES_LARGE}; k={K_NN}, "
          f"steps={STEPS}): {json.dumps({key: round(v, 3) for key, v in wall.items()})}",
          flush=True)
    for Qn in (N_QUERIES, N_QUERIES_LARGE):
        ratio = {e: round(wall[f"multipass:{e}@{Qn}"] / wall[f"onepass:{e}@{Qn}"], 2)
                 for e in engines}
        saved = {e: round(1 - wall[f"terminated:{e}@{Qn}"] / wall[f"onepass:{e}@{Qn}"], 3)
                 for e in engines}
        print(f"[times] Q={Qn}: multi-pass / one-pass wall {json.dumps(ratio)}; "
              f"Termination() saves {json.dumps(saved)} of the fixed schedule's wall "
              f"({phase_s():.1f} s)", flush=True)

    # ------------------------------------------- 8. where the time goes
    from torch.profiler import ProfilerActivity, profile

    stages = ("dblsh.project", "dblsh.select", "dblsh.verify", "dblsh.merge")
    for path in ("onepass", "multipass"):
        for Qn, Qb in ((N_QUERIES, Q64), (N_QUERIES_LARGE, Q1k)):
            for engine in engines:
                searches[path](Qb, engine)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    searches[path](Qb, engine)
                    torch.cuda.synchronize()
                    prof_ms = (time.perf_counter() - t0) * 1e3
                # kernel events only: the stage annotations also appear as
                # device-side ranges, which span time rather than fill it
                events = prof.events()
                on_card = [e for e in events
                           if e.device_type.name == "CUDA" and e.name not in stages]
                busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3
                span_ms = {}
                for e in events:  # host-side stage ranges: their kernels' device time
                    if e.name in stages and e.device_type.name == "CPU":
                        key = e.name.split(".")[1]
                        span_ms[key] = round(span_ms.get(key, 0.0) + e.device_time_total / 1e3, 3)
                by_name = {}
                for e in on_card:
                    by_name[e.name] = by_name.get(e.name, 0.0) + e.self_device_time_total / 1e3
                top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
                # the port's kernels: device time per launch, without the
                # host gap that the CUDA-event times of phase 7 include
                ours = {}
                for e in on_card:
                    for name in KERNELS:
                        if f"{name}_kernel" in e.name:
                            n_, t_ = ours.get(name, (0, 0.0))
                            ours[name] = (n_ + 1, t_ + e.self_device_time_total / 1e3)
                ours = {name: f"{n_} x {t_ / n_ * 1e3:.1f} us" for name, (n_, t_) in ours.items()}
                print(f"[profile] {path} Q={Qn} {engine}: device busy {busy_ms:.3f} ms of "
                      f"{prof_ms:.3f} ms wall of this call (idle {1 - busy_ms / prof_ms:.3f}; "
                      f"median unprofiled wall {wall[f'{path}:{engine}@{Qn}']:.3f} ms), "
                      f"{len(on_card)} device ops; per stage {span_ms}; our kernels "
                      f"{ours}; top: "
                      + "; ".join(f"{name[:48]} {ms:.3f} ms" for name, ms in top), flush=True)
    print(f"[profile] ok ({phase_s():.1f} s)", flush=True)

    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
