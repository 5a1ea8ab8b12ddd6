#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each printing a line when it passes:

1. build   — compiles the CUDA kernels from ``src/repro_torch/kernels/csrc``
             and prints the build time and the card;
2. twins   — holds each kernel against its plain PyTorch twin on the same
             CUDA tensors, at the shapes of tests/test_kernels.py (invalid
             block ids, steps 1/4/8, modes norm/exact, ragged Ct) and at
             ks = 50;
3. main    — the repo's large search workload (BENCH_search_hotpath_large:
             n = 1,000,000, d = 64, K = 10, L = 5, B = 64, M = 5, 64
             queries, steps = 8, r0 = 0.5) through ``search_batch_fixed``
             with engines torch, kernel and inline; checks that both kernels
             ran, that the kernel engines return the torch engine's id sets
             (all of them with exact=True, >= 98 % in norm form), recall@10
             >= 0.5 against brute force, and each kernel against its twin on
             the inputs the main path gave it;
4. times   — median CUDA-event times of each kernel and its twin at the
             main-path shapes, beside the least time the card could take,
             and the median wall time of each engine's full search at 64
             and 1024 queries;
5. profile — one search per engine and batch under torch.profiler: device
             busy time against the wall time, device ops, device time per
             stage (project, select, verify, merge) and the top device ops.

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
}


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


def work(torch, name: str, a: tuple, k: dict):
    """(input bytes, output bytes, float32 operations) one call needs on
    these inputs: each input read once — for B1 only the rows of the
    distinct valid blocks it selects — and each output written once.
    Operations per slot: 3K for hw, 2d for the dot, ``steps`` compares."""
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
    from repro_torch.core import DBLSHParams, brute_force, build, search_batch_fixed
    from repro_torch.data import make_clustered, normalize_scale
    from repro_torch.kernels import _build, ref

    dev = torch.device("cuda")
    wrappers = {"fused_window_search": kernels.fused_window_search,
                "fused_cand_search": kernels.fused_cand_search}
    twins = {"fused_window_search": ref.fused_window_search_ref,
             "fused_cand_search": ref.fused_cand_search_ref}
    max_err = {name: 0.0 for name in KERNELS}

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
          f"{torch.cuda.get_device_name(0)}", flush=True)

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
    print(f"[twins] ok: {n_cases} kernel-vs-twin cases agree (counts equal, "
          f"rtol = atol = 1e-5, id sets per bin); max |err| {max_err}", flush=True)

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
    kw = dict(k=K_NN, r0=R0, steps=STEPS, with_stats=True, device=dev)
    engines = ("torch", "kernel", "inline")

    kernels.reset_launches()
    results, per_engine = {}, {}
    for engine in engines:
        for exact in (False, True):
            before = dict(kernels.launches)
            results[engine, exact] = search_batch_fixed(index, Q64, engine=engine,
                                                        exact=exact, **kw)
            per_engine.setdefault(engine, {name: 0 for name in KERNELS})
            for name in KERNELS:
                per_engine[engine][name] += kernels.launches[name] - before[name]
    torch.cuda.synchronize()
    main_launches = dict(kernels.launches)
    for name in KERNELS:
        check(main_launches[name] > 0, f"the main path never launched {name}")
    print(f"[main] launches on the main path (2 searches per engine: norm, exact): "
          f"{json.dumps(per_engine)}", flush=True)

    def idsets(d, i):
        d, i = d.cpu(), i.cpu()
        return [set(i[q][torch.isfinite(d[q])].tolist()) for q in range(d.shape[0])]

    _, gt = brute_force(data, Q64, k=K_NN, device=dev)
    gt_sets = [set(r) for r in gt.cpu().tolist()]
    ref_exact = idsets(*results["torch", True][:2])
    ref_norm = idsets(*results["torch", False][:2])
    for engine in engines:
        for exact in (False, True):
            dd, ii, stats = results[engine, exact]
            check(tuple(dd.shape) == (N_QUERIES, K_NN) and tuple(ii.shape) == (N_QUERIES, K_NN),
                  f"{engine}: result shape {tuple(dd.shape)}")
            check(bool(torch.isfinite(dd[:, 0]).all()), f"{engine}: a query found nothing")
            check(bool((stats["candidates"] > 0).all()), f"{engine}: zero candidates")
        sets_exact = idsets(*results[engine, True][:2])
        sets_norm = idsets(*results[engine, False][:2])
        par_exact = sum(a == b for a, b in zip(sets_exact, ref_exact)) / N_QUERIES
        par_norm = sum(a == b for a, b in zip(sets_norm, ref_norm)) / N_QUERIES
        recall = sum(len(a & b) for a, b in zip(sets_norm, gt_sets)) / (N_QUERIES * K_NN)
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

    def capture(name):
        def wrapper(*a, **k):
            captured[name] = (a, k)
            return wrappers[name](*a, **k)
        return wrapper

    for name, engine in (("fused_window_search", "inline"), ("fused_cand_search", "kernel")):
        setattr(kernels, name, capture(name))
        try:
            search_batch_fixed(index, Q64, engine=engine, **kw)
        finally:
            setattr(kernels, name, wrappers[name])
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
          f"(norm form atol 4e-6 x {scale:.1f}, exact form 1e-5); max |err| {max_err}",
          flush=True)

    # ------------------------------------------------------------ 4. times
    records = []
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
            "launches": main_launches[name], "max_abs_err": max_err[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": bound_by, "library_ms": None,
        })
        print(f"[times] {name}: median {ms:.4f} ms/launch at Q={N_QUERIES} (twin {plain_ms:.3f} "
              f"ms), bound {max(bytes_ms, ops_ms) * 1e3:.2f} us by {bound_by} "
              f"({(in_bytes + out_bytes) / 1e6:.1f} MB, {ops / 1e6:.1f} Mflop)", flush=True)

    engine_ms = {}
    Q1k = queries[:N_QUERIES_LARGE].contiguous()
    for Qn, Qb in ((N_QUERIES, Q64), (N_QUERIES_LARGE, Q1k)):
        for engine in engines:
            engine_ms[f"{engine}@{Qn}"] = wall_ms(
                torch, lambda: search_batch_fixed(index, Qb, engine=engine, **kw), repeats=10)
    kernels.reset_launches()
    for engine in engines:
        search_batch_fixed(index, Q64, engine=engine, **kw)
    print(f"[times] search_batch_fixed median wall ms (10 runs, k={K_NN}, steps={STEPS}): "
          f"{json.dumps({key: round(v, 3) for key, v in engine_ms.items()})}; launches "
          f"for one search per engine: {json.dumps(kernels.launches)}", flush=True)

    # ------------------------------------------- 5. where the time goes
    from torch.profiler import ProfilerActivity, profile

    stages = ("dblsh.project", "dblsh.select", "dblsh.verify", "dblsh.merge")
    for Qn, Qb in ((N_QUERIES, Q64), (N_QUERIES_LARGE, Q1k)):
        for engine in engines:
            search_batch_fixed(index, Qb, engine=engine, **kw)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                search_batch_fixed(index, Qb, engine=engine, **kw)
                torch.cuda.synchronize()
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
            wall = engine_ms[f"{engine}@{Qn}"]
            print(f"[profile] Q={Qn} {engine}: device busy {busy_ms:.3f} ms of "
                  f"{wall:.3f} ms wall (idle {1 - busy_ms / wall:.3f}), "
                  f"{len(on_card)} device ops; per stage {span_ms}; top: "
                  + "; ".join(f"{name[:48]} {ms:.3f} ms" for name, ms in top), flush=True)

    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
