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
                 modes norm/exact, ragged Ct) and at ks = 50; B3 (B1/B2 in
                 the modes bf16 and int8) at tests/test_kernels.py:280-357's
                 shapes, ragged Ct and ks = 40 (int8: bins equal, and
                 whether bit-equal; bf16: bin ids >= 98 % equal); B6/B7 at
                 C in {64, 256, 100, 32} (odd d, k == C), the dedup and
                 all-masked cases, invalid block ids and M == nb; B4/B5 at
                 tests/test_kernels.py:122-176's shapes in both forms (hw
                 bit-equal, d2 within a norm-scaled atol, +inf on invalid
                 blocks, the all-invalid case), and at their edges on
                 integer inputs, bit-equal to the twin in both forms (5,000
                 units, so each block of the grid walks several; B = 7/100/130,
                 Ct = 1/65/100/333; d = 12/33 on unaligned bases; odd K;
                 a query whose blocks are all invalid; Q = 1/5/64); B8 at
                 :496-532's shapes and at the edges of its bf16 and fp32
                 tiles in fp32 and bf16 (rtol 1e-4, atol 1e-4 x d), on
                 bases not 16-byte aligned (bit-equal to the aligned call),
                 and bit-equal on integer inputs;
3. main        — the repo's large search workload (BENCH_search_hotpath_large:
                 n = 1,000,000, d = 64, K = 10, L = 5, B = 64, M = 5, 64
                 queries, steps = 8, r0 = 0.5) through the one-pass
                 ``search_batch_fixed`` with engines torch, kernel and
                 inline; checks that B1/B2 ran, that the kernel engines
                 return the torch engine's id sets (all of them with
                 exact=True; in norm form, a query may differ only where
                 every differing id lies within the norm-scaled atol of its
                 k-th distance, and the raw parity is printed), recall@10
                 >= 0.5 against brute force, and each kernel against its
                 twin on the inputs the main path gave it;
4. multipass   — the same workload through the multi-pass oracle
                 ``search_batch_fixed_ref``, all three engines: B6 (inline)
                 and B7 (kernel) launch L·steps = 40 times per search,
                 recall@10 >= 0.5, the kernel engines' id sets equal the
                 torch engine's up to near-ties at the k-th distance, stats
                 equal across engines, and B6/B7 against their twins on the
                 path's own inputs at 64 and 1024 queries;
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
7. quant       — the main index quantized in place (quantize_blocks: the
                 same blocks and hash functions) to bf16 and int8; 64 and
                 1024 queries on every engine and dtype: B1/B2 launched in
                 the quantized modes only (counts per mode), recall@10 >=
                 the fp32 recall - 0.02, id overlap with fp32, the re-rank
                 contract against a float64 diff-form oracle, stats equal
                 to fp32 where the ids are; Termination() stats against
                 fp32; each B3 instantiation against its twin on the
                 path's own inputs at 64 and 1024 queries;
8. updates     — on the int8 index: insert 10,000 new points (each ~0.5
                 from a random existing one), delete
                 10,000 ids (each query's true nearest neighbour among
                 them), then fp32
                 and int8 searches on every engine (no deleted id returned,
                 recall@10 over the live points >= 0.5, inserted points
                 found at d ~ 0 with exact=True); on the fp32 index,
                 the queries' true 10-NN deleted: the second-tier targets
                 found as often as the original index finds them (top 30,
                 filtered); compact on a 100k-point
                 int8 index after the same kind of updates (at n = 1M the
                 re-derived K = 3572 would need ~29 GB of projections) and
                 search it; wall times of insert, delete and compact;
9. pool        — ``_gather_pool``, the reference's pool engines, on the
                 blocks, projections and queries that the one-pass search
                 gives B1/B2 at the final radius, Q = 64 and 1024, norm and
                 exact: one launch of B5 (kernel) or B4 (inline) per call;
                 hw bit-equal across torch/kernel/inline; d2 of B4 and B5
                 bit-equal and close to torch's; B4's pool binned
                 (``ref.bins_from_pool``) equal to B1's bins bit for bit,
                 B5's to B2's; B4/B5 against their twins on these inputs;
10. brute      — ``pairwise_l2`` (B8) of the 64 and 1024 queries against
                 the 1M points in fp32 and bf16 (both cast): one launch
                 each; the matrix against its twin in row chunks; fp32
                 top-10 ids equal to ``brute_force``'s up to near-ties at
                 the 10th distance, the bf16 id overlap printed;
11. times      — median CUDA-event times of each kernel (B3 per mode) and
                 its twin at the shapes its path gives it, with the
                 profiler's device time (and, for B4-B7, the host time of
                 a call; for B4/B5 the exact form beside the norm form),
                 beside the least time the card could take (every
                 kernel at both batches; for B8 also torch.cdist and
                 Q @ X.T, and the kernel / cdist and kernel / Q @ X.T
                 ratios); median wall times
                 of the one-pass search, the
                 multi-pass search, the one-pass search under
                 Termination() and the quantized searches, per engine, at
                 64 and 1024 queries;
12. profile    — one one-pass, multi-pass, bf16 and int8 search per engine
                 and batch under torch.profiler (profiled twice, the trace
                 holding more device ops kept; each session first runs a
                 few spin kernels, left out of every figure, since the
                 device records of the first kernels after the profiler
                 starts can go missing): device busy time against
                 the wall time, device ops, device time per one-pass stage
                 (project, select, verify, merge: the device ops inside the
                 stage's device-side range; every stage must read device
                 time), our kernels' device time per launch (B3 per mode)
                 and the top device ops;
13. collection — the entry point a user calls, ``repro_torch.store``, on the
                 main workload: ``Collection.create`` with the generator in
                 the state main_workload built from (its index equal to
                 main_workload's); ``search`` at Q = 64 on inline and kernel
                 (B1 and B2 launched, results equal to
                 ``search_batch_fixed``'s; wall of both); ``calibrate`` on
                 256 held-out queries (inline, measure_ms) with its recall
                 non-decreasing in steps, ``plan(RecallTarget(0.9))`` and a
                 search with the plan; ``add`` 10,000 and ``remove``
                 10,000 (no deleted id returned, recall@10 over the live
                 points >= 0.5, no compaction triggered); ``snapshot`` into
                 a temporary directory under ``build/`` and
                 ``restore_collection`` onto the card (searches, calibration
                 table, stats equal, a fresh version; bytes and seconds);
                 the same round on the int8 index (re-quantized blocks and
                 int8 searches equal); ``compact`` of a 100k-point
                 collection with ``calibrate(..., retain=True)`` (the table
                 re-fit equal to a fresh calibration, payload rows aligned,
                 no deleted point returned).

Any failure raises, and the run exits non-zero.  The last three lines are
the card's name and power limit as nvidia-smi reports them, the kernels'
JSON record, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

SEED = 7
N, D, N_QUERIES, N_QUERIES_LARGE = 1_000_000, 64, 64, 1024
K_NN, STEPS, R0 = 10, 8, 0.5
N_INSERT, N_DELETE = 10_000, 10_000  # the updates phase (10,000 is not a multiple of B)
N_COMPACT = 100_000  # compact runs on an index of this many points (see phase 8)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores
PEAK_OPS = {"bf16": 989e12, "int8": 1979e12}  # H100 SXM dense tensor-core rates
QUANT = ("bf16", "int8")
KERNELS = {  # wrapper -> (source, the TPU kernel it replaces)
    "fused_window_search": ("src/repro_torch/kernels/csrc/fused_search.cu",
                            "src/repro/kernels/window_verify.py:328"),
    "fused_cand_search": ("src/repro_torch/kernels/csrc/fused_search.cu",
                          "src/repro/kernels/window_verify.py:374"),
    "window_verify": ("src/repro_torch/kernels/csrc/window_verify.cu",
                      "src/repro/kernels/window_verify.py:143"),
    "candidate_verify": ("src/repro_torch/kernels/csrc/window_verify.cu",
                         "src/repro/kernels/window_verify.py:113"),
    "window_dist": ("src/repro_torch/kernels/csrc/dist.cu",
                    "src/repro/kernels/window_verify.py:217"),
    "candidate_dist": ("src/repro_torch/kernels/csrc/dist.cu",
                       "src/repro/kernels/window_verify.py:189"),
    "pairwise_l2": ("src/repro_torch/kernels/csrc/pairwise_l2.cu",
                    "src/repro/kernels/pairwise_l2.py:25"),
}
FUSED = ("fused_window_search", "fused_cand_search")
VERIFY = ("window_verify", "candidate_verify")
POOL = ("window_dist", "candidate_dist")  # B4, B5: the pool engines of _gather_pool
NORM_ATOL = 4e-6  # x (max ||x||^2 + max ||q||^2): the norm form's cancellation
# kernel B3: the quantized modes of B1/B2, one record per instantiation
B3 = {f"{w}[{m}]": (w, m) for w in FUSED for m in QUANT}
B3_REPLACES = "src/repro/kernels/window_verify.py:270"  # _slot_d2, modes bf16/int8


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


def norm_edge_ties(torch, got, want, atol: float, rtol: float = 1e-5) -> int:
    """Norm-form id-set parity of a search result (dists, ids) with the
    torch engine's: a query's id set may differ only where every differing
    id's squared distance lies within ``atol + rtol * edge`` of that
    query's k-th squared distance ``edge`` (a near-tie at the k cut, the
    rule of ``bins_err``'s ``edge_ties``); any other difference fails.
    Returns the number of queries that differ at such near-ties."""
    gd, gi = (x.cpu() for x in got)
    wd, wi = (x.cpu() for x in want)
    ties = 0
    for q in range(gd.shape[0]):
        fg, fw = torch.isfinite(gd[q]), torch.isfinite(wd[q])
        a, b = set(gi[q][fg].tolist()), set(wi[q][fw].tolist())
        if a == b:
            continue
        edge = float(wd[q][fw].max()) ** 2
        dist = dict(zip(wi[q][fw].tolist(), wd[q][fw].tolist()))
        dist.update(zip(gi[q][fg].tolist(), gd[q][fg].tolist()))
        check(all(abs(dist[i] ** 2 - edge) <= atol + rtol * edge for i in a ^ b),
              f"norm form: ids differ from the torch engine at query {q}, off the k edge")
        ties += 1
    return ties


def dist_window_case(torch, gen, Q, L, M, nb, B, K, d, dev):
    """tests/test_kernels.py::test_window_dist_matches_ref's inputs on the
    card: the last block's back half +inf-padded, block ids including the
    sentinel L*nb, -1 and 2^20."""
    lnb = L * nb
    proj = torch.randn((lnb, B, K), generator=gen, device=dev) * 2.0
    vec = torch.randn((lnb, B, d), generator=gen, device=dev)
    nrm = (vec * vec).sum(-1)
    proj[-1, B // 2:] = torch.inf
    nrm[-1, B // 2:] = torch.inf
    blk = torch.randint(0, lnb + 1, (Q, L * M), generator=gen, device=dev).int()
    blk[0, -1] = -1
    blk[-1, 0] = 1 << 20
    g = torch.randn((Q, L, K), generator=gen, device=dev)
    q = torch.randn((Q, d), generator=gen, device=dev)
    return blk, proj, vec, nrm, g, q


def dist_cand_case(torch, gen, Q, L, Ct, K, d, dev):
    """tests/test_kernels.py::test_candidate_dist_matches_ref's inputs on
    the card: every 7th slot invalid (+inf projection and norm)."""
    cp = torch.randn((Q, L, Ct, K), generator=gen, device=dev) * 2.0
    cv = torch.randn((Q, L, Ct, d), generator=gen, device=dev)
    cn = (cv * cv).sum(-1)
    cp[:, :, ::7] = torch.inf
    cn[:, :, ::7] = torch.inf
    g = torch.randn((Q, L, K), generator=gen, device=dev)
    q = torch.randn((Q, d), generator=gen, device=dev)
    return cp, cv, cn.contiguous(), g, q


def dist_int_window(torch, gen, Q, L, M, nb, B, K, d, dev, p_invalid=0.2):
    """B4 inputs in small integers (every sum exact in float32, so both
    forms equal the twin bit for bit), as tests/test_torch_kernels.py's
    _int_dist_window: a share of the block ids invalid (-1, L*nb, 2^20)
    between valid ones, the last block's back half +inf-padded."""
    lnb = L * nb

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev).float()

    proj, vec = ints(-3, 4, (lnb, B, K)), ints(-2, 3, (lnb, B, d))
    nrm = (vec * vec).sum(-1)
    proj[-1, B // 2:] = torch.inf
    nrm[-1, B // 2:] = torch.inf
    blk = torch.randint(0, lnb, (Q, L * M), generator=gen, device=dev).int()
    bad = torch.rand((Q, L * M), generator=gen, device=dev) < p_invalid
    bad_ids = torch.tensor([-1, lnb, 1 << 20], dtype=torch.int32, device=dev)
    blk[bad] = bad_ids[torch.randint(0, 3, (int(bad.sum()),), generator=gen, device=dev)]
    return blk, proj, vec, nrm, ints(-3, 4, (Q, L, K)), ints(-2, 3, (Q, d))


def dist_int_cand(torch, gen, Q, L, Ct, K, d, dev):
    """B5 inputs in small integers; every 7th slot invalid (+inf projection
    and norm)."""
    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, device=dev).float()

    cp, cv = ints(-3, 4, (Q, L, Ct, K)), ints(-2, 3, (Q, L, Ct, d))
    cn = (cv * cv).sum(-1)
    cp[:, :, ::7] = torch.inf
    cn[:, :, ::7] = torch.inf
    return cp, cv, cn.contiguous(), ints(-3, 4, (Q, L, K)), ints(-2, 3, (Q, d))


def norm_scale(torch, x, q) -> float:
    """max ||x||^2 + max ||q||^2 over the finite rows: the norm form's
    ||x||^2 - 2<q,x> + ||q||^2 cancels, so its rounding follows this."""
    xn = (x.float() * x.float()).sum(-1)
    return float(xn[torch.isfinite(xn)].max()) + float((q.float() ** 2).sum(-1).max())


def pool_err(torch, got, want, x, q, exact: bool, invalid=None) -> float:
    """B4/B5 against their twin: hw bit-equal (an elementwise max); d2
    where hw is finite within rtol 1e-5 plus atol 1e-5 (diff form) or
    NORM_ATOL x the norms (norm form: the two sum the dot in other
    orders); with ``invalid`` (Q, C), both outputs +inf there.  Returns
    the largest d2 difference."""
    (gd, gh), (wd, wh) = got, want
    check(torch.equal(gh, wh), "pool: hw differs from the twin")
    fin = torch.isfinite(wh)
    atol = 1e-5 if exact else NORM_ATOL * norm_scale(torch, x, q)
    err = float((gd[fin] - wd[fin]).abs().max()) if fin.any() else 0.0
    check(torch.allclose(gd[fin], wd[fin], rtol=1e-5, atol=atol),
          f"pool: d2 differs from the twin by {err} (atol {atol})")
    if invalid is not None:
        check(bool(torch.isinf(gd[invalid]).all() and torch.isinf(gh[invalid]).all()),
              "pool: a slot of an invalid block is finite")
    return err


def quantized_case(torch, args, x_idx: int, mode: str):
    """A kernel case's float32 vectors args[x_idx] quantized per slot (the
    port's quantize_blocks, the reference's rule): the args with the
    quantized vectors, and the slots' dequant scales."""
    from repro_torch.core import quantize_blocks

    x = args[x_idx]
    flat = x.reshape(-1, x.shape[-1])
    qx, qs = quantize_blocks(flat, torch.arange(flat.shape[0], dtype=torch.int32,
                                                device=x.device), mode)
    out = list(args)
    out[x_idx] = qx.reshape(x.shape)
    return tuple(out), qs.reshape(x.shape[:-1])


def quant_err(torch, got, want, mode: str, atol: float, rtol: float = 1e-5):
    """Kernel B3 against its twin.  int8: counts, ids and distances as
    ``bins_err`` (the integer dot is exact and the dequant steps are the
    twin's, so they should also be bit-equal); bf16: counts equal, per-bin
    id overlap >= 0.98 (the two sum the bf16 products in other orders, so
    near-ties at the ks cut may swap), distances of the shared ids within
    tolerance.  Returns (largest |err|, whether every output is bit-equal)."""
    bits = all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(got, want))
    if mode == "int8":
        return bins_err(torch, got, want, atol=atol, rtol=rtol), bits
    gd, gi, gc = (x.cpu() for x in got)
    wd, wi, wc = (x.cpu() for x in want)
    check(torch.equal(gc, wc), "bf16: bin counts differ from the twin")
    hits = total = 0
    err = 0.0
    for q in range(gd.shape[0]):
        for j in range(gd.shape[1]):
            wf, gf = torch.isfinite(wd[q, j]), torch.isfinite(gd[q, j])
            wmap = dict(zip(wi[q, j][wf].tolist(), wd[q, j][wf].tolist()))
            gmap = dict(zip(gi[q, j][gf].tolist(), gd[q, j][gf].tolist()))
            shared = wmap.keys() & gmap.keys()
            hits += len(shared)
            total += len(wmap)
            for i in shared:
                e = abs(gmap[i] - wmap[i])
                err = max(err, e)
                check(e <= atol + rtol * abs(wmap[i]),
                      f"bf16: distance of id {i} differs from the twin by {e} (atol {atol})")
    check(total == 0 or hits / total >= 0.98, f"bf16: bin id overlap {hits / total} < 0.98")
    return err, bits


def work(torch, name: str, a: tuple, k: dict):
    """(input bytes, output bytes, operations, least ms for those
    operations) one call needs on these inputs: each input read once — for
    B1 and B6 only the rows of the distinct valid blocks they select — and
    each output written once.  Operations per slot: 3K for hw, 2d for the
    norm-form dot (B1/B2/B4/B5, plus ``steps`` compares in B1/B2) or 3d for
    the diff form (B6/B7, B4/B5 with exact), in float32; in the quantized
    modes (B3) the 2d of the dot at the card's peak rate for bf16 or int8
    and the rest in float32.  B4 reads only the rows of the distinct valid
    blocks it selects, as B1.  B8: 2 nq nn d for the product at the
    inputs' rate (fp32, or bf16 in the tensor cores), the norms and three
    epilogue operations per output in float32."""
    if name in POOL:  # B4/B5: no selection, two outputs per slot
        g, q = a[-2], a[-1]
        K, d = g.shape[-1], q.shape[-1]
        small = (g.numel() + q.numel() + q.shape[0]) * 4  # g, q, q2
        if name == "window_dist":
            blk, proj = a[0], a[1]
            lnb, B = proj.shape[0], proj.shape[1]
            valid = blk[(blk >= 0) & (blk < lnb)]
            rows = int(torch.unique(valid).numel()) * B
            in_bytes = blk.numel() * 4 + rows * (K + d + 1) * 4 + small
            slots, out_bytes = int(valid.numel()) * B, blk.numel() * B * 8
        else:
            slots = a[2].numel()
            in_bytes, out_bytes = slots * (K + d + 1) * 4 + small, slots * 8
        ops = slots * (3 * K + (3 if k.get("exact") else 2) * d)
        return in_bytes, out_bytes, ops, ops / FP32_FLOPS * 1e3
    if name == "pairwise_l2":  # B8: the product at the inputs' rate, the rest in fp32
        Q, X = a
        (nq, d), nn = Q.shape, X.shape[0]
        prod, rest = 2 * nq * nn * d, 2 * (nq + nn) * d + 3 * nq * nn
        rate = FP32_FLOPS if Q.dtype == torch.float32 else PEAK_OPS["bf16"]
        return ((nq + nn) * d * Q.element_size(), nq * nn * 4, prod + rest,
                (prod / rate + rest / FP32_FLOPS) * 1e3)
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
        ops = slots * (3 * K + 3 * d)
        return in_bytes, out_bytes, ops, ops / FP32_FLOPS * 1e3
    window = name == "fused_window_search"
    mode = k.get("mode", "norm")
    xbytes = {"bf16": 2, "int8": 1}.get(mode, 4)
    scale = 4 if mode in QUANT else 0  # the slot's dequant scale
    halves, g, q = (a[1], a[6], a[7]) if window else (a[4], a[5], a[6])
    Qn, K, d, steps = q.shape[0], g.shape[-1], q.shape[-1], halves.shape[0]
    small = (halves.numel() + g.numel() + q.numel()) * 4
    out_bytes = Qn * steps * (k["ks"] * 8 + 4)
    if window:
        blk, proj = a[0], a[2]
        lnb, B = proj.shape[0], proj.shape[1]
        valid = blk[(blk >= 0) & (blk < lnb)]
        rows = int(torch.unique(valid).numel()) * B
        in_bytes = blk.numel() * 4 + rows * ((K + 2) * 4 + d * xbytes + scale) + small
        slots = int(valid.numel()) * B
    else:
        slots = a[0].numel() // K
        in_bytes = slots * ((K + 2) * 4 + d * xbytes + scale) + small
    if mode in QUANT:
        f32_ops, q_ops = slots * (3 * K + steps), slots * 2 * d
        return (in_bytes, out_bytes, f32_ops + q_ops,
                (f32_ops / FP32_FLOPS + q_ops / PEAK_OPS[mode]) * 1e3)
    ops = slots * (3 * K + 2 * d + steps)
    return in_bytes, out_bytes, ops, ops / FP32_FLOPS * 1e3


def device_us(torch, fn, kernel: str, calls: int = 5, sessions: int = 3) -> tuple[float, str]:
    """Device microseconds of one launch of the kernel whose name contains
    ``kernel`` (``fn`` launches it once), and how they were taken: the
    median over the records of ``calls`` profiled calls, after a warm-up
    call.  A trace can lose a call's device records, and now and then all
    of a session's, so a session with none is taken again, up to
    ``sessions`` times; if every session lost them, the time is that of
    ``queued_us`` and says so."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        times = [e.self_device_time_total for e in prof.events()
                 if e.device_type.name == "CUDA" and kernel in e.name]
        if times:
            return statistics.median(times), "profiler"
    return queued_us(torch, fn, calls), f"CUDA events; the profiler kept no record of {kernel}"


def queued_us(torch, fn, calls: int = 5) -> float:
    """Device microseconds of one call, timed without the profiler: each
    call's pair of CUDA events is queued behind a ~2.5 ms spin on the card,
    so the host has enqueued the call before the card reaches it and the
    pair holds the call's device work (all of its kernels) and no host
    time.  Median over ``calls`` calls, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(5_000_000)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) * 1e3)
    return statistics.median(times)


def host_us(torch, fn, calls: int = 50, rounds: int = 5) -> float:
    """Host microseconds of one call: the median over ``rounds`` rounds of
    ``time.perf_counter`` over ``calls`` calls with no synchronisation
    inside the loop (the launches queue on the card), each round after a
    warm-up call and a synchronisation."""
    times = []
    for _ in range(rounds):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(times)


def stage_ms(events, on_card, stages) -> dict:
    """Device ms per stage: the device ops whose interval lies inside one
    of the stage's device-side ranges (the profiler's annotation of each
    ``record_function`` range on the card's timeline).  The host ranges'
    ``device_time_total`` loses a stage's kernels where the profiler does
    not nest their launches under the range; the ranges on the card's
    timeline hold every op launched inside them, ctypes launches included.
    A stage with no device-side range reads None."""
    out = {}
    for stage in stages:
        spans = [(e.time_range.start, e.time_range.end) for e in events
                 if e.name == stage and e.device_type.name == "CUDA"]
        key = stage.split(".")[1]
        out[key] = None if not spans else round(sum(
            e.self_device_time_total for e in on_card
            if any(s <= e.time_range.start and e.time_range.end <= t for s, t in spans)) / 1e3, 3)
    return out


def main_workload(gen, dev, states=None):
    """The main path's workload on the card, drawn from ``gen``: N points
    of dimension D (clustered, 250 clusters, spread 0.02, normalize_scale),
    N_QUERIES_LARGE queries, and the index built with derive(c=1.5, t=64,
    k=K_NN, K=10, L=5, inline_vectors=True).  Returns (data, queries,
    params, index); ``states``, a list, gets the generator's state just
    before the build."""
    from repro_torch.core import DBLSHParams, build
    from repro_torch.data import make_clustered, normalize_scale

    pts = make_clustered(gen, N + N_QUERIES_LARGE, D, n_clusters=N // 4000,
                         spread=0.02, device=dev)
    data, queries, _ = normalize_scale(pts[:N], pts[N:])
    del pts
    params = DBLSHParams.derive(n=N, d=D, c=1.5, t=64, k=K_NN, K=10, L=5,
                                inline_vectors=True)
    if states is not None:
        states.append(gen.get_state())
    return data, queries, params, build(data, params, generator=gen, device=dev)


def pool_inputs(kernels, wrappers, index, Qb, exact: bool, kw: dict):
    """The calls of B4 and B5 on the search's own selection: the blocks,
    projections and queries that the one-pass ``inline`` search of ``Qb``
    gives its fused kernel B1 at the final radius, handed to
    ``_gather_pool``'s ``inline`` (B4) and ``kernel`` (B5) engines.
    Returns B1's captured call and {"window_dist": B4's, "candidate_dist":
    B5's}, each as (args, kwargs)."""
    from repro_torch.core import search_batch_fixed
    from repro_torch.core.serve_search import _gather_pool

    wa, wk = capture_calls(kernels, wrappers, "fused_window_search", lambda: (
        search_batch_fixed(index, Qb, engine="inline", exact=exact, **kw)))
    blk_q, G, Qq = wa[0], wa[6], wa[7]
    calls = {name: capture_calls(kernels, wrappers, name, lambda e=e: (
        _gather_pool(index, blk_q, G, Qq, e, exact)))
        for name, e in zip(POOL, ("inline", "kernel"))}
    return (wa, wk), calls


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


def misaligned(torch, t):
    """A contiguous copy of ``t`` whose base lies one element into its
    buffer: not 16-byte aligned."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


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
        compact,
        delete,
        insert,
        live_count,
        quantize_blocks,
        search_batch_fixed,
        search_batch_fixed_dispatch,
        search_batch_fixed_ref,
    )
    from repro_torch.core.serve_search import _gather_pool
    from repro_torch.data import make_clustered, normalize_scale
    from repro_torch.kernels import _build, ref

    dev = torch.device("cuda")
    wrappers = {name: getattr(kernels, name) for name in KERNELS}
    twins = {name: getattr(ref, f"{name}_ref") for name in KERNELS}
    max_err = {name: 0.0 for name in (*KERNELS, *B3)}
    b3_bits = {name: True for name in B3}  # int8: every output bit-equal to the twin so far
    engines = ("torch", "kernel", "inline")
    t_start = t_phase = time.perf_counter()

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

    # B3: the quantized modes at tests/test_kernels.py:280-357's shapes
    # (invalid block ids, steps 6), ragged Ct, and the shortlist ks = 40; on
    # a generator of their own, so that the main path's data stays the same
    b3_gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    for mode in QUANT:
        for Q, L, M, nb, B, K, d, ks in ((2, 2, 4, 8, 32, 4, 16, 8), (2, 2, 4, 8, 32, 4, 24, 40),
                                         (8, 3, 8, 8, 64, 12, 24, 40)):
            args, n = window_case(torch, b3_gen, Q, L, M, nb, B, K, d, 6, dev)
            qargs, qs = quantized_case(torch, args, 3, mode)
            kk = dict(M=M, ks=ks, n=n, mode=mode, x_scale=qs)
            got = kernels.fused_window_search(*qargs, **kk)
            torch.cuda.synchronize()
            err, bits = quant_err(torch, got, ref.fused_window_search_ref(*qargs, **kk), mode,
                                  atol=1e-5)
            name = f"fused_window_search[{mode}]"
            max_err[name], b3_bits[name] = max(max_err[name], err), b3_bits[name] and bits
            n_cases += 1
        for Q, L, Ct, K, d, ks in ((2, 3, 64, 4, 16, 20), (1, 2, 300, 12, 96, 40),
                                   (4, 3, 320, 10, 24, 40)):
            args, n = cand_case(torch, b3_gen, Q, L, Ct, K, d, 6, dev)
            qargs, qs = quantized_case(torch, args, 1, mode)
            kk = dict(ks=ks, n=n, mode=mode, cand_scale=qs)
            got = kernels.fused_cand_search(*qargs, **kk)
            torch.cuda.synchronize()
            err, bits = quant_err(torch, got, ref.fused_cand_search_ref(*qargs, **kk), mode,
                                  atol=1e-5)
            name = f"fused_cand_search[{mode}]"
            max_err[name], b3_bits[name] = max(max_err[name], err), b3_bits[name] and bits
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
    # B4/B5 at tests/test_kernels.py:122-176's shapes, B8 at :496-532's, on
    # a generator of their own (the main path's data stays the same)
    dist_gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    for Q, L, M, nb, B, K, d in ((2, 2, 4, 16, 32, 4, 16), (1, 3, 8, 8, 64, 12, 96)):
        args = dist_window_case(torch, dist_gen, Q, L, M, nb, B, K, d, dev)
        for exact in (False, True):
            max_err["window_dist"] = max(max_err["window_dist"], pool_err(
                torch, wrappers["window_dist"](*args, M=M, exact=exact),
                twins["window_dist"](*args, M=M, exact=exact), args[2], args[5], exact,
                invalid=torch.repeat_interleave((args[0] < 0) | (args[0] >= L * nb), B, 1)))
            n_cases += 1
    for Q, L, Ct, K, d in ((2, 3, 64, 4, 16), (1, 5, 300, 12, 96), (4, 1, 32, 2, 8)):
        args = dist_cand_case(torch, dist_gen, Q, L, Ct, K, d, dev)
        for exact in (False, True):
            got = wrappers["candidate_dist"](*args, exact=exact)
            max_err["candidate_dist"] = max(max_err["candidate_dist"], pool_err(
                torch, got, twins["candidate_dist"](*args, exact=exact), args[1], args[4],
                exact))
            if not exact:
                check(bool(torch.isinf(got[0][torch.isinf(args[2]).reshape(Q, -1)]).all()),
                      "B5: a +inf norm gave a finite norm-form d2")
            n_cases += 1
    # tests/test_kernels.py::test_invalid_slots_never_contribute: every slot
    # invalid, block 0 matching the query exactly
    q1 = torch.randn((1, 8), generator=dist_gen, device=dev)
    inv = (torch.full((1, 4), 4, dtype=torch.int32, device=dev),
           torch.zeros((4, 8, 4), device=dev), q1[0].expand(4, 8, 8).contiguous(),
           (q1 * q1).sum().expand(4, 8).contiguous(), torch.zeros((1, 1, 4), device=dev), q1)
    for exact in (False, True):
        d2_, hw_ = wrappers["window_dist"](*inv, M=4, exact=exact)
        check(bool(torch.isinf(d2_).all() and torch.isinf(hw_).all()),
              "B4: an all-invalid selection gave a finite slot")
        n_cases += 1
    # B4/B5's edges (tests/test_torch_kernels.py's test_dist_kernels_*): the
    # blocks walking many units (5,000 of 64 rows), ragged units (B = 7, 100, 130;
    # Ct = 1, 65, 100, 333), d = 12 / 33 with and without unaligned bases
    # (vectors, projections, queries), odd K, Q = 1 / 5 / 64; one query's
    # blocks all invalid; on integer inputs, so both forms equal the twin bit
    # for bit (and the unaligned call the aligned one)
    dist_edges = [("window", (200, 5, 5, 40, 64, 10, 64), False),
                  ("cand", (200, 5, 320, 10, 64), False)]
    dist_edges += [("window", (6, 3, 4, 9, B, 10, 64), False) for B in (7, 100, 130)]
    dist_edges += [("cand", (6, 3, Ct, 10, 64), False) for Ct in (1, 65, 100, 333)]
    dist_edges += [(kind, shape, mis) for d in (12, 33) for mis in (False, True)
                   for kind, shape in (("window", (9, 3, 5, 12, 64, 10, d)),
                                       ("cand", (9, 3, 150, 10, d)))]
    dist_edges += [(kind, shape, False) for K in (1, 5, 7)
                   for kind, shape in (("window", (7, 3, 5, 12, 64, K, 64)),
                                       ("cand", (7, 3, 130, K, 64)))]
    dist_edges += [(kind, shape, False) for Q in (1, 5, 64)
                   for kind, shape in (("window", (Q, 5, 5, 30, 64, 10, 64)),
                                       ("cand", (Q, 5, 320, 10, 64)))]
    for kind, shape, mis in dist_edges:
        if kind == "window":
            Q, L, M, nb, B, K, d = shape
            args = dist_int_window(torch, dist_gen, Q, L, M, nb, B, K, d, dev)
            if Q > 1:
                args[0][Q // 2] = L * nb
            name, kw, moved = "window_dist", {"M": M}, (1, 2, 5)
        else:
            args = dist_int_cand(torch, dist_gen, *shape, dev)
            name, kw, moved = "candidate_dist", {}, (0, 1, 4)
        margs = [misaligned(torch, t) if mis and i in moved else t for i, t in enumerate(args)]
        for exact in (False, True):
            got = wrappers[name](*margs, exact=exact, **kw)
            check(bit_equal(torch, got, twins[name](*args, exact=exact, **kw)),
                  f"{name} {shape} exact={exact} misaligned={mis} on integers: not bit-equal "
                  f"to the twin")
            if mis:
                check(bit_equal(torch, got, wrappers[name](*args, exact=exact, **kw)),
                      f"{name} {shape} exact={exact}: the unaligned call differs from the "
                      f"aligned one")
            n_cases += 1
    l2_err = {"fp32": 0.0, "bf16": 0.0}  # B8's largest |err| per input type
    # tests/test_kernels.py:496-532's shapes, then the bf16 tile's edges (as
    # tests/test_torch_kernels.py::L2_EDGE_SHAPES): nq past one 128-row
    # tile, nn % 4 != 0, d = 1, 33, 65 (element loads), 72 and 960; then the
    # float32 tiles' (L2_FP32_EDGE_SHAPES): nq around one warp's 64 rows (the
    # 64 x 256 tile up to nq = 64) and one 128-row tile, d = 1, 3, 33, 65
    # and 960 (steps of 16) in both tiles
    l2_shapes = [(8, 16, 8), (256, 512, 128), (100, 300, 65), (1, 1000, 960),
                 (129, 4099, 72), (3000, 4099, 65), (129, 300, 1), (3000, 4096, 64),
                 (129, 4099, 33), (129, 4099, 960)]
    l2_shapes += [(nq, 4099, 64) for nq in (63, 64, 65, 127, 128, 129)]
    l2_shapes += [(nq, 1030, d) for nq in (64, 65) for d in (1, 3, 33, 65, 960)]
    for nq, nn, d in l2_shapes:
        Qa = torch.randn((nq, d), generator=dist_gen, device=dev)
        Xa = torch.randn((nn, d), generator=dist_gen, device=dev)
        for dt, tt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            qa, xa = Qa.to(tt), Xa.to(tt)
            got, want = wrappers["pairwise_l2"](qa, xa), twins["pairwise_l2"](qa, xa)
            err = float((got - want).abs().max())
            check(torch.allclose(got, want, rtol=1e-4, atol=1e-4 * d),
                  f"B8 {dt} ({nq}, {nn}, {d}): differs from the twin by {err}")
            l2_err[dt] = max(l2_err[dt], err)
            n_cases += 1
    # bases not 16-byte aligned (contiguous views one element into their
    # buffers, as tests/test_torch_kernels.py::test_pairwise_l2_kernel_misaligned_base):
    # the element loads, bit-equal to the aligned call and close to the twin
    Xa = torch.randn((1030, 64), generator=dist_gen, device=dev)
    for nq in (64, 129):
        Qa = torch.randn((nq, 64), generator=dist_gen, device=dev)
        for dt, tt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            qa, xa = Qa.to(tt), Xa.to(tt)
            aligned_out = wrappers["pairwise_l2"](qa, xa)
            for mis_q, mis_x in ((True, False), (False, True), (True, True)):
                qm, xm = (misaligned(torch, a) if m else a
                          for a, m in ((qa, mis_q), (xa, mis_x)))
                got, want = wrappers["pairwise_l2"](qm, xm), twins["pairwise_l2"](qa, xa)
                err = float((got - want).abs().max())
                check(torch.equal(got, aligned_out) and
                      torch.allclose(got, want, rtol=1e-4, atol=1e-4 * 64),
                      f"B8 {dt} ({nq}, 1030, 64) with a misaligned base (Q {mis_q}, X "
                      f"{mis_x}): not bit-equal to the aligned call, or differs from the "
                      f"twin by {err}")
                l2_err[dt] = max(l2_err[dt], err)
                n_cases += 1
    # integers in -4..4, d <= 64: every sum is exact in float32, so B8 equals
    # its twin bit for bit (in bf16 a fragment mix-up shows as a wrong value)
    for nq, nn, d in ((129, 4099, 64), (3000, 1000, 33), (65, 4096, 1), (300, 515, 56),
                      (63, 4099, 64), (127, 1030, 3)):
        Qa, Xa = (torch.randint(-4, 5, (m, d), generator=dist_gen, device=dev).float()
                  for m in (nq, nn))
        for dt, tt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
            qa, xa = Qa.to(tt), Xa.to(tt)
            got, want = wrappers["pairwise_l2"](qa, xa), twins["pairwise_l2"](qa, xa)
            check(torch.equal(got, want), f"B8 {dt} ({nq}, {nn}, {d}) on integers: not "
                  f"bit-equal to the twin (max |err| {float((got - want).abs().max())})")
            n_cases += 1
    max_err["pairwise_l2"] = max(l2_err.values())
    print(f"[twins] ok: {n_cases} kernel-vs-twin cases agree (counts equal, "
          f"rtol = atol = 1e-5, id sets per bin / per query; B3 bf16: bin id overlap "
          f">= 0.98; B4/B5: hw bit-equal, d2 rtol 1e-5 + atol {NORM_ATOL} x the norms "
          f"where hw is finite, +inf on invalid blocks, and bit-equal at their edges on "
          f"integer inputs; B8 fp32/bf16: rtol 1e-4, "
          f"atol 1e-4 x d, and bit-equal on integer inputs); max |err| {max_err}; B3 "
          f"outputs bit-equal to the twin: "
          f"{json.dumps({k_: v for k_, v in b3_bits.items()})} ({phase_s():.1f} s)", flush=True)

    # -------------------------------------------------------- 3. main path
    t0 = time.perf_counter()
    build_state = []  # the generator's state at the build, for phase 13
    data, queries, params, index = main_workload(gen, dev, build_state)
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
    norm_atol = NORM_ATOL * (float(index.norm_blocks[torch.isfinite(index.norm_blocks)].max())
                             + float((Q64 * Q64).sum(-1).max()))
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
        ties = norm_edge_ties(torch, results[engine, False][:2], results["torch", False][:2],
                              norm_atol)
        recall = sum(len(a & b) for a, b in zip(sets_norm, gt_sets)) / (N_QUERIES * K_NN)
        onepass_recall[engine] = recall
        print(f"[main] {engine:6s}: recall@{K_NN} {recall:.4f}, id-set parity with "
              f"torch: exact {par_exact:.4f}, norm {par_norm:.4f} (raw; {ties} queries "
              f"differ only at near-ties with the k-th distance)", flush=True)
        check(par_exact == 1.0, f"{engine}: exact-mode id sets differ from the torch engine")
        check(recall >= 0.5, f"{engine}: recall@{K_NN} {recall} < 0.5")
    s = results["torch", False][2]
    check(all(torch.equal(results[e, False][2][key], s[key])
              for e in engines for key in s), "stats differ across engines")

    # the kernels on the inputs the main path gives them at both batches
    # (the Q = 1024 ones under the name "<wrapper>@1024"), vs their twins
    captured = {}
    for (name, engine), (Qn, Qb) in itertools.product(
            (("fused_window_search", "inline"), ("fused_cand_search", "kernel")),
            ((N_QUERIES, Q64), (N_QUERIES_LARGE, Q1k))):
        key = name if Qn == N_QUERIES else f"{name}@{Qn}"
        captured[key] = capture_calls(
            kernels, wrappers, name,
            lambda: search_batch_fixed(index, Qb, engine=engine, **kw))
        a, k = captured[key]
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
    print(f"[main] ok: kernels agree with their twins on the main path's inputs at Q = "
          f"{N_QUERIES} and {N_QUERIES_LARGE} (norm form atol 4e-6 x the norms, {scale:.1f} "
          f"at the last, exact form 1e-5); max |err| {max_err} "
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
    # B6/B7 on the path's own inputs at both batches (the Q = 1024 ones
    # under "<wrapper>@1024"), against their twins
    for (name, engine), (Qn, Qb) in itertools.product(
            (("window_verify", "inline"), ("candidate_verify", "kernel")),
            ((N_QUERIES, Q64), (N_QUERIES_LARGE, Q1k))):
        key = name if Qn == N_QUERIES else f"{name}@{Qn}"
        captured[key] = capture_calls(
            kernels, wrappers, name,
            lambda: search_batch_fixed_ref(index, Qb, engine=engine, **kw))
        a, k = captured[key]
        err = topk_err(torch, wrappers[name](*a, **k), twins[name](*a, **k), k["n"],
                       edge_ties=True)
        max_err[name] = max(max_err[name], err)
    torch.cuda.synchronize()
    print(f"[multipass] ok: B6/B7 agree with their twins on the path's inputs at Q = "
          f"{N_QUERIES} and {N_QUERIES_LARGE} (rtol = atol = 1e-5); max |err| {max_err} "
          f"({phase_s():.1f} s)", flush=True)

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

    # ---------------------------------------- 7. quant: kernel B3 on the path
    # the main index quantized in place: the same blocks and hash functions
    t0 = time.perf_counter()
    quant_index = {}
    for dt in QUANT:
        qb, qsc = quantize_blocks(data, index.ids_blocks, dt)
        quant_index[dt] = dataclasses.replace(
            index, params=dataclasses.replace(params, quant_dtype=dt), qvec_blocks=qb,
            qvec_scale=qsc)
    torch.cuda.synchronize()
    sizes = {dt: (quant_index[dt].memory_bytes() - index.memory_bytes()) / 1e9 for dt in QUANT}
    print(f"[quant] quantized blocks: {json.dumps(sizes)} GB on the card, in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    _, gt1k = brute_force(data, Q1k, k=K_NN, device=dev)
    batches = {N_QUERIES: (Q64, gt_sets),
               N_QUERIES_LARGE: (Q1k, [set(r) for r in gt1k.cpu().tolist()])}
    fp32 = {(N_QUERIES, e): results[e, False] for e in engines}
    fp32.update({(N_QUERIES_LARGE, e): search_batch_fixed(index, Q1k, engine=e, **kw)
                 for e in engines})

    kernels.reset_launches()
    quant_results, quant_per_run = {}, {}
    for Qn, (Qb, _) in batches.items():
        for e in engines:
            for dt in QUANT:
                before = {w: dict(kernels.mode_launches[w]) for w in FUSED}
                quant_results[Qn, e, dt] = search_batch_fixed(quant_index[dt], Qb, engine=e,
                                                              dtype=dt, **kw)
                quant_per_run[f"{e}:{dt}@{Qn}"] = {
                    f"{w}[{m}]": kernels.mode_launches[w][m] - before[w][m]
                    for w in FUSED for m in kernels.mode_launches[w]
                    if kernels.mode_launches[w][m] != before[w][m]}
    torch.cuda.synchronize()
    quant_launches = {name: kernels.mode_launches[w][m] for name, (w, m) in B3.items()}
    for name, count in quant_launches.items():
        check(count > 0, f"the quantized path never launched {name}")
    check(not any(kernels.mode_launches[w][m] for w in FUSED for m in ("norm", "exact")),
          "the quantized path launched a float32 mode")
    print(f"[quant] launches per search (Q=64 and 1024, each engine and dtype): "
          f"{json.dumps(quant_per_run)}", flush=True)

    quant_summary = {}
    for (Qn, e, dt), (dd, ii, st) in quant_results.items():
        Qb, gts = batches[Qn]
        fd, fi, fst = fp32[Qn, e]
        check(tuple(dd.shape) == (Qn, K_NN) and bool(torch.isfinite(dd[:, 0]).all()),
              f"quant {e} {dt}@{Qn}: shape or an empty result")
        sets, fsets = idsets(torch, dd, ii), idsets(torch, fd, fi)
        recall = sum(len(a & b) for a, b in zip(sets, gts)) / (Qn * K_NN)
        f_recall = sum(len(a & b) for a, b in zip(fsets, gts)) / (Qn * K_NN)
        overlap = sum(len(a & b) for a, b in zip(sets, fsets)) / (Qn * K_NN)
        check(recall >= f_recall - 0.02,
              f"quant {e} {dt}@{Qn}: recall@{K_NN} {recall} < fp32 {f_recall} - 0.02")
        # the re-rank contract: each returned distance is its id's float32
        # distance, against a float64 diff-form oracle (norm-scaled atol)
        fin = torch.isfinite(dd)
        x = data[ii.clamp(0, N - 1).long()].double()
        true2 = ((x - Qb[:, None, :].double()) ** 2).sum(-1)
        scale2 = (x * x).sum(-1) + (Qb.double() ** 2).sum(-1, keepdim=True)
        rerr = (dd.double() ** 2 - true2).abs()
        check(bool((rerr[fin] <= 1e-5 * true2[fin] + 4e-6 * scale2[fin]).all()),
              f"quant {e} {dt}@{Qn}: a returned distance is off its id's float32 distance "
              f"by {float(rerr[fin].max())}")
        # stats: where the quantized top-k is the float32 one, the schedule
        # ran the same steps (C2 reads re-ranked float32 distances)
        same = torch.tensor([a == b for a, b in zip(sets, fsets)], device=dev)
        for key in st:
            check(torch.equal(st[key][same], fst[key][same]),
                  f"quant {e} {dt}@{Qn}: {key} differs from fp32 where the ids agree")
        quant_summary[f"{e}:{dt}@{Qn}"] = {
            "recall": recall, "fp32_recall": f_recall, "overlap_with_fp32": overlap,
            "queries_with_fp32_ids": int(same.sum()),
            "stats_equal_all": all(torch.equal(st[key], fst[key]) for key in st)}
    print(f"[quant] recall@{K_NN} vs brute force, id overlap with fp32, stats: "
          f"{json.dumps(quant_summary)}", flush=True)

    # Termination(): C1 counts float32 admissions and C2 reads float32 distances
    term_equal = {}
    for e in engines:
        ekw = dict(kw, engine=e, with_explain=True, termination=Termination())
        fd, fi, fst, fex = search_batch_fixed(index, Q64, **ekw)
        for dt in QUANT:
            qd, qi, qst, qex = search_batch_fixed(quant_index[dt], Q64, dtype=dt, **ekw)
            eq = ((fst["radius_steps"] == qst["radius_steps"])
                  & (fex["term_cause"] == qex["term_cause"]))
            same = torch.tensor([a == b for a, b in zip(idsets(torch, qd, qi),
                                                        idsets(torch, fd, fi))], device=dev)
            check(bool(eq[same].all()), f"quant {e} {dt}: Termination() stats differ from "
                  f"fp32 on a query whose ids equal fp32's")
            term_equal[f"{e}:{dt}"] = [int(eq.sum()), int(same.sum())]
    print(f"[quant] Termination(): [queries whose radius_steps and term_cause equal fp32's, "
          f"queries whose ids equal fp32's] of {N_QUERIES}: {json.dumps(term_equal)}",
          flush=True)

    # each B3 launch against its twin on the path's own inputs, at both
    # batches (the Q = 1024 ones under "<name>@1024")
    captured_b3 = {}
    for (name, (w, m)), (Qn, Qb) in itertools.product(B3.items(), batches.items()):
        engine = "inline" if w == "fused_window_search" else "kernel"
        key = name if Qn == N_QUERIES else f"{name}@{Qn}"
        captured_b3[key] = capture_calls(
            kernels, wrappers, w,
            lambda: search_batch_fixed(quant_index[m], Qb[0], engine=engine, dtype=m, **kw))
        a, k = captured_b3[key]
        nrm, q = (a[4], a[7]) if w == "fused_window_search" else (a[2], a[6])
        scale = float(nrm[torch.isfinite(nrm)].max()) + float((q * q).sum(-1).max())
        err, bits = quant_err(torch, wrappers[w](*a, **k), twins[w](*a, **k), m,
                              atol=1e-5 if m == "int8" else 4e-6 * scale)
        max_err[name], b3_bits[name] = max(max_err[name], err), b3_bits[name] and bits
    torch.cuda.synchronize()
    print(f"[quant] ok: B3 agrees with its twin on the path's inputs at Q = {N_QUERIES} and "
          f"{N_QUERIES_LARGE} (int8: rtol = atol = "
          f"1e-5; bf16: ids >= 0.98, atol 4e-6 x {scale:.1f}); max |err| "
          f"{ {n_: max_err[n_] for n_ in B3} }; bit-equal to the twin: {json.dumps(b3_bits)} "
          f"({phase_s():.1f} s)", flush=True)

    # ------------------------------------- 8. updates on the int8 index
    # new points around existing ones (~0.5 from a random point, the median
    # nearest-neighbour distance being 1), on a generator of their own
    upd_gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    near_of = torch.randint(0, N, (N_INSERT,), generator=upd_gen, device=dev)
    noise = torch.randn((N_INSERT, D), generator=upd_gen, device=dev) * (0.5 / D ** 0.5)
    extra = data[near_of] + noise
    qidx = quant_index["int8"]
    t0 = time.perf_counter()
    ins_index = insert(qidx, extra)
    torch.cuda.synchronize()
    insert_s = time.perf_counter() - t0
    n_all = N + N_INSERT
    check(ins_index.n == n_all and live_count(ins_index) == n_all, "insert: wrong point count")
    # the victims: the true nearest neighbour of each of the 1024 queries,
    # then random old ids
    near = torch.unique(gt1k[:, 0])
    rest = torch.randperm(N, generator=gen, device=dev)
    rest = rest[~torch.isin(rest, near)][:N_DELETE - near.numel()]
    victims = torch.cat([near, rest]).to(torch.int32)
    t0 = time.perf_counter()
    del_index = delete(ins_index, victims)
    torch.cuda.synchronize()
    delete_s = time.perf_counter() - t0
    check(live_count(del_index) == n_all - N_DELETE, "delete: wrong live count")
    live = torch.ones(n_all, dtype=torch.bool, device=dev)
    live[victims.long()] = False
    live_ids = torch.nonzero(live)[:, 0]
    _, gt_live = brute_force(del_index.data[live_ids], Q64, k=K_NN, device=dev)
    gt_live = [set(r) for r in live_ids[gt_live].cpu().tolist()]
    victim_set = set(victims.cpu().tolist())
    upd_summary = {}
    probes = extra[:4]
    for e in engines:
        for dt in ("fp32", "int8"):
            dd, ii = search_batch_fixed(del_index, Q64, engine=e, dtype=dt, **kw)[:2]
            sets = idsets(torch, dd, ii)
            check(not victim_set & set().union(*sets), f"updates {e} {dt}: a deleted id returned")
            recall = sum(len(a & b) for a, b in zip(sets, gt_live)) / (N_QUERIES * K_NN)
            check(recall >= 0.5, f"updates {e} {dt}: recall@{K_NN} over the live points {recall}")
            upd_summary[f"{e}:{dt}"] = recall
        # a query placed on an inserted point returns it, at d ~ 0
        pd_, pi_ = search_batch_fixed(del_index, probes, k=1, r0=0.25, steps=STEPS, engine=e,
                                      exact=True, device=dev)
        want = torch.arange(N, N + probes.shape[0], device=dev, dtype=torch.int32)
        check(torch.equal(pi_[:, 0], want) and bool((pd_[:, 0] < 1e-3).all()),
              f"updates {e}: an inserted point was not found at distance ~0: "
              f"{pi_[:, 0].tolist()} {pd_[:, 0].tolist()}")
    del ins_index, del_index
    # delete at full scale, held against the original index: with every true
    # 10-NN of the 64 queries deleted, the second-tier targets must be found
    # as often as the original fp32 index finds them (its top-30, the deleted
    # ids filtered out)
    tier2 = torch.unique(gt.reshape(-1)).to(torch.int32)
    tier2_set = set(tier2.cpu().tolist())
    keep = torch.ones(N, dtype=torch.bool, device=dev)
    keep[tier2.long()] = False
    keep_ids = torch.nonzero(keep)[:, 0]
    _, gt2 = brute_force(data[keep_ids], Q64, k=K_NN, device=dev)
    gt2 = [set(r) for r in keep_ids[gt2].cpu().tolist()]
    del2 = delete(index, tier2)
    tier2_recall = {}
    for e in engines:
        wide = search_batch_fixed(index, Q64, engine=e, **dict(kw, k=3 * K_NN))[1]
        filt = [[i for i in r if i not in tier2_set][:K_NN] for r in wide.cpu().tolist()]
        r_filt = sum(len(set(a) & b) for a, b in zip(filt, gt2)) / (N_QUERIES * K_NN)
        dd, ii = search_batch_fixed(del2, Q64, engine=e, **kw)[:2]
        sets = idsets(torch, dd, ii)
        check(not tier2_set & set().union(*sets), f"updates {e}: a deleted id returned")
        r_del = sum(len(a & b) for a, b in zip(sets, gt2)) / (N_QUERIES * K_NN)
        check(r_del >= r_filt - 0.02, f"updates {e}: recall {r_del} after deleting the "
              f"true 10-NN, the original index's {r_filt} on the same targets")
        tier2_recall[e] = [r_del, r_filt]
    del del2
    print(f"[updates] delete of the {tier2.numel()} true 10-NN of the {N_QUERIES} queries "
          f"(fp32): recall@{K_NN} on the second-tier targets [after delete, original "
          f"index filtered]: {json.dumps(tier2_recall)}", flush=True)
    # compact re-derives K and L for the live n by the paper's formulas, as
    # the reference does; on this workload that is K = 3572, L = 2 at
    # n = 1M (a ~29 GB projection array), so compact runs on a 100k-point
    # int8 index (K = 2721, L = 2 after compaction) with the same updates
    sub_n = N_COMPACT
    sub = build(data[:sub_n], DBLSHParams.derive(n=sub_n, d=D, c=1.5, t=64, k=K_NN, K=10,
                                                 L=5, inline_vectors=True, quant_dtype="int8"),
                generator=gen, device=dev)
    sub = delete(insert(sub, extra[:N_INSERT // 10]), victims[victims < sub_n])
    n_sub_all, sub_live = sub.n, live_count(sub)
    t0 = time.perf_counter()
    cidx, id_map = compact(sub, generator=gen)
    torch.cuda.synchronize()
    compact_s = time.perf_counter() - t0
    check(cidx.n == sub_live and int((id_map >= 0).sum()) == sub_live,
          "compact: wrong point count")
    dd, ii = search_batch_fixed(cidx, Q64, engine="inline", dtype="int8", **kw)[:2]
    inv = torch.full((cidx.n + 1,), -1, dtype=torch.long, device=dev)
    inv[id_map[id_map >= 0].long()] = torch.nonzero(id_map >= 0)[:, 0]
    sets = idsets(torch, dd, inv[ii.long()])
    sub_ids = torch.nonzero(id_map >= 0)[:, 0]
    sub_x = torch.cat([data[:sub_n], extra[:N_INSERT // 10]])[sub_ids]
    _, gt_sub = brute_force(sub_x, Q64, k=K_NN, device=dev)
    gt_sub = [set(r) for r in sub_ids[gt_sub].cpu().tolist()]
    # compact's re-derived K and L differ from the main path's, so its
    # recall is reported, not held to the main path's gate
    c_recall = sum(len(a & b) for a, b in zip(sets, gt_sub)) / (N_QUERIES * K_NN)
    check(bool(torch.isfinite(dd[:, 0]).all()) and -1 not in set().union(*sets),
          "compact: a query found nothing, or a deleted point came back")
    check(not set(victims[victims < sub_n].tolist()) & set().union(*sets),
          "compact: a deleted id came back")
    print(f"[updates] ok: int8 index, insert {N_INSERT} in {insert_s:.3f} s, delete "
          f"{N_DELETE} (the {near.numel()} distinct true 1-NN of the {N_QUERIES_LARGE} "
          f"queries among them) in "
          f"{delete_s:.3f} s, compact of a {n_sub_all}-point int8 index to {cidx.n} in "
          f"{compact_s:.3f} s; no deleted id "
          f"returned; inserted points found at d ~ 0 (exact); recall@{K_NN} over the live "
          f"points {json.dumps(upd_summary)}, after compact (int8, inline; K={cidx.params.K} "
          f"L={cidx.params.L} M={cidx.params.max_blocks}) {c_recall:.4f} "
          f"({phase_s():.1f} s)", flush=True)
    del sub, cidx

    # ---------------------------------- 9. pool engines: kernels B4 and B5
    # _gather_pool on each engine, on the blocks, projections and queries
    # that the one-pass search gives its fused kernels at the final radius
    want_pool = {"torch": {}, "kernel": {"candidate_dist": 1}, "inline": {"window_dist": 1}}
    pool_launches = dict.fromkeys(POOL, 0)
    pool_calls, pool_summary = {}, {}
    for Qn, Qb in ((N_QUERIES, Q64), (N_QUERIES_LARGE, Q1k)):
        atol = NORM_ATOL * norm_scale(torch, data, Qb)
        for exact in (False, True):
            form = "exact" if exact else "norm"
            (wa, wk), calls = pool_inputs(kernels, wrappers, index, Qb, exact, kw)
            ca, ck = capture_calls(kernels, wrappers, "fused_cand_search", lambda: (
                search_batch_fixed(index, Qb, engine="kernel", exact=exact, **kw)))
            blk_q, halves_t, G, Qq = wa[0], wa[1], wa[6], wa[7]
            pools = {}
            kernels.reset_launches()
            for e in engines:
                before = dict(kernels.launches)
                pools[e] = _gather_pool(index, blk_q, G, Qq, e, exact)
                delta = {n_: kernels.launches[n_] - before[n_] for n_ in KERNELS
                         if kernels.launches[n_] != before[n_]}
                check(delta == want_pool[e], f"pool {e}@{Qn} {form}: launches {delta}, "
                      f"want {want_pool[e]}")
            torch.cuda.synchronize()
            for n_ in POOL:
                pool_launches[n_] += kernels.launches[n_]
            hw_t = pools["torch"][1]
            for e in ("kernel", "inline"):
                check(torch.equal(pools[e][1], hw_t), f"pool {e}@{Qn} {form}: hw differs from "
                      f"the torch engine's")
            fin = torch.isfinite(hw_t)
            d_k, d_i, d_t = (pools[e][0][fin] for e in ("kernel", "inline", "torch"))
            check(torch.equal(d_k, d_i), f"pool @{Qn} {form}: B5's d2 differs from B4's")
            if exact:  # sequential fmaf chain vs torch's reduction, d = 64 terms
                ulp = torch.nextafter(d_t, torch.full_like(d_t, torch.inf)) - d_t
                ulps = float(((d_i - d_t).abs() / ulp).max())
                check(torch.allclose(d_i, d_t, rtol=D * 2.0 ** -24, atol=0.0),
                      f"pool @{Qn} exact: d2 {ulps} ulps from the torch engine")
                diff = {"max_ulps": ulps}
            else:
                err = float((d_i - d_t).abs().max())
                check(torch.allclose(d_i, d_t, rtol=1e-5, atol=atol),
                      f"pool @{Qn} norm: d2 differs from the torch engine by {err}")
                diff = {"max_abs": err, "atol": atol}
            # the pools, binned, against the serving kernels B1 and B2
            ids = ref.take_fill(wa[5], blk_q, index.n).reshape(Qn, -1)
            b4_bins = ref.bins_from_pool(*pools["inline"], ids, halves_t, index.n, wk["ks"])
            b5_bins = ref.bins_from_pool(*pools["kernel"], ca[3].reshape(Qn, -1), ca[4],
                                         index.n, ck["ks"])
            b1 = wrappers["fused_window_search"](*wa, **wk)
            b2 = wrappers["fused_cand_search"](*ca, **ck)
            check(all(torch.equal(x, y) for x, y in zip(b4_bins, b1)),
                  f"B4's pool, binned, differs from B1's bins @{Qn} {form}")
            check(all(torch.equal(x, y) for x, y in zip(b5_bins, b2)),
                  f"B5's pool, binned, differs from B2's bins @{Qn} {form}")
            for name in POOL:
                pool_calls[name, Qn, exact] = a, k = calls[name]
                x, q_ = (a[2], a[5]) if name == "window_dist" else (a[1], a[4])
                max_err[name] = max(max_err[name], pool_err(
                    torch, wrappers[name](*a, **k), twins[name](*a, **k), x, q_, exact))
            pool_summary[f"{form}@{Qn}"] = {"slots": int(fin.numel()),
                                            "finite_hw": int(fin.sum()), **diff}
    torch.cuda.synchronize()
    print(f"[pool] ok: _gather_pool on torch/kernel/inline at Q={N_QUERIES} and "
          f"{N_QUERIES_LARGE}, norm and exact: one launch of B5 (kernel) or B4 (inline) per "
          f"call ({json.dumps(pool_launches)} in all), hw bit-equal across the engines, d2 of B4 "
          f"and B5 bit-equal, within rtol 1e-5 + atol {NORM_ATOL} x the norms (norm) or "
          f"d x 2^-24 (exact) of torch; B4's pool binned == B1's bins and B5's == B2's, bit for "
          f"bit; B4/B5 vs their twins on these inputs (max |err| "
          f"{ {n_: max_err[n_] for n_ in POOL} }): {json.dumps(pool_summary)} "
          f"({phase_s():.1f} s)", flush=True)

    # ------------------------------------- 10. brute-force matrix: kernel B8
    X16 = data.to(torch.bfloat16)
    l2_launches, l2_summary = {"fp32": 0, "bf16": 0}, {}
    for Qn, Qb, gt_ids in ((N_QUERIES, Q64, gt), (N_QUERIES_LARGE, Q1k, gt1k)):
        scale = norm_scale(torch, data, Qb)
        atol = max(1e-4 * D, NORM_ATOL * scale)
        for dt in ("fp32", "bf16"):
            qa, xa = (Qb, data) if dt == "fp32" else (Qb.to(torch.bfloat16), X16)
            kernels.reset_launches()
            dm = kernels.pairwise_l2(qa, xa)
            torch.cuda.synchronize()
            check({n_: c for n_, c in kernels.launches.items() if c} == {"pairwise_l2": 1},
                  f"brute {dt}@{Qn}: launches {kernels.launches}")
            l2_launches[dt] += kernels.launches["pairwise_l2"]
            check(tuple(dm.shape) == (Qn, N) and bool(torch.isfinite(dm).all())
                  and bool((dm >= 0).all()), f"brute {dt}@{Qn}: shape or values")
            for r0 in range(0, Qn, 128):  # the twin in row chunks, beside the matrix
                want = twins["pairwise_l2"](qa[r0:r0 + 128], xa)
                err = float((dm[r0:r0 + 128] - want).abs().max())
                check(torch.allclose(dm[r0:r0 + 128], want, rtol=1e-4, atol=atol),
                      f"brute {dt}@{Qn}: rows {r0}+ differ from the twin by {err}")
                l2_err[dt] = max(l2_err[dt], err)
                del want
            ids = torch.topk(dm, K_NN, dim=1, largest=False).indices
            del dm
            sets, gsets = ([set(r) for r in t.cpu().tolist()] for t in (ids, gt_ids))
            same = sum(a == b for a, b in zip(sets, gsets)) / Qn
            overlap = sum(len(a & b) for a, b in zip(sets, gsets)) / (Qn * K_NN)
            if dt == "fp32":  # equal to brute_force's, up to near-ties at the 10th
                truth = ((data[gt_ids].double() - Qb[:, None].double()) ** 2).sum(-1)
                kth = truth.amax(dim=1).cpu().tolist()
                for q_, (a, b) in enumerate(zip(sets, gsets)):
                    if a == b:
                        continue
                    diff = torch.tensor(sorted(a ^ b), device=dev)
                    d2 = ((data[diff].double() - Qb[q_].double()) ** 2).sum(-1)
                    check(bool(((d2 - kth[q_]).abs() <= NORM_ATOL * scale + 1e-5 * kth[q_]).all()),
                          f"brute fp32@{Qn}: top-{K_NN} ids differ from brute_force's at query "
                          f"{q_}, off the k edge")
            l2_summary[f"{dt}@{Qn}"] = {"ids_equal_to_brute_force": same,
                                        "id_overlap": overlap}
    max_err["pairwise_l2"] = max(max_err["pairwise_l2"], *l2_err.values())
    print(f"[brute] ok: pairwise_l2 (B8) of {N_QUERIES} and {N_QUERIES_LARGE} queries against "
          f"the {N} points, fp32 and bf16 (queries and data cast): one launch each "
          f"({json.dumps(l2_launches)}); against the twin in row chunks (rtol 1e-4, atol "
          f"max(1e-4 x d, {NORM_ATOL} x the norms)): max |err| {json.dumps(l2_err)}; fp32 "
          f"top-{K_NN} ids equal to brute_force's up to near-ties at the {K_NN}th distance; "
          f"{json.dumps(l2_summary)} ({phase_s():.1f} s)", flush=True)

    # ----------------------------------------------------------- 11. times
    records = []
    path_launches = {**{n_: onepass_launches[n_] for n_ in FUSED},
                     **{n_: multi_launches[n_] for n_ in VERIFY}}
    path_launches.update(quant_launches)
    # B1/B2, B6/B7 and each B3 instantiation at both batches (path_launches
    # and max_abs_err are the kernel's, over the batches)
    timed = [(name, name, *KERNELS[name], captured[name]) for name in (*FUSED, *VERIFY)]
    timed += [(f"{name}@{N_QUERIES_LARGE}", name, *KERNELS[name],
               captured[f"{name}@{N_QUERIES_LARGE}"]) for name in (*FUSED, *VERIFY)]
    timed += [(name + sfx, w, KERNELS[w][0], B3_REPLACES, captured_b3[name + sfx])
              for sfx in ("", f"@{N_QUERIES_LARGE}") for name, (w, _) in B3.items()]
    for name, wrapper, source, replaces, (a, k) in timed:
        base = name.split("@")[0]
        ms = cuda_ms(torch, lambda: wrappers[wrapper](*a, **k), iters=50)
        plain_ms = cuda_ms(torch, lambda: twins[wrapper](*a, **k), iters=5)
        dev_us, dev_how = device_us(torch, lambda: wrappers[wrapper](*a, **k),
                                    f"{wrapper}_kernel")
        in_bytes, out_bytes, ops, ops_ms = work(torch, wrapper, a, k)
        bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        records.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": path_launches[base], "max_abs_err": max_err[base],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": bound_by, "library_ms": None,
        })
        q_rows = a[-2] if wrapper in VERIFY else a[7 if wrapper == "fused_window_search" else 6]
        host = (f"host {host_us(torch, lambda: wrappers[wrapper](*a, **k)):.1f} us/call; "
                if wrapper in VERIFY else "")
        print(f"[times] {name}: median {ms:.4f} ms/launch at Q={q_rows.shape[0]} "
              f"(device {dev_us:.1f} us by {dev_how}; {host}twin {plain_ms:.3f} "
              f"ms), bound {max(bytes_ms, ops_ms) * 1e3:.2f} us by {bound_by} "
              f"({(in_bytes + out_bytes) / 1e6:.2f} MB, {ops / 1e6:.1f} Mop)", flush=True)

    # B4/B5 in the norm form (the search's default) and B8 in fp32 and bf16,
    # at both batches, with their device time and, for B8, the library's
    # matrix: torch.cdist (TF32 off; the matrix up to its square root, on the
    # same fp32 or bf16 inputs) and the product Q @ X.T alone
    extra_rows = [(name if Qn == N_QUERIES else f"{name}@{Qn}", name,
                   pool_calls[name, Qn, False], pool_launches[name])
                  for name in POOL for Qn in (N_QUERIES, N_QUERIES_LARGE)]
    for Qn, Qb in ((N_QUERIES, Q64), (N_QUERIES_LARGE, Q1k)):
        for dt in ("fp32", "bf16"):
            qa, xa = (Qb, data) if dt == "fp32" else (Qb.to(torch.bfloat16), X16)
            extra_rows.append((f"pairwise_l2[{dt}]" + ("" if Qn == N_QUERIES else f"@{Qn}"),
                               "pairwise_l2", ((qa, xa), {}), l2_launches[dt]))
    for name, wrapper, (a, k), count in extra_rows:
        ms = cuda_ms(torch, lambda: wrappers[wrapper](*a, **k), iters=50)
        plain_ms = cuda_ms(torch, lambda: twins[wrapper](*a, **k), iters=5)
        dev_us, dev_how = device_us(torch, lambda: wrappers[wrapper](*a, **k),
                                    f"{wrapper}_kernel")
        in_bytes, out_bytes, ops, ops_ms = work(torch, wrapper, a, k)
        bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        library_ms, lib_note = None, ""
        if wrapper in POOL:  # the host side of a call, and the exact form beside
            ea, ek = pool_calls[wrapper, a[-1].shape[0], True]
            ex_ms = cuda_ms(torch, lambda: wrappers[wrapper](*ea, **ek), iters=50)
            ex_us, ex_how = device_us(torch, lambda: wrappers[wrapper](*ea, **ek),
                                      f"{wrapper}_kernel")
            e_in, e_out, _, e_ops_ms = work(torch, wrapper, ea, ek)
            e_bound = max((e_in + e_out) / HBM_BYTES_PER_S * 1e3, e_ops_ms)
            lib_note = (f"; host {host_us(torch, lambda: wrappers[wrapper](*a, **k)):.1f} "
                        f"us/call; exact form: median {ex_ms:.4f} ms, device {ex_us:.1f} us "
                        f"by {ex_how}, bound {e_bound * 1e3:.2f} us")
        if wrapper == "pairwise_l2":
            library_ms = cuda_ms(torch, lambda: torch.cdist(
                *a, compute_mode="use_mm_for_euclid_dist"), iters=20)
            mm_ms = cuda_ms(torch, lambda: a[0] @ a[1].T, iters=20)
            lib_note = (f", cdist {library_ms:.4f} ms (kernel / cdist {ms / library_ms:.3f}),"
                        f" Q @ X.T alone {mm_ms:.4f} ms (kernel / Q @ X.T {ms / mm_ms:.3f})")
        dt_name = name.split("[")[-1].split("]")[0] if "[" in name else wrapper
        records.append({
            "name": name, "route": "cuda", "source": KERNELS[wrapper][0],
            "replaces": KERNELS[wrapper][1], "launches": count,
            "max_abs_err": l2_err[dt_name] if wrapper == "pairwise_l2" else max_err[wrapper],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": bound_by, "library_ms": library_ms,
        })
        print(f"[times] {name}: median {ms:.4f} ms/launch (device {dev_us:.1f} us by {dev_how}; "
              f"twin {plain_ms:.3f} ms{lib_note}), bound {max(bytes_ms, ops_ms) * 1e3:.2f} us by "
              f"{bound_by} ({(in_bytes + out_bytes) / 1e6:.2f} MB, {ops / 1e6:.1f} Mop)",
              flush=True)

    # wall times: for each batch, engines in turns, each path timed alone
    wall = {}
    searches = {
        "onepass": lambda Qb, e: search_batch_fixed(index, Qb, engine=e, **kw),
        "multipass": lambda Qb, e: search_batch_fixed_ref(index, Qb, engine=e, **kw),
        "terminated": lambda Qb, e: search_batch_fixed(index, Qb, engine=e,
                                                       termination=Termination(), **kw),
        **{dt: (lambda Qb, e, dt=dt: search_batch_fixed(quant_index[dt], Qb, engine=e,
                                                        dtype=dt, **kw)) for dt in QUANT},
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
        quant = {f"{dt}:{e}": round(wall[f"{dt}:{e}@{Qn}"] / wall[f"onepass:{e}@{Qn}"], 3)
                 for dt in QUANT for e in engines}
        print(f"[times] Q={Qn}: multi-pass / one-pass wall {json.dumps(ratio)}; "
              f"Termination() saves {json.dumps(saved)} of the fixed schedule's wall; "
              f"quantized / fp32 one-pass wall {json.dumps(quant)} ({phase_s():.1f} s)",
              flush=True)

    # ------------------------------------------ 12. where the time goes
    from torch.profiler import ProfilerActivity, profile

    stages = ("dblsh.project", "dblsh.select", "dblsh.verify", "dblsh.merge")
    kernel_re = re.compile(r"(\w+)_kernel(?:<(?:\(int\))?(\d)>)?")
    mode_names = ("norm", "exact", *QUANT)
    unattributed = []  # (row, stage): a stage that ran but reads no device time
    lost = []  # rows whose traces held different numbers of device ops
    for path in ("onepass", "multipass", *QUANT):
        for Qn, Qb in ((N_QUERIES, Q64), (N_QUERIES_LARGE, Q1k)):
            for engine in engines:
                searches[path](Qb, engine)
                torch.cuda.synchronize()
                # two profiled calls: a trace can lose the device records of
                # a run of kernels (its op count and busy time drop
                # together), so the one holding more device ops is kept; up
                # to two more when that one reads no device time for a stage
                traces = []
                for attempt in range(4):
                    with profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA]) as prof:
                        # the device records of the first kernels after the
                        # profiler starts can go missing (they were
                        # project's, the first stage), so a few spin
                        # kernels go first, left out below, then a sync
                        for _ in range(8):
                            torch.cuda._sleep(1000)
                        torch.cuda.synchronize()
                        time.sleep(0.002)
                        t0 = time.perf_counter()
                        searches[path](Qb, engine)
                        torch.cuda.synchronize()
                        prof_ms = (time.perf_counter() - t0) * 1e3
                    # kernel events only: the stage annotations also appear
                    # as device-side ranges, which span time rather than fill it
                    events = prof.events()
                    on_card = [e for e in events
                               if e.device_type.name == "CUDA" and e.name not in stages
                               and "spin_kernel" not in e.name]
                    busy_ms = sum(e.self_device_time_total for e in on_card) / 1e3
                    traces.append((len(on_card), busy_ms, prof_ms, on_card,
                                   stage_ms(events, on_card, stages)))
                    best = max(traces, key=lambda tr: tr[0])
                    if attempt >= 1 and all(best[4].values()):
                        break
                row = f"{path} Q={Qn} {engine}"
                if len({tr[0] for tr in traces}) > 1:
                    lost.append(f"{row}: " + " / ".join(str(tr[0]) for tr in traces) + " ops, "
                                + " / ".join(f"{tr[1]:.3f}" for tr in traces) + " busy ms")
                _, busy_ms, prof_ms, on_card, span_ms = best
                unattributed += [(row, key) for key in span_ms if not span_ms[key]]
                by_name = {}
                for e in on_card:
                    by_name[e.name] = by_name.get(e.name, 0.0) + e.self_device_time_total / 1e3
                top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
                # the port's kernels: device time per launch, without the
                # host gap that the CUDA-event times of phase 11 include
                ours = {}
                for e in on_card:
                    m = kernel_re.search(e.name)
                    if m is None or m.group(1) not in KERNELS:
                        continue
                    name = m.group(1)
                    if m.group(2) is not None and mode_names[int(m.group(2))] in QUANT:
                        name = f"{name}[{mode_names[int(m.group(2))]}]"
                    n_, t_ = ours.get(name, (0, 0.0))
                    ours[name] = (n_ + 1, t_ + e.self_device_time_total / 1e3)
                ours = {name: f"{n_} x {t_ / n_ * 1e3:.1f} us" for name, (n_, t_) in ours.items()}
                print(f"[profile] {row}: device busy {busy_ms:.3f} ms of "
                      f"{prof_ms:.3f} ms wall of this call (idle {1 - busy_ms / prof_ms:.3f}; "
                      f"median unprofiled wall {wall[f'{path}:{engine}@{Qn}']:.3f} ms), "
                      f"{len(on_card)} device ops; per stage {span_ms}; our kernels "
                      f"{ours}; top: "
                      + "; ".join(f"{name[:48]} {ms:.3f} ms" for name, ms in top), flush=True)
    check(not unattributed, f"profile: stages that ran read no device time: {unattributed}")
    print(f"[profile] rows whose traces differ in device ops (the largest kept): "
          f"{lost or 'none'}", flush=True)
    print(f"[profile] ok ({phase_s():.1f} s)", flush=True)

    # ------------------------------------- 13. the collection entry point
    from repro_torch.store import Collection, restore_collection
    from repro_torch.tune import RecallTarget
    from repro_torch.tune import calibrate as tune_calibrate

    fields = ("proj_vecs", "proj_blocks", "ids_blocks", "mbr_lo", "mbr_hi", "data",
              "vec_blocks", "norm_blocks", "qvec_blocks", "qvec_scale")

    def same_index(a, b) -> bool:
        return a.params == b.params and all(torch.equal(getattr(a, f), getattr(b, f))
                                            for f in fields)

    def same_search(a, b) -> bool:
        return bit_equal(torch, a, b) and all(torch.equal(a[2][k_], b[2][k_]) for k_ in b[2])

    # create: the generator in the state main_workload built from
    cgen = torch.Generator(device=dev)
    cgen.set_state(build_state[0])
    t0 = time.perf_counter()
    col = Collection.create("main", cgen, data, params=params)
    torch.cuda.synchronize()
    create_s = time.perf_counter() - t0
    check(col.device.type == "cuda" and same_index(col.index, index),
          "Collection.create: its index differs from main_workload's")

    # search: B1 (inline) and B2 (kernel), each with the counts at 0 just
    # before it, against search_batch_fixed on the same index and arguments
    ckw = dict(k=K_NN, r0=R0, steps=STEPS, with_stats=True)
    col_launches = {}
    for e, name in (("inline", "fused_window_search"), ("kernel", "fused_cand_search")):
        kernels.reset_launches()
        got = col.search(Q64, engine=e, **ckw)
        torch.cuda.synchronize()
        col_launches[e] = {n_: c_ for n_, c_ in kernels.launches.items() if c_}
        check(col_launches[e].get(name, 0) > 0, f"Collection.search({e!r}) never launched {name}")
        check(same_search(got, search_batch_fixed(index, Q64, engine=e, **kw)),
              f"Collection.search({e!r}) differs from search_batch_fixed")
    col_wall = {}
    for e in ("inline", "kernel"):  # ABBA: Collection, plain, plain, Collection
        fns = {"collection": lambda e=e: col.search(Q64, engine=e, **ckw),
               "search_batch_fixed": lambda e=e: search_batch_fixed(index, Q64, engine=e, **kw)}
        got = {name: [] for name in fns}
        for name in ("collection", "search_batch_fixed", "search_batch_fixed", "collection"):
            got[name].append(wall_ms(torch, fns[name], repeats=5))
        col_wall[e] = {name: statistics.median(v) for name, v in got.items()}
    print(f"[collection] create (n={N}, on the card) in {create_s:.2f} s, index equal to "
          f"main_workload's; search at Q={N_QUERIES} equal to search_batch_fixed, launches "
          f"{json.dumps(col_launches)}; median wall ms {json.dumps(col_wall)}", flush=True)

    # calibrate on held-out queries, plan a recall target, search with the plan
    held = queries[N_QUERIES_LARGE - 256:].contiguous()
    t0 = time.perf_counter()
    table = col.calibrate(held, k=K_NN, steps_max=STEPS, engine="inline", measure_ms=True)
    calibrate_s = time.perf_counter() - t0
    check(all(b >= a - 1e-9 for a, b in zip(table.recall, table.recall[1:])),
          f"calibrate: recall decreases with steps: {table.recall}")
    plan = col.plan(RecallTarget(0.9))
    pd_, pi_ = col.search(Q64, engine="inline", k=K_NN, r0=plan.r0, steps=plan.steps,
                          termination=plan.termination)
    check(bool(torch.isfinite(pd_[:, 0]).all()), "the planned search found nothing for a query")
    plan_sets = idsets(torch, pd_, pi_)
    plan_recall = sum(len(a & b) for a, b in zip(plan_sets, gt_sets)) / (N_QUERIES * K_NN)
    print(f"[collection] calibrate (256 held-out queries, inline, measure_ms) in "
          f"{calibrate_s:.2f} s: {json.dumps(table.to_dict())}; plan(RecallTarget(0.9)) = "
          f"r0 {plan.r0:.6f}, steps {plan.steps}, {plan.termination}; recall@{K_NN} of its "
          f"search at Q={N_QUERIES} {plan_recall:.4f}", flush=True)

    # updates: the inserts and deletes of phase 8, so its live ground truth holds
    t0 = time.perf_counter()
    new_ids = col.add(extra)
    id_map = col.remove(victims)
    torch.cuda.synchronize()
    update_s = time.perf_counter() - t0
    check(np.array_equal(new_ids, np.arange(N, N + N_INSERT)), "add: unexpected ids")
    check(id_map is None and col.stats.compactions == 0 and not col.should_compact(),
          "add/remove triggered a compaction")
    check(col.live_count() == n_all - N_DELETE, "remove: wrong live count")
    col_upd = {}
    for e in ("inline", "kernel"):
        dd, ii = col.search(Q64, engine=e, k=K_NN, r0=R0, steps=STEPS)
        sets = idsets(torch, dd, ii)
        check(not victim_set & set().union(*sets), f"collection {e}: a removed id returned")
        col_upd[e] = sum(len(a & b) for a, b in zip(sets, gt_live)) / (N_QUERIES * K_NN)
        check(col_upd[e] >= 0.5, f"collection {e}: recall@{K_NN} over the live points "
              f"{col_upd[e]}")
    print(f"[collection] add {N_INSERT} + remove {N_DELETE} in {update_s:.3f} s, no "
          f"compaction; recall@{K_NN} over the live points {json.dumps(col_upd)}", flush=True)

    # snapshot / restore round trips (fp32, then the int8 index) under build/
    snap_root = ROOT / "build"
    snap_root.mkdir(exist_ok=True)
    snap_dir = Path(tempfile.mkdtemp(prefix="collection_snapshot_", dir=snap_root))
    snap = {}
    try:
        for label, c_, dt in (("fp32", col, "fp32"),
                              ("int8", Collection.from_index("main-int8", quant_index["int8"]),
                               "int8")):
            before = {e: c_.search(Q64, engine=e, dtype=dt, **ckw) for e in ("inline", "kernel")}
            where = snap_dir / label
            t0 = time.perf_counter()
            step = c_.snapshot(str(where))
            snap_s = time.perf_counter() - t0
            nbytes = sum(f_.stat().st_size for f_ in (where / f"step_{step:08d}").iterdir())
            t0 = time.perf_counter()
            back = restore_collection(str(where))
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            check(back.device.type == "cuda" and same_index(back.index, c_.index),
                  f"restore ({label}): the index differs")
            check(back.version > c_.version and back.stats == c_.stats
                  and back.built_n == c_.built_n and back.policy == c_.policy
                  and np.array_equal(back._key, c_._key)
                  and json.dumps(None if back.calibration is None else back.calibration.to_dict())
                  == json.dumps(None if c_.calibration is None else c_.calibration.to_dict()),
                  f"restore ({label}): the lifecycle state differs")
            for e in ("inline", "kernel"):
                check(same_search(back.search(Q64, engine=e, dtype=dt, **ckw), before[e]),
                      f"restore ({label}): {e} search differs from before the snapshot")
            snap[label] = {"bytes": nbytes, "snapshot_s": round(snap_s, 3),
                           "restore_s": round(restore_s, 3)}
            del back
    finally:
        shutil.rmtree(snap_dir, ignore_errors=True)
    print(f"[collection] snapshot -> restore_collection onto the card, searches equal "
          f"(fp32 and int8, inline and kernel), table/stats/key equal, fresh version: "
          f"{json.dumps(snap)}", flush=True)
    del col

    # compact a 100k collection (see phase 8) with a retained calibration
    sub_params = DBLSHParams.derive(n=N_COMPACT, d=D, c=1.5, t=64, k=K_NN, K=10, L=5,
                                    inline_vectors=True)
    sub_extra = extra[:N_INSERT // 10]
    scol = Collection.create("sub", torch.Generator(device=dev).manual_seed(SEED + 5),
                             data[:N_COMPACT], params=sub_params,
                             payload=torch.arange(N_COMPACT, device=dev) * 7)
    scol.add(sub_extra, payload=torch.arange(N_COMPACT, N_COMPACT + sub_extra.shape[0],
                                             device=dev) * 7)
    sub_victims = victims[victims < N_COMPACT]
    scol.remove(sub_victims)
    held64 = held[:N_QUERIES]
    scol.calibrate(held64, k=K_NN, steps_max=STEPS, engine="inline", retain=True)
    old_table, old_payload = scol.calibration, scol.payload.clone()
    t0 = time.perf_counter()
    id_map = torch.as_tensor(scol.compact(), device=dev)
    torch.cuda.synchronize()
    compact_s = time.perf_counter() - t0
    live_old = torch.nonzero(id_map >= 0)[:, 0]
    check(scol.stats.compactions == 1 and scol.n == live_old.numel(), "compact: wrong count")
    fresh = tune_calibrate(scol.index, held64, k=K_NN, steps_max=STEPS, engine="inline")
    check(scol.calibration is not None and scol.calibration is not old_table
          and (scol.calibration.r0, scol.calibration.recall, scol.calibration.cost_slots)
          == (fresh.r0, fresh.recall, fresh.cost_slots),
          "compact: the retained calibration was not re-fit on the new index")
    check(torch.equal(scol.payload[id_map[live_old].long()], old_payload[live_old]),
          "compact: payload rows out of line with the id map")
    dd, ii = scol.search(Q64, engine="inline", k=K_NN, r0=R0, steps=STEPS)
    inv = torch.full((scol.n + 1,), -1, dtype=torch.long, device=dev)
    inv[id_map[live_old].long()] = live_old
    fin = torch.isfinite(dd)
    old_ids = inv[ii.long()]
    check(bool(fin[:, 0].all()) and not bool((old_ids[fin] < 0).any())
          and not set(sub_victims.tolist()) & set(old_ids[fin].tolist()),
          "compact: a query found nothing, or a removed point came back")
    check(torch.equal(scol.get_payload(ii)[fin], old_ids[fin] * 7),
          "compact: a returned id's payload is not its point's")
    print(f"[collection] compact of a {N_COMPACT + sub_extra.shape[0]}-point collection to "
          f"{scol.n} in {compact_s:.3f} s (K={scol.index.params.K} L={scol.index.params.L}, "
          f"re-derived); table re-fit (recall {json.dumps(scol.calibration.recall)}, was "
          f"{json.dumps(old_table.recall)}); payload aligned ({phase_s():.1f} s); the whole "
          f"run took {time.perf_counter() - t_start:.1f} s", flush=True)
    del scol

    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
