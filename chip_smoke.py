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
                 and bit-equal on integer inputs; B1/B2 at the kNN-LM
                 datastores' widths (d = 4096, K = 10 and 3077, Q = 1/4/64;
                 d = 2048, K = 2821 and d = 7168, K = 2308, Q = 4/64)
                 bit-equal to the twin on integer inputs;
3. main        — the repo's large search workload (BENCH_search_hotpath_large:
                 n = 1,000,000, d = 64, K = 10, L = 5, B = 64, M = 5, 64
                 queries, steps = 8, r0 = 0.5) through the one-pass
                 ``search_batch_fixed`` with engines torch, kernel and
                 inline; checks that B1/B2 ran and S1 once a search (every
                 engine selects through it), M1 once a search on kernel and
                 inline and never on torch (its pool path merges in torch),
                 that the kernel engines
                 return the torch engine's id sets (all of them with
                 exact=True; in norm form, a query may differ only where
                 every differing id lies within the norm-scaled atol of its
                 k-th distance, and the raw parity is printed), recall@10
                 >= 0.5 against brute force, and each kernel against its
                 twin on the inputs the main path gave it (M1 on every
                 output, plain and under Termination() with explain);
4. multipass   — the same workload through the multi-pass oracle
                 ``search_batch_fixed_ref``, all three engines: B6 (inline)
                 and B7 (kernel) launch L·steps = 40 times per search, S1
                 once a step on every engine,
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
                 profiler's device time and the host time of a call (for
                 B4/B5 the exact form beside the norm form),
                 beside the least time the card could take (every
                 kernel at both batches; for B8 also torch.cdist and
                 Q @ X.T, and the kernel / cdist and kernel / Q @ X.T
                 ratios); S1 and M1 at the benchmark cells' shapes, bit-equal
                 to their twins, beside the eager code each replaced; median
                 wall times
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
                 no deleted point returned);
14. service    — the request scheduler, ``repro_torch.store.StoreService``
                 (batch shapes 1/4/16/64, k = 10, r0 = 0.5, steps = 8), over
                 the main index in a ``Collection`` with a payload: the
                 1,024 queries submitted one at a time in arrival chunks,
                 on inline and kernel, at inflight_depth 0 and 2, then
                 flush: every ticket bit-equal to ``Collection.search`` on
                 its own padded batch (all four shapes; stats and payload
                 rows too), depth 0 == depth 2, one B1 (inline) or B2
                 (kernel), one S1 and one M1 launch per batch, and no
                 other, recall@10 >= 0.5, no host sync
                 in the issue stage at depth 2 (under
                 ``torch.cuda.set_sync_debug_mode("error")``), a batch
                 issued while another was in flight; QPS and p50/p99 ticket
                 latency (medians of passes at depth 0 and 2 in turns, after
                 a warm pass); a second pass served wholly from the cache (zero
                 launches, equal tickets) and, after an ``add``, misses
                 equal to ``Collection.search`` on the new version; two
                 tenants' rejections against the token-bucket arithmetic on
                 a fake clock; a transient ``dispatch.raise`` retried to the
                 same results and a non-transient one failing its batch
                 with ``DispatchFailed``; with tracing on, a ``batch.issue``
                 span inside the previous batch's ``batch.pending`` window;
                 the card's busy share over one profiled flush at depth 0
                 and depth 2;
15. fleet      — the sharded fleet, ``repro_torch.store.router`` over
                 ``core.distributed``: 4,000,000 points (d = 64, made like the
                 main workload's) through ``open_collection`` on
                 ``make_mesh(4)`` (four shards on the cards there are, four
                 on one card) with max_points_per_shard = 1,000,000 and the
                 main index's settings: the sharded placement chosen, every
                 shard equal to ``build`` of its slice under the one draw of
                 hash functions; ``search`` at Q = 64 and 1024 ``torch.equal``
                 to the per-shard ``search_batch_fixed(engine="torch")`` and
                 the reference's merge rule written out here (lexsort by
                 distance, then position), stats and explain equal to the
                 max / sum / first argmax of the shards'; no kernel launched
                 (the sharded path is pinned to the torch engine, as the
                 reference pins it to jnp); recall@10 >= 0.5 against brute
                 force over the 4M points; wall, device ms (profiled) and
                 idle share, beside one shard's search; ``add`` 10,000 routed
                 to the least-loaded shard at ids ``target * stride + n_old +
                 j``, every other live id unchanged; ``remove`` 10,000, none
                 returned after; ``StoreService`` serving the fleet's 1,024
                 queries one at a time in phase 14's chunks, depth 0 and 2:
                 tickets bit-equal to ``ShardedCollection.search`` on their
                 padded batches, engine torch whatever was asked, no host
                 sync in the issue stage at depth 2, QPS and p50/p99; then a
                 small fleet of 4 x 25,000 (where compaction and migration
                 re-derive K and L): snapshot -> restore bit-equal with a
                 fresh version, an elastic restore 4 -> 2 -> 4 balanced with
                 every live point found at 0 by an exact search of itself and
                 its payload moved with it, compaction after most of one
                 shard is removed (rebalanced, id map ascending, the retained
                 calibration re-fit), an add past the stride renumbering once,
                 an int8 fleet's snapshot re-quantized per shard;
16. baselines  — the paper's baselines, ``repro_torch.core.{FBLSH, MQIndex,
                 C2Index}``, with benchmarks/common.py's settings on the main
                 workload: each built on a 20,000-point slice on the card and
                 held against the same function on the CPU over the same
                 arrays (id sets equal up to near-ties at the 10th distance,
                 d2 within d x 2^-24); then at n = 1,000,000 their recall@10
                 against brute force, ms a query (Q = 64) and build seconds,
                 beside the one-pass DB-LSH search on torch and kernel
                 (Table 4's comparison);
17. knnlm       — kNN-LM serving, ``repro_torch.serve``, with yi-9b at its full
                 width (48 x 4096, 32/4 heads, d_ff 11008, vocab 64000; fp32
                 weights drawn by the reference's init rules from a seed, bf16
                 compute) after phases 1-16 freed the card: ``build_datastore``
                 over 32 batches of 8 x 1024 synthetic tokens (262,144 keys at
                 d = 4096; forward tokens/s, index build s, derived K and L);
                 r0 so that the last radius covers the median 8th-NN distance
                 of 256 held-out states; the same index behind B2 (engine
                 kernel) and, with a vector copy per table, B1 (inline).
                 Gates: on the held-out states the kernel and inline id sets
                 equal torch's up to near-ties at the k-th distance and the
                 returned distances equal the keys' (norm form, atol 4e-6 x
                 the norms); ``knn_probs`` rows sum to 1 where a neighbour was
                 found and the interpolated log-probabilities are finite;
                 prefill of 64 tokens equals prefill of 63 plus one decode
                 (fp32 within 2e-3, bf16 within LM_BF16_TOL); 16 requests
                 (prompts of 32-128 tokens, 32 new tokens, half greedy, half
                 at temperature 0.8 / top-k 40) served on 4 slots without
                 retrieval and through each datastore, every one finished
                 with its 32 tokens, B2 / B1 launched on their runs, S1 on
                 every datastore's and no other kernel on torch's, M1 once a
                 decode step on kernel's and inline's; two greedy
                 requests decoded alone equal the shared batch up to a
                 near-tie; B1/B2 held against their twins on this path's
                 inputs (d = 4096, Q = 4), and S1 and M1 against their twins
                 on the datastore search's own inputs (S1 at K = 3077: equal
                 block sets and halfwidths away from near-ties of the M-th
                 MINDIST; M1 equal on every output).
                 Reported:
                 recall@8 and the overall ratio of the datastore, decode step
                 ms p50/p99, tokens/s and the retrieval share per run, the
                 kernels' times at this shape, the per-layer weight cast's
                 cost and the peak memory;
18. mamba       — the same kNN-LM serving (``knnlm_phase(tag="mamba")``) with
                 mamba2-1.3b at its full width and depth (48 layers, d_model
                 2048, 64 SSM heads of 64, state 128, chunk 64, vocab 50280
                 tied; fp32 weights, bf16 compute), a datastore of 16 batches
                 (131,072 keys at d = 2048), every gate of phase 17, and layer
                 0's chunked ``ssm_forward`` over 256 tokens equal to 256
                 ``ssm_decode`` steps in fp32 (SSD_TOL); records
                 ``<wrapper>@mamba``;
19. arctic      — arctic-480b at its published width (d_model 7168, 56/8 heads
                 of 128, 128 experts of d_ff 4864, top-2, dense residual,
                 vocab 32000, bf16 weights), 2 of its 35 layers: B1/B2's
                 shared-memory plan at d = 7168 printed first; layer 0's
                 ``moe_ffn`` on the path's inputs (a prefill of 8 x 1024
                 tokens at capacity factor 1.25 and 0.25, a decode step at 4
                 slots) against ``moe_oracle`` (the same experts and kept
                 assignments, outputs within MOE_TOL of the float32 oracle,
                 the load balance); prefill vs decode in bf16 at a dropless
                 capacity; 8 requests on 4 slots without retrieval and
                 through B2 and B1 from a datastore of 4 batches (32,768 keys
                 at d = 7168); records ``<wrapper>@arctic``;
20. hymba       — hymba-1.5b at its published width and depth (32 layers,
                 d_model 1600, 25/5 heads and 25 SSM heads of 64, state 16,
                 window 1024, global layers 0/15/31) on the batch path: a
                 prefill of 4 x 1100 tokens into per-layer caches of 1200
                 slots (windowed layers' rings equal to the prompt's last
                 1024 positions, global layers' caches to all of them), prefill
                 vs decode across the window's edge in fp32 and bf16, and 64
                 greedy decode steps (step ms p50/p99);
21. whisper     — kNN-LM on the batch path (``xattn_phase(tag="whisper")``:
                 the engine serves uniform caches only) with whisper-medium
                 at its published width and depth (24 + 24 layers x 1024, 16
                 heads of 64, d_ff 4096 GELU, vocab 51865 tied, 1500 stub
                 frames of d_model per sample; fp32 weights, bf16 compute):
                 B1/B2's shared-memory plan at d = 1024 first; a datastore of
                 32 batches of 8 x 448 tokens (448: Whisper's text context),
                 each sample with its own seeded frames (114,688 keys at d =
                 1024); phase 17's gates (held-out id sets, distances,
                 ``knn_probs`` sums, prefill vs decode fp32 / bf16), another
                 sample's frames moving the logits by more than LM_BF16_TOL;
                 4 requests of 64 tokens, each with its own frames, 32
                 greedy new tokens without retrieval and through the torch,
                 kernel and inline datastores: every token of kernel / inline
                 equals torch's, a request parting only where that step's two
                 searches differ at near-ties of the k-th distance or the
                 top-two log-probabilities tie within LM_BF16_TOL; request 0
                 decoded alone equals its row of the batch up to such a
                 near-tie; records ``<wrapper>@whisper``;
22. vlm         — the same (``xattn_phase(tag="vlm")``) with
                 llama-3.2-vision-11b at its published width and depth (40
                 self layers x 4096, 32/8 heads of 128, d_ff 14336, vocab
                 128256, a gated cross layer after every 5th, 1601 stub image
                 tokens of d_vision 1280 per sample; 11.53 B fp32 weights),
                 its 8 cross layers' gates (drawn as 0 by the reference, so
                 that the images would not count) set to atanh(0.5), a
                 datastore of 16 batches of 8 x 1024 tokens (131,072 keys at
                 d = 4096), images in place of frames; records
                 ``<wrapper>@vlm``.

23. train       — training (``train_phase``): (a) minicpm-2b at its published
                 width and depth (40 layers x 2304, 36 heads of 64, d_ff 5760,
                 vocab 122753 tied; fp32 weights, bf16 compute), AdamW from
                 ``make_optimizer``, 8 steps of 2 x 4096 tokens with
                 accum_steps 2, each layer rematerialised, through
                 ``make_train_step``: every loss finite, the first within (0.5,
                 3) x ln V (tests/test_arch_smoke.py's band); step ms p50/p99,
                 tokens/s, the model-FLOPs share of the dense bf16 peak, the
                 AdamW update's ms and the peak memory; (b) the same width cut
                 to 2 layers: gradients with remat on and off torch.equal,
                 accum_steps 2 vs 1 on the same batch (TRAIN_ACCUM_TOL), one
                 fp32 step (TF32 off) of 2 x 256 tokens on the card against the
                 port's CPU step on the same weights (params, m and v within
                 TRAIN_FP32_TOL), the loss falling by more than 0.1 over 20
                 steps on 2 alternating batches, and ``TrainSupervisor`` with a
                 failure at step 7 (checkpoints every 5 under build/, 12 steps)
                 torch.equal to an uninterrupted run, with its save and
                 restore seconds; (c) ``launch.train.main`` with ``--smoke`` for
                 20 steps;
24. mesh       — every mesh a single-controller mesh over the card (``make_mesh``
                 cycles the CUDA devices over its grid).  (a), right after
                 phase 19 on its parameters: Arctic expert-parallel on (data
                 2, model 4), layer 0's ``moe_ffn`` of a prefill of 4 x 1024
                 tokens and of a decode step at 4 slots against ``moe_oracle``
                 per data shard at the per-shard capacity (the same experts
                 and kept assignments, out within 0.03 x max |oracle|), the EP
                 loss within 5e-2 of the one-device loss, ms of each; (b)
                 Yi-9B at its width, 8 of 48 layers, ``sharding.pp.pp_loss_fn``
                 over the 'pod' axis of (pod 2, data 2, model 2), 8 x 1024
                 tokens in 4 microbatches: the loss within 2e-3 of
                 ``model.loss``, the embedding's gradient within rtol 5e-2,
                 atol 1e-4, ms and the bubble share; (c) MiniCPM-2B at its
                 width, 20 of 40 layers, 4 AdamW steps through the int8
                 error-feedback exchange across the pods of (pod 2, data 1,
                 model 1): step 1's loss within 1e-5 of the uncompressed
                 step's, its parameters within 2e-2 relative L2 of that step's,
                 its mean gradient within 2e-2 and its update within 0.3 of
                 that step's (relative L2), both pods' residual trees non-zero and apart and through a
                 checkpoint ``torch.equal``, step and exchange ms, the wire
                 ratio, peak memory; (d) ``launch.dryrun``'s cells for Yi-9B
                 (train_4k, prefill_32k, decode_32k) and Arctic (train_4k) on
                 16 x 16, on the meta device: per-device GB and FLOPs, CUDA
                 memory unchanged.  Alone: ``tools/mesh_phase.py``.

Each of phases 17-24 frees its model before the next starts and prints
its peak memory.  Any failure raises, and the run exits non-zero.  The last three lines are
the card's name and power limit as nvidia-smi reports them, the kernels'
JSON record, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
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
N_FLEET, FLEET_SHARDS = 4_000_000, 4  # phase 15: the sharded fleet
N_SMALL_SHARD = 25_000  # phase 15's small fleet, a shard's points
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
LM_COUNTED = (*FUSED, "select_blocks", "merge_schedule")  # the kNN-LM phases' launch counts
VERIFY = ("window_verify", "candidate_verify")
POOL = ("window_dist", "candidate_dist")  # B4, B5: the pool engines of _gather_pool
NORM_ATOL = 4e-6  # x (max ||x||^2 + max ||q||^2): the norm form's cancellation
# kernel B3: the quantized modes of B1/B2, one record per instantiation
B3 = {f"{w}[{m}]": (w, m) for w in FUSED for m in QUANT}
B3_REPLACES = "src/repro/kernels/window_verify.py:270"  # _slot_d2, modes bf16/int8
SVC_SHAPES = (1, 4, 16, 64)  # the service's batch shapes (phase 14)
# phase 14's arrival chunks: batches of 64 (two of them, 128, in one step),
# 16, 4 and 1, and partial fills 3 -> 4, 13 -> 16 and 40 -> 64
SVC_CHUNKS = (64, 128, 16, 4, 1, 3, 13, 40)
SVC_TURNS = (0, 2, 2, 0, 0, 2)  # phase 14's timed passes, per engine: depths in turns
N_SLICE = 20_000  # phase 16: the baselines on the card against the CPU on this slice
BASELINES = {  # phase 16: benchmarks/common.py:97-109's settings (class, build, search)
    "FB-LSH": ("FBLSH", dict(K=10, L=5, w0=4 * 1.5 * 1.5, c=1.5, t=64), dict(r0=0.5)),
    "MQ(PM-LSH)": ("MQIndex", dict(m=15, beta=0.08), {}),
    "C2(QALSH)": ("C2Index", dict(m=40, w=2.0), {}),
}
LM_SEQ, LM_BATCH = 1024, 8
LM_DS = dict(c=1.5, t=64, k=8, temperature=10.0, lam=0.25)
LM_STEPS, LM_HELD, LM_CHECK_T = 6, 256, 64
LM_SLOTS, LM_CACHE, LM_REQUESTS, LM_NEW = 4, 256, 16, 32
LM_FP32_TOL = 2e-3  # prefill vs decode in fp32: tests/test_arch_smoke.py's tolerance
# the same in bf16: logits of std ~1 after 48 layers of bf16 rounding (0.082
# measured at the full width, NVIDIA H100 80GB HBM3, 700 W)
LM_BF16_TOL = 0.125
# the same for the SSM family: Mamba2-1.3B's bf16 prefill of 64 tokens is
# itself 0.419 from its fp32 one, and its decode 0.1406 from the bf16
# prefill (0.0859 with the SSD mixer in fp32: the rest is the bf16 matrix
# products of 48 layers; tools/ssm_bf16_drift.py, NVIDIA H100 80GB HBM3,
# 700 W).  The reference drifts as far on the same weights: at 24 of the 48
# layers, on the CPU, over 8 prompts of 64 tokens, its decode is
# 0.078-0.112 from its bf16 prefill and the port's 0.082-0.105, the bf16
# prefills 0.211-0.256 and 0.200-0.276 from fp32
# (tools/ssm_ref_bf16_drift.py --layers 24 --rows 8)
SSM_BF16_TOL = 0.25
# phases 17-18: kNN-LM serving; tag -> (arch, its published width (config
# fields), corpus batches of LM_BATCH x LM_SEQ tokens, the bf16 prefill vs
# decode tolerance)
LM_RUNS = {
    "knnlm": ("yi-9b", dict(n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4, hd=128,
                            d_ff=11008, vocab_size=64000), 32, LM_BF16_TOL),  # 262,144 keys
    "mamba": ("mamba2-1.3b", dict(n_layers=48, d_model=2048, ssm_heads=64, ssm_head_dim=64,
                                  ssm_state=128, ssm_chunk=64, vocab_size=50280,
                                  tie_embeddings=True), 16, SSM_BF16_TOL),  # 131,072 keys
}
SSD_T, SSD_TOL = 256, 2e-4  # phase 18: chunked SSD vs decode steps (tests/test_ssm.py's tol)
# phase 19: Arctic-480B at its published width, 2 of its 35 layers (35 are
# ~953 GB in bf16), a datastore of 4 batches (32,768 keys at d = 7168)
ARCTIC = ("arctic-480b", dict(d_model=7168, n_heads=56, n_kv_heads=8, hd=128, d_ff=4864,
                              n_experts=128, experts_per_token=2, dense_residual=True,
                              vocab_size=32000, param_dtype="bfloat16"), 2, 4)
ARCTIC_REQUESTS = 8
MOE_LOW_FACTOR = 0.25  # a capacity that drops assignments (32 of a prefill's 128 a expert)
# moe_ffn (bf16 products, rounded at each step) against the float32 oracle:
# |err| <= MOE_TOL x max |oracle|
MOE_TOL = 0.03
# phase 20: Hymba-1.5B at its published width and depth, on the batch path
HYMBA = ("hymba-1.5b", dict(n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, hd=64,
                            d_ff=5504, ssm_heads=25, ssm_head_dim=64, ssm_state=16,
                            ssm_chunk=128, sliding_window=1024, global_layers=(0, 15, 31),
                            vocab_size=32001, tie_embeddings=True))
HY_BATCH, HY_PROMPT, HY_CACHE, HY_STEPS = 4, 1100, 1200, 64
# phases 21-22: the cross-attention families serving kNN-LM on the batch
# path; tag -> (arch, its published width (config fields), corpus batches of
# LM_BATCH x seq tokens, seq, the modality stub each sample carries)
XA_RUNS = {
    "whisper": ("whisper-medium", dict(n_layers=24, n_enc_layers=24, d_model=1024, n_heads=16,
                                       n_kv_heads=16, hd=64, d_ff=4096, ffn_kind="gelu",
                                       vocab_size=51865, enc_seq=1500, tie_embeddings=True),
                32, 448, "frames"),  # 448: Whisper's text context; 114,688 keys
    "vlm": ("llama-3.2-vision-11b", dict(n_layers=40, d_model=4096, n_heads=32, n_kv_heads=8,
                                         hd=128, d_ff=14336, vocab_size=128256, cross_every=5,
                                         n_img_tokens=1601, d_vision=1280),
            16, 1024, "images"),  # 131,072 keys
}
XA_REQUESTS, XA_PROMPT = 4, 64
# phase 22: the reference draws every cross layer's gates as 0, and tanh(0) = 0
# makes a drawn model ignore its images; tanh(XA_GATE) = 0.5
XA_GATE = math.atanh(0.5)
# phase 23: training MiniCPM-2B at its published width and depth (fp32 weights,
# bf16 compute, AdamW): 2 x 4096 tokens a step (train_4k's sequence length) in
# 2 microbatches, each layer rematerialised
TRAIN = ("minicpm-2b", dict(n_layers=40, d_model=2304, n_heads=36, n_kv_heads=36, hd=64,
                            d_ff=5760, vocab_size=122753, tie_embeddings=True))
TRAIN_SEQ, TRAIN_BATCH, TRAIN_ACCUM, TRAIN_STEPS = 4096, 2, 2, 8
TRAIN_LR = (3e-4, 2, 100)  # cosine_schedule(peak, warmup, total)
# (b): the full width cut to 2 of 40 layers (0.405 B parameters, 4.9 GB a
# checkpoint); its fp32 card-vs-CPU step, descent and restart run 2 x 256 tokens
TRAIN_CUT, TRAIN_SMALL_SEQ = 2, 256
# descent: tests/test_training.py's gate (the loss falls by more than 0.1 over
# 20 steps on 2 alternating batches) at a tenth of its peak rate, 1e-2 there
# being for d_model 64
TRAIN_DESCENT = (20, (1e-3, 5, 200))
# accum_steps 2 vs 1 on the same batch in bf16 compute: each microbatch's
# weight gradients are rounded to bf16 before they are summed (relative L2)
TRAIN_ACCUM_TOL = 2e-2
# one fp32 step on the card (TF32 off) vs the port's CPU step: the products
# sum in other orders (~1e-6 relative), so m and v agree within
# TRAIN_FP32_TOL (relative L2).  Adam's first step moves each parameter by
# lr * g / (|g| + 1e-8), about lr in the sign of g whatever its size: where g
# is at the two devices' rounding noise the sign may differ (a move of up to
# 2 lr); where |g| > TRAIN_FP32_G a relative change d of g moves the step by
# at most lr * 1e-2 * d, so the parameters agree within TRAIN_FP32_UTOL x lr
# (d up to 1e-2, the small gradients' summation noise) and two float32 ulps
# of the parameter
TRAIN_FP32_TOL, TRAIN_FP32_G, TRAIN_FP32_UTOL = 1e-4, 1e-6, 1e-4
TRAIN_FAIL_AT, TRAIN_CKPT_EVERY, TRAIN_SUP_STEPS = 7, 5, 12
TRAIN_LAUNCH_STEPS = 20  # (c): launch.train --smoke
# phase 24: the mesh, every mesh a single-controller one over the card.  (a)
# Arctic (phase 19's parameters) expert-parallel on (data 2, model 4): a
# prefill of 4 x 1024 tokens, decode at LM_SLOTS slots, the EP loss within
# the reference's rtol (tests/test_distributed.py) of the one-device loss
MESH_EP = ((2, 4), ("data", "model"))
MESH_EP_BATCH, MESH_EP_SEQ, MESH_EP_RTOL = 4, 1024, 5e-2
# (b) GPipe: Yi-9B at its published width, 8 of its 48 layers (2.27 B fp32
# parameters, ~18 GB with their gradients: the cut keeps the run short), 8 x
# 1024 tokens in 4 microbatches over the 'pod' axis of (pod 2, data 2, model 2);
# the reference's tolerances (tests/test_distributed.py's PP parity)
MESH_PP = ((2, 2, 2), ("pod", "data", "model"))
PP_RUN = ("yi-9b", {k: v for k, v in LM_RUNS["knnlm"][1].items() if k != "n_layers"})
PP_LAYERS, PP_BATCH, PP_SEQ, PP_MICRO = 8, 8, 1024, 4
PP_LOSS_RTOL, PP_GRAD = 2e-3, dict(rtol=5e-2, atol=1e-4)
# (c) MiniCPM-2B at its width, 20 of its 40 layers (1.50 B fp32 parameters:
# params, m, v, the gradients and two pods' residual trees ~42 GB; full depth
# would add 2 x 10.9 GB of residuals to phase 23's 55.6 GB peak), AdamW, 4
# steps of a 4096-token sequence a pod on (pod 2, data 1, model 1); the
# parameters after step 1 through int8 with error feedback within PODS_TOL
# (relative L2, over the parameters' norm) of the uncompressed step's
MESH_PODS = ((2, 1, 1), ("pod", "data", "model"))
PODS_LAYERS, PODS_STEPS, PODS_SEQ, PODS_TOL = 20, 4, 4096, 2e-2
# step 1's mean gradient and update through the int8 exchange against the
# uncompressed step's, in relative L2 (an update that is not made reads 1)
PODS_GRAD_TOL, PODS_UPDATE_TOL = 2e-2, 0.3
# (d) the dry run's cells on the 16 x 16 production mesh (device meta)
DRYRUN_CELLS = (("yi-9b", ("train_4k", "prefill_32k", "decode_32k")),
                ("arctic-480b", ("train_4k",)))


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


def int_fused_case(torch, gen, kind, Q, L, K, d, steps, dev, M=5, nb=8, B=64, Ct=320):
    """tests/test_torch_kernels.py's integer inputs for B1 ('window') and B2
    ('cand'): vectors in -2..2, projections on a quarter grid around
    integer query projections, so every float32 sum is exact and the
    kernel equals its twin bit for bit; B1's block ids include the invalid
    sentinel, every 7th B2 slot is +inf."""
    def ints(lo, hi, shape):
        return torch.randint(lo, hi + 1, shape, generator=gen, device=dev).float()

    halves = torch.tensor([0.4 * 1.5 ** j for j in range(steps)], device=dev)
    q = ints(-2, 2, (Q, d))
    if kind == "window":
        lnb, n = L * nb, nb * B
        data = ints(-2, 2, (n, d))
        ids = torch.cat([torch.randperm(n, generator=gen, device=dev) for _ in range(L)])
        ids = ids.reshape(lnb, B)
        vec = data[ids]
        g0 = ints(-4, 4, (K,))
        proj = g0 + ints(-3, 3, (lnb, B, K)) * 0.25
        blk = torch.randint(0, lnb + 1, (Q, L * M), generator=gen, device=dev).int()
        return (blk, halves, proj, vec, (vec * vec).sum(-1), ids.int(),
                g0.expand(Q, L, K).contiguous(), q), n
    n = 4096
    cx = ints(-2, 2, (Q, L, Ct, d))
    ci = torch.randint(0, n, (Q, L, Ct), generator=gen, device=dev).int()
    g = ints(-4, 4, (Q, L, K))
    cp = g[:, :, None, :] + ints(-3, 3, (Q, L, Ct, K)) * 0.25
    cn = (cx * cx).sum(-1)
    cp[:, :, ::7] = torch.inf
    cn[:, :, ::7] = torch.inf
    return (cp, cx, cn, ci, halves, g, q), n


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


SELECT_SHAPES = {  # S1 at the benchmark cells' shapes: (Q, L, nb, K), M
    "sift10m": ((256, 5, 156_250, 10), 5),
    "gist1m": ((1024, 5, 15_625, 10), 5),
}
SELECT_SOURCE = "src/repro_torch/kernels/csrc/select.cu"
SELECT_REPLACES = "none (the JAX package's jnp + lax.top_k, src/repro/core/serve_search.py:161)"


def select_bound(L, Q, nb, K, M) -> tuple[float, str, int, int]:
    """S1's least time (ms), what bounds it, and its bytes and operations:
    ~8 fp32 operations a (query, table, block, dimension) at the float32
    peak, or the MBRs, projections and lists read once, the larger."""
    ops, nbytes = 8 * Q * L * nb * K, 2 * L * nb * K * 4 + Q * L * K * 4 + L * Q * M * 8
    ops_ms, bytes_ms = ops / FP32_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "bytes" if bytes_ms >= ops_ms else "operations", nbytes, ops


def select_times(torch, np, kernels, ref, records: list, launched: int) -> None:
    """Kernel S1 at the benchmark cells' shapes on random boxes and
    projections (~20 overlapping blocks a table and query): bit-equal to
    its twin on the card, then its times beside the twin's (the eager
    selection it replaced) and its bound.  Appends one record a shape;
    ``launched`` is S1's launches on the main path (phase 3)."""
    dev = torch.device("cuda")
    for tag, ((Q, L, nb, K), M) in SELECT_SHAPES.items():
        rng = np.random.default_rng(Q + nb)
        c, e = rng.uniform(-1, 1, (L, nb, K)), rng.uniform(0, 0.3, (L, nb, K))
        p = min(1.0, 20.0 / nb) ** (1.0 / K)
        half = float(np.float32(2.0 * (1.0 - np.sqrt(1.0 - p)) - 0.15))
        lo, hi, g = (torch.from_numpy(x.astype(np.float32)).to(dev)
                     for x in (c - e, c + e, rng.uniform(-1, 1, (Q, L, K))))
        args, kw = (lo, hi, g, half), dict(M=M)
        before = kernels.launches["select_blocks"]
        got = kernels.select_blocks(*args, **kw)
        want = ref.select_blocks_ref(*args, **kw)
        torch.cuda.synchronize()
        check(kernels.launches["select_blocks"] == before + 1, f"S1@{tag}: launch not counted")
        check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
              f"S1@{tag}: differs from its twin")
        overlap = float((got[0] < nb).float().mean())
        ms = cuda_ms(torch, lambda: kernels.select_blocks(*args, **kw), iters=50)
        plain_ms = cuda_ms(torch, lambda: ref.select_blocks_ref(*args, **kw), iters=5)
        dev_us = fleet_profile_ms(torch, lambda: kernels.select_blocks(*args, **kw)) * 1e3
        twin_us = fleet_profile_ms(torch, lambda: ref.select_blocks_ref(*args, **kw)) * 1e3
        hus = host_us(torch, lambda: kernels.select_blocks(*args, **kw))
        bound_ms, bound_by, nbytes, ops = select_bound(L, Q, nb, K, M)
        records.append({
            "name": f"select_blocks@{tag}", "route": "cuda", "source": SELECT_SOURCE,
            "replaces": SELECT_REPLACES, "launches": launched, "max_abs_err": 0.0,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": None,
        })
        print(f"[times] select_blocks@{tag} (S1, Q={Q} L={L} nb={nb} K={K} M={M}): median "
              f"{ms:.4f} ms/launch (device {dev_us:.1f} us [the eager stage {twin_us:.1f} us]; "
              f"host {hus:.1f} us/call; twin {plain_ms:.3f} ms), bound "
              f"{bound_ms * 1e3:.2f} us by {bound_by} ({nbytes / 1e6:.2f} MB, "
              f"{ops / 1e6:.1f} Mop); bit-equal to the twin, {overlap:.3f} of slots filled",
              flush=True)


def select_sets_check(torch, got, want, args, M: int) -> tuple[int, int]:
    """S1's outputs against its twin's at K >= 128, where torch vectorises
    its sum and S1 keeps its own order: per (table, query) equal block sets
    and equal sorted halfwidths, except where the M-th and (M+1)-th MINDIST
    (float64, on the card) lie within float32 rounding, as
    tests/test_torch_kernels.py::test_select_blocks_kernel_wide_k allows.
    Returns the (table, query) rows compared and those skipped."""
    lo, hi, g, half = args
    L, nb, _ = lo.shape
    M = min(M, nb)
    kept = skipped = 0
    for li in range(L):
        lo64, hi64 = lo[li].double(), hi[li].double()
        gb, gw = got[0][li].cpu(), got[1][li].cpu()
        wb, ww = want[0][li].cpu(), want[1][li].cpu()
        for q in range(g.shape[0]):  # a query at a time: (nb, K) in float64
            g64 = g[q, li].double()
            pd = torch.clamp(lo64 - g64, min=0) + torch.clamp(g64 - hi64, min=0)
            ok = ((lo64 <= g64 + half) & (hi64 >= g64 - half)).all(-1)
            score = torch.sort(torch.where(ok, pd.square().sum(-1), torch.inf)).values.cpu()
            a = float(score[M - 1])
            b = float(score[M]) if M < nb else math.inf
            if a != b and math.isfinite(b) and b - a <= 1e-5 * max(1.0, b):
                skipped += 1
                continue
            kept += 1
            check(set(gb[q].tolist()) == set(wb[q].tolist())
                  and torch.equal(torch.sort(gw[q]).values, torch.sort(ww[q]).values),
                  f"S1: table {li}, query {q}: blocks {sorted(gb[q].tolist())} against the "
                  f"twin's {sorted(wb[q].tolist())}")
    return kept, skipped


MERGE_SHAPES = {"sift10m": 256, "gist1m": 1024}  # M1 at the cells' shapes: Q (S = 8, k = kb = 10)
MERGE_SOURCE = "src/repro_torch/kernels/csrc/merge.cu"
MERGE_REPLACES = ("none (the JAX package's per-step jnp merge_dedup_topk, "
                  "src/repro/core/serve_search.py:680)")


def merge_equal(torch, got, want) -> bool:
    """M1's outputs against its twin's: ``torch.equal`` on the results and
    on every stats and explain array."""
    same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if want[2] is not None:
        same = same and got[2].keys() == want[2].keys() and all(
            torch.equal(got[2][key], want[2][key]) for key in want[2])
    return same


def merge_bound(Q, S, kb, k, T=0) -> tuple[float, int]:
    """M1's least time (ms) and its bytes: the bins (and the halfwidths, if
    any) read once and the results written once, at 3.35 TB/s."""
    nbytes = Q * S * kb * 8 + Q * T * 4 + 3 * S * 4 + Q * k * 8
    return nbytes / HBM_BYTES_PER_S * 1e3, nbytes


def merge_record(torch, wrapper, twin, records, name, args, kw, launched) -> str:
    """Times of one M1 call (``wrapper``) beside its twin's and its bound,
    appended as the record ``name``; returns the line's numbers."""
    ms = cuda_ms(torch, lambda: wrapper(*args, **kw), iters=50)
    plain_ms = cuda_ms(torch, lambda: twin(*args, **kw), iters=5)
    dev_us = fleet_profile_ms(torch, lambda: wrapper(*args, **kw)) * 1e3
    twin_us = fleet_profile_ms(torch, lambda: twin(*args, **kw)) * 1e3
    hus = host_us(torch, lambda: wrapper(*args, **kw))
    Q, S, kb = args[0].shape
    bound_ms, nbytes = merge_bound(Q, S, kb, kw["k"], 0 if args[2] is None else args[2].shape[1])
    records.append({
        "name": name, "route": "cuda", "source": MERGE_SOURCE, "replaces": MERGE_REPLACES,
        "launches": launched, "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": None,
    })
    return (f"median {ms:.4f} ms/launch (device {dev_us:.1f} us [the eager loop {twin_us:.1f} "
            f"us]; host {hus:.1f} us/call; twin {plain_ms:.3f} ms), bound "
            f"{bound_ms * 1e3:.3f} us by bytes ({nbytes / 1e6:.3f} MB)")


def merge_times(torch, np, kernels, ref, records: list, launched: int) -> None:
    """Kernel M1 at the benchmark cells' shapes (Q = 256 / 1,024, 8 steps,
    k = kb = 10, C2 on, no stats, as ``Collection.search`` runs it there)
    on bins shaped like B1's (each ascending and distinct, a fifth of the
    slots unfilled, distances growing with the step): bit-equal to its twin
    on the card, then its times beside the twin's (the eager loop it
    replaced) and its bound.  C2's bounds are 0, so every query runs all 8
    steps.  ``launched`` is M1's launches on the main path (phase 3)."""
    dev = torch.device("cuda")
    S, k = 8, 10
    for tag, Q in MERGE_SHAPES.items():
        rng = np.random.default_rng(Q)
        d = np.sort(rng.uniform(0, 1, (Q, S, k)), axis=-1) + np.arange(S)[None, :, None]
        ids = rng.integers(0, 10_000_000, (Q, S, k))
        empty = rng.random((Q, S, k)) < 0.2
        d, ids = np.where(empty, np.inf, d), np.where(empty, 10_000_000, ids)
        order = np.argsort(d, axis=-1, kind="stable")
        d, ids = np.take_along_axis(d, order, -1), np.take_along_axis(ids, order, -1)
        sched = np.stack([0.5 * 1.5 ** np.arange(S), np.zeros(S), 1.5 ** np.arange(S)])
        args = (torch.from_numpy(d.astype(np.float32)).to(dev),
                torch.from_numpy(ids.astype(np.int32)).to(dev), None, None,
                torch.from_numpy(sched.astype(np.float32)).to(dev))
        kw = dict(k=k, n=10_000_000, B=64, use_c2=True)
        before = kernels.launches["merge_schedule"]
        got = kernels.merge_schedule(*args, **kw)
        want = ref.merge_schedule_ref(*args, **kw)
        torch.cuda.synchronize()
        check(kernels.launches["merge_schedule"] == before + 1, f"M1@{tag}: launch not counted")
        check(merge_equal(torch, got, want), f"M1@{tag}: differs from its twin")
        line = merge_record(torch, kernels.merge_schedule, ref.merge_schedule_ref, records,
                            f"merge_schedule@{tag}", args, kw, launched)
        print(f"[times] merge_schedule@{tag} (M1, Q={Q} S={S} k=kb={k}): {line}; bit-equal "
              f"to the twin", flush=True)


def merge_lm_checks(tag, path_launches) -> None:
    """M1 on the LM paths: one launch a datastore search on the fused
    engines (each search launches one B1 or B2), none on the torch
    datastore's fp32 pool path nor without retrieval."""
    for name, counts in path_launches.items():
        fused = sum(counts[f] for f in FUSED)
        check(counts["merge_schedule"] == fused
              and (fused > 0) == (name in ("kernel", "inline")),
              f"{tag}: the {name} path launched M1 {counts['merge_schedule']} times beside "
              f"{fused} B1/B2 launches")


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


def fleet_profile_ms(torch, fn, sessions: int = 3) -> float:
    """Device ms of one call of ``fn`` under the profiler: the sum of its
    device ops, after a few spin kernels that are left out (the first
    records of a session can go missing, see phase 12).  A session that
    kept no record of the call is taken again, up to ``sessions`` times;
    if every one lost them, the time is queued_us's."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(8):
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        us = sum(e.self_device_time_total for e in prof.events()
                 if e.device_type.name == "CUDA" and not e.name.startswith("dblsh.")
                 and "spin_kernel" not in e.name)
        if us > 0:
            return us / 1e3
    return queued_us(torch, fn) / 1e3


def fleet_oracle(torch, np, fleet, Qb, skw: dict):
    """The fleet's search written out from its parts: each shard's
    ``search_batch_fixed(engine="torch")`` on the same queries, then the
    reference's merge rule on the host — local ids below n_local become
    ``rank * stride + local``, anything else the sentinel ``id_space``;
    the k smallest distances, ties to the lowest (shard, slot) position
    (numpy's lexsort); stats as the max / sum over shards, and explain's
    critical path as numpy's first argmax of the shard steps."""
    from repro_torch.core import search_batch_fixed

    s = fleet.sharded
    outs = [search_batch_fixed(sh, Qb, engine="torch", with_explain=True, device=sh.device,
                               **skw) for sh in s.shards]
    host = lambda t: t.cpu().numpy()  # noqa: E731
    d = np.stack([host(o[0]) for o in outs], 1)  # (Qn, P, k)
    i = np.stack([host(o[1]).astype(np.int64) for o in outs], 1)
    rank = np.arange(len(outs))[None, :, None]
    gi = np.where(i < s.n_local, i + rank * s.stride, s.id_space)
    qn = d.shape[0]
    d, gi = d.reshape(qn, -1), gi.reshape(qn, -1)
    d = np.where(np.isfinite(d), d, np.inf)
    pos = np.arange(d.shape[1])
    k = skw["k"]
    md, mi = np.empty((qn, k), np.float32), np.empty((qn, k), np.int64)
    for q in range(qn):
        order = np.lexsort((pos, d[q]))[:k]
        md[q], mi[q] = d[q, order], gi[q, order]
    mi = np.where(np.isfinite(md), mi, s.id_space).astype(np.int32)
    steps = np.stack([host(o[2]["radius_steps"]) for o in outs])  # (P, Qn)
    slots = np.stack([host(o[2]["candidates"]) for o in outs])
    cause = np.stack([host(o[3]["term_cause"]) for o in outs])
    radius = np.stack([host(o[3]["final_radius"]) for o in outs])
    crit = np.argmax(steps, axis=0)
    cols = np.arange(qn)
    stats = {"radius_steps": steps.max(0), "candidates": slots.sum(0).astype(np.int32)}
    explain = {"step_half": host(outs[0][3]["step_half"]),
               "step_slots": np.stack([host(o[3]["step_slots"]) for o in outs]).sum(0)
               .astype(np.int32),
               "term_cause": cause[crit, cols], "final_radius": radius[crit, cols],
               "shard_steps": steps, "shard_slots": slots, "shard_cause": cause}
    return md, mi, stats, explain


def fleet_phase(torch, np, kernels, dev, card, service, strict_issue, drive, check_tickets,
                phase_s) -> None:
    """Phase 15: ``store.router`` and ``core.distributed`` (see the module
    docstring)."""
    from repro_torch.core import brute_force, build, sample_projections, search_batch_fixed
    from repro_torch.core.distributed import id_stride, make_mesh
    from repro_torch.data import make_clustered, normalize_scale
    from repro_torch.store import (
        CompactionPolicy,
        ShardedCollection,
        open_collection,
        restore_collection,
    )

    fields = ("proj_vecs", "proj_blocks", "ids_blocks", "mbr_lo", "mbr_hi", "data",
              "vec_blocks", "norm_blocks", "qvec_blocks", "qvec_scale")
    derive = dict(c=1.5, t=64, k=K_NN, K=10, L=5, inline_vectors=True)
    skw = dict(k=K_NN, r0=R0, steps=STEPS)
    mesh = make_mesh(FLEET_SHARDS)
    cards = len(set(mesh.devices))
    n_local = N_FLEET // FLEET_SHARDS
    stride = id_stride(n_local, 2.0)  # the default policy's headroom

    def gid_of(rows, n_loc=n_local, strd=stride):
        return torch.div(rows, n_loc, rounding_mode="floor") * strd + rows % n_loc

    # the data, made like the main workload's, on a generator of its own
    fgen = torch.Generator(device=dev).manual_seed(SEED + 15)
    pts = make_clustered(fgen, N_FLEET + N_QUERIES_LARGE, D, n_clusters=N_FLEET // 4000,
                         spread=0.02, device=dev)
    fdata, fq, _ = normalize_scale(pts[:N_FLEET], pts[N_FLEET:])
    del pts
    Q64f, Q1kf = fq[:N_QUERIES].contiguous(), fq.contiguous()
    row_gid = gid_of(torch.arange(N_FLEET, device=dev))
    state = fgen.get_state()
    t0 = time.perf_counter()
    fleet = open_collection("fleet", fgen, fdata, mesh=mesh,
                            max_points_per_shard=N_FLEET // FLEET_SHARDS,
                            payload=row_gid, **derive)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    check(isinstance(fleet, ShardedCollection) and fleet.sharded.stride == stride
          and fleet.id_space == FLEET_SHARDS * stride and fleet.device.type == "cuda",
          "open_collection did not choose the sharded placement")
    s = fleet.sharded
    redraw = torch.Generator(device=dev)
    redraw.set_state(state)
    pv = sample_projections(redraw, D, s.params.K, s.params.L, dev)
    for r, sh in enumerate(s.shards):
        alone = build(fdata[r * n_local:(r + 1) * n_local], s.params, proj_vecs=pv, device=dev)
        check(sh.device == mesh.devices[r] and alone.params == sh.params
              and all(torch.equal(getattr(alone, f), getattr(sh, f)) for f in fields),
              f"fleet: shard {r} differs from build of its slice under the shared hash "
              "functions")
        del alone
    nbytes = sum(sh.memory_bytes() + sh.data.numel() * 4 for sh in s.shards)
    print(f"[fleet] open_collection of n={N_FLEET} d={D} over {FLEET_SHARDS} shards on "
          f"{cards} card(s) ({[str(x) for x in mesh.devices]}): sharded, stride {stride}, "
          f"K={s.params.K} L={s.params.L} B={s.params.block_size} M={s.params.max_blocks}; "
          f"{nbytes / 1e9:.2f} GB of index and data; built in {build_s:.2f} s; every shard "
          f"equal to build of its slice under the shared hash functions", flush=True)

    # search: against the per-shard searches and the merge rule written out
    kernels.reset_launches()
    for Qb in (Q64f, Q1kf):
        got = fleet.search(Qb, with_explain=True, **skw)
        md, mi, stats, explain = fleet_oracle(torch, np, fleet, Qb, skw)
        check(torch.equal(got[0].cpu(), torch.from_numpy(md))
              and torch.equal(got[1].cpu(), torch.from_numpy(mi)),
              f"fleet search at Q={Qb.shape[0]}: ids or distances differ from the merge rule")
        check(all(torch.equal(got[2][key].cpu(), torch.from_numpy(v)) for key, v in stats.items())
              and all(torch.equal(got[3][key].cpu(), torch.from_numpy(v))
                      for key, v in explain.items()),
              f"fleet search at Q={Qb.shape[0]}: stats or explain differ from max/sum/argmax")
        plain = fleet.search(Qb, **skw)
        check(torch.equal(plain[0], got[0]) and torch.equal(plain[1], got[1]),
              "fleet search: with_explain changed the results")
    torch.cuda.synchronize()
    # every engine selects with S1; the torch engine verifies and merges in torch
    launched = {n_: c_ for n_, c_ in kernels.launches.items() if c_ and n_ != "select_blocks"}
    check(not launched, f"fleet: the torch engine launched {launched}")
    check(kernels.launches["select_blocks"] > 0, "fleet: the search never launched S1")
    _, gt = brute_force(fdata, Q64f, k=K_NN, device=dev)
    gt_sets = [set(r) for r in row_gid[gt].cpu().tolist()]
    d64, i64 = fleet.search(Q64f, **skw)
    sets = idsets(torch, d64, i64)
    recall = sum(len(a & b) for a, b in zip(sets, gt_sets)) / (N_QUERIES * K_NN)
    check(recall >= 0.5, f"fleet: recall@{K_NN} {recall} over {N_FLEET} points")
    times = {}
    for Qb in (Q64f, Q1kf):
        qn = Qb.shape[0]
        wall = wall_ms(torch, lambda: fleet.search(Qb, **skw), repeats=5)
        one = wall_ms(torch, lambda: search_batch_fixed(s.shards[0], Qb, engine="torch",
                                                        device=dev, **skw), repeats=5)
        dev_ms = fleet_profile_ms(torch, lambda: fleet.search(Qb, **skw))
        check(dev_ms > 0, f"fleet: no device time at Q={qn}")
        times[f"Q={qn}"] = {"wall_ms": round(wall, 3), "device_ms": round(dev_ms, 3),
                            "idle": round(1 - dev_ms / wall, 3),
                            "qps": round(qn / wall * 1e3, 1),
                            "one_shard_wall_ms": round(one, 3)}
    print(f"[fleet] search at Q={N_QUERIES} and {N_QUERIES_LARGE}: torch.equal to the "
          f"per-shard search_batch_fixed(engine='torch') + the merge rule, stats and "
          f"explain equal to max/sum/first-argmax; no kernel launch but S1's (the "
          f"sharded path is pinned to the torch engine); recall@{K_NN} {recall:.4f} against brute "
          f"force over {N_FLEET} points; {card}: {json.dumps(times)}", flush=True)

    # add 10,000 (to the least-loaded shard) and remove 10,000
    ugen = torch.Generator(device=dev).manual_seed(SEED + 16)
    near_of = torch.randint(0, N_FLEET, (N_INSERT,), generator=ugen, device=dev)
    fextra = fdata[near_of] + torch.randn((N_INSERT, D), generator=ugen, device=dev) * (
        0.5 / D ** 0.5)
    counts0 = fleet.shard_counts()
    target, n_old = int(np.argmin(counts0)), s.n_local
    want_ids = target * stride + n_old + np.arange(N_INSERT)
    before = [sh.ids_blocks.clone() for sh in s.shards]
    t0 = time.perf_counter()
    new_ids = fleet.add(fextra, payload=torch.from_numpy(want_ids).to(dev))
    torch.cuda.synchronize()
    add_s = time.perf_counter() - t0
    s = fleet.sharded
    check(np.array_equal(new_ids, want_ids) and fleet.stats.compactions == 0
          and s.stride == stride
          and np.array_equal(fleet.shard_counts() - counts0,
                             np.eye(FLEET_SHARDS, dtype=np.int64)[target] * N_INSERT),
          f"fleet add: ids {new_ids[:3]}... or counts {fleet.shard_counts()} not routed to "
          f"shard {target}")
    n_new = s.n_local
    for r, (old, sh) in enumerate(zip(before, s.shards)):
        moved = torch.where(old >= n_old, n_new, old)
        check(torch.equal(sh.ids_blocks[:, :old.shape[1]], moved),
              f"fleet add: a live id of shard {r} changed")
    del before
    d, i = fleet.search(fextra[:16], k=1, r0=R0, steps=STEPS, exact=True)
    check(bool((d[:, 0] == 0).all()) and np.array_equal(i[:, 0].cpu().numpy(), want_ids[:16])
          and torch.equal(fleet.get_payload(i[:, 0]).cpu(), torch.from_numpy(want_ids[:16])),
          "fleet add: an inserted point is not found at its id")
    nn = []
    for c in range(0, N_QUERIES_LARGE, N_QUERIES):
        nn.append(brute_force(fdata, Q1kf[c:c + N_QUERIES], k=1, device=dev)[1][:, 0])
    near = torch.unique(row_gid[torch.cat(nn)])
    pool = torch.cat([row_gid[torch.randperm(N_FLEET, generator=ugen, device=dev)[:N_DELETE]],
                      torch.from_numpy(want_ids[::7]).to(dev)])
    pool = pool[~torch.isin(pool, near)]
    victims = torch.cat([near, pool[:N_DELETE - near.numel()]]).to(torch.int32)
    t0 = time.perf_counter()
    id_map = fleet.remove(victims)
    torch.cuda.synchronize()
    remove_s = time.perf_counter() - t0
    check(id_map is None and fleet.live_count() == N_FLEET + N_INSERT - N_DELETE,
          "fleet remove: wrong live count, or a compaction")
    victim_set = set(victims.cpu().tolist())
    for Qb in (Q64f, Q1kf):
        dd, ii = fleet.search(Qb, **skw)
        check(not victim_set & set().union(*idsets(torch, dd, ii)),
              "fleet remove: a removed id returned")
    print(f"[fleet] add {N_INSERT} in {add_s:.3f} s to the least-loaded shard {target}, ids "
          f"target*stride + {n_old} + j, every other live id unchanged; remove {N_DELETE} "
          f"(the {N_QUERIES_LARGE} queries' nearest neighbours among them) in {remove_s:.3f} s, "
          f"no removed "
          f"id returned", flush=True)

    # the service: phase 14's 1,024 single queries through StoreService
    rows_h = Q1kf.cpu().numpy()
    runs, svc_numbers = {}, {}
    for depth in (0, 2):
        svc = service(col=fleet, engine="kernel", inflight_depth=depth, max_wait_ms=0.0,
                      cache_size=2 * N_QUERIES_LARGE)
        if depth:
            strict_issue(svc)
        kernels.reset_launches()
        tickets, _ = drive(svc, rows_h)
        torch.cuda.synchronize()
        errors = [t.error for t in tickets if t.error is not None]
        check(not errors, f"fleet service (depth {depth}): {len(errors)} tickets failed, "
              f"the first: {errors[:1]!r}"
              + (f" (cause {errors[0].__cause__!r})" if errors else ""))
        check(all(t.done and not t.cached and t.engine == "torch" for t in tickets)
              and all(e == "torch" for _, _, e in svc.batch_log),
              f"fleet service (depth {depth}): a ticket not done, cached, or not on torch")
        check(not any(c_ for n_, c_ in kernels.launches.items() if n_ != "select_blocks"),
              "fleet service: a kernel other than S1 launched")
        shapes = check_tickets(svc, tickets, f"fleet, depth {depth}")
        check(shapes == set(SVC_SHAPES), f"fleet service: shapes {shapes}")
        runs[depth] = tickets
        svc_numbers[f"depth{depth}"] = {"batches": len(svc.batch_log),
                                        "overlap_ratio": svc.stats("fleet")["overlap_ratio"]}
    check(all(np.array_equal(x.dists, y.dists) and np.array_equal(x.ids, y.ids)
              for x, y in zip(runs[0], runs[2])), "fleet service: depth 0 and 2 differ")
    svc = service(col=fleet, engine="inline", cache_size=0)
    asked = svc.submit("fleet", rows_h[0], engine="kernel")
    svc.flush()
    check(asked.engine == "torch" and asked.error is None,
          f"fleet service: a request asking for kernel ran on {asked.engine}")
    timing = {}
    drive(service(col=fleet, max_wait_ms=0.0, cache_size=0), rows_h)
    for depth in SVC_TURNS:
        svc = service(col=fleet, inflight_depth=depth, max_wait_ms=0.0, cache_size=0)
        _, wall_s = drive(svc, rows_h)
        st_ = svc.stats("fleet")
        row = timing.setdefault(f"depth{depth}", {"qps": [], "p50_ms": [], "p99_ms": [],
                                                  "wall_s": []})
        for key, v in (("qps", st_["qps"]), ("p50_ms", st_["latency_ms_p50"]),
                       ("p99_ms", st_["latency_ms_p99"]), ("wall_s", wall_s)):
            row[key].append(v)
    medians = {name: {key: statistics.median(v) for key, v in row.items()}
               for name, row in timing.items()}
    print(f"[fleet] service: {N_QUERIES_LARGE} single queries (chunks {SVC_CHUNKS}) on the "
          f"fleet, tickets bit-equal to ShardedCollection.search on their padded batches "
          f"(all four shapes), engine torch whatever was asked, depth 0 == depth 2, no host "
          f"sync in the issue stage at depth 2: {json.dumps(svc_numbers)}; {card}: QPS and "
          f"ticket latency, medians of passes in turns {SVC_TURNS}: {json.dumps(medians)}; "
          f"readings {json.dumps(timing)}", flush=True)
    del fleet, s, svc

    # a small fleet, 4 x 25,000: snapshot, elastic restore, compaction,
    # the stride's renumbering, int8 (K and L are re-derived there: at 1M a
    # shard would need K = 3572, see phase 8)
    n_small = FLEET_SHARDS * N_SMALL_SHARD
    sdata = fdata[:n_small].contiguous()
    sgid = gid_of(torch.arange(n_small, device=dev), N_SMALL_SHARD, id_stride(N_SMALL_SHARD))
    small = ShardedCollection.create("small", torch.Generator(device=dev).manual_seed(SEED + 17),
                                     sdata, mesh, payload=sgid,
                                     policy=CompactionPolicy(auto=False), **derive)
    sextra = fextra[:1000]
    tgt = int(np.argmin(small.shard_counts()))
    pred = torch.arange(1000, device=dev) + tgt * small.sharded.stride + N_SMALL_SHARD
    check(np.array_equal(small.add(sextra, payload=pred), pred.cpu().numpy()),
          "small fleet: add returned other ids")
    small.remove(sgid[::9].to(torch.int32))
    snap_root = ROOT / "build"
    snap_root.mkdir(exist_ok=True)
    snap_dir = Path(tempfile.mkdtemp(prefix="fleet_snapshot_", dir=snap_root))
    small_numbers = {}
    try:
        before = small.search(Q1kf, with_stats=True, **skw)
        t0 = time.perf_counter()
        small.snapshot(str(snap_dir / "small"))
        snap_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        back = restore_collection(str(snap_dir / "small"), mesh=mesh)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        after = back.search(Q1kf, with_stats=True, **skw)
        check(isinstance(back, ShardedCollection) and back.version > small.version
              and bit_equal(torch, before, after)
              and all(torch.equal(before[2][k_], after[2][k_]) for k_ in before[2])
              and torch.equal(back.payload, small.payload),
              "fleet snapshot: the restored fleet differs")
        # elastic: 4 -> 2 -> 4, every live point found at its new id
        _, live_gids = small._live_rows_and_ids()
        g = torch.from_numpy(live_gids).to(dev)
        ss = small.sharded
        live_pts = torch.cat([ss.shards[r].data[g[g // ss.stride == r] % ss.stride]
                              for r in range(FLEET_SHARDS)])
        mesh2 = make_mesh(2)
        two = restore_collection(str(snap_dir / "small"), mesh=mesh2)
        two.snapshot(str(snap_dir / "two"))
        four = restore_collection(str(snap_dir / "two"), mesh=mesh)
        for label, col in (("2 shards", two), ("4 shards", four)):
            counts = col.shard_counts()
            check(counts.sum() == live_gids.size and counts.max() - counts.min() <= 1,
                  f"elastic restore ({label}): counts {counts}")
            # in chunks: the re-derived K (~2,200 at 25,000 a shard) makes
            # the selection's (Q, nb, K) terms ~3.5 MB a query
            for c in range(0, live_pts.shape[0], 1024):
                dd, ii = col.search(live_pts[c:c + 1024], k=1, r0=R0, steps=STEPS, exact=True)
                check(bool((dd[:, 0] == 0).all())
                      and torch.equal(col.get_payload(ii[:, 0]), g[c:c + 1024].long()),
                      f"elastic restore ({label}): a live point not found at 0, or its "
                      "payload did not move with it")
        del two, four
        # compact after most of one shard is removed: rebalanced, the
        # retained calibration re-fit
        small.remove(sgid[N_SMALL_SHARD:N_SMALL_SHARD + 4 * N_SMALL_SHARD // 5]
                     .to(torch.int32))
        held = Q1kf[-N_QUERIES:]
        small.calibrate(held, k=K_NN, steps_max=STEPS, retain=True)
        old_table = small.calibration
        t0 = time.perf_counter()
        id_map = small.compact()
        torch.cuda.synchronize()
        compact_s = time.perf_counter() - t0
        counts = small.shard_counts()
        newv = id_map[id_map >= 0]
        fresh = small._calibrate_impl(held, k=K_NN, r0=None, steps_max=STEPS, engine=None,
                                      measure_ms=False)
        check(counts.max() - counts.min() <= 1 and np.all(newv[1:] > newv[:-1])
              and small.calibration is not old_table
              and (small.calibration.r0, small.calibration.recall,
                   small.calibration.cost_slots) == (fresh.r0, fresh.recall, fresh.cost_slots),
              f"fleet compact: counts {counts}, or the id map, or the re-fit")
        # an add past the stride renumbers once
        room = small.sharded.stride - small.sharded.n_local
        over = torch.cat([sextra] * (room // sextra.shape[0] + 2))[:room + 1]
        small.add(over, payload=torch.zeros(over.shape[0], dtype=small.payload.dtype,
                                            device=dev))
        check(small.stats.compactions == 2 and small.sharded.stride >= small.sharded.n_local,
              "fleet: an add past the stride did not renumber once")
        # int8: the snapshot re-quantizes per shard
        q8 = ShardedCollection.create("small8", torch.Generator(device=dev).manual_seed(SEED),
                                      sdata, mesh, quant_dtype="int8", **derive)
        q8.snapshot(str(snap_dir / "q8"))
        q8b = restore_collection(str(snap_dir / "q8"), mesh=mesh)
        check(all(torch.equal(a.qvec_blocks, b.qvec_blocks) and torch.equal(a.qvec_scale,
                                                                           b.qvec_scale)
                  for a, b in zip(q8.sharded.shards, q8b.sharded.shards))
              and bit_equal(torch, q8.search(Q1kf, dtype="int8", **skw),
                            q8b.search(Q1kf, dtype="int8", **skw)),
              "fleet int8 snapshot: re-quantized blocks or int8 searches differ")
        small_numbers = {"snapshot_s": round(snap_s, 3), "restore_s": round(restore_s, 3),
                         "compact_s": round(compact_s, 3), "counts_after_compact":
                         counts.tolist(), "K_L_after_compact": [small.sharded.params.K,
                                                                small.sharded.params.L]}
    finally:
        shutil.rmtree(snap_dir, ignore_errors=True)
    print(f"[fleet] small fleet ({FLEET_SHARDS} x {N_SMALL_SHARD}): snapshot -> restore on "
          f"an equal mesh bit-equal with a fresh version; elastic 4 -> 2 -> 4 balanced, every "
          f"live point found at its new id with its payload; compact after most of shard 1 "
          f"removed rebalances, id map ascending, calibration re-fit; an add past the stride "
          f"renumbers once; int8 snapshot re-quantized per shard, searches equal: "
          f"{json.dumps(small_numbers)} ({phase_s():.1f} s)", flush=True)


# ------------------------------------------------ 16. the paper's baselines


def edge_ties(torch, got, want, rtol: float, atol: float = 0.0, what: str = "") -> int:
    """Id-set parity of two (dists, ids) results: filled slots equal,
    squared distances within ``atol + rtol * d2``, unfilled ids equal; a
    query's id set may differ only where every differing id's squared
    distance lies within the tolerance of the k-th (a near-tie at the k
    cut).  Returns the number of queries that differ at such near-ties."""
    gd, gi = (x.cpu() for x in got)
    wd, wi = (x.cpu() for x in want)
    fin = torch.isfinite(wd)
    check(torch.equal(fin, torch.isfinite(gd)), f"{what}: filled slots differ")
    g2, w2 = gd[fin].double() ** 2, wd[fin].double() ** 2
    check(bool(((g2 - w2).abs() <= atol + rtol * w2).all()),
          f"{what}: squared distances differ by {float((g2 - w2).abs().max())}")
    check(torch.equal(gi[~fin].long(), wi[~fin].long()), f"{what}: unfilled ids differ")
    ties = 0
    for q in range(gd.shape[0]):
        f = fin[q]
        a, b = set(gi[q][f].tolist()), set(wi[q][f].tolist())
        if a == b:
            continue
        edge = float(wd[q][f].max()) ** 2
        dist = dict(zip(wi[q][f].tolist(), wd[q][f].tolist()))
        dist.update(zip(gi[q][f].tolist(), gd[q][f].tolist()))
        check(all(abs(dist[i] ** 2 - edge) <= atol + rtol * edge for i in a ^ b),
              f"{what}: ids differ at query {q}, off the k edge")
        ties += 1
    return ties


def recall_at(ids, truth: list, k: int) -> float:
    """Mean share of each query's true k nearest ids found."""
    rows = ids.cpu().tolist()
    return sum(len(set(r[:k]) & t) / k for r, t in zip(rows, truth)) / len(truth)


def baselines_phase(torch, dev, card, data, Q64, gt_sets, index, kw, phase_s) -> None:
    """Phase 16: the paper's baselines beside DB-LSH on the main workload
    (Table 4's comparison).  The gate holds each baseline on the card
    against the same function on the CPU over a slice of the points, the
    same arrays; the 1M figures are reported."""
    from repro_torch.core import baselines, search_batch_fixed

    gen = torch.Generator(device=dev).manual_seed(SEED + 16)
    # the diff form's d2 sums d squares in another order on the CPU
    rtol = D * 2.0 ** -24
    sl = data[:N_SLICE].contiguous()
    parity = {}
    for name, (cls_name, bkw, skw) in BASELINES.items():
        cls = getattr(baselines, cls_name)
        small = cls.build(gen, sl, device=dev, **bkw)
        got = small.search_batch(Q64, k=K_NN, **skw)
        fields = {f.name: getattr(small, f.name) for f in dataclasses.fields(small)}
        arrays = {f: v.cpu() for f, v in fields.items() if isinstance(v, torch.Tensor)}
        meta = {f: v for f, v in fields.items() if not isinstance(v, torch.Tensor)}
        want = cls.from_arrays(arrays, device="cpu", **meta).search_batch(Q64.cpu(), k=K_NN,
                                                                          **skw)
        parity[name] = edge_ties(torch, got, want, rtol, 1e-12, f"{name} card vs CPU")
        check(bool(torch.isfinite(got[0][:, 0]).any()), f"{name} found nothing")
    print(f"[baselines] ok: each baseline on the card equals the CPU on {N_SLICE:,} points "
          f"(id sets, near-ties at the 10th distance allowed: {json.dumps(parity)} queries; "
          f"d2 rtol {rtol:.2e})", flush=True)

    table = {}
    for name, (cls_name, bkw, skw) in BASELINES.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx = getattr(baselines, cls_name).build(gen, data, device=dev, **bkw)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        ms = wall_ms(torch, lambda: idx.search_batch(Q64, k=K_NN, **skw), repeats=2)
        _, ids = idx.search_batch(Q64, k=K_NN, **skw)
        table[name] = {"recall@10": round(recall_at(ids, gt_sets, K_NN), 4),
                       "ms_per_query": round(ms / N_QUERIES, 4), "build_s": round(build_s, 3)}
        del idx
    for engine in ("torch", "kernel"):
        ms = wall_ms(torch, lambda: search_batch_fixed(index, Q64, engine=engine, **kw),
                     repeats=5)
        _, ids = search_batch_fixed(index, Q64, engine=engine, **kw)[:2]
        table[f"DB-LSH ({engine})"] = {"recall@10": round(recall_at(ids, gt_sets, K_NN), 4),
                                       "ms_per_query": round(ms / N_QUERIES, 4),
                                       "build_s": "phase 3"}
    torch.cuda.empty_cache()
    print(f"[baselines] {card}: n = {N:,}, d = {D}, Q = {N_QUERIES}, k = {K_NN} (wall of a "
          f"batch over Q; FB-LSH r0 = 0.5, DB-LSH r0 = {R0}, steps {STEPS}): "
          f"{json.dumps(table)} ({phase_s():.1f} s)", flush=True)


# ----------------------------- 17-20. the LM: kNN-LM serving and the families


def inline_index(torch, index):
    """``index`` with the per-table vector copy (``inline_vectors``) added:
    the rows of ``data`` in each table's STR order, zero rows for the
    padding, as ``build`` lays them out; every other array shared."""
    L, nb, B = index.ids_blocks.shape
    n, d = index.data.shape
    vec = torch.zeros((L, nb * B, d), device=index.data.device)
    for li in range(L):
        ids = index.ids_blocks[li].reshape(-1).long()
        real = torch.nonzero(ids < n).squeeze(1)
        vec[li].index_copy_(0, real, index.data[ids[real]])
    return dataclasses.replace(index, vec_blocks=vec.reshape(L, nb, B, d),
                               params=dataclasses.replace(index.params, inline_vectors=True))


def lm_requests(np, vocab: int, n: int):
    """The LM phases' requests: prompts of 32-128 tokens, LM_NEW new tokens
    each, even uids greedy, odd ones at temperature 0.8 with top-k 40."""
    from repro_torch.serve import Request

    rng = np.random.default_rng(SEED)
    lens = rng.integers(32, 129, n)
    return [Request(uid=i, prompt=rng.integers(0, vocab, int(n_)).astype(np.int32),
                    max_new_tokens=LM_NEW, temperature=0.0 if i % 2 == 0 else 0.8, top_k=40)
            for i, n_ in enumerate(lens)]


def lm_model(torch, dev, tag: str, arch: str, width: dict, n_layers: int = 0):
    """``arch`` at its published ``width`` (the config's fields), depth cut
    to ``n_layers`` where given, with random weights drawn on the card:
    (cfg, model, params)."""
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model, param_count

    cfg = get_config(arch)
    if n_layers:
        cfg = cfg.scaled(n_layers=n_layers)
    check(all(getattr(cfg, k) == v for k, v in width.items()),
          f"{arch} is not at its published width {width}")
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    stacks = sum(len(m) for m in params.children() if isinstance(m, torch.nn.ModuleList))
    groups = cfg.n_layers // cfg.cross_every if cfg.cross_every else 0
    check(stacks == cfg.n_layers + cfg.n_enc_layers + groups
          and tuple(params.embed.shape) == (cfg.padded_vocab, cfg.d_model),
          f"{arch}: the drawn model is not the config's")
    n_params = param_count(params)
    nbytes = sum(p.numel() * p.element_size() for p in params.parameters())
    print(f"[{tag}] {arch}: {cfg.n_layers} layers, {n_params:,} parameters, "
          f"{nbytes / 1e9:.1f} GB (weights in {cfg.param_dtype}), drawn in {init_s:.1f} s "
          f"(peak {torch.cuda.max_memory_allocated() / 1e9:.1f} GB); compute in {cfg.dtype}",
          flush=True)
    return cfg, model, params


def lm_datastore(torch, np, dev, tag, model, params, n_batches: int, seq: int = LM_SEQ,
                 extras=None):
    """The datastore of a teacher-forced pass over ``n_batches`` synthetic
    batches of LM_BATCH x ``seq`` tokens (with the modality stubs
    ``extras``, {name: a sample's shape}, as ``make_batch_fn`` draws
    them), held-out states (another batch, LM_HELD of its positions),
    their true neighbours and r0 from the median k-th NN distance."""
    from repro_torch.core import brute_force
    from repro_torch.data.pipeline import SyntheticTokens, make_batch_fn
    from repro_torch.serve import build_datastore

    cfg = model.cfg
    src = SyntheticTokens(cfg.vocab_size, seq, LM_BATCH, seed=SEED)
    batch_fn = make_batch_fn(src, extras)
    batches = [batch_fn(s) for s in range(n_batches)]
    fwd = {"s": 0.0}

    def timed_loss(p, b, mesh=None):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = model.loss(p, b)
        torch.cuda.synchronize()
        fwd["s"] += time.perf_counter() - t
        return out

    t0 = time.perf_counter()
    ds = build_datastore(dataclasses.replace(model, loss=timed_loss), params, batches,
                         torch.Generator(device=dev).manual_seed(1), device=dev, **LM_DS)
    torch.cuda.synchronize()
    ds_s = time.perf_counter() - t0
    keys = ds.index.data
    n_keys = n_batches * LM_BATCH * seq
    check(tuple(keys.shape) == (n_keys, cfg.d_model) and ds.values.shape[0] == n_keys,
          f"datastore holds {tuple(keys.shape)}")
    check(bool(torch.isfinite(keys).all()), "non-finite hidden states in the datastore")
    p_lsh = ds.index.params
    print(f"[{tag}] datastore: {n_keys:,} keys of d = {keys.shape[1]} ({keys.numel() * 4 / 1e9:.2f}"
          f" GB) in {ds_s:.1f} s: teacher-forced pass {fwd['s']:.1f} s "
          f"({n_keys / fwd['s']:,.0f} tokens/s), index build {ds_s - fwd['s']:.1f} s; derived "
          f"K = {p_lsh.K}, L = {p_lsh.L}, B = {p_lsh.block_size}, M = {p_lsh.max_blocks}, "
          f"index {ds.index.memory_bytes() / 1e9:.2f} GB", flush=True)
    del batches
    with torch.inference_mode():
        hb = model.loss(params, batch_fn(n_batches))[1]["hidden"]
    held = hb[:, ::seq * LM_BATCH // LM_HELD].reshape(-1, hb.shape[-1]).float().contiguous()
    del hb
    check(held.shape[0] == LM_HELD, f"{held.shape[0]} held-out states")
    bd, bi = brute_force(keys, held, k=LM_DS["k"], device=dev)
    truth = [set(r) for r in bi.cpu().tolist()]
    med = float(bd[:, -1].median())
    r0 = med / LM_DS["c"] ** (LM_STEPS - 1)
    norms = keys.square().sum(-1).sqrt()
    print(f"[{tag}] hidden-state norms {float(norms.min()):.1f}-{float(norms.max()):.1f}; "
          f"median 8th-NN distance of {LM_HELD} held-out states {med:.3f} -> r0 = {r0:.4f} "
          f"(r0 c^{LM_STEPS - 1} covers it)", flush=True)
    return ds, batch_fn, held, bd, truth, r0


def lm_stores(torch, tag, ds, headroom: int = 8 << 30):
    """The same keys behind torch, B2 (kernel) and, where the card has the
    room (the copy and ``headroom`` bytes), B1 (inline: a vector copy per
    table)."""
    from repro_torch.serve import Datastore
    from repro_torch.store import Collection

    stores = {"torch": ds, "kernel": Datastore(Collection.from_index(
        f"{tag}-kernel", ds.index, payload=ds.values, engine="kernel"),
        ds.temperature, ds.lam, ds.k)}
    need = ds.index.params.L * ds.index.data.numel() * 4
    torch.cuda.empty_cache()
    free = torch.cuda.mem_get_info()[0]
    if free > need + headroom:
        stores["inline"] = Datastore(Collection.from_index(
            f"{tag}-inline", inline_index(torch, ds.index), payload=ds.values,
            engine="inline"), ds.temperature, ds.lam, ds.k)
    print(f"[{tag}] datastores: {sorted(stores)} (inline needs {need / 1e9:.1f} GB, "
          f"{free / 1e9:.1f} GB free)", flush=True)
    return stores


def serve_requests(torch, np, kernels, model, params, store, r0, n_requests: int):
    """``n_requests`` of ``lm_requests`` through a ServeEngine on LM_SLOTS
    slots, without retrieval (``store`` None) or through ``store``; launch
    counts reset just before the run: (requests, numbers, launches)."""
    from repro_torch.serve import RetrievalLM, ServeEngine

    cfg = model.cfg
    eng = ServeEngine(model, params, slots=LM_SLOTS, cache_len=LM_CACHE,
                      retrieval=None if store is None else RetrievalLM(
                          model, store, r0=r0, steps=LM_STEPS))
    steps_ms, search_ms = [], []
    inner = eng._step

    def step(*a):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = inner(*a)
        check(bool(torch.isfinite(out[0]).all()), "non-finite decode log-probabilities")
        steps_ms.append((time.perf_counter() - t) * 1e3)
        return out

    eng._step = step
    if store is not None:
        search = store.search

        def timed_search(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = search(*a, **k)
            torch.cuda.synchronize()
            search_ms.append((time.perf_counter() - t) * 1e3)
            return out

        store.search = timed_search
    reqs = lm_requests(np, cfg.vocab_size, n_requests)
    for r in reqs:
        eng.submit(r)
    kernels.reset_launches()
    t = time.perf_counter()
    n_steps = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launched = dict(kernels.launches)
    if store is not None:
        del store.search
    check(all(r.done and len(r.output) == LM_NEW for r in reqs),
          "a request ended without its max_new_tokens")
    check(all(0 <= tok < cfg.padded_vocab for r in reqs for tok in r.output),
          "a token outside the vocabulary")
    return reqs, {"engine_steps": n_steps, "wall_s": round(wall, 3),
                  "tokens_per_s": round(n_requests * LM_NEW / wall, 2),
                  "step_ms_p50": round(float(np.percentile(steps_ms, 50)), 3),
                  "step_ms_p99": round(float(np.percentile(steps_ms, 99)), 3),
                  "retrieval_share": round(sum(search_ms) / sum(steps_ms), 4)
                  if search_ms else 0.0}, {k: launched[k] for k in LM_COUNTED}


def prefill_decode_gate(torch, tag, models, params, batch, cache_len):
    """Prefill of T tokens (``batch``: the tokens and any modality stub)
    against prefill of T - 1 and one decode, for each (model, tolerance):
    the last logits' largest difference by dtype."""
    gaps = {}
    prompt = batch["tokens"]
    for m, tol in models:
        with torch.inference_mode():
            full = m.prefill(params, batch, cache_len=cache_len)[0].float()
            _, _, c = m.prefill(params, {**batch, "tokens": prompt[:, :-1]}, cache_len=cache_len)
            dec = m.decode(params, prompt[:, -1], c, prompt.shape[1] - 1)[0].float()
        err = float((dec - full).abs().max())
        gaps[m.cfg.dtype] = round(err, 6)
        check(bool(torch.allclose(dec, full, rtol=tol, atol=tol)),
              f"{tag} {m.cfg.dtype}: decode after prefill differs from prefill by {err} "
              f"(tol {tol})")
    return gaps, float(full.std())


def path_kernel_records(torch, kernels, wrappers, twins, records, tag, stores, h4, r0,
                        path_launches) -> None:
    """B1/B2 and S1 at a datastore path's shapes (the serving engine's
    slots), against their twins, timed, and recorded as ``<wrapper>@<tag>``.
    S1's inputs are those of the kernel datastore's search (every engine
    selects through S1), checked with select_sets_check."""
    engine = "kernel" if "kernel" in stores else next(iter(stores))
    a, k = capture_calls(kernels, wrappers, "select_blocks",
                         lambda: stores[engine].search(h4, r0=r0, steps=LM_STEPS))
    got, want = wrappers["select_blocks"](*a, **k), twins["select_blocks"](*a, **k)
    kept, skipped = select_sets_check(torch, got, want, a, k["M"])
    check(kept >= skipped, f"S1@{tag}: only {kept} of {kept + skipped} rows away from near-ties")
    ms = cuda_ms(torch, lambda: wrappers["select_blocks"](*a, **k), iters=50)
    plain_ms = cuda_ms(torch, lambda: twins["select_blocks"](*a, **k), iters=5)
    dev_us = fleet_profile_ms(torch, lambda: wrappers["select_blocks"](*a, **k)) * 1e3
    (L, nb, K), Qn = a[0].shape, a[2].shape[0]
    bound_ms, bound_by, nbytes, ops = select_bound(L, Qn, nb, K, k["M"])
    records.append({
        "name": f"select_blocks@{tag}", "route": "cuda", "source": SELECT_SOURCE,
        "replaces": SELECT_REPLACES, "launches": path_launches[engine]["select_blocks"],
        "max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": None,
    })
    print(f"[{tag}] select_blocks@{tag}: Q={Qn}, L={L}, nb={nb}, K={K}, M={k['M']}: median "
          f"{ms:.4f} ms/launch (device {dev_us:.1f} us; twin {plain_ms:.3f} ms), bound "
          f"{bound_ms * 1e3:.2f} us by {bound_by} ({nbytes / 1e6:.2f} MB, {ops / 1e6:.1f} Mop); "
          f"block sets and halfwidths equal to the twin's on {kept} (table, query) rows, "
          f"{skipped} at near-ties of the M-th MINDIST", flush=True)
    for engine in ("kernel", "inline"):
        if engine not in stores:
            continue
        a, k = capture_calls(kernels, wrappers, "merge_schedule",
                             lambda: stores[engine].search(h4, r0=r0, steps=LM_STEPS))
        check(merge_equal(torch, wrappers["merge_schedule"](*a, **k),
                          twins["merge_schedule"](*a, **k)),
              f"M1@{tag} ({engine}): differs from its twin on the datastore's bins")
        line = merge_record(torch, wrappers["merge_schedule"], twins["merge_schedule"], records,
                            f"merge_schedule@{tag}[{engine}]", a, k,
                            path_launches[engine]["merge_schedule"])
        Qn, S, kb = a[0].shape
        print(f"[{tag}] merge_schedule@{tag}[{engine}]: Q={Qn}, S={S}, kb={kb}, k={k['k']}: "
              f"{line}; equal to the twin on every output", flush=True)
    for name, engine in (("fused_cand_search", "kernel"), ("fused_window_search", "inline")):
        if engine not in stores:
            continue
        a, k = capture_calls(kernels, wrappers, name,
                             lambda: stores[engine].search(h4, r0=r0, steps=LM_STEPS))
        nrm, q = (a[4], a[7]) if name == "fused_window_search" else (a[2], a[6])
        sc = float(nrm[torch.isfinite(nrm)].max()) + float((q * q).sum(-1).max())
        err = 0.0
        for mode, tol in (("norm", dict(atol=NORM_ATOL * sc)),
                          ("exact", dict(atol=1e-5, rtol=q.shape[-1] * 2.0 ** -24))):
            kk = dict(k, mode=mode)
            err = max(err, bins_err(torch, wrappers[name](*a, **kk), twins[name](*a, **kk),
                                    edge_ties=True, **tol))
        ms = cuda_ms(torch, lambda: wrappers[name](*a, **k), iters=50)
        plain_ms = cuda_ms(torch, lambda: twins[name](*a, **k), iters=5)
        dev_us, dev_how = device_us(torch, lambda: wrappers[name](*a, **k), f"{name}_kernel")
        in_bytes, out_bytes, ops, ops_ms = work(torch, name, a, k)
        bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        records.append({
            "name": f"{name}@{tag}", "route": "cuda", "source": KERNELS[name][0],
            "replaces": KERNELS[name][1], "launches": path_launches.get(engine, {}).get(name, 0),
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": bound_by, "library_ms": None,
        })
        K = (a[6] if name == "fused_window_search" else a[5]).shape[-1]
        print(f"[{tag}] {name}@{tag}: Q={q.shape[0]}, d={q.shape[-1]}, K={K}: median {ms:.4f} "
              f"ms/launch (device {dev_us:.1f} us by {dev_how}; twin {plain_ms:.3f} ms), bound "
              f"{max(bytes_ms, ops_ms) * 1e3:.2f} us by {bound_by} "
              f"({(in_bytes + out_bytes) / 1e6:.2f} MB, {ops / 1e6:.1f} Mop); max |err| vs "
              f"twin {err:.3g}", flush=True)


def free_card(torch) -> None:
    import gc

    gc.collect()
    torch.cuda.empty_cache()


def ssd_gate(torch, params, cfg, dev, tag) -> None:
    """One full-width layer's chunked ``ssm_forward`` over SSD_T tokens
    against SSD_T ``ssm_decode`` steps, in float32 (tests/test_ssm.py's
    check at this width), on the layer's own input."""
    from repro_torch.data.pipeline import SyntheticTokens, make_batch_fn
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.common import rmsnorm
    from repro_torch.models.transformer import _layer_params

    bp = _layer_params(params.blocks[0], torch.float32)
    toks = torch.as_tensor(make_batch_fn(SyntheticTokens(cfg.vocab_size, SSD_T, 1, seed=SEED))(
        0)["tokens"], device=dev).long()
    with torch.inference_mode():
        x = rmsnorm(params.embed[toks].float(), bp["norm1"], cfg.norm_eps)
        y, s, tail = ssm_mod.ssm_forward(x, bp["ssm"], cfg, chunk=cfg.ssm_chunk)
        _, H, P, N, conv_dim, _ = ssm_mod.ssm_dims(cfg)
        state = torch.zeros((1, H, N, P), device=dev)
        conv = torch.zeros((1, ssm_mod.CONV_W - 1, conv_dim), device=dev)
        ys = []
        for t in range(SSD_T):
            y1, state, conv = ssm_mod.ssm_decode(x[:, t:t + 1], bp["ssm"], cfg, state, conv)
            ys.append(y1)
        y_seq = torch.cat(ys, dim=1)
    err_y = float((y - y_seq).abs().max())
    err_s = float((s - state).abs().max())
    check(bool(torch.allclose(y, y_seq, rtol=SSD_TOL, atol=SSD_TOL))
          and bool(torch.allclose(s, state, rtol=SSD_TOL, atol=SSD_TOL))
          and bool(torch.allclose(tail, conv, rtol=SSD_TOL, atol=SSD_TOL)),
          f"{tag}: chunked SSD differs from {SSD_T} decode steps by {err_y} (y), {err_s} "
          f"(state)")
    print(f"[{tag}] ok: layer 0's ssm_forward over {SSD_T} tokens at chunk {cfg.ssm_chunk} == "
          f"{SSD_T} ssm_decode steps in fp32 within rtol = atol = {SSD_TOL}: max |dy| {err_y:.3g}"
          f" (|y| max {float(y.abs().max()):.3f}), max |dstate| {err_s:.3g}, conv tails within the same",
          flush=True)


def heldout_gates(torch, tag, stores, held, bd, truth, r0):
    """Gates 5-6 on the held-out states: every store's returned distances
    equal the keys' (norm form), kernel/inline id sets equal torch's up
    to near-ties; prints recall@8 and the ratio.  Returns each store's
    (dists, ids) and the norm form's atol on d2."""
    keys = stores["torch"].index.data
    atol = NORM_ATOL * norm_scale(torch, keys, held)
    found, summary = {}, {}
    for name, s in stores.items():
        # in chunks: the selection's (Q, L, nb, K) terms are 0.1 GB a query
        # at K = 3077
        parts = [s.search(held[j:j + LM_SLOTS * 4], r0=r0, steps=LM_STEPS)
                 for j in range(0, LM_HELD, LM_SLOTS * 4)]
        d_, i_ = (torch.cat(t) for t in zip(*parts))
        found[name] = (d_, i_)
        fin = torch.isfinite(d_)
        rows = torch.nonzero(fin)[:, 0]
        exact = (keys[i_[fin].long()] - held[rows]).square().sum(-1)
        err = float((d_[fin].double() ** 2 - exact.double()).abs().max()) if fin.any() else 0.0
        check(err <= atol, f"{name}: returned distances off the keys' by {err} in d2 "
                           f"(atol {atol:.4f})")
        # the paper's overall ratio: returned over true distance, rank by rank
        ratio = float((d_[fin] / bd.expand_as(d_)[fin]).mean()) if fin.any() else 0.0
        summary[name] = {"recall@8": round(recall_at(i_, truth, LM_DS["k"]), 4),
                         "ratio": round(ratio, 4),
                         "all_k_found": round(float(fin.all(1).float().mean()), 4),
                         "d2_err": round(err, 5)}
    for name in stores:
        if name != "torch":
            summary[name]["near_ties"] = norm_edge_ties(torch, found[name], found["torch"],
                                                         atol)
    check(summary["torch"]["all_k_found"] > 0, "no held-out state found its k neighbours")
    print(f"[{tag}] ok: held-out searches (r0 {r0:.4f}, steps {LM_STEPS}, k {LM_DS['k']}): "
          f"kernel/inline id sets equal torch's up to near-ties, distances equal the keys' "
          f"(norm form, atol {atol:.4f}); {json.dumps(summary)}", flush=True)
    return found, atol


def knn_probs_gate(torch, ds, held, found, params, cfg, r0) -> None:
    """Gate 4: the retrieval distribution sums to 1 where a neighbour was
    found (else 0), and its interpolation with the LM is finite."""
    from repro_torch.models.transformer import logits_fn
    from repro_torch.serve import knn_probs
    from repro_torch.serve.retrieval import interpolate

    with torch.inference_mode():
        p = torch.cat([knn_probs(ds, held[j:j + LM_SLOTS * 4], cfg.padded_vocab, r0=r0,
                                 steps=LM_STEPS) for j in range(0, LM_HELD, LM_SLOTS * 4)])
        hit = torch.isfinite(found["torch"][0][:, 0])
        sums = p.sum(-1)
        check(bool(torch.allclose(sums[hit], torch.ones_like(sums[hit]), rtol=1e-3)),
              "knn_probs rows with a neighbour do not sum to 1")
        check(bool((sums[~hit] == 0).all()), "knn_probs rows without a neighbour are not 0")
        logp = torch.log(interpolate(logits_fn(params, held.to(torch.bfloat16), cfg), p,
                                     ds.lam) + 1e-20)
        check(bool(torch.isfinite(logp).all()), "interpolated log-probabilities not finite")


def smem_plan(torch, tag, n: int, d: int) -> None:
    """B1/B2's shared-memory plan at a datastore of n keys of width d
    (derived K, L), printed before anything runs; fails if no stage fits."""
    from repro_torch.core import DBLSHParams
    from repro_torch.kernels import _build
    from repro_torch.kernels.ops import _MAX_SMEM, _MODES

    p_lsh = DBLSHParams.derive(n=n, d=d, c=LM_DS["c"], t=LM_DS["t"], k=LM_DS["k"],
                               block_size=64)
    C = p_lsh.L * p_lsh.max_blocks * p_lsh.block_size
    lib = _build.load()
    smem = {f"{w}[{m}]": lib.fused_search_smem_bytes(_MODES.index(m), LM_STEPS, p_lsh.L,
                                                     p_lsh.K, p_lsh.d, C, S)
            for w, S in (("fused_window_search", p_lsh.L * p_lsh.max_blocks),
                         ("fused_cand_search", 0)) for m in ("norm", "exact")}
    print(f"[{tag}] fused_search_smem_bytes at d = {p_lsh.d}, K = {p_lsh.K}, L = {p_lsh.L}, "
          f"C = {C}, steps = {LM_STEPS}: {json.dumps(smem)} (at most {_MAX_SMEM})", flush=True)
    check(max(smem.values()) <= _MAX_SMEM, "B1/B2 cannot plan a stage at this width")


def knnlm_phase(torch, np, dev, card, kernels, wrappers, twins, records, phase_s,
                tag: str = "knnlm") -> None:
    """Phases 17 (``knnlm``: Yi-9B) and 18 (``mamba``: Mamba2-1.3B): kNN-LM
    serving with a full-width model (random weights) and a DB-LSH datastore
    of its own hidden states, through the torch engine and the fused
    kernels B2 (kernel) and B1 (inline)."""
    from repro_torch.models.registry import build_model
    from repro_torch.serve import Request, ServeEngine

    arch, width, n_batches, bf16_tol = LM_RUNS[tag]
    torch.cuda.reset_peak_memory_stats()
    print(f"[{tag}] held on the card before the phase: "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB", flush=True)
    cfg, model, params = lm_model(torch, dev, tag, arch, width)
    check(all(p.dtype == torch.float32 for p in params.parameters()), "weights not fp32")
    if cfg.family == "ssm":
        ssd_gate(torch, params, cfg, dev, tag)

    ds, batch_fn, held, bd, truth, r0 = lm_datastore(torch, np, dev, tag, model, params,
                                                     n_batches)
    stores = lm_stores(torch, tag, ds)
    found, _ = heldout_gates(torch, tag, stores, held, bd, truth, r0)
    knn_probs_gate(torch, ds, held, found, params, cfg, r0)

    # gate 1: prefill of T against prefill of T - 1 and one decode, in fp32
    # (the reference's tolerance) and in the compute dtype
    prompt = torch.as_tensor(batch_fn(0)["tokens"][:1, :LM_CHECK_T], device=dev)
    gaps, std = prefill_decode_gate(
        torch, tag, ((build_model(cfg.scaled(dtype="float32")), LM_FP32_TOL),
                     (model, bf16_tol)), params, {"tokens": prompt}, LM_CHECK_T)
    print(f"[{tag}] ok: prefill of {LM_CHECK_T} == prefill of {LM_CHECK_T - 1} + one decode, "
          f"max |dlogit| {json.dumps(gaps)} (tol fp32 {LM_FP32_TOL}, {cfg.dtype} "
          f"{bf16_tol}); logits std {std:.3f}", flush=True)

    # serving: the same requests without retrieval and through each datastore
    served, runs, path_launches = {}, {}, {}
    for name in ("none", *stores):
        served[name], runs[name], path_launches[name] = serve_requests(
            torch, np, kernels, model, params, None if name == "none" else stores[name], r0,
            LM_REQUESTS)
    check(path_launches["kernel"]["fused_cand_search"] > 0, "the kernel datastore never ran B2")
    check(not any(c_ for n_, c_ in path_launches["torch"].items() if n_ != "select_blocks"),
          "the torch datastore launched a kernel other than S1")
    check(all(path_launches[n_]["select_blocks"] > 0 for n_ in stores)
          and not path_launches["none"]["select_blocks"],
          f"a datastore never ran S1, or plain decoding did: {path_launches}")
    merge_lm_checks(tag, path_launches)
    if "inline" in stores:
        check(path_launches["inline"]["fused_window_search"] > 0,
              "the inline datastore never ran B1")
    print(f"[{tag}] ok: {LM_REQUESTS} requests x {LM_NEW} new tokens each served on "
          f"{LM_SLOTS} slots (cache {LM_CACHE}), half greedy, half at temperature 0.8 / top-k "
          f"40; {card}: {json.dumps(runs)}; launches {json.dumps(path_launches)}", flush=True)

    # gate 2: a greedy request decoded alone gives the shared batch's tokens;
    # they may part only at a token whose top-two logit gap is within the
    # tolerance (a near-tie), after which their contexts differ
    def recording(fn, logs):
        """``fn`` (a prefill or a decode step) keeping its first row of logits."""
        def wrapped(*a, **k):
            out = fn(*a, **k)
            logs.append(out[0][0].float())
            return out
        return wrapped

    compared, parted = 0, []
    for req in served["none"][:4:2]:
        logs = []
        eng = ServeEngine(dataclasses.replace(model, prefill=recording(model.prefill, logs)),
                          params, slots=1, cache_len=LM_CACHE)
        eng._step = recording(eng._step, logs)
        solo = Request(uid=req.uid, prompt=req.prompt, max_new_tokens=LM_NEW)
        eng.submit(solo)
        eng.run()
        for j, (a_, b_) in enumerate(zip(solo.output, req.output)):
            if a_ != b_:
                top2 = torch.topk(logs[j], 2).values
                gap = float(top2[0] - top2[1])
                check(gap <= bf16_tol, f"request {req.uid}: token {j} differs alone "
                      f"({a_}) and shared ({b_}) at a top-two gap of {gap}")
                parted.append((req.uid, j, round(gap, 4)))
                break
            compared += 1
    print(f"[{tag}] ok: two greedy requests decoded alone equal the shared batch over "
          f"{compared} tokens; parted at near-ties (uid, token, top-two gap <= "
          f"{bf16_tol}): {parted}", flush=True)

    path_kernel_records(torch, kernels, wrappers, twins, records, tag, stores,
                        held[:LM_SLOTS].contiguous(), r0, path_launches)

    # what casting each layer's weights to bf16 costs a decode step
    blocks = list(params.blocks)

    def cast_all():
        for b in blocks:
            for w in b.parameters():
                if w.dim() > 1:
                    w.to(torch.bfloat16)

    cast_ms = cuda_ms(torch, cast_all, iters=3)
    print(f"[{tag}] the per-layer weight cast (fp32 -> bf16, {len(blocks)} layers) takes "
          f"{cast_ms:.2f} ms of a decode step; a bf16 copy kept at load would cost "
          f"{sum(p.numel() for b in blocks for p in b.parameters() if p.dim() > 1) * 2 / 1e9:.1f}"
          f" GB; peak memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB "
          f"({phase_s():.1f} s)", flush=True)
    del stores, ds, params, blocks
    free_card(torch)


def capture_moe(ffn_mod, fn):
    """Run ``fn`` with ``ffn_mod.moe_ffn`` wrapped: the (x, weights, out,
    aux) of its first call (layer 0's MoE on the path ``fn`` drives)."""
    calls = []
    inner = ffn_mod.moe_ffn

    def wrapped(x, p, cfg, *a, **k):
        out = inner(x, p, cfg, *a, **k)
        if not calls:
            calls.append((x, p, *out))
        return out

    ffn_mod.moe_ffn = wrapped
    try:
        fn()
    finally:
        ffn_mod.moe_ffn = inner
    return calls[0]


def moe_oracle(torch, x, p, cfg):
    """The MoE FFN written out: route each token to its top-k experts (probs
    in float32, ties to the lower expert), keep an assignment when its rank
    among the same expert's assignments in the flat (token, k) order is
    below the capacity, and add w x the expert's SwiGLU on the token, from
    the expert's own weights, in float32.  Returns (out (N, D) float32,
    kept (N * k,), expert ids (N, k), load balance, capacity)."""
    N, D = x.shape[0] * x.shape[1], x.shape[2]
    E, k = cfg.n_experts, cfg.experts_per_token
    xf = x.reshape(N, D)
    probs = torch.softmax(xf.float() @ p["router"].float(), dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :k], ids[:, :k]
    w = w / w.sum(-1, keepdim=True)
    counts = torch.bincount(ids.reshape(-1), minlength=E).float()
    lb = E * float((counts / N * probs.mean(0)).sum())
    cap = max(4, math.ceil(N * k / E * cfg.moe_capacity_factor))
    flat = ids.reshape(-1)
    kept = torch.zeros(N * k, dtype=torch.bool, device=x.device)
    out = torch.zeros((N, D), dtype=torch.float32, device=x.device)
    for e in range(E):
        rows = torch.nonzero(flat == e)[:, 0][:cap]  # ascending flat order
        if rows.numel() == 0:
            continue
        kept[rows] = True
        tok = rows // k
        xe = xf[tok].float()
        h = torch.nn.functional.silu(xe @ p["w_gate"][e].float()) * (xe @ p["w_up"][e].float())
        out.index_add_(0, tok, (h @ p["w_down"][e].float()) * w.reshape(-1)[rows, None])
    return out, kept, ids, lb, cap


def arctic_phase(torch, np, dev, card, kernels, wrappers, twins, records, phase_s):
    """Phase 19: Arctic-480B at its published width, depth cut to
    ARCTIC_LAYERS layers (bf16 weights): the MoE FFN against
    ``moe_oracle`` on the path's own inputs, prefill vs decode, and
    requests served without retrieval and through B2 and B1.  Returns
    (cfg, model, params) for phase 24 (a)."""
    from repro_torch.data.pipeline import SyntheticTokens, make_batch_fn
    from repro_torch.models import ffn as ffn_mod
    from repro_torch.models.registry import build_model

    tag = "arctic"
    arch, width, n_layers, n_batches = ARCTIC
    torch.cuda.reset_peak_memory_stats()
    smem_plan(torch, tag, n_batches * LM_BATCH * LM_SEQ, width["d_model"])

    cfg, model, params = lm_model(torch, dev, tag, arch, width, n_layers)
    check(all(p.dtype == torch.bfloat16 for p in params.parameters() if p.dim() > 1),
          "weights not bf16")
    E, k, D = cfg.n_experts, cfg.experts_per_token, cfg.d_model

    # the MoE FFN of layer 0 on the main path's inputs: a prefill of
    # LM_BATCH x LM_SEQ tokens (the configured capacity, and MOE_LOW_FACTOR
    # so that assignments are dropped) and a decode step of LM_SLOTS slots
    toks = torch.as_tensor(make_batch_fn(SyntheticTokens(cfg.vocab_size, LM_SEQ, LM_BATCH,
                                                         seed=SEED + 1))(0)["tokens"],
                           device=dev)
    cases = {}
    with torch.inference_mode():
        x, p, out, aux = capture_moe(ffn_mod, lambda: model.prefill(params, {"tokens": toks}))
        cases["prefill"] = (x, p, out, aux, cfg)
        low = cfg.scaled(moe_capacity_factor=MOE_LOW_FACTOR)
        cases[f"prefill@{MOE_LOW_FACTOR}"] = (x, p, *ffn_mod.moe_ffn(x, p, low), low)
        _, _, c = model.prefill(params, {"tokens": toks[:LM_SLOTS, :LM_CHECK_T]},
                                cache_len=LM_CACHE)
        cases["decode"] = (*capture_moe(ffn_mod, lambda: model.decode(
            params, toks[:LM_SLOTS, LM_CHECK_T], c, LM_CHECK_T)), cfg)
        del c
        summary = {}
        for name, (x_, p_, out_, aux_, cfg_) in cases.items():
            want, kept, ids, lb, cap = moe_oracle(torch, x_, p_, cfg_)
            xf = x_.reshape(-1, D)
            _, ids_port = ffn_mod._top_k(torch.softmax(xf.float() @ p_["router"].float(), -1), k)
            keep, _, flat = ffn_mod._dispatch(ids_port, capacity=cap, n_local=E,
                                              first_eid=0)
            kept_port = torch.zeros_like(kept)
            kept_port[flat] = keep
            check(torch.equal(ids_port, ids), f"{name}: the router's top-{k} differs")
            check(torch.equal(kept_port, kept), f"{name}: kept assignments differ from the "
                                                "oracle's")
            err = float((out_.reshape(-1, D).float() - want).abs().max())
            scale = float(want.abs().max())
            check(err <= MOE_TOL * scale, f"{name}: moe_ffn off the oracle by {err} "
                  f"(tol {MOE_TOL} x {scale})")
            got_lb = float(aux_["load_balance"])
            check(abs(got_lb - lb) <= 1e-5 * lb, f"{name}: load balance {got_lb} != {lb}")
            summary[name] = {"tokens": xf.shape[0], "capacity": cap,
                             "dropped": int((~kept).sum()), "max_abs_err": round(err, 5),
                             "max_abs_out": round(scale, 4), "load_balance": round(lb, 5)}
        del cases, x, p, out
    check(summary[f"prefill@{MOE_LOW_FACTOR}"]["dropped"] > 0,
          f"no assignment dropped at capacity factor {MOE_LOW_FACTOR}")
    print(f"[{tag}] ok: layer 0's moe_ffn == moe_oracle (the same top-{k} experts, the same "
          f"kept assignments, out within {MOE_TOL} x max |out|, load balance within 1e-5): "
          f"{json.dumps(summary)}", flush=True)

    # prefill vs decode in bf16, at a capacity no expert can fill (at the
    # configured one a prefill drops assignments that a decode keeps)
    dropless = build_model(cfg.scaled(moe_capacity_factor=float(E)))
    gaps, std = prefill_decode_gate(torch, tag, ((dropless, LM_BF16_TOL),), params,
                                    {"tokens": toks[:1, :LM_CHECK_T]}, LM_CHECK_T)
    print(f"[{tag}] ok: prefill of {LM_CHECK_T} == prefill of {LM_CHECK_T - 1} + one decode "
          f"(capacity factor {E}), max |dlogit| {json.dumps(gaps)} (tol {LM_BF16_TOL}); "
          f"logits std {std:.3f}", flush=True)

    ds, _, held, _, _, r0 = lm_datastore(torch, np, dev, tag, model, params, n_batches)
    # B1's copy (1.9 GB) beside the 55.4 GB of weights: a decode step of two
    # layers at 4 slots needs well under a GB more
    stores = lm_stores(torch, tag, ds, headroom=2 << 30)
    check("inline" in stores, "no room on the card for B1's vector copy")
    runs, path_launches = {}, {}
    for name in ("none", "kernel", "inline"):
        _, runs[name], path_launches[name] = serve_requests(
            torch, np, kernels, model, params, None if name == "none" else stores[name], r0,
            ARCTIC_REQUESTS)
    check(path_launches["kernel"]["fused_cand_search"] > 0, "the kernel datastore never ran B2")
    check(path_launches["inline"]["fused_window_search"] > 0, "the inline datastore never ran B1")
    check(not any(path_launches["none"].values()), "plain decoding launched a kernel")
    check(all(path_launches[n_]["select_blocks"] > 0 for n_ in ("kernel", "inline")),
          f"a datastore never ran S1: {path_launches}")
    merge_lm_checks(tag, path_launches)
    print(f"[{tag}] ok: {ARCTIC_REQUESTS} requests x {LM_NEW} new tokens each served on "
          f"{LM_SLOTS} slots (cache {LM_CACHE}), without retrieval and through B2 and B1; {card}: "
          f"{json.dumps(runs)}; launches {json.dumps(path_launches)}", flush=True)
    path_kernel_records(torch, kernels, wrappers, twins, records, tag, stores,
                        held[:LM_SLOTS].contiguous(), r0, path_launches)
    print(f"[{tag}] peak memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB "
          f"({phase_s():.1f} s)", flush=True)
    del stores, ds
    free_card(torch)
    return cfg, model, params  # phase 24 (a) runs on them before they are freed


def hybrid_phase(torch, np, dev, card, phase_s) -> None:
    """Phase 20: Hymba-1.5B at its published width and depth on the batch
    path (the engine serves uniform caches only): a prefill of HY_BATCH
    prompts of HY_PROMPT tokens, past the window, into per-layer caches of
    HY_CACHE slots (the windowed layers' rings hold the window), prefill
    vs decode across the window's edge, and HY_STEPS greedy decode steps."""
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.registry import build_model
    from repro_torch.models.transformer import _layer_window, forward

    tag = "hymba"
    arch, width = HYMBA
    torch.cuda.reset_peak_memory_stats()
    cfg, model, params = lm_model(torch, dev, tag, arch, width)
    rng = np.random.default_rng(SEED)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (HY_BATCH, HY_PROMPT)),
                              device=dev)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _, caches = model.prefill(params, {"tokens": prompts}, cache_len=HY_CACHE)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        _, full, _ = forward(params, prompts, cfg, want_cache=True)
    _, H, P, N, conv_dim, _ = ssm_mod.ssm_dims(cfg)
    check(isinstance(caches, list) and len(caches) == cfg.n_layers, "caches not per layer")
    windowed = [li for li in range(cfg.n_layers) if _layer_window(cfg, li)]
    for li, c in enumerate(caches):
        size = _layer_window(cfg, li) or HY_CACHE
        kv = (HY_BATCH, size, cfg.n_kv_heads, cfg.hd)
        check(tuple(c["k"].shape) == kv and tuple(c["v"].shape) == kv
              and tuple(c["ssm"].shape) == (HY_BATCH, H, N, P)
              and tuple(c["conv"].shape) == (HY_BATCH, ssm_mod.CONV_W - 1, conv_dim),
              f"layer {li}: cache shapes {[tuple(t.shape) for t in c.values()]}")
    # the rings: position p at slot p % window, for the window's last positions
    w = cfg.sliding_window
    slots = torch.arange(HY_PROMPT - w, HY_PROMPT, device=dev) % w
    check(all(torch.equal(caches[li]["k"][:, slots], full[li]["k"][:, HY_PROMPT - w:])
              and torch.equal(caches[li]["ssm"], full[li]["ssm"]) for li in windowed),
          "a windowed layer's ring is not the last positions of the prompt")
    check(all(torch.equal(caches[li]["k"][:, :HY_PROMPT], full[li]["k"])
              for li in cfg.global_layers), "a global layer's cache is not the prompt's")
    del full
    gaps, std = prefill_decode_gate(
        torch, tag, ((build_model(cfg.scaled(dtype="float32")), LM_FP32_TOL),
                     (model, LM_BF16_TOL)), params, {"tokens": prompts}, HY_CACHE)
    print(f"[{tag}] ok: prefill of {HY_BATCH} x {HY_PROMPT} tokens ({prefill_ms:.1f} ms) into "
          f"{len(windowed)} rings of {w} and {len(cfg.global_layers)} global caches of "
          f"{HY_CACHE}; prefill of {HY_PROMPT} == prefill of {HY_PROMPT - 1} + one decode "
          f"across the window's edge, max |dlogit| {json.dumps(gaps)} (tol fp32 "
          f"{LM_FP32_TOL}, {cfg.dtype} {LM_BF16_TOL}); logits std {std:.3f}", flush=True)

    tok = logits.argmax(-1)
    step_ms = []
    with torch.inference_mode():
        for i in range(HY_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _, caches = model.decode(params, tok, caches, HY_PROMPT + i)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            check(bool(torch.isfinite(logits).all()), "non-finite decode logits")
            tok = logits.argmax(-1)
    print(f"[{tag}] ok: {HY_STEPS} greedy decode steps of the batch of {HY_BATCH} ({card}): "
          f"step ms p50 {float(np.percentile(step_ms, 50)):.3f}, p99 "
          f"{float(np.percentile(step_ms, 99)):.3f}, "
          f"{HY_BATCH * HY_STEPS / sum(step_ms) * 1e3:.1f} tokens/s; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB ({phase_s():.1f} s)", flush=True)
    del caches, params
    free_card(torch)


def rel_l2(np, got, want) -> float:
    """|got - want| / |want| over two trees of arrays (the largest leaf's)."""
    if isinstance(want, dict):
        return max((rel_l2(np, got[k], want[k]) for k in want), default=0.0)
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-300))


def params_leaves(*trees, path=""):
    """(path, leaf of each tree) over nested dicts of arrays."""
    if isinstance(trees[0], dict):
        for k in trees[0]:
            yield from params_leaves(*(t[k] for t in trees), path=f"{path}.{k}".lstrip("."))
        return
    yield (path, *trees)


def timed_optimizer(torch, opt, ms: list):
    """``opt`` whose update appends its device-synchronised ms to ``ms``."""
    from repro_torch.train.optimizer import Optimizer

    def update(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = opt.update(*args)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        return out

    return Optimizer(opt.init, update)


def train_phase(torch, np, dev, card, phase_s) -> None:
    """Phase 23: training.  (a) MiniCPM-2B at its published width and
    depth, 8 AdamW steps of 2 x 4096 tokens in 2 microbatches through
    ``make_train_step``; (b) the width cut to 2 layers: remat on / off,
    accum 2 / 1, an fp32 step on the card against the CPU's, descent, and
    a supervised restart; (c) ``launch.train.main`` with ``--smoke``."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticTokens, make_batch_fn
    from repro_torch.launch.train import main as train_main
    from repro_torch.models import transformer
    from repro_torch.models.common import cross_entropy
    from repro_torch.models.registry import (build_model, param_count,
                                             train_state_from_reference,
                                             train_state_to_reference)
    from repro_torch.runtime import TrainSupervisor
    from repro_torch.runtime.fault_tolerance import state_tree
    from repro_torch.train import init_train_state, make_optimizer, make_train_step
    from repro_torch.train.optimizer import cosine_schedule
    from repro_torch.train.train_step import deterministic

    tag = "train"
    arch, width = TRAIN
    torch.cuda.reset_peak_memory_stats()
    cfg = get_config(arch)
    check(all(getattr(cfg, k) == v for k, v in width.items()),
          f"{arch} is not at its published width {width}")
    model = build_model(cfg)
    update_ms = []
    opt = timed_optimizer(torch, make_optimizer("adamw", cosine_schedule(*TRAIN_LR)), update_ms)
    state = init_train_state(model, opt, torch.Generator(device=dev).manual_seed(0))
    n_params = param_count(state["params"])
    state_gb = torch.cuda.memory_allocated() / 1e9
    batches = make_batch_fn(SyntheticTokens(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=SEED))
    step = make_train_step(model, opt, accum_steps=TRAIN_ACCUM)
    losses, step_ms = [], []
    for s in range(TRAIN_STEPS):
        batch = batches(s)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        loss = float(metrics["loss"])  # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(loss)
        check(math.isfinite(loss) and math.isfinite(float(metrics["grad_norm"])),
              f"step {s}: loss {loss}, grad norm {float(metrics['grad_norm'])}")
    ln_v = math.log(cfg.vocab_size)
    check(0.5 * ln_v < losses[0] < 3.0 * ln_v,
          f"first loss {losses[0]:.4f} outside (0.5, 3) x ln V = {ln_v:.3f}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    # model FLOPs of a step: 6 N a token (N counts the tied embedding once:
    # the lookup is free, the head's product is not) plus 12 L d T a token for
    # the scores and the context (PaLM's count, the causal half not taken
    # off); the recompute of remat is not counted
    flops = tokens * (6 * n_params + 12 * cfg.n_layers * cfg.d_model * TRAIN_SEQ)
    steady = step_ms[1:]
    p50 = float(np.percentile(steady, 50))
    print(f"[{tag}] ok: {arch}, {cfg.n_layers} layers x {cfg.d_model} (fp32 weights, "
          f"{cfg.dtype} compute): {TRAIN_STEPS} AdamW steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens "
          f"(accum_steps {TRAIN_ACCUM}, remat) on {n_params:,} parameters (train state "
          f"{state_gb:.1f} GB); losses {json.dumps([round(x, 4) for x in losses])} (first in "
          f"(0.5, 3) x ln V); {card}: step ms p50 {p50:.1f}, p99 "
          f"{float(np.percentile(steady, 99)):.1f} (steps 2-{TRAIN_STEPS}; the first "
          f"{step_ms[0]:.1f}), {tokens / p50 * 1e3:.1f} tokens/s, model FLOPs "
          f"{flops:.4g} a step = {flops / (p50 / 1e3) / PEAK_OPS['bf16']:.4f} of the dense bf16 "
          f"peak; AdamW update ms p50 {float(np.percentile(update_ms, 50)):.1f}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB ({phase_s():.1f} s)", flush=True)
    del state, step, opt
    free_card(torch)

    # ---------------------------- (b) the full width, 2 of its 40 layers
    torch.cuda.reset_peak_memory_stats()
    cut = cfg.scaled(n_layers=TRAIN_CUT)
    model = build_model(cut)
    adamw = make_optimizer("adamw", cosine_schedule(*TRAIN_LR))
    state = init_train_state(model, adamw, torch.Generator(device=dev).manual_seed(1))
    params = state["params"]
    batch = batches(0)

    def grads(remat=True, accum=1):
        """(loss, gradients) of ``batch``, the microbatches' gradients summed
        in place and scaled as ``make_train_step`` does."""
        for p in params.parameters():
            p.grad = None
        total = 0.0
        with deterministic():
            for i in range(accum):
                rows = slice(i * TRAIN_BATCH // accum, (i + 1) * TRAIN_BATCH // accum)
                mb = {k: v[rows] for k, v in batch.items()}
                hidden, _, _ = transformer.forward(params, mb["tokens"], cut, remat=remat)
                logits = transformer.logits_fn(params, hidden, cut)
                loss = cross_entropy(logits, torch.as_tensor(mb["labels"], device=dev),
                                     cut.vocab_size)
                loss.backward()
                total = total + loss.detach()
                del hidden, logits, loss
        out = {n: p.grad.detach().clone() / accum for n, p in params.named_parameters()}
        return float(total) / accum, out

    loss_on, g_on = grads(remat=True)
    peak_remat = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    loss_off, g_off = grads(remat=False)
    peak_plain = torch.cuda.max_memory_allocated()
    check(loss_on == loss_off and all(torch.equal(g_on[n], g_off[n]) for n in g_on),
          "remat on and off give other gradients")
    del g_off
    loss_acc, g_acc = grads(accum=2)
    acc_err = rel_l2(np, {n: g.float().cpu().numpy() for n, g in g_acc.items()},
                     {n: g.float().cpu().numpy() for n, g in g_on.items()})
    check(abs(loss_acc - loss_on) <= 1e-3 * abs(loss_on) and acc_err <= TRAIN_ACCUM_TOL,
          f"accum 2 vs 1: loss {loss_acc} vs {loss_on}, gradients {acc_err}")
    del g_on, g_acc
    for p in params.parameters():
        p.grad = None
    print(f"[{tag}] ok: {arch} at its width, {TRAIN_CUT} of {cfg.n_layers} layers, "
          f"{TRAIN_BATCH} x {TRAIN_SEQ} tokens: remat on / off gradients torch.equal (peak "
          f"memory {peak_remat / 1e9:.1f} / {peak_plain / 1e9:.1f} GB); accum_steps 2 vs 1: "
          f"loss {loss_acc:.6f} vs {loss_on:.6f}, gradients {acc_err:.3g} apart in relative "
          f"L2 (tol {TRAIN_ACCUM_TOL})", flush=True)

    # one fp32 step (TF32 off) on the card against the port's CPU step
    f32 = cut.scaled(dtype="float32")
    small = make_batch_fn(SyntheticTokens(cfg.vocab_size, TRAIN_SMALL_SEQ, TRAIN_BATCH,
                                          seed=SEED + 1))
    tree = train_state_to_reference(state)
    on_cpu = train_state_from_reference(tree, f32, device="cpu")
    step32 = make_train_step(build_model(f32), adamw)
    state, m_card = step32(state, small(0))
    t0 = time.perf_counter()
    on_cpu, m_cpu = step32(on_cpu, small(0))
    cpu_s = time.perf_counter() - t0
    got, want = train_state_to_reference(state), train_state_to_reference(on_cpu)
    errs = {k: rel_l2(np, got["opt"][k], want["opt"][k]) for k in ("m", "v")}
    lr1 = float(m_card["lr"])
    flipped, moved, seen = 0, 0.0, 0
    for path, g_p, w_p, w_m in params_leaves(got["params"], want["params"], want["opt"]["m"]):
        w_p = np.asarray(w_p, np.float64)
        diff = np.abs(np.asarray(g_p, np.float64) - w_p)
        big = np.abs(w_m) > 0.1 * TRAIN_FP32_G  # m = 0.1 g after one step
        check(float(diff.max()) <= 2.0001 * lr1,
              f"fp32 step: {path} moved {float(diff.max())} apart (2 lr = {2 * lr1})")
        tol = TRAIN_FP32_UTOL * lr1 + 2.0 ** -22 * np.abs(w_p)
        check(bool((diff[big] <= tol[big]).all()),
              f"fp32 step: {path} {float(diff[big].max())} apart where |g| > {TRAIN_FP32_G}")
        if big.any():
            moved = max(moved, float(diff[big].max()) / lr1)
        flipped += int((diff > tol).sum())
        seen += diff.size
    check(abs(float(m_card["loss"]) - float(m_cpu["loss"])) <= 1e-5 * float(m_cpu["loss"])
          and max(errs.values()) <= TRAIN_FP32_TOL,
          f"fp32 step: card {float(m_card['loss'])} vs CPU {float(m_cpu['loss'])}, {errs}")
    del tree, on_cpu, got, want
    print(f"[{tag}] ok: one fp32 AdamW step of {TRAIN_BATCH} x {TRAIN_SMALL_SEQ} tokens on the "
          f"card (TF32 off) vs the CPU ({cpu_s:.1f} s): loss {float(m_card['loss']):.6f} vs "
          f"{float(m_cpu['loss']):.6f}; m, v {errs['m']:.3g}, {errs['v']:.3g} apart in relative "
          f"L2 (tol {TRAIN_FP32_TOL}); params where |g| > {TRAIN_FP32_G} within {moved:.3g} lr "
          f"(tol {TRAIN_FP32_UTOL} lr + 2 ulps); {flipped} of {seen:,} parameters apart by "
          f"more (all within 2 lr = {2 * lr1:.3g})", flush=True)

    # descent on 2 alternating batches, the config's bf16 compute
    n_desc, lr = TRAIN_DESCENT
    opt = make_optimizer("adamw", cosine_schedule(*lr))
    state = init_train_state(model, opt, torch.Generator(device=dev).manual_seed(2))
    step = make_train_step(model, opt)
    desc = []
    for s in range(n_desc):
        state, metrics = step(state, small(s % 2))
        desc.append(float(metrics["loss"]))
    check(all(map(math.isfinite, desc)) and desc[-1] < desc[0] - 0.1,
          f"the loss did not fall by 0.1: {desc[0]} -> {desc[-1]}")
    print(f"[{tag}] ok: {n_desc} steps on 2 alternating batches, cosine_schedule{lr}: loss "
          f"{desc[0]:.4f} -> {desc[-1]:.4f}", flush=True)
    del state

    # a supervised run with a failure injected, against an uninterrupted one
    def fresh():
        return init_train_state(model, adamw, torch.Generator(device=dev).manual_seed(3))

    step = make_train_step(model, adamw)
    state = fresh()
    for s in range(TRAIN_SUP_STEPS):
        state, _ = step(state, small(s))
    want = {n: p.detach().clone() for n, p in state["params"].named_parameters()}
    want_opt = {k: v.clone() for k, v in state_tree(state["opt"])["m"].items()}
    del state
    boom = {"armed": True}

    def failure_hook(s):
        if s == TRAIN_FAIL_AT and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("simulated node failure")

    root = ROOT / "build"
    root.mkdir(exist_ok=True)
    ck_dir = Path(tempfile.mkdtemp(prefix="train_ckpt_", dir=root))
    try:
        sup = TrainSupervisor(str(ck_dir), ckpt_every=TRAIN_CKPT_EVERY)
        io_s = {"save": [], "restore": []}
        for name in io_s:
            fn = getattr(sup.ckpt, name)

            def timed(*a, _fn=fn, _name=name, **k):
                t0 = time.perf_counter()
                out = _fn(*a, **k)
                io_s[_name].append(time.perf_counter() - t0)
                return out

            setattr(sup.ckpt, name, timed)
        state = sup.run(fresh(), step, small, TRAIN_SUP_STEPS, failure_hook=failure_hook)
        ck_gb = sum(f.stat().st_size for f in ck_dir.rglob("*.npy")) / 1e9 / len(
            sup.ckpt.all_steps())
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    check(sup.restarts == 1 and int(state["step"]) == TRAIN_SUP_STEPS
          and all(torch.equal(p, want[n]) for n, p in state["params"].named_parameters())
          and all(torch.equal(v, want_opt[k]) for k, v in state["opt"]["m"].items()),
          "the supervised restart is not bit-equal to the uninterrupted run")
    print(f"[{tag}] ok: TrainSupervisor, failure at step {TRAIN_FAIL_AT}, checkpoints every "
          f"{TRAIN_CKPT_EVERY}, {TRAIN_SUP_STEPS} steps: params and AdamW state torch.equal to "
          f"the uninterrupted run, 1 restart; a checkpoint {ck_gb:.2f} GB, save s "
          f"{json.dumps([round(x, 2) for x in io_s['save']])}, restore s "
          f"{json.dumps([round(x, 2) for x in io_s['restore']])}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB ({phase_s():.1f} s)", flush=True)
    del state, params, want, want_opt
    free_card(torch)

    # ------------------------------------ (c) the launcher, --smoke, on the card
    ck_dir = Path(tempfile.mkdtemp(prefix="train_launch_", dir=root))
    try:
        launch = train_main(["--arch", arch, "--smoke", "--steps", str(TRAIN_LAUNCH_STEPS),
                             "--ckpt", str(ck_dir)])
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    check(len(launch) == TRAIN_LAUNCH_STEPS and all(map(math.isfinite, launch)),
          f"launch.train: {launch}")
    print(f"[{tag}] ok: launch.train --arch {arch} --smoke --steps {TRAIN_LAUNCH_STEPS} on the "
          f"card: loss {launch[0]:.4f} -> {launch[-1]:.4f} ({phase_s():.1f} s)", flush=True)
    free_card(torch)


def mesh_ep(torch, np, dev, card, arctic, phase_s) -> None:
    """Phase 24 (a), run on phase 19's parameters before they are freed:
    Arctic-480B (full width, ARCTIC's depth) expert-parallel on a
    single-controller (data 2, model 4) mesh over the card.  Layer 0's
    ``moe_ffn`` of a prefill of MESH_EP_BATCH x MESH_EP_SEQ tokens and of a
    decode step at LM_SLOTS slots against ``moe_oracle`` run data shard by
    data shard at the per-shard capacity (the same experts and kept
    assignments, out within MOE_TOL x max |oracle|), the EP loss against the
    one-device loss (MESH_EP_RTOL), and the ms of each."""
    from repro_torch.core.distributed import make_mesh
    from repro_torch.data.pipeline import SyntheticTokens, make_batch_fn
    from repro_torch.models import ffn as ffn_mod

    tag = "mesh"
    torch.cuda.reset_peak_memory_stats()
    cfg, model, params = arctic
    mesh = make_mesh(*MESH_EP)
    check(all(d.type == dev.type for d in mesh.devices), "the mesh is not on the card")
    E, k, D = cfg.n_experts, cfg.experts_per_token, cfg.d_model
    dp, tp = mesh.shape["data"], mesh.shape["model"]
    batch = make_batch_fn(SyntheticTokens(cfg.vocab_size, MESH_EP_SEQ, MESH_EP_BATCH,
                                          seed=SEED + 2))(0)
    toks = torch.as_tensor(batch["tokens"], device=dev)
    labels = torch.as_tensor(batch["labels"], device=dev)
    summary = {}
    with torch.inference_mode():
        cases = {"prefill": capture_moe(ffn_mod, lambda: model.prefill(
            params, {"tokens": toks}, mesh))}
        _, _, c = model.prefill(params, {"tokens": toks[:LM_SLOTS, :LM_CHECK_T]}, mesh,
                                cache_len=LM_CACHE)
        cases["decode"] = capture_moe(ffn_mod, lambda: model.decode(
            params, toks[:LM_SLOTS, LM_CHECK_T], c, LM_CHECK_T, mesh))
        del c
        for name, (x, p, out, aux) in cases.items():
            xf = x.reshape(-1, D)
            m = xf.shape[0] // dp
            _, ids = ffn_mod._top_k(torch.softmax(xf.float() @ p["router"].float(), -1), k)
            cap = max(4, math.ceil(xf.shape[0] * k / dp / E * cfg.moe_capacity_factor))
            errs, dropped, scale = [], [], 0.0
            for d in range(dp):
                rows = slice(d * m, (d + 1) * m)
                want, kept, ids_o, _, cap_o = moe_oracle(torch, x.reshape(-1, D)[rows][None],
                                                         p, cfg)
                check(cap_o == cap and torch.equal(ids_o, ids[rows]),
                      f"{name}, data shard {d}: the router's top-{k} or the capacity differs")
                kept_port = torch.zeros_like(kept)
                for r in range(tp):
                    keep, _, flat = ffn_mod._dispatch(ids[rows], capacity=cap,
                                                      n_local=E // tp, first_eid=r * (E // tp))
                    kept_port[flat[keep]] = True
                check(torch.equal(kept_port, kept),
                      f"{name}, data shard {d}: kept assignments differ from the oracle's")
                errs.append(float((out.reshape(-1, D)[rows].float() - want).abs().max()))
                scale = max(scale, float(want.abs().max()))
                dropped.append(int((~kept).sum()))
            check(max(errs) <= MOE_TOL * scale, f"{name}: the EP moe_ffn off the oracle by "
                  f"{max(errs)} (tol {MOE_TOL} x {scale})")
            summary[name] = {"tokens": xf.shape[0], "capacity_per_shard": cap,
                             "dropped_per_shard": dropped, "max_abs_err": round(max(errs), 5),
                             "max_abs_out": round(scale, 4)}
        del cases, x, p, out
        one = float(model.loss(params, {"tokens": toks, "labels": labels})[0])
        ep = float(model.loss(params, {"tokens": toks, "labels": labels}, mesh)[0])
        check(abs(ep - one) <= MESH_EP_RTOL * abs(one),
              f"the EP loss {ep} is not within {MESH_EP_RTOL} of the one-device loss {one}")
        ms = {}
        for name, fn in (
                ("prefill_ep", lambda: model.prefill(params, {"tokens": toks}, mesh)),
                ("prefill_1dev", lambda: model.prefill(params, {"tokens": toks})),
                ("loss_ep", lambda: model.loss(params, {"tokens": toks, "labels": labels},
                                               mesh)),
                ("loss_1dev", lambda: model.loss(params, {"tokens": toks, "labels": labels}))):
            ms[name] = round(wall_ms(torch, fn, 3), 2)
        _, _, c = model.prefill(params, {"tokens": toks[:LM_SLOTS, :LM_CHECK_T]},
                                cache_len=LM_CACHE)
        tok = toks[:LM_SLOTS, LM_CHECK_T]
        ms["decode_ep"] = round(wall_ms(torch, lambda: model.decode(params, tok, c, LM_CHECK_T,
                                                                   mesh), 5), 2)
        ms["decode_1dev"] = round(wall_ms(torch, lambda: model.decode(params, tok, c,
                                                                     LM_CHECK_T), 5), 2)
        del c
    print(f"[{tag}] ok (a): {cfg.name} at its width, {cfg.n_layers} of 35 layers, expert-"
          f"parallel on a (data {dp}, model {tp}) mesh of {mesh.size} x {dev}: layer 0's "
          f"moe_ffn == moe_oracle per data shard at the per-shard capacity (the same top-{k} "
          f"experts and kept assignments, out within {MOE_TOL} x max |out|): "
          f"{json.dumps(summary)}; loss EP {ep:.6f} vs one device {one:.6f} (rtol "
          f"{MESH_EP_RTOL}); {card}: ms {json.dumps(ms)}; peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB ({phase_s():.1f} s)", flush=True)


def mesh_pp(torch, np, dev, card, phase_s) -> None:
    """Phase 24 (b): GPipe.  Yi-9B at its width, PP_LAYERS layers,
    ``pp_loss_fn`` over the 'pod' axis of a (pod 2, data 2, model 2) mesh
    on the card against ``model.loss``: the loss and the embedding's
    gradient, ms and the bubble share."""
    from repro_torch.configs import get_config
    from repro_torch.core.distributed import make_mesh
    from repro_torch.data.pipeline import SyntheticTokens, make_batch_fn
    from repro_torch.models.registry import build_model, param_count
    from repro_torch.sharding import pp
    from repro_torch.train.train_step import deterministic

    tag = "mesh"
    # --------------------------------------------- (b) GPipe over 'pod', Yi-9B
    torch.cuda.reset_peak_memory_stats()
    arch, width = PP_RUN
    cfg = get_config(arch).scaled(n_layers=PP_LAYERS)
    check(all(getattr(cfg, k) == v for k, v in width.items()),
          f"{arch} is not at its published width {width}")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    params.requires_grad_(True)
    mesh = make_mesh(*MESH_PP)
    S, M = mesh.shape["pod"], PP_MICRO
    batch = {k_: torch.as_tensor(v, device=dev) for k_, v in make_batch_fn(SyntheticTokens(
        cfg.vocab_size, PP_SEQ, PP_BATCH, seed=SEED + 3))(0).items()}

    def grad_of(fn):
        for p_ in params.parameters():
            p_.grad = None
        with deterministic():
            loss = fn()
            loss.backward()
        torch.cuda.synchronize()
        return float(loss.detach()), params.embed.grad.detach().clone()

    plain = lambda: model.loss(params, batch)[0]  # noqa: E731
    piped = lambda: pp.pp_loss_fn(params, batch, cfg, mesh, microbatches=M)  # noqa: E731
    loss_ref, g_ref = grad_of(plain)
    loss_pp, g_pp = grad_of(piped)
    handoff = pp.handoff_bytes(cfg, PP_BATCH, PP_SEQ, S, M)
    check(abs(loss_pp - loss_ref) <= PP_LOSS_RTOL * abs(loss_ref),
          f"pp_loss_fn {loss_pp} vs model.loss {loss_ref} (rtol {PP_LOSS_RTOL})")
    bad = (g_pp - g_ref).abs() > PP_GRAD["atol"] + PP_GRAD["rtol"] * g_ref.abs()
    check(not bool(bad.any()), f"the embedding's gradient: {int(bad.sum())} elements beyond "
          f"rtol {PP_GRAD['rtol']}, atol {PP_GRAD['atol']}")
    g_rel = float((g_pp - g_ref).norm() / g_ref.norm())
    del g_pp, g_ref
    ms = {}
    for name, fn in (("pp", piped), ("plain", plain)):
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            grad_of(fn)
            times.append((time.perf_counter() - t0) * 1e3)
        ms[name] = round(min(times), 1)
    print(f"[{tag}] ok (b): {arch} at its width, {PP_LAYERS} of 48 layers "
          f"({param_count(params):,} fp32 parameters), GPipe over the 'pod' axis of a "
          f"{json.dumps(mesh.shape)} mesh on {dev}: {S} stages, {PP_BATCH} x {PP_SEQ} tokens "
          f"in {M} microbatches, {M + S - 1} ticks, bubble (S-1)/(M+S-1) = "
          f"{(S - 1) / (M + S - 1):.2f}; loss {loss_pp:.6f} vs model.loss {loss_ref:.6f} "
          f"(rtol {PP_LOSS_RTOL}); the embedding's gradient within rtol {PP_GRAD['rtol']}, "
          f"atol {PP_GRAD['atol']} ({g_rel:.3g} apart in relative L2); hand-offs "
          f"{handoff / 1e6:.1f} MB forward and backward; {card}: forward + backward ms "
          f"{json.dumps(ms)}; peak memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB "
          f"({phase_s():.1f} s)", flush=True)
    for p_ in params.parameters():
        p_.grad = None
    del params, model, batch
    free_card(torch)


def mesh_pods(torch, np, dev, card, phase_s) -> None:
    """Phase 24 (c): MiniCPM-2B at its width, PODS_LAYERS layers, AdamW
    steps through the int8 error-feedback exchange across the pods of a
    (pod 2, data 1, model 1) mesh against the uncompressed step, every
    pod's residual tree through a checkpoint."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import get_config
    from repro_torch.core.distributed import make_mesh
    from repro_torch.data.pipeline import SyntheticTokens, make_batch_fn
    from repro_torch.models.registry import build_model, param_count, stacked_leaves
    from repro_torch.runtime.fault_tolerance import state_tree
    from repro_torch.train import grad_compression as gc
    from repro_torch.train import init_train_state, make_optimizer, make_train_step
    from repro_torch.train.optimizer import Optimizer, cosine_schedule

    tag = "mesh"
    # ------------------------- (c) int8 error-feedback exchange across pods
    torch.cuda.reset_peak_memory_stats()
    arch, width = TRAIN
    cfg = get_config(arch).scaled(n_layers=PODS_LAYERS)
    model = build_model(cfg)
    mesh = make_mesh(*MESH_PODS)
    base = make_optimizer("adamw", cosine_schedule(*TRAIN_LR))
    probe = {}

    def update(grads, st, params_):
        """AdamW's update; the uncompressed step's gradient is kept, and
        compressed step 1's held against it (relative L2)."""
        if probe.pop("keep", False):
            probe["g_u"] = {n: g.detach().clone() for n, g in grads.items()}
        elif "g_u" in probe:
            g_u = probe.pop("g_u")
            num = sum(float((grads[n].float() - g_u[n].float()).square().sum()) for n in g_u)
            den = sum(float(g_u[n].float().square().sum()) for n in g_u)
            probe["g_err"] = (num / den) ** 0.5
            del g_u
        return base.update(grads, st, params_)

    opt = Optimizer(base.init, update)
    state = init_train_state(model, opt, torch.Generator(device=dev).manual_seed(0),
                             compress_pods=True, mesh=mesh)
    params = state["params"]
    n_params = param_count(params)
    batches = make_batch_fn(SyntheticTokens(cfg.vocab_size, PODS_SEQ, mesh.shape["pod"],
                                            seed=SEED + 4))
    # the starting parameters and the uncompressed step's update, on the host
    p0 = {n: p_.detach().to("cpu", copy=True) for n, p_ in params.named_parameters()}
    probe["keep"] = True
    state, m_u = make_train_step(model, opt, mesh)(state, batches(0))
    loss_u = float(m_u["loss"])
    d_u = {n: p_.detach().cpu() - p0[n] for n, p_ in params.named_parameters()}
    with torch.no_grad():  # back to the starting state
        for n, p_ in params.named_parameters():
            p_.copy_(p0[n])
        for moments in (state["opt"]["m"], state["opt"]["v"]):
            for t in moments.values():
                t.zero_()
        state["opt"]["step"].zero_()
        state["step"].zero_()
    timing = {"encode": [], "mean_of_codes": []}
    inner = {name: getattr(gc, name) for name in timing}

    def timed(name):
        def run(*a, **k_):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = inner[name](*a, **k_)
            torch.cuda.synchronize()
            timing[name].append((time.perf_counter() - t0) * 1e3)
            return out
        return run

    step = make_train_step(model, opt, mesh, compress_pods=True)
    losses, step_ms, exchange_ms = [], [], []
    for name in timing:
        setattr(gc, name, timed(name))
    try:
        for s in range(PODS_STEPS):
            for t in timing.values():
                t.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, metrics = step(state, batches(s))
            loss = float(metrics["loss"])
            step_ms.append((time.perf_counter() - t0) * 1e3)
            exchange_ms.append(sum(sum(t) for t in timing.values()))
            losses.append(loss)
            check(math.isfinite(loss), f"compressed step {s}: loss {loss}")
            if s == 0:
                up = {"num": 0.0, "den": 0.0, "pden": 0.0}
                with torch.no_grad():
                    for n, p_ in params.named_parameters():
                        diff = (p_.detach().cpu() - p0[n]) - d_u[n]
                        up["num"] += float(diff.square().sum())
                        up["den"] += float(d_u[n].square().sum())
                        up["pden"] += float((p0[n] + d_u[n]).square().sum())
                del p0, d_u
                update_err = (up["num"] / up["den"]) ** 0.5
                param_err = (up["num"] / up["pden"]) ** 0.5
    finally:
        for name, fn in inner.items():
            setattr(gc, name, fn)
    wire = gc.wire_bytes([leaf.shape for leaf in stacked_leaves(params)], mesh.shape["pod"])
    wire = wire["pod_int8"] / wire["pod_fp32"]
    check(abs(losses[0] - loss_u) <= 1e-5 * abs(loss_u),
          f"compressed step 1's loss {losses[0]} vs the uncompressed step's {loss_u}")
    g_err = probe.pop("g_err")
    check(param_err <= PODS_TOL, f"step 1 through the int8 exchange: parameters {param_err} "
          f"apart from the uncompressed step's in relative L2 (tol {PODS_TOL})")
    # the exchange's own error, whatever the size of the update: the mean
    # gradient against the uncompressed one
    check(g_err <= PODS_GRAD_TOL, f"step 1 through the int8 exchange: the gradient {g_err} "
          f"apart from the uncompressed step's in relative L2 (tol {PODS_GRAD_TOL})")
    # the update against the uncompressed update: a step that does not move
    # the parameters reads 1, one that moves them backwards 2
    check(update_err <= PODS_UPDATE_TOL, f"step 1 through the int8 exchange: the update "
          f"{update_err} apart from the uncompressed update in relative L2 (tol "
          f"{PODS_UPDATE_TOL})")
    norms = [float(sum(t.abs().sum() for t in e.values())) for e in state["err"]]
    check(all(x > 0 for x in norms) and norms[0] != norms[1],
          f"the pods' residual trees are not two non-zero trees of their own: {norms}")
    peak = torch.cuda.max_memory_allocated() / 1e9
    root = ROOT / "build"
    root.mkdir(exist_ok=True)
    ck_dir = Path(tempfile.mkdtemp(prefix="mesh_ckpt_", dir=root))
    try:
        t0 = time.perf_counter()
        Checkpointer(str(ck_dir)).save(PODS_STEPS, {"err": state_tree(state["err"])})
        save_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tree, _ = Checkpointer(str(ck_dir)).restore()
        restore_s = time.perf_counter() - t0
        ck_gb = sum(f.stat().st_size for f in ck_dir.rglob("*.npy")) / 1e9
    finally:
        shutil.rmtree(ck_dir, ignore_errors=True)
    check(all(torch.equal(torch.as_tensor(tree["err"][str(i)][path]), t.cpu())
              for i, e in enumerate(state["err"]) for path, t in e.items()),
          "a pod's residual tree did not round-trip a checkpoint bit for bit")
    del tree
    tokens = mesh.shape["pod"] * PODS_SEQ
    p50 = float(np.percentile(step_ms[1:], 50))
    print(f"[{tag}] ok (c): {arch} at its width, {PODS_LAYERS} of 40 layers ({n_params:,} fp32 "
          f"parameters), AdamW through the int8 error-feedback exchange across the pods of a "
          f"{json.dumps(mesh.shape)} mesh on {dev}, {PODS_STEPS} steps of "
          f"{mesh.shape['pod']} x {PODS_SEQ} tokens (a sequence a pod): losses "
          f"{json.dumps([round(x, 4) for x in losses])}; step 1 vs the uncompressed step: loss "
          f"{losses[0]:.6f} vs {loss_u:.6f}, parameters {param_err:.3g} apart in relative L2 "
          f"(tol {PODS_TOL}), the gradient {g_err:.3g} (tol {PODS_GRAD_TOL}), the update "
          f"{update_err:.3g} (tol {PODS_UPDATE_TOL}); "
          f"residual L1 per pod {json.dumps([round(x, 3) for x in norms])}, through a "
          f"checkpoint torch.equal ({ck_gb:.2f} GB, save {save_s:.1f} s, restore "
          f"{restore_s:.1f} s); wire bytes int8 / fp32 {wire:.4f}; {card}: step ms p50 "
          f"{p50:.1f} (the first {step_ms[0]:.1f}), quantize and exchange ms p50 "
          f"{float(np.percentile(exchange_ms[1:], 50)):.1f}, {tokens / p50 * 1e3:.1f} tokens/s; "
          f"peak memory {peak:.1f} GB ({phase_s():.1f} s)", flush=True)
    del state, params, model, opt, step
    free_card(torch)


def mesh_dryrun(torch, np, dev, card, phase_s) -> None:
    """Phase 24 (d): ``launch.dryrun``'s DRYRUN_CELLS on the 16 x 16
    production mesh, on the meta device: nothing may be allocated on the
    card."""
    from repro_torch.launch.dryrun import run_cell

    tag = "mesh"
    # ------------------------------------- (d) the dry run, on the meta device
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    cells = {}
    for arch, shapes in DRYRUN_CELLS:
        for shape in shapes:
            r = run_cell(arch, shape, False, force=True)
            check(r.get("status") == "ok", f"dry run {arch} x {shape}: {r.get('error')}")
            cells[f"{arch}/{shape}"] = {
                "GB_per_device": round(r["memory"]["per_device_total"] / 1e9, 3),
                "flops": r["step_stats"]["flops"],
                "collective_bytes": r["step_stats"]["collective_bytes"],
                "s": round(r["build_s"] + r["analyze_s"], 1)}
    check(torch.cuda.memory_allocated() == before
          and torch.cuda.max_memory_allocated() == before,
          f"the dry run allocated on the card: {torch.cuda.memory_allocated()} bytes, peak "
          f"{torch.cuda.max_memory_allocated()}, before {before}")
    print(f"[{tag}] ok (d): the dry run on the 16 x 16 production mesh (device meta): "
          f"{json.dumps(cells)}; CUDA memory unchanged ({before} bytes) ({phase_s():.1f} s)",
          flush=True)


def mesh_phase(torch, np, dev, card, phase_s, parts="bcd") -> None:
    """Phase 24 (b)-(d), the mesh: GPipe, the int8 exchange across pods,
    the dry run (``parts`` picks them)."""
    for part, fn in (("b", mesh_pp), ("c", mesh_pods), ("d", mesh_dryrun)):
        if part in parts:
            fn(torch, np, dev, card, phase_s)


def batch_serve(torch, kernels, model, params, batch, store, r0):
    """The requests of ``batch`` (tokens (R, T) and their modality stub)
    decoded together on the batch path (the engine serves uniform caches
    only): one prefill, then LM_NEW - 1 greedy steps of ``model.decode``,
    or of ``RetrievalLM.decode`` through ``store``; launch counts reset
    just before.  Returns (tokens (R, LM_NEW), each step's top-two gaps
    (R,) and hidden states (R, D), numbers, launches)."""
    from repro_torch.serve import RetrievalLM

    step = model.decode if store is None else RetrievalLM(model, store, r0=r0,
                                                          steps=LM_STEPS).decode
    R, T = batch["tokens"].shape
    steps_ms, search_ms = [], []
    if store is not None:
        search = store.search

        def timed_search(*a, **k):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = search(*a, **k)
            torch.cuda.synchronize()
            search_ms.append((time.perf_counter() - t) * 1e3)
            return out

        store.search = timed_search

    def top2(scores):
        v = torch.topk(scores.float(), 2).values
        return (v[:, 0] - v[:, 1]).cpu()

    kernels.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.inference_mode():
        logits, hidden, caches = model.prefill(params, batch, cache_len=T + LM_NEW)
        toks, gaps, states = [logits.argmax(-1)], [top2(logits)], [hidden[:, -1].float()]
        for i in range(LM_NEW - 1):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out, h, caches = step(params, toks[-1], caches, T + i)
            torch.cuda.synchronize()
            steps_ms.append((time.perf_counter() - t) * 1e3)
            check(bool(torch.isfinite(out).all()), "non-finite decode log-probabilities")
            toks.append(out.argmax(-1))
            gaps.append(top2(out))
            states.append(h.float())
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = dict(kernels.launches)
    if store is not None:
        del store.search
    return torch.stack(toks, 1).cpu(), gaps, states, {
        "wall_s": round(wall, 3), "tokens_per_s": round(R * LM_NEW / wall, 2),
        "step_ms_p50": round(statistics.median(steps_ms), 3),
        "step_ms_p99": round(sorted(steps_ms)[math.ceil(0.99 * len(steps_ms)) - 1], 3),
        "retrieval_share": round(sum(search_ms) / sum(steps_ms), 4) if search_ms else 0.0,
    }, {k: launched[k] for k in LM_COUNTED}


def xattn_phase(torch, np, dev, card, kernels, wrappers, twins, records, phase_s,
                tag: str) -> None:
    """Phases 21 (``whisper``: Whisper-medium) and 22 (``vlm``:
    Llama-3.2-Vision-11B): a full-width cross-attention LM (random
    weights; the VLM's gates set to XA_GATE) and a DB-LSH datastore of its
    decoder states, each sample with its own stub frames or image
    embeddings; the gates of phase 17, other frames / images moving the
    logits, and XA_REQUESTS requests served on the batch path without
    retrieval and through the torch engine, B2 (kernel) and B1 (inline)."""
    from repro_torch.models.registry import build_model

    arch, width, n_batches, seq, extra = XA_RUNS[tag]
    torch.cuda.reset_peak_memory_stats()
    smem_plan(torch, tag, n_batches * LM_BATCH * seq, width["d_model"])
    cfg, model, params = lm_model(torch, dev, tag, arch, width)
    check(all(p.dtype == torch.float32 for p in params.parameters()), "weights not fp32")
    if cfg.family == "vlm":
        with torch.no_grad():
            for c in params.cross_blocks:
                c.gate_attn.fill_(XA_GATE)
                c.gate_ffn.fill_(XA_GATE)
        print(f"[{tag}] the reference draws the {len(params.cross_blocks)} cross layers' gates "
              f"as 0 (tanh 0 = 0: the images would not count); both set to atanh(0.5) = "
              f"{XA_GATE:.6f}", flush=True)
    shape = (cfg.enc_seq, cfg.d_model) if extra == "frames" else (cfg.n_img_tokens,
                                                                   cfg.d_vision)
    ds, batch_fn, held, bd, truth, r0 = lm_datastore(torch, np, dev, tag, model, params,
                                                     n_batches, seq=seq,
                                                     extras={extra: shape})
    stores = lm_stores(torch, tag, ds)
    found, atol = heldout_gates(torch, tag, stores, held, bd, truth, r0)
    knn_probs_gate(torch, ds, held, found, params, cfg, r0)

    # gate 1, and the modality stub moving the logits
    b0 = batch_fn(0)
    gate_batch = {"tokens": torch.as_tensor(b0["tokens"][:1, :LM_CHECK_T], device=dev),
                  extra: b0[extra][:1]}
    gaps, std = prefill_decode_gate(
        torch, tag, ((build_model(cfg.scaled(dtype="float32")), LM_FP32_TOL),
                     (model, LM_BF16_TOL)), params, gate_batch, LM_CHECK_T)
    with torch.inference_mode():
        mine = model.prefill(params, gate_batch)[0].float()
        other = model.prefill(params, {**gate_batch, extra: b0[extra][1:2]})[0].float()
    moved = float((mine - other).abs().max())
    check(moved > LM_BF16_TOL, f"other {extra} move the logits by {moved} only")
    print(f"[{tag}] ok: prefill of {LM_CHECK_T} == prefill of {LM_CHECK_T - 1} + one decode, "
          f"max |dlogit| {json.dumps(gaps)} (tol fp32 {LM_FP32_TOL}, {cfg.dtype} "
          f"{LM_BF16_TOL}); logits std {std:.3f}; another sample's {extra} move them by "
          f"{moved:.3f}", flush=True)

    # serving: the same requests without retrieval and through each datastore
    b1 = batch_fn(n_batches + 1)
    batch = {"tokens": torch.as_tensor(b1["tokens"][:XA_REQUESTS, :XA_PROMPT], device=dev),
             extra: b1[extra][:XA_REQUESTS]}
    toks, tgaps, states, runs, path_launches = {}, {}, {}, {}, {}
    for name in ("none", *stores):
        toks[name], tgaps[name], states[name], runs[name], path_launches[name] = batch_serve(
            torch, kernels, model, params, batch, None if name == "none" else stores[name], r0)
    check(path_launches["kernel"]["fused_cand_search"] > 0, "the kernel datastore never ran B2")
    check(not any(c_ for n_, c_ in path_launches["torch"].items() if n_ != "select_blocks")
          and not any(path_launches["none"].values()),
          "the torch datastore launched a kernel other than S1, or plain decoding one")
    check(all(path_launches[n_]["select_blocks"] > 0 for n_ in stores),
          f"a datastore never ran S1: {path_launches}")
    merge_lm_checks(tag, path_launches)
    if "inline" in stores:
        check(path_launches["inline"]["fused_window_search"] > 0,
              "the inline datastore never ran B1")
    # every token of kernel / inline equals torch's; a request may part only
    # where the two searches of that step (the same state, the same context
    # so far) differ at near-ties of the k-th distance, or at a near-tie of
    # the log-probabilities' top two
    compared, parted = 0, []
    for name in stores:
        if name == "torch":
            continue
        for r in range(XA_REQUESTS):
            diff = torch.nonzero(toks[name][r] != toks["torch"][r])
            if not len(diff):
                compared += LM_NEW
                continue
            j = int(diff[0])
            compared += j
            check(j > 0, f"{name}: request {r}'s first token (the prefill's) differs")
            q = states["torch"][j][r:r + 1]
            ties = norm_edge_ties(torch, stores[name].search(q, r0=r0, steps=LM_STEPS),
                                  stores["torch"].search(q, r0=r0, steps=LM_STEPS), atol)
            gap = float(tgaps["torch"][j][r])
            check(ties or gap <= LM_BF16_TOL, f"{name}: request {r} parts from torch's at "
                  f"token {j} with the same neighbours, at a top-two gap of {gap}")
            parted.append((name, r, j, round(gap, 4), ties))
    print(f"[{tag}] ok: {XA_REQUESTS} requests of {XA_PROMPT} tokens, each with its own "
          f"{extra}, {LM_NEW} greedy new tokens on the batch path (cache "
          f"{XA_PROMPT + LM_NEW}); {card}: {json.dumps(runs)}; launches "
          f"{json.dumps(path_launches)}; kernel/inline equal torch's over {compared} tokens, "
          f"parted at near-ties (store, request, token, top-two gap, differing searches): "
          f"{parted}", flush=True)

    # a request decoded alone gives its row of the batch
    solo, sgaps, _, _, _ = batch_serve(torch, kernels, model, params,
                                       {"tokens": batch["tokens"][:1], extra: batch[extra][:1]},
                                       None, r0)
    diff = torch.nonzero(solo[0] != toks["none"][0])
    j = int(diff[0]) if len(diff) else LM_NEW
    if j < LM_NEW:
        gap = float(sgaps[j][0])
        check(gap <= LM_BF16_TOL, f"request 0 alone parts from the batch at token {j}, at a "
              f"top-two gap of {gap}")
    print(f"[{tag}] ok: request 0 decoded alone equals its row of the batch over {j} tokens"
          + (f", parting at a near-tie (top-two gap {gap:.4f} <= {LM_BF16_TOL})"
             if j < LM_NEW else ""), flush=True)

    path_kernel_records(torch, kernels, wrappers, twins, records, tag, stores,
                        held[:LM_SLOTS].contiguous(), r0, path_launches)
    print(f"[{tag}] peak memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB "
          f"({phase_s():.1f} s)", flush=True)
    del stores, ds, params
    free_card(torch)


def search_phases(torch, np):
    """Phases 1-16; returns what phase 17 and the last lines need."""
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
    wrappers = {name: getattr(kernels, name)
                for name in (*KERNELS, "select_blocks", "merge_schedule")}
    twins = {name: getattr(ref, f"{name}_ref")
             for name in (*KERNELS, "select_blocks", "merge_schedule")}
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
    # B1/B2 at the kNN-LM datastores' widths on integer inputs, bit-equal to
    # the twin: d = 4096 (K = 10 and the K = 3077, L = 2 derived for phase
    # 17's 262,144 keys) at Q = 1, the serving engine's 4 slots and 64; d =
    # 2048 (K = 2821, phase 18's 131,072 keys) and d = 7168 (K = 2308, phase
    # 19's 32,768 keys; a stage holds 1-2 rows) at Q = 4 and 64
    lm_gen = torch.Generator(device=dev).manual_seed(SEED + 4)
    lm_cases = [(Q, K, 4096) for Q in (1, 4, 64) for K in (10, 3077)]
    lm_cases += [(Q, K, d) for Q in (4, 64) for K, d in ((2821, 2048), (2308, 7168))]
    for (Q, K, d), kind, mode in itertools.product(lm_cases, ("window", "cand"),
                                                   ("norm", "exact")):
        args, n = int_fused_case(torch, lm_gen, kind, Q, 2, K, d, 6, dev)
        name = f"fused_{kind}_search"
        kk = dict(ks=LM_DS["k"], n=n, mode=mode, **({"M": 5} if kind == "window" else {}))
        got = wrappers[name](*args, **kk)
        torch.cuda.synchronize()
        want = twins[name](*args, **kk)
        check(all(torch.equal(a_, b_) for a_, b_ in zip(got, want)),
              f"{name} at d = {d}, K = {K}, Q = {Q}, {mode}: not bit-equal to the twin")
        n_cases += 1
        del args, got, want
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
            eng = per_engine.setdefault(key[0], dict.fromkeys(kernels.launches, 0))
            for name in eng:
                eng[name] += kernels.launches[name] - before[name]
        torch.cuda.synchronize()
        return results, per_engine, dict(kernels.launches)

    results, per_engine, onepass_launches = run_counted(
        [((e, x), (lambda e=e, x=x: search_batch_fixed(index, Q64, engine=e, exact=x, **kw)))
         for e in engines for x in (False, True)])
    for name in FUSED:
        check(onepass_launches[name] > 0, f"the main path never launched {name}")
    check(onepass_launches["select_blocks"] == 2 * len(engines),
          f"S1 launched {onepass_launches['select_blocks']} times in {2 * len(engines)} "
          f"one-pass searches")
    check(all(per_engine[e]["merge_schedule"] == (0 if e == "torch" else 2) for e in engines),
          f"M1 launches per engine {[per_engine[e]['merge_schedule'] for e in engines]}: want "
          f"one a fused search (kernel, inline) and none on torch's pool path")
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
    # M1 on the main path's bins, plain and with every rule and explain
    for (engine, (Qn, Qb)), extra in itertools.product(
            itertools.product(("inline", "kernel"), ((N_QUERIES, Q64), (N_QUERIES_LARGE, Q1k))),
            ({}, {"termination": Termination(), "with_explain": True})):
        a, k = capture_calls(kernels, wrappers, "merge_schedule",
                             lambda: search_batch_fixed(index, Qb, engine=engine, **kw, **extra))
        check(merge_equal(torch, wrappers["merge_schedule"](*a, **k),
                          twins["merge_schedule"](*a, **k)),
              f"M1 ({engine}, Q = {Qn}, {sorted(extra)}): differs from its twin on the main "
              f"path's bins")
    torch.cuda.synchronize()
    print(f"[main] ok: kernels agree with their twins on the main path's inputs at Q = "
          f"{N_QUERIES} and {N_QUERIES_LARGE} (norm form atol 4e-6 x the norms, {scale:.1f} "
          f"at the last, exact form 1e-5); max |err| {max_err}; M1 equal to its twin on "
          f"every output "
          f"({phase_s():.1f} s)", flush=True)

    # --------------------------------------------------- 4. multi-pass path
    multi, per_engine, multi_launches = run_counted(
        [((e,), (lambda e=e: search_batch_fixed_ref(index, Q64, engine=e, **kw)))
         for e in engines])
    want = {"torch": {}, "kernel": {"candidate_verify": params.L * STEPS},
            "inline": {"window_verify": params.L * STEPS}}
    for engine in engines:
        want[engine]["select_blocks"] = STEPS  # S1 once a step, on every engine
        for name in per_engine[engine]:
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
        host = f"host {host_us(torch, lambda: wrappers[wrapper](*a, **k)):.1f} us/call; "
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

    select_times(torch, np, kernels, ref, records,  # S1 at the cells' shapes
                 onepass_launches["select_blocks"])
    merge_times(torch, np, kernels, ref, records,  # M1 at the cells' shapes
                onepass_launches["merge_schedule"])

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
          f"{json.dumps(old_table.recall)}); payload aligned ({phase_s():.1f} s)",
          flush=True)
    del scol

    # -------------------------------------------- 14. the request scheduler
    from repro_torch.obs import Observability
    from repro_torch.resilience import FaultPlan, faults
    from repro_torch.store import DispatchFailed, QuotaExceeded, StoreService

    # the main index behind a collection with a payload (each point's id),
    # so the payload rows ride back with the tickets too
    svc_col = Collection.from_index("svc", index,
                                    payload=torch.arange(N, dtype=torch.int64, device=dev))
    rows_h = queries[:N_QUERIES_LARGE].cpu().numpy()  # the queries, as clients send them
    _, gt1k = brute_force(data, Q1k, k=K_NN, device=dev)
    gt1k_sets = [set(r) for r in gt1k.cpu().tolist()]
    fused_of = {"inline": "fused_window_search", "kernel": "fused_cand_search"}
    svc_kw = dict(batch_shapes=SVC_SHAPES, default_k=K_NN, r0=R0, steps=STEPS)

    def service(col=None, **kw):
        """A StoreService over ``col`` (svc_col when None) whose issued
        batches are logged: (uids, shape, engine) per batch, in issue
        order."""
        svc = StoreService(**{**svc_kw, **kw})
        svc.attach(svc_col if col is None else col)
        svc.batch_log = []
        issue = svc._issue

        def logged(name, reqs, engine=None, *a, **k):
            svc.batch_log.append(([r.uid for r in reqs], svc._shape_for(len(reqs)), engine))
            return issue(name, reqs, engine, *a, **k)

        svc._issue = logged
        return svc

    def strict_issue(svc):
        """Raise on any host sync inside the issue stage (the completion of
        a batch that overflows the ring may wait: it is the complete
        stage)."""
        issue, complete = svc._issue, svc._complete

        def strict(*a, **k):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return issue(*a, **k)
            finally:
                torch.cuda.set_sync_debug_mode(0)

        def lax(batch):
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(0)
            try:
                return complete(batch)
            finally:
                torch.cuda.set_sync_debug_mode(mode)

        svc._issue, svc._complete = strict, lax

    def drive(svc, rows, tenant="default"):
        """Submit ``rows`` one at a time in arrival chunks of SVC_CHUNKS
        (a step after each chunk: with max_wait_ms=0 every step drains
        what is queued, so the chunks become batches of shapes 64, 16, 4
        and 1, and a chunk of 128 two batches issued in one step), then
        flush.  Returns the tickets and the wall seconds."""
        name = next(iter(svc.collections))
        tickets, start, t0 = [], 0, time.perf_counter()
        for size in itertools.cycle(SVC_CHUNKS):
            if start >= len(rows):
                break
            for q in rows[start:start + size]:
                tickets.append(svc.submit(name, q, tenant=tenant))
            svc.step()
            start += size
        svc.flush()
        return tickets, time.perf_counter() - t0

    def check_tickets(svc, tickets, label):
        """Every ticket against the attached collection's ``search`` on its
        own padded batch (shape, rows and engine as logged), bit for bit,
        stats and payload included; returns the shapes issued."""
        by_uid = {t.uid: t for t in tickets}
        shapes = set()
        for uids, shape, engine in svc.batch_log:
            reqs = [by_uid[u] for u in uids if u in by_uid]
            if not reqs or any(r.error is not None for r in reqs):
                continue
            Qpad = np.zeros((shape, D), np.float32)
            Qpad[:len(reqs)] = np.stack([r.query for r in reqs])
            col = next(iter(svc.collections.values()))
            dd, ii, st = col.search(torch.from_numpy(Qpad).to(dev), k=K_NN, r0=R0,
                                    steps=STEPS, engine=engine, with_stats=True,
                                    rows=len(reqs))
            m = len(reqs)
            check(np.array_equal(np.stack([r.dists for r in reqs]), dd[:m].cpu().numpy())
                  and np.array_equal(np.stack([r.ids for r in reqs]), ii[:m].cpu().numpy())
                  and [r.radius_steps for r in reqs] == st["radius_steps"][:m].tolist()
                  and [r.candidates for r in reqs] == st["candidates"][:m].tolist(),
                  f"service ({label}): a batch of shape {shape} differs from "
                  "Collection.search on the same padded batch")
            for r in reqs:
                fin = np.isfinite(r.dists)
                check(np.array_equal(r.payload[fin], r.ids[fin]),
                      f"service ({label}): payload rows out of line with the ids")
            shapes.add(shape)
        return shapes

    def recall_of(tickets):
        return sum(len(set(t.ids[np.isfinite(t.dists)].tolist()) & g)
                   for t, g in zip(tickets, gt1k_sets)) / (len(tickets) * K_NN)

    # results: every engine and depth, against Collection.search; the
    # issue stage under set_sync_debug_mode("error") at depth 2
    runs, svc_numbers = {}, {}
    for engine in ("inline", "kernel"):
        for depth in (0, 2):
            svc = service(engine=engine, inflight_depth=depth, max_wait_ms=0.0,
                          cache_size=2 * N_QUERIES_LARGE)
            if depth:
                strict_issue(svc)
            kernels.reset_launches()
            tickets, wall_s = drive(svc, rows_h)
            torch.cuda.synchronize()
            launched = dict(kernels.launches)
            errors = [t.error for t in tickets if t.error is not None]
            check(not errors, f"service ({engine}, depth {depth}): {len(errors)} tickets "
                  f"failed, the first: {errors[:1]!r}"
                  + (f" (cause {errors[0].__cause__!r})" if errors else ""))
            check(all(t.done and not t.cached for t in tickets),
                  f"service ({engine}, depth {depth}): a ticket is not done, or cached")
            n_batches = len(svc.batch_log)
            check(launched[fused_of[engine]] == launched["select_blocks"]
                  == launched["merge_schedule"] == n_batches
                  and sum(launched.values()) == 3 * n_batches,
                  f"service ({engine}, depth {depth}): launches {launched} for "
                  f"{n_batches} batches")
            shapes = check_tickets(svc, tickets, f"{engine}, depth {depth}")
            check(shapes == set(SVC_SHAPES), f"service ({engine}): shapes {shapes}")
            recall = recall_of(tickets)
            check(recall >= 0.5, f"service ({engine}, depth {depth}): recall@{K_NN} {recall}")
            runs[engine, depth] = (svc, tickets)
            svc_numbers[f"{engine}@depth{depth}"] = {
                "batches": n_batches, "overlap_ratio": svc.stats("svc")["overlap_ratio"],
                "recall": recall, "launches": launched[fused_of[engine]]}
        a, b = runs[engine, 0][1], runs[engine, 2][1]
        check(runs[engine, 0][0].batch_log == runs[engine, 2][0].batch_log
              and all(np.array_equal(x.dists, y.dists) and np.array_equal(x.ids, y.ids)
                      for x, y in zip(a, b)),
              f"service ({engine}): depth 0 and depth 2 differ")
        check(runs[engine, 2][0].stats("svc")["overlap_ratio"] > 0,
              f"service ({engine}): no batch was issued while another was in flight")
    print(f"[service] {N_QUERIES_LARGE} queries one at a time (chunks {SVC_CHUNKS}), "
          f"batch shapes {SVC_SHAPES}: every ticket bit-equal to Collection.search on its "
          f"padded batch (all four shapes), depth 0 == depth 2, one B1/B2, one S1 and one M1 "
          f"launch per batch, no host sync in the issue stage at depth 2 (set_sync_debug_mode): "
          f"{json.dumps(svc_numbers)}", flush=True)

    # QPS and ticket latency: after a warm pass per engine (the first batch
    # of a shape pays one-time costs), depth 0 and 2 in turns, the same
    # passes as above without the checks; each metric's median and readings
    timing = {}
    for engine in ("inline", "kernel"):
        drive(service(engine=engine, max_wait_ms=0.0, cache_size=0), rows_h)
        for depth in SVC_TURNS:
            svc = service(engine=engine, inflight_depth=depth, max_wait_ms=0.0, cache_size=0)
            _, wall_s = drive(svc, rows_h)
            s = svc.stats("svc")
            row = timing.setdefault(f"{engine}@depth{depth}",
                                    {"qps": [], "p50_ms": [], "p99_ms": [], "wall_s": []})
            for key, v in (("qps", s["qps"]), ("p50_ms", s["latency_ms_p50"]),
                           ("p99_ms", s["latency_ms_p99"]), ("wall_s", wall_s)):
                row[key].append(v)
    medians = {name: {key: statistics.median(v) for key, v in row.items()}
               for name, row in timing.items()}
    print(f"[service] {card}: QPS and ticket latency, median of {SVC_TURNS.count(0)} "
          f"passes of {N_QUERIES_LARGE} queries per engine and depth, in turns "
          f"{SVC_TURNS}: {json.dumps(medians)}; readings {json.dumps(timing)}", flush=True)

    # the cache: the same queries again on inline at depth 2, all hits,
    # no launch; then an add (a new version): every one a miss, and equal
    # to a fresh Collection.search of the grown index
    svc, first = runs["inline", 2]
    svc.batch_log = []
    kernels.reset_launches()
    again, hit_s = drive(svc, rows_h)
    torch.cuda.synchronize()
    check(all(t.cached for t in again) and not any(kernels.launches.values())
          and not svc.batch_log,
          f"cache: second pass launched {kernels.launches} or missed")
    check(all(np.array_equal(x.dists, y.dists) and np.array_equal(x.ids, y.ids)
              and np.array_equal(x.payload, y.payload) for x, y in zip(first, again)),
          "cache: a hit differs from the first pass")
    hit_stats = {"hit_rate": svc.cache_stats()["hit_rate"],
                 "service_hit_rate": svc.stats("svc")["cache_hit_rate"],
                 "pass_wall_s": round(hit_s, 4)}
    old_version = svc_col.version
    svc_col.add(extra[:1000], payload=torch.arange(N, N + 1000, device=dev))
    check(svc_col.version != old_version, "add: the version did not change")
    after, _ = drive(svc, rows_h[:256])
    check(not any(t.cached for t in after) and not any(t.error for t in after),
          "cache: a hit after add (stale)")
    check_tickets(svc, after, "after add")
    print(f"[service] {card}: cache: second pass all {N_QUERIES_LARGE} hits, zero launches, "
          f"equal to the first ({json.dumps(hit_stats)}); after add(1000) 256 queries all "
          f"missed and equal Collection.search on the new version", flush=True)

    # tenants: two quotas on a fake clock, rejections against the
    # token-bucket arithmetic done here
    clock = {"t": 0.0}
    svc = service(engine="inline", max_wait_ms=1.0, clock=lambda: clock["t"])
    quotas = {"gold": (300.0, 8.0, 3), "bronze": (100.0, 2.0, 1)}
    for tenant, (rate, burst, weight) in quotas.items():
        svc.set_quota(tenant, rate=rate, burst=burst, weight=weight)
    tokens = {t: max(1.0, q[1]) for t, q in quotas.items()}
    last = {t: 0.0 for t in quotas}
    want_rej, got_rej, admitted = {t: 0 for t in quotas}, {t: 0 for t in quotas}, []
    for j, q in enumerate(rows_h[:512]):
        tenant = "bronze" if j % 4 == 0 else "gold"
        rate, burst, _ = quotas[tenant]
        tokens[tenant] = min(max(1.0, burst), tokens[tenant] + (clock["t"] - last[tenant]) * rate)
        last[tenant] = clock["t"]
        ok = tokens[tenant] >= 1.0
        tokens[tenant] -= 1.0 if ok else 0.0
        want_rej[tenant] += not ok
        try:
            admitted.append(svc.submit("svc", q, tenant=tenant))
        except QuotaExceeded:
            got_rej[tenant] += 1
        clock["t"] += 0.0016 if j % 7 else 0.006
        svc.step()
    svc.flush()
    ts = svc.tenant_stats()
    check(got_rej == want_rej and all(ts[t]["rejected"] == want_rej[t] for t in quotas)
          and all(t.done and t.error is None for t in admitted),
          f"quotas: rejected {got_rej} (stats {ts}), token-bucket arithmetic {want_rej}")
    check_tickets(svc, admitted, "two tenants")

    # faults: one transient dispatch.raise is retried and changes nothing;
    # one non-transient raise fails its batch typed, and the run goes on
    base = service(engine="kernel", cache_size=0).serve("svc", rows_h[:64])
    svc = service(engine="kernel", cache_size=0, sleep=lambda s: None)
    plan = FaultPlan().add("dispatch.raise", count=1, transient=True)
    with faults.active(plan):
        fd, fi, fr = svc.serve("svc", rows_h[:64])
    check(len(plan.fired) == 1 and np.array_equal(fd, base[0]) and np.array_equal(fi, base[1])
          and all(r.error is None for r in fr),
          "faults: a transient dispatch.raise was not retried to the same result")
    svc = service(engine="kernel", cache_size=0)
    doomed = [svc.submit("svc", q) for q in rows_h[:16]]
    with faults.active(FaultPlan().add("dispatch.raise", transient=False)):
        svc.flush()
    check(all(r.done and isinstance(r.error, DispatchFailed) for r in doomed)
          and svc.stats("svc")["failed"] == 16 and svc.in_flight() == 0,
          "faults: a non-transient raise did not fail every ticket of its batch")
    print(f"[service] tenants: rejected {json.dumps(got_rej)} = the token-bucket "
          f"arithmetic; admitted tickets equal Collection.search; a transient "
          f"dispatch.raise retried to the same results; a non-transient one failed "
          f"its 16 tickets with DispatchFailed", flush=True)

    # the ring in the reference's own spans: at depth 2 some batch.issue
    # lies inside the previous batch's batch.pending window; and the
    # card's busy share over one profiled flush at depth 0 and depth 2
    obs = Observability(trace=True)
    try:
        svc = service(engine="inline", inflight_depth=2, max_wait_ms=0.0, cache_size=0,
                      obs=obs)
        drive(svc, rows_h[:512])
        spans = {(s.name, s.args.get("seq")): s for s in obs.tracer.events
                 if s.name in ("batch.issue", "batch.pending")}
    finally:
        obs.tracer.disable()
        obs.tracer.clear()
    inside = []
    for (name, seq), s in spans.items():
        prev = spans.get(("batch.pending", seq - 1))
        if name == "batch.issue" and prev is not None and \
                prev.ts <= s.ts and s.ts + s.dur <= prev.ts + prev.dur:
            inside.append(seq)
    check(inside, "trace: no batch.issue lies inside the previous batch's pending window")
    busy = {}
    for depth in (0, 2):
        svc = service(engine="inline", inflight_depth=depth, max_wait_ms=0.0, cache_size=0)
        drive(svc, rows_h[:256])  # warm: the pinned blocks, the allocator
        svc = service(engine="inline", inflight_depth=depth, max_wait_ms=0.0, cache_size=0)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(8):  # see phase 12: the first records can go missing
                torch.cuda._sleep(1000)
            torch.cuda.synchronize()
            _, flush_s = drive(svc, rows_h[256:512])
            torch.cuda.synchronize()
        dev_ms = sum(e.self_device_time_total for e in prof.events()
                     if e.device_type.name == "CUDA" and e.name not in stages
                     and "spin_kernel" not in e.name) / 1e3
        check(dev_ms > 0, f"profile: no device time in the depth-{depth} flush")
        busy[f"depth{depth}"] = {"device_ms": round(dev_ms, 3),
                                 "wall_ms": round(flush_s * 1e3, 3),
                                 "busy": round(dev_ms / (flush_s * 1e3), 4),
                                 "batches": len(svc.batch_log)}
    print(f"[service] trace: {len(inside)} batch.issue spans inside the previous batch's "
          f"pending window (depth 2); {card}: device busy share over one profiled flush "
          f"of 256 queries (inline) {json.dumps(busy)} ({phase_s():.1f} s)", flush=True)
    del svc_col

    # ------------------------------------------------ 15. the sharded fleet
    fleet_phase(torch, np, kernels, dev, card, service, strict_issue, drive, check_tickets,
                phase_s)

    # ----------------------------------------------- 16. the paper's baselines
    baselines_phase(torch, dev, card, data, Q64, gt_sets, index, kw, phase_s)
    return dict(kernels=kernels, wrappers=wrappers, twins=twins, records=records, card=card,
                dev=dev, t_start=t_start, phase_s=phase_s)


def main() -> int:
    import gc

    # a fixed cuBLAS workspace before torch starts cuBLAS, for the training
    # phase's reproducible products (see repro_torch.train.train_step)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
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

    st = search_phases(torch, np)
    # every tensor of phases 1-16 went with their frames: the card is free
    # for the model
    gc.collect()
    torch.cuda.empty_cache()
    card, records = st["card"], st["records"]
    dev, kernels, wrappers, twins = st["dev"], st["kernels"], st["wrappers"], st["twins"]
    # ------------------------------------------ 17. kNN-LM serving, Yi-9B
    knnlm_phase(torch, np, dev, card, kernels, wrappers, twins, records, st["phase_s"])
    # ------------------------------- 18. kNN-LM serving, Mamba2-1.3B (SSM)
    knnlm_phase(torch, np, dev, card, kernels, wrappers, twins, records, st["phase_s"],
                tag="mamba")
    # --------------------------------- 19. Arctic-480B (MoE), 2 of 35 layers
    arctic = arctic_phase(torch, np, dev, card, kernels, wrappers, twins, records,
                          st["phase_s"])
    # ------------- 24 (a). the mesh: Arctic expert-parallel, on phase 19's weights
    mesh_ep(torch, np, dev, card, arctic, st["phase_s"])
    del arctic
    free_card(torch)
    # ----------------------------------- 20. Hymba-1.5B (hybrid), batch path
    hybrid_phase(torch, np, dev, card, st["phase_s"])
    # ------------------ 21-22. Whisper-medium (encdec) and the VLM, batch path
    for tag in XA_RUNS:
        xattn_phase(torch, np, dev, card, kernels, wrappers, twins, records, st["phase_s"],
                    tag)
    # ------------------------------------ 23. training MiniCPM-2B (AdamW)
    train_phase(torch, np, dev, card, st["phase_s"])
    # ---------------------- 24 (b)-(d). the mesh: GPipe, int8 pods, the dry run
    mesh_phase(torch, np, dev, card, st["phase_s"])
    print(f"[mesh] the whole run took {time.perf_counter() - st['t_start']:.1f} s", flush=True)

    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
