"""The port stands alone: no JAX, no ``repro``, no silent CPU fallback."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import repro_torch  # noqa: E402
from repro_torch.core import (  # noqa: E402
    DBLSHParams,
    brute_force,
    build,
    search_batch_fixed,
    search_batch_fixed_dispatch,
    search_batch_fixed_ref,
)
from repro_torch.data import make_clustered, make_uniform  # noqa: E402
from repro_torch.core.distributed import build_sharded, make_mesh  # noqa: E402
from repro_torch.store import (  # noqa: E402
    Collection,
    ShardedCollection,
    StoreService,
    open_collection,
    restore_collection,
)
from repro_torch.core.serve_search import _gather_pool  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import C2Index, FBLSH, MQIndex  # noqa: E402
from repro_torch.data.pipeline import SyntheticTokens, make_batch_fn  # noqa: E402
from repro_torch.models.registry import build_model  # noqa: E402
from repro_torch.serve import ServeEngine, build_datastore  # noqa: E402
from repro_torch.kernels import launches, mode_launches, pairwise_l2, reset_launches  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.models.registry import train_state_from_reference  # noqa: E402
from repro_torch.train import init_train_state, make_optimizer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

_ISOLATED = """
import sys
sys.modules["jax"] = None
sys.modules["jaxlib"] = None
sys.modules["repro"] = None
import torch
import repro_torch, repro_torch.core, repro_torch.data, repro_torch.kernels
import repro_torch.checkpoint, repro_torch.resilience, repro_torch.tune
import repro_torch.obs, repro_torch.store
from repro_torch.core import (DBLSHParams, Termination, brute_force, build, search_batch,
                              search_batch_fixed, search_batch_fixed_ref)
from repro_torch.data import make_clustered, normalize_scale
from repro_torch.kernels import launches
gen = torch.Generator().manual_seed(0)
pts = make_clustered(gen, 560, 8, n_clusters=4, spread=0.05, device="cpu")
data, queries, _ = normalize_scale(pts[:512], pts[512:])
params = DBLSHParams.derive(n=512, d=8, k=5, K=4, L=2, block_size=16,
                            inline_vectors=True)
index = build(data, params, generator=gen, device="cpu")
_, gt = brute_force(data, queries, k=5, device="cpu")
for engine in ("torch", "kernel", "inline"):
    d, i = search_batch_fixed(index, queries, k=5, r0=0.5, steps=4,
                              engine=engine, device="cpu")
    assert d.shape == (48, 5) and torch.isfinite(d[:, 0]).all()
    d, i = search_batch_fixed_ref(index, queries, k=5, r0=0.5, steps=4,
                                  engine=engine, device="cpu")
    assert d.shape == (48, 5) and torch.isfinite(d[:, 0]).all()
    search_batch_fixed(index, queries, k=5, r0=0.5, steps=4, engine=engine,
                       termination=Termination(), with_explain=True, device="cpu")
d, i = search_batch(index, queries, k=5, r0=0.5)
assert d.shape == (48, 5) and torch.isfinite(d[:, 0]).all()
import tempfile
from repro_torch.store import Collection, restore_collection
from repro_torch.tune import RecallTarget
col = Collection.create("iso", gen, data, params=params, engine="inline", device="cpu")
col.calibrate(queries[:16], k=5, steps_max=3, retain=True)
plan = col.plan(RecallTarget(0.5))
col.search(queries, k=5, r0=plan.r0, steps=plan.steps, termination=plan.termination)
col.remove(col.add(queries[:4])[:2])
with tempfile.TemporaryDirectory() as tmp:
    col.snapshot(tmp)
    back = restore_collection(tmp, device="cpu")
assert torch.equal(back.search(queries, k=5)[1], col.search(queries, k=5)[1])
col.compact()
from repro_torch.store import QueryResultCache, StoreService
from repro_torch.store.cache import CachedResult
from repro_torch.store.service import QuotaExceeded
svc = StoreService(batch_shapes=(1, 4), default_k=5, r0=0.5, steps=4)
svc.attach(col)
d, i, tickets = svc.serve("iso", queries[:5].numpy())
assert d.shape == (5, 5) and not any(t.cached for t in tickets)
assert all(t.cached for t in svc.serve("iso", queries[:5].numpy())[2])
assert isinstance(svc.cache, QueryResultCache)
from repro_torch.core.distributed import make_mesh
from repro_torch.store import ShardedCollection, open_collection
fleet = open_collection("iso2", gen, data, max_points_per_shard=100,
                        mesh=make_mesh(2, devices=["cpu"] * 2), k=5, K=4, L=2,
                        block_size=16, inline_vectors=True)
assert isinstance(fleet, ShardedCollection)
fleet.remove(fleet.add(queries[:4])[:2])
with tempfile.TemporaryDirectory() as tmp:
    fleet.snapshot(tmp)
    back = restore_collection(tmp, mesh=make_mesh(2, devices=["cpu"] * 2))
assert torch.equal(back.search(queries, k=5)[1], fleet.search(queries, k=5)[1])
svc.attach(fleet)
assert svc.serve("iso2", queries[:5].numpy())[2][0].engine == "torch"
from repro_torch.core import C2Index, FBLSH, MQIndex
for idx in (FBLSH.build(gen, data, K=4, L=2, w0=4.0, c=1.5, t=8, device="cpu"),
            MQIndex.build(gen, data, device="cpu"), C2Index.build(gen, data, device="cpu")):
    d, i = idx.search_batch(queries, k=5)
    assert d.shape == i.shape == (48, 5)
import numpy as np
import repro_torch.configs, repro_torch.models, repro_torch.serve, repro_torch.launch
from repro_torch.configs import get_config
from repro_torch.data.pipeline import SyntheticTokens, make_batch_fn
from repro_torch.models.registry import build_model
from repro_torch.serve import Request, RetrievalLM, ServeEngine, build_datastore
from repro_torch.launch.serve import main as serve_main
cfg = get_config("yi-9b").smoke().scaled(n_layers=1)
model = build_model(cfg)
lm = model.init(gen, device="cpu")
batches = [make_batch_fn(SyntheticTokens(cfg.vocab_size, 16, 2))(s) for s in range(2)]
ds = build_datastore(model, lm, batches, gen, t=16, k=4, block_size=32, device="cpu")
eng = ServeEngine(model, lm, slots=2, cache_len=32, device="cpu",
                  retrieval=RetrievalLM(model, ds, r0=0.5, steps=4))
reqs = [Request(uid=i, prompt=np.arange(3, dtype=np.int32), max_new_tokens=3) for i in range(3)]
for r in reqs:
    eng.submit(r)
eng.run()
assert all(r.done and len(r.output) == 3 for r in reqs)
for arch, extra in (("whisper-medium", "frames"), ("llama-3.2-vision-11b", "images")):
    cfg = get_config(arch).smoke()
    model = build_model(cfg)
    lm = model.init(gen, device="cpu")
    shape = (cfg.enc_seq, cfg.d_model) if extra == "frames" else (cfg.n_img_tokens, cfg.d_vision)
    batches = [make_batch_fn(SyntheticTokens(cfg.vocab_size, 16, 2), {extra: shape})(0)]
    ds = build_datastore(model, lm, batches, gen, t=16, k=4, block_size=32, device="cpu")
    b = batches[0]
    _, _, caches = model.prefill(lm, {"tokens": b["tokens"][:, :8], extra: b[extra]},
                                 cache_len=12)
    logp, _, _ = RetrievalLM(model, ds, r0=0.5, steps=4).decode(
        lm, torch.as_tensor(b["tokens"][:, 8]), caches, 8)
    assert logp.shape == (2, cfg.padded_vocab) and torch.isfinite(logp).all()
import repro_torch.train, repro_torch.runtime
from repro_torch.launch.train import main as train_main
from repro_torch.runtime import TrainSupervisor
from repro_torch.train import init_train_state, make_optimizer, make_train_step
cfg = get_config("minicpm-2b").smoke().scaled(n_layers=1)
model = build_model(cfg)
opt = make_optimizer("adafactor")
state = init_train_state(model, opt, gen, device="cpu")
with tempfile.TemporaryDirectory() as tmp:
    state = TrainSupervisor(tmp, ckpt_every=1).run(
        state, make_train_step(model, opt, accum_steps=2),
        make_batch_fn(SyntheticTokens(cfg.vocab_size, 8, 2)), 2)
    assert int(state["step"]) == 2
    losses = train_main(["--arch", "minicpm-2b", "--device", "cpu", "--steps", "2",
                         "--batch", "2", "--seq", "8", "--ckpt", tmp + "/launch"])
    assert len(losses) == 2
import repro_torch.sharding.pp, repro_torch.train.grad_compression
from repro_torch.configs import SHAPES
from repro_torch.launch.dryrun import run_cell
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.step_stats import analyze, wire_bytes
from repro_torch.launch.steps import build_step
mesh = make_production_mesh(multi_pod=True, device="meta")
cfg = get_config("yi-9b").smoke()
fn, args, in_sh, out_sh, donate = build_step(build_model(cfg), SHAPES["train_4k"], mesh,
                                             compress_pods=True, batch_override=64)
assert analyze(fn, args, in_sh, out_sh, donate, wire=wire_bytes(
    cfg, mesh, "train", args)).collective_breakdown["pod_int8"] > 0
with tempfile.TemporaryDirectory() as tmp:
    assert run_cell("yi-9b", "long_500k", False, out_dir=tmp)["status"] == "skipped"
assert not any(launches.values()), launches
assert not any(m == "jax" or m.startswith(("jax.", "repro."))
               for m, v in sys.modules.items() if v is not None)
print("ISOLATED-OK")
"""


def test_port_runs_without_jax_or_reference():
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    proc = subprocess.run([sys.executable, "-c", _ISOLATED], capture_output=True,
                          text=True, env=env, timeout=300, check=False)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "ISOLATED-OK" in proc.stdout


def test_sources_import_neither_jax_nor_reference():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_entry_points_need_a_device_without_cuda(tmp_path):
    """With no CUDA device, leaving ``device`` out raises instead of
    quietly running on the CPU (a restore raises before it reads the
    snapshot)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    gen = torch.Generator().manual_seed(0)
    data = torch.randn(64, 4, generator=gen)
    params = DBLSHParams.derive(n=64, d=4, k=2, K=2, L=1, block_size=8)
    index = build(data, params, generator=gen, device="cpu")
    Collection.from_index("c", index).snapshot(str(tmp_path))
    model = build_model(get_config("yi-9b").smoke().scaled(n_layers=1))
    lm = model.init(gen, device="cpu")
    batches = [make_batch_fn(SyntheticTokens(model.cfg.vocab_size, 8, 2))(0)]
    calls = (
        lambda: repro_torch.resolve_device(),
        lambda: make_clustered(gen, 16, 4),
        lambda: build(data, params, generator=gen),
        lambda: brute_force(data, data[:2], k=2),
        lambda: search_batch_fixed(index, data[:2], k=2),
        lambda: search_batch_fixed_ref(index, data[:2], k=2),
        lambda: search_batch_fixed_dispatch(index, data[:2], k=2),
        lambda: make_uniform(gen, 4, 2),
        lambda: Collection.create("c", gen, data, params=params),
        lambda: Collection.restore(str(tmp_path)),
        lambda: restore_collection(str(tmp_path)),
        lambda: StoreService().create_collection("c", gen, data, params=params),
        lambda: make_mesh(2),
        lambda: build_sharded(gen, data, params, make_mesh(2)),
        lambda: ShardedCollection.create("c", gen, data, make_mesh(2), params=params),
        lambda: open_collection("c", gen, data, params=params),
        lambda: open_collection("c", gen, data, params=params, mesh=None,
                                max_points_per_shard=8),
        lambda: FBLSH.build(gen, data, K=2, L=1, w0=4.0, c=1.5),
        lambda: MQIndex.build(gen, data),
        lambda: C2Index.build(gen, data),
        lambda: model.init(gen),
        lambda: model.init_cache(1, 8),
        lambda: build_datastore(model, lm, batches, gen),
        lambda: ServeEngine(model, lm),
        lambda: init_train_state(model, make_optimizer("adamw"), gen),
        lambda: train_state_from_reference({"params": {}, "opt": {}, "step": 0}, model.cfg),
        lambda: train_main(["--arch", "minicpm-2b", "--steps", "1"]),
    )
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_cpu_tensors_never_launch_kernels():
    gen = torch.Generator().manual_seed(1)
    data = torch.randn(256, 8, generator=gen)
    params = DBLSHParams.derive(n=256, d=8, k=4, K=3, L=2, block_size=16,
                                inline_vectors=True, quant_dtype="int8")
    index = build(data, params, generator=gen, device="cpu")
    reset_launches()
    for engine in ("kernel", "inline"):
        search_batch_fixed(index, data[:5], k=4, engine=engine, device="cpu")
        search_batch_fixed(index, data[:5], k=4, engine=engine, dtype="int8", device="cpu")
        search_batch_fixed_ref(index, data[:5], k=4, engine=engine, device="cpu")
    # the pool engines' kernels B4/B5 and the distance matrix B8
    p = index.params
    G = torch.einsum("lkd,qd->qlk", index.proj_vecs, data[:5]).contiguous()
    blk_q = torch.arange(5 * p.L * p.max_blocks, dtype=torch.int32).reshape(5, -1)
    blk_q = blk_q % (p.L * index.nb + 1)
    for engine in ("kernel", "inline"):
        _gather_pool(index, blk_q, G, data[:5], engine, False)
    pairwise_l2(data[:5], data)
    assert set(launches) == {"fused_window_search", "fused_cand_search",
                             "window_verify", "candidate_verify", "window_dist",
                             "candidate_dist", "pairwise_l2", "select_blocks",
                             "merge_schedule"}
    assert not any(launches.values()), launches
    assert not any(c for counts in mode_launches.values() for c in counts.values())
