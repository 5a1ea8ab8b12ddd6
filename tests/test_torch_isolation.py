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
from repro_torch.store import Collection, restore_collection  # noqa: E402
from repro_torch.core.serve_search import _gather_pool  # noqa: E402
from repro_torch.kernels import launches, mode_launches, pairwise_l2, reset_launches  # noqa: E402

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
                             "candidate_dist", "pairwise_l2"}
    assert not any(launches.values()), launches
    assert not any(c for counts in mode_launches.values() for c in counts.values())
