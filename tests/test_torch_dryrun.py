"""``launch.step_stats`` and ``launch.dryrun``: the counterpart of
tests/test_hlo_stats.py.

The reference validates its HLO walk against analytic FLOP counts; the
port's counts come from ``FlopCounterMode`` over ``device="meta"``
tensors and meet the same counts: a plain matmul, a loop of L layers
(the HLO walk's scan trip count), nested loops, and a smoke train step
with its recompute against the model's analytic count.  Per-device bytes
are exact from the spec trees; the dry run writes its cells under its
results directory only and skips ``long_500k`` for full-attention
archs.
"""

import json
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
R = pytest.importorskip("_torch_parity")

from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.core.distributed import make_mesh  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.launch.step_stats import (analyze, count_flops, per_device_bytes,  # noqa: E402
                                            wire_bytes)
from repro_torch.launch.steps import build_step  # noqa: E402
from repro_torch.models.registry import build_model, stacked_leaves  # noqa: E402
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.sharding.rules import P, NamedSharding  # noqa: E402

META = "meta"


def _meta(*shape):
    return torch.empty(shape, device=META)


def test_plain_matmul_flops():
    _, flops = count_flops(lambda a, b: a @ b, _meta(128, 256), _meta(256, 64))
    assert flops == 2 * 128 * 256 * 64


def test_loop_trip_count_multiplies():
    L, D = 7, 64

    def f(w, x):
        for wl in w:
            x = torch.tanh(x @ wl)
        return x.sum()

    _, flops = count_flops(f, _meta(L, D, D), _meta(32, D))
    assert flops == 2 * 32 * D * D * L


def test_nested_loop():
    Lo, Li, D = 3, 5, 32

    def f(w, x):
        for wo in w:
            for _ in range(Li):
                x = torch.tanh(x @ wo)
        return x.sum()

    _, flops = count_flops(f, _meta(Lo, D, D), _meta(8, D))
    assert flops == 2 * 8 * D * D * Lo * Li


def _layer_flops(cfg, B, T):
    """The forward matmul FLOPs of one dense layer: projections, scores
    and values over the full (masked) T x T, SwiGLU."""
    D, H, KV, hd, F = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_ff
    N = B * T
    proj = 2 * N * D * (H + 2 * KV) * hd + 2 * N * H * hd * D
    attn = 2 * 2 * B * H * T * T * hd
    return proj + attn + 3 * 2 * N * D * F


def test_smoke_train_step_counts_the_recompute():
    """A train step: forward, each layer's recompute and the backward
    (twice the forward) — 4x a layer's forward — plus 3x the head's."""
    cfg = get_config("yi-9b").smoke().scaled(n_layers=3)
    model = build_model(cfg)
    B, T = 4, 64
    mesh = make_mesh((2, 2), ("data", "model"), devices=[META] * 4)
    shape = SHAPES["train_4k"]
    fn, args, in_sh, out_sh, donate = build_step(model, shape, mesh, batch_override=B)
    args[1]["tokens"], args[1]["labels"] = (torch.empty((B, T), dtype=torch.int32, device=META)
                                            for _ in range(2))
    st = analyze(fn, args, in_sh, out_sh, donate)
    head = 2 * B * T * cfg.d_model * cfg.padded_vocab
    want = 4 * cfg.n_layers * _layer_flops(cfg, B, T) + 3 * head
    assert abs(st.flops - want) / want < 0.10, (st.flops, want)
    assert st.collective_bytes == 0 and st.alias_bytes > 0


def test_per_device_bytes_exact_from_specs():
    mesh = make_mesh((2, 4), ("data", "model"), devices=[META] * 8)
    tree = {"a": torch.empty((8, 16), device=META), "b": torch.empty((6,), dtype=torch.bfloat16,
                                                                      device=META),
            "c": [torch.empty((4, 3, 8), device=META)]}
    sh = {"a": NamedSharding(mesh, P(("data", "model"), None)),
          "b": NamedSharding(mesh, P("data")),
          "c": [NamedSharding(mesh, P(None, None, "model"))]}
    assert per_device_bytes(tree, sh) == 8 * 16 * 4 // 8 + 6 * 2 // 2 + 4 * 3 * 8 * 4 // 4
    assert per_device_bytes(tree, None) == 8 * 16 * 4 + 12 + 4 * 3 * 8 * 4
    # the spec trees of a step: every parameter's bytes over its shards
    cfg = get_config("yi-9b").smoke()
    model = build_model(cfg)
    fn, args, in_sh, out_sh, donate = build_step(model, SHAPES["decode_32k"], mesh,
                                                 batch_override=8)
    specs = rules.param_specs(args[0], mesh)
    want = 0
    for leaf in stacked_leaves(args[0]):
        factor = math.prod(rules.shard_factor(mesh, ax) for ax in specs[leaf.path])
        want += math.prod(leaf.shape) * leaf.params[0].element_size() // factor
    assert per_device_bytes(args[0], in_sh[0]) == want


def test_compressed_pod_exchange_bytes():
    """The pod exchange moves int8 codes and a float32 scale a block of
    256: 8.125 / 32 of the float32 gradients, every leaf rounded up to
    whole blocks."""
    cfg = get_config("yi-9b").smoke()
    model = build_model(cfg)
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), devices=[META] * 8)
    fn, args, in_sh, out_sh, donate = build_step(model, SHAPES["train_4k"], mesh,
                                                 compress_pods=True, batch_override=4)
    args[1]["tokens"], args[1]["labels"] = (torch.empty((4, 32), dtype=torch.int32, device=META)
                                            for _ in range(2))
    st = analyze(fn, args, in_sh, out_sh, donate,
                 wire=wire_bytes(cfg, mesh, "train", args))
    sizes = [math.prod(leaf.shape) for leaf in stacked_leaves(args[0]["params"])]
    blocks = sum(-(-n // 256) for n in sizes)
    assert st.collective_breakdown == {"pod_int8": 2 * blocks * (256 + 4),
                                       "pod_fp32": 2 * 4 * sum(sizes)}
    ratio = st.collective_bytes / st.collective_breakdown["pod_fp32"]
    assert 8.125 / 32 <= ratio < 8.125 / 32 * 1.02
    assert len(args[0]["err"]) == 2


def test_dryrun_cells(tmp_path):
    """The CLI writes one JSON a cell under its results directory, skips
    long_500k for full-attention archs, runs it for the SSM family, and
    reads a finished cell back from the cache."""
    res = dryrun.main(["--arch", "yi-9b", "--shape", "long_500k", "--out", str(tmp_path)])
    assert res[0]["status"] == "skipped" and "full-attention" in res[0]["reason"]
    res = dryrun.main(["--arch", "mamba2-1.3b", "--shape", "long_500k", "--multi-pod",
                       "--out", str(tmp_path)])
    cell = res[0]
    assert cell["status"] == "ok" and cell["mesh"] == "2x16x16", cell.get("error")
    assert cell["memory"]["per_device_total"] > 0 and cell["step_stats"]["flops"] > 0
    path = tmp_path / "pod2x16x16" / "mamba2-1.3b__long_500k.json"
    assert json.loads(path.read_text()) == cell
    assert dryrun.run_cell("mamba2-1.3b", "long_500k", True, out_dir=tmp_path) == cell
    assert sorted(p.relative_to(tmp_path).as_posix() for p in tmp_path.rglob("*.json")) == [
        "pod16x16/yi-9b__long_500k.json", "pod2x16x16/mamba2-1.3b__long_500k.json"]
    # by default the cells go under build/ at the repository's root
    assert dryrun.RESULTS_DIR.parts[-2:] == ("build", "dryrun_torch")
    assert dryrun.RESULTS_DIR.parent.parent == Path(__file__).resolve().parents[1]


def test_production_mesh_cell_allocates_nothing():
    """A full-size cell on the meta device: the production mesh's 256
    entries, Yi-9B's 8.8 B parameters, no storage."""
    mesh = make_production_mesh(device=META)
    model = build_model(get_config("yi-9b"))
    fn, args, in_sh, out_sh, donate = build_step(model, SHAPES["decode_32k"], mesh)
    params = args[0]
    assert all(p.device.type == META for p in params.parameters())
    assert sum(p.numel() for p in params.parameters()) > 8e9
    st = analyze(fn, args, in_sh, out_sh, donate)
    assert st.flops > 0 and st.per_device_total < 4 * 2 ** 30


@pytest.mark.parametrize("phase", ["train_4k", "prefill_32k"])
def test_expert_parallel_partial_bytes(phase, monkeypatch):
    """An MoE step on a 'model' axis of 2: ``wire_bytes`` counts each MoE
    layer's partial sums (tp of them, (rows, D) in the compute dtype) once
    a forward pass, as the step's calls of the EP path hand them over; a
    train step runs the forward, the recompute and the backward."""
    from repro_torch.models import ffn

    cfg = get_config("arctic-480b").smoke()
    model = build_model(cfg)
    mesh = make_mesh((2, 2), ("data", "model"), devices=[META] * 4)
    B, T = 16, 32
    fn, args, in_sh, out_sh, donate = build_step(model, SHAPES[phase], mesh, batch_override=B)
    args[1]["tokens"] = torch.empty((B, T), dtype=torch.int32, device=META)
    if "labels" in args[1]:
        args[1]["labels"] = torch.empty((B, T), dtype=torch.int32, device=META)
    handed = []
    moe = ffn._moe

    def counted(xf, *a, tp=1, **k):
        out = moe(xf, *a, tp=tp, **k)
        handed.append(tp * out.numel() * out.element_size())
        return out

    monkeypatch.setattr(ffn, "_moe", counted)
    wire = wire_bytes(cfg, mesh, SHAPES[phase].phase, args)
    st = analyze(fn, args, in_sh, out_sh, donate, wire=wire)
    train = phase == "train_4k"
    passes = 3 if train else 1
    # the forward (and the recompute) of every layer, a microbatch at a time
    assert len(handed) == cfg.n_layers * (2 * cfg.accum_steps if train else 1)
    assert wire["ep_psum"] == sum(handed) * passes // (2 if train else 1)
    assert st.collective_bytes == wire["ep_psum"] == (passes * cfg.n_layers * 2 * B * T
                                                      * cfg.d_model * 4)  # float32
