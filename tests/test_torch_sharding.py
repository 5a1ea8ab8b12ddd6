"""``sharding.rules``, ``sharding.pp``, the named-axis mesh, expert
parallelism and ``launch.steps`` against the reference.

The rules' spec trees equal the reference's spec for spec, for every
config and shape on the (16, 16) and (2, 16, 16) production meshes (the
reference's rules read only the mesh's axis sizes and names, so a
stand-in serves on its side, applied to ``jax.eval_shape`` trees; the
port's to ``device="meta"`` ones).  Expert parallelism and the pipeline
are held against the reference's own parity setups
(tests/test_distributed.py's SCRIPT_MOE_PARITY and SCRIPT_PP_PARITY) run
on 8 forced host devices in a subprocess (``_torch_parity.mesh_reference``),
at their tolerances; ``build_step``'s spec trees against the reference's
on the same (data 2, model 4) mesh.
"""

import itertools
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
R = pytest.importorskip("_torch_parity")

from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import CONFIGS, SHAPES, get_config  # noqa: E402
from repro_torch.core.distributed import Mesh, make_mesh  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh  # noqa: E402
from repro_torch.launch.steps import build_step  # noqa: E402
from repro_torch.models import ffn  # noqa: E402
from repro_torch.models.registry import build_model, params_from_reference  # noqa: E402
from repro_torch.sharding import pp, rules  # noqa: E402
from repro_torch.sharding.rules import P, NamedSharding  # noqa: E402
from repro_torch.train import grad_compression as gc  # noqa: E402
from repro_torch.train import init_train_state, make_optimizer  # noqa: E402

CPU = "cpu"
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
EP_MESH = ((2, 4), ("data", "model"))
PP_MESH = ((2, 2, 2), ("pod", "data", "model"))
EP_LOSS_RTOL = 1e-5  # the port's EP loss against the reference's EP loss
MOE_ATOL = 1e-5  # x max |out|: the EP FFN against the reference's
GATE_RTOL = 5e-2  # the reference's own gate: EP loss against the one-device loss
PP_LOSS_RTOL = 2e-3  # the reference's: pp_loss_fn against model.loss
PP_GRAD = dict(rtol=5e-2, atol=1e-4)  # the reference's, on the embedding's gradient


def _flat(tree) -> dict:
    return {k: tuple(v) for k, v in rules._flat(tree).items()}


# ---------------------------------------------------------------------------
# the rules, spec for spec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,mesh_name", list(itertools.product(sorted(CONFIGS), MESHES)))
def test_specs_match_reference(arch, mesh_name):
    shape, names = MESHES[mesh_name]
    want = R.ref_specs(arch, shape, names)
    mesh = make_production_mesh(multi_pod=len(shape) == 3, device="meta")
    assert mesh.shape == dict(zip(names, shape))
    model = build_model(get_config(arch))
    params = model.init(torch.Generator(), device="meta")
    for fsdp in (True, False):
        got = _flat(rules.param_specs(params, mesh, fsdp=fsdp))
        assert got == want[f"params/fsdp={fsdp}"], fsdp
    pods = mesh.shape.get("pod", 1)
    for name in ("adamw", "adafactor"):
        opt = make_optimizer(name)
        state = init_train_state(model, opt, torch.Generator(), device="meta")
        state["err"] = gc.init_error_state(state["params"], pods)
        got = _flat(rules.state_specs(state, rules.param_specs(state["params"], mesh), mesh))
        ref = want[f"state/{name}"]
        # one residual tree a pod, each with the reference's one tree's specs
        for pod in range(pods):
            mine = {k.replace(f"err/{pod}/", "err/", 1): v for k, v in got.items()
                    if k.startswith(f"err/{pod}/")}
            assert mine == {k: v for k, v in ref.items() if k.startswith("err/")}, (name, pod)
        rest = {k: v for k, v in got.items() if not k.startswith("err/")}
        assert rest == {k: v for k, v in ref.items() if not k.startswith("err/")}, name
        assert len(rest) > 10
    for sname, s in SHAPES.items():
        spec = model.input_specs(s)
        got = _flat(rules.cache_specs(spec["caches"], mesh) if s.phase == "decode"
                    else rules.batch_specs(spec["batch"], mesh))
        assert got == want[f"inputs/{sname}"], sname


def test_spec_type_and_guards():
    assert P(("data",), None) == ("data", None) and P() == () and P(None) != P()
    mesh = make_mesh((2, 4), ("data", "model"), devices=[CPU] * 8)
    assert rules.dp_axes(mesh) == "data"
    assert rules.dp_axes(make_mesh((2, 1, 4), ("pod", "data", "model"),
                                   devices=[CPU] * 8)) == ("pod", "data")
    # a batch of 1 is not split over 2 data shards
    assert rules.batch_specs({"tokens": torch.empty(1, 8, device="meta")}, mesh) == \
        {"tokens": P(None, None)}
    assert rules.named(mesh, {"a": P("data")}) == {"a": NamedSharding(mesh, P("data"))}


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


def test_mesh_named_axes():
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"), devices=[CPU] * 7 + ["meta"])
    assert mesh.axis_names == ("pod", "data", "model") and list(mesh.shape) == ["pod", "data",
                                                                                 "model"]
    assert mesh.shape == {"pod": 2, "data": 2, "model": 2} and mesh.size == 8
    assert mesh.device_at(pod=1, data=1, model=1).type == "meta"
    assert mesh.device_at().type == "cpu" and mesh.merge_device.type == "cpu"
    with pytest.raises(IndexError):
        mesh.device_at(pod=2)
    with pytest.raises(KeyError):
        mesh.device_at(stage=0)
    with pytest.raises(ValueError, match="needs 8 devices"):
        Mesh((CPU,) * 4, ("data", "model"), (2, 4))
    one = Mesh([CPU] * 3, "data")  # the fleet's one-axis mesh, unchanged
    assert one.shape == {"data": 3} and one.axis_names == ("data",) and one.axis == "data"


def test_launch_meshes():
    assert make_production_mesh(device="meta").shape == {"data": 16, "model": 16}
    mp = make_production_mesh(multi_pod=True, device="meta")
    assert mp.shape == {"pod": 2, "data": 16, "model": 16} and mp.size == 512
    assert make_local_mesh(device=CPU).shape == {"data": 1, "model": 1}
    assert make_local_mesh(multi_pod=True, device=CPU).axis_names == ("pod", "data", "model")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            make_production_mesh()
        with pytest.raises(RuntimeError, match="CUDA"):
            make_local_mesh()


# ---------------------------------------------------------------------------
# expert parallelism against the reference's SCRIPT_MOE_PARITY setup
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_ep(tmp_path_factory):
    return R.mesh_reference(tmp_path_factory.mktemp("ep"), "ep")


def _nest(r: dict, prefix: str) -> dict:
    out: dict = {}
    for k, v in r.items():
        if k.startswith(prefix):
            node, parts = out, k[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
    return out


def _ep_setup(r):
    cfg = get_config("arctic-480b").smoke().scaled(n_layers=2)
    tree = _nest(r, "params/")
    params = params_from_reference(tree, cfg, device=CPU)
    batch = {k: torch.from_numpy(v) for k, v in _nest(r, "batch/").items()}
    moe = {n: torch.from_numpy(np.ascontiguousarray(v[0])) for n, v in
           tree["blocks"]["moe"].items()}
    return cfg, build_model(cfg), params, batch, moe


def test_ep_loss_matches_reference(ref_ep):
    cfg, model, params, batch, _ = _ep_setup(ref_ep)
    mesh = make_mesh(*EP_MESH, devices=[CPU] * 8)
    with torch.no_grad():
        one = float(model.loss(params, batch)[0])
        ep = float(model.loss(params, batch, mesh)[0])
    assert one == pytest.approx(float(ref_ep["loss_1dev"]), rel=EP_LOSS_RTOL)
    assert ep == pytest.approx(float(ref_ep["loss_ep"]), rel=EP_LOSS_RTOL)
    assert ep != one  # the per-shard capacity drops other assignments
    np.testing.assert_allclose(one, ep, rtol=GATE_RTOL)


def _kept_from_output(out, x, ids, w, moe):
    """Which of each token's k assignments an MoE output holds: the subset
    of the k weighted expert outputs (computed here in float32) whose sum
    is nearest ``out``; the nearest must be unambiguous."""
    k = ids.shape[1]
    contrib = []
    for j in range(k):
        e = ids[:, j]
        up = torch.einsum("td,tdf->tf", x, moe["w_up"][e].float())
        gate = torch.einsum("td,tdf->tf", x, moe["w_gate"][e].float())
        h = torch.nn.functional.silu(gate) * up
        contrib.append(w[:, j:j + 1] * torch.einsum("tf,tfd->td", h, moe["w_down"][e].float()))
    subsets = list(itertools.product((False, True), repeat=k))
    errs = torch.stack([(sum((c for c, on in zip(contrib, sub) if on), torch.zeros_like(out))
                         - out).abs().amax(-1) for sub in subsets], -1)
    best = errs.argmin(-1)
    two = torch.topk(errs, 2, largest=False).values
    scale = float(out.abs().max())
    assert float(two[:, 0].max()) <= 1e-4 * scale and float(two[:, 1].min()) > 1e-2 * scale
    return torch.tensor(subsets)[best]  # (T, k)


@pytest.mark.parametrize("low", [False, True])
def test_ep_moe_ffn_matches_reference_and_keeps_its_assignments(ref_ep, low):
    cfg, _, _, _, moe = _ep_setup(ref_ep)
    if low:
        cfg = cfg.scaled(moe_capacity_factor=R.MOE_LOW_FACTOR)
    want = ref_ep["moe_ep_low" if low else "moe_ep"]
    x = torch.from_numpy(ref_ep["x"])
    mesh = make_mesh(*EP_MESH, devices=[CPU] * 8)
    with torch.no_grad():
        out, aux = ffn.moe_ffn(x, moe, cfg, mesh=mesh, dp_axes=("data",))
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=MOE_ATOL * scale)
    assert float(aux["load_balance"]) == pytest.approx(float(ref_ep["moe_lb"]), rel=1e-6)
    # the kept assignments: the reference's (read off its output) are the
    # port's, data shard by data shard and rank by rank
    E, k, dp, tp = cfg.n_experts, cfg.experts_per_token, 2, 4
    xf = x.reshape(-1, cfg.d_model)
    w, ids = ffn._top_k(torch.softmax(xf @ moe["router"], -1), k)
    w = w / w.sum(-1, keepdim=True)
    ref_kept = _kept_from_output(torch.from_numpy(want).reshape(-1, cfg.d_model), xf, ids, w,
                                 moe)
    rows = xf.shape[0] // dp
    cap = max(4, math.ceil(rows * k / E * cfg.moe_capacity_factor))
    kept = torch.zeros(xf.shape[0] * k, dtype=torch.bool)
    for d in range(dp):
        for r in range(tp):
            keep, _, flat = ffn._dispatch(ids[d * rows:(d + 1) * rows], capacity=cap,
                                          n_local=E // tp, first_eid=r * (E // tp))
            kept[d * rows * k + flat[keep]] = True
    assert torch.equal(kept.reshape(-1, k), ref_kept)
    assert int((~kept).sum()) >= (20 if low else 1)


# ---------------------------------------------------------------------------
# the pipeline against the reference's SCRIPT_PP_PARITY setup
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_pp(tmp_path_factory):
    return R.mesh_reference(tmp_path_factory.mktemp("pp"), "pp")


def test_pp_loss_and_grad_match_reference(ref_pp, monkeypatch):
    cfg = get_config("yi-9b").smoke().scaled(n_layers=4)
    params = params_from_reference(_nest(ref_pp, "params/"), cfg, device=CPU)
    params.requires_grad_(True)
    batch = {k: torch.from_numpy(v) for k, v in _nest(ref_pp, "batch/").items()}
    mesh = make_mesh(*PP_MESH, devices=[CPU] * 8)
    moved = []  # the bytes of every hand-off to the next stage, and of its gradient back
    handoff = pp._handoff

    def counted(y, device):
        moved.append(y.numel() * y.element_size())
        out = handoff(y, device)
        out.register_hook(lambda g: moved.append(g.numel() * g.element_size()))
        return out

    monkeypatch.setattr(pp, "_handoff", counted)
    loss = pp.pp_loss_fn(params, batch, cfg, mesh, microbatches=4)
    loss.backward()
    monkeypatch.undo()
    got = float(loss.detach())
    assert got == pytest.approx(float(ref_pp["loss_pp"]), rel=1e-6)
    np.testing.assert_allclose(got, float(ref_pp["loss"]), rtol=PP_LOSS_RTOL)
    g = params.embed.grad.numpy()
    np.testing.assert_allclose(g, ref_pp["grad_embed_pp"], **PP_GRAD)
    np.testing.assert_allclose(g, ref_pp["grad_embed"], **PP_GRAD)
    # M (S - 1) hand-offs of a (B / M, T, D) float32 activation, and their gradients back
    want = 2 * 4 * 1 * (2 * 16 * cfg.d_model * 4)
    assert pp.handoff_bytes(cfg, 8, 16, mesh.shape["pod"], 4) == want == sum(moved)


def test_pp_param_specs_and_refusals():
    cfg = get_config("yi-9b").smoke().scaled(n_layers=4)
    params = build_model(cfg).init(torch.Generator(), device="meta")
    mesh = make_mesh(*PP_MESH, devices=["meta"] * 8)
    base = rules.param_specs(params, mesh)
    got = pp.pp_param_specs(params, base)
    for path, spec in got.items():
        if path.startswith("blocks."):
            assert spec == P("pod", *base[path][1:]), path
        else:
            assert spec == base[path], path
    batch = {"tokens": torch.zeros((8, 4), dtype=torch.int32),
             "labels": torch.zeros((8, 4), dtype=torch.int32)}
    with pytest.raises(AssertionError):
        pp.pp_loss_fn(build_model(cfg.scaled(n_layers=3)).init(torch.Generator(), device=CPU),
                      batch, cfg.scaled(n_layers=3), mesh)
    hy = get_config("hymba-1.5b").smoke()
    with pytest.raises(ValueError, match="uniform families"):
        pp.pp_loss_fn(None, batch, hy, mesh)


# ---------------------------------------------------------------------------
# build_step's spec trees against the reference's on (data 2, model 4)
# ---------------------------------------------------------------------------


def _step_specs(in_sh, out_sh) -> dict:
    flat = {}
    for tag, tree in (("in", in_sh), ("out", out_sh)):
        for i, t in enumerate(tree):
            if t is not None:
                for path, sh in rules._flat(t).items():
                    flat[f"{tag}/{i}" + (f"/{path}" if path else "")] = list(sh.spec)
    return json.loads(json.dumps(flat))


@pytest.mark.parametrize("arch,shape", list(itertools.product(
    ("yi-9b", "arctic-480b"), ("train_4k", "prefill_32k", "decode_32k"))))
def test_build_step_specs_match_reference(ref_ep, arch, shape):
    want = json.loads(str(ref_ep["build_step"]))[f"{arch}/{shape}"]
    mesh = make_mesh(*EP_MESH, devices=["meta"] * 8)
    model = build_model(get_config(arch).smoke())
    fn, args, in_sh, out_sh, donate = build_step(model, SHAPES[shape], mesh, batch_override=8)
    assert _step_specs(in_sh, out_sh) == want["specs"]
    assert list(donate) == want["donate"]
    # nothing allocated: every argument on the meta device but the step
    # counters (int32 CPU scalars)
    leaves = rules._flat(rules._map(lambda path, leaf: getattr(leaf, "params", (leaf,))[0],
                                    args[0]))
    assert leaves and all(t.device.type == "meta" or t.dim() == 0 for t in leaves.values())


# ---------------------------------------------------------------------------
# restore onto shardings (elastic resume)
# ---------------------------------------------------------------------------


def test_elastic_restore_new_sharding(tmp_path):
    """Checkpoints restore onto a different mesh (elastic resume): each
    leaf checked against its spec and returned on the host, never on the
    mesh's device (the caller copies it into its state there)."""
    ck = Checkpointer(str(tmp_path))
    tree = {"w": np.arange(16.0, dtype=np.float32).reshape(4, 4), "s": np.float32(3.0)}
    ck.save(3, tree, meta={"next_step": 3})
    mesh = make_mesh(1, "data", devices=[CPU])
    got, meta = ck.restore(shardings={"w": NamedSharding(mesh, P("data", None)),
                                      "s": NamedSharding(mesh, P())})
    assert meta == {"next_step": 3} and isinstance(got["w"], torch.Tensor)
    np.testing.assert_array_equal(got["w"].numpy(), tree["w"])
    got, _ = ck.restore(shardings=NamedSharding(make_mesh((2, 2), ("data", "model"),
                                                          devices=[CPU] * 4), P()))
    assert got["w"].device.type == "cpu" and float(got["s"]) == 3.0
    on_meta = make_mesh((2, 2), ("data", "model"), devices=["meta"] * 4)
    got, _ = ck.restore(shardings={"w": NamedSharding(on_meta, P("data", "model")),
                                   "s": NamedSharding(on_meta, P())})
    assert on_meta.merge_device.type == "meta"
    assert all(t.device.type == "cpu" for t in got.values())
    np.testing.assert_array_equal(got["w"].numpy(), tree["w"])
    with pytest.raises(ValueError, match="more entries"):
        ck.restore(step=3, shardings=NamedSharding(mesh, P("data")))  # on the scalar
    three = make_mesh(3, devices=[CPU] * 3)
    with pytest.raises(ValueError, match="does not split"):
        ck.restore(step=3, shardings={"w": NamedSharding(three, P("data", None)),
                                      "s": NamedSharding(three, P())})
    with pytest.raises(ValueError, match="no axis"):
        ck.restore(step=3, shardings={"w": NamedSharding(mesh, P("model")),
                                      "s": NamedSharding(mesh, P())})
    with pytest.raises(ValueError, match="no sharding"):
        ck.restore(step=3, shardings={"w": NamedSharding(mesh, P())})
