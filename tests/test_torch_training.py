"""The training half of the LM zoo (``train.{optimizer,train_step}``,
``runtime.fault_tolerance``, ``launch.train``, ``models.common.grad_cast``
and autograd through every family's loss) against the reference.

The reference's smoke models (two layers of d_model 64 unless stated) are
initialised by the reference and carried across by
``params_from_reference`` (a train state by ``train_state_from_reference``);
batches are numpy arrays drawn from a seed (``data.pipeline``'s Philox
stream or ``np.random.default_rng``), fed to both packages.

Tolerances, each measured on the CPU and set with headroom (the two
frameworks sum products and reductions in different orders):

* value and grad: the loss within rtol 1e-5 (measured <= 1e-7) and each
  gradient leaf within GRAD_TOL x its largest element (float32: 2e-5,
  measured <= 4e-6; the MoE smoke models keep bf16 parameters, whose
  gradients are bf16: 2^-7, measured 1.1e-3);
* train steps, 3 of them: each step's loss within a relative tolerance and
  every leaf of the state (parameters, optimizer state) within a relative
  L2 error, ``|got - want| <= tol x |want|`` (STEP_CASES).  Adam and
  Adafactor divide each gradient element by its own running RMS, so an
  element whose gradient is at the frameworks' rounding noise takes a
  step of about the learning rate in either direction: the L2 measure
  keeps such elements from deciding the comparison.  float32 AdamW and
  Adafactor hold 1e-4 (measured 1.7e-5 and 1.8e-6); 32 layers, where
  more attention gradients sit at that noise, 2e-3 (measured 2.2e-4);
  Arctic's bf16 parameters, each rounded to bf16 after its update, 2e-2
  (measured 3.5e-3); bf16 compute, whose gradients differ between the
  frameworks by ~1-2 % of their largest element already in one
  backward pass, 0.3 (measured 0.12) with the losses within 1e-3
  (measured 2.5e-4);
* schedules: the reference's learning rates within rtol 1e-6 (both in
  float32);
* inside the port, bit for bit: remat on and off, a supervised restart
  against an uninterrupted run, a train state carried to the reference's
  layout and back, and ``grad_cast``'s cotangent against ``jax.vjp``'s.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
R = pytest.importorskip("_torch_parity")

from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import SyntheticTokens, make_batch_fn  # noqa: E402
from repro_torch.launch.train import main as train_main  # noqa: E402
from repro_torch.models import attention as port_attention  # noqa: E402
from repro_torch.models import encdec, transformer, vlm  # noqa: E402
from repro_torch.models.common import grad_cast  # noqa: E402
from repro_torch.models.registry import (  # noqa: E402
    build_model,
    params_from_reference,
    stacked_leaves,
    train_state_from_reference,
    train_state_to_reference,
)
from repro_torch.runtime import TrainSupervisor  # noqa: E402
from repro_torch.train import init_train_state, make_optimizer, make_train_step  # noqa: E402
from repro_torch.train.optimizer import cosine_schedule, wsd_schedule  # noqa: E402

CPU = "cpu"
B, T = 2, 16
LR = (1e-2, 2, 100)  # cosine_schedule(peak, warmup, total) of the step cases
LOSS_RTOL = 1e-5
GRAD_TOL = {"float32": 2e-5, "bfloat16": 2.0 ** -7}


def _cfg(arch, **scaled):
    return get_config(arch).smoke().scaled(**{"n_layers": 2, **scaled})


def _batch(cfg, seed, batch=B, seq=T):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (batch, seq)).astype(np.int32)}
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal((batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        b["images"] = rng.standard_normal((batch, cfg.n_img_tokens, cfg.d_vision)).astype(
            np.float32)
    return b


def _at(tree, path):
    for k in path.split("."):
        tree = tree[k]
    return tree


def _grads_of(model, params, batch):
    """(loss, {name: grad}) of one backward pass."""
    params.requires_grad_(True)
    for p in params.parameters():
        p.grad = None
    loss, _ = model.loss(params, batch)
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in params.named_parameters()}


# ---------------------------------------------------------------------------
# value and grad through every family's loss
# ---------------------------------------------------------------------------

FAMILIES = {  # case -> (arch, scaled config fields)
    "dense": ("minicpm-2b", {}),
    "dense-kv-chunked": ("minicpm-2b", {}),  # the KV-chunked attention path
    "moe": ("arctic-480b", {}),
    "moe-drops": ("arctic-480b", {"moe_capacity_factor": 0.25}),  # capacity drops rows
    "ssm": ("mamba2-1.3b", {}),
    "hybrid": ("hymba-1.5b", {}),
    "encdec": ("whisper-medium", {}),
    "vlm": ("llama-3.2-vision-11b", {}),
}


@pytest.mark.parametrize("case", FAMILIES)
def test_value_and_grad_matches_reference(case, monkeypatch):
    arch, scaled = FAMILIES[case]
    ref = R.RefLM(arch, **scaled)
    cfg = _cfg(arch, **scaled)
    tree = ref.tree
    if cfg.family == "vlm":  # drawn as 0, the gates would zero the cross layers' gradients
        for name in ("gate_attn", "gate_ffn"):
            tree["cross_blocks"][name] = np.full(tree["cross_blocks"][name].shape, 0.5,
                                                 np.float32)
        ref.set_tree(tree)
    batch = _batch(cfg, 1)
    if case == "dense-kv-chunked":
        monkeypatch.setattr(port_attention, "CHUNKED_THRESHOLD", 8)
        with R.ref_chunked_threshold(8):
            want_loss, want = R.ref_value_and_grad(ref, batch)
    else:
        want_loss, want = R.ref_value_and_grad(ref, batch)

    model = build_model(cfg)
    params = params_from_reference(tree, cfg, device=CPU)
    loss, grads = _grads_of(model, params, batch)
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    for leaf in stacked_leaves(params):
        g = torch.stack([grads[n] for n in leaf.names]) if leaf.stacked else grads[leaf.names[0]]
        w = np.asarray(_at(want, leaf.path)).astype(np.float32)
        assert tuple(g.shape) == w.shape, leaf.path
        assert g.dtype == leaf.params[0].dtype, leaf.path
        err = np.max(np.abs(g.float().numpy() - w))
        assert err <= GRAD_TOL[str(g.dtype).split(".")[1]] * np.max(np.abs(w)), (leaf.path, err)


@pytest.mark.parametrize("arch", ["minicpm-2b", "arctic-480b", "mamba2-1.3b", "hymba-1.5b",
                                  "whisper-medium", "llama-3.2-vision-11b"])
def test_remat_keeps_gradients_bit_equal(arch, monkeypatch):
    """Each layer rematerialised (the default under autograd) against no
    rematerialisation: the same loss and gradients bit for bit, and fewer
    bytes kept for the backward pass."""
    cfg = _cfg(arch)
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=CPU)
    batch = _batch(cfg, 2)

    def run():
        saved = []

        def pack(t):
            saved.append(t.numel() * t.element_size())
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            out = _grads_of(model, params, batch)
        return out, sum(saved)

    (l1, g1), kept_remat = run()
    mod = {"encdec": encdec, "vlm": vlm}.get(cfg.family, transformer)
    monkeypatch.setattr(mod, "rematerialised", lambda fn, *args, remat=True: fn(*args))
    (l2, g2), kept_plain = run()
    assert torch.equal(l1, l2)
    assert all(torch.equal(g1[n], g2[n]) for n in g1)
    assert kept_remat < kept_plain, (kept_remat, kept_plain)


def test_forward_remat_flag_is_the_switch():
    """``transformer.forward(..., remat=False)`` keeps every activation."""
    cfg = _cfg("minicpm-2b")
    params = build_model(cfg).init(torch.Generator().manual_seed(0), device=CPU)
    params.requires_grad_(True)
    tokens = _batch(cfg, 0)["tokens"]
    kept = {}
    for remat in (True, False):
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t,
                                                      lambda t: t):
            hidden, _, _ = transformer.forward(params, tokens, cfg, remat=remat)
        kept[remat] = len(saved)
        hidden.sum().backward()
    assert kept[True] < kept[False]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dtype_name", ["float32", "bfloat16"])
def test_grad_cast_cotangent_matches_jax_vjp(dtype_name, dtype):
    """The identity forward; the cotangent bf16-rounded when the compute
    dtype is bf16.  JAX hands a float32 primal a bf16 cotangent, torch
    the same values in the input's dtype."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(33).astype(np.float32) * 3.0
    ct = rng.standard_normal(33).astype(np.float32) * 1.2345678
    want, want_dtype = R.ref_grad_cast_vjp(x, ct, dtype_name, dtype)
    tdt = getattr(torch, dtype)
    xt = torch.from_numpy(x).to(tdt).requires_grad_(True)
    y = grad_cast(xt, dtype_name)
    assert torch.equal(y.detach(), xt.detach())
    y.backward(torch.from_numpy(ct).to(tdt))
    assert xt.grad.dtype == tdt
    np.testing.assert_array_equal(xt.grad.float().numpy(), want)
    assert want_dtype == ("bfloat16" if "bfloat16" in (dtype, dtype_name) else "float32")


# ---------------------------------------------------------------------------
# train steps against the reference's jitted make_train_step
# ---------------------------------------------------------------------------

# case -> (arch, optimizer, accum_steps, scaled config fields, loss rtol,
# state tolerance in relative L2); optimizer/accum None: the config's own
STEP_CASES = {
    "adamw": ("minicpm-2b", "adamw", 1, {}, LOSS_RTOL, 1e-4),
    "adafactor": ("minicpm-2b", "adafactor", 1, {}, LOSS_RTOL, 1e-4),
    "adafactor-32-layers": ("minicpm-2b", "adafactor", 1, {"n_layers": 32}, LOSS_RTOL, 2e-3),
    "arctic-own-config": ("arctic-480b", None, None, {}, 1e-4, 2e-2),
    "bf16-compute": ("minicpm-2b", "adamw", 2, {"dtype": "bfloat16"}, 1e-3, 0.3),
}
STEP_BATCH, STEP_SEQ = 8, 16  # accum_steps 8 splits it into single sequences


def _held(got, want, tol, path="state"):
    """Every leaf of ``want`` in ``got`` with its shape, within ``tol`` in
    relative L2 norm (integers exactly)."""
    if isinstance(want, dict):
        assert set(got) == set(want), (path, sorted(got), sorted(want))
        for k in want:
            _held(got[k], want[k], tol, f"{path}.{k}")
        return
    g, w = np.asarray(got), np.asarray(want)
    assert g.shape == w.shape, (path, g.shape, w.shape)
    if np.issubdtype(w.dtype, np.integer):
        np.testing.assert_array_equal(g, w, err_msg=path)
        return
    g, w = g.astype(np.float64), w.astype(np.float64)
    err = np.linalg.norm(g - w)
    assert err <= tol * np.linalg.norm(w), (path, err / max(np.linalg.norm(w), 1e-300))


def _step_batches(cfg, seed=3):
    return make_batch_fn(SyntheticTokens(cfg.vocab_size, STEP_SEQ, STEP_BATCH, seed=seed))


def _dtypes(params):
    return {leaf.path: str(leaf.params[0].dtype).split(".")[1] for leaf in stacked_leaves(params)}


@pytest.mark.parametrize("case", STEP_CASES)
def test_train_steps_match_reference(case):
    arch, opt_name, accum, scaled, loss_rtol, tol = STEP_CASES[case]
    cfg = _cfg(arch, **scaled)
    opt_name, accum = opt_name or cfg.optimizer, accum or cfg.accum_steps
    ref = R.RefTrain(arch, opt_name, LR, accum_steps=accum, **scaled)
    state = train_state_from_reference(ref.tree, cfg, device=CPU)
    assert _dtypes(state["params"]) == {
        leaf.path: np.asarray(_at(ref.tree["params"], leaf.path)).dtype.name
        for leaf in stacked_leaves(state["params"])}
    step = make_train_step(build_model(cfg), make_optimizer(opt_name, cosine_schedule(*LR)),
                           accum_steps=accum)
    batches = _step_batches(cfg)
    for s in range(3):
        want = ref.step(batches(s))
        state, got = step(state, batches(s))
        np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=loss_rtol)
        np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6)
        if "grad_norm" in want:
            np.testing.assert_allclose(float(got["grad_norm"]), want["grad_norm"],
                                       rtol=100 * loss_rtol)
    _held(train_state_to_reference(state), ref.tree, tol)
    if case == "adafactor-32-layers":  # stacked (32, 64): factored across the layers
        assert set(state["opt"]["v"]["blocks.norm1"]) == {"vr", "vc"}
        assert tuple(state["opt"]["v"]["blocks.norm1"]["vc"].shape) == (cfg.d_model,)


def test_train_state_carried_mid_training_continues_as_the_reference():
    """Three reference steps, the state carried into the port, then three
    more steps on each side."""
    cfg = _cfg("minicpm-2b")
    ref = R.RefTrain("minicpm-2b", "adamw", LR)
    batches = _step_batches(cfg, seed=4)
    for s in range(3):
        ref.step(batches(s))
    state = train_state_from_reference(ref.tree, cfg, device=CPU)
    assert int(state["step"]) == int(state["opt"]["step"]) == 3
    step = make_train_step(build_model(cfg), make_optimizer("adamw", cosine_schedule(*LR)))
    for s in range(3, 6):
        want = ref.step(batches(s))
        state, got = step(state, batches(s))
        np.testing.assert_allclose(float(got["loss"]), want["loss"], rtol=LOSS_RTOL)
    _held(train_state_to_reference(state), ref.tree, 1e-4)


@pytest.mark.parametrize("arch,optimizer", [("minicpm-2b", "adamw"),
                                            ("arctic-480b", "adafactor")])
def test_train_state_round_trip_is_exact(arch, optimizer):
    ref = R.RefTrain(arch, optimizer, LR)
    cfg = _cfg(arch)
    ref.step(_step_batches(cfg)(0))
    want = ref.tree
    got = train_state_to_reference(train_state_from_reference(want, cfg, device=CPU))

    def equal(g, w, path):
        if isinstance(w, dict):
            assert set(g) == set(w), path
            for k in w:
                equal(g[k], w[k], f"{path}.{k}")
            return
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w).astype(np.asarray(g).dtype),
                                      err_msg=path)

    equal(got, want, "state")


# ---------------------------------------------------------------------------
# tests/test_training.py, case for case
# ---------------------------------------------------------------------------


def _tiny_model():
    cfg = _cfg("minicpm-2b")
    return cfg, build_model(cfg)


def test_optimizers_descend():
    cfg, model = _tiny_model()
    batch_fn = make_batch_fn(SyntheticTokens(cfg.vocab_size, 16, 4, seed=3))
    for name in ["adamw", "adafactor"]:
        opt = make_optimizer(name, cosine_schedule(1e-2, 5, 200))
        state = init_train_state(model, opt, torch.Generator().manual_seed(0), device=CPU)
        step = make_train_step(model, opt)
        losses = []
        for s in range(20):
            state, metrics = step(state, batch_fn(s % 2))  # 2 repeating batches
            losses.append(float(metrics["loss"]))
        assert losses[-1] < losses[0] - 0.1, (name, losses[0], losses[-1])
        assert np.all(np.isfinite(losses))


def test_wsd_schedule_shape():
    lr = wsd_schedule(1.0, warmup=10, stable=50, decay=40)
    assert float(lr(0)) == 0.0
    assert abs(float(lr(10)) - 1.0) < 1e-6
    assert abs(float(lr(40)) - 1.0) < 1e-6
    assert float(lr(80)) < 1.0
    assert abs(float(lr(100)) - 0.1) < 1e-2


def test_schedules_match_reference():
    ref_cos, ref_wsd = R.ref_schedules()
    pairs = ((cosine_schedule(3e-4, 10, 100), ref_cos(3e-4, 10, 100)),
             (wsd_schedule(1e-2, 5, 30, 20), ref_wsd(1e-2, 5, 30, 20)))
    for port, ref in pairs:
        for s in range(0, 120):
            np.testing.assert_allclose(port(s), float(ref(s)), rtol=1e-6, err_msg=str(s))


@pytest.mark.parametrize("arch,fail_at", [("minicpm-2b", 7), ("minicpm-2b", 3),
                                          ("arctic-480b", 7)])
def test_restart_bit_exact(tmp_path, arch, fail_at):
    """Kill training at step ``fail_at``, restart, resume: final params and
    optimizer state identical to an uninterrupted run (batches are pure
    functions of the step).  At step 7 the supervisor restores the step-5
    checkpoint; at step 3 it restarts from the state it started with.
    Arctic's smoke model keeps bf16 parameters and trains with Adafactor."""
    cfg = _cfg(arch)
    model = build_model(cfg)
    opt = make_optimizer(cfg.optimizer, cosine_schedule(1e-2, 2, 100))
    batch_fn = make_batch_fn(SyntheticTokens(cfg.vocab_size, 16, 4, seed=5))
    step_fn = make_train_step(model, opt)
    N = 12

    def fresh():
        return init_train_state(model, opt, torch.Generator().manual_seed(1), device=CPU)

    state = fresh()
    for s in range(N):
        state, _ = step_fn(state, batch_fn(s))
    want = train_state_to_reference(state)

    boom = {"armed": True}

    def failure_hook(step):
        if step == fail_at and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("simulated node failure")

    sup = TrainSupervisor(str(tmp_path / "ck"), ckpt_every=5)
    st2 = sup.run(fresh(), step_fn, batch_fn, N, failure_hook=failure_hook)
    assert sup.restarts == 1
    assert int(st2["step"]) == N
    got = train_state_to_reference(st2)
    for path in ("params", "opt"):
        _held(got[path], want[path], 0.0)
    if cfg.param_dtype == "bfloat16":
        assert any(p.dtype == torch.bfloat16 for p in st2["params"].parameters())
    # the final save holds the state bit for bit, bf16 leaves as bf16
    tree, meta = Checkpointer(str(tmp_path / "ck")).restore()
    assert meta == {"next_step": N}
    for name, p in st2["params"].named_parameters():
        assert torch.equal(torch.as_tensor(tree["params"][name]), p.detach()), name


def test_launch_train_main_on_cpu(tmp_path):
    ck = str(tmp_path / "ck")
    losses = train_main(["--arch", "minicpm-2b", "--device", "cpu", "--steps", "3", "--batch",
                         "2", "--seq", "16", "--ckpt", ck, "--ckpt-every", "2"])
    assert len(losses) == 3 and np.all(np.isfinite(losses))
    assert Checkpointer(ck).all_steps() == [2, 3]


def test_unported_options_raise(tmp_path):
    """Once refused, both options run: ``compress_pods`` on a mesh with a
    'pod' axis (and raises without one), and ``state_shardings``, onto
    which a supervised restart restores the state — elastically, on
    another mesh than the one the run started on."""
    from repro_torch.core.distributed import make_mesh
    from repro_torch.runtime.fault_tolerance import state_tree
    from repro_torch.sharding import rules

    cfg, model = _tiny_model()
    opt = make_optimizer("adamw")
    with pytest.raises(ValueError, match="'pod' axis"):
        make_train_step(model, opt, compress_pods=True)
    pods = make_mesh((2, 1, 1), ("pod", "data", "model"), devices=[CPU] * 2)
    step_fn = make_train_step(model, opt, pods, compress_pods=True)
    batch_fn = make_batch_fn(SyntheticTokens(cfg.vocab_size, 8, 4))

    def fresh():
        return init_train_state(model, opt, torch.Generator().manual_seed(0), device=CPU,
                                compress_pods=True, mesh=pods)

    mesh = make_mesh((2, 2), ("data", "model"), devices=[CPU] * 4)
    state = fresh()
    shardings = rules.named(mesh, rules.state_specs(
        state, rules.param_specs(state["params"], mesh, fsdp_min_size=1), mesh))
    want = TrainSupervisor(str(tmp_path / "a"), ckpt_every=2).run(fresh(), step_fn, batch_fn, 4)

    def failure_hook(step, fired=[]):
        if step == 3 and not fired:
            fired.append(step)
            raise RuntimeError("node lost")

    sup = TrainSupervisor(str(tmp_path / "b"), ckpt_every=2)
    got = sup.run(fresh(), step_fn, batch_fn, 4, failure_hook=failure_hook,
                  state_shardings=shardings)
    assert sup.restarts == 1 and int(got["step"]) == 4
    a, b = state_tree(want), state_tree(got)
    for path in ("params", "err"):
        for x, y in zip(_tensors(a[path]), _tensors(b[path])):
            assert torch.equal(x, y)
    with pytest.raises(ValueError, match="more entries"):  # a spec the step scalar refuses
        TrainSupervisor(str(tmp_path / "b")).run(
            fresh(), step_fn, batch_fn, 5,
            state_shardings=rules.NamedSharding(mesh, rules.P("data")))


def _tensors(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _tensors(tree[k])
    else:
        yield tree


def test_no_train_state_under_inference_mode():
    cfg, model = _tiny_model()
    with torch.inference_mode(), pytest.raises(RuntimeError, match="inference_mode"):
        init_train_state(model, make_optimizer("adamw"), torch.Generator().manual_seed(0),
                         device=CPU)


def test_microbatches_must_split_the_batch():
    cfg, model = _tiny_model()
    opt = make_optimizer("adamw")
    state = init_train_state(model, opt, torch.Generator().manual_seed(0), device=CPU)
    with pytest.raises(ValueError, match="microbatches"):
        make_train_step(model, opt, accum_steps=3)(state, _batch(cfg, 0, batch=4))

