"""``train.grad_compression`` and the pod-compressed train step against
the reference.

``quantize`` gives the reference's codes and scales on the same inputs;
the reference's own tests (tests/test_training.py:115-148) are mirrored;
``compressed_pmean`` matches the reference's vmapped over a 'pod' axis;
and three ``compress_pods=True`` AdamW steps of the yi-9b smoke model (2
layers) on a (pod 2, data 1, model 4) mesh match the reference's on 8
forced host devices (``_torch_parity.mesh_reference``, one subprocess):
the losses chained over the three steps, and each step replayed from the
reference's state before it — loss, gradient norm, and each pod's
residual tree against the shard of that pod's first device.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
R = pytest.importorskip("_torch_parity")

from repro_torch.checkpoint import Checkpointer  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.distributed import make_mesh  # noqa: E402
from repro_torch.data.pipeline import SyntheticTokens, make_batch_fn  # noqa: E402
from repro_torch.models.registry import (build_model, train_state_from_reference,  # noqa: E402
                                         train_state_to_reference)
from repro_torch.runtime.fault_tolerance import load_state, state_tree  # noqa: E402
from repro_torch.train import (grad_compression as gc, init_train_state,  # noqa: E402
                               make_optimizer, make_train_step)
from repro_torch.train.optimizer import cosine_schedule  # noqa: E402

CPU = "cpu"
POD_MESH = ((2, 1, 4), ("pod", "data", "model"))
STEPS = 3
LOSS_RTOL = 1e-4  # the chained run: Adam's rounding noise grows over the steps
REPLAY_RTOL = 1e-5  # a step from the reference's own state
FLIP_SHARE = 1e-3  # residuals that may take the other code at a rounding boundary


def _pod_mesh():
    return make_mesh(*POD_MESH, devices=[CPU] * 8)


@pytest.mark.parametrize("shape", [(1000,), (256,), (3, 700), (2, 5, 129), (7,)])
def test_quantize_matches_reference(shape):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * rng.uniform(0.01, 10.0)).astype(np.float32)
    x.reshape(-1)[: min(x.size, 300)] *= 1e-3  # a block of small values beside large ones
    if x.size >= 512:
        x.reshape(-1)[256:512] = 0.0  # an all-zero block
    q, s, r = gc.quantize(torch.from_numpy(x))
    wq, ws, wr = R.ref_quantize(x)
    assert q.dtype == torch.int8 and q.shape == wq.shape and s.shape == ws.shape
    np.testing.assert_array_equal(q.numpy(), wq)
    np.testing.assert_array_max_ulp(s.numpy(), ws, maxulp=1)
    np.testing.assert_allclose(r.numpy(), wr, rtol=0, atol=float(ws.max()) * 2.0 ** -22)


def test_grad_compression_quantize_exact_roundtrip():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(1000, generator=gen) * 3.0
    q, s, r = gc.quantize(x)
    back = gc.dequantize(q, s, x.shape)
    np.testing.assert_allclose((back + r).numpy(), x.numpy(), rtol=1e-5, atol=1e-5)
    # quantization error bounded by scale/2 per element
    assert float(r.abs().max()) <= float(s.max()) * 0.51


def test_error_feedback_convergence():
    """EF-int8 SGD on a quadratic matches exact SGD to high accuracy."""
    dim = 64
    gen = torch.Generator().manual_seed(1)
    A = torch.randn(dim, dim, generator=gen) / np.sqrt(dim)
    H = A @ A.T + 0.1 * torch.eye(dim)
    b = torch.randn(dim, generator=gen)

    def grad(x):
        return H @ x - b

    lr = 0.1
    x_exact = torch.zeros(dim)
    x_comp = torch.zeros(dim)
    err = torch.zeros(dim)
    for _ in range(300):
        x_exact = x_exact - lr * grad(x_exact)
        g = grad(x_comp) + err
        q, s, err = gc.quantize(g)
        x_comp = x_comp - lr * gc.dequantize(q, s, g.shape)
    ref = torch.linalg.solve(H, b)
    # EF-compressed SGD must track exact SGD tightly...
    assert float(torch.linalg.norm(x_comp - x_exact)) < 1e-3
    # ...and make the same progress toward the optimum
    assert float(torch.linalg.norm(x_comp - ref)) < float(torch.linalg.norm(ref)) * 0.5


@pytest.mark.parametrize("pods", [2, 4])
def test_compressed_pmean_matches_reference(pods):
    rng = np.random.default_rng(pods)
    shapes = {"a": (3, 300), "b": (257,), "c": (4, 4)}
    trees = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(pods)]
    errs = [{k: (rng.standard_normal(s) * 1e-3).astype(np.float32) for k, s in shapes.items()}
            for _ in range(pods)]
    mean, new_err = gc.compressed_pmean(
        [{k: torch.from_numpy(v) for k, v in t.items()} for t in trees],
        [{k: torch.from_numpy(v) for k, v in e.items()} for e in errs])
    want_mean, want_err = R.ref_compressed_pmean(trees, errs)
    for k in shapes:
        np.testing.assert_allclose(mean[k].numpy(), want_mean[k], rtol=1e-6, atol=1e-7)
        for p in range(pods):
            np.testing.assert_allclose(new_err[p][k].numpy(), want_err[p][k], rtol=0,
                                       atol=1e-7)
    # the wire: int8 codes plus a float32 scale a block of 256, every pod's,
    # as the codes encode hands to the gather
    sent = 0
    for t, e in zip(trees, errs):
        codes, _ = gc.encode({k: torch.from_numpy(v) for k, v in t.items()},
                             {k: torch.from_numpy(v) for k, v in e.items()})
        sent += sum(q.numel() * q.element_size() + s.numel() * s.element_size()
                    for q, s in codes.values())
    blocks = sum(-(-int(np.prod(s)) // gc.BLOCK) for s in shapes.values())
    assert gc.wire_bytes(shapes.values(), pods) == {
        "pod_int8": sent, "pod_fp32": pods * 4 * sum(int(np.prod(s)) for s in shapes.values())}
    assert sent == pods * blocks * (gc.BLOCK + 4)


# ---------------------------------------------------------------------------
# the pod-compressed train step against the reference's on 8 host devices
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ref_pods(tmp_path_factory):
    return R.mesh_reference(tmp_path_factory.mktemp("pods"), "pods")


def _nest(r: dict, prefix: str) -> dict:
    out: dict = {}
    for k, v in r.items():
        if k.startswith(prefix):
            node, parts = out, k[len(prefix):].split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = v
    return out


def _setup():
    cfg = get_config("yi-9b").smoke().scaled(n_layers=2)
    model = build_model(cfg)
    opt = make_optimizer("adamw", cosine_schedule(1e-2, 2, 100))
    batch_fn = make_batch_fn(SyntheticTokens(cfg.vocab_size, 16, 8, seed=R.MESH_BATCH_SEED))
    return cfg, model, opt, batch_fn


def _ref_err(r: dict, step: int, pod: int, paths) -> dict:
    return {p: torch.from_numpy(r[f"err{step}/{pod}/" + p.replace(".", "/")]) for p in paths}


def _residuals_match(got: dict, want: dict) -> int:
    """Each residual equals the reference's within 1e-6, but where the
    gradient sat at a code's rounding boundary and took the other code:
    there the residual moves by one step of its block's scale, at most
    twice the block's largest residual.  Returns how many moved."""
    moved = total = 0
    for path, t in got.items():
        g, w = t.numpy().reshape(-1), want[path].numpy().reshape(-1)
        pad = (-w.size) % gc.BLOCK
        gb, wb = np.pad(g, (0, pad)).reshape(-1, gc.BLOCK), np.pad(w, (0, pad)).reshape(-1,
                                                                                        gc.BLOCK)
        diff = np.abs(gb - wb)
        step = 2.0 * np.abs(wb).max(axis=1, keepdims=True)
        off = diff > 1e-6
        assert np.all(diff <= step + 1e-6), path
        moved += int(off.sum())
        total += w.size
    assert moved <= FLIP_SHARE * total, (moved, total)
    return moved


def test_compress_pods_matches_reference(ref_pods):
    """Three chained steps: the losses within 1e-4 of the reference's."""
    cfg, model, opt, batch_fn = _setup()
    mesh = _pod_mesh()
    st = train_state_from_reference(_nest(ref_pods, "init/"), cfg, device=CPU)
    st["err"] = gc.init_error_state(st["params"], 2)
    step = make_train_step(model, opt, mesh, compress_pods=True)
    for t in range(STEPS):
        st, m = step(st, batch_fn(t))
        want = float(ref_pods[f"loss/{t}"])
        assert abs(float(m["loss"]) - want) <= LOSS_RTOL * abs(want), (t, float(m["loss"]), want)
    assert int(st["step"]) == STEPS
    # each pod's residual is its own: non-zero, and the two differ
    norms = [float(sum(torch.sum(torch.abs(t)) for t in e.values())) for e in st["err"]]
    assert all(n > 0 for n in norms) and norms[0] != norms[1]
    assert train_state_to_reference(st)["err"].keys() == _nest(ref_pods, "err0/0/").keys()


@pytest.mark.parametrize("t", range(STEPS))
def test_compress_pods_step_replayed_from_reference(ref_pods, t):
    """Step t from the reference's state before it (each pod's residual
    from that pod's device): the loss, the gradient norm, the parameters
    and each pod's new residual tree."""
    cfg, model, opt, batch_fn = _setup()
    prev = "init/" if t == 0 else f"state{t - 1}/"
    st = train_state_from_reference(_nest(ref_pods, prev), cfg, device=CPU)
    paths = list(st["opt"]["m"])
    st["err"] = (gc.init_error_state(st["params"], 2) if t == 0 else
                 [_ref_err(ref_pods, t - 1, pod, paths) for pod in range(2)])
    st, m = make_train_step(model, opt, _pod_mesh(), compress_pods=True)(st, batch_fn(t))
    for key in ("loss", "grad_norm"):
        want = float(ref_pods[f"{key}/{t}"])
        assert abs(float(m[key]) - want) <= REPLAY_RTOL * abs(want), (key, float(m[key]), want)
    for pod in range(2):
        _residuals_match(st["err"][pod], _ref_err(ref_pods, t, pod, paths))
    got = train_state_to_reference(st)["params"]
    want = _nest(ref_pods, f"state{t}/")["params"]
    num = den = 0.0
    for a, b in zip(_leaves(got), _leaves(want)):
        num += float(np.sum((np.asarray(a, np.float64) - b) ** 2))
        den += float(np.sum(np.asarray(b, np.float64) ** 2))
    assert (num / den) ** 0.5 < 1e-4


def _leaves(tree):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    else:
        yield tree


def test_pod_residuals_round_trip_a_checkpoint(tmp_path):
    """Every pod's residual tree is checkpointed and restored bit for bit;
    only pod 0's maps to the reference's ``err``."""
    cfg, model, opt, batch_fn = _setup()
    mesh = _pod_mesh()
    st = init_train_state(model, opt, torch.Generator().manual_seed(0), device=CPU,
                          compress_pods=True, mesh=mesh)
    assert len(st["err"]) == 2 and all(float(t.abs().sum()) == 0 for t in st["err"][1].values())
    st, _ = make_train_step(model, opt, mesh, compress_pods=True)(st, batch_fn(0))
    ck = Checkpointer(str(tmp_path))
    ck.save(1, state_tree(st), meta={"next_step": 1})
    fresh = init_train_state(model, opt, torch.Generator().manual_seed(1), device=CPU,
                             compress_pods=True, mesh=mesh)
    back = load_state(fresh, ck.restore()[0])
    for pod in range(2):
        for path, t in st["err"][pod].items():
            assert torch.equal(back["err"][pod][path], t), (pod, path)
    ref = train_state_to_reference(back)
    np.testing.assert_array_equal(ref["err"]["embed"], st["err"][0]["embed"].numpy())


def test_compress_pods_needs_a_pod_axis():
    cfg, model, opt, _ = _setup()
    with pytest.raises(ValueError, match="'pod' axis"):
        make_train_step(model, opt, make_mesh((2, 4), ("data", "model"), devices=[CPU] * 8),
                        compress_pods=True)
    with pytest.raises(ValueError, match="'pod' axis"):
        init_train_state(model, opt, torch.Generator(), device=CPU, compress_pods=True)
