"""The VLM family (``models.vlm``) against the reference on the same
weights.

The reference's smoke llama-3.2-vision-11b at ``n_layers=4,
cross_every=2`` (two groups of two self layers and a gated cross block,
so the group order is exercised; d_model 64, 8 image tokens of d_vision
32, fp32 compute) is carried into the port with ``params_from_reference``
after its gates are set to nonzero values in the numpy tree, on both
sides (the reference draws them as zeros, which make the images
irrelevant).  The forward pass, loss, prefill caches in the nested layout
and three decode steps agree within rtol = atol = 1e-4, as the decoder
families of test_torch_models.py do.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
R = pytest.importorskip("_torch_parity")

from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.models import vlm  # noqa: E402
from repro_torch.models.registry import build_model, param_count, params_from_reference  # noqa: E402
from repro_torch.models.transformer import logits_fn  # noqa: E402

ARCH = "llama-3.2-vision-11b"
TOL = dict(rtol=1e-4, atol=1e-4)
B, T = 2, 16
CPU = "cpu"
GATES = {"gate_attn": [0.7, -0.4], "gate_ffn": [0.3, 0.9]}  # one a group


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), want, **(tol or TOL))


def _tree_close(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for name in want:
            _tree_close(got[name], want[name])
        return
    assert tuple(got.shape) == want.shape
    _close(got, want)


def _gated_tree(tree, gates):
    tree["cross_blocks"].update({k: np.asarray(v, np.float32) for k, v in gates.items()})
    return tree


def _images(cfg, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.n_img_tokens, cfg.d_vision)).astype(np.float32)


def _tokens(cfg, seed, shape=(B, T)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


@pytest.fixture(scope="module")
def pair():
    """(reference, port model, port params, images), nonzero gates on both."""
    ref = R.RefLM(ARCH, n_layers=4)
    cfg = ref.cfg
    assert (cfg.cross_every, vlm.n_groups(cfg)) == (2, 2)
    tree = _gated_tree(ref.tree, GATES)
    ref.set_tree(tree)
    return ref, build_model(cfg), params_from_reference(tree, cfg, device=CPU), _images(cfg, 9)


def test_params_from_reference_round_trip(pair):
    """Every leaf under its key path (``blocks.<i>.attn.wq``,
    ``cross_blocks.<g>.xattn.wk``, ``cross_blocks.<g>.gate_attn`` (0-d
    float32), ``img_proj``, ``lm_head``)."""
    ref, model, params, _ = pair
    tree = ref.tree
    got = dict(params.named_parameters())
    want = {k: tree[k] for k in ("embed", "img_proj", "final_norm", "lm_head")}
    for stack in ("blocks", "cross_blocks"):
        for group, leaf in tree[stack].items():
            for name, arr in (leaf.items() if isinstance(leaf, dict) else [(None, leaf)]):
                for i in range(arr.shape[0]):
                    want[f"{stack}.{i}.{group}" + (f".{name}" if name else "")] = arr[i]
    assert set(got) == set(want)
    for name, arr in want.items():
        assert got[name].dtype == torch.float32
        assert torch.equal(got[name], torch.from_numpy(np.array(arr))), name
    assert got["cross_blocks.1.gate_ffn"].shape == () and float(got["cross_blocks.1.gate_ffn"]) \
        == np.float32(GATES["gate_ffn"][1])
    assert param_count(params) == sum(np.size(a) for a in want.values())


def test_forward_loss_and_logits(pair):
    ref, model, params, images = pair
    toks, labels = _tokens(model.cfg, 1), _tokens(model.cfg, 2)
    labels[0, :3] = model.cfg.padded_vocab - 1  # padded ids: masked out of the CE
    want_loss, want_hidden, want_logits = ref.loss(toks, labels, images=images)
    loss, metrics = model.loss(params, {"tokens": toks, "labels": labels, "images": images})
    _close(metrics["hidden"], want_hidden)
    _close(logits_fn(params, metrics["hidden"], model.cfg), want_logits)
    assert abs(float(loss) - want_loss) <= 1e-4 * abs(want_loss)


@pytest.mark.parametrize("per_slot", [False, True])
def test_prefill_and_decode(pair, per_slot):
    """The nested caches, ``self`` k/v (G, E, B, S, KV, hd) padded on axis 3
    to cache_len and ``cross`` xk/xv (G, B, n_img, KV, hd); three decode
    steps at a scalar or per-slot positions, the cross caches passed on
    as they are."""
    ref, model, params, images = pair
    cfg = model.cfg
    G, E = vlm.n_groups(cfg), cfg.cross_every
    toks = _tokens(cfg, 3)
    want = ref.prefill(toks, cache_len=T + 4, images=images)
    logits, hidden, caches = model.prefill(params, {"tokens": toks, "images": images},
                                           cache_len=T + 4)
    _close(logits, want[0])
    _close(hidden, want[1])
    _tree_close(caches, want[2])
    assert caches["self"]["k"].shape == (G, E, B, T + 4, cfg.n_kv_heads, cfg.hd)
    assert caches["cross"]["xv"].shape == (G, B, cfg.n_img_tokens, cfg.n_kv_heads, cfg.hd)
    assert not caches["self"]["v"][:, :, :, T:].any()
    ref_caches, tok = want[2], np.argmax(want[0], axis=-1).astype(np.int32)
    for i in range(3):
        pos = np.array([T - 2 + i, T + i], np.int32) if per_slot else T + i
        w_logits, w_hidden, ref_caches = ref.decode(tok, ref_caches, pos)
        cross = caches["cross"]
        logits, hidden, caches = model.decode(params, torch.from_numpy(tok), caches,
                                              torch.as_tensor(pos))
        assert caches["cross"] is cross
        _close(logits, w_logits)
        _close(hidden, w_hidden)
        _tree_close(caches, ref_caches)
        tok = np.argmax(w_logits, axis=-1).astype(np.int32)


def test_zero_gates_make_the_images_irrelevant(pair):
    """With the reference's zero gates (tanh 0 = 0) two image sets give the
    same logits in both packages, bit for bit; with nonzero gates they
    differ."""
    ref, model, params, images = pair
    cfg = model.cfg
    toks = _tokens(cfg, 5)
    other = _images(cfg, 10)
    zero = {k: [0.0, 0.0] for k in GATES}
    ref0 = R.RefLM(ARCH, n_layers=4)
    ref0.set_tree(_gated_tree(ref.tree, zero))
    port0 = params_from_reference(_gated_tree(ref.tree, zero), cfg, device=CPU)
    a = ref0.prefill(toks, images=images)[0]
    b = ref0.prefill(toks, images=other)[0]
    assert np.array_equal(a, b)
    pa = model.prefill(port0, {"tokens": toks, "images": images})[0]
    pb = model.prefill(port0, {"tokens": toks, "images": other})[0]
    assert torch.equal(pa, pb)
    _close(pa, a)
    gated = [model.prefill(params, {"tokens": toks, "images": im})[0] for im in (images, other)]
    assert float((gated[0] - gated[1]).abs().max()) > 1e-3


def test_decode_consistent_with_prefill():
    """tests/test_arch_smoke.py::test_decode_consistent_with_prefill on the
    port's own draws (smoke config, gates set to 0.5): decode after
    prefilling T - 1 tokens == the teacher-forced logits at T - 1."""
    cfg = get_config(ARCH).smoke()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=CPU)
    assert all(float(c.gate_attn) == 0.0 for c in params.cross_blocks)
    for c in params.cross_blocks:
        c.gate_attn.data.fill_(0.5)
        c.gate_ffn.data.fill_(0.5)
    toks, images = _tokens(cfg, 7), _images(cfg, 8)
    full, _, _ = model.prefill(params, {"tokens": toks, "images": images}, cache_len=T)
    _, _, caches = model.prefill(params, {"tokens": toks[:, :-1], "images": images},
                                 cache_len=T)
    dec, _, _ = model.decode(params, torch.from_numpy(toks[:, -1]), caches, T - 1)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=2e-3, atol=2e-3)
    assert dec.shape == (B, cfg.padded_vocab) and bool(torch.isfinite(dec).all())


@pytest.mark.parametrize("phase", ["train_4k", "prefill_32k", "decode_32k"])
def test_specs_match_reference(phase):
    """``input_specs`` (``images`` in the compute dtype) and the nested
    ``cache_specs`` against the reference's, shapes and dtypes."""
    model = build_model(get_config(ARCH).smoke())
    want = R.ref_model_specs(ARCH, phase, 2, 24)

    def plain(tree):
        if isinstance(tree, dict):
            return {k: plain(v) for k, v in tree.items()}
        assert tree.device.type == "meta"
        return (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))

    assert plain(model.input_specs(SHAPES[phase], batch_override=2)) == want["inputs"]
    assert plain(model.cache_specs(2, 24)) == want["caches"]
    zeros = model.init_cache(2, 24, device=CPU)
    assert set(zeros) == {"self", "cross"} and not zeros["cross"]["xk"].any()
