"""Cross attention and the encoder-decoder family (``models.attention``'s
``cross_attention``/``decode_cross_attention``, ``models.encdec``) against
the reference on the same inputs and weights.

Cross attention runs on seeded numpy inputs and projection weights (MHA
and GQA).  The Whisper cases carry the reference's smoke whisper-medium
(2 + 2 layers, d_model 64, enc_seq 16, fp32 compute) into the port with
``params_from_reference``: ``encode``, the loss and hidden states, the
prefill logits and caches (the self caches padded to ``cache_len``) and
three decode steps agree within rtol = atol = 1e-4, as the decoder
families of test_torch_models.py do; the sinusoids within 1e-5
(4e-5 at Whisper's 1,500 frames, where float32 angles reach 1,500).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
R = pytest.importorskip("_torch_parity")

from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.models import attention as port_attention  # noqa: E402
from repro_torch.models import encdec  # noqa: E402
from repro_torch.models.registry import build_model, param_count, params_from_reference  # noqa: E402

ARCH = "whisper-medium"
TOL = dict(rtol=1e-4, atol=1e-4)
B, T = 2, 16
CPU = "cpu"


def _close(got, want, **tol):
    np.testing.assert_allclose(got.detach().float().numpy(), want, **(tol or TOL))


def _tree_close(got, want):
    """Every tensor of a (nested) cache tree, shapes and values."""
    if isinstance(want, dict):
        assert set(got) == set(want)
        for name in want:
            _tree_close(got[name], want[name])
        return
    assert tuple(got.shape) == want.shape
    _close(got, want)


def _rand(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _attn_weights(rng, D, H, KV, hd):
    return {"wq": _rand(rng, (D, H, hd), D ** -0.5), "wk": _rand(rng, (D, KV, hd), D ** -0.5),
            "wv": _rand(rng, (D, KV, hd), D ** -0.5), "wo": _rand(rng, (H, hd, D), (H * hd) ** -0.5)}


def _t(tree):
    return {k: torch.from_numpy(v) for k, v in tree.items()}


@pytest.mark.parametrize("H,KV,S", [(4, 4, 9), (4, 2, 16), (8, 1, 5)])
def test_cross_attention_matches_reference(H, KV, S):
    """``cross_attention`` (out and the cross K/V) and, on those K/V,
    ``decode_cross_attention``: MHA and GQA, a source longer and shorter
    than the queries."""
    rng = np.random.default_rng(H * 10 + KV)
    D, hd, Tq = 32, 8, 7
    p = _attn_weights(rng, D, H, KV, hd)
    x, src, x1 = _rand(rng, (2, Tq, D)), _rand(rng, (2, S, D)), _rand(rng, (2, 1, D))
    want_out, (want_k, want_v) = R.ref_cross_attention(x, p, src)
    out, (k, v) = port_attention.cross_attention(torch.from_numpy(x), _t(p), torch.from_numpy(src))
    _close(out, want_out)
    _close(k, want_k)
    _close(v, want_v)
    want1 = R.ref_decode_cross_attention(x1, p, {"k": want_k, "v": want_v})
    _close(port_attention.decode_cross_attention(torch.from_numpy(x1), _t(p), {"k": k, "v": v}),
           want1)


@pytest.mark.parametrize("Tn,D,offset", [(16, 64, 0), (5, 32, 7), (1500, 1024, 0)])
def test_sinusoid_matches_reference(Tn, D, offset):
    """The sin half, then the cos half, exponent dim / D, in float32."""
    got = encdec.sinusoid(Tn, D, offset)
    assert got.shape == (Tn, D) and got.dtype == torch.float32
    atol = 4e-5 if Tn > 100 else 1e-5
    np.testing.assert_allclose(got.numpy(), R.ref_sinusoid(Tn, D, offset), rtol=0, atol=atol)


@pytest.mark.parametrize("pos", [3, [0, 5, 17]])
def test_sinusoid_at_matches_reference(pos):
    """At a scalar position (-> (1, 1, D)) and at (B,) positions (-> (B, 1, D))."""
    got = encdec.sinusoid_at(torch.tensor(pos), 32)
    want = R.ref_sinusoid_at(np.asarray(pos, np.int32), 32)
    assert got.shape == want.shape == (np.size(pos), 1, 32)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    assert torch.equal(got[-1, 0], encdec.sinusoid(1, 32, offset=int(np.ravel(pos)[-1]))[0])


@pytest.fixture(scope="module")
def whisper():
    """(reference, port model, port params, frames) for the smoke whisper."""
    ref = R.RefLM(ARCH)
    cfg = ref.cfg
    assert (cfg.n_layers, cfg.n_enc_layers, cfg.enc_seq) == (2, 2, 16)
    frames = _rand(np.random.default_rng(9), (B, cfg.enc_seq, cfg.d_model))
    return ref, build_model(cfg), params_from_reference(ref.tree, cfg, device=CPU), frames


def _tokens(cfg, seed, shape=(B, T)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


def test_params_from_reference_round_trip(whisper):
    """Every leaf of the reference's tree under its key path
    (``enc_blocks.<i>.attn.wq``, ``dec_blocks.<i>.xattn.wk``, ...)."""
    ref, model, params, _ = whisper
    tree = ref.tree
    got = dict(params.named_parameters())
    want = {"embed": tree["embed"], "enc_norm": tree["enc_norm"],
            "final_norm": tree["final_norm"]}
    for stack, n in (("enc_blocks", model.cfg.n_enc_layers), ("dec_blocks", model.cfg.n_layers)):
        for group, leaf in tree[stack].items():
            for name, arr in (leaf.items() if isinstance(leaf, dict) else [(None, leaf)]):
                for i in range(n):
                    want[f"{stack}.{i}.{group}" + (f".{name}" if name else "")] = arr[i]
    assert set(got) == set(want)
    for name, arr in want.items():
        assert got[name].dtype == torch.float32
        assert torch.equal(got[name], torch.from_numpy(np.array(arr))), name
    assert param_count(params) == sum(a.size for a in want.values())


def test_encode_matches_reference(whisper):
    """Non-causal, no RoPE, frames + sinusoid(S, D), then ``enc_norm``."""
    ref, model, params, frames = whisper
    _close(encdec.encode(params, frames, model.cfg), R.ref_encode(ref, frames))


def test_loss_and_hidden(whisper):
    ref, model, params, frames = whisper
    toks, labels = _tokens(model.cfg, 1), _tokens(model.cfg, 2)
    labels[0, :3] = model.cfg.padded_vocab - 1  # padded ids: masked out of the CE
    want_loss, want_hidden, want_logits = ref.loss(toks, labels, frames=frames)
    loss, metrics = model.loss(params, {"tokens": toks, "labels": labels, "frames": frames})
    _close(metrics["hidden"], want_hidden)
    _close(encdec._logits(params, metrics["hidden"]), want_logits)
    assert abs(float(loss) - want_loss) <= 1e-4 * abs(want_loss)


@pytest.mark.parametrize("per_slot", [False, True])
def test_prefill_and_decode(whisper, per_slot):
    """Prefill logits, hidden and caches (self k/v padded on axis 2 to
    cache_len, cross xk/xv of enc_seq), then three decode steps at a
    scalar position, or at per-slot positions; ``xk``/``xv`` pass through
    decode unchanged."""
    ref, model, params, frames = whisper
    cfg = model.cfg
    toks = _tokens(cfg, 3)
    want = ref.prefill(toks, cache_len=T + 4, frames=frames)
    logits, hidden, caches = model.prefill(params, {"tokens": toks, "frames": frames},
                                           cache_len=T + 4)
    _close(logits, want[0])
    _close(hidden, want[1])
    _tree_close(caches, want[2])
    assert caches["k"].shape == (cfg.n_layers, B, T + 4, cfg.n_kv_heads, cfg.hd)
    assert caches["xk"].shape == (cfg.n_layers, B, cfg.enc_seq, cfg.n_kv_heads, cfg.hd)
    assert not caches["k"][:, :, T:].any()
    ref_caches, tok = want[2], np.argmax(want[0], axis=-1).astype(np.int32)
    for i in range(3):
        pos = np.array([T - 2 + i, T + i], np.int32) if per_slot else T + i
        w_logits, w_hidden, ref_caches = ref.decode(tok, ref_caches, pos)
        xk = caches["xk"]
        logits, hidden, caches = model.decode(params, torch.from_numpy(tok), caches,
                                              torch.as_tensor(pos))
        assert caches["xk"] is xk
        _close(logits, w_logits)
        _close(hidden, w_hidden)
        _tree_close(caches, ref_caches)
        tok = np.argmax(w_logits, axis=-1).astype(np.int32)


def test_decode_consistent_with_prefill():
    """tests/test_arch_smoke.py::test_decode_consistent_with_prefill
    [whisper-medium] on the port's own draws: decode after prefilling
    T - 1 tokens == the teacher-forced logits at T - 1."""
    cfg = get_config(ARCH).smoke()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=CPU)
    toks = _tokens(cfg, 7)
    frames = _rand(np.random.default_rng(8), (B, cfg.enc_seq, cfg.d_model))
    full, _, _ = model.prefill(params, {"tokens": toks, "frames": frames}, cache_len=T)
    _, _, caches = model.prefill(params, {"tokens": toks[:, :-1], "frames": frames},
                                 cache_len=T)
    dec, _, _ = model.decode(params, torch.from_numpy(toks[:, -1]), caches, T - 1)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), rtol=2e-3, atol=2e-3)
    assert dec.shape == (B, cfg.padded_vocab) and bool(torch.isfinite(dec).all())


def test_frames_change_the_logits(whisper):
    """The decoder reads the encoder: other frames, other logits."""
    _, model, params, frames = whisper
    toks = _tokens(model.cfg, 4)
    a = model.prefill(params, {"tokens": toks, "frames": frames})[0]
    b = model.prefill(params, {"tokens": toks, "frames": frames[::-1].copy()})[0]
    assert float((a - b).abs().max()) > 1e-3


@pytest.mark.parametrize("phase", ["train_4k", "prefill_32k", "decode_32k"])
def test_specs_match_reference(phase):
    """``input_specs`` (``frames`` in the compute dtype) and ``cache_specs``
    against the reference's, shapes and dtypes."""
    model = build_model(get_config(ARCH).smoke())
    want = R.ref_model_specs(ARCH, phase, 2, 24)

    def plain(tree):
        if isinstance(tree, dict):
            return {k: plain(v) for k, v in tree.items()}
        assert tree.device.type == "meta"
        return (tuple(tree.shape), str(tree.dtype).removeprefix("torch."))

    got = plain(model.input_specs(SHAPES[phase], batch_override=2))
    assert got == want["inputs"]
    assert plain(model.cache_specs(2, 24)) == want["caches"]
    zeros = model.init_cache(2, 24, device=CPU)
    assert set(zeros) == {"k", "v", "xk", "xv"} and not zeros["xk"].any()
