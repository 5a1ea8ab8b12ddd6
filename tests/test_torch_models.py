"""The dense LM (``configs``, ``models.{common,attention,ffn,transformer,
registry}``) against the reference on the same weights.

For each of the four dense configs the reference's smoke model (two
layers, d_model 64, fp32) is initialised by the reference, its parameter
tree carried into the port by ``params_from_reference``, and both run
the same numpy tokens: forward hidden states, logits and loss, prefill
logits and caches, and decode steps agree within rtol = atol = 1e-4 (the
two frameworks sum the matrix products in different orders; at this
width that moves the fp32 outputs by ~1e-6).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
R = pytest.importorskip("_torch_parity")

from repro_torch.configs import CONFIGS, SHAPES, get_config, runnable  # noqa: E402
from repro_torch.models import attention as port_attention  # noqa: E402
from repro_torch.models.registry import build_model, param_count, params_from_reference  # noqa: E402

DENSE = ("minicpm-2b", "phi3-medium-14b", "starcoder2-3b", "yi-9b")
TOL = dict(rtol=1e-4, atol=1e-4)
B, T = 2, 16
CPU = "cpu"


def _tokens(cfg, seed, shape=(B, T)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


@pytest.fixture(scope="module", params=DENSE)
def pair(request):
    """(reference model, port model, port params) for one dense config."""
    ref = R.RefLM(request.param)
    cfg = get_config(request.param).smoke().scaled(n_layers=2)
    model = build_model(cfg)
    return ref, model, params_from_reference(ref.tree, cfg, device=CPU)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().float().numpy()), want,
                               **(tol or TOL))


def _caches_close(got, want):
    for name in ("k", "v"):
        _close(got[name], want[name])


def test_configs_are_the_references():
    """Every config, its smoke variant, padded vocabulary and shape skips
    are the reference's."""
    ref = R.ref_configs()
    assert set(CONFIGS) == set(ref.CONFIGS)
    for name, cfg in CONFIGS.items():
        want = ref.CONFIGS[name]
        assert dataclasses.asdict(cfg) == dataclasses.asdict(want), name
        assert cfg.padded_vocab == want.padded_vocab
        assert dataclasses.asdict(cfg.smoke()) == dataclasses.asdict(want.smoke())
        for shape in SHAPES.values():
            assert runnable(cfg, shape) == ref.runnable(want, ref.SHAPES[shape.name])
    assert {k: dataclasses.asdict(v) for k, v in SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in ref.SHAPES.items()}


def test_params_from_reference_round_trip(pair):
    ref, model, params = pair
    tree = ref.tree
    got = dict(params.named_parameters())
    assert param_count(params) == sum(a.size for a in _leaves(tree))
    assert torch.equal(got["embed"], torch.tensor(tree["embed"]))
    assert torch.equal(got["final_norm"], torch.tensor(tree["final_norm"]))
    assert ("lm_head" in got) == ("lm_head" in tree)
    for i in range(model.cfg.n_layers):
        for group in ("attn", "ffn"):
            for name, arr in tree["blocks"][group].items():
                t = got[f"blocks.{i}.{group}.{name}"]
                assert t.dtype == torch.float32
                assert torch.equal(t, torch.tensor(arr[i]))
        for name in ("norm1", "norm2"):
            assert torch.equal(got[f"blocks.{i}.{name}"],
                               torch.tensor(tree["blocks"][name][i]))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_forward_logits_and_loss(pair):
    ref, model, params = pair
    toks, labels = _tokens(model.cfg, 1), _tokens(model.cfg, 2)
    labels[0, :3] = model.cfg.padded_vocab - 1  # padded ids: masked out of the CE
    want_loss, want_hidden, want_logits = ref.loss(toks, labels)
    loss, metrics = model.loss(params, {"tokens": torch.from_numpy(toks),
                                        "labels": torch.from_numpy(labels)})
    _close(metrics["hidden"], want_hidden)
    from repro_torch.models.transformer import logits_fn

    _close(logits_fn(params, metrics["hidden"], model.cfg), want_logits)
    assert abs(float(loss) - want_loss) <= 1e-4 * abs(want_loss)


def test_prefill_and_decode(pair):
    ref, model, params = pair
    toks = _tokens(model.cfg, 3)
    want = ref.prefill(toks, cache_len=T + 4)
    logits, hidden, caches = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                                           cache_len=T + 4)
    _close(logits, want[0])
    _close(hidden, want[1])
    _caches_close(caches, want[2])
    assert caches["k"].shape == (model.cfg.n_layers, B, T + 4, model.cfg.n_kv_heads,
                                 model.cfg.hd)
    ref_caches = want[2]
    tok = np.argmax(want[0], axis=-1).astype(np.int32)
    for i in range(3):
        pos = T + i
        w_logits, w_hidden, ref_caches = ref.decode(tok, ref_caches, pos)
        logits, hidden, caches = model.decode(params, torch.from_numpy(tok), caches, pos)
        _close(logits, w_logits)
        _close(hidden, w_hidden)
        _caches_close(caches, ref_caches)
        tok = np.argmax(w_logits, axis=-1).astype(np.int32)


def test_decode_with_per_slot_positions(pair):
    """Continuous batching: each slot at its own position."""
    ref, model, params = pair
    toks = _tokens(model.cfg, 4)
    want = ref.prefill(toks, cache_len=T + 4)
    _, _, caches = model.prefill(params, {"tokens": torch.from_numpy(toks)}, cache_len=T + 4)
    tok = np.array([5, 9], np.int32)
    pos = np.array([T - 3, T], np.int32)
    w_logits, _, w_caches = ref.decode(tok, want[2], pos)
    logits, _, caches = model.decode(params, torch.from_numpy(tok), caches,
                                     torch.from_numpy(pos))
    _close(logits, w_logits)
    _caches_close(caches, w_caches)


def test_chunked_attention_path(pair, monkeypatch):
    """The KV-chunked path (taken from CHUNKED_THRESHOLD keys on), with the
    threshold lowered in both packages."""
    ref, model, params = pair
    toks = _tokens(model.cfg, 5)
    monkeypatch.setattr(port_attention, "CHUNKED_THRESHOLD", 8)
    with R.ref_chunked_threshold(8):
        want = ref.prefill(toks, cache_len=T)
    logits, hidden, caches = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                                           cache_len=T)
    _close(logits, want[0])
    _close(hidden, want[1])
    _caches_close(caches, want[2])


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 17), (True, 1)])
@pytest.mark.parametrize("Bc,Tc,S,H,KV,hd,ck", [
    (2, 32, 32, 8, 2, 16, 8),
    (1, 48, 48, 4, 4, 8, 16),   # MHA, non-multiple handled by pad
    (1, 40, 40, 6, 2, 8, 16),   # S % ck != 0
])
def test_kv_chunked_context_matches_reference(causal, window, Bc, Tc, S, H, KV, hd, ck):
    """tests/test_chunked_attention.py's shapes (window 1: fully masked
    chunks), the port against the reference on the same inputs."""
    rng = np.random.default_rng(Bc * Tc + H)
    q = rng.standard_normal((Bc, Tc, H, hd)).astype(np.float32)
    k = rng.standard_normal((Bc, S, KV, hd)).astype(np.float32)
    v = rng.standard_normal((Bc, S, KV, hd)).astype(np.float32)
    want = R.ref_kv_chunked_context(q, k, v, causal=causal, window=window, ck=ck)
    got = port_attention._kv_chunked_context(torch.from_numpy(q), torch.from_numpy(k),
                                             torch.from_numpy(v), causal=causal,
                                             window=window, ck=ck)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("T_prompt", [5, 12])
def test_sliding_window_ring(T_prompt):
    """scaled(sliding_window=8): the ring cache of 8 slots.  A prompt of 5
    fills part of the ring and decode wraps it.  A prompt of 12 is cut by
    the reference's expand_stacked, copied: ``[:, :, size - T:]`` keeps
    the last T - size = 4 positions (not the last 8), in order, without
    the roll the per-layer path applies, and decode goes on from that
    ring of 4."""
    arch = "yi-9b"
    ref = R.RefLM(arch, sliding_window=8)
    cfg = get_config(arch).smoke().scaled(n_layers=2, sliding_window=8)
    model = build_model(cfg)
    params = params_from_reference(ref.tree, cfg, device=CPU)
    toks = _tokens(cfg, 6, (B, T_prompt))
    want = ref.prefill(toks, cache_len=32)
    logits, _, caches = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                                      cache_len=32)
    assert caches["k"].shape[2] == (8 if T_prompt <= 8 else T_prompt - 8)
    _close(logits, want[0])
    _caches_close(caches, want[2])
    if T_prompt > 8:  # the last T - 8 positions, in order, not rolled
        from repro_torch.models.transformer import forward

        _, full, _ = forward(params, torch.from_numpy(toks), cfg, want_cache=True)
        assert torch.equal(caches["k"], full["k"][:, :, 8 - T_prompt:])
    ref_caches, tok = want[2], np.argmax(want[0], axis=-1).astype(np.int32)
    for i in range(10):
        w_logits, _, ref_caches = ref.decode(tok, ref_caches, T_prompt + i)
        logits, _, caches = model.decode(params, torch.from_numpy(tok), caches, T_prompt + i)
        _close(logits, w_logits)
        _caches_close(caches, ref_caches)
        tok = np.argmax(w_logits, axis=-1).astype(np.int32)


def test_decode_consistent_with_prefill():
    """tests/test_arch_smoke.py::test_decode_consistent_with_prefill on the
    port (yi-9b's smoke config, the port's own draws): greedy decode after
    prefilling T - 1 tokens == the teacher-forced logits at T - 1."""
    cfg = get_config("yi-9b").smoke()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=CPU)
    toks = torch.from_numpy(_tokens(cfg, 7))
    logits_full, _, _ = model.prefill(params, {"tokens": toks}, cache_len=T)
    _, _, caches = model.prefill(params, {"tokens": toks[:, : T - 1]}, cache_len=T)
    logits_dec, _, _ = model.decode(params, toks[:, T - 1], caches, T - 1)
    np.testing.assert_allclose(logits_dec.numpy(), logits_full.numpy(), rtol=2e-3, atol=2e-3)


def test_init_follows_the_reference_rules():
    """Random init by the reference's rules: truncated normal on [-3, 3]
    over sqrt(fan_in), embeddings N(0, 0.02), zero norms; the same seed
    draws the same weights; input and cache specs on the meta device."""
    cfg = get_config("yi-9b").smoke().scaled(n_layers=2)
    model = build_model(cfg)
    a = model.init(torch.Generator().manual_seed(3), device=CPU)
    b = model.init(torch.Generator().manual_seed(3), device=CPU)
    for (na, ta), (_, tb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(ta, tb), na
    wq = a.blocks[0].attn.wq
    assert wq.shape == (cfg.d_model, cfg.n_heads, cfg.hd)
    assert float(wq.abs().max()) <= 3.0 / np.sqrt(cfg.d_model) + 1e-6
    assert abs(float(wq.std()) * np.sqrt(cfg.d_model) - 0.9866) < 0.05  # truncated N(0, 1)
    assert abs(float(a.embed.std()) - 0.02) < 0.002
    assert not a.blocks[1].norm2.any() and a.embed.shape[0] == cfg.padded_vocab
    specs = model.input_specs(SHAPES["decode_32k"], batch_override=2)
    assert specs["caches"]["k"].device.type == "meta"
    assert specs["caches"]["k"].shape == (2, 2, 32_768, cfg.n_kv_heads, cfg.hd)
    assert model.input_specs(SHAPES["train_4k"], 2)["batch"]["labels"].shape == (2, 4096)
    tied = build_model(get_config("minicpm-2b").smoke().scaled(n_layers=1))
    assert tied.init(torch.Generator(), device=CPU).lm_head is None


@pytest.mark.parametrize("arch", sorted(a for a in CONFIGS if a not in DENSE))
def test_unported_families_raise(arch):
    cfg = get_config(arch).smoke()
    with pytest.raises(NotImplementedError, match="ROADMAP A17"):
        build_model(cfg)


def test_entry_points_need_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    model = build_model(get_config("yi-9b").smoke().scaled(n_layers=1))
    for call in (lambda: model.init(torch.Generator()), lambda: model.init_cache(1, 8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
