"""The decoder LM (``configs``, ``models.{common,attention,ffn,ssm,
transformer,registry}``) against the reference on the same weights.

For each of the four dense configs and the moe (arctic-480b, kimi-k2),
ssm (mamba2-1.3b) and hybrid (hymba-1.5b) ones, the reference's smoke
model (two layers, d_model 64, fp32 compute; the MoEs keep their bf16
``param_dtype``) is initialised by the reference, its parameter tree
carried into the port by ``params_from_reference``, and both run the same
numpy tokens: forward hidden states, logits and loss (with the MoE
load-balance term), prefill logits and caches, and decode steps agree
within rtol = atol = 1e-4 (the two frameworks sum the matrix products in
different orders; at this width that moves the fp32 outputs by ~1e-6).
The MoE FFN is also held against the reference where its capacity drops
assignments and at Kimi's top-8, and the hybrid family in bf16 (float32
weights) against the reference's promotion of each product.  The
encoder-decoder and VLM families have files of their own
(test_torch_encdec.py, test_torch_vlm.py); here they are built.
"""

import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
R = pytest.importorskip("_torch_parity")

from repro_torch.configs import CONFIGS, SHAPES, get_config, runnable  # noqa: E402
from repro_torch.models import attention as port_attention  # noqa: E402
from repro_torch.models.registry import build_model, param_count, params_from_reference  # noqa: E402

DENSE = ("minicpm-2b", "phi3-medium-14b", "starcoder2-3b", "yi-9b")
FAMILIES = ("arctic-480b", "kimi-k2-1t-a32b", "mamba2-1.3b", "hymba-1.5b")
TOL = dict(rtol=1e-4, atol=1e-4)
B, T = 2, 16
CPU = "cpu"


def _tokens(cfg, seed, shape=(B, T)):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)


@pytest.fixture(scope="module", params=DENSE + FAMILIES)
def pair(request):
    """(reference model, port model, port params) for one config."""
    ref = R.RefLM(request.param)
    cfg = get_config(request.param).smoke().scaled(n_layers=2)
    model = build_model(cfg)
    return ref, model, params_from_reference(ref.tree, cfg, device=CPU)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got.detach().float().numpy()), want,
                               **(tol or TOL))


def _caches_close(got, want):
    """Every cache tensor (k/v, ssm, conv), stacked or per layer."""
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _caches_close(g, w)
        return
    assert set(got) == set(want)
    for name in want:
        assert tuple(got[name].shape) == want[name].shape, name
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


def _ref_tensor(arr):
    return torch.from_numpy(np.array(arr, np.float32))


def _ref_dtype(arr):
    return torch.bfloat16 if arr.dtype.name == "bfloat16" else torch.float32


def test_params_from_reference_round_trip(pair):
    """Every leaf of the reference's tree under its key path in the port
    (``blocks.<i>.moe.w_up``, ``blocks.<i>.ssm.A_log``, ...), in its dtype."""
    ref, model, params = pair
    tree = ref.tree
    got = dict(params.named_parameters())
    assert param_count(params) == sum(a.size for a in _leaves(tree))
    for name in ("embed", "final_norm"):
        assert got[name].dtype == _ref_dtype(tree[name])
        assert torch.equal(got[name].float(), _ref_tensor(tree[name]))
    assert ("lm_head" in got) == ("lm_head" in tree)
    paths = set()
    for i in range(model.cfg.n_layers):
        for group, leaf in tree["blocks"].items():
            items = leaf.items() if isinstance(leaf, dict) else [(None, leaf)]
            for name, arr in items:
                path = f"blocks.{i}.{group}" + (f".{name}" if name else "")
                paths.add(path)
                t = got[path]
                assert t.dtype == _ref_dtype(arr), path
                assert torch.equal(t.float(), _ref_tensor(arr[i])), path
    assert paths == {k for k in got if k.startswith("blocks.")}


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
    if "k" in caches:
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


@pytest.mark.parametrize("arch", sorted(a for a in CONFIGS if a not in DENSE + FAMILIES))
def test_cross_attention_families_build_and_carry_across(arch):
    """whisper-medium (encdec) and llama-3.2-vision-11b (vlm), the last
    families to wait: ``build_model`` draws them, ``params_from_reference``
    carries the reference's tree across with every leaf, and both modules
    have the same parameters by name and shape.  test_torch_encdec.py and
    test_torch_vlm.py hold them against the reference."""
    from repro_torch.models import registry

    assert not registry._WAITING
    ref = R.RefLM(arch)
    cfg = get_config(arch).smoke().scaled(n_layers=2)
    model = build_model(cfg)
    params = params_from_reference(ref.tree, cfg, device=CPU)
    assert param_count(params) == sum(a.size for a in _leaves(ref.tree))
    drawn = model.init(torch.Generator().manual_seed(0), device=CPU)
    assert {n: tuple(t.shape) for n, t in drawn.named_parameters()} == \
        {n: tuple(t.shape) for n, t in params.named_parameters()}


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    experts_per_token: int
    moe_capacity_factor: float = 1.25


def _moe_weights(rng, D, F, E, kind):
    def w(shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    p = {"router": w((D, E), D), "w_up": w((E, D, F), D), "w_down": w((E, F, D), F)}
    if kind == "swiglu":
        p["w_gate"] = w((E, D, F), D)
    return p


@pytest.mark.parametrize("E,k,factor,kind", [
    (8, 2, 1.25, "swiglu"),    # the smoke MoEs' routing
    (8, 2, 0.25, "swiglu"),    # capacity binds: assignments are dropped
    (16, 8, 1.25, "swiglu"),   # Kimi's top-8 over 16 experts
    (16, 8, 0.25, "gelu"),     # top-8, drops, the GELU experts
])
def test_moe_ffn_matches_reference(E, k, factor, kind):
    """``moe_ffn`` of both packages on the same router, experts and inputs:
    the output and the load-balance term; where the capacity binds, the
    port drops assignments (the same ones: the outputs agree)."""
    from repro_torch.models import ffn

    rng = np.random.default_rng(E * k + int(factor * 4))
    cfg = MoECfg(E, k, factor)
    D, F_, Bx, Tx = 32, 48, 3, 24
    p = _moe_weights(rng, D, F_, E, kind)
    x = rng.standard_normal((Bx, Tx, D)).astype(np.float32)
    want, want_lb = R.ref_moe_ffn(x, p, cfg)
    got, aux = ffn.moe_ffn(torch.from_numpy(x), {n: torch.from_numpy(v) for n, v in p.items()},
                           cfg)
    _close(got, want)
    assert abs(float(aux["load_balance"]) - want_lb) <= 1e-5 * want_lb
    # the dispatch: kept assignments per expert at most the capacity
    cap = max(4, int(np.ceil(Bx * Tx * k / E * factor)))
    probs = torch.softmax(torch.from_numpy(x.reshape(-1, D) @ p["router"]), -1)
    _, ids = ffn._top_k(probs, k)
    keep, slot, _ = ffn._dispatch(ids, capacity=cap, n_local=E, first_eid=0)
    kept = int(keep.sum())
    assert kept == sum(min(cap, int((ids == e).sum())) for e in range(E))
    assert (kept < Bx * Tx * k) == (factor < 1)
    assert torch.equal(torch.sort(slot[keep]).values, torch.unique(slot[keep]))


def test_moe_top_k_breaks_ties_to_the_lower_expert():
    from repro_torch.models import ffn

    probs = torch.tensor([[0.1, 0.3, 0.3, 0.3], [0.25, 0.25, 0.25, 0.25]])
    w, i = ffn._top_k(probs, 2)
    assert i.tolist() == [[1, 2], [0, 1]] and torch.equal(w[:, 0], w[:, 1])


@pytest.mark.parametrize("dp", [1, 2])
def test_moe_expert_parallel_mesh_raises(dp):
    """The reference's shard_map branch on a (data dp, model 2) mesh: each
    (data shard, rank) partial is the one-device path, (dp, tp) = (1, 1),
    on the shard's rows, the rank's half of the experts and the ids
    shifted to them, at the per-shard capacity; the output is the ranks'
    sum in rank order, the shards in order.  Experts that do not split
    over the 'model' axis raise."""
    from repro_torch.core.distributed import make_mesh
    from repro_torch.models import ffn

    E, k, D, F, Bx, Tx = 4, 2, 8, 16, 2, 6
    p = {n: torch.from_numpy(v) for n, v in _moe_weights(np.random.default_rng(0), D, F, E,
                                                          "swiglu").items()}
    cfg = MoECfg(E, k, 0.75)  # a capacity that drops assignments
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((Bx, Tx, D)).astype(np.float32))
    out, _ = ffn.moe_ffn(x, p, cfg, mesh=make_mesh((dp, 2), ("data", "model"),
                                                   devices=[CPU] * (2 * dp)))
    xf = x.reshape(-1, D)
    w, ids = ffn._top_k(torch.softmax(xf @ p["router"], -1), k)
    w = w / w.sum(-1, keepdim=True)
    cap = max(4, math.ceil(Bx * Tx * k / dp / E * cfg.moe_capacity_factor))
    half, m = E // 2, Bx * Tx // dp
    want = []
    for d in range(dp):
        rows = slice(d * m, (d + 1) * m)
        parts = [ffn._moe(xf[rows], ids[rows] - r * half, w[rows],
                          *(p[n][r * half:(r + 1) * half] for n in ("w_up", "w_gate", "w_down")),
                          capacity=cap) for r in range(2)]
        want.append(parts[0] + parts[1])
    assert torch.equal(out.reshape(-1, D), torch.cat(want))
    with pytest.raises(ValueError, match="experts do not split"):
        ffn.moe_ffn(x, p, cfg, mesh=make_mesh((1, 3), ("data", "model"), devices=[CPU] * 3))


@pytest.mark.parametrize("T_prompt", [6, 12])
def test_hybrid_window_ring(T_prompt):
    """Hymba's smoke config (window 8, layer 0 global): a prompt of 12
    passes the window, so layer 1 keeps its last 8 positions rolled into
    the ring (position p at slot p % 8) while layer 0 keeps all 32 slots;
    the SSM state and conv tail carry over; ten decode steps wrap the
    ring, each equal to the reference's."""
    ref = R.RefLM("hymba-1.5b")
    cfg = ref.cfg
    model = build_model(cfg)
    params = params_from_reference(ref.tree, cfg, device=CPU)
    toks = _tokens(cfg, 8, (B, T_prompt))
    want = ref.prefill(toks, cache_len=32)
    logits, _, caches = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                                      cache_len=32)
    assert isinstance(caches, list) and caches[0]["k"].shape[1] == 32
    assert caches[1]["k"].shape[1] == cfg.sliding_window
    _close(logits, want[0])
    _caches_close(caches, want[2])
    ref_caches, tok = want[2], np.argmax(want[0], axis=-1).astype(np.int32)
    for i in range(10):
        w_logits, _, ref_caches = ref.decode(tok, ref_caches, T_prompt + i)
        logits, _, caches = model.decode(params, torch.from_numpy(tok), caches, T_prompt + i)
        _close(logits, w_logits)
        _caches_close(caches, ref_caches)
        tok = np.argmax(w_logits, axis=-1).astype(np.int32)


def _dtype_name(t):
    return str(t.dtype).removeprefix("torch.")


def _same_dtypes(got, want):
    """The port's caches (per layer) in the reference's dtypes, leaf by leaf."""
    assert [{k: _dtype_name(v) for k, v in c.items()} for c in got] == \
        [{k: v.dtype.name for k, v in c.items()} for c in want]


def test_hybrid_bf16_promotes_as_the_reference():
    """Hymba's smoke config in bf16 with float32 weights takes the per-layer
    loop (window 8, layer 0 global), where the reference casts no weight:
    each product runs in the promotion of its operands (bf16 x float32 ->
    float32), so from layer 0's residual on the stream is float32.  The
    port's hidden state, logits, prefill caches and three decode steps
    have the reference's dtypes and agree within TOL (rtol = atol = 1e-4);
    a port that casts the weights to bf16 is 0.01-0.06 off."""
    ref = R.RefLM("hymba-1.5b", dtype="bfloat16")
    cfg = ref.cfg
    assert cfg.param_dtype == "float32" and cfg.sliding_window and cfg.global_layers
    model = build_model(cfg)
    params = params_from_reference(ref.tree, cfg, device=CPU)
    toks, labels = _tokens(cfg, 1), _tokens(cfg, 2)
    want_loss, want_hidden, want_logits = ref.loss(toks, labels)
    loss, metrics = model.loss(params, {"tokens": torch.from_numpy(toks),
                                        "labels": torch.from_numpy(labels)})
    from repro_torch.models.transformer import logits_fn

    logits = logits_fn(params, metrics["hidden"], cfg)
    assert _dtype_name(metrics["hidden"]) == want_hidden.dtype.name
    assert _dtype_name(logits) == want_logits.dtype.name
    _close(metrics["hidden"], want_hidden)
    _close(logits, want_logits)
    assert abs(float(loss) - want_loss) <= 1e-4 * abs(want_loss)

    want = ref.prefill(toks, cache_len=T + 4)
    logits, hidden, caches = model.prefill(params, {"tokens": torch.from_numpy(toks)},
                                           cache_len=T + 4)
    _close(logits, want[0])
    _close(hidden, want[1])
    _same_dtypes(caches, want[2])
    _caches_close(caches, want[2])
    ref_caches, tok = want[2], np.argmax(want[0], axis=-1).astype(np.int32)
    for i in range(3):
        w_logits, w_hidden, ref_caches = ref.decode(tok, ref_caches, T + i)
        logits, hidden, caches = model.decode(params, torch.from_numpy(tok), caches, T + i)
        assert _dtype_name(logits) == w_logits.dtype.name
        _close(logits, w_logits)
        _close(hidden, w_hidden)
        _same_dtypes(caches, ref_caches)
        _caches_close(caches, ref_caches)
        tok = np.argmax(w_logits, axis=-1).astype(np.int32)


def test_bf16_init_casts_each_tensor_as_drawn():
    """A bf16 ``param_dtype`` (smoke Arctic): the parameters equal those of
    drawing the same model in float32 and casting every >=2-D weight
    afterwards — the per-tensor cast draws the same values."""
    cfg = get_config("arctic-480b").smoke()
    assert cfg.param_dtype == "bfloat16"
    a = build_model(cfg).init(torch.Generator().manual_seed(5), device=CPU)
    b = build_model(cfg.scaled(param_dtype="float32")).init(torch.Generator().manual_seed(5),
                                                            device=CPU)
    got, want = dict(a.named_parameters()), dict(b.named_parameters())
    assert set(got) == set(want)
    for name, w in want.items():
        w = w.to(torch.bfloat16) if w.dim() > 1 else w
        assert got[name].dtype == w.dtype and torch.equal(got[name], w), name
    assert got["blocks.0.moe.router"].dtype == torch.bfloat16
    assert got["blocks.1.moe.w_up"].shape == (cfg.n_experts, cfg.d_model, cfg.d_ff)


@pytest.mark.parametrize("arch", FAMILIES)
def test_new_families_decode_consistent_with_prefill(arch):
    """test_decode_consistent_with_prefill for the moe, ssm and hybrid smoke
    configs on the port's own draws.  The MoEs run with a capacity no
    expert can fill (factor E): at 1.25 the prefill's capacity drops
    assignments that the one-token decode keeps, by design."""
    cfg = get_config(arch).smoke()
    if cfg.family == "moe":
        cfg = cfg.scaled(moe_capacity_factor=float(cfg.n_experts))
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), device=CPU)
    toks = torch.from_numpy(_tokens(cfg, 7))
    logits_full, _, _ = model.prefill(params, {"tokens": toks}, cache_len=T)
    _, _, caches = model.prefill(params, {"tokens": toks[:, : T - 1]}, cache_len=T)
    logits_dec, _, _ = model.decode(params, toks[:, T - 1], caches, T - 1)
    np.testing.assert_allclose(logits_dec.numpy(), logits_full.numpy(), rtol=2e-3, atol=2e-3)


def test_entry_points_need_a_device_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None resolves to it")
    model = build_model(get_config("yi-9b").smoke().scaled(n_layers=1))
    for call in (lambda: model.init(torch.Generator()), lambda: model.init_cache(1, 8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
