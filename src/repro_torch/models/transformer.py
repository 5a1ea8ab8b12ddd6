"""Decoder-only transformer, dense family: the parameters as ``nn.Module``s
and the reference's forward, prefill and decode as functions over them.

Block wiring (pre-norm residual):

  dense : x + attn(n1(x));  h + ffn(n2(h))

The parameters are a :class:`Transformer` module whose names follow the
reference's key paths (``embed``, ``blocks.<i>.attn.wq``,
``blocks.<i>.ffn.w_up``, ``final_norm``, ``lm_head``), one
:class:`Block` per layer in an ``nn.ModuleList`` (the reference stacks
them on a leading axis for ``lax.scan``; here a Python loop runs them).
Weights are stored in ``cfg.param_dtype``; each layer casts its >=2-D
float32 weights to the compute dtype ``cfg.dtype`` as it runs, as the
reference does inside its layer scan.

KV caches are stacked (L, B, S, KV, hd) tensors when every layer has the
same window (the serving engine splices them on axis 1), else a list of
per-layer caches.  The MoE, SSM and hybrid families are not ported yet
(ROADMAP A17).
"""

from __future__ import annotations

import torch
from torch import nn

from . import attention as attn
from . import ffn as ffn_mod
from .common import compute_dtype, cross_entropy, dense_init, embed_init, rmsnorm

__all__ = [
    "Transformer",
    "Block",
    "init_block",
    "init_params",
    "block_forward",
    "forward",
    "logits_fn",
    "loss_fn",
    "cache_spec",
    "init_cache",
    "block_decode",
    "decode",
    "prefill",
    "expand_stacked",
]


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


class _Weights(nn.Module):
    """A module holding named tensors as parameters."""

    def __init__(self, tensors: dict):
        super().__init__()
        for name, t in tensors.items():
            self.register_parameter(name, nn.Parameter(t, requires_grad=False))


class Block(nn.Module):
    """One layer: ``norm1``, ``attn`` (wq, wk, wv, wo), ``norm2``, ``ffn``
    (w_up, w_down[, w_gate])."""

    def __init__(self, norm1, attn_w: dict, norm2, ffn_w: dict):
        super().__init__()
        self.norm1 = nn.Parameter(norm1, requires_grad=False)
        self.attn = _Weights(attn_w)
        self.norm2 = nn.Parameter(norm2, requires_grad=False)
        self.ffn = _Weights(ffn_w)


class Transformer(nn.Module):
    """``embed`` (V, D), ``blocks`` (L x :class:`Block`), ``final_norm``
    (D,) and, unless the embeddings are tied, ``lm_head`` (D, V)."""

    def __init__(self, embed, blocks, final_norm, lm_head=None):
        super().__init__()
        self.embed = nn.Parameter(embed, requires_grad=False)
        self.blocks = nn.ModuleList(blocks)
        self.final_norm = nn.Parameter(final_norm, requires_grad=False)
        if lm_head is not None:
            self.lm_head = nn.Parameter(lm_head, requires_grad=False)
        else:
            self.lm_head = None


def _zeros(shape, device):
    return torch.zeros(shape, dtype=torch.float32, device=device)


def init_block(generator, cfg, kind=None, device=None) -> Block:
    """One layer's params, drawn from ``generator``.  kind defaults to
    cfg.family (only 'dense' is ported)."""
    kind = kind or cfg.family
    if kind != "dense":
        raise NotImplementedError(f"family {kind!r} is not ported yet (ROADMAP A17)")
    device = device if device is not None else generator.device
    a = attn.attn_params(generator, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                         device=device)
    f = ffn_mod.dense_ffn_params(generator, cfg.d_model, cfg.d_ff, cfg.ffn_kind,
                                 device=device)
    return Block(_zeros((cfg.d_model,), device), a, _zeros((cfg.d_model,), device), f)


def init_params(generator, cfg, device=None) -> Transformer:
    """Random weights by the reference's rules, drawn in order (embedding,
    blocks, head) on the generator's device and placed on ``device``."""
    device = device if device is not None else generator.device
    embed = embed_init(generator, (cfg.padded_vocab, cfg.d_model), device=device)
    blocks = [init_block(generator, cfg, device=device) for _ in range(cfg.n_layers)]
    head = None
    if not cfg.tie_embeddings:
        head = dense_init(generator, (cfg.d_model, cfg.padded_vocab), cfg.d_model,
                          device=device)
    return Transformer(embed, blocks, _zeros((cfg.d_model,), device), head)


def _layer_params(module: nn.Module, dt) -> dict:
    """A layer's weights as the reference's dict, >=2-D float32 weights
    cast to the compute dtype."""
    out = {}
    for name, p in module.named_parameters(recurse=False):
        out[name] = p.to(dt) if (p.dtype == torch.float32 and p.dim() > 1) else p
    for name, child in module.named_children():
        out[name] = _layer_params(child, dt)
    return out


# ---------------------------------------------------------------------------
# forward (prefill / teacher forcing)
# ---------------------------------------------------------------------------


def _layer_window(cfg, layer_idx):
    """Sliding window for a layer (0 = full attention)."""
    if not cfg.sliding_window:
        return 0
    if layer_idx in cfg.global_layers:
        return 0
    return cfg.sliding_window


def _uniform_family(cfg):
    """Identical cache shapes across layers (stacked caches)."""
    return not (cfg.sliding_window and cfg.global_layers)


def block_forward(x, bp, cfg, mesh=None, *, positions, window=0, want_cache=False):
    """Full-sequence block. Returns (x, cache, aux)."""
    cache = {}
    h = rmsnorm(x, bp["norm1"], cfg.norm_eps)
    a_out, (k, v) = attn.attention(
        h, bp["attn"], positions, causal=True, window=window, rope_theta=cfg.rope_theta,
    )
    if want_cache:
        cache["k"], cache["v"] = k, v
    x = x + a_out
    h2 = rmsnorm(x, bp["norm2"], cfg.norm_eps)
    x = x + ffn_mod.dense_ffn(h2, bp["ffn"], cfg.ffn_kind)
    return x, cache, {}


def _tokens(tokens, params: Transformer) -> torch.Tensor:
    return torch.as_tensor(tokens, device=params.embed.device).long()


def forward(params: Transformer, tokens, cfg, mesh=None, *, want_cache=False, remat=True):
    """Token ids (B, T) -> (hidden (B,T,D), caches, aux).  ``mesh`` and
    ``remat`` (sharding and rematerialisation in the reference) have no
    effect on one device."""
    dt = compute_dtype(cfg)
    tokens = _tokens(tokens, params)
    B, T = tokens.shape
    x = params.embed[tokens].to(dt)
    positions = torch.arange(T, device=x.device).expand(B, T)
    uniform = _uniform_family(cfg)
    caches = []
    for li, block in enumerate(params.blocks):
        window = cfg.sliding_window if uniform else _layer_window(cfg, li)
        x, cache, _ = block_forward(x, _layer_params(block, dt), cfg, positions=positions,
                                    window=window, want_cache=want_cache)
        caches.append(cache)
    if uniform:
        caches = ({"k": torch.stack([c["k"] for c in caches]),
                   "v": torch.stack([c["v"] for c in caches])} if want_cache else {})
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    return x, caches, {"load_balance": torch.zeros((), device=x.device)}


def logits_fn(params: Transformer, hidden, cfg, mesh=None):
    w = params.embed.T if cfg.tie_embeddings else params.lm_head
    return hidden @ w.to(hidden.dtype)


def loss_fn(params: Transformer, batch, cfg, mesh=None):
    """Next-token CE (forward only). batch: {'tokens': (B,T), 'labels': (B,T)}."""
    hidden, _, _ = forward(params, batch["tokens"], cfg, mesh)
    logits = logits_fn(params, hidden, cfg, mesh)
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    loss = cross_entropy(logits, labels, cfg.vocab_size)
    return loss, {"ce": loss, "hidden": hidden}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def cache_spec(cfg, batch, seq_len):
    """Abstract cache structure (``device="meta"`` tensors): stacked when
    every layer has the same window, else one per layer."""
    dt = compute_dtype(cfg)

    def one_layer(window, lead=()):
        size = min(seq_len, window) if window else seq_len
        shape = lead + (batch, size, cfg.n_kv_heads, cfg.hd)
        return {"k": torch.empty(shape, dtype=dt, device="meta"),
                "v": torch.empty(shape, dtype=dt, device="meta")}

    if _uniform_family(cfg):
        return one_layer(cfg.sliding_window, (cfg.n_layers,))
    return [one_layer(_layer_window(cfg, li)) for li in range(cfg.n_layers)]


def _zeros_like_spec(spec, device):
    if isinstance(spec, list):
        return [_zeros_like_spec(s, device) for s in spec]
    return {k: torch.zeros(s.shape, dtype=s.dtype, device=device) for k, s in spec.items()}


def init_cache(cfg, batch, seq_len, device=None):
    return _zeros_like_spec(cache_spec(cfg, batch, seq_len), device)


def block_decode(x1, bp, cfg, cache, pos, window=0, mesh=None):
    new_cache = dict(cache)
    h = rmsnorm(x1, bp["norm1"], cfg.norm_eps)
    a_out, kv = attn.decode_attention(
        h, bp["attn"], {"k": cache["k"], "v": cache["v"]}, pos,
        window=window, rope_theta=cfg.rope_theta,
    )
    new_cache["k"], new_cache["v"] = kv["k"], kv["v"]
    x1 = x1 + a_out
    h2 = rmsnorm(x1, bp["norm2"], cfg.norm_eps)
    x1 = x1 + ffn_mod.dense_ffn(h2, bp["ffn"], cfg.ffn_kind)
    return x1, new_cache


def decode(params: Transformer, token, caches, pos, cfg, mesh=None):
    """One decode step. token: (B,) integers; caches from init_cache or
    prefill (left unmodified).  Returns (logits (B, V), hidden (B, D),
    new caches)."""
    dt = compute_dtype(cfg)
    x = params.embed[_tokens(token, params)[:, None]].to(dt)
    pos = torch.as_tensor(pos, device=x.device)
    if _uniform_family(cfg):
        ks, vs = [], []
        for li, block in enumerate(params.blocks):
            x, nc = block_decode(x, _layer_params(block, dt), cfg,
                                 {"k": caches["k"][li], "v": caches["v"][li]}, pos,
                                 window=cfg.sliding_window)
            ks.append(nc["k"])
            vs.append(nc["v"])
        new_caches = {"k": torch.stack(ks), "v": torch.stack(vs)}
    else:
        new_caches = []
        for li, block in enumerate(params.blocks):
            x, nc = block_decode(x, _layer_params(block, dt), cfg, caches[li], pos,
                                 window=_layer_window(cfg, li))
            new_caches.append(nc)
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    logits = logits_fn(params, x, cfg, mesh)
    return logits[:, 0], x[:, 0], new_caches


def prefill(params: Transformer, tokens, cfg, mesh=None, cache_len=None):
    """Prefill: forward with cache capture, padded to cache_len slots.
    Returns (logits last position (B, V), hidden (B,T,D), caches)."""
    hidden, caches, _ = forward(params, tokens, cfg, mesh, want_cache=True)
    B, T = hidden.shape[:2]
    cache_len = cache_len or T

    def expand(c, window):
        out = dict(c)
        size = min(cache_len, window) if window else cache_len
        pad = size - T
        if pad > 0:
            out["k"] = torch.nn.functional.pad(c["k"], (0, 0, 0, 0, 0, pad))
            out["v"] = torch.nn.functional.pad(c["v"], (0, 0, 0, 0, 0, pad))
        elif pad < 0:
            # keep the last `size` positions; ring invariant: position
            # p lives at slot p % size
            out["k"] = torch.roll(c["k"][:, -size:], T % size, dims=1)
            out["v"] = torch.roll(c["v"][:, -size:], T % size, dims=1)
        return out

    if _uniform_family(cfg):
        caches = expand_stacked(caches, cfg, T, cache_len)
    else:
        caches = [expand(c, _layer_window(cfg, li)) for li, c in enumerate(caches)]
    logits = logits_fn(params, hidden[:, -1:], cfg, mesh)
    return logits[:, 0], hidden, caches


def expand_stacked(caches, cfg, T, cache_len):
    """Stacked caches padded (or cut) to the cache's slots.  A windowed
    prompt longer than the window keeps its last ``size`` positions
    without the roll that the per-layer path applies: the reference's own
    behaviour, copied."""
    out = dict(caches)
    if "k" in caches:
        window = cfg.sliding_window
        size = min(cache_len, window) if window else cache_len
        pad = size - T
        if pad > 0:
            out["k"] = torch.nn.functional.pad(caches["k"], (0, 0, 0, 0, 0, pad))
            out["v"] = torch.nn.functional.pad(caches["v"], (0, 0, 0, 0, 0, pad))
        elif pad < 0:
            out["k"] = caches["k"][:, :, pad:]
            out["v"] = caches["v"][:, :, pad:]
    return out
