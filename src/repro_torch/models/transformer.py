"""Decoder-only transformer covering the dense / MoE / SSM / hybrid
families: the parameters as ``nn.Module``s and the reference's forward,
prefill and decode as functions over them.

Block wiring by family (pre-norm residual):

  dense : x + attn(n1(x));  h + ffn(n2(h))
  moe   : x + attn(n1(x));  h + moe(n2(h)) [+ dense_ffn(n2(h)) if
          cfg.dense_residual — Arctic's dense+MoE parallel residual]
  ssm   : x + ssd(n1(x))                        (Mamba-2: mixer-only stack)
  hybrid: x + 0.5(na(attn(n1 x)) + ns(ssd(n1 x))); h + ffn(n2 h)  (Hymba)

The parameters are a :class:`Transformer` module whose names follow the
reference's key paths (``embed``, ``blocks.<i>.attn.wq``,
``blocks.<i>.moe.w_up``, ``blocks.<i>.ssm.A_log``, ``blocks.<i>.norm_a``,
``final_norm``, ``lm_head``), one :class:`Block` per layer in an
``nn.ModuleList`` (the reference stacks them on a leading axis for
``lax.scan``; here a Python loop runs them).  Weights are stored in
``cfg.param_dtype``, drawn in float32 and cast one tensor at a time.  In
the uniform families each layer casts its >=2-D float32 weights to the
compute dtype ``cfg.dtype`` as it runs, as the reference's scanned branch
does; the per-layer loop of the hybrid family's windowed and global
layers casts nothing, as the reference's does not, so each product runs
in the promotion of its operands' dtypes (bf16 activations times float32
weights give float32, and the residual stream is float32 from the first
layer on).

Caches are stacked (L, ...) tensors (``k``/``v`` (L, B, S, KV, hd),
``ssm`` (L, B, H, N, P), ``conv`` (L, B, CONV_W - 1, conv_dim)) when every
layer has the same window (the serving engine splices them on axis 1),
else a list of per-layer dicts (the hybrid family's windowed and global
layers).  The per-layer MoE load-balance terms are summed in ``forward``.
"""

from __future__ import annotations

import torch
from torch import nn

from . import attention as attn
from . import ffn as ffn_mod
from . import ssm as ssm_mod
from .common import DTYPES, compute_dtype, cross_entropy, dense_init, embed_init, rmsnorm

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
    """One layer: ``norm1`` and, by family, ``attn`` (wq, wk, wv, wo),
    ``norm2``, ``ffn`` (w_up, w_down[, w_gate]), ``moe`` (router, w_up,
    w_down[, w_gate]; experts stacked on a leading axis), ``ssm`` (the
    SSD mixer's weights), ``norm_a`` and ``norm_s``.  A tensor becomes a
    parameter of its name, a dict of tensors a sub-module of it."""

    def __init__(self, norm1, **parts):
        super().__init__()
        self.norm1 = nn.Parameter(norm1, requires_grad=False)
        for name, part in parts.items():
            if isinstance(part, dict):
                setattr(self, name, _Weights(part))
            else:
                setattr(self, name, nn.Parameter(part, requires_grad=False))


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


def init_block(generator, cfg, kind=None, device=None, dtype=torch.float32) -> Block:
    """One layer's params, drawn from ``generator`` in the reference's
    order of groups.  kind defaults to cfg.family; ``dtype`` is that of
    the >=2-D weights, each drawn in float32 and cast as it is drawn (the
    MoE router stays float32, as the reference draws it)."""
    kind = kind or cfg.family
    if kind not in ("dense", "moe", "ssm", "hybrid"):
        raise ValueError(kind)
    device = device if device is not None else generator.device
    D = cfg.d_model
    parts = {}
    if kind in ("dense", "moe", "hybrid"):
        parts["attn"] = attn.attn_params(generator, D, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                                         dtype=dtype, device=device)
        parts["norm2"] = _zeros((D,), device)
    if kind == "dense":
        parts["ffn"] = ffn_mod.dense_ffn_params(generator, D, cfg.d_ff, cfg.ffn_kind, dtype,
                                                device)
    if kind == "moe":
        parts["moe"] = ffn_mod.moe_params(generator, D, cfg.d_ff, cfg.n_experts, cfg.ffn_kind,
                                          dtype, device)
        if cfg.dense_residual:
            parts["ffn"] = ffn_mod.dense_ffn_params(generator, D, cfg.d_ff, cfg.ffn_kind,
                                                    dtype, device)
    if kind in ("ssm", "hybrid"):
        parts["ssm"] = ssm_mod.ssm_params(generator, cfg, dtype, device)
    if kind == "hybrid":
        parts["ffn"] = ffn_mod.dense_ffn_params(generator, D, cfg.d_ff, cfg.ffn_kind, dtype,
                                                device)
        parts["norm_a"] = _zeros((D,), device)
        parts["norm_s"] = _zeros((D,), device)
    return Block(_zeros((D,), device), **parts)


def init_params(generator, cfg, device=None) -> Transformer:
    """Random weights by the reference's rules, drawn in order (embedding,
    blocks, head) on the generator's device and placed on ``device``;
    each >=2-D weight but the router is stored in ``cfg.param_dtype`` as
    soon as it is drawn, so a bf16 model never holds more than one float32
    tensor at a time (the router is cast by ``registry._cast_params``)."""
    device = device if device is not None else generator.device
    pd = DTYPES[cfg.param_dtype]
    embed = embed_init(generator, (cfg.padded_vocab, cfg.d_model), pd, device)
    blocks = [init_block(generator, cfg, device=device, dtype=pd) for _ in range(cfg.n_layers)]
    head = None
    if not cfg.tie_embeddings:
        head = dense_init(generator, (cfg.d_model, cfg.padded_vocab), cfg.d_model, pd, device)
    return Transformer(embed, blocks, _zeros((cfg.d_model,), device), head)


def _layer_params(module: nn.Module, dt) -> dict:
    """A layer's weights as the reference's dict, >=2-D float32 weights
    cast to the compute dtype, and lower-precision ones to a float32
    compute dtype (where JAX promotes them in each product, exactly);
    ``dt`` None casts nothing."""
    out = {}
    for name, p in module.named_parameters(recurse=False):
        cast = (dt is not None and p.dim() > 1 and p.dtype != dt
                and torch.float32 in (p.dtype, dt))
        out[name] = p.to(dt) if cast else p
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


def _mix(a_out, s_out, bp, cfg):
    """The hybrid family's mixing of its attention and SSD branches."""
    return 0.5 * (rmsnorm(a_out, bp["norm_a"], cfg.norm_eps)
                  + rmsnorm(s_out, bp["norm_s"], cfg.norm_eps))


def _ffn(h2, bp, cfg, mesh):
    """The FFN sub-layer of the attention families: (out, aux)."""
    if cfg.family != "moe":
        return ffn_mod.dense_ffn(h2, bp["ffn"], cfg.ffn_kind), {}
    out, aux = ffn_mod.moe_ffn(h2, bp["moe"], cfg, mesh=mesh)
    if cfg.dense_residual:
        out = out + ffn_mod.dense_ffn(h2, bp["ffn"], cfg.ffn_kind)
    return out, aux


def block_forward(x, bp, cfg, mesh=None, *, positions, window=0, want_cache=False):
    """Full-sequence block. Returns (x, cache, aux)."""
    cache = {}
    fam = cfg.family
    h = rmsnorm(x, bp["norm1"], cfg.norm_eps)
    if fam in ("ssm", "hybrid"):
        s_out, s_state, conv_tail = ssm_mod.ssm_forward(h, bp["ssm"], cfg, cfg.ssm_chunk)
        if want_cache:
            cache["ssm"], cache["conv"] = s_state, conv_tail
        if fam == "ssm":
            return x + s_out, cache, {}
    a_out, (k, v) = attn.attention(
        h, bp["attn"], positions, causal=True, window=window, rope_theta=cfg.rope_theta,
    )
    if want_cache:
        cache["k"], cache["v"] = k, v
    x = x + (_mix(a_out, s_out, bp, cfg) if fam == "hybrid" else a_out)
    f_out, aux = _ffn(rmsnorm(x, bp["norm2"], cfg.norm_eps), bp, cfg, mesh)
    return x + f_out, cache, aux


def _tokens(tokens, params: Transformer) -> torch.Tensor:
    return torch.as_tensor(tokens, device=params.embed.device).long()


def _stack(caches: list) -> dict:
    """Per-layer cache dicts as one dict of (L, ...) tensors."""
    return {name: torch.stack([c[name] for c in caches]) for name in caches[0]}


def forward(params: Transformer, tokens, cfg, mesh=None, *, want_cache=False, remat=True):
    """Token ids (B, T) -> (hidden (B,T,D), caches, aux).  ``mesh`` and
    ``remat`` (sharding and rematerialisation in the reference) have no
    effect on one device; a mesh with a 'model' axis larger than 1 is
    refused by the MoE FFN."""
    dt = compute_dtype(cfg)
    tokens = _tokens(tokens, params)
    B, T = tokens.shape
    x = params.embed[tokens].to(dt)
    positions = torch.arange(T, device=x.device).expand(B, T)
    uniform = _uniform_family(cfg)
    caches = []
    lb = torch.zeros((), device=x.device)
    for li, block in enumerate(params.blocks):
        window = cfg.sliding_window if uniform else _layer_window(cfg, li)
        # the per-layer loop keeps the weights as stored (see the module doc)
        x, cache, aux = block_forward(x, _layer_params(block, dt if uniform else None), cfg, mesh,
                                      positions=positions, window=window,
                                      want_cache=want_cache)
        caches.append(cache)
        if "load_balance" in aux:
            lb = lb + aux["load_balance"]
    if uniform:
        caches = _stack(caches) if want_cache else {}
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    return x, caches, {"load_balance": lb}


def logits_fn(params: Transformer, hidden, cfg, mesh=None):
    w = params.embed.T if cfg.tie_embeddings else params.lm_head
    return hidden @ w.to(hidden.dtype)


def loss_fn(params: Transformer, batch, cfg, mesh=None):
    """Next-token CE (forward only), plus the MoE load-balance term.
    batch: {'tokens': (B,T), 'labels': (B,T)}."""
    hidden, _, aux = forward(params, batch["tokens"], cfg, mesh)
    logits = logits_fn(params, hidden, cfg, mesh)
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    loss = cross_entropy(logits, labels, cfg.vocab_size)
    if cfg.family == "moe":
        loss = loss + 0.01 * aux["load_balance"] / cfg.n_layers
    return loss, {"ce": loss, "hidden": hidden}


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def cache_spec(cfg, batch, seq_len):
    """Abstract cache structure (``device="meta"`` tensors): stacked when
    every layer has the same window, else one per layer."""
    dt = compute_dtype(cfg)
    fam = cfg.family

    def sds(shape):
        return torch.empty(shape, dtype=dt, device="meta")

    def one_layer(window, lead=()):
        c = {}
        if fam in ("dense", "moe", "hybrid"):
            size = min(seq_len, window) if window else seq_len
            c["k"] = sds(lead + (batch, size, cfg.n_kv_heads, cfg.hd))
            c["v"] = sds(lead + (batch, size, cfg.n_kv_heads, cfg.hd))
        if fam in ("ssm", "hybrid"):
            _, H, P, N, conv_dim, _ = ssm_mod.ssm_dims(cfg)
            c["ssm"] = sds(lead + (batch, H, N, P))
            c["conv"] = sds(lead + (batch, ssm_mod.CONV_W - 1, conv_dim))
        return c

    if _uniform_family(cfg):
        return one_layer(cfg.sliding_window, (cfg.n_layers,))
    return [one_layer(_layer_window(cfg, li)) for li in range(cfg.n_layers)]


def _zeros_like_spec(spec, device):
    """Zero tensors in the shapes and dtypes of a (nested) cache spec."""
    if isinstance(spec, list):
        return [_zeros_like_spec(s, device) for s in spec]
    if isinstance(spec, dict):
        return {k: _zeros_like_spec(s, device) for k, s in spec.items()}
    return torch.zeros(spec.shape, dtype=spec.dtype, device=device)


def init_cache(cfg, batch, seq_len, device=None):
    return _zeros_like_spec(cache_spec(cfg, batch, seq_len), device)


def block_decode(x1, bp, cfg, cache, pos, window=0, mesh=None):
    fam = cfg.family
    new_cache = dict(cache)
    h = rmsnorm(x1, bp["norm1"], cfg.norm_eps)
    if fam in ("ssm", "hybrid"):
        s_out, new_cache["ssm"], new_cache["conv"] = ssm_mod.ssm_decode(
            h, bp["ssm"], cfg, cache["ssm"], cache["conv"])
        if fam == "ssm":
            return x1 + s_out, new_cache
    a_out, kv = attn.decode_attention(
        h, bp["attn"], {"k": cache["k"], "v": cache["v"]}, pos,
        window=window, rope_theta=cfg.rope_theta,
    )
    new_cache["k"], new_cache["v"] = kv["k"], kv["v"]
    x1 = x1 + (_mix(a_out, s_out, bp, cfg) if fam == "hybrid" else a_out)
    f_out, _ = _ffn(rmsnorm(x1, bp["norm2"], cfg.norm_eps), bp, cfg, mesh)
    return x1 + f_out, new_cache


def decode(params: Transformer, token, caches, pos, cfg, mesh=None):
    """One decode step. token: (B,) integers; caches from init_cache or
    prefill (left unmodified).  Returns (logits (B, V), hidden (B, D),
    new caches)."""
    dt = compute_dtype(cfg)
    x = params.embed[_tokens(token, params)[:, None]].to(dt)
    pos = torch.as_tensor(pos, device=x.device)
    uniform = _uniform_family(cfg)
    new_caches = []
    for li, block in enumerate(params.blocks):
        if uniform:
            cache, window = {name: c[li] for name, c in caches.items()}, cfg.sliding_window
        else:
            cache, window = caches[li], _layer_window(cfg, li)
        x, nc = block_decode(x, _layer_params(block, dt if uniform else None), cfg, cache,
                             pos, window=window, mesh=mesh)
        new_caches.append(nc)
    if uniform:
        new_caches = _stack(new_caches)
    x = rmsnorm(x, params.final_norm, cfg.norm_eps)
    logits = logits_fn(params, x, cfg, mesh)
    return logits[:, 0], x[:, 0], new_caches


def prefill(params: Transformer, tokens, cfg, mesh=None, cache_len=None):
    """Prefill: forward with cache capture, padded to cache_len slots.
    Returns (logits last position (B, V), hidden (B,T,D), caches).  The
    SSM state and conv tail are kept as they are."""
    hidden, caches, _ = forward(params, tokens, cfg, mesh, want_cache=True)
    B, T = hidden.shape[:2]
    cache_len = cache_len or T

    def expand(c, window):
        out = dict(c)
        if "k" in c:
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
