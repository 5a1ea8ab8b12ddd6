"""Dense (SwiGLU / GELU) and Mixture-of-Experts FFN layers.

MoE dispatch, as the reference's (sort-based, MegaBlocks-style, fixed
shapes throughout): the assignments are sorted stably by expert id, each
one's rank in its expert's group comes from a running maximum of the
group starts, the first ``capacity`` of a group are kept (in the flat
(token, k) order, so the same assignments are dropped), and the kept rows
are packed into a fixed-capacity (E, C, D) buffer for batched per-expert
matrix products.  The router's top-k takes the experts in order of
falling probability, ties to the lower expert index (a stable sort, the
reference's tie rule).  The weighted expert outputs are combined by
gathering them into (T, k, D) and summing over k, an order that does not
change from run to run (a scatter-add with atomics would).

The reference's expert-parallel branch (a ``shard_map`` over the mesh's
'model' axis) has no counterpart on one device: a mesh whose 'model'
axis is larger than 1 raises.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import dense_init, matmul

__all__ = ["dense_ffn_params", "dense_ffn", "moe_params", "moe_ffn"]


# ---------------------------------------------------------------------------
# dense
# ---------------------------------------------------------------------------


def dense_ffn_params(generator, d_model, d_ff, kind="swiglu", dtype=torch.float32,
                     device=None) -> dict:
    p = {
        "w_up": dense_init(generator, (d_model, d_ff), d_model, dtype, device),
        "w_down": dense_init(generator, (d_ff, d_model), d_ff, dtype, device),
    }
    if kind == "swiglu":
        p["w_gate"] = dense_init(generator, (d_model, d_ff), d_model, dtype, device)
    return p


def _act(up, gate, kind):
    if kind == "swiglu":
        return F.silu(gate) * up
    return F.gelu(up, approximate="tanh")  # jax.nn.gelu's default


def dense_ffn(x, p, kind="swiglu"):
    up = matmul(x, p["w_up"])
    return matmul(_act(up, matmul(x, p["w_gate"]) if kind == "swiglu" else None, kind),
                  p["w_down"])


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def moe_params(generator, d_model, d_ff, n_experts, kind="swiglu", dtype=torch.float32,
               device=None) -> dict:
    """The router (float32, as the reference draws it) and the experts'
    stacked weights in ``dtype``."""
    p = {
        "router": dense_init(generator, (d_model, n_experts), d_model, torch.float32, device),
        "w_up": dense_init(generator, (n_experts, d_model, d_ff), d_model, dtype, device),
        "w_down": dense_init(generator, (n_experts, d_ff, d_model), d_ff, dtype, device),
    }
    if kind == "swiglu":
        p["w_gate"] = dense_init(generator, (n_experts, d_model, d_ff), d_model, dtype, device)
    return p


def _dispatch(ids, *, capacity, n_local, first_eid):
    """The fixed-capacity routing of ``_moe_local``: (sel_keep, sel_slot,
    flat) over the first n_local * capacity assignments in the order that
    keeps the kept ones first; ``flat`` is each selected row's index in the
    flat (token, k) order, ``sel_slot`` its row of the (E * C) buffer (E * C
    where dropped)."""
    Tk = ids.numel()
    EC = n_local * capacity
    dev = ids.device
    flat_e = ids.reshape(-1).long() - first_eid
    mine = (flat_e >= 0) & (flat_e < n_local)
    sort_key = torch.where(mine, flat_e, n_local)
    order = torch.argsort(sort_key, stable=True)
    e_s = sort_key[order]
    idx = torch.arange(Tk, device=dev)
    firsts = torch.ones(Tk, dtype=torch.bool, device=dev)
    firsts[1:] = e_s[1:] != e_s[:-1]
    group_start = torch.cummax(torch.where(firsts, idx, -1), 0).values
    rank = idx - group_start
    keep = (rank < capacity) & (e_s < n_local)
    # fixed-capacity compaction: all kept rows fit in EC slots
    sel = torch.argsort((~keep).int(), stable=True)[:EC]
    sel_keep = keep[sel]
    sel_slot = torch.where(sel_keep, e_s[sel] * capacity + rank[sel], EC)
    return sel_keep, sel_slot, order[sel]


def _moe_local(x, ids, wts, w_up, w_gate, w_down, *, capacity, n_local, first_eid,
               kind="swiglu"):
    """Sort-based dispatch -> per-expert matmuls -> weighted combine.

    x: (T, D); ids/wts: (T, k) global expert assignments; the caller owns
    experts [first_eid, first_eid + n_local). Fixed shapes throughout.
    """
    T, D = x.shape
    k = ids.shape[1]
    EC = n_local * capacity
    sel_keep, sel_slot, flat = _dispatch(ids, capacity=capacity, n_local=n_local,
                                         first_eid=first_eid)
    sel_tok = flat // k
    sel_w = torch.where(sel_keep, wts.reshape(-1)[flat], 0.0)

    x_sel = x[sel_tok] * sel_keep[:, None].to(x.dtype)
    buf = torch.zeros((EC + 1, D), dtype=x.dtype, device=x.device)
    buf[sel_slot] = x_sel  # dropped rows land on row EC, cut off below
    buf = buf[:EC].reshape(n_local, capacity, D)

    up = torch.bmm(buf, w_up)
    gate = torch.bmm(buf, w_gate) if kind == "swiglu" else None
    y = torch.bmm(_act(up, gate, kind), w_down).reshape(EC, D)

    y_sel = y[torch.clamp(sel_slot, max=EC - 1)]
    contrib = y_sel * (sel_w * sel_keep)[:, None].to(y.dtype)
    # each (token, k) pair has its own row: summing over k combines them in
    # an order that does not change from run to run
    rows = torch.zeros((T * k, D), dtype=x.dtype, device=x.device)
    rows[flat] = contrib
    return rows.reshape(T, k, D).sum(1)


def _top_k(probs, k):
    """jax.lax.top_k by a stable sort on (-prob, expert index)."""
    order = torch.argsort(-probs, dim=-1, stable=True)[:, :k]
    return torch.gather(probs, -1, order), order


def moe_ffn(x, p, cfg, mesh=None, ep_axis="model"):
    """MoE FFN. x: (B, T, D). Returns (out, aux) with the Switch
    load-balancing loss in aux."""
    B, T, D = x.shape
    E, k = cfg.n_experts, cfg.experts_per_token
    xf = x.reshape(B * T, D)

    # the router in float32 whatever the weights' dtype (the reference's
    # promotion of f32 @ bf16)
    logits = xf.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    top_w, top_i = _top_k(probs, k)
    top_w = (top_w / torch.sum(top_w, dim=-1, keepdim=True)).to(x.dtype)

    # Switch load-balance aux: E * sum_e f_e * p_e
    frac = torch.mean(torch.sum(F.one_hot(top_i, E).float(), dim=1), dim=0)
    aux = {"load_balance": E * torch.sum(frac * torch.mean(probs, dim=0))}

    kind = "swiglu" if "w_gate" in p else "gelu"
    tp = 1 if mesh is None else mesh.shape.get(ep_axis, 1)
    if tp > 1:
        raise NotImplementedError(
            f"expert parallelism over a '{ep_axis}' axis of {tp} is not ported "
            "(ROADMAP A17, item 7: sharding/*)")
    cap = max(4, math.ceil(B * T * k / E * cfg.moe_capacity_factor))
    out = _moe_local(xf, top_i, top_w, p["w_up"], p.get("w_gate"), p["w_down"],
                     capacity=cap, n_local=E, first_eid=0, kind=kind)
    return out.reshape(B, T, D), aux
