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

One function, ``_moe``, runs both the one-device path and expert
parallelism (a mesh whose 'model' axis has tp > 1), the reference's
``shard_map`` branch on the single controller: the rows are cut into the
data shards of ``dp_axes`` in order, each with its own capacity
``max(4, ceil(rows · k / dp / E · factor))``; EP rank ``r`` owns experts
[r · E/tp, (r + 1) · E/tp), and every (data shard, rank) pair is routed
as the reference's ``_moe_local`` routes it.  The pairs run batched: one
dispatch over all of them, and each expert's products over the rows of
every data shard at once, so its weights are read once.  The ranks'
partial outputs are summed in rank order (the reference's ``psum``) and
the data shards concatenated in order.  One device is the case
(dp, tp) = (1, 1).  The capacity is per data shard, so the assignments
dropped differ from the one-device path's, as in the reference.  The
layout of ``moe_reduce_scatter`` (the output left sequence-sharded) gives
the same values and needs no branch here.
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
    """The fixed-capacity routing of one (data shard, EP rank) pair:
    (sel_keep, sel_slot, flat) over the first n_local * capacity
    assignments in the order that keeps the kept ones first; ``flat`` is
    each selected row's index in the flat (token, k) order, ``sel_slot``
    its row of the (E * C) buffer (E * C where dropped).  ``ids`` (..., T,
    k): leading dims are independent groups (``first_eid`` a scalar, or a
    tensor of shape (..., 1)), each routed on its own."""
    lead = ids.shape[:-2]
    Tk = ids.shape[-2] * ids.shape[-1]
    EC = n_local * capacity
    dev = ids.device
    flat_e = ids.reshape(*lead, Tk).long() - first_eid
    mine = (flat_e >= 0) & (flat_e < n_local)
    sort_key = torch.where(mine, flat_e, n_local)
    order = torch.argsort(sort_key, dim=-1, stable=True)
    e_s = torch.gather(sort_key, -1, order)
    idx = torch.arange(Tk, device=dev).expand_as(e_s)
    firsts = torch.ones(e_s.shape, dtype=torch.bool, device=dev)
    firsts[..., 1:] = e_s[..., 1:] != e_s[..., :-1]
    group_start = torch.cummax(torch.where(firsts, idx, -1), -1).values
    rank = idx - group_start
    keep = (rank < capacity) & (e_s < n_local)
    # fixed-capacity compaction: all kept rows fit in EC slots
    sel = torch.argsort((~keep).int(), dim=-1, stable=True)[..., :EC]
    sel_keep = torch.gather(keep, -1, sel)
    sel_slot = torch.where(sel_keep, torch.gather(e_s, -1, sel) * capacity
                           + torch.gather(rank, -1, sel), EC)
    return sel_keep, sel_slot, torch.gather(order, -1, sel)


def _top_k(probs, k):
    """jax.lax.top_k by a stable sort on (-prob, expert index)."""
    order = torch.argsort(-probs, dim=-1, stable=True)[:, :k]
    return torch.gather(probs, -1, order), order


def moe_ffn(x, p, cfg, mesh=None, dp_axes=("data",), ep_axis="model"):
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
    # one device (tp = 1) is one data shard that owns every expert
    dp = 1 if tp == 1 else math.prod(mesh.shape[a] for a in dp_axes)
    if E % tp:
        raise ValueError(f"{E} experts do not split over an expert-parallel axis of {tp}")
    if (B * T) % dp:
        raise ValueError(f"{B * T} rows do not split over {dp} data shards")
    cap = max(4, math.ceil(B * T * k / dp / E * cfg.moe_capacity_factor))
    out = _moe(xf, top_i, top_w, p["w_up"], p.get("w_gate"), p["w_down"], capacity=cap,
               dp=dp, tp=tp, kind=kind)
    return out.reshape(B, T, D), aux


def _moe(xf, ids, wts, w_up, w_gate, w_down, *, capacity, dp=1, tp=1, kind="swiglu"):
    """Sort-based dispatch -> per-expert matmuls -> weighted combine, as
    the reference's ``shard_map`` over (dp_axes, ep_axis) runs its
    ``_moe_local``: every (data shard, EP rank) pair routes the shard's
    rows to the rank's experts as its own call would, all pairs at once
    (each pair a group of the batched dispatch, each expert's products
    over the rows of every data shard at once).  (dp, tp) = (1, 1) is the
    one-device path.

    xf: (rows, D); ids/wts: (rows, k) assignments to the E experts of the
    weights (an id outside [0, E) is no rank's).  Returns (rows, D): the
    ranks' partials summed in rank order, the data shards in order.  Fixed
    shapes throughout."""
    E, k = w_up.shape[0], ids.shape[1]
    n_local = E // tp
    rows, D = xf.shape
    m, G = rows // dp, dp * tp
    dev = xf.device
    xs = xf.reshape(dp, m, D)
    shard = torch.arange(dp, device=dev).repeat_interleave(tp)  # group -> data shard
    first = (torch.arange(tp, device=dev) * n_local).repeat(dp)[:, None]  # group -> 1st expert
    sel_keep, sel_slot, flat = _dispatch(ids.reshape(dp, m, k)[shard], capacity=capacity,
                                         n_local=n_local, first_eid=first)
    g = torch.arange(G, device=dev)[:, None]
    sel_tok = flat // k
    sel_w = torch.where(sel_keep, wts.reshape(dp, m * k)[shard[:, None], flat], 0.0)

    # every expert's rows of all data shards in one (E, dp · C, D) buffer, so
    # that each expert's weights are read once: local slot e · C + c of
    # group (shard d, rank r) is row d · C + c of expert r · n_local + e
    rows_e = dp * capacity
    expert = first + torch.div(sel_slot, capacity, rounding_mode="floor")
    slot = torch.where(sel_keep,
                       expert * rows_e + shard[:, None] * capacity + sel_slot % capacity,
                       E * rows_e)
    x_sel = xs[shard[:, None], sel_tok] * sel_keep[..., None].to(xf.dtype)
    buf = torch.zeros((E * rows_e + 1, D), dtype=xf.dtype, device=dev)
    buf[slot] = x_sel  # dropped rows land on the last row, cut off below
    buf = buf[:-1].reshape(E, rows_e, D)

    up = torch.bmm(buf, w_up)
    gate = torch.bmm(buf, w_gate) if kind == "swiglu" else None
    y = torch.bmm(_act(up, gate, kind), w_down).reshape(E * rows_e, D)

    y_sel = y[torch.clamp(slot, max=E * rows_e - 1)]
    contrib = y_sel * (sel_w * sel_keep)[..., None].to(y.dtype)
    # each (token, k) pair has its own row: summing over k combines them in
    # an order that does not change from run to run
    part = torch.zeros((G, m * k, D), dtype=xf.dtype, device=dev)
    part[g, flat] = contrib
    part = part.reshape(dp, tp, m, k, D).sum(3)
    total = part[:, 0]
    for r in range(1, tp):  # the reference's psum over the ranks, in rank order
        total = total + part[:, r]
    return total.reshape(rows, D)
