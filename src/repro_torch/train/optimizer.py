"""Optimizers: AdamW, Adafactor and the learning-rate schedules.

The reference's functional API:

    opt = make_optimizer(name, lr_schedule)
    state = opt.init(params)
    params, state, stats = opt.update(grads, state, params)

``params`` is the model's module, updated in place and returned;
``grads`` maps each parameter's name to its gradient; ``state`` is
updated in place and returned.  Updates run in float32 and are cast back
to each parameter's dtype.  Schedules are plain functions of the step,
computed in float32 as the reference computes them.

The reference stacks each per-layer weight of the L layers on a leading
axis and updates the stacked leaf; the port keeps one module a layer
(``models.registry.stacked_leaves`` pairs the two).  The optimizer state
keeps the reference's layout: one tensor a leaf, keyed by the leaf's
dotted key path (``"blocks.attn.wq"``), stacked (L, ...) where the
reference stacks, and a layer's parameter is updated from its row.
AdamW is elementwise apart from its global norm, so the layout does not
change its update.  Adafactor's update depends on the stacked shape in
two places, both held here: its RMS clip is one RMS over the whole
stacked leaf, and a leaf is factored by the last two dims of the stacked
shape, so a per-layer vector ((L, D) stacked) is factored from L = 32 on,
its column second moment then spanning the layers.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from ..models.registry import stacked_leaves

__all__ = ["Optimizer", "cosine_schedule", "wsd_schedule", "adamw", "adafactor",
           "global_norm", "make_optimizer"]

F32 = np.float32


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


def cosine_schedule(peak_lr, warmup, total):
    def lr(step) -> float:
        step = F32(step)
        if step < warmup:
            return float(F32(peak_lr) * step / F32(max(warmup, 1)))
        frac = np.clip((step - F32(warmup)) / F32(max(total - warmup, 1)), F32(0), F32(1))
        return float(F32(peak_lr * 0.5) * (F32(1) + np.cos(F32(np.pi) * frac)))

    return lr


def wsd_schedule(peak_lr, warmup, stable, decay, floor=0.1):
    """Warmup-Stable-Decay (MiniCPM, arXiv:2404.06395): linear warmup,
    long flat stage, short exponential-ish decay to floor*peak."""

    def lr(step) -> float:
        step = F32(step)
        if step < warmup:
            return float(F32(peak_lr) * step / F32(max(warmup, 1)))
        if step < warmup + stable:
            return float(F32(peak_lr))
        dec_frac = np.clip((step - F32(warmup) - F32(stable)) / F32(max(decay, 1)), F32(0),
                           F32(1))
        return float(F32(peak_lr) * np.power(F32(floor), dec_frac))

    return lr


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Optimizer:
    init: Callable  # (params) -> state
    update: Callable  # (grads, state, params) -> (params, state, stats)


def _zeros(shape, device) -> torch.Tensor:
    return torch.zeros(shape, dtype=torch.float32, device=device)


def _descend(p: torch.Tensor, delta: torch.Tensor) -> None:
    """``p - delta`` in float32, cast back to ``p``'s dtype, in place."""
    if p.dtype == torch.float32:
        p.sub_(delta)
    else:
        p.copy_(p.float() - delta)


def _rows(leaf, t: torch.Tensor) -> list:
    """A state tensor of ``leaf`` as one view a parameter."""
    return list(t.unbind(0)) if leaf.stacked else [t]


def adamw(lr_fn, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1, clip_norm=1.0):
    def init(params):
        leaves = stacked_leaves(params)
        dev = leaves[0].params[0].device
        return {"step": torch.zeros((), dtype=torch.int32),
                "m": {leaf.path: _zeros(leaf.shape, dev) for leaf in leaves},
                "v": {leaf.path: _zeros(leaf.shape, dev) for leaf in leaves}}

    @torch.no_grad()
    def update(grads, state, params):
        state["step"].add_(1)
        step = int(state["step"])
        gnorm = global_norm(grads)
        scale = torch.clamp(clip_norm / (gnorm + 1e-9), max=1.0) if clip_norm else 1.0
        lr = lr_fn(step)
        b1c = float(F32(1) - np.power(F32(b1), F32(step)))
        b2c = float(F32(1) - np.power(F32(b2), F32(step)))
        for leaf in stacked_leaves(params):
            for name, p, m, v in zip(leaf.names, leaf.params, _rows(leaf, state["m"][leaf.path]),
                                     _rows(leaf, state["v"][leaf.path])):
                g = grads[name].float() * scale
                m.mul_(b1).add_(g * (1 - b1))
                v.mul_(b2).add_(g.square_().mul_(1 - b2))
                delta = (m / b1c).div_((v / b2c).sqrt_().add_(eps))
                delta.add_(p.float() * weight_decay)
                _descend(p, delta.mul_(lr))
        return params, state, {"grad_norm": gnorm, "lr": lr}

    return Optimizer(init, update)


def adafactor(lr_fn, eps=1e-30, clip_threshold=1.0, decay_rate=0.8,
              weight_decay=0.0, min_dim_size_to_factor=32):
    """Adafactor (Shazeer & Stern): factored 2nd moments, no 1st moment."""

    def _factored(shape):
        return (len(shape) >= 2 and shape[-1] >= min_dim_size_to_factor
                and shape[-2] >= min_dim_size_to_factor)

    def _whole(leaf):
        """A stacked leaf of vectors is updated stacked: factored, its
        second moments couple the layers.  Other leaves go row by row."""
        return leaf.stacked and leaf.params[0].dim() < 2

    def init(params):
        def one(leaf):
            shape, dev = leaf.shape, leaf.params[0].device
            if _factored(shape):
                return {"vr": _zeros(shape[:-1], dev), "vc": _zeros(shape[:-2] + shape[-1:], dev)}
            return {"v": _zeros(shape, dev)}

        return {"step": torch.zeros((), dtype=torch.int32),
                "v": {leaf.path: one(leaf) for leaf in stacked_leaves(params)}}

    def moments(g, v, beta2, factored):
        """The second moments' update, in place."""
        g2 = torch.square(g).add_(eps)
        if factored:
            v["vr"].mul_(beta2).add_(g2.mean(-1) * (1 - beta2))
            v["vc"].mul_(beta2).add_(g2.mean(-2) * (1 - beta2))
        else:
            v["v"].mul_(beta2).add_(g2.mul_(1 - beta2))

    def direction(g, v, factored):
        """The update before clipping, from the updated moments."""
        if factored:
            vr, vc = v["vr"], v["vc"]
            norm = torch.clamp(vr.mean(-1, keepdim=True)[..., None], min=eps)
            denom = (vr[..., :, None] * vc[..., None, :]).div_(norm).sqrt_()
            return g / torch.clamp(denom, min=eps)
        return g / (v["v"] + eps).sqrt_()

    @torch.no_grad()
    def update(grads, state, params):
        state["step"].add_(1)
        step = int(state["step"])
        beta2 = float(F32(1) - np.power(F32(step), F32(-decay_rate)))
        lr = lr_fn(step)
        for leaf in stacked_leaves(params):
            node = state["v"][leaf.path]
            factored = _factored(leaf.shape)
            gs = [grads[n].float() for n in leaf.names]
            if _whole(leaf):
                ps, gs, rows = [torch.stack(leaf.params)], [torch.stack(gs)], [node]
            else:
                ps = list(leaf.params)
                rows = [dict(zip(node, r)) for r in zip(*(_rows(leaf, t) for t in node.values()))]
            # the RMS clip: one RMS over the whole leaf, layers included
            sumsq = 0.0
            for g, v in zip(gs, rows):
                moments(g, v, beta2, factored)
                sumsq = sumsq + torch.sum(torch.square(direction(g, v, factored)))
            rms = torch.sqrt(sumsq / float(np.prod(leaf.shape)) + 1e-12)
            div = torch.clamp(rms / clip_threshold, min=1.0)
            for p, g, v in zip(ps, gs, rows):
                u = direction(g, v, factored).div_(div)
                if weight_decay:
                    u.add_(p.float() * weight_decay)
                _descend(p, u.mul_(lr))
            if _whole(leaf):
                for q, row in zip(leaf.params, ps[0]):
                    q.copy_(row)
        return params, state, {"lr": lr}

    return Optimizer(init, update)


def global_norm(tensors) -> torch.Tensor:
    """The L2 norm over every tensor (a mapping's values or an iterable),
    in float32."""
    values = tensors.values() if isinstance(tensors, dict) else tensors
    return torch.sqrt(sum(torch.sum(torch.square(t.float())) for t in values))


def make_optimizer(name: str, lr_fn=None):
    lr_fn = lr_fn or cosine_schedule(3e-4, 100, 10_000)
    if name == "adamw":
        return adamw(lr_fn)
    if name == "adafactor":
        return adafactor(lr_fn)
    if name == "adamw_wsd":
        return adamw(wsd_schedule(3e-4, 100, 8_000, 1_900))
    raise ValueError(name)
