"""Dense (SwiGLU / GELU) FFN layers.

The Mixture-of-Experts FFN (``moe_params``, ``moe_ffn``) is not ported
yet (ROADMAP A17): ``models.registry.build_model`` refuses the ``moe``
family until it is.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import dense_init

__all__ = ["dense_ffn_params", "dense_ffn"]


def dense_ffn_params(generator, d_model, d_ff, kind="swiglu", dtype=torch.float32,
                     device=None) -> dict:
    p = {
        "w_up": dense_init(generator, (d_model, d_ff), d_model, dtype, device),
        "w_down": dense_init(generator, (d_ff, d_model), d_ff, dtype, device),
    }
    if kind == "swiglu":
        p["w_gate"] = dense_init(generator, (d_model, d_ff), d_model, dtype, device)
    return p


def dense_ffn(x, p, kind="swiglu"):
    up = x @ p["w_up"]
    if kind == "swiglu":
        h = F.silu(x @ p["w_gate"]) * up
    else:  # gelu, in the tanh approximation (jax.nn.gelu's default)
        h = F.gelu(up, approximate="tanh")
    return h @ p["w_down"]
