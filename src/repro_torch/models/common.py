"""Shared model building blocks: norms, RoPE, initializers, dtype policy.

Functions over tensors; the layers themselves are ``nn.Module``s (see
``models.transformer``).  Every form is the reference's: the ``(1 +
scale)`` RMSNorm computed in float32, RoPE rotating the two halves of a
head with float32 angles, a vocabulary padded to a multiple of 128, and a
cross entropy that masks the padded ids.
"""

from __future__ import annotations

import math

import torch

__all__ = [
    "DTYPES",
    "compute_dtype",
    "pad_vocab",
    "dense_init",
    "embed_init",
    "rmsnorm",
    "rope_freqs",
    "apply_rope",
    "cross_entropy",
    "promoted",
    "matmul",
    "einsum",
]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def compute_dtype(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


def pad_vocab(v: int, mult: int = 128) -> int:
    return -(-v // mult) * mult


# ---------------------------------------------------------------------------
# products in JAX's promoted dtype
# ---------------------------------------------------------------------------


def promoted(*ts: torch.Tensor) -> list:
    """The operands in the dtype JAX gives their product, the promotion of
    theirs (a bf16 activation times a float32 weight is a float32
    product); ``torch.matmul``/``einsum`` refuse mixed dtypes."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t if t.dtype == dt else t.to(dt) for t in ts]


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = promoted(a, b)
    return a @ b


def einsum(eq: str, *ops: torch.Tensor) -> torch.Tensor:
    return torch.einsum(eq, *promoted(*ops))


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def dense_init(generator: torch.Generator, shape, in_axis_size=None, dtype=torch.float32,
               device=None) -> torch.Tensor:
    """Truncated-normal fan-in init (LeCun-style): a standard normal
    truncated to [-3, 3], times 1/sqrt(fan_in), drawn on the generator's
    device and placed on ``device``."""
    fan_in = in_axis_size if in_axis_size is not None else shape[0]
    out = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(out, 0.0, 1.0, -3.0, 3.0, generator=generator)
    out.mul_(1.0 / math.sqrt(fan_in))
    return out.to(device=device if device is not None else generator.device, dtype=dtype)


def embed_init(generator: torch.Generator, shape, dtype=torch.float32,
               device=None) -> torch.Tensor:
    out = torch.randn(shape, generator=generator, device=generator.device).mul_(0.02)
    return out.to(device=device if device is not None else generator.device, dtype=dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    return ((x * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(dt)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 1e4) -> torch.Tensor:
    """x: (..., T, H, hd); positions: (..., T) integers.  Rotates the two
    halves of each head (not interleaved pairs), in float32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)  # (hd/2,)
    angles = positions[..., :, None].float() * freqs  # (..., T, hd/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Mean CE over valid labels (< vocab_size; padded ids masked)."""
    logits = logits.float()
    valid = labels < vocab_size
    safe = torch.where(valid, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = torch.where(valid, logz - gold, 0.0)
    return torch.sum(nll) / torch.clamp(torch.sum(valid), min=1)
