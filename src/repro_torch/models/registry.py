"""Model assembly: family -> (init, loss, prefill, decode, input_specs).

``build_model(cfg)`` returns a :class:`Model` whose functions take the
parameters first, as the reference's do: ``model.decode(params, token,
caches, pos)``.  ``model.init(generator)`` draws the parameters (a
:class:`~repro_torch.models.transformer.Transformer` module) on the CUDA
device unless ``device`` says otherwise; ``input_specs``/``cache_specs``
give ``device="meta"`` tensors, the counterpart of JAX's
``ShapeDtypeStruct``.  ``params_from_reference`` carries the reference's
parameter tree (as numpy arrays) into the port.

Only the dense family is ported; the others raise ``NotImplementedError``
naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..device import resolve_device
from . import transformer
from .common import DTYPES

__all__ = ["Model", "build_model", "param_count", "params_from_reference"]

# families whose layers are not ported yet, and what waits on each
_WAITING = {
    "moe": "the MoE FFN (ROADMAP A17, item 1 of its remainder)",
    "ssm": "the SSM family (ROADMAP A17, item 2 of its remainder)",
    "hybrid": "the hybrid family (ROADMAP A17, item 3 of its remainder)",
    "encdec": "the encoder-decoder family and cross attention (ROADMAP A17, item 4)",
    "vlm": "the VLM family and cross attention (ROADMAP A17, item 4)",
}


def _cast_params(params: transformer.Transformer, cfg) -> transformer.Transformer:
    """Store >=2D weights in cfg.param_dtype (bf16 for the giant MoEs)."""
    pd = DTYPES[cfg.param_dtype]
    for p in params.parameters():
        if p.dim() > 1 and p.dtype == torch.float32 and pd != torch.float32:
            p.data = p.data.to(pd)
    return params


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    init: Callable[..., Any]  # (generator, device=None) -> params
    loss: Callable[..., Any]  # (params, batch, mesh=None) -> (loss, metrics)
    prefill: Callable[..., Any]  # (params, batch, mesh=None, cache_len=None)
    decode: Callable[..., Any]  # (params, token, caches, pos, mesh=None)

    def input_specs(self, shape: ShapeConfig, batch_override: int = 0) -> dict:
        """``device="meta"`` stand-ins for every model input of the step
        implied by shape.phase ('train' | 'prefill' | 'decode')."""
        B = batch_override or shape.global_batch
        S = shape.seq_len

        def sds(shp, dtype=torch.int32):
            return torch.empty(shp, dtype=dtype, device="meta")

        if shape.phase == "train":
            return {"batch": {"tokens": sds((B, S)), "labels": sds((B, S))}}
        if shape.phase == "prefill":
            return {"batch": {"tokens": sds((B, S))}}
        if shape.phase == "decode":
            return {"token": sds((B,)), "caches": self.cache_specs(B, S), "pos": sds(())}
        raise ValueError(shape.phase)

    def cache_specs(self, batch: int, seq_len: int):
        return transformer.cache_spec(self.cfg, batch, seq_len)

    def init_cache(self, batch: int, seq_len: int, device=None):
        """Zero caches on ``device`` (the CUDA device when None)."""
        return transformer.init_cache(self.cfg, batch, seq_len, resolve_device(device))


def build_model(cfg: ModelConfig) -> Model:
    fam = cfg.family
    if fam in _WAITING:
        raise NotImplementedError(f"family {fam!r} is not ported yet: {_WAITING[fam]}")
    if fam != "dense":
        raise ValueError(fam)

    def init(generator: torch.Generator, device=None):
        device = resolve_device(device)
        return _cast_params(transformer.init_params(generator, cfg, device), cfg)

    return Model(
        cfg=cfg,
        init=init,
        loss=lambda params, batch, mesh=None: transformer.loss_fn(params, batch, cfg, mesh),
        prefill=lambda params, batch, mesh=None, cache_len=None: transformer.prefill(
            params, batch["tokens"], cfg, mesh, cache_len
        ),
        decode=lambda params, token, caches, pos, mesh=None: transformer.decode(
            params, token, caches, pos, cfg, mesh
        ),
    )


def param_count(params: torch.nn.Module) -> int:
    return sum(p.numel() for p in params.parameters())


def _tensor(a, device) -> torch.Tensor:
    """A numpy array (bfloat16 as ``ml_dtypes``) as a tensor of its dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def params_from_reference(tree: dict, cfg: ModelConfig, device=None) -> transformer.Transformer:
    """The reference's parameter tree (nested dicts of arrays, blocks
    stacked on a leading axis) as the port's module on ``device`` (the
    CUDA device when None), dtypes kept."""
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet: "
                                  f"{_WAITING.get(cfg.family, cfg.family)}")
    device = resolve_device(device)
    b = tree["blocks"]
    blocks = []
    for i in range(cfg.n_layers):
        blocks.append(transformer.Block(
            _tensor(b["norm1"][i], device),
            {k: _tensor(v[i], device) for k, v in b["attn"].items()},
            _tensor(b["norm2"][i], device),
            {k: _tensor(v[i], device) for k, v in b["ffn"].items()},
        ))
    head = _tensor(tree["lm_head"], device) if "lm_head" in tree else None
    return transformer.Transformer(_tensor(tree["embed"], device), blocks,
                                   _tensor(tree["final_norm"], device), head)
