"""Model assembly: family -> (init, loss, prefill, decode, input_specs).

``build_model(cfg)`` returns a :class:`Model` whose functions take the
parameters first, as the reference's do: ``model.decode(params, token,
caches, pos)``.  ``model.init(generator)`` draws the parameters (a
:class:`~repro_torch.models.transformer.Transformer` module) on the CUDA
device unless ``device`` says otherwise; ``input_specs``/``cache_specs``
give ``device="meta"`` tensors, the counterpart of JAX's
``ShapeDtypeStruct``.  ``params_from_reference`` carries the reference's
parameter tree (as numpy arrays) into the port.

Every family is ported: dense, moe, ssm and hybrid
(:mod:`~repro_torch.models.transformer`), encdec
(:mod:`~repro_torch.models.encdec`, whose batches carry ``frames``) and
vlm (:mod:`~repro_torch.models.vlm`, whose batches carry ``images``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..device import resolve_device
from . import encdec, transformer, vlm
from .common import DTYPES, compute_dtype

__all__ = ["Model", "build_model", "param_count", "params_from_reference"]

# families whose layers are not ported yet, and what waits on each: none
_WAITING: dict[str, str] = {}

# the module of each family's init_params, loss_fn, cache_spec, prefill, decode
_FAMILIES = {"dense": transformer, "moe": transformer, "ssm": transformer,
             "hybrid": transformer, "encdec": encdec, "vlm": vlm}


def _cast_params(params: torch.nn.Module, cfg) -> torch.nn.Module:
    """Store >=2D weights in cfg.param_dtype (bf16 for the giant MoEs).
    ``transformer.init_params`` stores all but the MoE router so as it
    draws them; this casts what is left."""
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
        cfg = self.cfg
        B = batch_override or shape.global_batch
        S = shape.seq_len

        def sds(shp, dtype=torch.int32):
            return torch.empty(shp, dtype=dtype, device="meta")

        extras = {}  # the modality stubs, in the compute dtype
        if cfg.family == "encdec":
            extras["frames"] = sds((B, cfg.enc_seq, cfg.d_model), compute_dtype(cfg))
        if cfg.family == "vlm":
            extras["images"] = sds((B, cfg.n_img_tokens, cfg.d_vision), compute_dtype(cfg))
        if shape.phase == "train":
            return {"batch": {"tokens": sds((B, S)), "labels": sds((B, S)), **extras}}
        if shape.phase == "prefill":
            return {"batch": {"tokens": sds((B, S)), **extras}}
        if shape.phase == "decode":
            return {"token": sds((B,)), "caches": self.cache_specs(B, S), "pos": sds(())}
        raise ValueError(shape.phase)

    def cache_specs(self, batch: int, seq_len: int):
        return _FAMILIES[self.cfg.family].cache_spec(self.cfg, batch, seq_len)

    def init_cache(self, batch: int, seq_len: int, device=None):
        """Zero caches on ``device`` (the CUDA device when None)."""
        return transformer._zeros_like_spec(self.cache_specs(batch, seq_len),
                                            resolve_device(device))


def _check_ported(fam: str) -> None:
    if fam in _WAITING:
        raise NotImplementedError(f"family {fam!r} is not ported yet: {_WAITING[fam]}")
    if fam not in _FAMILIES:
        raise ValueError(fam)


def build_model(cfg: ModelConfig) -> Model:
    _check_ported(cfg.family)
    mod = _FAMILIES[cfg.family]

    def init(generator: torch.Generator, device=None):
        device = resolve_device(device)
        return _cast_params(mod.init_params(generator, cfg, device), cfg)

    def prefill(params, batch, mesh=None, cache_len=None):
        if mod is transformer:  # the decoder-only families take the tokens alone
            return transformer.prefill(params, batch["tokens"], cfg, mesh, cache_len)
        return mod.prefill(params, batch, cfg, mesh, cache_len)

    return Model(
        cfg=cfg,
        init=init,
        loss=lambda params, batch, mesh=None: mod.loss_fn(params, batch, cfg, mesh),
        prefill=prefill,
        decode=lambda params, token, caches, pos, mesh=None: mod.decode(
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


def _blocks(stacked: dict, n: int, device) -> list:
    """Blocks stacked on a leading axis (the reference's scan layout) as
    ``n`` :class:`~repro_torch.models.transformer.Block` modules."""

    def layer(v, i):
        if isinstance(v, dict):
            return {k: _tensor(a[i], device) for k, a in v.items()}
        return _tensor(v[i], device)

    return [transformer.Block(**{name: layer(v, i) for name, v in stacked.items()})
            for i in range(n)]


def params_from_reference(tree: dict, cfg: ModelConfig, device=None) -> torch.nn.Module:
    """The reference's parameter tree (nested dicts of arrays, blocks
    stacked on a leading axis) as the port's module on ``device`` (the
    CUDA device when None), dtypes kept."""
    _check_ported(cfg.family)
    device = resolve_device(device)

    def t(name):
        return _tensor(tree[name], device)

    if cfg.family == "encdec":
        return encdec.EncDec(t("embed"), _blocks(tree["enc_blocks"], cfg.n_enc_layers, device),
                             t("enc_norm"), _blocks(tree["dec_blocks"], cfg.n_layers, device),
                             t("final_norm"))
    if cfg.family == "vlm":
        return vlm.VLM(t("embed"), _blocks(tree["blocks"], cfg.n_layers, device),
                       _blocks(tree["cross_blocks"], vlm.n_groups(cfg), device),
                       t("img_proj"), t("final_norm"), t("lm_head"))
    head = t("lm_head") if "lm_head" in tree else None
    return transformer.Transformer(t("embed"), _blocks(tree["blocks"], cfg.n_layers, device),
                                   t("final_norm"), head)
