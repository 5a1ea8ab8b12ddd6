"""GPipe pipeline parallelism over the 'pod' axis.

The layer stack is split into ``S = mesh.shape['pod']`` contiguous
stages, stage ``s`` on the mesh's device at pod ``s``
(``pp_param_specs`` puts 'pod' on the layer dim of every stacked
``blocks`` leaf). The global batch is cut into M microbatches that flow
through the stages, M + S − 1 ticks a step (bubble fraction
(S − 1)/(M + S − 1)). At tick t stage s runs microbatch t − s: stage 0
embeds it, every stage runs its layers (each rematerialised, its float32
weights of more than one dimension cast to the compute dtype as it runs),
the last stage applies the final norm, the head and the CE, and the
activation is handed to the next stage's device (the reference's
``ppermute``). A tick the reference computes and masks out (a stage with
no microbatch) is skipped. The loss is the mean of the microbatches' CE.

Autograd differentiates through the whole schedule: each hand-off's
backward hands the gradient back to the previous stage's device.
``handoff_bytes`` gives the bytes handed on in both directions.

As in the reference: only the uniform scanned families (dense / moe /
ssm) are supported, the layer count must divide into the stages and the
batch into the microbatches, and the loss is the CE alone — the MoE
load-balance term of ``model.loss`` is not added.
"""

from __future__ import annotations

import torch

from ..models import transformer
from ..models.common import compute_dtype, cross_entropy, rmsnorm
from .rules import P

__all__ = ["pp_loss_fn", "pp_param_specs", "handoff_bytes"]


def pp_param_specs(params_shapes, base_specs):
    """Add P('pod') on the leading (layer) dim of every blocks leaf."""
    del params_shapes  # the specs carry the tree
    return {path: (P("pod", *tuple(spec)[1:]) if path.split(".")[0] == "blocks" else spec)
            for path, spec in base_specs.items()}


def handoff_bytes(cfg, batch: int, seq: int, n_stages: int, microbatches: int) -> int:
    """The bytes ``pp_loss_fn`` hands between stages in a forward and
    backward pass: M (S − 1) activations of (B / M, T, D) in the compute
    dtype, and as many gradients back."""
    act = batch // microbatches * seq * cfg.d_model * compute_dtype(cfg).itemsize
    return 2 * microbatches * (n_stages - 1) * act


def _handoff(y, device):
    """The activation moved to the next stage's device (the reference's
    ``ppermute``); autograd moves its gradient back."""
    return y.to(device)


def _stage_params(block, dt, device) -> dict:
    """A layer's weights for its stage: >= 2-D float32 weights cast to the
    compute dtype (the reference's per-layer cast), on the stage's device."""

    def one(node):
        if isinstance(node, dict):
            return {k: one(v) for k, v in node.items()}
        cast = node.dtype == torch.float32 and node.dim() > 1
        return node.to(device=device, dtype=dt if cast else node.dtype)

    return one(transformer._layer_params(block, None))


def pp_loss_fn(params, batch, cfg, mesh, microbatches: int = 8):
    """Pipeline-parallel CE loss (replaces model.loss under PP)."""
    if cfg.family not in ("dense", "moe", "ssm"):
        raise ValueError(f"pipeline parallelism runs the uniform families (dense, moe, ssm), "
                         f"not {cfg.family!r}")
    n_stages = mesh.shape["pod"]
    assert cfg.n_layers % n_stages == 0, (cfg.n_layers, n_stages)
    dt = compute_dtype(cfg)
    M = microbatches
    tokens = torch.as_tensor(batch["tokens"], device=params.embed.device).long()
    labels = torch.as_tensor(batch["labels"], device=params.embed.device)
    B, T = tokens.shape
    assert B % M == 0, (B, M)
    per = cfg.n_layers // n_stages
    devices = [mesh.device_at(pod=s) for s in range(n_stages)]
    mb_tok = tokens.reshape(M, B // M, T)
    mb_lab = labels.reshape(M, B // M, T)

    def layer(x, block, dev):
        positions = torch.arange(T, device=x.device).expand(B // M, T)
        x, _, _ = transformer.block_forward(x, _stage_params(block, dt, dev), cfg, mesh,
                                            positions=positions, window=cfg.sliding_window)
        return x

    def run_stage(x, s):
        for block in params.blocks[s * per:(s + 1) * per]:
            x = transformer.rematerialised(layer, x, block, devices[s])
        return x

    def head(y, lab, dev):
        h = rmsnorm(y, params.final_norm.to(dev), cfg.norm_eps)
        w = params.embed.T if cfg.tie_embeddings else params.lm_head
        logits = torch.einsum("btd,dv->btv", h, w.to(device=dev, dtype=h.dtype))
        return cross_entropy(logits, lab.to(dev), cfg.vocab_size)

    buf = [None] * n_stages  # the activation waiting at each stage's input
    loss = None
    for t in range(M + n_stages - 1):
        nxt = [None] * n_stages
        for s in range(n_stages):
            mb = t - s
            if not 0 <= mb < M:
                continue  # the reference computes this tick and masks it out
            x = (params.embed[mb_tok[mb]].to(dt).to(devices[0]) if s == 0 else buf[s])
            y = run_stage(x, s)
            if s == n_stages - 1:
                ce = head(y, mb_lab[mb], devices[s])
                loss = ce if loss is None else loss + ce.to(loss.device)
            else:
                nxt[s + 1] = _handoff(y, devices[s + 1])
        buf = nxt
    return loss / M
