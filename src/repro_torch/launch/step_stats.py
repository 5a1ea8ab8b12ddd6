"""What a step costs, measured on ``device="meta"`` tensors: the port's
counterpart of the reference's ``launch/hlo_stats.py``.

The reference walks XLA's post-SPMD HLO text for FLOPs (``dot`` ops with
loop trip counts), HBM bytes and the operand bytes of the collectives.
The port has no HLO; it measures the same quantities where they live:

  * FLOPs: the step run once on meta tensors under
    ``torch.utils.flop_counter.FlopCounterMode`` (matrix products and
    convolutions, as the HLO walk counts ``dot`` ops), the backward pass
    and each rematerialised layer's recompute included — the whole step,
    as one device would run it;
  * per-device argument and output bytes: each leaf's bytes divided by
    the sizes of the mesh axes its spec shards it over (exact: the rules
    shard only dims the axes divide), and the donated arguments' bytes
    (aliased with the outputs, as XLA's ``alias_size_in_bytes``);
  * the bytes of the port's explicit collectives, from the shapes of the
    step's arguments (``wire_bytes``): the pod exchange's int8 codes and
    float32 scales (``pod_int8``, beside ``pod_fp32``: the float32
    gradients an uncompressed all-reduce would move) and the
    expert-parallel partial sums (``ep_psum``).  The pipeline's hand-offs
    are ``sharding.pp.handoff_bytes``; ``build_step`` builds no pipelined
    step.

What has no counterpart: GSPMD's automatic TP/FSDP collectives (the
all-gathers and reduce-scatters XLA inserts for a sharded matmul) and
XLA's temp bytes. On the single-controller mesh every layer computes on
whole tensors, so neither exists here.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils.flop_counter import FlopCounterMode

from ..models.common import compute_dtype
from ..models.registry import stacked_leaves
from ..sharding import rules
from ..train import grad_compression

__all__ = ["StepStats", "analyze", "per_device_bytes", "count_flops", "wire_bytes"]

_WIRE = ("ep_psum", "pod_int8")  # what the collectives move; pod_fp32 is the comparison


@dataclasses.dataclass
class StepStats:
    flops: float
    argument_bytes: int  # per device
    output_bytes: int  # per device
    alias_bytes: int  # per device: donated arguments reused by the outputs
    collective_bytes: int
    collective_breakdown: dict

    @property
    def per_device_total(self) -> int:
        return self.argument_bytes + self.output_bytes - self.alias_bytes


def count_flops(fn, *args):
    """(``fn(*args)``, the FLOPs of its matrix products, backward and
    recompute included)."""
    with FlopCounterMode(display=False) as fc:
        out = fn(*args)
    return out, float(fc.get_total_flops())


def _nbytes(leaf) -> int:
    if isinstance(leaf, torch.Tensor):
        return leaf.numel() * leaf.element_size()
    if hasattr(leaf, "params"):  # a stacked leaf of a module
        return sum(p.numel() * p.element_size() for p in leaf.params)
    return 0


def per_device_bytes(tree, shardings) -> int:
    """The bytes of ``tree`` one device holds under ``shardings`` (a tree
    of ``NamedSharding`` shaped as ``tree``, one for every leaf, or None:
    replicated)."""
    sizes = rules._flat(rules._map(lambda path, leaf: _nbytes(leaf), tree))
    if shardings is None:
        return sum(sizes.values())
    if hasattr(shardings, "spec"):
        specs = {k: shardings for k in sizes}
    else:
        specs = rules._flat(shardings)
    total = 0
    for path, n in sizes.items():
        sh = specs[path]
        factor = 1
        for ax in sh.spec:
            factor *= rules.shard_factor(sh.mesh, ax)
        total += n // factor
    return total


def wire_bytes(cfg, mesh, phase: str, args) -> dict:
    """The bytes the explicit collectives of ``launch.build_step``'s step
    move, from its example ``args``:

      * a pod-compressed train step (its state carries one residual tree
        a pod): ``grad_compression.wire_bytes`` of the stacked leaves;
      * an MoE model on a 'model' axis of tp > 1: each MoE layer's tp
        partial sums of (rows, D) in the compute dtype, once a forward
        pass — three in a train step (the forward, the recompute, the
        backward's gradient of the sum)."""
    out = {}
    if phase == "train" and "err" in args[0]:
        shapes = [leaf.shape for leaf in stacked_leaves(args[0]["params"])]
        out.update(grad_compression.wire_bytes(shapes, len(args[0]["err"])))
    tp = mesh.shape.get("model", 1)
    if cfg.family == "moe" and tp > 1:
        rows = (args[1] if phase == "decode" else args[1]["tokens"]).numel()
        passes = 3 if phase == "train" else 1
        out["ep_psum"] = (passes * cfg.n_layers * tp * rows * cfg.d_model
                          * compute_dtype(cfg).itemsize)
    return out


def analyze(fn, args, in_shardings, out_shardings, donate=(), wire=None) -> StepStats:
    """Run ``fn(*args)`` (meta tensors) once and measure it; ``wire`` is
    the step's ``wire_bytes``."""
    arg_bytes = sum(per_device_bytes(a, s) for a, s in zip(args, in_shardings))
    alias = sum(per_device_bytes(args[i], in_shardings[i]) for i in donate)
    out, flops = count_flops(fn, *args)
    if not isinstance(out, tuple):
        out, out_shardings = (out,), (out_shardings,)
    out_bytes = sum(per_device_bytes(o, s) for o, s in zip(out, out_shardings))
    breakdown = dict(wire or {})
    return StepStats(
        flops=flops, argument_bytes=arg_bytes, output_bytes=out_bytes, alias_bytes=alias,
        collective_bytes=sum(breakdown.get(k, 0) for k in _WIRE),
        collective_breakdown=breakdown,
    )
