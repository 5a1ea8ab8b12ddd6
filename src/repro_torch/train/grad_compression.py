"""Error-feedback int8 gradient compression for the cross-pod all-reduce.

Cross-pod links are the scarcest bandwidth in a multi-pod mesh. Per-pod
gradients are block-quantized to int8 with a float32 scale a block of
``BLOCK`` elements (8.125 bits an element against 32 for float32
gradients), the codes and scales of every pod are gathered, and the mean
is their dequantized sum over pods divided by the pod count. The
quantization residual is fed back into the pod's next gradient (error
feedback keeps convergence unbiased — Karimireddy et al., ICML 2019).

On the single-controller mesh one process holds every pod's gradients:
:func:`compressed_pmean` takes one gradient tree a pod and one residual
tree a pod, and its ``all_gather`` is the pods' codes and scales stacked
on the merge device. :func:`encode` and :func:`mean_of_codes` are its two
halves, which ``train.train_step`` runs a pod at a time so that only one
pod's float32 gradients exist at once. A tree is a dict of tensors (the
train step's: one stacked tensor a reference leaf, keyed by its dotted
path); every leaf is quantized whole, flattened, so a block of a stacked
leaf may span two layers, as in the reference.

``wire_bytes`` gives what the exchange moves: the int8 codes and float32
scales of every pod (``pod_int8``) and, beside them, the float32
gradients an uncompressed all-reduce would move (``pod_fp32``).
"""

from __future__ import annotations

import math

import torch

from ..models.registry import stacked_leaves

__all__ = ["BLOCK", "quantize", "dequantize", "compressed_pmean", "init_error_state",
           "encode", "mean_of_codes", "wire_bytes"]

BLOCK = 256


def quantize(x: torch.Tensor):
    """x -> (int8 codes (nb, BLOCK), float32 scales (nb,), residual like x
    in float32)."""
    flat = x.float().reshape(-1)
    pad = (-flat.numel()) % BLOCK
    blocks = torch.nn.functional.pad(flat, (0, pad)).reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    residual = (blocks - deq).reshape(-1)[: x.numel()].reshape(x.shape)
    return q, scale[:, 0], residual


def dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    deq = q.float() * scale[:, None]
    size = 1
    for s in shape:
        size *= s
    return deq.reshape(-1)[:size].reshape(tuple(shape))


def encode(tree: dict, err: dict) -> tuple[dict, dict]:
    """One pod's half of the exchange: each gradient plus the pod's
    residual, quantized.  Returns ({leaf: (codes, scales)}, {leaf: new
    residual})."""
    codes, residual = {}, {}
    for name, g in tree.items():
        q, s, r = quantize(g.float() + err[name])
        codes[name], residual[name] = (q, s), r
    return codes, residual


def mean_of_codes(codes: list, shapes: dict) -> dict:
    """The other half: the pods' codes and scales (one ``encode`` result
    a pod, in pod order) gathered and summed over pods, divided by the
    pod count.  ``shapes`` maps each leaf to its shape."""
    npods = len(codes)
    out = {}
    for name, shape in shapes.items():
        q_all = torch.stack([c[name][0] for c in codes])  # (P, nb, BLOCK) int8 wire
        s_all = torch.stack([c[name][1] for c in codes])  # (P, nb) fp32 wire
        size = 1
        for n in shape:
            size *= n
        total = torch.einsum("pbk,pb->bk", q_all.float(), s_all)
        out[name] = total.reshape(-1)[:size].reshape(tuple(shape)) / npods
    return out


def compressed_pmean(trees: list, err_states: list) -> tuple[dict, list]:
    """Error-feedback int8 mean over pods.

    trees: one gradient tree a pod; err_states: one residual tree a pod,
    carried across steps.  Returns (the mean tree, the new residual tree
    of each pod)."""
    if len(trees) != len(err_states):
        raise ValueError(f"{len(trees)} gradient trees for {len(err_states)} residual trees")
    halves = [encode(t, e) for t, e in zip(trees, err_states)]
    shapes = {name: tuple(g.shape) for name, g in trees[0].items()}
    return mean_of_codes([h[0] for h in halves], shapes), [h[1] for h in halves]


def wire_bytes(shapes, npods: int) -> dict:
    """What ``mean_of_codes`` gathers for leaves of ``shapes`` from
    ``npods`` pods: their int8 codes and float32 scales, every leaf
    rounded up to whole blocks (``pod_int8``), and the float32 gradients
    an uncompressed all-reduce would move (``pod_fp32``)."""
    sizes = [math.prod(s) for s in shapes]
    return {"pod_int8": npods * sum(-(-n // BLOCK) * (BLOCK + 4) for n in sizes),
            "pod_fp32": npods * 4 * sum(sizes)}


def init_error_state(params, pods: int = 1) -> list:
    """``pods`` zero residual trees in float32, one a pod, each keyed as
    the optimizer state is: the module's stacked leaves by their dotted
    path, on the parameters' device."""
    leaves = stacked_leaves(params)
    return [{leaf.path: torch.zeros(leaf.shape, dtype=torch.float32,
                                    device=leaf.params[0].device) for leaf in leaves}
            for _ in range(pods)]
