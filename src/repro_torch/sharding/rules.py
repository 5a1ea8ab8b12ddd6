"""Per-architecture PartitionSpec rules (DP / TP / EP / SP).

Conventions (mesh axes: optional 'pod', 'data', 'model'):

  * batch dims shard over ('pod', 'data') — DP everywhere;
  * attention heads / FFN features / experts shard over 'model' — TP/EP;
    GQA KV projections are replicated when n_kv < model-axis size;
  * embeddings / LM head shard the vocab over 'model';
  * SSM in/out projections shard their *contraction* dim over 'model'
    (row-parallel);
  * decode KV caches shard batch over 'data' and KV heads over 'model'
    when divisible, else the *sequence* dim over 'model' (sequence
    parallelism);
  * optimizer state mirrors the parameter specs (Adafactor row/col
    factors drop the corresponding trailing dims).

The rules are the reference's, spec for spec.  On the single-controller
mesh (``core.distributed.Mesh``) every layer computes on whole tensors,
so a spec changes no value: the specs say where each shard would live,
and ``launch.step_stats`` reads from them the bytes each device holds.
The port's own collectives are explicit (``models.ffn``'s expert
parallelism, ``sharding.pp``'s hand-offs, ``train.grad_compression``).

Matching is by the reference's key paths, read from the port's trees:
a module's parameters by ``models.registry.stacked_leaves`` (the
per-layer tensors of ``blocks.<i>.attn.wq`` make the stacked leaf
``blocks/attn/wq`` of shape (L, ...)), the optimizer state by its dotted
leaf paths, a list (the per-layer caches, the per-pod error trees) by
index.  Leaves may be ``device="meta"`` tensors: nothing is allocated.
A spec tree mirrors its input, a module becoming ``{leaf path: P}``.
"""

from __future__ import annotations

import dataclasses
import math
import re

import torch

from ..models.registry import stacked_leaves

__all__ = ["P", "NamedSharding", "param_specs", "state_specs", "batch_specs",
           "cache_specs", "named", "dp_axes", "shard_factor"]


class P(tuple):
    """A PartitionSpec: one entry a dimension, an axis name, a tuple of
    axis names (sharded over their product, in order) or None
    (replicated).  A one-name tuple is that name, as JAX normalises it."""

    def __new__(cls, *axes):
        def norm(a):
            if isinstance(a, (tuple, list)):
                a = tuple(a)
                return a[0] if len(a) == 1 else a
            return a

        return super().__new__(cls, (norm(a) for a in axes))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: where each shard of a tensor lives."""

    mesh: object
    spec: P


def dp_axes(mesh):
    axes = tuple(a for a in mesh.axis_names if a in ("pod", "data"))
    return axes if len(axes) > 1 else axes[0]


def _tp(mesh):
    return mesh.shape.get("model", 1)


# (path regex, fn(shape) -> P). First match wins. Paths look like
# "blocks/attn/wq", "dec_blocks/ffn/w_up", "cross_blocks/...".
def _rules(tp):
    def heads_ok(n):
        return n % tp == 0

    return [
        # embeddings / head: vocab over model
        (r"^embed$", lambda s: P("model", None)),
        (r"^lm_head$", lambda s: P(None, "model")),
        (r"^img_proj$", lambda s: P(None, None)),
        # attention (leading dims: layer stacks) — q/o shard heads
        (r"(attn|xattn)/wq$", lambda s: P(*(None,) * (len(s) - 3), None, "model", None)),
        (r"(attn|xattn)/w[kv]$", lambda s: (
            P(*(None,) * (len(s) - 3), None, "model", None)
            if heads_ok(s[-2]) else P(*(None,) * len(s))
        )),
        (r"(attn|xattn)/wo$", lambda s: P(*(None,) * (len(s) - 3), "model", None, None)),
        # dense FFN
        (r"ffn/w_(up|gate)$", lambda s: P(*(None,) * (len(s) - 2), None, "model")),
        (r"ffn/w_down$", lambda s: P(*(None,) * (len(s) - 2), "model", None)),
        # MoE: experts over model (EP); router replicated
        (r"moe/router$", lambda s: P(*(None,) * len(s))),
        (r"moe/w_(up|gate|down)$", lambda s: P(*(None,) * (len(s) - 3), "model", None, None)),
        # SSM: z/x segment column-parallel on the head-aligned dim,
        # out_proj row-parallel; depthwise conv weights follow the
        # activation sharding
        (r"ssm/w_zx$", lambda s: P(*(None,) * (len(s) - 2), None, "model")),
        (r"ssm/(conv_wx|conv_bx)$", lambda s: P(*(None,) * (len(s) - 1), "model")),
        (r"ssm/out_proj$", lambda s: P(*(None,) * (len(s) - 2), "model", None)),
        (r"ssm/", lambda s: P(*(None,) * len(s))),
        # norms, gates, scalars: replicated
        (r".*", lambda s: P(*(None,) * len(s))),
    ]


# ---------------------------------------------------------------------------
# trees: the port's state, parameters and caches under the reference's paths
# ---------------------------------------------------------------------------


def _shape(leaf) -> tuple:
    """The shape of a leaf: a tensor, a ``registry.Leaf`` or a shape."""
    if isinstance(leaf, (tuple, torch.Size)):
        return tuple(int(n) for n in leaf)
    return tuple(leaf.shape)


def _map(fn, tree, path: tuple = ()):
    """``fn(path, leaf)`` over a tree, the tree's structure kept: a dict
    by key, a list by index, a module as ``{leaf path: ...}`` over its
    stacked leaves.  ``path`` is the tuple of keys, a dotted leaf path
    split at its dots (the reference's key path)."""
    if isinstance(tree, torch.nn.Module):
        return {leaf.path: fn(path + tuple(leaf.path.split(".")), leaf)
                for leaf in stacked_leaves(tree)}
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + tuple(str(k).split("."))) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(fn, v, path + (str(i),)) for i, v in enumerate(tree)]
    return fn(path, tree)


def _flat(tree, path: tuple = ()) -> dict:
    """{'/'-joined key path: leaf} of a spec tree (P leaves)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, path + tuple(str(k).split("."))))
        return out
    if isinstance(tree, list):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, path + (str(i),)))
        return out
    return {"/".join(path): tree}


def shard_factor(mesh, ax) -> int:
    """The number of shards an entry of a spec cuts its dim into."""
    sz = 1
    if ax is not None:
        for a in (ax if isinstance(ax, tuple) else (ax,)):
            sz *= mesh.shape.get(a, 1)
    return sz



def _guard_spec(shape, spec, mesh):
    """Drop axes whose size does not divide the dim (e.g. batch=1)."""
    fixed = []
    for dim, ax in zip(shape, spec):
        fixed.append(None if (ax is not None and dim % shard_factor(mesh, ax) != 0) else ax)
    return P(*fixed)


# ---------------------------------------------------------------------------
# the rules
# ---------------------------------------------------------------------------


def param_specs(params, mesh, fsdp: bool = True, fsdp_min_size: int = 1 << 20):
    """Parameters (a module, ``{dotted leaf path: tensor or shape}``, or
    nested dicts of either) -> the same tree of specs.

    fsdp=True additionally shards every large tensor's biggest
    still-unsharded dim over the data axes (ZeRO-3 style: parameters and
    optimizer state are fully sharded)."""
    rules = _rules(_tp(mesh))
    dpa = dp_axes(mesh)
    dp_size = shard_factor(mesh, dpa)

    def one(path, leaf):
        ps = "/".join(path)
        shape = _shape(leaf)
        for pat, fn in rules:
            if re.search(pat, ps):
                spec = fn(shape)
                # guard: never shard a dim not divisible by the axis size
                fixed = []
                for dim, ax in zip(shape, spec):
                    if ax is not None and dim % mesh.shape.get(ax, 1) != 0:
                        fixed.append(None)
                    else:
                        fixed.append(ax)
                if fsdp and math.prod(shape) >= fsdp_min_size and dp_size > 1:
                    # biggest unsharded, divisible dim -> data axes
                    cands = [
                        (dim, i) for i, (dim, ax) in enumerate(zip(shape, fixed))
                        if ax is None and dim % dp_size == 0
                    ]
                    if cands:
                        _, i = max(cands)
                        fixed[i] = dpa
                return P(*fixed)
        raise AssertionError(ps)

    return _map(one, params)


def _factored_spec(base, which):
    if which == "vr":
        return P(*base[:-1])
    if which == "vc":
        return P(*(base[:-2] + (base[-1],)))
    return base


def state_specs(state, pspecs, mesh):
    """A train state (``{"params", "opt", "step"[, "err"]}``) -> specs.
    Optimizer moments mirror the parameters; Adafactor's factored stats
    drop the corresponding dims; each pod's error-feedback tree mirrors
    the parameters; step counters are replicated."""
    flat_p = _flat(pspecs)

    def one(path, leaf):
        ps = "/".join(path)
        m = re.match(r"^opt/v/(.*)/(vr|vc|v)$", ps)
        if m and m.group(1) in flat_p:
            return _factored_spec(flat_p[m.group(1)], m.group(2))
        if ps.startswith("params/"):
            return flat_p[ps[len("params/"):]]
        m = re.match(r"^err/(?:\d+/)?(.*)$", ps)  # one tree a pod
        if m:
            return flat_p[m.group(1)]
        m = re.match(r"^opt/(m|v)/(.*)$", ps)
        if m:
            return flat_p[m.group(2)]
        return P()  # step counters etc.

    return _map(one, state)


def batch_specs(batch, mesh):
    dp = dp_axes(mesh)
    return _map(lambda path, s: _guard_spec(_shape(s), (dp,) + (None,) * (len(_shape(s)) - 1),
                                            mesh), batch)


def cache_specs(caches, mesh, batch_axis=1):
    """Decode caches: batch over data axes; KV heads over 'model' when
    divisible, else sequence over 'model' (SP). Cache leaves are either
    stacked (L, B, S, KV, hd) / (L, B, H, N, P) or per-layer
    (B, S, KV, hd)."""
    tp = _tp(mesh)
    dp = dp_axes(mesh)

    def one(ps, shape):
        if ps.endswith("ssm"):  # (..., B, H, N, P)
            nb = len(shape) - 4
            spec = [None] * len(shape)
            spec[nb] = dp
            if shape[nb + 1] % tp == 0:
                spec[nb + 1] = "model"
            return P(*spec)
        if ps.endswith("conv"):  # (..., B, W, C)
            nb = len(shape) - 3
            spec = [None] * len(shape)
            spec[nb] = dp
            if shape[-1] % tp == 0:
                spec[-1] = "model"
            return P(*spec)
        # attention caches (..., B, S, KV, hd)
        nb = len(shape) - 4
        spec = [None] * len(shape)
        spec[nb] = dp
        if shape[nb + 2] % tp == 0:
            spec[nb + 2] = "model"  # KV heads
        elif shape[nb + 1] % tp == 0:
            spec[nb + 1] = "model"  # sequence parallelism
        return P(*spec)

    def guard(path, leaf):
        shape = _shape(leaf)
        return _guard_spec(shape, one("/".join(path), shape), mesh)

    return _map(guard, caches)


def named(mesh, spec_tree):
    """The spec tree as a tree of :class:`NamedSharding` on ``mesh``."""
    if isinstance(spec_tree, P):
        return NamedSharding(mesh, spec_tree)
    if isinstance(spec_tree, dict):
        return {k: named(mesh, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, list):
        return [named(mesh, v) for v in spec_tree]
    raise TypeError(f"not a spec tree leaf: {spec_tree!r}")
