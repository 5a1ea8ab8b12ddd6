"""Train step assembly: loss -> grads -> optimizer update.

``make_train_step(model, opt, accum_steps=A)`` returns ``step(state,
batch) -> (state, metrics)``.  The backward pass runs in torch autograd,
each layer rematerialised (see ``models.transformer.rematerialised``).
With ``accum_steps > 1`` the global batch is split into A microbatches
along its first axis, in order, as the reference's scan splits it; their
gradients accumulate in place in each parameter's ``.grad``, in the
parameter's dtype and in microbatch order (the sums of the reference's
accumulator, without a second gradient buffer), and are then scaled by
1/A.  The step updates the state in place and returns it; the gradients
are freed after the update.

The backward pass is deterministic: the step runs with
``torch.use_deterministic_algorithms`` on.  The embedding lookup's
backward is an ``index_put_`` with accumulation, which on CUDA adds with
atomics otherwise, in an order that changes from run to run; a restart
that replays the same batches must give the same bits.  ``warn_only``
keeps the few CUDA ops that have no deterministic kernel running (with a
warning), and ``CUBLAS_WORKSPACE_CONFIG`` is set for cuBLAS if nothing set
it, which takes effect where no cuBLAS handle exists yet (a program that
runs cuBLAS before its first step sets it first, as ``chip_smoke.py``
does).  The train state's parameters must have gradients on
(``init_train_state``, ``models.registry.train_state_from_reference``).

``compress_pods=True`` (a mesh with a 'pod' axis) is the reference's
pod-compressed flavour.  The batch is cut into the 'pod' axis's equal
parts, in order; each pod's gradients are computed from its part (with
``accum_steps`` as above) and go through the int8 error-feedback
exchange of ``train.grad_compression`` at once, a pod at a time (its
gradients, stacked by reference leaf, plus its residual, quantized; the
new residual kept); then the mean of the pods' dequantized codes becomes
every parameter's gradient, the loss is the mean of the pods' losses, and
one optimizer update runs.  ``state["err"]`` holds one residual tree a
pod, as the reference's ``shard_map`` with ``out_specs=P()`` keeps one a
pod device (a host read of the reference's state sees pod 0's).
"""

from __future__ import annotations

import contextlib
import os

import torch

from ..models.registry import stacked_leaves
from . import grad_compression as gc
from .optimizer import global_norm

__all__ = ["make_train_step", "init_train_state"]

CUBLAS_WORKSPACE = ":4096:8"  # a fixed cuBLAS workspace: reproducible products


def init_train_state(model, opt, generator: torch.Generator, device=None,
                     compress_pods=False, mesh=None) -> dict:
    """``{"params", "opt", "step"}``: the model's parameters drawn from
    ``generator`` on ``device`` (the CUDA device when None) with gradients
    on, the optimizer's state, and the step (an int32 CPU scalar).  With
    ``compress_pods`` also ``"err"``: one zero residual tree for each pod
    of ``mesh``'s 'pod' axis.  ``device="meta"`` gives the state's shapes
    and allocates nothing."""
    if torch.is_inference_mode_enabled():
        raise RuntimeError("a train state cannot be made under torch.inference_mode")
    params = model.init(generator, device=device)
    params.requires_grad_(True)
    state = {"params": params, "opt": opt.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    if compress_pods:
        state["err"] = gc.init_error_state(params, _pods(mesh))
    return state


def _pods(mesh) -> int:
    if mesh is None or "pod" not in mesh.axis_names:
        raise ValueError("compress_pods needs a mesh with a 'pod' axis")
    return mesh.shape["pod"]


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms inside the block (see the module doc), the
    caller's settings restored after.  The mode would also fill every
    uninitialised allocation with NaN, a guard against reading memory no
    kernel wrote, which no op here does; at MiniCPM-2B's width those fills
    were ~0.39 s of a 3.5 s step, so they are off."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    fill = torch.utils.deterministic
    prev = (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            fill.fill_uninitialized_memory)
    torch.use_deterministic_algorithms(True, warn_only=True)
    fill.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev[0], warn_only=prev[1])
        fill.fill_uninitialized_memory = prev[2]


def _microbatches(batch: dict, n: int) -> list:
    """The batch split along its first axis into ``n`` equal parts, in order."""
    size = len(next(iter(batch.values())))
    if size % n:
        raise ValueError(f"a batch of {size} does not split into {n} microbatches")
    m = size // n
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()} for i in range(n)]


def make_train_step(model, opt, mesh=None, compress_pods=False, accum_steps=1):
    """Returns step(state, batch) -> (state, metrics): ``loss`` (a float32
    device scalar), ``grad_norm`` (the global norm of the gradients) and
    ``lr``."""
    pods = _pods(mesh) if compress_pods else 1

    def grads_of(params, batch) -> torch.Tensor:
        for p in params.parameters():
            p.grad = None
        if accum_steps == 1:
            loss, _ = model.loss(params, batch, mesh)
            loss.backward()
            return loss.detach()
        l_sum = None
        for mb in _microbatches(batch, accum_steps):
            loss, _ = model.loss(params, mb, mesh)
            loss.backward()
            l_sum = loss.detach() if l_sum is None else l_sum + loss.detach()
        inv = 1.0 / accum_steps
        with torch.no_grad():
            for p in params.parameters():
                p.grad.mul_(inv)
        return l_sum * inv

    def pod_grads(state, batch):
        """The pods' gradients through the compressed exchange: (the mean
        loss, {parameter name: float32 gradient})."""
        params = state["params"]
        leaves = stacked_leaves(params)
        codes, losses = [], []
        for pod, part in enumerate(_microbatches(batch, pods)):
            losses.append(grads_of(params, part))
            err, pod_codes = state["err"][pod], {}
            with torch.no_grad():
                for leaf in leaves:  # a leaf at a time: one stacked copy at once
                    g = (torch.stack([p.grad for p in leaf.params]) if leaf.stacked
                         else leaf.params[0].grad)
                    for p in leaf.params:
                        p.grad = None
                    c, r = gc.encode({leaf.path: g}, {leaf.path: err[leaf.path]})
                    pod_codes.update(c)
                    err[leaf.path] = r[leaf.path]
                    del g
            codes.append(pod_codes)
        with torch.no_grad():
            mean = gc.mean_of_codes(codes, {leaf.path: leaf.shape for leaf in leaves})
        del codes
        # the mean stays float32 whatever the parameters' dtype, as the
        # reference hands its exchange's output to the optimizer
        grads = {}
        for leaf in leaves:
            rows = mean.pop(leaf.path)
            grads.update(zip(leaf.names, rows.unbind(0) if leaf.stacked else [rows]))
        return sum(losses[1:], losses[0]) / pods, grads

    def step(state, batch):
        params = state["params"]
        with deterministic():
            if compress_pods:
                loss, grads = pod_grads(state, batch)
            else:
                loss = grads_of(params, batch)
                grads = {name: p.grad for name, p in params.named_parameters()}
        params, state["opt"], stats = opt.update(grads, state["opt"], params)
        grad_norm = stats["grad_norm"] if "grad_norm" in stats else global_norm(grads)
        del grads
        for p in params.parameters():
            p.grad = None
        state["step"].add_(1)
        return state, {"loss": loss, "grad_norm": grad_norm, "lr": stats["lr"]}

    return step
