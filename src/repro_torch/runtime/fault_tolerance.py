"""Fault-tolerant training supervision: checkpoint/restart, straggler
mitigation, elastic resume.

On real fleets, failures arrive as lost hosts / NCCL timeouts; in a
single process they are *simulated* by a failure-injection hook (tests
raise at a chosen step). The supervisor's contract is what matters and
is fully exercised:

  * every ``ckpt_every`` steps the full train state (params, optimizer,
    step) is checkpointed asynchronously+atomically;
  * on failure, ``run()`` restores the latest checkpoint and replays from
    there — data batches are a pure function of the step (pipeline.py),
    and the train step is deterministic, so recovery is bit-exact;
  * the straggler monitor tracks per-step wall time with an EWMA and
    flags outliers (slow replicas); in DP deployments the runner drops /
    reassigns the slow replica's shard (simulated in tests).

The port's train step updates its state in place (``train.train_step``),
so a restore copies the checkpoint into the state's own tensors, and
``run()`` keeps a host copy of the state it started from, to restart
from when a failure comes before the first checkpoint.  ``state_tree``
gives the tree a state is checkpointed as (a module as its named
parameters) and ``load_state`` copies such a tree back into a state.
"""

from __future__ import annotations

import time

import torch

from ..checkpoint.checkpointer import Checkpointer, _host_tree
from ..models.registry import stacked_leaves
from ..sharding.rules import P, NamedSharding
from ..resilience.stragglers import StragglerMonitor

__all__ = ["StragglerMonitor", "TrainSupervisor", "state_tree", "load_state"]


def state_tree(state):
    """The nested dict of tensors a train state is checkpointed as: a
    module becomes ``{parameter name: tensor}``, a list (the per-pod
    residual trees) ``{"0": ..., "1": ...}``."""
    if isinstance(state, torch.nn.Module):
        return {name: p.detach() for name, p in state.named_parameters()}
    if isinstance(state, dict):
        return {k: state_tree(v) for k, v in state.items()}
    if isinstance(state, list):
        return {str(i): state_tree(v) for i, v in enumerate(state)}
    return state


@torch.no_grad()
def load_state(state, tree):
    """Copy ``tree`` (``state_tree``'s form, arrays or tensors) into the
    tensors of ``state``, bit for bit; returns ``state``."""
    if isinstance(state, torch.nn.Module):
        for name, p in state.named_parameters():
            p.copy_(torch.as_tensor(tree[name]))
        return state
    if isinstance(state, dict):
        for k in state:
            state[k] = load_state(state[k], tree[k])
        return state
    if isinstance(state, list):
        for i in range(len(state)):
            state[i] = load_state(state[i], tree[str(i)])
        return state
    return state.copy_(torch.as_tensor(tree))


def _tensor_shardings(state, shardings):
    """``shardings`` in ``state_tree``'s form: a module's stacked leaf's
    sharding becomes one a parameter, its spec without the layer entry
    where the reference stacks; a list's one a pod becomes ``{"0": ...}``.
    A single sharding stays as it is."""
    if shardings is None or hasattr(shardings, "spec"):
        return shardings
    if isinstance(state, torch.nn.Module):
        out = {}
        for leaf in stacked_leaves(state):
            sh = shardings[leaf.path]
            if leaf.stacked:
                sh = NamedSharding(sh.mesh, P(*tuple(sh.spec)[1:]))
            out.update((name, sh) for name in leaf.names)
        return out
    if isinstance(state, dict):
        return {k: _tensor_shardings(v, shardings[k]) for k, v in state.items()}
    if isinstance(state, list):
        return {str(i): _tensor_shardings(v, shardings[i]) for i, v in enumerate(state)}
    return shardings


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def _synchronize(state) -> None:
    """Wait for the work queued on the device of the state's first CUDA
    tensor."""
    for t in _leaves(state_tree(state)):
        if t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
            return


class TrainSupervisor:
    """Run a step function with checkpoint/restart semantics.

    step_fn(state, batch) -> (state, metrics); batch_fn(step) -> batch.
    failure_hook(step) may raise to simulate a node loss.
    """

    def __init__(self, ckpt_dir: str, ckpt_every: int = 10, max_restarts: int = 10,
                 keep: int = 3):
        self.ckpt = Checkpointer(ckpt_dir, keep=keep)
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.monitor = StragglerMonitor()
        self.restarts = 0

    def _restore(self, state, shardings=None):
        tree, meta = self.ckpt.restore(shardings=shardings)
        return load_state(state, tree), meta["next_step"]

    def run(self, init_state, step_fn, batch_fn, num_steps: int,
            failure_hook=None, state_shardings=None, log=None):
        """Run ``num_steps`` steps from the latest checkpoint (or from
        ``init_state``).  ``state_shardings``: one sharding, or the tree
        ``sharding.rules.named(mesh, state_specs(...))`` gives, onto which
        every restore places and checks the state (an elastic resume when
        the mesh differs from the one that saved it)."""
        shardings = _tensor_shardings(init_state, state_shardings)
        state = init_state
        start, initial = 0, None
        if self.ckpt.latest_step() is not None:
            state, start = self._restore(state, shardings)
        else:
            initial = _host_tree(state_tree(state), copy=True)

        step = start
        while step < num_steps:
            try:
                t0 = time.perf_counter()
                if failure_hook is not None:
                    failure_hook(step)
                batch = batch_fn(step)
                state, metrics = step_fn(state, batch)
                # wait for the device so step timing (straggler detection)
                # sees real work, not the launch queue
                _synchronize(state)
                dt = time.perf_counter() - t0
                slow = self.monitor.record(step, dt)
                if log:
                    log(step, metrics, dt, slow)
                step += 1
                if step % self.ckpt_every == 0:
                    self.ckpt.save_async(step, state_tree(state), meta={"next_step": step})
            except Exception:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                # an in-flight async save may itself have died (that can be
                # the very failure we are recovering from) — drain it without
                # re-raising; restore() below falls back to the newest
                # *verified* step regardless of how the write ended
                self.ckpt.wait(reraise=False)
                if self.ckpt.latest_step() is None:
                    state, step = load_state(state, initial), 0
                else:
                    state, step = self._restore(state, shardings)
        self.ckpt.wait()
        self.ckpt.save(num_steps, state_tree(state), meta={"next_step": num_steps})
        return state
