"""Token data pipeline: deterministic, host-sharded, resumable, prefetched.

Design for fault tolerance/elasticity: batches are a *pure function of
the global step* (stateless indexing into a seeded generator or a memmap
corpus). Resuming from step k — on any number of hosts — reproduces the
exact global batch sequence; the only iterator state that needs to be
checkpointed is the step counter itself.
"""

from __future__ import annotations

import queue
import threading

import numpy as np

__all__ = ["SyntheticTokens", "MemmapTokens", "Prefetcher", "make_batch_fn"]


class SyntheticTokens:
    """Deterministic synthetic LM stream (counter-based RNG: independent
    of history, safe to index from any step)."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int, seed: int = 0):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed

    def batch_at(self, step: int, host_id: int = 0, n_hosts: int = 1):
        local = self.global_batch // n_hosts
        rng = np.random.Generator(
            np.random.Philox(key=self.seed, counter=[0, 0, host_id, step])
        )
        toks = rng.integers(
            0, self.vocab_size, size=(local, self.seq_len + 1), dtype=np.int32
        )
        # mix in structure so losses are learnable: low-order markov flavor
        toks[:, 1:] = (toks[:, 1:] + toks[:, :-1]) % self.vocab_size
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class MemmapTokens:
    """File-backed corpus of int32 tokens; step-indexed strided windows."""

    def __init__(self, path: str, seq_len: int, global_batch: int):
        self.data = np.memmap(path, dtype=np.int32, mode="r")
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.n_windows = (len(self.data) - 1) // seq_len

    def batch_at(self, step: int, host_id: int = 0, n_hosts: int = 1):
        local = self.global_batch // n_hosts
        base = (step * self.global_batch + host_id * local) % self.n_windows
        idx = (base + np.arange(local)) % self.n_windows
        starts = idx * self.seq_len
        toks = np.stack([self.data[s : s + self.seq_len + 1] for s in starts])
        return {"tokens": toks[:, :-1].astype(np.int32), "labels": toks[:, 1:].astype(np.int32)}


def make_batch_fn(source, extras=None, host_id=0, n_hosts=1):
    """-> batch_fn(step) adding any modality-stub extras (frames/images)."""

    def fn(step: int):
        b = source.batch_at(step, host_id, n_hosts)
        if extras:
            rng = np.random.Generator(np.random.Philox(key=17, counter=[0, 0, 0, step]))
            for name, shape in extras.items():
                local = b["tokens"].shape[0]
                b[name] = rng.standard_normal((local,) + tuple(shape), dtype=np.float32)
        return b

    return fn


class Prefetcher:
    """Background-thread prefetch of step-indexed batches."""

    def __init__(self, batch_fn, start_step: int = 0, depth: int = 2):
        self.batch_fn = batch_fn
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self.step = start_step
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        s = self.step
        while not self.stop.is_set():
            try:
                self.q.put((s, self.batch_fn(s)), timeout=0.2)
                s += 1
            except queue.Full:
                continue

    def next(self):
        s, b = self.q.get()
        return s, b

    def close(self):
        self.stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
        self.thread.join(timeout=2)
