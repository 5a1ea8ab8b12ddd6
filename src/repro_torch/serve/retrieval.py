"""kNN-LM retrieval head backed by the vector store — the integration
that makes the paper's index a first-class feature of the serving stack.

Datastore: (key = LM hidden state at position t, value = token t+1)
pairs collected by a teacher-forced pass over a corpus (Khandelwal et
al., ICLR 2020).  The pairs live in a ``repro_torch.store.Collection``
whose payload is the value tokens, so the datastore inherits the store
lifecycle: ``add``/``remove`` of corpus spans, auto-compaction as the
corpus grows past the built K/L sizing, and ``snapshot``/``restore``
persistence.  :class:`Datastore` is a thin client that adds the kNN-LM
math on top.  Every decode step searches the collection as it stands,
so a mutation is seen by the next step.

At decode time the current hidden state queries the collection
((c,k)-ANN, fixed-schedule batched path, through the collection's
engine: ``torch``, or the fused kernels B2 (``kernel``) and B1
(``inline``)); retrieved neighbors vote with softmax(-dist^2 / T) mass on
their value tokens and the result is interpolated with the LM
distribution:

    p(y) = (1 - lam) * p_LM(y) + lam * p_kNN(y)

Fleet scale: attach a ``repro_torch.store.router.ShardedCollection``
instead — the same client code serves a datastore sharded over a mesh.
"""

from __future__ import annotations

import dataclasses

import torch

from ..core import DBLSHParams
from ..device import as_tensor, resolve_device
from ..obs.trace import get_tracer
from ..store import CachedResult, Collection, QueryResultCache

__all__ = ["Datastore", "build_datastore", "knn_probs", "RetrievalLM"]

# the engine name the cache keys carry: the port's pure-framework engine
# (the reference writes its own, "jnp", whatever the collection's engine)
_CACHE_ENGINE = "torch"


@dataclasses.dataclass
class Datastore:
    """Thin kNN-LM client over a Collection (payload = next-token ids).

    ``cache`` (optional, a :class:`~repro_torch.store.cache.QueryResultCache`,
    shareable with a StoreService) short-circuits repeated hidden-state
    queries — a greedy decode loop revisits identical states whenever
    the context re-converges, and batch-of-one eval re-runs the same
    prefixes.  Entries key on the collection's mutation version, so
    ``add``/``remove``/``compact`` on the datastore invalidate them by
    construction.  Nothing here is traced, so the cache engages on every
    query when one is attached.
    """

    collection: Collection
    temperature: float
    lam: float
    k: int
    cache: QueryResultCache | None = None

    # compat surface for callers that predate the store layer
    @property
    def index(self):
        return self.collection.index

    @property
    def values(self) -> torch.Tensor:
        return self.collection.payload

    @classmethod
    def from_index(
        cls, index, values, *, temperature: float, lam: float, k: int,
        name: str = "knnlm", cache: QueryResultCache | None = None,
    ) -> "Datastore":
        """Wrap an already-built DBLSHIndex + value array (on the index's
        device)."""
        col = Collection.from_index(name, index, payload=as_tensor(
            values, index.device, torch.int32))
        return cls(col, temperature, lam, k, cache=cache)

    def search(self, queries, *, r0: float = 1.0, steps: int = 6):
        """(B, D) -> (dists, ids), through the query-result cache when every
        row hits; misses dispatch the whole batch (the shape menu stays
        closed) and publish their rows for the next repeat.

        Published entries are *complete* — payload rows and real probe
        stats included — because the cache is shareable with a
        StoreService over the same collection: a service hit on a
        datastore-published entry must look exactly like one the service
        published itself."""
        col = self.collection
        queries = torch.atleast_2d(as_tensor(queries, col.device))
        if self.cache is None:
            return col.search(queries, k=self.k, r0=r0, steps=steps)
        rows = queries.cpu().numpy()
        keys = [
            self.cache.key(col.name, col.version, q, self.k, _CACHE_ENGINE, r0, steps)
            for q in rows
        ]
        entries = [self.cache.get(kk) for kk in keys]
        if all(e is not None for e in entries):
            tracer = get_tracer()
            if tracer.enabled:  # hot decode path: guard before the span
                tracer.instant(
                    "datastore.cache_hit", cat="cache", collection=col.name,
                    rows=len(entries),
                )
            return (
                torch.stack([torch.as_tensor(e.dists) for e in entries]).to(col.device),
                torch.stack([torch.as_tensor(e.ids) for e in entries]).to(col.device),
            )
        with get_tracer().span(
            "datastore.search", cat="serve", collection=col.name,
            rows=int(rows.shape[0]),
        ):
            dists, ids, stats = col.search(
                queries, k=self.k, r0=r0, steps=steps, with_stats=True
            )
        d_np, i_np = dists.cpu().numpy(), ids.cpu().numpy()
        steps_np = stats["radius_steps"].cpu().numpy()
        cands_np = stats["candidates"].cpu().numpy()
        p_np = (
            None if col.payload is None
            else col.get_payload(ids).cpu().numpy()
        )
        for j, kk in enumerate(keys):
            self.cache.put(kk, CachedResult(
                dists=d_np[j].copy(),
                ids=i_np[j].copy(),
                payload=None if p_np is None else p_np[j].copy(),
                radius_steps=int(steps_np[j]),
                candidates=int(cands_np[j]),
            ))
        return dists, ids


def build_datastore(
    model,
    params,
    batches,
    generator: torch.Generator,
    *,
    c: float = 1.5,
    t: int = 64,
    k: int = 16,
    temperature: float = 10.0,
    lam: float = 0.25,
    block_size: int = 64,
    device=None,
) -> Datastore:
    """Teacher-forced pass over ``batches`` collecting (hidden, next_token),
    indexed on ``device`` (the CUDA device when None) with hash functions
    drawn from ``generator``."""
    device = resolve_device(device)
    keys_l, vals_l = [], []
    with torch.inference_mode():
        for batch in batches:
            hidden = model.loss(params, batch)[1]["hidden"]  # (B,T,D)
            keys_l.append(hidden.reshape(-1, hidden.shape[-1]).float().to(device))
            vals_l.append(as_tensor(batch["labels"], device, torch.int32).reshape(-1))
    keys = torch.cat(keys_l)
    del keys_l
    vals = torch.cat(vals_l)
    params_lsh = DBLSHParams.derive(
        n=keys.shape[0], d=keys.shape[1], c=c, t=t, k=k, block_size=block_size
    )
    col = Collection.create(
        "knnlm", generator, keys, params=params_lsh, payload=vals, device=device
    )
    return Datastore(col, temperature, lam, k)


def _scatter_probs(dists, toks, vocab: int, temperature):
    """(B, k) neighbor dists + value tokens -> (B, vocab) distribution.
    Non-finite distances (unfilled slots) weigh 0; tokens outside the
    vocabulary are dropped."""
    fin = torch.isfinite(dists)
    w = torch.softmax(torch.where(fin, -torch.square(dists) / temperature, -torch.inf),
                      dim=-1)
    toks = toks.long()
    inside = (toks >= 0) & (toks < vocab)
    w = torch.where(fin & inside, w, 0.0)
    out = torch.zeros((dists.shape[0], vocab), dtype=w.dtype, device=w.device)
    return out.scatter_add_(1, torch.where(inside, toks, 0), w)


def knn_probs(ds: Datastore, queries, vocab: int, r0: float = 1.0, steps: int = 6):
    """(B, D) hidden states -> (B, vocab) retrieval distribution."""
    dists, ids = ds.search(queries, r0=r0, steps=steps)
    toks = ds.collection.get_payload(ids)
    return _scatter_probs(dists, toks, vocab, ds.temperature)


def interpolate(lm_logits, knn_p, lam):
    lm_p = torch.softmax(lm_logits.float(), dim=-1)
    return (1.0 - lam) * lm_p + lam * knn_p


@dataclasses.dataclass
class RetrievalLM:
    """Serving wrapper: model decode + kNN-LM interpolation."""

    model: object
    datastore: Datastore
    r0: float = 1.0
    steps: int = 6

    def decode(self, params, token, caches, pos):
        logits, hidden, caches = self.model.decode(params, token, caches, pos)
        vocab = logits.shape[-1]
        knn_p = knn_probs(self.datastore, hidden.float(), vocab, self.r0, self.steps)
        probs = interpolate(logits, knn_p, self.datastore.lam)
        return torch.log(probs + 1e-20), hidden, caches
