"""Serving substrate: continuous-batching engine + kNN-LM retrieval.

    from repro_torch.serve import Request, RetrievalLM, ServeEngine, build_datastore

    ds = build_datastore(model, params, batches, torch.Generator("cuda").manual_seed(1), k=8)
    engine = ServeEngine(model, params, slots=4, cache_len=256,
                         retrieval=RetrievalLM(model, ds, r0=r0, steps=6))
    engine.submit(Request(uid=0, prompt=prompt, max_new_tokens=32))
    engine.run()
"""
from .engine import Request, ServeEngine
from .retrieval import Datastore, RetrievalLM, build_datastore, knn_probs

__all__ = ["Request", "ServeEngine", "Datastore", "RetrievalLM", "build_datastore", "knn_probs"]
