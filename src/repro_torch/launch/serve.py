"""Serving launcher: continuous-batching engine (+ optional kNN-LM).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-9b --requests 16
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu --retrieval

On the CPU the model is the architecture's smoke config with two layers
in float32; on the CUDA device (the default) it is the full config, with
random weights.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import get_config
from ..data.pipeline import SyntheticTokens, make_batch_fn
from ..device import resolve_device
from ..models.registry import build_model
from ..serve import Request, RetrievalLM, ServeEngine, build_datastore


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-9b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--retrieval", action="store_true")
    ap.add_argument("--device", default=None,
                    help="'cpu' or a CUDA device (default: the CUDA device)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if device.type == "cpu":
        cfg = cfg.smoke().scaled(dtype="float32", n_layers=2)
    model = build_model(cfg)
    gen = torch.Generator(device=device)
    params = model.init(gen.manual_seed(0), device=device)

    retrieval = None
    if args.retrieval:
        src = SyntheticTokens(cfg.vocab_size, 32, 2)
        batches = [make_batch_fn(src)(s) for s in range(4)]
        ds = build_datastore(model, params, batches, gen.manual_seed(1), t=32, k=8,
                             device=device)
        retrieval = RetrievalLM(model, ds, r0=1.0, steps=4)

    eng = ServeEngine(model, params, slots=args.slots, cache_len=args.cache_len,
                      retrieval=retrieval, device=device)
    rng = np.random.default_rng(0)
    reqs = [Request(uid=i,
                    prompt=rng.integers(0, cfg.vocab_size, size=8).astype(np.int32),
                    max_new_tokens=16)
            for i in range(args.requests)]
    for r in reqs:
        eng.submit(r)
    steps = eng.run()
    done = sum(r.done for r in reqs)
    print(f"served {done}/{len(reqs)} requests in {steps} engine steps")
    return done, steps


if __name__ == "__main__":
    main()
