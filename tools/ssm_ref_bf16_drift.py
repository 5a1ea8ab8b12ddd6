#!/usr/bin/env python3
"""Mamba2-1.3B's bf16 prefill-vs-decode gap in the JAX reference and in the
port, on the same weights, on the CPU.

    PYTHONPATH=src python3 tools/ssm_ref_bf16_drift.py [--layers 48] [--tokens 64] [--rows 1]

Draws the model at its full width with the reference's ``init``
(``jax.random.key(0)``), depth cut to ``--layers`` where the host's memory
does not hold two copies of the 48 layers (5.4 GB each in float32), and
takes the prompt of ``chip_smoke.py``'s gate (the first ``--tokens`` tokens
of the synthetic corpus's first batch; ``--rows`` takes that many of its
rows, each a prompt).  For each package, and for bf16 and float32
compute, it prints the last logits' largest differences, one per row:

- ``decode_vs_prefill``: a prefill of T - 1 tokens and one decode against
  a prefill of T (what ``chip_smoke.py`` phase 18 gates);
- ``prefill_vs_fp32``: the prefill of T against the same package's
  float32 prefill;

and the two packages' float32 prefills against each other.  The port
runs on the same weights, carried across by ``params_from_reference``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
os.environ.setdefault("JAX_PLATFORMS", "cpu")

LM_SEQ, LM_BATCH, SEED = 1024, 8, 7  # chip_smoke.py's corpus


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--layers", type=int, default=0, help="cut the depth to this many layers")
    ap.add_argument("--tokens", type=int, default=64)
    ap.add_argument("--rows", type=int, default=1, help="prompts: rows of the first batch")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro.configs import get_config as ref_config
    from repro.data.pipeline import SyntheticTokens, make_batch_fn
    from repro.models.registry import build_model as ref_build
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build_model, params_from_reference

    cfg_ref = ref_config(args.arch)
    cfg = get_config(args.arch)
    if args.layers:
        cfg_ref, cfg = cfg_ref.scaled(n_layers=args.layers), cfg.scaled(n_layers=args.layers)
    T = args.tokens
    prompt = make_batch_fn(SyntheticTokens(cfg.vocab_size, LM_SEQ, LM_BATCH, seed=SEED))(0)[
        "tokens"][:args.rows, :T]
    t0 = time.perf_counter()
    ref_params = ref_build(cfg_ref).init(jax.random.key(0))
    n_params = sum(a.size for a in jax.tree.leaves(ref_params))
    print(f"{args.arch}: {cfg.n_layers} of {get_config(args.arch).n_layers} layers at "
          f"d_model {cfg.d_model}, {n_params:,} parameters, drawn by the reference in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def ref_last(dtype):
        m = ref_build(cfg_ref.scaled(dtype=dtype))
        toks = jnp.asarray(prompt)
        full = m.prefill(ref_params, {"tokens": toks}, cache_len=T)[0]
        _, _, c = m.prefill(ref_params, {"tokens": toks[:, :-1]}, cache_len=T)
        dec = m.decode(ref_params, toks[:, -1], c, jnp.asarray(T - 1, jnp.int32))[0]
        return np.asarray(full, np.float32), np.asarray(dec, np.float32)

    tree = jax.tree.map(np.asarray, ref_params)
    params = params_from_reference(tree, cfg, device="cpu")
    del tree

    def port_last(dtype):
        m = build_model(cfg.scaled(dtype=dtype))
        toks = torch.from_numpy(np.asarray(prompt))
        with torch.inference_mode():
            full = m.prefill(params, {"tokens": toks}, cache_len=T)[0]
            _, _, c = m.prefill(params, {"tokens": toks[:, :-1]}, cache_len=T)
            dec = m.decode(params, toks[:, -1], c, T - 1)[0]
        return full.float().numpy(), dec.float().numpy()

    def gap(a, b) -> list:
        return [round(float(r), 6) for r in np.abs(a - b).max(-1)]

    out, fp32 = {}, {}
    for name, last in (("reference", ref_last), ("port", port_last)):
        t0 = time.perf_counter()
        runs = {dt: last(dt) for dt in ("float32", "bfloat16")}
        fp32[name] = runs["float32"][0]
        out[name] = {dt: {"decode_vs_prefill": gap(dec, full),
                          "prefill_vs_fp32": gap(full, fp32[name])}
                     for dt, (full, dec) in runs.items()}
        out[name]["logits_std"] = float(fp32[name].std())
        print(f"{name}: {json.dumps(out[name])} ({time.perf_counter() - t0:.1f} s)", flush=True)
    print(json.dumps({"arch": args.arch, "layers": cfg.n_layers, "tokens": T,
                      "max_abs_dlogit": out,
                      "rows": args.rows,
                      "fp32_prefill_port_vs_reference": gap(fp32["port"], fp32["reference"])}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
