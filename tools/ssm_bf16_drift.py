#!/usr/bin/env python3
"""Where the bf16 prefill-vs-decode gap of a full-width Mamba2-1.3B comes
from, on one GPU.

    PYTHONPATH=src python3 tools/ssm_bf16_drift.py [--arch mamba2-1.3b] [--tokens 64]

Draws the model as ``chip_smoke.py`` phase 18 does (random fp32 weights
from seed 0) and takes the same prompt (the first LM_CHECK_T tokens of
the synthetic corpus's first batch).  For each variant it compares the
last logits of a prefill of T tokens with those of a prefill of T - 1
and one decode, and with the float32 prefill:

- ``bf16``: the port as it is (bf16 compute, the reference's dtypes);
- ``bf16, SSD in fp32``: the same with each layer's SSD mixer (its
  input, weights, state and conv ring) in float32, the rest in bf16;
- ``fp32``: float32 throughout.

A variant whose decode-vs-prefill gap is of the order of its own distance
from the float32 prefill is as consistent as its rounding allows.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--tokens", type=int, default=64)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("ssm_bf16_drift: no CUDA device is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticTokens, make_batch_fn
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.models.registry import build_model

    print(chip_smoke.card_line(), flush=True)
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    params = build_model(cfg).init(torch.Generator(device=dev).manual_seed(0))
    src = SyntheticTokens(cfg.vocab_size, chip_smoke.LM_SEQ, chip_smoke.LM_BATCH,
                          seed=chip_smoke.SEED)
    prompt = torch.as_tensor(make_batch_fn(src)(0)["tokens"][:1, :args.tokens], device=dev)
    T = args.tokens

    def last_logits(model):
        with torch.inference_mode():
            full = model.prefill(params, {"tokens": prompt}, cache_len=T)[0].float()
            _, _, c = model.prefill(params, {"tokens": prompt[:, :-1]}, cache_len=T)
            dec = model.decode(params, prompt[:, -1], c, T - 1)[0].float()
        return full, dec

    fwd, dcd = ssm_mod.ssm_forward, ssm_mod.ssm_decode

    def f32(t):
        return t.float() if torch.is_floating_point(t) else t

    def forward_fp32(x, p, cfg_, chunk=128, init_state=None):
        y, s, tail = fwd(x.float(), {k: f32(v) for k, v in p.items()}, cfg_, chunk, init_state)
        return y.to(x.dtype), s.to(x.dtype), tail.to(x.dtype)

    def decode_fp32(x1, p, cfg_, state, conv):
        y, s, c = dcd(x1.float(), {k: f32(v) for k, v in p.items()}, cfg_, state.float(),
                      conv.float())
        return y.to(x1.dtype), s.to(x1.dtype), c.to(x1.dtype)

    ref_full, ref_dec = last_logits(build_model(cfg.scaled(dtype="float32")))
    out = {"fp32": {"decode_vs_prefill": float((ref_dec - ref_full).abs().max()),
                    "logits_std": float(ref_full.std())}}
    model = build_model(cfg)
    for name, patch in (("bf16", None), ("bf16, SSD in fp32", (forward_fp32, decode_fp32))):
        if patch:
            ssm_mod.ssm_forward, ssm_mod.ssm_decode = patch
        try:
            full, dec = last_logits(model)
        finally:
            ssm_mod.ssm_forward, ssm_mod.ssm_decode = fwd, dcd
        out[name] = {"decode_vs_prefill": float((dec - full).abs().max()),
                     "prefill_vs_fp32": float((full - ref_full).abs().max()),
                     "decode_vs_fp32": float((dec - ref_full).abs().max())}
    print(json.dumps({"arch": args.arch, "tokens": T, "max_abs_dlogit": out}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
