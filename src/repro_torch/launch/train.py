"""Training launcher.

    PYTHONPATH=src python -m repro_torch.launch.train --arch minicpm-2b \
        [--steps N] [--batch B] [--seq T] [--smoke] [--ckpt DIR] [--device cpu]

Trains ``arch`` under ``runtime.TrainSupervisor`` (checkpoints every
``--ckpt-every`` steps, restart on failure) on synthetic tokens, with the
architecture's own optimizer (``cfg.optimizer``) and a cosine schedule.
On the CUDA device (the default) the model is the full config, with
random weights, unless ``--smoke``; on the CPU, and with ``--smoke``, it
is the architecture's smoke config in float32.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from ..configs import get_config
from ..data.pipeline import SyntheticTokens, make_batch_fn
from ..device import resolve_device
from ..models.registry import build_model, param_count
from ..runtime import TrainSupervisor
from ..train import init_train_state, make_optimizer, make_train_step
from ..train.optimizer import cosine_schedule


def main(argv=None):
    """Returns the loss of every step run (replayed steps included)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced smoke config (CPU-sized)")
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default=None,
                    help="'cpu' or a CUDA device (default: the CUDA device)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke or device.type == "cpu":
        cfg = cfg.smoke().scaled(dtype="float32")
    model = build_model(cfg)
    opt = make_optimizer(cfg.optimizer, cosine_schedule(3e-4, 10, args.steps))
    gen = torch.Generator(device=device).manual_seed(0)
    state = init_train_state(model, opt, gen, device=device)
    print(f"{cfg.name}: {param_count(state['params']) / 1e6:.1f}M params, "
          f"optimizer={cfg.optimizer}, on {device}")

    src = SyntheticTokens(cfg.vocab_size, args.seq, args.batch)
    extras = {}
    if cfg.family == "encdec":
        extras["frames"] = (cfg.enc_seq, cfg.d_model)
    if cfg.family == "vlm":
        extras["images"] = (cfg.n_img_tokens, cfg.d_vision)
    batch_fn = make_batch_fn(src, extras=extras)
    step_fn = make_train_step(model, opt)

    sup = TrainSupervisor(args.ckpt, ckpt_every=args.ckpt_every)
    losses = []

    def log(step, metrics, dt, slow):
        losses.append(float(metrics["loss"]))
        if step % 10 == 0:
            print(f"step {step:4d} loss {losses[-1]:.4f} "
                  f"{dt * 1e3:.0f} ms" + (" [STRAGGLER]" if slow else ""))

    sup.run(state, step_fn, batch_fn, args.steps, log=log)
    print("training complete")
    return losses


if __name__ == "__main__":
    main()
