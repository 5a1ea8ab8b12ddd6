"""Step-function + sharding assembly for the launcher and the dry run.

``build_step(model, shape, mesh, ...)`` returns (fn, example_args,
in_shardings, out_shardings, donate). The example arguments are
``device="meta"`` tensors (the parameters drawn on the meta device, the
train state made there, the registry's ``input_specs``), so nothing is
allocated; ``fn(*example_args)`` runs on them and gives the outputs'
shapes (``launch.step_stats`` counts its FLOPs so).  The shardings are
``sharding.rules.NamedSharding`` trees over ``mesh``: on the
single-controller mesh they say where each shard would live and change
no value.
"""

from __future__ import annotations

import torch

from ..configs.base import ShapeConfig
from ..sharding import rules
from ..sharding.rules import P
from ..train import init_train_state, make_optimizer, make_train_step
from ..train.optimizer import cosine_schedule

__all__ = ["build_step"]

META = "meta"


def build_step(model, shape: ShapeConfig, mesh, *, compress_pods=False,
               batch_override: int = 0):
    cfg = model.cfg
    specs = model.input_specs(shape, batch_override=batch_override)
    gen = torch.Generator()  # nothing is drawn on the meta device

    if shape.phase == "train":
        opt = make_optimizer(cfg.optimizer, cosine_schedule(3e-4, 2000, 200_000))
        step = make_train_step(model, opt, mesh, compress_pods=compress_pods,
                               accum_steps=cfg.accum_steps)
        state = init_train_state(model, opt, gen, device=META, compress_pods=compress_pods,
                                 mesh=mesh)
        pspecs = rules.param_specs(state["params"], mesh)
        sspecs = rules.state_specs(state, pspecs, mesh)
        bspecs = rules.batch_specs(specs["batch"], mesh)
        in_sh = (rules.named(mesh, sspecs), rules.named(mesh, bspecs))
        out_sh = (rules.named(mesh, sspecs), None)
        return step, (state, specs["batch"]), in_sh, out_sh, (0,)

    params = model.init(gen, device=META)
    pspecs = rules.param_specs(params, mesh)

    dp = rules.dp_axes(mesh)
    B = batch_override or shape.global_batch

    def _out_vec_specs():
        """(logits (B,V), hidden (B,D)) with divisibility guards."""
        v = model.cfg.padded_vocab
        lspec = rules._guard_spec((B, v), (dp, "model"), mesh)
        hspec = rules._guard_spec((B, model.cfg.d_model), (dp, None), mesh)
        return lspec, hspec

    if shape.phase == "prefill":
        @torch.no_grad()
        def fn(params, batch):
            logits, hidden, caches = model.prefill(params, batch, mesh)
            # return last-position hidden (retrieval key) + caches + logits
            return logits, hidden[:, -1, :], caches

        bspecs = rules.batch_specs(specs["batch"], mesh)
        # the prefill's caches hold the whole prompt: the cache layout at
        # seq_len slots
        cspecs = rules.cache_specs(model.cache_specs(B, shape.seq_len), mesh)
        lspec, hspec = _out_vec_specs()
        in_sh = (rules.named(mesh, pspecs), rules.named(mesh, bspecs))
        out_sh = (
            rules.named(mesh, lspec),
            rules.named(mesh, hspec),
            rules.named(mesh, cspecs),
        )
        return fn, (params, specs["batch"]), in_sh, out_sh, ()

    if shape.phase == "decode":
        @torch.no_grad()
        def fn(params, token, caches, pos):
            return model.decode(params, token, caches, pos, mesh)

        cspecs = rules.cache_specs(specs["caches"], mesh)
        lspec, hspec = _out_vec_specs()
        tok_spec = rules._guard_spec((B,), (dp,), mesh)
        in_sh = (
            rules.named(mesh, pspecs),
            rules.named(mesh, tok_spec),
            rules.named(mesh, cspecs),
            rules.named(mesh, P()),
        )
        out_sh = (
            rules.named(mesh, lspec),
            rules.named(mesh, hspec),
            rules.named(mesh, cspecs),
        )
        args = (params, specs["token"], specs["caches"], specs["pos"])
        return fn, args, in_sh, out_sh, (2,)  # donate caches

    raise ValueError(shape.phase)
