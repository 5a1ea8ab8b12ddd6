"""Multi-pod dry run: build and measure every (arch x shape x mesh) cell.

For each cell: ``build_step`` on the production mesh with
``device="meta"`` arguments — nothing is allocated, on the host or on a
card — then the step run once on them under ``launch.step_stats``
(FLOPs a step, backward and recompute included; per-device argument,
output and aliased bytes from the spec trees; the bytes of the port's
explicit collectives). One JSON a cell, under
``build/dryrun_torch/<mesh>/<arch>__<shape>.json`` at the repository's
root (or ``--out``); existing results are skipped (incremental cache;
errors are retried). The reference's XLA fields (lower and compile
seconds, ``memory_analysis``'s temp bytes, ``cost_analysis``, the HLO
size) have no counterpart; ``build_s`` and ``analyze_s`` stand in for
the first two.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--force]
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from pathlib import Path

from ..configs import CONFIGS, SHAPES, get_config, runnable
from ..models.registry import build_model
from .mesh import make_production_mesh
from .step_stats import analyze, wire_bytes
from .steps import build_step

__all__ = ["RESULTS_DIR", "cell_path", "run_cell", "main"]

RESULTS_DIR = Path(__file__).resolve().parents[3] / "build" / "dryrun_torch"


def cell_path(arch, shape, multi_pod, compress=False, out_dir=None) -> str:
    mesh_tag = "pod2x16x16" if multi_pod else "pod16x16"
    if compress:
        mesh_tag += "_int8pod"
    d = Path(out_dir or RESULTS_DIR) / mesh_tag
    d.mkdir(parents=True, exist_ok=True)
    return str(d / f"{arch}__{shape}.json")


def run_cell(arch: str, shape_name: str, multi_pod: bool, *,
             compress_pods: bool = False, force: bool = False, out_dir=None) -> dict:
    path = cell_path(arch, shape_name, multi_pod, compress_pods, out_dir)
    if os.path.exists(path) and not force:
        with open(path) as f:
            cached = json.load(f)
        if cached.get("status") in ("ok", "skipped"):
            return cached  # errors are retried

    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    result = {
        "arch": arch, "shape": shape_name,
        "mesh": "2x16x16" if multi_pod else "16x16",
        "phase": shape.phase,
    }
    if not runnable(cfg, shape):
        result["status"] = "skipped"
        result["reason"] = (
            "long_500k requires sub-quadratic attention; "
            f"{arch} is full-attention (DESIGN.md §5)"
        )
        _write(path, result)
        return result

    try:
        t0 = time.time()
        mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
        model = build_model(cfg)
        fn, args, in_sh, out_sh, donate = build_step(model, shape, mesh,
                                                     compress_pods=compress_pods)
        t_build = time.time() - t0
        stats = analyze(fn, args, in_sh, out_sh, donate,
                        wire=wire_bytes(cfg, mesh, shape.phase, args))
        t_analyze = time.time() - t0 - t_build
        result.update(
            status="ok",
            build_s=round(t_build, 2),
            analyze_s=round(t_analyze, 2),
            memory={
                "argument_bytes": stats.argument_bytes,
                "output_bytes": stats.output_bytes,
                "alias_bytes": stats.alias_bytes,
                "per_device_total": stats.per_device_total,
            },
            step_stats={
                "flops": stats.flops,
                "collective_bytes": stats.collective_bytes,
                "collective_breakdown": stats.collective_breakdown,
            },
        )
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        result.update(status="error", error=f"{type(e).__name__}: {e}",
                      traceback=traceback.format_exc()[-4000:])
    _write(path, result)
    return result


def _write(path, result):
    with open(path + ".tmp", "w") as f:
        json.dump(result, f, indent=1)
    os.replace(path + ".tmp", path)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--compress-pods", action="store_true")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=None, help="results directory (default: build/dryrun_torch)")
    args = ap.parse_args(argv)

    cells = []
    archs = sorted(CONFIGS) if (args.all or not args.arch) else [args.arch]
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    for mp in meshes:
        for a in archs:
            for s in shapes:
                cells.append((a, s, mp))

    results = []
    for i, (a, s, mp) in enumerate(cells):
        t0 = time.time()
        r = run_cell(a, s, mp, compress_pods=args.compress_pods, force=args.force,
                     out_dir=args.out)
        results.append(r)
        status = r.get("status")
        extra = ""
        if status == "ok":
            gb = r["memory"]["per_device_total"] / 2**30
            extra = f"mem/dev={gb:.2f}GiB flops={r['step_stats']['flops']:.3e}"
        elif status == "error":
            extra = r["error"][:120]
        print(
            f"[{i + 1}/{len(cells)}] {a} x {s} x {'2x16x16' if mp else '16x16'}: "
            f"{status} {extra} ({time.time() - t0:.1f}s)",
            flush=True,
        )
    return results


if __name__ == "__main__":
    main()
