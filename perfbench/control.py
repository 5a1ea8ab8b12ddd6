"""The control of ``correct``: the plain reference in TF32 (the nearest
precision below the configuration's float32 with TF32 off) put in the
port's place, judged as a run judges the port.  It has to come out as not
correct.  The benchmark's own runs do not run it.

    python3 perfbench/control.py --workload <cell> --seeds 11 12 13

prints, per seed, one JSON line with the compared numbers: ``wrong`` of
``queries`` sampled answers, for the TF32 reference and, as the lower
reading beside it, for the float32 reference rebuilt a second time.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from perfbench import harness, inputs, judge  # noqa: E402


def control(cell: str, seed: int, *, device="cuda", seconds: float = 4.0,
            overrides: dict | None = None) -> dict:
    """The compared numbers of the TF32 control on one seed, at the cell's
    own sizes: as many sampled queries as a run compares."""
    config, traffic, _, _ = harness.cell_setup(cell, overrides)
    dev = torch.device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    pool_n = harness.load_loop(traffic).pool_rows(traffic, seconds)
    inp = inputs.make_inputs(config, traffic, seed, pool_n, dev)
    rng = np.random.default_rng(int(seed) % (1 << 63))
    count = int(traffic["check_requests"]) * int(traffic["check_rows"])
    rows = rng.choice(pool_n, size=min(pool_n, count), replace=False)
    Q = torch.from_numpy(inp.pool[rows]).to(dev)
    kw = dict(k=int(traffic["k"]), r0=inp.r0, steps=int(traffic["steps"]))
    out = {"seed": seed, "queries": len(rows)}
    answers = {}
    for name, precision in (("fp32", "fp32"), ("again", "fp32"), ("tf32", "tf32")):
        t = time.perf_counter()
        ref = harness.reference_for(config, inp, precision)
        d, i = ref.search(Q, **kw)
        answers[name] = (d.cpu().numpy(), i.cpu().numpy())
        out[f"{name}_s"] = round(time.perf_counter() - t, 3)
        del ref
    want = answers["fp32"]
    out["wrong_fp32"] = judge.wrong_answers(*answers["again"], *want)
    out["wrong_tf32"] = judge.wrong_answers(*answers["tf32"], *want)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("perfbench control: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(control(args.workload, seed)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
