"""Run one cell of the benchmark and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout.  The last line on standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``:
each number compared with its limit); the last lines on standard error
are the same checks.  Side information (the card and its power limit,
latency, recall, the generator's lateness) comes on standard error
before them.  Without a CUDA device, or with fewer than the cell asks
for, it prints no result and exits with 2.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the checkout's root (for ``perfbench``) and its ``src`` (for the port),
# in place of this script's directory
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]
# every kernel and build cache at a fixed path inside the checkout
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from perfbench import harness

    t_import = time.perf_counter()
    bench = harness.load_bench()
    chips = harness.find_cell(bench, args.workload)["chips"]
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    t_check = time.perf_counter()
    if cards < chips:
        print(f"perfbench: the cell needs {chips} CUDA device(s); "
              f"{cards} available",
              file=sys.stderr)
        return 2
    result, side = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                                    t_start=T_START, bench=bench)
    found = harness.forbidden_loaded()
    if found:
        print(f"perfbench: the run loaded {', '.join(found)}: no result", file=sys.stderr)
        return 3
    print(f"process: imports {t_import - T_START:.3f} s, CUDA check {t_check - t_import:.3f} s",
          file=sys.stderr)
    for line in side:
        print(line, file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
