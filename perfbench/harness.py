"""One run of one cell: set-up, the measured window, the metrics, and the
comparison with the plain reference that decides ``correct``.

Everything a cell needs is found by name (the data-driven layout):

* the cell: an entry of ``workloads`` in ``BENCHMARK.json``;
* its configuration: ``perfbench/configs/<config>.json``;
* its traffic mix: ``perfbench/traffic/<traffic>.json``, a data file whose
  ``"loop"`` names the generator that reads it,
  ``perfbench/loops/<loop>.py`` (``loadgen.py`` says what one gives);
* a per-layer metric: ``perfbench/metrics/<metric>.py``, a ``read(run)``
  that returns a number, or None when it finds nothing to read;
* a kernel's work count: ``perfbench/roofline/<kernel>.py``, for a
  metric named ``<kernel>_roofline``.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from . import inputs, judge, loadgen, peaks, profread
from .reference.dblsh import Reference, brute_force_knn

__all__ = ["HERE", "ROOT", "load_bench", "find_cell", "load_config", "load_traffic",
           "load_module", "load_loop", "cell_metrics", "run_cell", "p95", "max_blocks",
           "FORBIDDEN_MODULES", "forbidden_loaded"]

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "repro", "benchmarks")


def load_bench(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def find_cell(bench: dict, name: str) -> dict:
    for wl in bench["workloads"]:
        if wl["name"] == name:
            return wl
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def load_config(name: str) -> dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def load_traffic(name: str) -> dict:
    return json.loads((HERE / "traffic" / f"{name}.json").read_text())


def load_module(kind: str, name: str):
    """``perfbench/<kind>/<name>.py`` (names may hold dots)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_{kind}_{name.replace('.', '_')}",
                                                  path)
    if spec is None or not path.exists():
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_loop(traffic: dict):
    """The generator that reads ``traffic``: ``perfbench/loops/<loop>.py``."""
    return load_module("loops", traffic["loop"])


def cell_metrics(bench: dict, cell: str) -> tuple[list, list]:
    """(end-to-end, per-layer) metric entries that ``cell`` reports."""
    e2e = [m for m in bench["end_to_end"] if cell in m.get("workloads", [cell])]
    moves = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if (cell in m["workloads"] if "workloads" in m else m["moves"] in moves)]
    return e2e, layer


def p95(values) -> float:
    """The 95th percentile by nearest rank over all values (a missing
    answer counts as +inf)."""
    v = np.sort(np.asarray(values, dtype=np.float64))
    if v.size == 0:
        return math.nan
    return float(v[max(0, math.ceil(0.95 * v.size) - 1)])


def max_blocks(n: int, t: int, k: int, B: int) -> int:
    """Blocks fetched per table: the paper's budget ``2t + k`` points a
    table, twice over since an overlapping block is only partly inside."""
    m = max(4, math.ceil(2.0 * (2 * t + k) / B))
    return min(m, max(1, math.ceil(n / B)))


def forbidden_loaded(modules=None) -> list[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules``
    by default), each compared whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN_MODULES))


@dataclasses.dataclass
class RunView:
    """What a per-layer reader may read."""
    cell: str
    config: dict
    traffic: dict
    window: loadgen.Window
    tracer: profread.TraceWindow
    trace: profread.TraceSummary | None
    kernel_calls: dict      # kernel name -> list of launch records (traced part)
    peaks: dict | None
    roofline: dict          # kernel name -> its roofline module

    def host_spans_ms(self) -> list[float]:
        """Host ms of the search calls outside the profiled part (all of
        them when the whole window was profiled)."""
        spans = [(s, e) for s, e in self.window.spans if not self.tracer.covers(s)]
        if not spans:
            spans = self.window.spans
        return [(e - s) * 1e3 for s, e in spans]


class _KernelRecorder:
    """Wraps one ``repro_torch.kernels`` wrapper; while the trace runs, it
    keeps each launch's record (the roofline module's ``record``)."""

    def __init__(self, kernels_mod, mod, tracer):
        self.kernels_mod, self.mod, self.tracer = kernels_mod, mod, tracer
        self.orig = getattr(kernels_mod, mod.WRAPPER)
        self.calls = []
        setattr(kernels_mod, mod.WRAPPER, self)

    def __call__(self, *a, **kw):
        if self.tracer.active:
            self.calls.append(self.mod.record(a, kw))
        return self.orig(*a, **kw)

    def restore(self):
        setattr(self.kernels_mod, self.mod.WRAPPER, self.orig)


def build_port(config: dict, inp: inputs.Inputs, dev):
    """The system under test on these inputs: the index built by
    ``repro_torch.core.build`` from the benchmark's vectors and hash
    functions, in a ``repro_torch.store.Collection`` with the
    configuration's engine."""
    from repro_torch.core import DBLSHParams, build
    from repro_torch.store import Collection

    ix = config["index"]
    params = DBLSHParams.derive(
        n=int(config["n"]), d=int(config["d"]), c=ix["c"], w0=ix["w0"], t=ix["t"], k=ix["k"],
        K=ix["K"], L=ix["L"], block_size=ix["block_size"], inline_vectors=ix["inline_vectors"])
    index = build(inp.data, params, proj_vecs=inp.proj, device=dev)
    return Collection.from_index(config["name"], index, engine=config["engine"])


def reference_for(config: dict, inp: inputs.Inputs, precision: str = "fp32") -> Reference:
    ix = config["index"]
    return Reference(inp.data, inp.proj, c=ix["c"], w0=ix["w0"], block_size=ix["block_size"],
                     max_blocks=max_blocks(int(config["n"]), ix["t"], ix["k"],
                                           ix["block_size"]), precision=precision)


def cell_setup(cell: str, overrides: dict | None = None, bench: dict | None = None):
    """(configuration, traffic mix, end-to-end specs, per-layer specs) of a
    cell, with test overrides applied."""
    bench = load_bench() if bench is None else bench
    wl = find_cell(bench, cell)
    config, traffic = load_config(wl["config"]), load_traffic(wl["traffic"])
    for key, val in (overrides or {}).get("config", {}).items():
        config[key] = val
    for key, val in (overrides or {}).get("traffic", {}).items():
        traffic[key] = val
    return config, traffic, *cell_metrics(bench, cell)


def _card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20, check=False).stdout.strip()
        return out.splitlines()[0] if out else "nvidia-smi printed nothing"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cell(cell: str, seed: int, seconds: float, trace: bool, *, device=None,
             t_start: float | None = None, bench: dict | None = None,
             overrides: dict | None = None) -> tuple[dict, list[str]]:
    """One run.  Returns the result line's object and the side lines (to
    be printed on standard error before the checks)."""
    t_start = time.perf_counter() if t_start is None else t_start
    side: list[str] = []
    say = side.append
    config, traffic, e2e_specs, layer_specs = cell_setup(cell, overrides, bench)
    dev = torch.device(device or "cuda")
    torch.backends.cuda.matmul.allow_tf32 = False

    from repro_torch import kernels as port_kernels

    # ---------------------------------------------------------------- set-up
    n, d = int(config["n"]), int(config["d"])
    loops = load_loop(traffic)
    pool_n = loops.pool_rows(traffic, seconds)
    phases = {"start": time.perf_counter() - t_start}
    t_phase = time.perf_counter()

    def phase(name):
        nonlocal t_phase
        _sync(dev)
        now = time.perf_counter()
        phases[name] = now - t_phase
        t_phase = now

    inp = inputs.make_inputs(config, traffic, seed, pool_n, dev)
    phase("inputs")
    col = build_port(config, inp, dev)
    digest, r0, pool = inp.digest, inp.r0, inp.pool
    del inp
    phase("build")
    loop = loops.Loop(traffic, col, pool, r0)
    loop.warm_up()
    phase("warm_up")
    tracer = profread.TraceWindow(trace, traffic.get("trace_seconds", 10))
    tracer.warm_up()
    phase("trace_warm_up")
    rooflines = {m["name"][:-len("_roofline")]: None for m in layer_specs
                 if m["name"].endswith("_roofline")} if trace else {}
    recorders = {}
    for kernel in rooflines:
        rooflines[kernel] = load_module("roofline", kernel)
        recorders[kernel] = _KernelRecorder(port_kernels, rooflines[kernel], tracer)
    _sync(dev)
    gc.collect()
    on_card = dev.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    if on_card:
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start

    # ---------------------------------------------------------------- window
    win = loop.run(seconds, tracer, seed)
    tracer.stop()
    _sync(dev)
    for rec in recorders.values():
        rec.restore()
    window_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0
    memory_peak = max(setup_peak, window_peak)

    # -------------------------------------------------------------- metrics
    lat_ms = np.where(np.isfinite(win.done), (win.done - win.due) * 1e3, np.inf)
    answered = np.isfinite(win.done)
    span_s = max(win.t_end - win.t0, 1e-9)
    e2e_values = {
        "queries_per_s": float(win.queries[answered].sum() / span_s),
        "request_p95_ms": p95(lat_ms),
        "peak_bytes_per_vector_byte": window_peak / (n * d * 4) if on_card else None,
        "setup_s": setup_s,
    }
    device_info = {"platform": "gpu" if on_card else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if on_card else dev.type,
                   "count": 1, "memory_peak_bytes": int(memory_peak)}
    say(f"card: {_card_line() if on_card else dev.type}")
    say(f"window: {len(win.due)} requests, {int(win.queries.sum())} queries in "
        f"{span_s:.3f} s; latency p50 {np.median(lat_ms):.3f} ms, p95 {p95(lat_ms):.3f} ms, "
        f"max {lat_ms.max() if lat_ms.size else math.nan:.3f} ms; setup {setup_s:.3f} s; "
        f"peak {window_peak} B in the window, {setup_peak} B in set-up")
    say("setup phases: " + ", ".join(f"{k} {v:.3f} s" for k, v in phases.items()) +
        f"; pool {pool_n} rows, the window went through it {win.pool_passes:.4f} times")
    summary = tracer.summary() if trace else None
    metrics = {}
    if trace:
        view = RunView(cell=cell, config=config, traffic=traffic, window=win, tracer=tracer,
                       trace=summary,
                       kernel_calls={kname: r.calls for kname, r in recorders.items()},
                       peaks=peaks.peaks_for(device_info["kind"]), roofline=rooflines)
        for spec in layer_specs:
            value = load_module("metrics", spec["name"]).read(view)
            if value is not None:
                metrics[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
        if summary is not None:
            device_info["busy_s"] = summary.busy_s()
            device_info["window_s"] = summary.window_s
    else:
        for spec in e2e_specs:
            value = e2e_values.get(spec["name"])
            if value is not None:
                metrics[spec["name"]] = {"value": float(value), "unit": spec["unit"]}

    # ---------------------------------------------------- correctness check
    missing = int((~answered).sum())
    picks = [(j, r) for j, r in _sample(win, traffic, seed) if win.dists[j] is not None]
    k = int(traffic["k"])
    port_d = np.concatenate([win.dists[j][r] for j, r in picks] or [np.zeros((0, k), np.float32)])
    port_i = np.concatenate([win.ids[j][r] for j, r in picks] or [np.zeros((0, k), np.int32)])
    rows = np.concatenate([win.rows[j][r] for j, r in picks] or [np.zeros(0, np.int64)])
    del loop, col, win, pool
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    wrong = 0
    if len(rows):
        t_ref = time.perf_counter()
        again = inputs.make_inputs(config, traffic, seed, pool_n, dev)
        if again.digest != digest or again.r0 != r0:
            raise RuntimeError("regenerated inputs differ from the run's: no comparison possible")
        ref = reference_for(config, again)
        Q = torch.from_numpy(again.pool[rows]).to(dev)
        ref_d, ref_i = ref.search(Q, k=int(traffic["k"]), r0=r0, steps=int(traffic["steps"]))
        wrong = judge.wrong_answers(port_d, port_i, ref_d.cpu().numpy(), ref_i.cpu().numpy())
        true_d = brute_force_knn(again.data, Q[:1024], int(traffic["k"])).cpu().numpy()
        recall, ratio = judge.quality(port_d[:1024], true_d)
        say(f"reference: {len(rows)} sampled answers of {len(picks)} requests compared in "
            f"{time.perf_counter() - t_ref:.3f} s; recall@{traffic['k']} {recall:.4f}, "
            f"overall ratio {ratio:.6f} (exact neighbours of {true_d.shape[0]} queries); "
            f"r0 {r0!r}")
    if summary is not None:
        say(f"trace: busy {summary.busy_s():.6f} s of {summary.window_s:.6f} s; "
            f"device ops {len(summary.ops)}")
    checks = {"wrong": {"value": wrong, "limit": 0}, "missing": {"value": missing, "limit": 0}}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and len(rows) > 0
    result = {"correct": bool(correct), "attempted": int(len(answered)), "failed": missing,
              "metrics": metrics, "device": device_info}
    if summary is not None:
        result["breakdown"] = {"device_ops": summary.top_ops(), "idle_gaps": summary.idle_gaps()}
    result["checks"] = checks
    return result, side


def _sample(win: loadgen.Window, traffic: dict, seed: int) -> list[tuple[int, np.ndarray]]:
    """The answers compared: ``check_requests`` requests drawn from the
    seed over every request of the window, and ``check_rows`` of each
    one's queries (all of a smaller request), as (request, query rows)."""
    R = len(win.due)
    rng = np.random.default_rng((int(seed) * 7919 + 17) % (1 << 63))
    picks = sorted(int(j) for j in rng.choice(R, size=min(R, int(traffic["check_requests"])),
                                              replace=False))
    per = int(traffic["check_rows"])
    out = []
    for j in picks:
        m = int(win.queries[j])
        out.append((j, np.sort(rng.choice(m, size=per, replace=False)) if m > per
                    else np.arange(m)))
    return out
