"""Runs of the harness at small sizes on the CPU (the kernels' plain
twins): the plain reference against ``repro_torch``, the TF32 control
and the planted faults coming out as not correct, the closed loop's
pool and the check's sample, and a cell with a new configuration, mix,
loop kind and metric added by files and entries alone."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import control, harness, inputs, judge
from perfbench.reference.dblsh import round_tf32

torch.set_num_threads(1)

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SEEDS = (3, 2**31 + 7, 4_000_000_019)
SMALL = {  # the cells' own mixes and index settings on a small collection
    "sift10m.batch256": {"config": {"n": 12_000, "d": 48},
                         "traffic": {"batch": 64, "pool_per_s": 2000, "check_requests": 4,
                                     "check_rows": 48}},
    "gist1m.batch1024": {"config": {"n": 6_000, "d": 96},
                         "traffic": {"batch": 64, "pool_per_s": 2000, "check_requests": 4,
                                     "check_rows": 48}},
}


def _run(cell, seed, trace=False, seconds=0.6):
    return harness.run_cell(cell, seed, seconds, trace, device="cpu", overrides=SMALL[cell])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", ["sift10m.batch256", "gist1m.batch1024"])
def test_reference_answers_as_the_port(cell, seed):
    """The port's index and search (``build`` + ``Collection.search``,
    kernel B1's twin) against the reference, bit for bit."""
    config, traffic, _, _ = harness.cell_setup(cell, SMALL[cell])
    inp = inputs.make_inputs(config, traffic, seed, 512, "cpu")
    col = harness.build_port(config, inp, "cpu")
    Q = torch.from_numpy(inp.pool[:256])
    kw = dict(k=traffic["k"], r0=inp.r0, steps=traffic["steps"])
    d, i = col.search(Q, **kw)
    rd, ri = harness.reference_for(config, inp).search(Q, **kw)
    assert judge.wrong_answers(d.numpy(), i.numpy(), rd.numpy(), ri.numpy()) == 0
    assert bool((i < config["n"]).all())  # every query answered in full


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_the_inputs_do_not_depend_on_the_pool_size(cell):
    """A run's inputs are its seed's whatever its length: the vectors, the
    hash functions and the pool's first rows (so r0) come out the same."""
    config, traffic, _, _ = harness.cell_setup(cell, SMALL[cell])
    a = inputs.make_inputs(config, traffic, SEEDS[1], 600, "cpu")
    b = inputs.make_inputs(config, traffic, SEEDS[1], 70_000, "cpu")
    assert torch.equal(a.data, b.data) and torch.equal(a.proj, b.proj)
    assert np.array_equal(a.pool, b.pool[:600]) and a.r0 == b.r0
    assert a.digest[0] == b.digest[0] and a.digest[2] == b.digest[2]
    assert not np.array_equal(b.pool[:600], b.pool[600:1200])


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_run_is_correct_and_reports_its_metrics(cell):
    traced = cell == "gist1m.batch1024"
    result, side = _run(cell, SEEDS[1], trace=traced)
    assert result["correct"] and result["failed"] == 0 and result["attempted"] > 0
    if traced:  # the host span's reader finds its spans on the CPU too
        assert "search.host_ms.batch" in result["metrics"]
    assert list(result)[-1] == "checks"
    assert result["checks"] == {"wrong": {"value": 0, "limit": 0},
                                "missing": {"value": 0, "limit": 0}}
    assert any(line.startswith("reference:") for line in side)


# the control needs points dense enough in projection that TF32's
# rounding of the hash functions reorders them
CONTROL = {"sift10m.batch256": SMALL["sift10m.batch256"],
           "gist1m.batch1024": {"config": {"n": 40_000, "d": 96},
                                "traffic": {"pool_per_s": 1024, "check_requests": 8,
                                            "check_rows": 64}}}


@pytest.mark.parametrize("cell", sorted(CONTROL))
def test_the_tf32_control_is_not_correct(cell):
    for seed in SEEDS:
        out = control.control(cell, seed, device="cpu", seconds=1.0, overrides=CONTROL[cell])
        assert out["wrong_fp32"] == 0 and out["wrong_tf32"] > 0, out


def test_the_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, -2.0 - 2**-10, 2.5 + 3 * 2**-10])
    got = round_tf32(x)  # to nearest, ties to even, 10 mantissa bits
    assert got.dtype == torch.float32
    assert got.tolist() == [1.0, 1.0, 1.0 + 2**-9, -2.0, 2.5 + 2**-8]


def _altered(orig):
    """B1 with one id of every answer bin replaced: an answer altered where
    it is produced."""
    def fused(*a, **kw):
        bd, bi, cnt = orig(*a, **kw)
        bi = bi.clone()
        bi[:, 0, 0] = torch.where(bi[:, 0, 0] > 0, bi[:, 0, 0] - 1, bi[:, 0, 0] + 1)
        return bd, bi, cnt
    return fused


def _half_left_out(orig):
    """``Collection.search`` answering only the first half of each batch."""
    def search(self, Q, *a, **kw):
        out = list(orig(self, Q, *a, **kw))
        half = (Q.shape[0] + 1) // 2
        out[0] = out[0].clone()
        out[1] = out[1].clone()
        out[0][half:] = torch.inf
        out[1][half:] = self.index.n
        return tuple(out)
    return search


@pytest.mark.parametrize("fault", ["altered", "half"])
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_broken_port_is_not_correct(cell, fault, monkeypatch):
    from repro_torch import kernels
    from repro_torch.store import Collection

    if fault == "altered":
        monkeypatch.setattr(kernels, "fused_window_search", _altered(kernels.fused_window_search))
    else:
        monkeypatch.setattr(Collection, "search", _half_left_out(Collection.search))
    result, _ = _run(cell, SEEDS[0])
    assert not result["correct"] and result["checks"]["wrong"]["value"] > 0


class _Answers:
    """A collection that answers every query with its own first value, so
    a window's answers show which pool rows it sent."""

    def search(self, Q, k, r0, steps):
        return Q[:, :1].repeat(1, k), torch.zeros((Q.shape[0], k), dtype=torch.int32)


class _Tracer:
    def arm(self, t0, seconds):
        pass

    def tick(self, t):
        pass


def test_the_closed_loop_sends_each_pool_row_once():
    """The pool covers the window: every query sent is a distinct pool row
    while the rate stays under ``pool_per_s``, and the warm-up's rows are
    never the window's; past it the loop starts the pool again."""
    loops = harness.load_module("loops", "closed")
    traffic = {"batch": 8, "pool_per_s": 4000, "k": 2, "steps": 1}
    P = loops.pool_rows(traffic, 0.05)
    assert P == 200 + 16
    pool = np.arange(P, dtype=np.float32)[:, None].repeat(3, axis=1)
    warm = []

    class Warm(_Answers):
        def search(self, Q, **kw):
            warm.append(Q[:, 0].tolist())
            return super().search(Q, **kw)

    loop = loops.Loop(traffic, Warm(), pool, 1.0)
    loop.warm_up()
    assert warm == [list(range(200, 208)), list(range(208, 216))]
    loop.col = _Answers()
    win = loop.run(0.05, _Tracer(), 1)
    sent = np.concatenate([d[:, 0] for d in win.dists]).astype(np.int64)
    assert sent.tolist() == np.concatenate(win.rows).tolist()
    first = sent[:200]
    assert len(set(first.tolist())) == len(first) and first.max() < 200
    assert win.pool_passes == pytest.approx(len(sent) / 200)
    if len(sent) > 200:  # a fast enough host wraps: the second pass repeats the first
        assert sent[200:400].tolist() == list(range(len(sent[200:400])))


def test_the_check_samples_rows_of_many_requests():
    from perfbench import loadgen

    R, B = 50, 16
    win = loadgen.Window(t0=0.0, t_end=1.0, due=np.zeros(R), done=np.ones(R),
                         queries=np.full(R, B), rows=[np.arange(B) + B * j for j in range(R)],
                         dists=[None] * R, ids=[None] * R, spans=[])
    picks = harness._sample(win, {"check_requests": 20, "check_rows": 5}, 7)
    assert len({j for j, _ in picks}) == 20
    assert all(len(r) == 5 and len(set(r.tolist())) == 5 and r.max() < B for _, r in picks)
    assert [(j, r.tolist()) for j, r in picks] == [
        (j, r.tolist()) for j, r in harness._sample(win, {"check_requests": 20, "check_rows": 5}, 7)]
    small = harness._sample(win, {"check_requests": 80, "check_rows": 40}, 7)
    assert len(small) == R and all(len(r) == B for _, r in small)


def test_a_cell_is_added_by_files_and_entries_alone(tmp_path):
    """A copy of the benchmark with a new configuration, a new mix read by
    a new kind of loop, and a new per-layer metric -- files and
    ``BENCHMARK.json`` entries only -- runs its new cell."""
    shutil.copytree(HERE, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((HERE / "configs" / "gist1m.json").read_text())
    cfg.update(name="tiny", n=3000, d=24)
    (tmp_path / "perfbench" / "configs" / "tiny.json").write_text(json.dumps(cfg))
    (tmp_path / "perfbench" / "traffic" / "batch32.json").write_text(json.dumps(
        {"loop": "paced", "batch": 32, "gap_s": 0.01, "k": 5, "r0_nn": 0.5, "steps": 6,
         "nn_sample": 64, "check_requests": 3, "check_rows": 20, "trace_seconds": 1}))
    (tmp_path / "perfbench" / "loops" / "paced.py").write_text(PACED)
    (tmp_path / "perfbench" / "metrics" / "window.requests.py").write_text(
        "def read(run):\n    return len(run.window.due)\n")
    bench["configs"].append({"name": "tiny", "source": "a test", "file": "perfbench/configs/tiny.json",
                             "reduced": [], "why": "a test"})
    bench["workloads"].append({"name": "tiny.batch32", "config": "tiny", "traffic": "batch32",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "window.requests", "unit": "requests", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "queries_per_s", "workloads": ["tiny.batch32"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys, torch; torch.set_num_threads(1); "
            "from perfbench import harness; "
            "r, _ = harness.run_cell('tiny.batch32', 11, 0.4, True, device='cpu'); "
            "print(json.dumps(r))")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=tmp_path, timeout=600, check=False,
                          env={"PYTHONPATH": f"{tmp_path}:{ROOT / 'src'}", "PATH": "/usr/bin:/bin",
                               "HOME": str(tmp_path)})
    assert proc.returncode == 0, proc.stderr[-3000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"]
    assert result["metrics"]["window.requests"]["value"] >= 1
    assert result["checks"]["wrong"]["value"] == 0


# a loop kind of its own: one batch every ``gap_s`` seconds, each timed
# from when it was due
PACED = """
import math, time
import numpy as np
import torch
from perfbench.loadgen import Timed, Window


def pool_rows(traffic, seconds):
    return int(traffic["batch"]) * (int(math.ceil(seconds / traffic["gap_s"])) + 2)


class Loop:
    def __init__(self, traffic, col, pool, r0):
        self.col, self.pool, self.B = col, pool, int(traffic["batch"])
        self.gap = float(traffic["gap_s"])
        self.kw = dict(k=int(traffic["k"]), r0=r0, steps=int(traffic["steps"]))

    def warm_up(self):
        self.col.search(torch.from_numpy(self.pool[-self.B:]), **self.kw)

    def run(self, seconds, tracer, seed):
        timed = Timed(self.col.search)
        t0 = time.perf_counter()
        tracer.arm(t0, seconds)
        N = int(seconds / self.gap)
        due = t0 + self.gap * np.arange(N)
        done, rows, dl, il = [], [], [], []
        for i in range(N):
            while time.perf_counter() < due[i]:
                time.sleep(1e-4)
            tracer.tick(time.perf_counter())
            r = np.arange(i * self.B, (i + 1) * self.B)
            d, ids = timed(torch.from_numpy(self.pool[r]), **self.kw)
            dl.append(d.cpu().numpy())
            il.append(ids.cpu().numpy())
            done.append(time.perf_counter())
            rows.append(r)
        return Window(t0=t0, t_end=done[-1], due=due, done=np.array(done),
                      queries=np.full(N, self.B), rows=rows, dists=dl, ids=il,
                      spans=timed.spans, pool_passes=N * self.B / (len(self.pool) - self.B))
"""


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: kernel B1 runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_small_run_on_the_card_is_correct(cell, card):
    result, _ = harness.run_cell(cell, SEEDS[2], 2.0, True, device=card, overrides=SMALL[cell])
    assert result["correct"] and result["device"]["busy_s"] > 0
    assert np.isfinite([m["value"] for m in result["metrics"].values()]).all()
