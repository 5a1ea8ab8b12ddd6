"""The benchmark's layout: every cell, configuration, mix, metric and
kernel work count is found by name; ``BENCHMARK.json`` keeps the
contract's shapes; nothing here imports JAX or the JAX package; the
statistics are the ones named."""

from __future__ import annotations

import ast
import json
import math
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import harness, judge

torch.set_num_threads(1)

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_cell_finds_its_files_by_name():
    names = {c["name"] for c in BENCH["configs"]}
    for wl in BENCH["workloads"]:
        assert wl["config"] in names
        config = harness.load_config(wl["config"])
        traffic = harness.load_traffic(wl["traffic"])
        assert config["name"] == wl["config"]
        loop = harness.load_loop(traffic)
        assert callable(loop.pool_rows) and callable(loop.Loop)
        e2e, layer = harness.cell_metrics(BENCH, wl["name"])
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
    for cfg in BENCH["configs"]:
        assert (ROOT / cfg["file"]).is_file() and cfg["file"].startswith("perfbench/")
    for m in BENCH["per_layer"]:
        assert callable(harness.load_module("metrics", m["name"]).read)
        if m["name"].endswith("_roofline"):
            mod = harness.load_module("roofline", m["name"][:-len("_roofline")])
            assert callable(mod.work) and callable(mod.record) and mod.KERNEL


def test_benchmark_json_keeps_the_contract_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"] and BENCH["paths"] == ["perfbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]) and entry["name"] not in seen
            seen.add(entry["name"])
    for wl in BENCH["workloads"]:
        assert set(wl) == {"name", "config", "traffic", "chips", "why"}
        assert wl["chips"] == 1 and 1 <= len(wl["why"]) <= 200
    for cfg in BENCH["configs"]:
        assert set(cfg) == {"name", "source", "file", "reduced", "why"}
        assert len(cfg["source"]) <= 200 and len(cfg["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert m["moves"] in {x["name"] for x in harness.cell_metrics(BENCH, cell)[0]}


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_nothing_imports_jax_or_the_jax_package():
    files = sorted(HERE.rglob("*.py"))
    assert files
    for path in files:
        found = _imports(path) & {"jax", "jaxlib", "flax", "repro", "benchmarks"}
        assert not found, f"{path.relative_to(ROOT)} imports {found}"
    for path in sorted((HERE / "reference").rglob("*.py")):
        assert "repro_torch" not in _imports(path), path


def test_forbidden_modules_compare_whole_top_level_names():
    assert harness.forbidden_loaded(["repro_torch", "repro_torch.core", "numpy"]) == []
    assert harness.forbidden_loaded(["repro_torch", "repro.core"]) == ["repro"]
    assert harness.forbidden_loaded(["jaxlib.xla_client", "flax"]) == ["flax", "jaxlib"]


def test_p95_is_taken_over_all_requests():
    lat = np.arange(1, 101, dtype=np.float64)  # 1..100 ms
    assert harness.p95(lat) == 95.0  # nearest rank: the 95th of 100
    assert harness.p95(lat[:20]) == 19.0
    # a request that never came counts, as an infinite latency
    assert harness.p95(np.concatenate([lat[:19], [math.inf]])) == 19.0
    assert harness.p95(np.concatenate([lat[:18], [math.inf, math.inf]])) == math.inf
    assert harness.p95(np.concatenate([lat, [math.inf]])) == 96.0


def test_b1_work_count_against_a_hand_computed_case():
    mod = harness.load_module("roofline", "fused_window_search")
    # 2 queries, S = 3 slots each over lnb = 10 blocks of B = 4 slots, K = 2, d = 3,
    # 2 steps, ks = 1; slot ids: block 7 twice, one invalid (10), one -1
    blk = torch.tensor([[1, 7, 10], [7, -1, 2]], dtype=torch.int32)
    halves = torch.zeros(2)
    proj = torch.zeros(10, 4, 2)
    x = torch.zeros(10, 4, 3)
    g, q = torch.zeros(2, 1, 2), torch.zeros(2, 3)
    rec = mod.record((blk, halves, proj, x, None, None, g, q), {"ks": 1})
    in_b, out_b, ops = mod.work(rec)
    # distinct valid blocks {1, 7, 2}: 12 rows of (K + 2) * 4 + d * 4 = 28 bytes;
    # the ids (6 x 4), halves (2), g (4) and q (6) in float32
    assert in_b == 6 * 4 + 12 * 28 + (2 + 4 + 6) * 4
    assert out_b == 2 * 2 * (1 * 8 + 4)
    # 4 valid slots of 4 rows: 3K + 2d + steps = 14 operations a row
    assert ops == {"fp32_flops": 16 * 14}


def test_judge_holds_answers_bit_for_bit():
    d = np.array([[1.0, 2.0], [3.0, np.inf]], np.float32)
    i = np.array([[4, 5], [6, 9]], np.int32)
    assert judge.wrong_answers(d, i, d.copy(), i.copy()) == 0
    d2 = d.copy()
    d2[0, 1] = np.nextafter(np.float32(2.0), np.float32(3.0))
    assert judge.wrong_answers(d2, i, d, i) == 1
    i2 = i.copy()
    i2[1, 0] = 7
    assert judge.wrong_answers(d, i2, d, i) == 1
    recall, ratio = judge.quality(np.array([[1.0, 3.0]]), np.array([[1.0, 2.0]]))
    assert recall == 0.5 and ratio == pytest.approx(1.25)


def test_run_prints_no_result_without_the_cards_it_needs(tmp_path):
    proc = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload", BENCH["workloads"][0]["name"],
         "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=tmp_path, timeout=300, check=False)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for a machine without one")
    assert proc.returncode == 2 and proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr
