"""A tiny run of each cell's path on the CPU prints a well-formed result;
the command refuses to run without a card and prints no result."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark.harness import spec
from benchmark.tests.helpers import CELLS, cell, run_tiny, tiny_result


def _well_formed(result, cell_, trace):
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert result["correct"] is True
    assert result["attempted"] > 0 and result["failed"] == 0
    dev = result["device"]
    assert set(dev) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert dev["count"] == cell_.chips
    if trace:
        assert "busy_s" in dev and "window_s" in dev
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        # on the CPU only the spans are measured: no device metric
        spans = {"act_ms_per_slot", "env_ms_per_slot", "train_event_ms"}
        assert set(result["metrics"]) == {
            m.name for m in cell_.per_layer if m.name in spans}
    else:
        assert set(result["metrics"]) == {m.name for m in cell_.end_to_end}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(result)


@pytest.mark.parametrize("name", CELLS)
def test_tiny_run(name):
    _well_formed(tiny_result(name), cell(name), False)


def test_tiny_traced_run():
    name = CELLS[0]
    _well_formed(run_tiny(name, trace=True), cell(name), True)


def test_no_card_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run(
        [sys.executable, os.path.join(spec.BENCH_DIR, "run.py"),
         "--workload", CELLS[0], "--seed", str(2 ** 31 + 7), "--seconds",
         "1", "--trace", "0"], cwd=spec.ROOT, capture_output=True,
        text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    """A checkout that holds only BENCHMARK.json and the benchmark's files
    exits non-zero and prints no result."""
    import shutil
    shutil.copytree(spec.BENCH_DIR, tmp_path / "benchmark")
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode != 0
    assert out.stdout.strip() == ""


@pytest.mark.card
def test_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, os.path.join(spec.BENCH_DIR, "run.py"),
         "--workload", CELLS[0], "--seed",
         str(2 ** 31 + 11), "--seconds", "3", "--trace", "1"],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is True
    assert result["device"]["platform"] == "gpu"
