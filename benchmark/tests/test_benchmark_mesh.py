"""The four-card cell's path at a tiny size on the CPU: four processes
joined over gloo, one env each.  Its result is well formed and correct,
with the mesh's per-layer metrics, and its slots and check numbers are
the recorded ones; with the window batch's all-reduce left out between
the ranks it comes out not correct."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.harness import ranks, spec
from benchmark.tests.helpers import MESH_CELL, numbers, recorded

HERE = os.path.dirname(os.path.abspath(__file__))


def _run(tmp_path, fault=None):
    port = ranks.free_port()
    out = tmp_path / "result.json"
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(HERE, "mesh_rank.py"), str(r),
         str(port), str(out)] + ([fault] if fault else []), env=env,
        cwd=spec.ROOT, stdout=subprocess.DEVNULL)
        for r in range(4)]
    codes = ranks.join(procs, timeout=600)
    assert codes == [0, 0, 0, 0]
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def sound(tmp_path_factory):
    """The sound run, shared by the tests that read it."""
    return _run(tmp_path_factory.mktemp("mesh"))


def test_mesh_cell_tiny(sound):
    result = sound
    assert result["correct"] is True
    assert result["device"]["count"] == 4
    assert list(result)[-1] == "checks"
    # the CPU has no device timeline: the NCCL readers find nothing
    assert result["metrics"] == {}


@pytest.mark.parametrize("fault", ["exchange"])
def test_mesh_fault_is_caught(tmp_path, fault):
    result = _run(tmp_path, fault)
    assert not result["correct"]


def test_mesh_cell_equals_recorded(sound):
    """Bit for bit the slots and check numbers recorded before DRQN moved
    behind its algorithm module."""
    assert numbers(sound) == recorded(MESH_CELL)
