"""Tiny CPU runs of a cell's path for the tests: the cell's configuration
with two envs, a 256-slot ring and batches of 8 rows (widths as
configured), a window of one 50-slot chunk (traced: its 50-slot chunks to
the profiles' end)."""

import dataclasses
import functools
import json
import os
import time

import torch

from benchmark.harness import spec

TINY = {"engine.num_envs": 2, "memory_size": 256, "agent.batch_size": 8}
SEED = 2 ** 31 + 12345      # beyond 32 signed bits, as the driver's are
MESH_CELL = "scale100v50r.train.envs4096.data4"
# a cell whose files are kept but which BENCHMARK.json holds back (its
# pace is the host's): its tiny runs keep the reference's plain channel
# walk and velocity kicks under test
HELD_BACK = {"name": "dynamic20v15r.train.envs8192",
             "config": "dynamic_20v_15r", "traffic": "train.envs8192",
             "chips": 1}
CELLS = ("scale100v50r.train.envs1024", HELD_BACK["name"])
# attempted and the check's numbers of the tiny runs as recorded before
# DRQN moved behind its algorithm module (see the file's "source")
RECORDED = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "expected_tiny_runs.json")


def cell(name: str) -> spec.Cell:
    """The cell ``name`` of BENCHMARK.json or the held-back one."""
    bench = spec.load()
    bench["configs"].append({"name": HELD_BACK["config"]})
    bench["workloads"].append(HELD_BACK)
    return spec.cell(name, bench)


def run_tiny(name: str, trace: bool = False, seed: int = SEED,
             overrides=None, **mesh):
    from benchmark.harness import cell as cell_run
    over = dict(TINY, **(overrides or {}))
    cell_ = cell(name)
    cell_ = dataclasses.replace(cell_, traffic_params=dict(
        cell_.traffic_params, chunk_slots=50))
    return cell_run.run(cell_, seed, 0.01, trace,
                        torch.device("cpu"), time.perf_counter(),
                        overrides=over, log=lambda *a: None, **mesh)


@functools.cache
def tiny_result(name: str) -> dict:
    """``run_tiny(name)`` at its defaults, run once a process: the tests
    that read it share the run."""
    return run_tiny(name)


def recorded(name: str) -> dict:
    with open(RECORDED) as f:
        return json.load(f)["runs"][name]


def numbers(result: dict) -> dict:
    """A result's ``attempted`` and its check values, as recorded."""
    return {"attempted": result["attempted"],
            "checks": {k: c["value"] for k, c in result["checks"].items()}}
