"""The benchmark's description, read by name: ``BENCHMARK.json`` at the
checkout's root names the cells and metrics; a cell's configuration is
``benchmark/configs/<config>.yaml``, its traffic ``benchmark/traffic/
<traffic>.json``, its limits ``benchmark/checks/<cell>.json``, and each
per-layer metric's reader ``benchmark/metrics/<metric>.py``.  Adding a
cell or a metric adds files and entries; no code here changes."""

from __future__ import annotations

import importlib.util
import json
import os
import re
from dataclasses import dataclass

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
TRAFFIC_KEYS = {"num_envs", "chunk_slots", "start_slot", "mesh", "why"}


def check_name(name: str) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise ValueError(f"bad name {name!r}")
    return name


def check_unit(unit: str) -> str:
    if not isinstance(unit, str) or not UNIT.match(unit):
        raise ValueError(f"bad unit {unit!r}")
    return unit


@dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    workloads: tuple | None


@dataclass(frozen=True)
class Cell:
    name: str
    config: str
    traffic: str
    chips: int
    traffic_params: dict
    limits: dict
    end_to_end: tuple
    per_layer: tuple

    @property
    def config_path(self) -> str:
        return os.path.join(BENCH_DIR, "configs", f"{self.config}.yaml")


def _metric(entry: dict) -> Metric:
    name = check_name(entry["name"])
    if entry.get("better") not in ("lower", "higher"):
        raise ValueError(f"{name}: better must be lower or higher")
    if entry.get("source") not in SOURCES:
        raise ValueError(f"{name}: bad source {entry.get('source')!r}")
    wl = entry.get("workloads")
    if wl is not None:
        wl = tuple(check_name(w) for w in wl)
    return Metric(name, check_unit(entry["unit"]), wl)


def _applies(metric: Metric, cell: str) -> bool:
    return metric.workloads is None or cell in metric.workloads


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def load(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` with its traffic, limits and metrics; raises on
    an unknown or malformed name, unit or file."""
    bench = load() if bench is None else bench
    check_name(name)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = entries[name]
    config, traffic = check_name(w["config"]), check_name(w["traffic"])
    if config not in {c["name"] for c in bench["configs"]}:
        raise KeyError(f"{name}: no config {config!r}")
    params = load_json(os.path.join(BENCH_DIR, "traffic", f"{traffic}.json"))
    unknown = set(params) - TRAFFIC_KEYS
    if unknown:
        raise KeyError(f"traffic {traffic}: unknown keys {sorted(unknown)}")
    limits = load_json(os.path.join(BENCH_DIR, "checks", f"{name}.json"))
    e2e = tuple(m for m in map(_metric, bench["end_to_end"])
                if _applies(m, name))
    layer = tuple(m for m in map(_metric, bench["per_layer"])
                  if _applies(m, name))
    return Cell(name, config, traffic, int(w["chips"]), params,
                limits["limits"], e2e, layer)


def reader(metric: str):
    """The ``read(ctx)`` function of ``benchmark/metrics/<metric>.py``."""
    check_name(metric)
    path = os.path.join(BENCH_DIR, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
