"""The benchmark's description, read by name: ``BENCHMARK.json`` at the
checkout's root names the cells and metrics; a cell's configuration is
``benchmark/configs/<config>.yaml``, its traffic ``benchmark/traffic/
<traffic>.json``, its limits ``benchmark/checks/<cell>.json``, the
algorithm module that runs it ``benchmark/algorithms/<algorithm>.py``
(the configuration's ``RLAgent.algorithm`` in lower case), and each
per-layer metric's reader ``benchmark/metrics/<metric>.py``.  Adding a
cell, a metric or an algorithm adds files and entries; no code here
changes."""

from __future__ import annotations

import importlib.util
import json
import os
import re
import sys
from dataclasses import dataclass

import yaml

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
# the core's traffic keys; an algorithm module declares its own
TRAFFIC_KEYS = {"num_envs", "mesh", "why"}


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
    algorithm: object          # the algorithm module
    root: str = BENCH_DIR      # the directory that holds the files above

    @property
    def config_path(self) -> str:
        return os.path.join(self.root, "configs", f"{self.config}.yaml")


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


def config_algorithm(path: str) -> str:
    """The ``RLAgent.algorithm`` that the configuration file names."""
    with open(path) as f:
        raw = yaml.safe_load(f)
    algo = (raw.get("RLAgent") or {}).get("algorithm") if isinstance(
        raw, dict) else None
    if not isinstance(algo, str):
        raise ValueError(f"{path}: names no RLAgent.algorithm")
    return check_name(algo)


def algorithm(name: str, root: str = BENCH_DIR):
    """The module ``<root>/algorithms/<name in lower case>.py``, loaded
    once a process for each file."""
    path = os.path.join(root, "algorithms", f"{check_name(name).lower()}.py")
    if not os.path.isfile(path):
        raise KeyError(f"algorithm {name!r} has no module: {path} is "
                       "missing (benchmark/README.md, \"An algorithm\")")
    module = "benchmark_algorithm_" + re.sub(r"\W", "_", name.lower())
    loaded = sys.modules.get(module)
    if loaded is not None and loaded.__file__ == path:
        return loaded
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    # registered before it runs: its dataclasses look their module up
    sys.modules[module] = mod
    try:
        spec.loader.exec_module(mod)
    except BaseException:
        del sys.modules[module]
        raise
    return mod


def cell(name: str, bench: dict | None = None, root: str = BENCH_DIR) -> Cell:
    """The cell ``name`` with its traffic, limits, metrics and algorithm
    module (its files under ``root``); raises on an unknown or malformed
    name, unit or file, on a configuration whose algorithm has no module,
    on a traffic key that neither the core nor the module declares, and
    on limits that name other numbers than the module's."""
    bench = load() if bench is None else bench
    check_name(name)
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = entries[name]
    config, traffic = check_name(w["config"]), check_name(w["traffic"])
    if config not in {c["name"] for c in bench["configs"]}:
        raise KeyError(f"{name}: no config {config!r}")
    algo = algorithm(config_algorithm(
        os.path.join(root, "configs", f"{config}.yaml")), root)
    params = load_json(os.path.join(root, "traffic", f"{traffic}.json"))
    unknown = set(params) - TRAFFIC_KEYS - set(algo.TRAFFIC_KEYS)
    if unknown:
        raise KeyError(f"traffic {traffic}: unknown keys {sorted(unknown)}")
    limits = load_json(os.path.join(root, "checks", f"{name}.json"))
    if set(limits["limits"]) != set(algo.LIMITS):
        raise KeyError(f"checks/{name}.json: limits {sorted(limits['limits'])}"
                       f" are not the algorithm's {sorted(algo.LIMITS)}")
    e2e = tuple(m for m in map(_metric, bench["end_to_end"])
                if _applies(m, name))
    layer = tuple(m for m in map(_metric, bench["per_layer"])
                  if _applies(m, name))
    return Cell(name, config, traffic, int(w["chips"]), params,
                limits["limits"], e2e, layer, algo, root)


def reader(metric: str, root: str = BENCH_DIR):
    """The ``read(ctx)`` function of ``<root>/metrics/<metric>.py``."""
    check_name(metric)
    path = os.path.join(root, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
