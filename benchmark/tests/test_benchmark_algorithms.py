"""The seam between the harness's core and its algorithm modules.

The core imports no agent code; a stub algorithm written outside the
benchmark's directory runs through ``cell.run`` with a traffic key and
limits of its own, with no file under benchmark/ edited; ``spec.cell``
refuses what no module declares; and the DRQN cells' tiny runs give the
slots and check numbers recorded before DRQN moved behind its module."""

import ast
import json
import os
import time

import pytest
import torch

from benchmark.harness import cell as cell_run
from benchmark.harness import spec
from benchmark.tests.helpers import CELLS, numbers, recorded, tiny_result

# agent code, which only an algorithm module (and the readings tool
# through it) may import
AGENT = ("diral_tpu_torch.agents", "diral_tpu_torch.train.loop",
         "diral_tpu_torch.models", "benchmark.reference.drqn",
         "benchmark.algorithms")


def _core_files() -> list:
    """run.py, every module of the harness, and every metric reader."""
    out = [os.path.join(spec.BENCH_DIR, "run.py")]
    for d in ("harness", "metrics"):
        root = os.path.join(spec.BENCH_DIR, d)
        out += [os.path.join(root, f) for f in sorted(os.listdir(root))
                if f.endswith(".py")]
    return out


def _imported(path: str) -> list:
    names = []
    for node in ast.walk(ast.parse(open(path).read())):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names += [node.module] + [f"{node.module}.{a.name}"
                                      for a in node.names]
    return names


def test_core_imports_no_agent_code():
    files = _core_files()
    assert {"cell.py", "spec.py", "inputs.py", "trace.py", "spans.py",
            "ranks.py", "run.py"} <= {os.path.basename(f) for f in files}
    for path in files:
        for name in _imported(path):
            assert not any(name == a or name.startswith(a + ".")
                           for a in AGENT), (path, name)


STUB = '''"""A stub algorithm: a few torch operations a slot on a vector of the
traffic's ``num_envs`` rows, in steps of its ``stub_slots`` slots; its
check repeats them in float64."""

import contextlib

import torch

TRAFFIC_KEYS = ("stub_slots",)
LIMITS = ("stub_gap",)
CONTROL = {}
EPISODE = 4


def supported(cfg):
    pass


def weights(cfg, seed, device):
    g = torch.Generator(device=device).manual_seed(seed)
    rows = cfg.engine.num_envs
    return {"w": torch.randn((rows, rows), generator=g, device=device)
            / rows}


class Capture:
    def __init__(self, seed):
        self.seed, self.seconds, self.x, self.slots = seed, 0.0, None, 0


class Session:
    layers = ("step",)

    def __init__(self, cfg, slots, seed, device):
        self.w = weights(cfg, seed, device)["w"]
        rows = self.w.shape[0]
        self.x = torch.ones(rows, device=device)
        self.slots = slots
        self.capture = Capture(seed)
        self.shapes = {"rows": rows}
        self.start, self.envs = 0, rows
        self.profiles = ((4, 8), (8, 12))
        self.spans = None

    def episode_end(self, s):
        return s % EPISODE == EPISODE - 1

    def steps(self, before, after):
        s = self.start
        while True:
            for _ in range(self.slots):
                before(s)
                if self.spans:
                    self.spans.begin("step")
                self.x = torch.tanh(self.w @ self.x + 0.5)
                if self.spans:
                    self.spans.end("step")
                after(s)
                s += 1
            self.capture.x = self.x.clone()
            self.capture.slots = s - self.start
            float(self.x.sum())
            yield s

    def events(self, lo, hi):
        return sum(1 for s in range(lo, hi) if self.episode_end(s))

    def wrap_layers(self, spans):
        self.spans = spans

        def undo():
            self.spans = None
        return undo

    def close(self):
        self.w = self.x = None


def set_up(cfg, traffic, seed, device, mesh=None):
    return Session(cfg, int(traffic["stub_slots"]), seed, device)


def check(capture, cfg, device):
    w = weights(cfg, capture.seed, device)["w"].double()
    x = torch.ones(w.shape[0], dtype=torch.float64, device=device)
    for _ in range(capture.slots):
        x = torch.tanh(w @ x + 0.5)
    return {"stub_gap": float((capture.x.double() - x).abs().max())}


def faults(mesh):
    return ()


def planted(fault):
    return contextlib.nullcontext()
'''

READER = '''def read(ctx):
    spans = ctx.spans.get("step")
    return sum(spans) / len(spans) if spans else None
'''


def _metric(name, unit, better, source="host_clock", **kw):
    return dict(name=name, unit=unit, better=better, source=source, **kw)


def _stub_root(tmp_path, algorithm="STUB", traffic=None, limits=None):
    """A benchmark directory under ``tmp_path`` with the stub's module, a
    configuration naming ``algorithm``, its traffic, limits and reader;
    returns (root, bench)."""
    root = tmp_path / "bench"
    for d in ("algorithms", "configs", "traffic", "checks", "metrics"):
        (root / d).mkdir(parents=True)
    (root / "algorithms" / "stub.py").write_text(STUB)
    (root / "metrics" / "stub_ms_per_step.py").write_text(READER)
    body = open(os.path.join(spec.BENCH_DIR, "configs",
                             "dynamic_20v_15r.yaml")).read()
    assert 'algorithm: "DRQN"' in body
    (root / "configs" / "stub_cfg.yaml").write_text(
        body.replace('algorithm: "DRQN"', f'algorithm: "{algorithm}"'))
    traffic = traffic or {"why": "a stub", "num_envs": 16, "stub_slots": 10}
    (root / "traffic" / "stub.json").write_text(json.dumps(traffic))
    limits = limits or {"stub_gap": 1e-4}
    (root / "checks" / "stub.cell.json").write_text(
        json.dumps({"limits": limits}))
    bench = {
        "configs": [{"name": "stub_cfg"}],
        "workloads": [{"name": "stub.cell", "config": "stub_cfg",
                       "traffic": "stub", "chips": 1}],
        "end_to_end": [_metric("env_slots_per_s", "slots/s", "higher"),
                       _metric("episode_ms_p90", "ms", "lower",
                               "device_trace"),
                       _metric("setup_s", "s", "lower")],
        "per_layer": [_metric("stub_ms_per_step", "ms", "lower",
                              "device_trace", layer="stub",
                              moves="env_slots_per_s")]}
    return str(root), bench


def _tree(path) -> dict:
    out = {}
    for d, dirs, files in os.walk(path):
        dirs[:] = [x for x in dirs if x != "__pycache__"]
        for f in files:
            st = os.stat(os.path.join(d, f))
            out[os.path.join(d, f)] = (st.st_size, st.st_mtime_ns)
    return out


@pytest.mark.parametrize("trace", [False, True])
def test_stub_algorithm_runs_through_the_core(tmp_path, trace):
    before = _tree(spec.BENCH_DIR)
    root, bench = _stub_root(tmp_path)
    stub = spec.cell("stub.cell", bench, root=root)
    assert stub.algorithm is spec.algorithm("STUB", root)
    result = cell_run.run(stub, 2 ** 31 + 99, 0.0, trace,
                          torch.device("cpu"), time.perf_counter(),
                          log=lambda *a: None)
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics",
                                "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True
    assert set(result["checks"]) == {"stub_gap"}
    assert result["checks"]["stub_gap"]["limit"] == 1e-4
    assert 0 <= result["checks"]["stub_gap"]["value"] <= 1e-4
    if trace:
        # the window runs past the stub's profiles, to slot 12
        assert result["attempted"] == 20
        assert set(result["metrics"]) == {"stub_ms_per_step"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert result["attempted"] == 10
        assert set(result["metrics"]) == {"env_slots_per_s",
                                          "episode_ms_p90", "setup_s"}
    assert _tree(spec.BENCH_DIR) == before


@pytest.mark.parametrize("fault", ["no_module", "traffic_key",
                                   "limit_missing", "limit_extra"])
def test_spec_refuses_what_no_module_declares(tmp_path, fault):
    kw = {"no_module": {"algorithm": "NOSUCH"},
          "traffic_key": {"traffic": {"why": "x", "num_envs": 2,
                                      "stub_slots": 2, "chunk_slots": 5}},
          "limit_missing": {"limits": {"act_gap": 1.0}},
          "limit_extra": {"limits": {"stub_gap": 1.0, "act_gap": 1.0}}}
    root, bench = _stub_root(tmp_path, **kw[fault])
    with pytest.raises(KeyError, match={
            "no_module": "has no module", "traffic_key": "chunk_slots",
            "limit_missing": "not the algorithm's",
            "limit_extra": "not the algorithm's"}[fault]):
        spec.cell("stub.cell", bench, root=root)


def test_drqn_module_found_by_the_configuration():
    for name in ("scale_100v_50r", "dynamic_20v_15r"):
        path = os.path.join(spec.BENCH_DIR, "configs", f"{name}.yaml")
        assert spec.config_algorithm(path) == "DRQN"
    drqn = spec.algorithm("DRQN")
    assert drqn.__file__ == os.path.join(spec.BENCH_DIR, "algorithms",
                                         "drqn.py")


@pytest.mark.parametrize("name", CELLS)
def test_tiny_run_equals_recorded(name):
    """Bit for bit the slots and check numbers recorded before DRQN moved
    behind its algorithm module."""
    assert numbers(tiny_result(name)) == recorded(name)
