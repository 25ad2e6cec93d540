"""The harness finds every cell, configuration, traffic, limit file and
metric reader by name, and BENCHMARK.json keeps to its contract."""

import json
import os

import pytest

from benchmark.harness import spec

BENCH = spec.load()


def test_every_cell_resolves():
    for w in BENCH["workloads"]:
        cell = spec.cell(w["name"], BENCH)
        assert os.path.exists(cell.config_path)
        assert {m.name for m in cell.end_to_end} >= {"setup_s"}
        assert len(cell.end_to_end) >= 2 and cell.per_layer
        assert set(cell.limits) == set(cell.algorithm.LIMITS)
        if cell.algorithm is spec.algorithm("DRQN"):
            assert set(cell.limits) == {"act_gap", "env_gap", "loss_gap",
                                        "grad_gap", "update_gap"}


def test_traffic_files_name_only_known_keys():
    for w in BENCH["workloads"]:
        cell = spec.cell(w["name"], BENCH)
        tp = cell.traffic_params
        assert set(tp) <= spec.TRAFFIC_KEYS | set(cell.algorithm.TRAFFIC_KEYS)
        assert {"num_envs", "why"} <= set(tp)
        if cell.algorithm is spec.algorithm("DRQN"):
            assert {"chunk_slots", "start_slot"} <= set(tp)


@pytest.mark.parametrize("n_batch,episodes", [(1, 4), (2, 2), (4, 2)])
def test_setup_runs_the_episodes_the_check_follows(n_batch, episodes):
    """A train event an episode: the check's gradient steps and the next
    one's loss, and at least two events."""
    from types import SimpleNamespace

    drqn = spec.algorithm("DRQN")
    cfg = SimpleNamespace(agent=SimpleNamespace(n_batch=n_batch))
    assert drqn.setup_episodes(cfg) == episodes


def test_every_reader_loads():
    for m in BENCH["per_layer"]:
        assert callable(spec.reader(m["name"]))


def test_configs_are_the_repo_configs_unchanged():
    """Every configuration file, a held-back cell's too."""
    root = spec.ROOT
    for c in BENCH["configs"]:
        assert c["reduced"] == []
        assert c["file"] == f"benchmark/configs/{c['name']}.yaml"
    for name in os.listdir(os.path.join(spec.BENCH_DIR, "configs")):
        body = open(os.path.join(spec.BENCH_DIR, "configs", name)).read()
        original = open(os.path.join(root, "configs", name)).read()
        assert body.endswith(original)
        header = body[:len(body) - len(original)]
        assert all(line.startswith("#") for line in header.splitlines())


@pytest.mark.parametrize("bad", ["", "a b", "a,b", "a/b", "x" * 65,
                                 "-lead", "ünïcode"])
def test_bad_names_refused(bad):
    with pytest.raises((ValueError, KeyError)):
        spec.cell(bad, BENCH)


@pytest.mark.parametrize("bad", ["", "tokens per second", "µs",
                                 "x" * 17])
def test_bad_units_refused(bad):
    with pytest.raises(ValueError):
        spec.check_unit(bad)


def test_unknown_cell_refused():
    with pytest.raises(KeyError):
        spec.cell("no.such.cell", BENCH)


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert len(json.dumps(BENCH)) < 64 * 1024
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [w["name"] for w in BENCH["workloads"]]
    names += [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        spec.check_name(n)
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        # every cell that reads the metric reports the metric it moves
        moved = e2e[m["moves"]].get("workloads")
        assert moved is None or set(m["workloads"]) <= set(moved)
        spec.check_unit(m["unit"])
        name = m["name"]
        assert name.endswith("_roofline") == ("roofline" in name)
        if "roofline" in name or "mfu" in name:
            assert m["unit"] == "%"
    configs = {c["name"] for c in BENCH["configs"]}
    assert configs == {w["config"] for w in BENCH["workloads"]}
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) \
        == len(BENCH["workloads"])
