"""The port's reference suite (diral_tpu_torch/scripts/ref_sweep.py) on the
CPU, against the JAX package's scripts/ref_sweep.py.

* The suite: ``load_suite()`` equals JAX's value for value, for all six
  configs (``state_space`` 13 / 23 / 43 included), and reads a
  reference YAML where one is given.
* Formulas: the rows equal what the JAX script computes on the same
  arrays (training and evaluation stubbed in both).
* Runs at cut widths (the flagship cut to 100 slots, nets 32/32): six
  rows with JAX's keys plus the port's; cut and resumed equals uncut;
  ``--jobs 2`` equals one process; ``run.json`` refuses another option;
  no run without ``--device cpu`` on a box without a card.
* The checks: the band's limit from the committed toy artifacts, each
  rule on rows that meet and miss it.
* The kernels' plans take the suite's widths: D = 13 and 43 (padded) at
  H = 256 and the suite's row counts.
"""

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import yaml

from diral_tpu_torch.config import load_config
from diral_tpu_torch.ops import lstm_window as K
from diral_tpu_torch.scripts import full_run, ref_sweep, seed_campaign
from diral_tpu_torch.train import checkpoint as ckpt
from diral_tpu_torch.train import evaluate, runner

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
EVAL = ["--eval-steps", "10", "--eval-envs", "2", "--device", "cpu"]
JAX_ROW_KEYS = ["config", "gamma", "num_bins", "state_space", "train_seconds",
                "slots_per_sec", "reward_curve_deciles",
                "final_mean_sum_reward", "drqn_prr", "sps_prr",
                "prr_improvement"]
ADDED_ROW = ["device", "resumed_from", "init_seconds", "loop_seconds",
             "eval_seconds"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Six xdist workers share the machine's cores: one intra-op thread
    each."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load_jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_script_ref_sweep", os.path.join(ROOT, "scripts", "ref_sweep.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cut_flagship(tmp_path_factory):
    """The flagship cut to a few train events in 100 slots, nets 32/32."""
    raw = yaml.safe_load(open(os.path.join(ROOT, "configs",
                                           "toy_4ue_3r.yaml")))
    raw.update(time_slots=100, episode_interval=5, memory_size=64,
               pretrain_length=1, explore=20, greedy=70, training_stop=90)
    raw["RLAgent"].update(batch_size=8)
    raw["RLAgent"]["network"]["layers"] = {1: 32, 2: 32}
    path = tmp_path_factory.mktemp("cfg") / "cut.yaml"
    path.write_text(yaml.safe_dump(raw))
    return load_config(str(path))


@pytest.fixture
def cut_suite(cut_flagship, monkeypatch):
    monkeypatch.setattr(ref_sweep, "toy_4ue_3r", lambda: cut_flagship)


def _suite(root, *extra):
    return ref_sweep.main([str(root), *EVAL, *extra])


@pytest.fixture(scope="module")
def uncut(cut_flagship, tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setattr(ref_sweep, "toy_4ue_3r", lambda: cut_flagship)
    try:
        root = tmp_path_factory.mktemp("uncut")
        return root, _suite(root / "sweep", "--save-freq", "20")
    finally:
        mp.undo()


def _results_of(rows):
    return [{k: v for k, v in r.items() if k not in seed_campaign.RUN_FIELDS}
            for r in rows]


def test_suite_equals_jax_suite():
    jax = _load_jax_script()
    ref = jax.REF_CONFIG_DIR if os.path.isdir(jax.REF_CONFIG_DIR) else None
    theirs = jax.load_suite()
    mine = ref_sweep.load_suite(ref)
    assert [n for n, _ in mine] == [n for n, _ in theirs] == [
        n for n, _, _ in jax.SUITE] == [n for n, _, _ in ref_sweep.SUITE]
    for (name, m), (_, t) in zip(mine, theirs):
        assert dataclasses.asdict(m) == dataclasses.asdict(t), name
        assert m.env.state_space == t.env.state_space, name
    assert [c.env.state_space for _, c in mine] == [13, 23, 23, 23, 23, 43]
    assert [(c.agent.gamma, c.env.state.num_bins) for _, c in mine] == [
        (g, b) for _, g, b in jax.SUITE]
    assert dict(mine)[ref_sweep.FLAGSHIP] == load_config(
        os.path.join(ROOT, "configs", "toy_4ue_3r.yaml"))


def test_suite_reads_reference_yamls(tmp_path):
    """A config file in the reference directory is loaded as it is."""
    raw = yaml.safe_load(open(os.path.join(ROOT, "configs",
                                           "toy_4ue_3r.yaml")))
    raw["RLAgent"]["gamma"] = 0.3
    raw["memory_size"] = 2048
    name = ref_sweep.SUITE[1][0]
    (tmp_path / f"config_toy_4ue_3r_tests_db_{name}.yaml").write_text(
        yaml.safe_dump(raw))
    suite = dict(ref_sweep.load_suite(str(tmp_path)))
    assert suite[name].memory_size == 2048 and suite[name].agent.gamma == 0.3
    assert suite[ref_sweep.FLAGSHIP].memory_size == 1024


def test_rows_match_jax_formulas(monkeypatch, tmp_path):
    """The JAX script's row formulas, on stubbed training and
    evaluation, against the port's on the same arrays."""
    import diral_tpu.train.evaluate as jeval
    import diral_tpu.train.runner as jrunner

    rng = np.random.RandomState(5)
    names = [n for n, _, _ in ref_sweep.SUITE]
    sums = {n: rng.normal(-3.0, 2.0, (37, 1)).astype(np.float32)
            for n in names}
    comps = {}
    for n in names:
        drqn, sps = rng.uniform(0.4, 0.9, 2)
        comps[n] = {"drqn": {"mean_prr": float(drqn)},
                    "sps": {"mean_prr": float(sps)},
                    "prr_improvement": float(drqn / sps - 1.0)}

    monkeypatch.setattr(
        jrunner, "train_experiment",
        lambda cfg, workdir=".", seed=0, **kw: (
            types.SimpleNamespace(learner=cfg.experiment_name),
            {"sum_reward": sums[cfg.experiment_name]}))
    monkeypatch.setattr(jeval, "compare_drqn_vs_sps",
                        lambda cfg, learner, key, steps: comps[learner])

    def port_train(cfg, workdir=".", seed=0, timing=None, **kw):
        timing.update(start_slot=0, init_seconds=0.0, loop_seconds=1.0)
        return (types.SimpleNamespace(learner=types.SimpleNamespace(
            params=cfg.experiment_name)),
            {"sum_reward": sums[cfg.experiment_name]})

    monkeypatch.setattr(runner, "train_experiment", port_train)
    monkeypatch.setattr(evaluate, "compare_drqn_vs_sps",
                        lambda cfg, params, seed, steps, **kw: comps[params])
    jax = _load_jax_script()
    monkeypatch.setattr(sys, "argv", ["ref_sweep.py", str(tmp_path / "jax"),
                                      "--slots", "37"])
    jax.main()
    with open(tmp_path / "jax" / "sweep.json") as f:
        theirs = json.load(f)
    mine = ref_sweep.main([str(tmp_path / "port"), "--slots", "37",
                           "--device", "cpu"])
    timing = {"train_seconds", "slots_per_sec"}
    assert ([{k: v for k, v in r.items() if k not in timing}
             for r in theirs]
            == [{k: r[k] for k in JAX_ROW_KEYS if k not in timing}
                for r in mine["rows"]])


def test_six_rows_with_jax_keys(uncut):
    root, art = uncut
    with open(os.path.join(ROOT, "results", "ref_sweep.json")) as f:
        assert list(json.load(f)[0]) == JAX_ROW_KEYS
    assert [list(r) for r in art["rows"]] == [JAX_ROW_KEYS + ADDED_ROW] * 6
    with open(root / "sweep" / "sweep.json") as f:
        assert json.load(f) == art["rows"]
    assert [r["state_space"] for r in art["rows"]] == [13, 23, 23, 23, 23, 43]
    assert [r["config"] for r in art["rows"]] == [
        n for n, _, _ in ref_sweep.SUITE]
    assert set(art) >= {"rows", "device", "cli", "checks"}
    assert art["device"] == {"name": "cpu", "power_limit": None}
    for r in art["rows"]:
        assert len(r["reward_curve_deciles"]) == 10
        assert r["final_mean_sum_reward"] == r["reward_curve_deciles"][-1]
        assert 0.0 <= r["drqn_prr"] <= 1.0 and 0.0 <= r["sps_prr"] <= 1.0
        assert np.isfinite(r["prr_improvement"])
        assert r["resumed_from"] == []
    # SPS reads no state: one PRR for the six
    assert art["checks"]["sps_equal"]["met"]
    # each config's workdir: run.json, summary.json, its checkpoints
    for name, _, _ in ref_sweep.SUITE:
        files = os.listdir(root / "sweep" / name)
        assert {"run.json", "summary.json"} <= set(files)


def test_cut_suite_resumes_equal_to_uncut(uncut, cut_suite, tmp_path,
                                          monkeypatch):
    """Cut by a checkpoint write that raises after the second config's
    second checkpoint, then started again: the first config is read
    back, the second resumes, the rest run; the rows equal uncut."""
    _, art = uncut
    second = ref_sweep.SUITE[1][0]
    real_save, saves = ckpt.save, []

    def cutting_save(directory, step, *a, **k):
        path = real_save(directory, step, *a, **k)
        if f"{os.sep}{second}{os.sep}" in str(directory):
            saves.append(step)
            if len(saves) == 2:
                raise RuntimeError("cut")
        return path

    monkeypatch.setattr(ckpt, "save", cutting_save)
    with pytest.raises(RuntimeError, match="cut"):
        _suite(tmp_path / "sweep", "--save-freq", "20")
    monkeypatch.setattr(ckpt, "save", real_save)
    ran = []
    real_run = full_run.run

    def spy(*a, **k):
        ran.append(k["name"])
        return real_run(*a, **k)
    monkeypatch.setattr(full_run, "run", spy)
    again = _suite(tmp_path / "sweep", "--save-freq", "20")
    assert saves == [20, 40]
    assert ran == [n for n, _, _ in ref_sweep.SUITE[1:]]
    assert [r["resumed_from"] for r in again["rows"]] == [[], [40]] + [[]] * 4
    assert _results_of(again["rows"]) == _results_of(art["rows"])


def test_jobs_give_the_rows_of_one_process(uncut, cut_suite, tmp_path,
                                           monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    _, art = uncut
    two = _suite(tmp_path / "sweep", "--save-freq", "20", "--jobs", "2")
    assert _results_of(two["rows"]) == _results_of(art["rows"])


def test_run_json_refuses_another_option(uncut, cut_suite):
    root, _ = uncut
    with pytest.raises(ValueError, match="eval_steps was 10"):
        ref_sweep.main([str(root / "sweep"), "--save-freq", "20",
                        "--eval-steps", "11", "--eval-envs", "2",
                        "--device", "cpu"])
    with pytest.raises(ValueError, match="save_freq was 20"):
        _suite(root / "sweep")


def test_run_json_refuses_another_config(uncut, cut_flagship, monkeypatch):
    """The same name with other config values is another run."""
    root, _ = uncut
    monkeypatch.setattr(ref_sweep, "toy_4ue_3r", lambda: dataclasses.replace(
        cut_flagship, memory_size=32))
    with pytest.raises(ValueError, match="config_sha256"):
        _suite(root / "sweep", "--save-freq", "20")


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a box without a GPU")
def test_no_silent_cpu_fallback(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-m", "diral_tpu_torch.scripts.ref_sweep",
         str(tmp_path / "sweep"), "--slots", "10"], cwd=ROOT, env=env,
        capture_output=True, text=True)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert not os.listdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ref_sweep.main([str(tmp_path / "sweep"), "--slots", "10"])


def _jax_rows():
    with open(os.path.join(ROOT, "results", "ref_sweep.json")) as f:
        return json.load(f)


def test_checks_on_the_committed_artifacts():
    """The band's limit is 3 sqrt(s_jax^2 + s_port^2) of the two
    packages' toy full runs (0.0526); JAX's own rows meet every held rule
    but determinism, which holds the flagship row to the port's toy seed
    0 run."""
    jax = _jax_rows()
    suite = ref_sweep.load_suite()
    c = ref_sweep.suite_checks(jax, suite, 250002)
    assert round(c["band"]["s_jax"], 5) == 0.00525
    assert round(c["band"]["s_port"], 5) == 0.01672
    assert round(c["band"]["limit"], 4) == 0.0526
    # the five rows whose JAX evaluation did not collapse
    assert sorted(c["band"]["rows"]) == [n for n, _, _ in ref_sweep.SUITE[1:]]
    assert c["band"]["met"] and c["sps_equal"]["met"] and c["learning"]["met"]
    assert c["determinism"]["config_values_equal"]
    assert c["determinism"]["met"] is False and not c["held_met"]
    assert c["reported"]["collapsed"][ref_sweep.SUITE[0][0]] == {
        "port": True, "jax": True}

    # the flagship row equal to the toy seed 0 run in the four fields
    with open(ref_sweep.TOY_SEED0) as f:
        toy0 = seed_campaign.seed_row(0, json.load(f))
    rows = [dict(r) for r in jax]
    flag = next(r for r in rows if r["config"] == ref_sweep.FLAGSHIP)
    flag.update({k: toy0[k] for k in ref_sweep.SAME_RUN_FIELDS})
    flag["final_mean_sum_reward"] = toy0["reward_curve_deciles"][-1]
    for r in rows:
        r["sps_prr"] = toy0["sps_prr"]
    c = ref_sweep.suite_checks(rows, suite, 250002)
    assert c["determinism"]["met"] and c["held_met"]
    # not comparable at another schedule
    assert ref_sweep.suite_checks(rows, suite, 1000)["determinism"][
        "met"] is None

    # each held rule missed on its own
    off = [dict(r) for r in rows]
    off[2]["prr_improvement"] += 0.06
    assert not ref_sweep.suite_checks(off, suite, 250002)["band"]["met"]
    off = [dict(r) for r in rows]
    off[4]["sps_prr"] += 0.0001
    assert not ref_sweep.suite_checks(off, suite, 250002)["sps_equal"]["met"]
    off = [dict(r) for r in rows]
    off[5]["final_mean_sum_reward"] = off[5]["reward_curve_deciles"][0]
    c = ref_sweep.suite_checks(off, suite, 250002)
    assert not c["learning"]["met"] and not c["held_met"]


@pytest.mark.parametrize("D", [13, 23, 43])
@pytest.mark.parametrize("B", [4, 64, 512, 1024])
def test_kernel_plans_take_the_suite_widths(D, B):
    """K1 (a slot: 4 rows; the eval: 16 envs x 4), K2 and K3 (a train
    event's 512 rows, and 1024) at H = 256 with D padded."""
    Dp = K.padded_dim(D)
    assert Dp % 16 == 0 and Dp >= D + 2
    for recs in (1, 2, 3):
        plan = K._fwd_plan(B, Dp, 256, recs)
        assert plan.blocks * plan.bm >= B > (plan.blocks - 1) * plan.bm
        assert plan.smem == K._fwd_smem(plan.bm, Dp, 256, recs)
    plan = K._bwd_plan(B, Dp, 256)
    assert plan.blocks * plan.bm >= B > (plan.blocks - 1) * plan.bm
    assert plan.smem == K._bwd_smem(plan.bm, Dp, 256)
