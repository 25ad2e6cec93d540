"""The port's full-schedule scripts (diral_tpu_torch/scripts/full_run.py
and seed_campaign.py) on the CPU, at a cut toy schedule (narrow nets, a
short pretrain, a few train events in 100 slots, a 10-slot eval on 2
envs).

* Keys: a summary and a campaign have the keys of the JAX package's
  committed artifacts (results/toy_full_250k.json,
  results/scale_seeds5.json), plus the port's documented additions.
* Formulas: the decile curve and the campaign's statistics equal what
  the JAX scripts compute on the same arrays (their training and
  evaluation stubbed out).
* Resume: a campaign cut mid-seed (a checkpoint write that raises) and
  started again skips the finished seed, resumes the open one and gives
  rows bit-equal to an uncut campaign, timings apart; so does a full_run
  cut and restarted.  ``--save-freq`` changes no number, ``--jobs 2``
  gives the rows of ``--jobs 1``, and ``run.json`` refuses a start under
  another option.
* Without ``--device cpu`` on a box without a GPU both scripts raise.
"""

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

from diral_tpu_torch.scripts import full_run, seed_campaign
from diral_tpu_torch.train import checkpoint as ckpt
from diral_tpu_torch.train import evaluate, runner

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
SLOTS = 100
EVAL = ["--eval-steps", "10", "--eval-envs", "2", "--device", "cpu"]
ADDED_SUMMARY = {"device", "resumed_from", "build_seconds", "init_seconds",
                 "loop_seconds", "launches"}
ADDED_ROW = {"device", "resumed_from", "init_seconds", "loop_seconds",
             "eval_seconds", "launches"}


@pytest.fixture(scope="module")
def cut_yaml(tmp_path_factory):
    """configs/toy_4ue_3r.yaml cut to a few train events in 100 slots."""
    raw = yaml.safe_load(open(os.path.join(ROOT, "configs",
                                           "toy_4ue_3r.yaml")))
    raw.update(time_slots=SLOTS, episode_interval=5, memory_size=64,
               pretrain_length=1, explore=20, greedy=70, training_stop=90)
    raw["RLAgent"].update(batch_size=8)
    raw["RLAgent"]["network"]["layers"] = {1: 32, 2: 32}
    path = tmp_path_factory.mktemp("cfg") / "cut.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def _results(name):
    with open(os.path.join(ROOT, "results", name)) as f:
        return json.load(f)


def _campaign(cut_yaml, root, *extra):
    return seed_campaign.main([cut_yaml, str(root / "out.json"), "--seeds",
                               "2", "--workdir", str(root / "wd"), *EVAL,
                               *extra])


def _results_of(rows):
    return [{k: v for k, v in r.items() if k not in seed_campaign.RUN_FIELDS}
            for r in rows]


def _same_run(a, b):
    """Two full_run summaries agree in every number of the run."""
    drop = {"train_seconds", "slots_per_sec", "eval_seconds"} | ADDED_SUMMARY
    assert ({k: v for k, v in a.items() if k not in drop}
            == {k: v for k, v in b.items() if k not in drop})


def test_summary_and_campaign_keys_match_jax_artifacts(cut_yaml, tmp_path):
    summary = full_run.main([cut_yaml, str(tmp_path / "run"), *EVAL])
    jax_run = _results("toy_full_250k.json")
    assert set(summary) == set(jax_run) | ADDED_SUMMARY
    assert set(summary["compare_vs_sps"]) == set(jax_run["compare_vs_sps"])
    for side in ("drqn", "sps"):
        assert (set(summary["compare_vs_sps"][side])
                == set(jax_run["compare_vs_sps"][side]))
    assert summary["time_slots"] == SLOTS
    assert len(summary["reward_curve_deciles"]) == 10
    assert summary["resumed_from"] == [] and summary["device"]["name"] == "cpu"
    with open(tmp_path / "run" / "summary.json") as f:
        assert json.load(f) == summary
    # full_run checkpoints (save_model, as JAX's) and keeps its best
    ck = runner.checkpoint_dir(full_run.setup(cut_yaml, device="cpu")[0],
                               str(tmp_path / "run"))
    assert ckpt.latest_step(ck) == SLOTS
    assert os.path.exists(ck + "_best/best_metric.json")

    camp = _campaign(cut_yaml, tmp_path)
    jax_camp = _results("scale_seeds5.json")
    assert set(camp) == set(jax_camp) | {"device"}
    for row in camp["rows"]:
        assert set(row) == set(jax_camp["rows"][0]) | ADDED_ROW
    assert [r["seed"] for r in camp["rows"]] == [0, 1]
    assert camp["rows"][0] != camp["rows"][1]
    with open(tmp_path / "out.json") as f:
        assert json.load(f) == camp
    # no checkpoint and no result dump without --save-freq
    for k in (0, 1):
        wd = tmp_path / "wd" / f"seed{k}"
        assert sorted(os.listdir(wd)) == ["run.json", "save_results",
                                          "summary.json"]
        assert not any(n.endswith(".npy")
                       for n in os.listdir(wd / "save_results" / "test"
                                           / "toy_4ue_3r"))


def _load_jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stub_arrays(n, seeds):
    rng = np.random.RandomState(n)
    sums = {s: rng.normal(-3.0, 2.0, (n, 2)).astype(np.float32)
            for s in seeds}
    comps = {}
    for s in seeds:
        drqn, sps = rng.uniform(0.4, 0.9, 2)
        comps[s] = {"drqn": {"mean_prr": float(drqn)},
                    "sps": {"mean_prr": float(sps)},
                    "prr_improvement": float(drqn / sps - 1.0)}
    return sums, comps


@pytest.mark.parametrize("n", [7, 37, 1003])
def test_statistics_match_jax_formulas(monkeypatch, tmp_path, n):
    """The JAX scripts' own decile and campaign formulas, run on stubbed
    training and evaluation, against the port's on the same arrays."""
    import diral_tpu.train.evaluate as jeval
    import diral_tpu.train.runner as jrunner

    seeds = [0, 1, 2, 3]
    sums, comps = _stub_arrays(n, seeds)
    # seed 3 loses to SPS, seed 2 ties it
    comps[3]["prr_improvement"] = -0.25
    comps[2]["prr_improvement"] = 0.0
    cfg_path = os.path.join(ROOT, "configs", "toy_4ue_3r.yaml")

    def jax_train(cfg, workdir=".", seed=0, **kw):
        return types.SimpleNamespace(learner=seed), {"sum_reward": sums[seed]}

    monkeypatch.setattr(jrunner, "train_experiment", jax_train)
    monkeypatch.setattr(jeval, "compare_drqn_vs_sps",
                        lambda cfg, learner, key, steps: comps[learner])

    def port_train(cfg, workdir=".", seed=0, timing=None, **kw):
        timing.update(start_slot=0, init_seconds=0.0, loop_seconds=1.0)
        return (types.SimpleNamespace(learner=types.SimpleNamespace(
            params=seed)), {"sum_reward": sums[seed]})

    monkeypatch.setattr(runner, "train_experiment", port_train)
    monkeypatch.setattr(evaluate, "compare_drqn_vs_sps",
                        lambda cfg, params, seed, steps, **kw: comps[params])

    jfull = _load_jax_script("full_run")
    monkeypatch.setattr(sys, "argv", ["full_run.py", cfg_path,
                                      str(tmp_path / "jax_run"), "--slots",
                                      str(n), "--seed", "1"])
    jfull.main()
    with open(tmp_path / "jax_run" / "summary.json") as f:
        jax_summary = json.load(f)
    mine = full_run.main([cfg_path, str(tmp_path / "run"), "--slots", str(n),
                          "--seed", "1", "--device", "cpu"])
    assert mine["reward_curve_deciles"] == jax_summary["reward_curve_deciles"]
    assert mine["compare_vs_sps"] == jax_summary["compare_vs_sps"]
    assert mine["time_slots"] == jax_summary["time_slots"] == n

    jcamp = _load_jax_script("seed_campaign")
    out = tmp_path / "jax_campaign.json"
    monkeypatch.setattr(sys, "argv", ["seed_campaign.py", cfg_path, str(out),
                                      "--seeds", "4", "--slots", str(n)])
    jcamp.main()
    with open(out) as f:
        jax_camp = json.load(f)
    camp = seed_campaign.main([cfg_path, str(tmp_path / "campaign.json"),
                               "--seeds", "4", "--slots", str(n),
                               "--device", "cpu"])
    stats = ("prr_improvement_mean", "prr_improvement_std",
             "prr_improvement_min", "prr_improvement_max", "n_below_sps")
    assert {k: camp[k] for k in stats} == {k: jax_camp[k] for k in stats}
    below = sum(round(c["prr_improvement"], 4) <= 0 for c in comps.values())
    assert jax_camp["n_below_sps"] == below >= 2
    assert _results_of(camp["rows"]) == _results_of(jax_camp["rows"])
    # one seed: JAX's std is 0.0
    one = seed_campaign.campaign_stats(camp["rows"][:1])
    assert one["prr_improvement_std"] == 0.0
    assert one["prr_improvement_mean"] == camp["rows"][0]["prr_improvement"]


def test_cut_campaign_equals_uncut(cut_yaml, tmp_path, monkeypatch):
    uncut = _campaign(cut_yaml, tmp_path / "uncut", "--save-freq", "25")
    real_save = ckpt.save
    saves = []

    def cutting_save(directory, step, *a, **k):
        path = real_save(directory, step, *a, **k)
        if f"{os.sep}seed1{os.sep}" in str(directory):
            saves.append(step)
            if len(saves) == 2:
                raise RuntimeError("cut")
        return path

    monkeypatch.setattr(ckpt, "save", cutting_save)
    with pytest.raises(RuntimeError, match="cut"):
        _campaign(cut_yaml, tmp_path / "cut", "--save-freq", "25")
    monkeypatch.setattr(ckpt, "save", real_save)
    wd = tmp_path / "cut" / "wd"
    assert os.path.exists(wd / "seed0" / "summary.json")
    assert not os.path.exists(wd / "seed1" / "summary.json")
    assert saves == [25, 50]

    ran = []
    real_run = full_run.run

    def spy(*a, **k):
        ran.append(k["seed"])
        return real_run(*a, **k)

    monkeypatch.setattr(full_run, "run", spy)
    again = _campaign(cut_yaml, tmp_path / "cut", "--save-freq", "25")
    assert ran == [1]
    assert _results_of(again["rows"]) == _results_of(uncut["rows"])
    assert [r["resumed_from"] for r in again["rows"]] == [[], [50]]
    assert [r["resumed_from"] for r in uncut["rows"]] == [[], []]
    stats = {k: v for k, v in again.items()
             if k not in ("rows", "cli", "device")}
    assert stats == {k: v for k, v in uncut.items()
                     if k not in ("rows", "cli", "device")}


def test_full_run_cut_and_restarted_equals_uncut(cut_yaml, tmp_path,
                                                 monkeypatch):
    args = ["--save-freq", "25", *EVAL]
    uncut = full_run.main([cut_yaml, str(tmp_path / "a"), *args])
    real_save = ckpt.save

    def cutting_save(directory, step, *a, **k):
        path = real_save(directory, step, *a, **k)
        if step == 75:
            raise RuntimeError("cut")
        return path

    monkeypatch.setattr(ckpt, "save", cutting_save)
    with pytest.raises(RuntimeError, match="cut"):
        full_run.main([cut_yaml, str(tmp_path / "b"), *args])
    monkeypatch.setattr(ckpt, "save", real_save)
    again = full_run.main([cut_yaml, str(tmp_path / "b"), *args])
    _same_run(again, uncut)
    assert again["resumed_from"] == [75]
    assert again["slots_per_sec"] > 0


def test_save_freq_changes_no_number(cut_yaml, tmp_path):
    a = full_run.main([cut_yaml, str(tmp_path / "a"), "--save-freq", "10",
                       *EVAL])
    b = full_run.main([cut_yaml, str(tmp_path / "b"), "--save-freq", "40",
                       *EVAL])
    _same_run(a, b)
    with open(tmp_path / "a" / "run.json") as f:
        assert json.load(f)["save_freq"] == 10


def test_jobs_give_the_rows_of_one_process(cut_yaml, tmp_path):
    one = _campaign(cut_yaml, tmp_path / "one")
    two = _campaign(cut_yaml, tmp_path / "two", "--jobs", "2")
    assert _results_of(two["rows"]) == _results_of(one["rows"])


def test_run_json_refuses_a_changed_option(cut_yaml, tmp_path):
    wd = str(tmp_path / "run")
    full_run.main([cut_yaml, wd, "--slots", "30", *EVAL])
    with pytest.raises(ValueError, match="eval_steps was 10"):
        full_run.main([cut_yaml, wd, "--slots", "30", "--eval-steps", "11",
                       "--eval-envs", "2", "--device", "cpu"])
    with pytest.raises(ValueError, match="slots was 30"):
        full_run.main([cut_yaml, wd, "--slots", "40", *EVAL])
    # a finished campaign seed is checked too before its row is read back
    _campaign(cut_yaml, tmp_path / "c", "--slots", "30")
    with pytest.raises(ValueError, match="save_freq was None"):
        _campaign(cut_yaml, tmp_path / "c", "--slots", "30", "--save-freq",
                  "10")
    # the config file's contents are part of the run
    raw = yaml.safe_load(open(cut_yaml))
    raw["RLAgent"]["gamma"] = 0.5
    other = tmp_path / "other.yaml"
    other.write_text(yaml.safe_dump(raw))
    with open(os.path.join(wd, "run.json")) as f:
        record = json.load(f)
    record["config"] = str(other)
    with open(os.path.join(wd, "run.json"), "w") as f:
        json.dump(record, f)
    with pytest.raises(ValueError, match="config_sha256"):
        full_run.main([str(other), wd, "--slots", "30", *EVAL])


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a box without a GPU")
@pytest.mark.parametrize("module,extra", [
    ("full_run", ["WORKDIR"]),
    ("seed_campaign", ["WORKDIR/out.json", "--seeds", "1"])])
def test_no_silent_cpu_fallback(cut_yaml, tmp_path, module, extra):
    argv = [a.replace("WORKDIR", str(tmp_path)) for a in extra]
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-m", f"diral_tpu_torch.scripts.{module}", cut_yaml,
         *argv], cwd=ROOT, env=env, capture_output=True, text=True)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert not os.listdir(tmp_path)
    script = {"full_run": full_run, "seed_campaign": seed_campaign}[module]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        script.main([cut_yaml, *argv])
