"""The port's PPO and PS-DQN / PS-DRQN campaign drivers
(diral_tpu_torch/scripts/ppo_campaign.py, ps_campaign.py) and the
checkpoint of their loops, on the CPU at cut sizes (a PPO config of 2
envs and 16-wide nets; the PS toy at its 16 envs over a few episodes).

* Resume: a PPO run and a PS-DQN and PS-DRQN run cut after a checkpoint
  and restarted from it equal the uncut run bit for bit -- the learner
  (nets and Adam), the carry, the generator and every log -- in float32
  and float64; restoring consumes no draw.
* Keys: the artifacts and rows have the keys of the JAX package's
  results/ppo_seeds.json and results/ps_campaign.json, plus the port's
  documented additions.
* Formulas: with training and evaluation stubbed, the rows equal what
  the JAX scripts compute on the same arrays, and the band statistics
  are render_results.py's mean and population std.
* Campaigns cut mid-seed and started again give the uncut rows (timings
  apart); ``--save-freq`` changes no number, ``--jobs 2`` gives the
  rows of ``--jobs 1``, ``run.json`` refuses a changed option, and
  without ``--device cpu`` on a box without a GPU both scripts raise.
"""

import dataclasses
import importlib.util
import json
import math
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import yaml

from diral_tpu_torch.config import load_config
from diral_tpu_torch.scripts import episode_campaign as ec
from diral_tpu_torch.scripts import episode_rate, ppo_campaign, ps_campaign
from diral_tpu_torch.train import checkpoint as ckpt
from diral_tpu_torch.train import evaluate, ppo_loop, ps_loop

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
PPO_EVAL = ["--eval-steps", "10", "--eval-envs", "2", "--device", "cpu"]
PS_EVAL = ["--eval-steps", "10", "--device", "cpu"]
ADDED_ROW = {"device", "resumed_from"}
ADDED = {"seeds", "cli", "device", "checks"}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tests run many small ops; beside the suite's other workers,
    torch's intra-op threads would only contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ppo_yaml(tmp_path_factory):
    """configs/ppo_congested.yaml cut to 2 envs and 16-wide nets."""
    raw = yaml.safe_load(open(os.path.join(ROOT, "configs",
                                           "ppo_congested.yaml")))
    raw["Engine"]["num_envs"] = 2
    raw["time_slots"] = 25 * 6
    raw["RLAgent"]["network"]["layers"] = {1: 16, 2: 16}
    path = tmp_path_factory.mktemp("cfg") / "ppo_cut.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def _results(name):
    with open(os.path.join(ROOT, "results", name)) as f:
        return json.load(f)


def _same(a, b, path="carry"):
    """a and b agree bit for bit: tensors (dtype, shape, values), dicts,
    sequences, dataclasses and numbers."""
    if torch.is_tensor(a):
        assert torch.is_tensor(b) and a.dtype == b.dtype, path
        assert a.shape == b.shape and torch.equal(a.cpu(), b.cpu()), path
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    elif dataclasses.is_dataclass(a):
        assert type(a) is type(b), path
        for f in dataclasses.fields(a):
            _same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif isinstance(a, torch.nn.Module):
        _same(a.state_dict(), b.state_dict(), path)
    elif isinstance(a, torch.optim.Optimizer):
        _same(a.state_dict(), b.state_dict(), path)
    else:
        assert type(a) is type(b) and a == b, (path, a, b)


class _Cut(Exception):
    pass


def _ppo_fns(ppo_yaml, dtype):
    return ppo_loop.make_ppo_functions(load_config(ppo_yaml), dtype,
                                       device="cpu")


def _ps_fns(algo, dtype):
    return ps_loop.make_ps_functions(ps_campaign.ps_config(16), algo, dtype,
                                     device="cpu")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("kind", ["ppo", "ps-dqn", "ps-drqn"])
def test_cut_run_resumes_bit_equal(kind, dtype, ppo_yaml, tmp_path):
    episodes, cut = 6, 4
    if kind == "ppo":
        fns = _ppo_fns(ppo_yaml, dtype)
        Draws = ppo_loop.PPODraws

        def save(d, e, carry, logs, gen):
            return ckpt.save_ppo(d, e, carry, logs, gen, seconds=1.5)

        def restore(d, gen):
            return ckpt.restore_ppo(d, "cpu", gen)
    else:
        fns = _ps_fns(kind, dtype)
        Draws = ps_loop.PSDraws
        assert fns.n_batches > 0   # the cut falls between train calls

        def save(d, e, carry, logs, gen):
            return ckpt.save_ps(d, e, carry, logs, kind, gen, seconds=1.5)

        def restore(d, gen):
            return ckpt.restore_ps(d, kind, fns.cfg.agent, "cpu", gen)

    ends = {}

    def keep(name):
        def after(done, carry, logs):
            if done == episodes:
                ends[name] = carry
        return after
    gen_a = torch.Generator().manual_seed(3)
    result_a, logs_a = fns.run(Draws(gen_a), episodes,
                               after_episode=keep("uncut"))

    directory = str(tmp_path / "ckpt")
    gen_b = torch.Generator().manual_seed(3)

    def saving(done, carry, logs):
        if done % 2 == 0:
            save(directory, done, carry, logs(), gen_b)
        if done == cut:
            raise _Cut
    with pytest.raises(_Cut):
        fns.run(Draws(gen_b), episodes, after_episode=saving)
    assert ckpt.steps(directory) == [2, 4]

    gen_c = torch.Generator().manual_seed(12345)   # set by the restore
    start = restore(directory, gen_c)
    assert start.episode == cut and start.seconds == 1.5
    assert torch.equal(gen_c.get_state(), gen_b.get_state())
    assert {k: len(v) for k, v in start.logs.items()} == {
        k: cut for k in logs_a}
    result_c, logs_c = fns.run(Draws(gen_c), episodes, start=start,
                               after_episode=keep("resumed"))
    _same(logs_c, logs_a, "logs")
    _same(ends["resumed"], ends["uncut"])
    _same(result_c, result_a, "result")
    _same(gen_c.get_state(), gen_a.get_state(), "generator")
    if kind != "ppo":
        assert isinstance(result_c.replay.count, int)
        assert isinstance(result_c.eps_state.eps, np.float32)


@pytest.mark.parametrize("eps_init", [None, 0.05])
@pytest.mark.parametrize("algo", ["ps-dqn", "ps-drqn"])
def test_campaign_config_tracks_jax(algo, eps_init, monkeypatch):
    """The PS loops at ps_campaign's own config (the toy x 16 envs, batch
    64, layers 256/256, target_update 1000; unroll 8) against JAX's
    ``episode`` with JAX's draws replayed (tests/test_torch_ps_slice.py's
    ``JaxPSDraws``), float64, over 20 episodes -- more than the slice
    test's 3 -- from the config's eps and from 0.05 (the greedy regime
    the end of a schedule runs in): every episode's actions and replay
    bit-equal, the loss within 1e-12, the params within 1e-12."""
    import jax
    import jax.numpy as jnp
    import test_torch_ps_slice as slice_test

    from diral_tpu.config import toy_4ue_3r
    from diral_tpu.train import ps_loop as jloop

    episodes = 20
    monkeypatch.setattr(slice_test, "EPISODES", episodes)
    jcfg = toy_4ue_3r(save_positions=False)
    jcfg = dataclasses.replace(
        jcfg, engine=dataclasses.replace(jcfg.engine, num_envs=16),
        agent=dataclasses.replace(jcfg.agent, batch_size=64,
                                  target_update=1000))
    tcfg = ps_campaign.ps_config(16)
    if eps_init is not None:
        jcfg, tcfg = (dataclasses.replace(c, agent=dataclasses.replace(
            c.agent, eps_init=eps_init)) for c in (jcfg, tcfg))
    init_fn, episode_fn, _ = jloop.make_ps_functions(jcfg, algo, jnp.float64)
    jcarry = jax.jit(init_fn)(jax.random.PRNGKey(slice_test.SEED))
    episode = jax.jit(episode_fn)
    fns = ps_loop.make_ps_functions(tcfg, algo, torch.float64, device="cpu")
    draws = slice_test.JaxPSDraws(jcfg, fns.n_batches)
    carry = fns.init_carry(draws, learner=slice_test._convert(
        algo, jcarry.learner, tcfg.agent))
    for ep in range(episodes):
        jcarry, jlog = episode(jcarry, jnp.asarray(ep, jnp.int32))
        carry, log = fns.episode(carry, ep, draws)
        for k in ("states", "actions", "rewards"):
            np.testing.assert_array_equal(
                getattr(carry.replay, k).numpy(),
                np.asarray(getattr(jcarry.replay, k)), err_msg=f"{ep} {k}")
        assert log["eps"] == np.float32(jlog["eps"])
        assert abs(float(log["loss"]) - float(jlog["loss"])) <= 1e-12
        want = slice_test.learner_dict(jcarry.learner)["params"]
        for name, p in carry.learner.params.named_parameters():
            g, k = name.split(".")
            np.testing.assert_allclose(p.detach().numpy(), want[g][k],
                                       rtol=0, atol=1e-12, err_msg=name)


def test_restore_refuses_another_run_or_device(ppo_yaml, tmp_path):
    fns = _ppo_fns(ppo_yaml, torch.float32)
    gen = torch.Generator().manual_seed(0)
    d = str(tmp_path / "c")
    fns.run(ppo_loop.PPODraws(gen), 2, after_episode=lambda e, c, logs:
            ckpt.save_ppo(d, e, c, logs(), gen))
    with pytest.raises(ValueError, match="ppo run, not ps-dqn"):
        ckpt.restore_ps(d, "ps-dqn", fns.cfg.agent, "cpu", gen)
    blob = torch.load(os.path.join(d, "ckpt_2.pt"), weights_only=True)
    blob["generator"]["device"] = "cuda"
    torch.save(blob, os.path.join(d, "ckpt_2.pt"))
    with pytest.raises(ValueError, match="cuda generator"):
        ckpt.restore_ppo(d, "cpu", gen)
    assert ckpt.restore_ppo(d, "cpu").episode == 2   # no generator: carry only


def _ppo(ppo_yaml, root, *extra, seeds="2"):
    return ppo_campaign.main(["--config", ppo_yaml, "--seeds", seeds,
                              "--out", str(root / "out.json"), "--workdir",
                              str(root / "wd"), *PPO_EVAL, *extra])


def _ps(root, *extra, seeds="1", episodes="6"):
    return ps_campaign.main(["--seeds", seeds, "--episodes", episodes,
                             "--out", str(root / "out.json"), "--workdir",
                             str(root / "wd"), *PS_EVAL, *extra])


def _rows(summary):
    return [{k: v for k, v in r.items() if k not in ec.RUN_FIELDS}
            for r in summary["runs"]]


def test_keys_match_jax_artifacts(ppo_yaml, tmp_path):
    ppo = _ppo(ppo_yaml, tmp_path / "ppo", "--episodes", "2")
    jax = _results("ppo_seeds.json")
    assert set(ppo) == set(jax) | ADDED
    for row in ppo["runs"]:
        assert set(row) == set(jax["runs"][0]) | ADDED_ROW
        comp, jcomp = row["compare_vs_sps"], jax["runs"][0]["compare_vs_sps"]
        assert set(comp) == set(jcomp)
        for side in ("ppo", "sps"):
            assert set(comp[side]) == set(jcomp[side])
    assert ppo["seeds"] == 2 and ppo["episodes"] == 2
    assert [r["seed"] for r in ppo["runs"]] == [0, 1]
    assert ppo["runs"][0]["device"] == {"name": "cpu", "power_limit": None}
    assert set(ppo["checks"]) == {"prr_improvement", "n_below_sps",
                                  "jax_n_below_sps", "sps_prr",
                                  "sum_r_rising"}
    with open(tmp_path / "ppo" / "out.json") as f:
        assert json.load(f) == ppo

    ps = _ps(tmp_path / "ps", episodes="2")
    jax = _results("ps_campaign.json")
    assert set(ps) == set(jax) | ADDED
    assert ps["config"] == jax["config"] and ps["num_envs"] == 16
    assert [(r["algo"], r["seed"]) for r in ps["runs"]] == [
        ("ps-dqn", 0), ("ps-drqn", 0)]
    for row, jrow in zip(ps["runs"], (jax["runs"][0], jax["runs"][5])):
        assert set(row) == set(jrow) | ADDED_ROW
        assert set(row["compare_vs_sps"]) == set(jrow["compare_vs_sps"])
    assert set(ps["checks"]) == {"ps-dqn", "ps-drqn"}
    # no checkpoint without --save-freq
    assert sorted(os.listdir(tmp_path / "ps" / "wd" / "ps-dqn" / "seed0")) \
        == ["run.json", "summary.json"]


def _load_jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _stub_comp(rng, label):
    own, sps = rng.uniform(0.4, 0.99, 2)
    return {label: {"mean_prr": float(own),
                    "mean_sum_reward": float(rng.uniform(-17, 4))},
            "sps": {"mean_prr": float(sps)},
            "prr_improvement": float(own / sps - 1.0)}


class _StubFns:
    """A loop whose ``run`` returns the stubbed logs of its generator's
    seed (the port's side of the formula tests)."""

    def __init__(self, logs, result):
        self.device = torch.device("cpu")
        self.logs, self.result = logs, result

    def run(self, draws, episodes, start=None, after_episode=None):
        seed = draws.gen.initial_seed()
        return self.result(seed), {"mean_sum_reward": self.logs[seed]}


@pytest.mark.parametrize("n", [7, 130, 1003])
def test_ppo_statistics_match_jax_formulas(monkeypatch, tmp_path, n):
    import diral_tpu.train.evaluate as jeval
    import diral_tpu.train.ppo_loop as jppo

    seeds = 4
    rng = np.random.RandomState(n)
    logs = {s: rng.normal(1.0, 2.0, n).astype(np.float32)
            for s in range(seeds)}
    comps = {s: _stub_comp(rng, "ppo") for s in range(seeds)}
    comps[3]["prr_improvement"] = -0.25

    monkeypatch.setattr(jppo, "make_ppo_functions", lambda cfg: (
        lambda key, episodes: (int(key[1]),
                               {"mean_sum_reward": logs[int(key[1])]})))
    monkeypatch.setattr(jeval, "compare_ppo_vs_sps",
                        lambda cfg, learner, key, steps: comps[learner])
    out = tmp_path / "jax.json"
    monkeypatch.setattr(sys, "argv", ["ppo_campaign.py", "--seeds",
                                      str(seeds), "--episodes", str(n),
                                      "--out", str(out)])
    _load_jax_script("ppo_campaign").main()
    with open(out) as f:
        jax = json.load(f)

    monkeypatch.setattr(ppo_loop, "make_ppo_functions",
                        lambda cfg, device=None: _StubFns(
                            logs, lambda s: types.SimpleNamespace(params=s)))
    monkeypatch.setattr(evaluate, "compare_ppo_vs_sps",
                        lambda cfg, params, seed, steps, **kw: comps[params])
    mine = ppo_campaign.main(["--seeds", str(seeds), "--episodes", str(n),
                              "--out", str(tmp_path / "port.json"),
                              "--workdir", str(tmp_path / "wd"),
                              "--device", "cpu", "--reference", str(out)])
    assert _rows(mine) == _rows(jax)
    assert {k: mine[k] for k in jax if k != "runs"} == {
        k: jax[k] for k in jax if k != "runs"}

    # render_results.py's mean +- std row, from the port's checks
    render = _load_jax_script("render_results")
    monkeypatch.setattr(render, "_load", lambda name: jax)
    last = render._ppo_seeds_table().splitlines()[-1]
    band = mine["checks"]["prr_improvement"]
    assert band["port_mean"] == band["jax_mean"]
    assert f"**{band['port_mean']:+.1%} ± {band['port_std']:.1%}**" in last
    assert f"({mine['checks']['n_below_sps']}/{seeds} below SPS)" in last
    assert mine["checks"]["n_below_sps"] == sum(
        c["prr_improvement"] < 0 for c in comps.values()) >= 1
    assert band["abs_diff"] == 0.0 and band["inside"]
    assert band["limit"] == 3 * math.sqrt(2 * band["port_std"] ** 2 / seeds)
    assert mine["checks"]["sum_r_rising"] == [
        r["sum_r_last100"] > r["sum_r_first100"] for r in jax["runs"]]


@pytest.mark.parametrize("n", [9, 1003])
def test_ps_statistics_match_jax_formulas(monkeypatch, tmp_path, n):
    import diral_tpu.train.evaluate as jeval
    import diral_tpu.train.ps_loop as jps

    seeds = 3
    rng = np.random.RandomState(n)
    logs = {(a, s): rng.normal(-3.0, 2.0, n).astype(np.float32)
            for a in ps_loop.ALGOS for s in range(seeds)}
    comps = {(a, s): _stub_comp(rng, a.replace("-", "_"))
             for a in ps_loop.ALGOS for s in range(seeds)}
    # a collapse: PRR 1, sum reward -16
    comps[("ps-dqn", 1)]["ps_dqn"] = {"mean_prr": 1.0,
                                      "mean_sum_reward": -16.0}

    def jax_fns(cfg, algo):
        assert (cfg.engine.num_envs, cfg.agent.batch_size,
                cfg.agent.target_update) == (16, 64, 1000)

        def run(key, episodes):
            s = int(key[1])
            return (types.SimpleNamespace(learner=(algo, s)),
                    {"mean_sum_reward": logs[(algo, s)]})
        return None, None, run
    monkeypatch.setattr(jps, "make_ps_functions", jax_fns)
    monkeypatch.setattr(jeval, "compare_ps_vs_sps",
                        lambda cfg, learner, key, steps, algo: comps[learner])
    out = tmp_path / "jax.json"
    monkeypatch.setattr(sys, "argv", ["ps_campaign.py", "--seeds", str(seeds),
                                      "--episodes", str(n), "--out",
                                      str(out)])
    _load_jax_script("ps_campaign").main()
    with open(out) as f:
        jax = json.load(f)

    monkeypatch.setattr(ps_loop, "make_ps_functions",
                        lambda cfg, algo, device=None: _StubFns(
                            {s: logs[(algo, s)] for s in range(seeds)},
                            lambda s: types.SimpleNamespace(
                                learner=types.SimpleNamespace(
                                    params=(algo, s)))))
    monkeypatch.setattr(evaluate, "compare_ps_vs_sps",
                        lambda cfg, params, seed, steps, algo, **kw:
                        comps[params])
    mine = ps_campaign.main(["--seeds", str(seeds), "--episodes", str(n),
                             "--out", str(tmp_path / "port.json"),
                             "--workdir", str(tmp_path / "wd"),
                             "--device", "cpu", "--reference", str(out)])
    assert _rows(mine) == _rows(jax)
    assert {k: mine[k] for k in jax if k != "runs"} == {
        k: jax[k] for k in jax if k != "runs"}
    for algo in ps_loop.ALGOS:
        c = mine["checks"][algo]
        deltas = [comps[(algo, s)]["prr_improvement"] for s in range(seeds)]
        assert c["prr_improvement"]["port_mean"] == sum(deltas) / seeds
        assert c["prr_improvement"]["port_std"] == float(
            np.std(np.asarray(deltas, np.float64)))
        assert c["n_positive"] == sum(d > 0 for d in deltas)
    assert mine["checks"]["ps-dqn"]["labels"] == ["learner", "collapse",
                                                  "learner"]
    assert mine["checks"]["ps-dqn"]["n_collapse"] == 1
    # JAX's published rows: PS-DQN seeds 0, 2, 4 and PS-DRQN seed 2 collapse
    ref = _results("ps_campaign.json")["runs"]
    assert [ps_campaign.collapsed(r) for r in ref] == [
        True, False, True, False, True, False, False, True, False, False]


def test_cut_campaigns_equal_uncut(ppo_yaml, tmp_path, monkeypatch):
    ppo_uncut = _ppo(ppo_yaml, tmp_path / "ppo_uncut", "--save-freq", "2")
    ps_uncut = _ps(tmp_path / "ps_uncut", "--save-freq", "2")
    saves = []

    def cutting(real, marker):
        def save(d, e, *a, **k):
            path = real(d, e, *a, **k)
            if marker in str(d):
                saves.append(e)
                if len(saves) == 2:
                    raise _Cut
            return path
        return save

    for name, marker, fn, root in (
            ("save_ppo", f"{os.sep}seed1{os.sep}",
             lambda: _ppo(ppo_yaml, tmp_path / "ppo_cut", "--save-freq",
                          "2"), "ppo_cut"),
            ("save_ps", f"ps-drqn{os.sep}seed0{os.sep}",
             lambda: _ps(tmp_path / "ps_cut", "--save-freq", "2"),
             "ps_cut")):
        saves.clear()
        real = getattr(ckpt, name)
        monkeypatch.setattr(ckpt, name, cutting(real, marker))
        with pytest.raises(_Cut):
            fn()
        monkeypatch.setattr(ckpt, name, real)
        assert saves == [2, 4]

    ran = []
    for mod in (ppo_campaign, ps_campaign):
        real_seed = mod.run_seed

        def spy(*a, _real=real_seed, **k):
            ran.append((k.get("algo", k.get("config")), k["seed"]))
            return _real(*a, **k)
        monkeypatch.setattr(mod, "run_seed", spy)
    ppo_again = _ppo(ppo_yaml, tmp_path / "ppo_cut", "--save-freq", "2")
    ps_again = _ps(tmp_path / "ps_cut", "--save-freq", "2")
    assert ran == [(ppo_yaml, 1), ("ps-drqn", 0)]
    assert _rows(ppo_again) == _rows(ppo_uncut)
    assert _rows(ps_again) == _rows(ps_uncut)
    assert [r["resumed_from"] for r in ppo_again["runs"]] == [[], [4]]
    assert [r["resumed_from"] for r in ps_again["runs"]] == [[], [4]]
    assert ppo_again["checks"] == ppo_uncut["checks"]
    assert ps_again["checks"] == ps_uncut["checks"]
    assert all(r["train_s"] > 0 for r in ppo_again["runs"])


def test_save_freq_and_jobs_change_no_number(ppo_yaml, tmp_path,
                                            monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")   # the --jobs processes
    a = _ppo(ppo_yaml, tmp_path / "a", "--save-freq", "1")
    b = _ppo(ppo_yaml, tmp_path / "b")
    c = _ppo(ppo_yaml, tmp_path / "c", "--jobs", "2", "--save-freq", "4")
    assert _rows(a) == _rows(b) == _rows(c)
    assert ckpt.steps(str(tmp_path / "a" / "wd" / "seed0" / "ckpt")) == [
        4, 5, 6]
    assert ckpt.steps(str(tmp_path / "c" / "wd" / "seed1" / "ckpt")) == [4, 6]
    d = _ps(tmp_path / "d", "--jobs", "2", "--save-freq", "3")
    e = _ps(tmp_path / "e")
    assert _rows(d) == _rows(e)


def test_run_json_refuses_a_changed_option(ppo_yaml, tmp_path):
    _ppo(ppo_yaml, tmp_path / "p", "--episodes", "2", seeds="1")
    with pytest.raises(ValueError, match="episodes was 2"):
        _ppo(ppo_yaml, tmp_path / "p", "--episodes", "3", seeds="1")
    with pytest.raises(ValueError, match="save_freq was None"):
        _ppo(ppo_yaml, tmp_path / "p", "--episodes", "2", "--save-freq", "1",
             seeds="1")
    _ps(tmp_path / "s", episodes="2")
    with pytest.raises(ValueError, match="num_envs was 16"):
        _ps(tmp_path / "s", "--num-envs", "8", episodes="2")
    with pytest.raises(ValueError, match="eval_steps was 10"):
        ps_campaign.main(["--seeds", "1", "--episodes", "2", "--out",
                          str(tmp_path / "s" / "out.json"), "--workdir",
                          str(tmp_path / "s" / "wd"), "--eval-steps", "11",
                          "--device", "cpu"])
    # the config file's contents are part of the run
    raw = yaml.safe_load(open(ppo_yaml))
    raw["RLAgent"]["gamma"] = 0.5
    other = tmp_path / "other.yaml"
    other.write_text(yaml.safe_dump(raw))
    wd = tmp_path / "p" / "wd" / "seed0"
    record = json.loads((wd / "run.json").read_text())
    record["config"] = str(other)
    (wd / "run.json").write_text(json.dumps(record))
    with pytest.raises(ValueError, match="config_sha256"):
        ppo_campaign.main(["--config", str(other), "--seeds", "1",
                           "--episodes", "2", "--out",
                           str(tmp_path / "p" / "out.json"), "--workdir",
                           str(tmp_path / "p" / "wd"), *PPO_EVAL])


def test_episode_rate_on_the_cpu(monkeypatch):
    """The planning script: every process of every spec reports a rate."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = episode_rate.main(["ps-dqn:2:1", "ps-drqn:1:1", "--warm", "1",
                             "--device", "cpu"])
    assert set(out) == {"device", "cpu_count", "specs", "wall_s",
                        "episodes_per_s"}
    assert [k for k, _ in out["episodes_per_s"]] == ["ps-dqn", "ps-dqn",
                                                     "ps-drqn"]
    assert all(r > 0 for _, r in out["episodes_per_s"])
    assert episode_rate.rate("ppo", 1, 0, 0, "cpu") > 0
    with pytest.raises(ValueError, match="unknown kind"):
        episode_rate.parse("dqn:1:1")


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal on a box without a GPU")
@pytest.mark.parametrize("module", ["ppo_campaign", "ps_campaign"])
def test_no_silent_cpu_fallback(tmp_path, module):
    argv = ["--seeds", "1", "--episodes", "1", "--out",
            str(tmp_path / "out.json")]
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, "-m", f"diral_tpu_torch.scripts.{module}", *argv],
        cwd=ROOT, env=env, capture_output=True, text=True)
    assert out.returncode != 0 and "no CUDA device" in out.stderr
    assert not os.listdir(tmp_path)
    script = {"ppo_campaign": ppo_campaign, "ps_campaign": ps_campaign}[module]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        script.main(argv)
