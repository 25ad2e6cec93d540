"""Checkpoints and exact resume of the port's DRQN runner
(diral_tpu_torch/train/checkpoint.py, runner.train_experiment), on the CPU
at the cut toy size of test_torch_train_slice.py.

* A run cut at a checkpoint and resumed equals the uninterrupted run bit
  for bit -- the whole carry, the generator state and the result arrays --
  in float32, float64 and with bf16 storage of the ring and history.
* Resume against JAX: the port on JAX's draws, cut at slot 20 and resumed,
  matches JAX's 40-slot run in test_torch_train_slice.py's classes.
* ``--resume`` on an empty directory is a cold start and writes
  checkpoints without ``save_model``; the ``_best`` snapshot and its
  ``best_metric.json``, re-read on resume; ``eval`` / ``compare-sps
  --checkpoint [--best]`` on the CPU; two simulations checkpoint into
  directories of their own.
* The file loads with ``torch.load(weights_only=True)``; a generator of
  another device type is refused; only the last ``max_to_keep`` stay.
"""

import dataclasses
import json
import os

import numpy as np
import jax
import pytest
import torch
import yaml

from diral_tpu_torch.train import checkpoint as ckpt
from diral_tpu_torch.train import runner
from test_torch_train_slice import (JCFG, SEED, TCFG, JaxChainDraws,
                                    jax_run)  # noqa: F401 (fixture)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
CFG = dataclasses.replace(TCFG, time_slots=40, save_freq=20, save_model=True)
NAME = CFG.experiment_name


def _equal(x, y, path=""):
    """Bit-equality of two ``carry_state`` trees; returns the paths that
    differ."""
    if isinstance(x, dict):
        assert x.keys() == y.keys(), path
        return [p for k in x for p in _equal(x[k], y[k], f"{path}.{k}")]
    if isinstance(x, (list, tuple)):
        return [p for a, b in zip(x, y) for p in _equal(a, b, path)]
    if isinstance(x, torch.Tensor):
        same = x.dtype == y.dtype and torch.equal(x, y)
    else:
        same = x == y
    return [] if same else [path]


def _run(cfg, workdir, **kw):
    kw.setdefault("device", "cpu")
    return runner.train_experiment(cfg, str(workdir), verbose=False, **kw)


def _with_storage(storage):
    if storage == "bf16":
        net = dataclasses.replace(CFG.agent.network,
                                  compute_dtype="bfloat16")
        return (dataclasses.replace(CFG, agent=dataclasses.replace(
            CFG.agent, network=net)), torch.float32)
    return CFG, {"float32": torch.float32, "float64": torch.float64}[storage]


@pytest.mark.parametrize("storage", ["float32", "float64", "bf16"])
def test_resume_is_exact(tmp_path, storage):
    cfg, dtype = _with_storage(storage)
    ca, oa = _run(cfg, tmp_path / "a", dtype=dtype)
    _, ob = _run(dataclasses.replace(cfg, time_slots=20), tmp_path / "b",
                 dtype=dtype)
    assert ckpt.latest_step(tmp_path / "b" / "save_model" / "test"
                            / NAME) == 20
    cc, oc = _run(cfg, tmp_path / "b", dtype=dtype, resume=True)
    assert not _equal(ckpt.carry_state(ca), ckpt.carry_state(cc))
    if storage == "bf16":
        assert cc.replay.buf.dtype == cc.history.dtype == torch.bfloat16
    for k in ("sum_reward", "actions"):
        np.testing.assert_array_equal(oc[k], oa[k], err_msg=k)
    # the preloaded slots have no loss; the resumed ones equal the run's
    assert np.isnan(oc["loss"][:20]).all()
    np.testing.assert_array_equal(oc["loss"][20:], oa["loss"][20:])
    np.testing.assert_array_equal(ob["loss"], oa["loss"][:20])
    assert (oa["loss"][20:] != 0).sum() == 4    # t = 24, 29, 34, 39
    # the generator went on from where the cut one stopped
    ga = torch.load(tmp_path / "a" / "save_model" / "test" / NAME
                    / "ckpt_40.pt", weights_only=True)["generator"]
    gc = torch.load(tmp_path / "b" / "save_model" / "test" / NAME
                    / "ckpt_40.pt", weights_only=True)["generator"]
    assert torch.equal(ga["state"], gc["state"])


def test_resume_matches_jax(tmp_path, jax_run):
    """Cut at slot 20 and resumed on JAX's draws: JAX's 40 slots, in the
    classes of test_torch_train_slice.py's slot test."""
    d0, key, jcarry, jlogs = jax_run

    def draws():
        return JaxChainDraws(key, JCFG, SEED, 40,
                             params=d0["learner"]["params"])

    cut = dataclasses.replace(CFG, time_slots=20)
    _, ob = _run(cut, tmp_path, dtype=torch.float64, draws=draws())
    carry, oc = _run(CFG, tmp_path, dtype=torch.float64, draws=draws(),
                     resume=True)
    want = lambda k: np.stack([lg[k] for lg in jlogs])   # noqa: E731
    np.testing.assert_array_equal(oc["actions"], want("actions"))
    np.testing.assert_array_equal(oc["sum_reward"], want("sum_reward"))
    loss = np.concatenate([ob["loss"], oc["loss"][20:]])
    assert np.abs(loss - want("loss")).max() <= 1e-10
    got = carry.learner.params.tree()
    for g, leaves in jax.tree.map(np.asarray,
                                  jcarry.learner.params).items():
        for k, v in leaves.items():
            assert np.abs(got[g][k].detach().numpy() - v).max() <= 1e-9
    np.testing.assert_array_equal(carry.replay.buf.numpy(),
                                  np.asarray(jcarry.replay.buf))
    assert carry.replay.ptr == int(jcarry.replay.ptr[0])
    np.testing.assert_array_equal(carry.history.numpy(),
                                  np.asarray(jcarry.history))


def test_resume_cold_start_without_save_model(tmp_path, capsys):
    cfg = dataclasses.replace(CFG, save_model=False)
    ckdir = tmp_path / "save_model" / "test" / NAME
    runner.train_experiment(dataclasses.replace(cfg, time_slots=20),
                            str(tmp_path), device="cpu", resume=True)
    assert "no checkpoint yet; starting fresh" in capsys.readouterr().out
    assert ckpt.steps(ckdir) == [20]
    assert not os.path.exists(str(ckdir) + "_best")
    runner.train_experiment(cfg, str(tmp_path), device="cpu", resume=True)
    assert "resumed from slot 20" in capsys.readouterr().out
    assert ckpt.steps(ckdir) == [20, 40]
    # without save_model or --resume nothing is written
    _run(cfg, tmp_path / "plain")
    assert not os.path.exists(tmp_path / "plain" / "save_model")


def test_best_snapshot(tmp_path):
    cfg = dataclasses.replace(CFG, time_slots=60)
    _, out = _run(cfg, tmp_path)
    best_dir = tmp_path / "save_model" / "test" / f"{NAME}_best"
    means = {t: float(out["sum_reward"][t - 20:t].mean())
             for t in (20, 40, 60)}
    marker = json.load(open(best_dir / "best_metric.json"))
    step = max(means, key=means.get)
    assert marker == {"step": step, "mean_sum_reward": means[step]}
    assert ckpt.steps(best_dir) == [step]
    # resume re-reads the marker: a better past snapshot is not replaced
    json.dump({"step": 1, "mean_sum_reward": 1e9},
              open(best_dir / "best_metric.json", "w"))
    _run(dataclasses.replace(cfg, time_slots=80), tmp_path, resume=True)
    assert json.load(open(best_dir / "best_metric.json"))["step"] == 1
    assert ckpt.steps(best_dir) == [step]


def test_simulations_checkpoint_apart(tmp_path):
    """Simulation 1 checkpoints beside simulation 0, not over it, and each
    resumes its own run: equal to its uninterrupted run."""
    cfg = dataclasses.replace(CFG, simulations=2)
    full = [c for c, _ in runner.run_all_simulations(
        cfg, str(tmp_path / "a"), device="cpu", verbose=False)]
    runner.run_all_simulations(dataclasses.replace(cfg, time_slots=20),
                               str(tmp_path / "b"), device="cpu",
                               verbose=False)
    base = tmp_path / "b" / "save_model" / "test"
    assert ckpt.steps(base / NAME) == ckpt.steps(base / f"{NAME}_sim1") == [20]
    resumed = [c for c, _ in runner.run_all_simulations(
        cfg, str(tmp_path / "b"), device="cpu", verbose=False, resume=True)]
    for a, c in zip(full, resumed):
        assert not _equal(ckpt.carry_state(a), ckpt.carry_state(c))
    assert _equal(ckpt.carry_state(full[0]), ckpt.carry_state(full[1]))


def _cli(capsys, args):
    """The verb in this process (cli.main); returns its standard output."""
    from diral_tpu_torch.train import cli

    capsys.readouterr()
    cli.main(args)
    return capsys.readouterr().out


def _cut_yaml(tmp_path):
    raw = yaml.safe_load(open(os.path.join(ROOT, "configs",
                                           "toy_4ue_3r.yaml")))
    raw.update(episode_interval=5, memory_size=64, explore=10, save_freq=10,
               save_model=True, save_positions=False)
    raw["RLAgent"].update(batch_size=8)
    raw["RLAgent"]["network"]["layers"] = {1: 32, 2: 32}
    raw["Engine"] = {"num_envs": 2, "seed": 1}
    path = tmp_path / "cut.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def test_cli_resume_and_eval_checkpoint(tmp_path, capsys):
    cfg = _cut_yaml(tmp_path)
    wd = str(tmp_path / "w")
    train = ["train", cfg, "--device", "cpu", "--workdir", wd, "--resume"]
    out = _cli(capsys, train + ["--slots", "20"])
    assert "no checkpoint yet; starting fresh" in out
    out = _cli(capsys, train + ["--slots", "30"])
    assert "resumed from slot 20" in out
    rewards = np.load(os.path.join(wd, "save_results", "test", "toy_4ue_3r",
                                   "rewards_sim0.npy"))
    assert rewards.shape == (30, 2)
    ckdir = os.path.join(wd, "save_model", "test", "toy_4ue_3r")
    best = json.load(open(ckdir + "_best/best_metric.json"))["step"]
    for verb, extra, step in (("eval", [], 30),
                              ("eval", ["--best"], best),
                              ("compare-sps", [], 30),
                              ("compare-sps", ["--best"], best)):
        out = _cli(capsys, [verb, cfg, "--device", "cpu", "--steps", "3",
                            "--num-envs", "2", "--checkpoint", ckdir,
                            *extra])
        assert f"loaded checkpoint at slot {step}" in out
        res = json.loads(out.strip().splitlines()[-1])
        keys = ({"drqn", "sps", "prr_improvement"} if verb == "compare-sps"
                else {"mean_prr", "mean_sum_reward"})
        assert keys <= set(res), res
    with pytest.raises(FileNotFoundError, match="no checkpoint found"):
        _cli(capsys, ["eval", cfg, "--device", "cpu", "--checkpoint",
                      str(tmp_path / "none")])


def test_weights_only_and_learner(tmp_path):
    carry, _ = _run(CFG, tmp_path)
    ckdir = tmp_path / "save_model" / "test" / NAME
    blob = torch.load(ckdir / "ckpt_40.pt", weights_only=True)
    assert blob["step"] == 40 and blob["device"] == "cpu"
    assert blob["generator"]["device"] == "cpu"
    assert isinstance(blob["carry"]["beta"], float)
    assert isinstance(blob["carry"]["eps_state"]["eps"], float)
    learner, step = ckpt.load_learner(str(ckdir), CFG, "cpu")
    assert step == 40
    for a, b in ((learner.params, carry.learner.params),
                 (learner.target_params, carry.learner.target_params)):
        for p, q in zip(a.parameters(), b.parameters()):
            assert torch.equal(p, q)
    assert not _equal(learner.opt.state_dict(),
                      carry.learner.opt.state_dict())


class _CudaGenerator:
    """Stands in for a CUDA generator: its state saves as such."""

    device = torch.device("cuda")

    def get_state(self):
        return torch.zeros(16, dtype=torch.uint8)


def test_generator_device_mismatch_refused(tmp_path):
    from diral_tpu_torch.train import loop

    fns = loop.make_train_functions(TCFG, torch.float32, "cpu")
    carry = fns.init_carry(loop.Draws(torch.Generator().manual_seed(0)))
    ckpt.save(str(tmp_path), 7, carry, _CudaGenerator())
    with pytest.raises(ValueError, match="cuda generator"):
        ckpt.restore(str(tmp_path), carry, torch.Generator())
    # the learner alone loads onto any device
    learner, step = ckpt.load_learner(str(tmp_path), TCFG, "cpu")
    assert step == 7
    # draws passed in by the caller carry no generator to restore
    restored, step = ckpt.restore(str(tmp_path), carry, None)
    assert step == 7 and restored.replay.ptr == carry.replay.ptr


def test_rolling_and_refusals(tmp_path):
    from diral_tpu_torch.train import loop

    fns = loop.make_train_functions(TCFG, torch.float32, "cpu")
    gen = torch.Generator().manual_seed(0)
    carry = fns.init_carry(loop.Draws(gen))
    for step in range(1, 6):
        ckpt.save(str(tmp_path), step, carry, gen)
    assert ckpt.steps(str(tmp_path)) == [3, 4, 5]
    assert sorted(os.listdir(tmp_path)) == ["ckpt_3.pt", "ckpt_4.pt",
                                            "ckpt_5.pt"]
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "empty"), carry, gen)
    # a carry of another width does not take the checkpoint
    wide = dataclasses.replace(TCFG, engine=dataclasses.replace(
        TCFG.engine, num_envs=3))
    other = loop.make_train_functions(wide, torch.float32, "cpu").init_carry(
        loop.Draws(torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="does not fit"):
        ckpt.restore(str(tmp_path), other, torch.Generator())
    # no CUDA device: the learner of a checkpoint asks for one
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            ckpt.load_learner(str(tmp_path), TCFG)
