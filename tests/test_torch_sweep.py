"""The port's seed sweep (diral_tpu_torch/train/sweep.py, ``train-sweep``) on
the CPU at the cut toy size of test_torch_train_slice.py: duplicate seeds
train identically, every row IS the standalone
``runner.train_experiment(cfg, seed=s)`` run, and the verb prints the JAX
verb's row keys (taken from diral_tpu's own ``cmd_train_sweep`` with its
training and evaluation stubbed out) and takes the JAX verb's options.
"""

import contextlib
import dataclasses
import io
import json
import os

import numpy as np
import pytest
import torch

from diral_tpu_torch.train import checkpoint as ckpt
from diral_tpu_torch.train import runner
from diral_tpu_torch.train.sweep import run_seed_sweep, split_seed
from test_torch_train_slice import TCFG

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
CFG = dataclasses.replace(TCFG, time_slots=30, save_freq=10)


def _params_equal(a, b):
    return all(torch.equal(p, q) for p, q in
               zip(a.learner.params.parameters(),
                   b.learner.params.parameters()))


def test_duplicate_seeds_train_identically():
    carries, logs = run_seed_sweep(CFG, [3, 3], verbose=False,
                                   device="cpu")
    assert logs["sum_reward"].shape == (2, 30, 2)
    assert logs["loss"].shape == (2, 30)
    np.testing.assert_array_equal(logs["sum_reward"][0],
                                  logs["sum_reward"][1])
    np.testing.assert_array_equal(logs["loss"][0], logs["loss"][1])
    assert _params_equal(split_seed(carries, 0), split_seed(carries, 1))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_row_is_the_standalone_run(tmp_path, dtype):
    carries, logs = run_seed_sweep(CFG, [0, 1], chunk_size=7, dtype=dtype,
                                   verbose=False, device="cpu")
    assert not np.array_equal(logs["sum_reward"][0], logs["sum_reward"][1])
    for i, s in enumerate((0, 1)):
        carry, out = runner.train_experiment(
            CFG, str(tmp_path / str(s)), seed=s, simulation=0, dtype=dtype,
            verbose=False, device="cpu")
        np.testing.assert_array_equal(logs["sum_reward"][i],
                                      out["sum_reward"])
        np.testing.assert_array_equal(logs["loss"][i], out["loss"])
        mine, theirs = (ckpt.carry_state(split_seed(carries, i)),
                        ckpt.carry_state(carry))
        for k in ("history", "state", "sum_ia_prev"):
            assert torch.equal(mine[k], theirs[k]), k
        assert torch.equal(mine["replay"]["buf"], theirs["replay"]["buf"])
        assert _params_equal(split_seed(carries, i), carry)


ROW_KEYS = {"seed", "final_mean_sum_reward", "drqn_prr", "sps_prr",
            "prr_improvement"}


def _jax_sweep_rows(monkeypatch, cfg_path):
    """diral_tpu's own ``cmd_train_sweep`` with its training and evaluation
    stubbed: the rows it prints, for their keys."""
    from diral_tpu.train import cli as jcli
    from diral_tpu.train import evaluate as jeval
    from diral_tpu.train import sweep as jsweep

    class Carry:
        learner = None

    def fake_sweep(cfg, seeds):
        return [Carry()] * len(seeds), {
            "sum_reward": np.zeros((len(seeds), 10, 2), np.float32),
            "loss": np.zeros((len(seeds), 10), np.float32)}

    monkeypatch.setattr(jsweep, "run_seed_sweep", fake_sweep)
    monkeypatch.setattr(jsweep, "split_seed", lambda c, i: c[i])
    monkeypatch.setattr(jeval, "compare_drqn_vs_sps",
                        lambda *a, **k: {"drqn": {"mean_prr": 0.5},
                                         "sps": {"mean_prr": 0.4},
                                         "prr_improvement": 0.25})
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jcli.main(["train-sweep", cfg_path, "--seeds", "2"])
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_cli_rows_have_the_jax_keys(tmp_path, monkeypatch, capsys):
    from diral_tpu_torch.train import cli
    from test_torch_checkpoint import _cut_yaml

    cfg = _cut_yaml(tmp_path)
    jrows = _jax_sweep_rows(monkeypatch, cfg)
    assert [set(r) for r in jrows] == [ROW_KEYS] * 2
    capsys.readouterr()
    cli.main(["train-sweep", cfg, "--seeds", "2", "--slots", "20",
              "--eval-steps", "3", "--device", "cpu"])
    rows = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert [r["seed"] for r in rows] == [0, 1]
    assert [set(r) for r in rows] == [set(r) for r in jrows]
    for r in rows:
        assert 0.0 <= r["drqn_prr"] <= 1.0 and 0.0 <= r["sps_prr"] <= 1.0


def _options(main, verb, capsys):
    """The ``--options`` a CLI's verb takes, from its --help."""
    capsys.readouterr()
    with pytest.raises(SystemExit):
        main([verb, "--help"])
    text = capsys.readouterr().out
    return {w.strip("[],") for w in text.split()
            if w.startswith(("--", "[--")) and w.strip("[],") != "--help"}


@pytest.mark.parametrize("verb", ["train", "train-sweep", "eval",
                                  "compare-sps", "profile"])
def test_verbs_take_the_jax_options(verb, capsys):
    """Every option of the JAX verb but the parallel ones, plus --device.
    JAX's train-sweep and profile take --seed from a shared parent parser
    and ignore it (seeds 0..S-1, a profile seeded 0); the port leaves it
    out rather than accept an option that does nothing."""
    from diral_tpu.train import cli as jcli
    from diral_tpu_torch.train import cli

    jax_opts = _options(jcli.main, verb, capsys)
    mine = _options(cli.main, verb, capsys)
    later = {"--num-processes", "--process-id"}   # ROADMAP "Parallel"
    ignored = {"--seed"} if verb in ("train-sweep", "profile") else set()
    assert jax_opts - later - ignored <= mine, jax_opts - mine
    assert not ignored & mine
    assert mine - jax_opts == {"--device"}


def test_sweep_needs_the_card_without_cpu():
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_seed_sweep(CFG, [0], verbose=False)
