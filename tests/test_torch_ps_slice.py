"""The PS-DQN / PS-DRQN training slice on the CPU: the port's
``make_ps_functions`` against the JAX package's ``init_carry`` and
``episode`` (each under jit) on a cut configs/congested_6v_5r.yaml (4
envs x 6 vehicles, layers 32/32, 5-slot episodes, eps from 0.5), with the
JAX package's random draws replayed through a test-side ``PSDraws`` that
walks ps_loop.py's key chain (ps_loop.py:92-93, 116, 134, 150-160;
dqn.py:70-73, 135-142; ps_drqn.py:160-168).

* float64, both algorithms, 3 episodes: the init carry bit-equal; after
  every episode the env state, the state vectors and the replay (states,
  actions, rewards, masks / lengths: the episode's actions identical and
  rewards bit-equal) bit-equal, the eps schedule equal, the loss within
  1e-10, the GRU hidden within 1e-12 and the learner's params, target and
  Adam moments within 1e-9;
* float32 with ``hist_impl="lanes"``: one episode's state vectors (in the
  replay) bit-equal to JAX's lanes path (the Pallas K7 kernel in interpret
  mode under the env vmap), the port's K7 wrapper called every slot;
* the ``train-ps`` verb on the CPU prints the JAX verb's keys (its
  refusal without ``--device cpu`` is in tests/test_torch_hygiene.py).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diral_tpu.config import load_config as jload
from diral_tpu.envs import v2v_env as jenv
from diral_tpu.train import ps_loop as jloop
from diral_tpu_torch.config import load_config as tload
from diral_tpu_torch.convert import (ps_dqn_learner_from_numpy,
                                     ps_drqn_learner_from_numpy)
from diral_tpu_torch.envs import v2v_env as tenv
from diral_tpu_torch.ops import lanes_hist as K7
from diral_tpu_torch.train import ps_loop as tloop

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
CONFIG = os.path.join(ROOT, "configs", "congested_6v_5r.yaml")
SEED, EPISODES = 4, 3
FIELDS = ("pos_x", "pos_y", "vel", "direction", "table_x", "table_y",
          "table_seq", "table_age", "last_arrival", "prev_obs", "pf_counter")
REPLAY = {"ps-dqn": ("states", "actions", "rewards", "terminals", "masks"),
          "ps-drqn": ("states", "actions", "rewards", "terminals",
                      "lengths")}


def cut(cfg, hist_impl="xla"):
    env = dataclasses.replace(cfg.env, step_impl="xla", state=dataclasses
                              .replace(cfg.env.state, hist_impl=hist_impl))
    net = dataclasses.replace(cfg.agent.network, layers=(32, 32))
    agent = dataclasses.replace(cfg.agent, network=net, batch_size=8,
                                unroll_step=4, target_update=2, eps_init=0.5,
                                eps_decay=0.9)
    return dataclasses.replace(
        cfg, env=env, agent=agent, episode_interval=5, memory_size=512,
        engine=dataclasses.replace(cfg.engine, num_envs=4))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(t):
    return jax.tree.map(np.asarray, t)


def learner_dict(lrn) -> dict:
    adam = lrn.opt_state[1][0]    # chain(clip, adam)
    return {"params": _np(lrn.params),
            "target_params": _np(lrn.target_params),
            "mu": _np(adam.mu), "nu": _np(adam.nu), "count": int(adam.count)}


class JaxPSDraws(tloop.PSDraws):
    """JAX's draws, key for key: PRNGKey(SEED) -> (env, act, net, carry);
    each episode splits the carried key into (key, slots, train)."""

    def __init__(self, jcfg, n_batches):
        self.jcfg = jcfg
        self.k_env, self.k_act, _, key = jax.random.split(
            jax.random.PRNGKey(SEED), 4)
        self.slot_keys, self.train_keys = [], []
        for _ in range(EPISODES):
            key, k_ep, k_train = jax.random.split(key, 3)
            self.slot_keys.append(jax.random.split(k_ep,
                                                   jcfg.episode_interval))
            self.train_keys.append(jax.random.split(k_train, n_batches))

    @property
    def device(self):
        return torch.device("cpu")

    def reset(self, env_cfg, num_envs, dtype):
        jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
        js = jax.vmap(lambda k: jenv.reset(self.jcfg.env, k, jdt))(
            jax.random.split(self.k_env, num_envs))
        return tenv.EnvState(**{f: _t(getattr(js, f)) for f in FIELDS})

    def init_actions(self, env_cfg, num_envs):
        return _t(jax.vmap(lambda k: jenv.sample_actions(self.jcfg.env, k))(
            jax.random.split(self.k_act, num_envs)))

    def eps_greedy(self, ep, i, rows, num_actions):
        kd, kr = jax.random.split(self.slot_keys[ep][i])
        return (_t(jax.random.uniform(kd, (rows,))),
                _t(jax.random.randint(kr, (rows,), 0, num_actions)))

    def replay_indices(self, ep, j, replay, batch):
        return _t(jax.random.randint(self.train_keys[ep][j], (batch,), 0,
                                     max(replay.count - 1, 1)))

    def windows(self, ep, j, replay, batch):
        k_ep, k_start = jax.random.split(self.train_keys[ep][j])
        valid = np.arange(replay.capacity) < replay.count
        w = np.where(valid, replay.lengths.numpy(), 0).astype(np.float32)
        logits = jnp.log(jnp.maximum(jnp.asarray(w), 1e-9))
        eps_idx = jax.random.categorical(k_ep, logits, shape=(batch,))
        length = jnp.asarray(replay.lengths.numpy())[eps_idx]
        start = jax.random.randint(k_start, (batch,), 0,
                                   jnp.maximum(length, 1))
        return _t(eps_idx), _t(start)


def _convert(algo, jlearner, acfg):
    conv = (ps_drqn_learner_from_numpy if algo == "ps-drqn"
            else ps_dqn_learner_from_numpy)
    return conv(learner_dict(jlearner), acfg)


def _assert_carry(tc, jc, algo, ep):
    msg = f"{algo} episode {ep}"
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tc.env_state, f).numpy(),
                                      np.asarray(getattr(jc.env_state, f)),
                                      err_msg=f"{msg} {f}")
    np.testing.assert_array_equal(tc.state.numpy(), np.asarray(jc.state),
                                  err_msg=msg)
    for k in REPLAY[algo]:
        np.testing.assert_array_equal(getattr(tc.replay, k).numpy(),
                                      np.asarray(getattr(jc.replay, k)),
                                      err_msg=f"{msg} replay {k}")
    ptr = "ptr" if algo == "ps-drqn" else "head"
    assert (getattr(tc.replay, ptr), tc.replay.count) == (
        int(getattr(jc.replay, ptr)), int(jc.replay.count)), msg
    assert tc.eps_state.eps == np.float32(jc.eps_state.eps), msg
    if algo == "ps-drqn":
        np.testing.assert_allclose(tc.hidden.numpy(), np.asarray(jc.hidden),
                                   rtol=0, atol=1e-12, err_msg=msg)


def _assert_learner(tl, jl, algo):
    want = learner_dict(jl)
    for name, p in tl.params.named_parameters():
        g, k = name.split(".")
        for got, key in ((p.detach(), "params"),
                         (tl.opt.state[p]["exp_avg"], "mu"),
                         (tl.opt.state[p]["exp_avg_sq"], "nu")):
            np.testing.assert_allclose(got.numpy(), want[key][g][k], rtol=0,
                                       atol=1e-9, err_msg=f"{algo} {key} "
                                                          f"{name}")
    for name, p in tl.target_params.named_parameters():
        g, k = name.split(".")
        np.testing.assert_allclose(p.numpy(), want["target_params"][g][k],
                                   rtol=0, atol=1e-9, err_msg=name)


@pytest.mark.parametrize("algo", ["ps-dqn", "ps-drqn"])
def test_episodes_match_jax(algo):
    jcfg, tcfg = cut(jload(CONFIG)), cut(tload(CONFIG))
    init_fn, episode_fn, _ = jloop.make_ps_functions(jcfg, algo, jnp.float64)
    jcarry = jax.jit(init_fn)(jax.random.PRNGKey(SEED))
    episode = jax.jit(episode_fn)
    fns = tloop.make_ps_functions(tcfg, algo, torch.float64, device="cpu")
    assert fns.n_batches == (15 if algo == "ps-dqn" else 3)
    draws = JaxPSDraws(jcfg, fns.n_batches)
    carry = fns.init_carry(draws, learner=_convert(algo, jcarry.learner,
                                                   tcfg.agent))
    _assert_carry(carry, jcarry, algo, "init")
    for ep in range(EPISODES):
        jcarry, jlog = episode(jcarry, jnp.asarray(ep, jnp.int32))
        carry, log = fns.episode(carry, ep, draws)
        _assert_carry(carry, jcarry, algo, ep)
        np.testing.assert_allclose(float(log["mean_sum_reward"]),
                                   float(jlog["mean_sum_reward"]), rtol=0,
                                   atol=1e-12)
        np.testing.assert_allclose(float(log["loss"]), float(jlog["loss"]),
                                   rtol=0, atol=1e-10)
        assert log["eps"] == np.float32(jlog["eps"])
        _assert_learner(carry.learner, jcarry.learner, algo)
    actions = carry.replay.actions.numpy()
    assert len(np.unique(actions)) > 1


@pytest.mark.parametrize("algo", ["ps-dqn", "ps-drqn"])
def test_lanes_episode_float32(monkeypatch, algo):
    calls = []

    def spy(*a, **k):
        calls.append(a[2])
        return K7.lanes_histogram(*a, **k)

    monkeypatch.setattr(tenv, "lanes_histogram", spy)
    jcfg, tcfg = (cut(load(CONFIG), "lanes") for load in (jload, tload))
    init_fn, episode_fn, _ = jloop.make_ps_functions(jcfg, algo, jnp.float32)
    jcarry = jax.jit(init_fn)(jax.random.PRNGKey(SEED))
    fns = tloop.make_ps_functions(tcfg, algo, torch.float32, device="cpu")
    draws = JaxPSDraws(jcfg, fns.n_batches)
    carry = fns.init_carry(draws, learner=_convert(algo, jcarry.learner,
                                                   tcfg.agent))
    jcarry, _ = jax.jit(episode_fn)(jcarry, jnp.asarray(0, jnp.int32))
    carry, _ = fns.episode(carry, 0, draws)
    assert carry.replay.states.dtype == torch.float32
    for got, want in ((carry.replay.states, jcarry.replay.states),
                      (carry.replay.actions, jcarry.replay.actions),
                      (carry.state, jcarry.state)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert calls == [6] * (1 + jcfg.episode_interval)
    # the piggy histogram lanes of the state vectors are filled
    assert carry.state[..., 5:].abs().sum() > 0


def test_train_ps_verb():
    for algo in ("ps-dqn", "ps-drqn"):
        out = subprocess.run(
            [sys.executable, "-m", "diral_tpu_torch", "train-ps", CONFIG,
             "--algo", algo, "--episodes", "2", "--num-envs", "2",
             "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
            timeout=300, check=True)
        res = json.loads(out.stdout.strip().splitlines()[-1])
        assert set(res) == {"algo", "episodes", "mean_sum_reward_first100",
                            "mean_sum_reward_last100", "final_eps"}
        assert res["algo"] == algo and res["episodes"] == 2
