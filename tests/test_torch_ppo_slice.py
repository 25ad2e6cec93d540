"""The PPO training slice on the CPU: the port's ``make_ppo_functions``
against the JAX package's on a cut configs/ppo_congested.yaml (4 envs x 6
vehicles, H = 32, 10-slot episodes), with the JAX package's random draws
replayed into the port through a test-side ``PPODraws`` that walks
ppo_loop.py's key chain (ppo_loop.py:50-59, 65-66, 101-106).

* float64: the init state bit-equal; episode 0 slot for slot against
  JAX's slot body (ppo_loop.py:62-76, spelled out here under jit): actions
  identical, rewards and policy windows bit-equal; three whole episodes
  against JAX's ``run``: mean sum rewards within 1e-12, losses within
  1e-10, final params within 1e-9 and Adam moments within 1e-9;
* float32 with ``hist_impl="lanes"``: one episode's policy windows (the
  state vectors) bit-equal to JAX's lanes path (the Pallas K7 kernel in
  interpret mode under the env vmap), the port's K7 wrapper called every
  slot;
* the ``train-ppo`` verb on the CPU prints the JAX verb's keys (its
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
import torch

from diral_tpu.agents import ppo as jppo
from diral_tpu.config import load_config as jload
from diral_tpu.envs import v2v_env as jenv
from diral_tpu.train import ppo_loop as jloop
from diral_tpu_torch.config import load_config as tload
from diral_tpu_torch.convert import ppo_learner_from_numpy
from diral_tpu_torch.envs import v2v_env as tenv
from diral_tpu_torch.ops import lanes_hist as K7
from diral_tpu_torch.train import ppo_loop as tloop

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
CONFIG = os.path.join(ROOT, "configs", "ppo_congested.yaml")
SEED, EPISODES = 2, 3
FIELDS = ("pos_x", "pos_y", "vel", "direction", "table_x", "table_y",
          "table_seq", "table_age", "last_arrival", "prev_obs", "pf_counter")


def cut(cfg, hist_impl="xla"):
    env = dataclasses.replace(cfg.env, step_impl="xla", state=dataclasses
                              .replace(cfg.env.state, hist_impl=hist_impl))
    net = dataclasses.replace(cfg.agent.network, layers=(32, 32),
                              lstm_impl="xla")
    return dataclasses.replace(
        cfg, env=env, agent=dataclasses.replace(cfg.agent, network=net),
        episode_interval=10,
        engine=dataclasses.replace(cfg.engine, num_envs=4))


def _t(a):
    return torch.from_numpy(np.array(a))


def learner_dict(lrn) -> dict:
    adam = lrn.opt_state[0]
    tree = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return {"params": tree(lrn.params), "old_params": tree(lrn.old_params),
            "mu": tree(adam.mu), "nu": tree(adam.nu), "count": int(adam.count)}


class JaxPPODraws(tloop.PPODraws):
    """JAX's draws, key for key: PRNGKey(SEED) -> (init, learn, episodes);
    each episode key splits once per slot into (key, action key)."""

    def __init__(self, jcfg, dtype):
        self.jcfg, self.jdtype = jcfg, dtype
        k_init, self.k_learn, k_eps = jax.random.split(
            jax.random.PRNGKey(SEED), 3)
        self.k_env, self.k_act = jax.random.split(k_init)
        self.slot_keys = []
        for key in jax.random.split(k_eps, EPISODES):
            keys = []
            for _ in range(jcfg.episode_interval):
                key, ka = jax.random.split(key)
                keys.append(ka)
            self.slot_keys.append(keys)

    @property
    def device(self):
        return torch.device("cpu")

    def jax_reset(self):
        B = self.jcfg.engine.num_envs
        return jax.vmap(lambda k: jenv.reset(self.jcfg.env, k, self.jdtype))(
            jax.random.split(self.k_env, B))

    def jax_init_actions(self):
        return jax.vmap(lambda k: jenv.sample_actions(self.jcfg.env, k))(
            jax.random.split(self.k_act, self.jcfg.engine.num_envs))

    def reset(self, env_cfg, num_envs, dtype):
        js = self.jax_reset()
        return tenv.EnvState(**{f: _t(getattr(js, f)) for f in FIELDS})

    def init_actions(self, env_cfg, num_envs):
        return _t(self.jax_init_actions())

    def jax_learner(self):
        env = self.jcfg.env
        return jppo.init_learner(self.k_learn, env.state_space,
                                 env.num_channels, self.jcfg.agent,
                                 self.jdtype)

    def gumbel(self, ep, i, rows, num_actions, dtype):
        jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
        return _t(jax.random.gumbel(self.slot_keys[ep][i],
                                    (rows, num_actions), jdt))


def jax_episode0(jcfg, draws):
    """JAX's init_state and episode-0 slots (ppo_loop.py:50-76) under
    jit, from the draws' keys: [(x, actions, rew)] per slot."""
    env_cfg, acfg = jcfg.env, jcfg.agent
    B, N = jcfg.engine.num_envs, env_cfg.num_users
    D, T = env_cfg.state_space, acfg.step_size
    v_step = jax.vmap(lambda s, a, t: jenv.step_channel(env_cfg, s, a, t),
                      in_axes=(0, 0, None))
    v_obtain = jax.vmap(lambda s, o, a, r: jenv.obtain_state(env_cfg, s, o, a,
                                                             r))

    @jax.jit
    def init(env_state, a0):
        env_state, obs, rew = v_step(env_state, a0, 0)
        s0 = v_obtain(env_state, obs, a0, rew)
        history = jnp.zeros((B, T, N, D), draws.jdtype).at[:, -1].set(s0)
        return env_state, history

    @jax.jit
    def slot(env_state, history, learner, ka, t):
        x = jnp.transpose(history, (0, 2, 1, 3)).reshape(B * N, T, D)
        actions = jppo.choose_actions(learner, x, ka, acfg).reshape(B, N)
        env_state, obs, rew = v_step(env_state, actions, t)
        sv = v_obtain(env_state, obs, actions, rew)
        history = jnp.roll(history, -1, axis=1).at[:, -1].set(sv)
        return env_state, history, x, actions, rew

    env_state, history = init(draws.jax_reset(), draws.jax_init_actions())
    learner, out = draws.jax_learner(), []
    for i, ka in enumerate(draws.slot_keys[0]):
        env_state, history, x, a, r = slot(env_state, history, learner, ka,
                                           jnp.asarray(i, jnp.int32))
        out.append((np.asarray(x), np.asarray(a), np.asarray(r)))
    return out, history


def _rollout0(tcfg, dtype, draws):
    fns = tloop.make_ppo_functions(tcfg, dtype, device="cpu")
    learner = ppo_learner_from_numpy(learner_dict(draws.jax_learner()))
    env_state, history = fns.init_state(draws)
    _, history, traj = fns.rollout(env_state, history, learner, 0, draws)
    return traj, history


def test_episode0_slot_for_slot():
    jcfg, tcfg = cut(jload(CONFIG)), cut(tload(CONFIG))
    draws = JaxPPODraws(jcfg, jnp.float64)
    jout, jhist = jax_episode0(jcfg, draws)
    traj, history = _rollout0(tcfg, torch.float64, draws)
    B, N = 4, 6
    for i, (x, a, r) in enumerate(jout):
        np.testing.assert_array_equal(traj["x"][i].numpy(), x, err_msg=str(i))
        np.testing.assert_array_equal(traj["actions"][i].numpy(),
                                      a.reshape(-1), err_msg=str(i))
        np.testing.assert_array_equal(traj["rew"][i].numpy(), r.reshape(-1),
                                      err_msg=str(i))
    np.testing.assert_array_equal(history.numpy(),
                                  np.transpose(np.asarray(jhist), (0, 2, 1, 3)))
    assert len({int(a) for _, acts, _ in jout for a in acts.reshape(-1)}) > 1
    assert traj["x"].shape[1] == B * N


def test_episodes_match_jax_run():
    jcfg, tcfg = cut(jload(CONFIG)), cut(tload(CONFIG))
    run = jloop.make_ppo_functions(jcfg, jnp.float64)
    jl, jlogs = run(jax.random.PRNGKey(SEED), EPISODES)
    draws = JaxPPODraws(jcfg, jnp.float64)
    fns = tloop.make_ppo_functions(tcfg, torch.float64, device="cpu")
    tl, tlogs = fns.run(draws, EPISODES, learner=ppo_learner_from_numpy(
        learner_dict(draws.jax_learner())))
    np.testing.assert_allclose(tlogs["mean_sum_reward"],
                               np.asarray(jlogs["mean_sum_reward"]), rtol=0,
                               atol=1e-12)
    for k in ("loss", "actor_loss", "critic_loss", "entropy"):
        np.testing.assert_allclose(tlogs[k], np.asarray(jlogs[k]), rtol=0,
                                   atol=1e-10, err_msg=k)
    want = learner_dict(jl)
    for name, p in tl.params.named_parameters():
        g, k = name.split(".")
        np.testing.assert_allclose(p.detach().numpy(), want["params"][g][k],
                                   rtol=0, atol=1e-9, err_msg=name)
        st = tl.opt.state[p]
        np.testing.assert_allclose(st["exp_avg"].numpy(), want["mu"][g][k],
                                   rtol=0, atol=1e-9, err_msg=name)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(),
                                   want["nu"][g][k], rtol=0, atol=1e-9,
                                   err_msg=name)
        assert int(st["step"]) == want["count"]
    for name, p in tl.old_params.named_parameters():
        g, k = name.split(".")
        np.testing.assert_allclose(p.numpy(), want["old_params"][g][k],
                                   rtol=0, atol=1e-9, err_msg=name)


def test_lanes_episode_float32(monkeypatch):
    calls = []

    def spy(*a, **k):
        calls.append(a[2])
        return K7.lanes_histogram(*a, **k)

    monkeypatch.setattr(tenv, "lanes_histogram", spy)
    jcfg, tcfg = (cut(load(CONFIG), "lanes") for load in (jload, tload))
    draws = JaxPPODraws(jcfg, jnp.float32)
    jout, _ = jax_episode0(jcfg, draws)
    traj, _ = _rollout0(tcfg, torch.float32, draws)
    for i, (x, a, _) in enumerate(jout):
        assert x.dtype == np.float32
        np.testing.assert_array_equal(traj["x"][i].numpy(), x, err_msg=str(i))
        np.testing.assert_array_equal(traj["actions"][i].numpy(),
                                      a.reshape(-1), err_msg=str(i))
    assert calls == [6] * (1 + jcfg.episode_interval)
    # the piggy histogram lanes of the state vectors are filled
    assert np.abs(jout[-1][0][:, -1, 5:]).sum() > 0


def test_train_ppo_verb():
    out = subprocess.run(
        [sys.executable, "-m", "diral_tpu_torch", "train-ppo", CONFIG,
         "--episodes", "2", "--num-envs", "2", "--device", "cpu"], cwd=ROOT,
        capture_output=True, text=True, timeout=300, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(res) == {"episodes", "mean_sum_reward_first100",
                        "mean_sum_reward_last100"}
    assert res["episodes"] == 2
