"""The whole serving slice, float64 on the CPU: the port's greedy DRQN
rollout (train/evaluate._rollout_metrics with the DRQN actor) against the
JAX package's, from the same injected env state, zero history and the
same parameters (carried across by convert.py).  The four metrics must
agree to 1e-12 and the greedy actions of every step must be identical."""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diral_tpu.agents import policies as jpol
from diral_tpu.config import load_config as j_load_config
from diral_tpu.envs import v2v_env as jenv
from diral_tpu.models import qnets as jq
from diral_tpu.train import evaluate as jeval
from diral_tpu_torch.config import load_config as t_load_config
from diral_tpu_torch.convert import drqn_params_from_numpy
from diral_tpu_torch.envs import v2v_env as tenv
from diral_tpu_torch.models import qnets as tq
from diral_tpu_torch.train import evaluate as teval

CONFIGS = os.path.join(os.path.dirname(__file__), os.pardir, "configs")
STEPS = 30


def _cfg(load, name, num_envs, **env_over):
    cfg = load(os.path.join(CONFIGS, name))
    env = dataclasses.replace(cfg.env, step_impl="xla", **env_over)
    env = dataclasses.replace(env, state=dataclasses.replace(
        env.state, hist_impl="xla"))
    net = dataclasses.replace(cfg.agent.network, lstm_impl="xla",
                              layers=(32, 32))
    return dataclasses.replace(
        cfg, env=env,
        agent=dataclasses.replace(cfg.agent, network=net),
        engine=dataclasses.replace(cfg.engine, num_envs=num_envs))


def run_both(name, num_envs, **env_over):
    jcfg = _cfg(j_load_config, name, num_envs, **env_over)
    tcfg = _cfg(t_load_config, name, num_envs, **env_over)
    env = jcfg.env
    B, N, D, T = num_envs, env.num_users, env.state_space, jcfg.agent.step_size
    rng = np.random.RandomState(N)
    topo = (rng.randint(0, env.highway_length, (B, N)).astype(np.float64),
            np.zeros((B, N)), rng.uniform(1.1, 2.7, (B, N)), np.ones((B, N)))

    jparams = jq.drqn_init(jax.random.PRNGKey(3), D, env.num_channels,
                           jcfg.agent, jnp.float64)
    net = tq.drqn_init(torch.Generator().manual_seed(0), D, env.num_channels,
                       tcfg.agent, torch.float64)
    net.load_state_dict(drqn_params_from_numpy(
        jax.tree.map(np.asarray, jparams)))

    j_actions, t_actions = [], []

    def j_act(actor, env_state, history, k, t):
        x = jnp.transpose(history, (0, 2, 1, 3)).reshape(B * N, T, D)
        q = jq.drqn_apply(jparams, x, jcfg.agent).reshape(B, N, -1)
        a = jpol.greedy_action(q)
        jax.debug.callback(lambda v: j_actions.append(np.asarray(v)), a,
                           ordered=True)
        return a, actor

    js = jax.vmap(lambda x, y, v, d: jenv.reset_from(
        env, x, y, v, d, dtype=jnp.float64))(*(jnp.asarray(a) for a in topo))
    jm = jax.jit(lambda c: jeval._rollout_metrics(jcfg, j_act, c, STEPS))(
        (js, jnp.zeros((B, T, N, D), jnp.float64), (), jax.random.PRNGKey(0)))
    jm = {k: float(v) for k, v in jm.items()}

    t_inner = teval.drqn_act_fn(tcfg, net)

    def t_act(actor, env_state, history, gen, t):
        a, actor = t_inner(actor, env_state, history, gen, t)
        t_actions.append(a.numpy().copy())
        return a, actor

    ts = tenv.reset_from(tcfg.env, *topo, dtype=torch.float64)
    with torch.no_grad():
        tm = teval._rollout_metrics(
            tcfg, t_act, (ts, torch.zeros((B, T, N, D), dtype=torch.float64),
                          (), torch.Generator()), STEPS)
    return jm, tm, j_actions, t_actions


@pytest.mark.parametrize("name,num_envs,env_over", [
    ("toy_4ue_3r.yaml", 4, {}),
    # the 100v/50r config cut to N=16, C=10 (its 50 bins and channel step)
    ("scale_100v_50r.yaml", 2, {"num_users": 16, "num_channels": 10}),
])
def test_greedy_rollout_matches_jax(name, num_envs, env_over):
    jm, tm, ja, ta = run_both(name, num_envs, **env_over)
    assert set(jm) == set(tm)
    for k in jm:
        assert abs(jm[k] - tm[k]) <= 1e-12, (k, jm[k], tm[k])
    assert len(ja) == len(ta) == STEPS
    for t, (a, b) in enumerate(zip(ja, ta)):
        np.testing.assert_array_equal(b, a, err_msg=f"actions at step {t}")
    # a greedy policy that never moves would make the check vacuous
    assert len({tuple(a.ravel()) for a in ta}) > 1
