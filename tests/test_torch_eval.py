"""The PPO and PS serving paths, float64 on the CPU: the port's greedy
actors (train/evaluate.ppo_act_fn, ps_act_fn) run through the port's
``_rollout_metrics`` against the actors the JAX package's
``evaluate_ppo`` / ``evaluate_ps`` build, run through its own, from the
same injected env state, zero history and first carry and the same
parameters (the JAX trees copied into ``ParamTree``s).  The four metrics
must agree to 1e-12 and the greedy actions of every step must be
identical: PPO with the LSTM and the feed-forward encoder, PS-DQN plain
and dueling, PS-DRQN with its GRU hidden carried from slot to slot.

The JAX actors are closures inside its entry points; the test takes each
one by swapping ``_rollout_metrics`` for a function that keeps it and
stops.  The compare functions are held to the JAX package's labels."""

import dataclasses
import os
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diral_tpu.agents import ps_drqn as jdrqn
from diral_tpu.config import load_config as jload
from diral_tpu.envs import v2v_env as jenv
from diral_tpu.models import actor_critic as jac
from diral_tpu.models import qnets as jq
from diral_tpu.train import evaluate as jeval
from diral_tpu_torch.config import load_config as tload
from diral_tpu_torch.envs import v2v_env as tenv
from diral_tpu_torch.models.qnets import ParamTree
from diral_tpu_torch.train import evaluate as teval

CONFIGS = os.path.join(os.path.dirname(__file__), os.pardir, "configs")
PPO_CONFIG, PS_CONFIG = "ppo_congested.yaml", "congested_6v_5r.yaml"
STEPS = 30


def _cfg(load, name, num_envs, use_lstm=True, dueling=False):
    cfg = load(os.path.join(CONFIGS, name))
    env = dataclasses.replace(cfg.env, step_impl="xla")
    env = dataclasses.replace(env, state=dataclasses.replace(
        env.state, hist_impl="xla"))
    net = dataclasses.replace(cfg.agent.network, lstm_impl="xla",
                              layers=(32, 32), use_lstm_input=use_lstm,
                              use_dueling=dueling)
    return dataclasses.replace(
        cfg, env=env, agent=dataclasses.replace(cfg.agent, network=net),
        engine=dataclasses.replace(cfg.engine, num_envs=num_envs))


def _tree(params) -> ParamTree:
    return ParamTree({g: {k: torch.from_numpy(np.array(v))
                          for k, v in leaves.items()}
                      for g, leaves in params.items()})


def _params(algo, jcfg, dtype):
    env = jcfg.env
    init = {"ppo": jac.ppo_init, "ps-dqn": jq.ps_dqn_init,
            "ps-drqn": jq.ps_drqn_init}[algo]
    return init(jax.random.PRNGKey(3), env.state_space, env.num_channels,
                jcfg.agent, dtype)


class _Captured(Exception):
    pass


def jax_actor(monkeypatch, algo, jcfg, jparams):
    """The act function JAX's evaluate_ppo / evaluate_ps builds."""
    got = {}

    def keep(cfg, act_fn, carry_init, steps):
        got["act"] = act_fn
        raise _Captured

    learner = SimpleNamespace(params=jparams)
    with monkeypatch.context() as m:
        m.setattr(jeval, "_rollout_metrics", keep)
        with pytest.raises(_Captured):
            if algo == "ppo":
                jeval.evaluate_ppo(jcfg, learner, jax.random.PRNGKey(0), 1,
                                   jnp.float64)
            else:
                jeval.evaluate_ps(jcfg, learner, jax.random.PRNGKey(0), 1,
                                  algo, jnp.float64)
    return got["act"]


def run_both(monkeypatch, algo, num_envs, **net):
    name = PPO_CONFIG if algo == "ppo" else PS_CONFIG
    jcfg = _cfg(jload, name, num_envs, **net)
    tcfg = _cfg(tload, name, num_envs, **net)
    env = jcfg.env
    B, N, D, T = num_envs, env.num_users, env.state_space, jcfg.agent.step_size
    rng = np.random.RandomState(N)
    topo = (rng.randint(0, env.highway_length, (B, N)).astype(np.float64),
            np.zeros((B, N)), rng.uniform(1.1, 2.7, (B, N)), np.ones((B, N)))
    jparams = _params(algo, jcfg, jnp.float64)
    tparams = _tree(jparams)

    j_act = jax_actor(monkeypatch, algo, jcfg, jparams)
    if algo == "ppo":
        t_act, t_actor0 = teval.ppo_act_fn(tcfg, tparams), ()
        j_actor0 = ()
    else:
        t_act, t_actor0 = teval.ps_act_fn(tcfg, tparams, algo, torch.float64,
                                          "cpu")
        j_actor0 = (jdrqn.init_hidden(jcfg.agent, B * N, jnp.float64)
                    if algo == "ps-drqn" else ())
    assert (torch.equal(t_actor0, torch.from_numpy(np.array(j_actor0)))
            if algo == "ps-drqn" else t_actor0 == ())

    # actions and, for PS-DRQN, the carried GRU hidden after every step
    j_seen, t_seen = {"a": [], "h": []}, {"a": [], "h": []}

    def j_rec(actor, env_state, history, k, t):
        a, actor = j_act(actor, env_state, history, k, t)
        jax.debug.callback(lambda v: j_seen["a"].append(np.asarray(v)), a,
                           ordered=True)
        if algo == "ps-drqn":
            jax.debug.callback(lambda v: j_seen["h"].append(np.asarray(v)),
                               actor, ordered=True)
        return a, actor

    js = jax.vmap(lambda x, y, v, d: jenv.reset_from(
        env, x, y, v, d, dtype=jnp.float64))(*(jnp.asarray(a) for a in topo))
    jm = jax.jit(lambda c: jeval._rollout_metrics(jcfg, j_rec, c, STEPS))(
        (js, jnp.zeros((B, T, N, D), jnp.float64), j_actor0,
         jax.random.PRNGKey(0)))
    jm = {k: float(v) for k, v in jm.items()}

    def t_rec(actor, env_state, history, gen, t):
        a, actor = t_act(actor, env_state, history, gen, t)
        t_seen["a"].append(a.numpy().copy())
        if algo == "ps-drqn":
            t_seen["h"].append(actor.numpy().copy())
        return a, actor

    ts = tenv.reset_from(tcfg.env, *topo, dtype=torch.float64)
    with torch.no_grad():
        tm = teval._rollout_metrics(
            tcfg, t_rec, (ts, torch.zeros((B, T, N, D), dtype=torch.float64),
                          t_actor0, torch.Generator()), STEPS)
    return jm, tm, j_seen, t_seen


@pytest.mark.parametrize("algo,net", [
    ("ppo", {"use_lstm": True}),
    ("ppo", {"use_lstm": False}),
    ("ps-dqn", {}),
    ("ps-dqn", {"dueling": True}),
    ("ps-drqn", {"dueling": True}),
])
def test_greedy_rollout_matches_jax(monkeypatch, algo, net):
    jm, tm, js, ts = run_both(monkeypatch, algo, 3, **net)
    assert set(jm) == set(tm)
    for k in jm:
        assert abs(jm[k] - tm[k]) <= 1e-12, (k, jm[k], tm[k])
    assert len(js["a"]) == len(ts["a"]) == STEPS
    for t, (a, b) in enumerate(zip(js["a"], ts["a"])):
        np.testing.assert_array_equal(b, a, err_msg=f"actions at step {t}")
    # a greedy policy that never moves would make the check vacuous
    assert len({tuple(a.ravel()) for a in ts["a"]}) > 1
    assert len(js["h"]) == len(ts["h"]) == (STEPS if algo == "ps-drqn" else 0)
    for t, (a, b) in enumerate(zip(js["h"], ts["h"])):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-12,
                                   err_msg=f"GRU hidden after step {t}")
    if ts["h"]:   # the hidden moves from slot to slot
        assert np.abs(ts["h"][-1] - ts["h"][-2]).max() > 1e-3


def test_evaluate_ps_rejects_an_unknown_algorithm():
    tcfg = _cfg(tload, PS_CONFIG, 1)
    for call in (teval.evaluate_ps, teval.compare_ps_vs_sps):
        with pytest.raises(ValueError, match="unknown PS algorithm"):
            call(tcfg, None, 0, steps=1, algo="ps-dq", device="cpu")


@pytest.mark.parametrize("algo", ["ppo", "ps-dqn", "PS_DRQN"])
def test_compare_vs_sps_labels_match_jax(algo):
    """The comparison's keys are JAX's, its improvement is the PRR ratio
    minus one, and one seed gives one result."""
    kind = "ppo" if algo == "ppo" else algo.lower().replace("_", "-")
    name = PPO_CONFIG if kind == "ppo" else PS_CONFIG
    jcfg, tcfg = (_cfg(load, name, 1, use_lstm=False) for load in (jload,
                                                                   tload))
    jparams = _params(kind, jcfg, jnp.float32)
    learner = SimpleNamespace(params=jparams)
    if kind == "ppo":
        jres = jeval.compare_ppo_vs_sps(jcfg, learner, jax.random.PRNGKey(0),
                                        2)
        run = lambda: teval.compare_ppo_vs_sps(  # noqa: E731
            tcfg, _tree(jparams), 5, steps=2, device="cpu")
    else:
        jres = jeval.compare_ps_vs_sps(jcfg, learner, jax.random.PRNGKey(0),
                                       2, algo=algo)
        run = lambda: teval.compare_ps_vs_sps(  # noqa: E731
            tcfg, _tree(jparams), 5, steps=2, algo=algo, device="cpu")
    tres = run()
    assert set(tres) == set(jres)
    label = next(k for k in tres if k not in ("sps", "prr_improvement"))
    for k in (label, "sps"):
        assert set(tres[k]) == set(jres[k])
    assert tres["prr_improvement"] == (
        tres[label]["mean_prr"] / max(tres["sps"]["mean_prr"], 1e-9) - 1.0)
    assert run() == tres
