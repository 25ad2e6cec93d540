"""The greedy evaluation of the feedforward DRQN flavor
(configs/toy_4ue_3r_mlp.yaml, ``use_lstm_input: False``), float64 on the
CPU, against the JAX package's.

JAX's ``evaluate_drqn`` (evaluate.py:115-118) gives every net the whole
[T, D] history window.  The MLP maps each of the T steps to C Q-values,
so the greedy argmax runs over T * C ids, and an id >= C reaches the env
and the metrics: ``jax.nn.one_hot`` gives it a zero row (no
transmission), ``prr_per_user`` credits it on no channel, and the
colliding-user count's ``bincount`` drops it while its gather clamps it
to C - 1.  The port's actor is held to JAX's, step for step from the same
start state and parameters: identical actions (ids >= C among them) and
the four metrics within 1e-12.  The env steps and the state assembly are
held bit for bit on action streams that carry such ids."""

import dataclasses
import os
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diral_tpu.config import load_config as jload
from diral_tpu.envs import v2v_env as jenv
from diral_tpu.models import qnets as jq
from diral_tpu.train import evaluate as jeval
from diral_tpu_torch.config import load_config as tload
from diral_tpu_torch.envs import v2v_env as tenv
from diral_tpu_torch.models.qnets import ParamTree
from diral_tpu_torch.train import evaluate as teval
from test_torch_env import FIELDS, _cfgs, _topology

CONFIG = os.path.join(os.path.dirname(__file__), os.pardir, "configs",
                      "toy_4ue_3r_mlp.yaml")
B, STEPS = 3, 40


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(load):
    cfg = load(CONFIG)
    net = dataclasses.replace(cfg.agent.network, layers=(32, 32))
    return dataclasses.replace(
        cfg, agent=dataclasses.replace(cfg.agent, network=net),
        engine=dataclasses.replace(cfg.engine, num_envs=B))


class _Captured(Exception):
    pass


def jax_drqn_actor(monkeypatch, jcfg, jparams):
    """The act function JAX's evaluate_drqn builds."""
    got = {}

    def keep(cfg, act_fn, carry_init, steps):
        got["act"] = act_fn
        raise _Captured

    with monkeypatch.context() as m:
        m.setattr(jeval, "_rollout_metrics", keep)
        with pytest.raises(_Captured):
            jeval.evaluate_drqn(jcfg, SimpleNamespace(params=jparams),
                                jax.random.PRNGKey(0), 1, jnp.float64)
    return got["act"]


def test_mlp_window_eval_matches_jax(monkeypatch):
    jcfg, tcfg = _cfg(jload), _cfg(tload)
    env, acfg = jcfg.env, jcfg.agent
    assert not acfg.network.use_lstm_input
    N, C, D, T = env.num_users, env.num_channels, env.state_space, \
        acfg.step_size
    jparams = jq.drqn_init(jax.random.PRNGKey(5), D, C, acfg, jnp.float64)
    tparams = ParamTree({g: {k: torch.from_numpy(np.array(v))
                             for k, v in leaves.items()}
                         for g, leaves in jparams.items()})
    rng = np.random.RandomState(9)
    topo = (rng.randint(0, env.highway_length, (B, N)).astype(np.float64),
            np.zeros((B, N)), rng.uniform(1.1, 2.7, (B, N)), np.ones((B, N)))

    j_act = jax_drqn_actor(monkeypatch, jcfg, jparams)
    j_seen, t_seen = [], []

    def j_rec(actor, env_state, history, k, t):
        a, actor = j_act(actor, env_state, history, k, t)
        jax.debug.callback(lambda v: j_seen.append(np.asarray(v)), a,
                           ordered=True)
        return a, actor

    js = jax.vmap(lambda x, y, v, d: jenv.reset_from(
        env, x, y, v, d, dtype=jnp.float64))(*(jnp.asarray(a) for a in topo))
    jm = jax.jit(lambda c: jeval._rollout_metrics(jcfg, j_rec, c, STEPS))(
        (js, jnp.zeros((B, T, N, D), jnp.float64), (),
         jax.random.PRNGKey(0)))

    t_act = teval.drqn_act_fn(tcfg, tparams)

    def t_rec(actor, env_state, history, gen, t):
        a, actor = t_act(actor, env_state, history, gen, t)
        t_seen.append(a.numpy().copy())
        return a, actor

    ts = tenv.reset_from(tcfg.env, *topo, dtype=torch.float64)
    with torch.no_grad():
        tm = teval._rollout_metrics(
            tcfg, t_rec, (ts, torch.zeros((B, T, N, D), dtype=torch.float64),
                          (), torch.Generator()), STEPS)

    assert set(tm) == set(jm)
    for k in jm:
        assert abs(float(jm[k]) - tm[k]) <= 1e-12, (k, float(jm[k]), tm[k])
    assert len(j_seen) == len(t_seen) == STEPS
    for t, (a, b) in enumerate(zip(j_seen, t_seen)):
        np.testing.assert_array_equal(b, a, err_msg=f"actions at step {t}")
    actions = np.stack(t_seen)
    # the check reaches both kinds of id, and the policy moves
    assert actions.max() < T * C
    assert (actions >= C).any() and (actions < C).any()
    assert len({tuple(a.ravel()) for a in t_seen}) > 1


@pytest.mark.parametrize("flavor", ["collision", "design", "channel"])
def test_ids_beyond_the_channels_match_jax_env(flavor):
    """Actions drawn from [0, 6C): the step, the state vector, the PRR and
    the DQN-era state assembly equal JAX's bit for bit."""
    jcfg, tcfg = _cfgs(8, 3)
    n, c = jcfg.num_users, jcfg.num_channels
    topo = _topology(jcfg, 11)
    js = jax.vmap(lambda x, y, v, d: jenv.reset_from(
        jcfg, x, y, v, d, dtype=jnp.float64))(*(jnp.asarray(a) for a in topo))
    ts = tenv.reset_from(tcfg, *topo, dtype=torch.float64)
    jfn = getattr(jenv, f"step_{flavor}")
    tfn = getattr(tenv, f"step_{flavor}")
    jstep = jax.jit(jax.vmap(lambda s, a, t: jfn(jcfg, s, a, t),
                             in_axes=(0, 0, None)))
    jobtain = jax.jit(jax.vmap(lambda s, o, a, r: jenv.obtain_state(
        jcfg, s, o, a, r)))
    jprr = jax.jit(jax.vmap(lambda s, a: jeval.prr_per_user(jcfg, s, a)))
    jgen = jax.jit(jax.vmap(lambda a, o: jenv.state_generator(jcfg, a, o)))
    rng = np.random.RandomState(12)
    beyond = 0
    for t in range(12):
        acts = rng.randint(0, 6 * c, (B, n))
        beyond += int((acts >= c).sum())
        ja, ta = jnp.asarray(acts, jnp.int32), torch.from_numpy(acts)
        msg = f"{flavor} t={t}"
        np.testing.assert_array_equal(
            teval.prr_per_user(tcfg, ts, ta).numpy(),
            np.asarray(jprr(js, ja)), err_msg="prr " + msg)
        js, jobs, jrew = jstep(js, ja, t)
        ts, tobs, trew = tfn(tcfg, ts, ta, t)
        np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs),
                                      err_msg="obs " + msg)
        np.testing.assert_array_equal(trew.numpy(), np.asarray(jrew),
                                      err_msg="rew " + msg)
        for f in FIELDS:
            np.testing.assert_array_equal(
                getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                err_msg=f"{f} {msg}")
        np.testing.assert_array_equal(
            tenv.obtain_state(tcfg, ts, tobs, ta, trew).numpy(),
            np.asarray(jobtain(js, jobs, ja, jrew)), err_msg="state " + msg)
        np.testing.assert_array_equal(
            tenv.state_generator(tcfg, ta, tobs).numpy(),
            np.asarray(jgen(ja, jobs)), err_msg="state_generator " + msg)
    assert beyond > 0


def test_mlp_compare_vs_sps_runs():
    """``compare_drqn_vs_sps`` on the MLP config runs the window actor on
    the CPU and returns JAX's keys."""
    jcfg, tcfg = _cfg(jload), _cfg(tload)
    env = jcfg.env
    jparams = jq.drqn_init(jax.random.PRNGKey(0), env.state_space,
                           env.num_channels, jcfg.agent, jnp.float32)
    jres = jeval.compare_drqn_vs_sps(jcfg, SimpleNamespace(params=jparams),
                                     jax.random.PRNGKey(0), 5)
    tparams = ParamTree({g: {k: torch.from_numpy(np.array(v))
                             for k, v in leaves.items()}
                         for g, leaves in jparams.items()})
    tres = teval.compare_drqn_vs_sps(tcfg, tparams, 1, steps=5, device="cpu")
    assert set(tres) == set(jres)
    for k in ("drqn", "sps"):
        assert set(tres[k]) == set(jres[k])
    assert 0.0 <= tres["drqn"]["mean_prr"] <= 1.0
    assert np.isfinite(tres["prr_improvement"])
