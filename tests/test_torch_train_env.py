"""The training slice's env additions and exploration policies: the port
against the JAX package in float64 on the CPU, with the JAX package's
random draws injected into the port's pure functions.

* (g) ``step_design``, ``update_velocity`` (injected kicks),
  ``information_age``, ``ia_penalty`` and recorded-trace replay:
  bit-exact for (N, C) in {(4, 3), (12, 5), (20, 15)}.
* (h) eps-greedy update and action, ``driver_mode_actions``, the softmax
  temperature schedule and action, Boltzmann update and action: equal
  schedules and identical actions on the same draws.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diral_tpu.agents import policies as jpol
from diral_tpu.config import toy_4ue_3r
from diral_tpu.envs import v2v_env as jenv
from diral_tpu_torch.agents import policies as tpol
from diral_tpu_torch.config import toy_4ue_3r as t_toy_4ue_3r
from diral_tpu_torch.envs import v2v_env as tenv

B = 3
FIELDS = ("pos_x", "pos_y", "vel", "direction", "table_x", "table_y",
          "table_seq", "table_age", "last_arrival", "prev_obs", "pf_counter")
SIZES = [(4, 3), (12, 5), (20, 15)]


def _cfgs(n, c, **env_over):
    def make(toy):
        env = dataclasses.replace(toy().env, num_users=n, num_channels=c,
                                  highway_length=25 * n,
                                  communication_range=60.0, step_impl="xla",
                                  **env_over)
        return dataclasses.replace(env, state=dataclasses.replace(
            env.state, hist_impl="xla"))
    return make(toy_4ue_3r), make(t_toy_4ue_3r)


def _start(jcfg, tcfg, seed):
    """The same injected topology in both (y = 0: see test_torch_env)."""
    rng = np.random.RandomState(seed)
    n = jcfg.num_users
    topo = (rng.randint(0, jcfg.highway_length, (B, n)).astype(np.float64),
            np.zeros((B, n)), rng.uniform(1.1, 2.7, (B, n)),
            np.where(rng.rand(B, n) < 0.8, 1.0, -1.0))
    js = jax.vmap(lambda x, y, v, d: jenv.reset_from(
        jcfg, x, y, v, d, dtype=jnp.float64))(*(jnp.asarray(a) for a in topo))
    return js, tenv.reset_from(tcfg, *topo, dtype=torch.float64)


def _same_state(ts, js, msg):
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)),
                                      err_msg=f"{f} {msg}")


def _rollout(jcfg, tcfg, jfn, tfn, steps, seed, trace=None, check=None):
    js, ts = _start(jcfg, tcfg, seed)
    jt = None if trace is None else jnp.asarray(trace)
    tt = None if trace is None else torch.from_numpy(trace)
    jstep = jax.jit(jax.vmap(lambda s, a, t: jfn(jcfg, s, a, t, trace=jt),
                             in_axes=(0, 0, None)))
    rng = np.random.RandomState(seed + 1)
    for t in range(steps):
        acts = rng.randint(0, jcfg.num_channels, (B, jcfg.num_users))
        js, jobs, jrew = jstep(js, jnp.asarray(acts, jnp.int32), t)
        ts, tobs, trew = tfn(tcfg, ts, torch.from_numpy(acts), t, trace=tt)
        msg = f"n={jcfg.num_users} c={jcfg.num_channels} t={t}"
        np.testing.assert_array_equal(tobs.numpy(), np.asarray(jobs), msg)
        np.testing.assert_array_equal(trew.numpy(), np.asarray(jrew), msg)
        _same_state(ts, js, msg)
        if check is not None:
            check(js, ts, t)
    return js, ts


@pytest.mark.parametrize("n,c", SIZES)
def test_step_design_bitexact(n, c):
    jc, tc = _cfgs(n, c)
    _rollout(jc, tc, jenv.step_design, tenv.step_design, 20, 7 * n + c)


@pytest.mark.parametrize("n,c", SIZES)
def test_information_age_and_penalty(n, c):
    """After channel steps (which stamp packet arrivals): the age
    histogram and its weighted penalty, every slot."""
    jc, tc = _cfgs(n, c)

    def check(js, ts, t):
        jh = jax.vmap(jenv.information_age, in_axes=(0, None))(js, t)
        th = tenv.information_age(ts, t)
        assert th.dtype == torch.int32
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
        jp = jenv.ia_penalty(jh)
        tp = tenv.ia_penalty(th)
        assert tp.dtype == torch.float32
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))

    js, ts = _rollout(jc, tc, jenv.step_channel, tenv.step_channel, 12,
                      11 * n + c, check=check)
    assert (ts.last_arrival >= 0).any()


@pytest.mark.parametrize("n,c", SIZES)
def test_update_velocity_with_injected_kicks(n, c):
    jc, tc = _cfgs(n, c, mobility_vary=True)
    js, ts = _start(jc, tc, 3 * n)
    for e in range(6):
        keys = jax.random.split(jax.random.PRNGKey(e), B)
        kicks = jax.vmap(lambda k: jax.random.randint(k, (n,), 1, 4))(keys)
        js = jax.vmap(lambda s, k: jenv.update_velocity(jc, s, k))(js, keys)
        ts = tenv.update_velocity(tc, ts, torch.from_numpy(np.array(kicks)))
        np.testing.assert_array_equal(ts.vel.numpy(), np.asarray(js.vel))
    # without mobility_vary the kicks do nothing
    jc0, tc0 = _cfgs(n, c)
    assert tenv.update_velocity(tc0, ts, torch.ones((B, n))) is ts


@pytest.mark.parametrize("n,c", SIZES)
def test_trace_replay(n, c):
    """Recorded x positions replace the mobility advance, row t % T_rec,
    truncated to N users, in every step flavour."""
    jc, tc = _cfgs(n, c)
    trace = np.random.RandomState(n).uniform(0, jc.highway_length,
                                             (5, n + 2))

    def check(js, ts, t):
        np.testing.assert_array_equal(ts.pos_x.numpy(),
                                      np.broadcast_to(trace[t % 5, :n],
                                                      (B, n)))

    for jfn, tfn in ((jenv.step_collision, tenv.step_collision),
                     (jenv.step_design, tenv.step_design),
                     (jenv.step_channel, tenv.step_channel)):
        _rollout(jc, tc, jfn, tfn, 7, 5 * n, trace=trace, check=check)


# ---------------------------------------------------------------------------
# Policies
# ---------------------------------------------------------------------------


def _q(shape, seed):
    return np.random.RandomState(seed).normal(size=shape)


def test_eps_greedy_update_schedule():
    js, ts = jpol.eps_greedy_init(0.99), tpol.eps_greedy_init(0.99)
    for episode in [0, 1, 1, 2, 5, 5, 6] + list(range(7, 400)):
        js = jpol.eps_greedy_update(js, jnp.asarray(episode, jnp.int32),
                                    0.9992 if episode < 50 else 0.9, 0.001)
        ts = tpol.eps_greedy_update(ts, episode,
                                    0.9992 if episode < 50 else 0.9, 0.001)
        assert isinstance(ts.eps, np.float32)
        assert ts.eps == np.float32(js.eps) and ts.episode == int(js.episode)
    assert ts.eps == np.float32(0.001)


@pytest.mark.parametrize("eps", [0.0, 0.37, 1.0])
def test_eps_greedy_action_with_injected_draws(eps):
    n, a = 64, 5
    q = _q((n, a), 1)
    for s in range(4):
        key = jax.random.PRNGKey(s)
        want = jpol.eps_greedy_action(key, jnp.asarray(q),
                                      jnp.asarray(eps, jnp.float32))
        kd, kr = jax.random.split(key)
        draw = np.array(jax.random.uniform(kd, (n,)))
        rand = np.array(jax.random.randint(kr, (n,), 0, a))
        got = tpol.eps_greedy_action_pure(
            torch.from_numpy(q), np.float32(eps), torch.from_numpy(draw),
            torch.from_numpy(rand))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("t", [3, 50, 500])
def test_driver_mode_actions_with_injected_draws(t):
    n, a = 32, 4
    q = _q((n, a), 2)
    key = jax.random.PRNGKey(t)
    jstate = jpol.eps_greedy_init(0.5)
    want = jpol.driver_mode_actions(key, jnp.asarray(q), jstate, t, 10, 100)
    ke, kp = jax.random.split(key)
    kd, kr = jax.random.split(kp)
    draws = [np.array(jax.random.randint(ke, (n,), 0, a)),
             np.array(jax.random.uniform(kd, (n,))),
             np.array(jax.random.randint(kr, (n,), 0, a))]
    got = tpol.driver_mode_actions_pure(
        torch.from_numpy(q), tpol.eps_greedy_init(0.5), t, 10, 100,
        *(torch.from_numpy(d) for d in draws))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_softmax_schedule_and_action():
    sched_j = jpol.softmax_temperature_schedule(0.05, 30)
    sched_t = tpol.softmax_temperature_schedule(0.05, 30)
    np.testing.assert_array_equal(sched_t, sched_j)
    n, a = 48, 5
    q = _q((n, a), 3)
    for episode in (0, 7, 29, 30, 45):
        key = jax.random.PRNGKey(episode)
        want, wt = jpol.softmax_action(key, jnp.asarray(q),
                                       jnp.asarray(sched_j), episode, 0.05)
        gumbel = np.array(jax.random.gumbel(key, (n, a), jnp.float64))
        temp = tpol.softmax_temperature(sched_t, episode, 0.05)
        assert temp == float(wt)
        got = tpol.softmax_action_pure(torch.from_numpy(q), temp,
                                       torch.from_numpy(gumbel))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_boltzman_update_and_action():
    js, ts = jpol.boltzman_init(1.0), tpol.boltzman_init(1.0)
    n, a = 40, 4
    q = _q((n, a), 4)
    kw = dict(explore_start=0.99, explore_stop=0.001, decay_rate=0.001,
              alpha=0.3)
    for t in range(0, 5200, 37):
        js = jpol.boltzman_update(js, t)
        ts = tpol.boltzman_update(ts, t)
        assert ts.beta == np.float32(js.beta)
        key = jax.random.PRNGKey(t)
        want = jpol.boltzman_action(key, jnp.asarray(q), js, t, **kw)
        kd, kr = jax.random.split(key)
        got = tpol.boltzman_action_pure(
            torch.from_numpy(q), ts, t,
            torch.from_numpy(np.array(jax.random.uniform(kd, (n,)))),
            torch.from_numpy(np.array(jax.random.randint(kr, (n,), 0, a))),
            **kw)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
