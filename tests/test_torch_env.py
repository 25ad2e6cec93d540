"""Env parity: the PyTorch port's batched env (diral_tpu_torch.envs.v2v_env)
against the JAX package's (diral_tpu.envs.v2v_env) in float64 on the CPU.

Both get the same injected topologies (numpy seed) and the same action
streams; the JAX side runs its canonical paths (step_impl="xla",
hist_impl="xla") vmapped over a batch of 3 envs.  Observations, rewards,
every state table and the assembled state vectors must be bit-identical,
except where a documented float op differs (stated per test)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diral_tpu.config import toy_4ue_3r
from diral_tpu.envs import v2v_env as jenv
from diral_tpu_torch.config import toy_4ue_3r as t_toy_4ue_3r
from diral_tpu_torch.envs import v2v_env as tenv

B = 3
FIELDS = ("pos_x", "pos_y", "vel", "direction", "table_x", "table_y",
          "table_seq", "table_age", "last_arrival", "prev_obs", "pf_counter")


def _cfgs(n, c, **env_over):
    """The same env config in both packages' dataclasses."""
    def make(toy):
        base = toy().env
        return dataclasses.replace(base, num_users=n, num_channels=c,
                                   highway_length=25 * n,
                                   communication_range=60.0,
                                   **{"step_impl": "xla", **env_over})
    jc, tc = make(toy_4ue_3r), make(t_toy_4ue_3r)
    jc = dataclasses.replace(jc, state=dataclasses.replace(jc.state,
                                                           hist_impl="xla"))
    tc = dataclasses.replace(tc, state=dataclasses.replace(tc.state,
                                                           hist_impl="xla"))
    return jc, tc


def _with_state(cfgs, **state_over):
    return tuple(dataclasses.replace(c, state=dataclasses.replace(
        c.state, **state_over)) for c in cfgs)


def _topology(cfg, seed):
    """Integer x, y = 0 (highway_height 2 gives y in [0, 1)), as reset
    draws them.  A nonzero dy is left out on purpose: XLA's CPU compiler
    contracts ``dx*dx + dy*dy`` into a fused multiply-add, which the
    reference (and the port) round as two operations."""
    rng = np.random.RandomState(seed)
    n = cfg.num_users
    return (rng.randint(0, cfg.highway_length, (B, n)).astype(np.float64),
            np.zeros((B, n)),
            rng.uniform(1.1, 2.7, (B, n)),
            np.where(rng.rand(B, n) < 0.8, 1.0, -1.0))


def rollout_compare(jcfg, tcfg, flavor, steps, seed, obs_atol=0.0,
                    state_atol=0.0):
    topo = _topology(jcfg, seed)
    js = jax.vmap(lambda x, y, v, d: jenv.reset_from(
        jcfg, x, y, v, d, dtype=jnp.float64))(*(jnp.asarray(a) for a in topo))
    ts = tenv.reset_from(tcfg, *topo, dtype=torch.float64)
    jstep_fn = {"collision": jenv.step_collision,
                "channel": jenv.step_channel}[flavor]
    tstep_fn = {"collision": tenv.step_collision,
                "channel": tenv.step_channel}[flavor]
    jstep = jax.jit(jax.vmap(lambda s, a, t: jstep_fn(jcfg, s, a, t),
                             in_axes=(0, 0, None)))
    jobtain = jax.jit(jax.vmap(lambda s, o, a, r: jenv.obtain_state(
        jcfg, s, o, a, r, 3, 0.5)))
    rng = np.random.RandomState(seed + 1)
    for t in range(steps):
        acts = rng.randint(0, jcfg.num_channels, (B, jcfg.num_users))
        js, jobs, jrew = jstep(js, jnp.asarray(acts, jnp.int32), t)
        ts, tobs, trew = tstep_fn(tcfg, ts, torch.from_numpy(acts), t)
        msg = f"{flavor} n={jcfg.num_users} c={jcfg.num_channels} t={t}"
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), rtol=0,
                                   atol=obs_atol, err_msg="obs " + msg)
        np.testing.assert_allclose(trew.numpy(), np.asarray(jrew), rtol=0,
                                   atol=obs_atol, err_msg="rew " + msg)
        for f in FIELDS:
            np.testing.assert_array_equal(
                getattr(ts, f).numpy(), np.asarray(getattr(js, f)),
                err_msg=f"{f} {msg}")
        jsv = jobtain(js, jobs, jnp.asarray(acts, jnp.int32), jrew)
        tsv = tenv.obtain_state(tcfg, ts, tobs, torch.from_numpy(acts), trew,
                                3, 0.5)
        assert tsv.shape == (B, jcfg.num_users, jcfg.state_space)
        np.testing.assert_allclose(tsv.numpy(), np.asarray(jsv), rtol=0,
                                   atol=state_atol, err_msg="state " + msg)


@pytest.mark.parametrize("n,c", [(4, 3), (12, 5), (20, 15)])
@pytest.mark.parametrize("flavor", ["collision", "channel"])
def test_env_bitexact_f64(n, c, flavor):
    """Default toy toggles (type-2 piggy histogram, one-hot action), reward
    design 2; C = 15 exercises the JAX package's scanned channel walk."""
    jc, tc = _cfgs(n, c)
    rollout_compare(jc, tc, flavor, steps=25, seed=100 * n + c)


@pytest.mark.parametrize("design", [3, 4])
def test_channel_designs_exp(design):
    """Designs 3/4 go through exp(): XLA's and PyTorch's float64 exp may
    differ in the last bit, so rewards allow 1e-15 (as
    tests/test_env_parity.py does for the oracle); tables stay exact."""
    jc, tc = _cfgs(12, 5, reward_design=design)
    rollout_compare(jc, tc, "channel", steps=20, seed=7 + design,
                    obs_atol=1e-15, state_atol=0.0)


@pytest.mark.parametrize("design", [1, 3, 4, 5])
def test_collision_designs(design):
    jc, tc = _cfgs(8, 4, reward_design=design, congestion_test=False)
    tol = 1e-15 if design == 3 else 0.0  # design 3 goes through exp()
    rollout_compare(jc, tc, "collision", steps=20, seed=30 + design,
                    obs_atol=tol, state_atol=tol)


def test_all_state_toggles():
    """Every obtain_state toggle at once except piggybacking.  add_position
    divides by a constant, which XLA turns into a multiply by its
    reciprocal (1 ULP, as in tests/test_env_parity.py)."""
    cfgs = _cfgs(6, 4, enable_fingerprint=True, proportional_fair=True)
    cfgs = _with_state(cfgs, add_reward=True, add_index=True,
                       add_velocity=True, add_position=True,
                       add_channel_obs=True, add_positional_dist=True)
    rollout_compare(*cfgs, "collision", steps=25, seed=11, state_atol=1e-15)


def test_state_type_1_real_action():
    cfgs = _with_state(_cfgs(6, 4), type=1, action_index="real",
                       add_channel_obs=True)
    rollout_compare(*cfgs, "collision", steps=20, seed=12)


def test_type1_histogram():
    """Type-1 weighted histogram: float sums in another order, 1e-12."""
    cfgs = _with_state(_cfgs(6, 4), add_positional_dist_type=1)
    rollout_compare(*cfgs, "collision", steps=20, seed=13, state_atol=1e-12)


@pytest.mark.parametrize("state_type", [1, 2])
def test_piggybacking_fixed_width(state_type):
    cfgs = _with_state(_cfgs(6, 4), piggybacking=True, add_channel_obs=True,
                       type=state_type)
    rollout_compare(*cfgs, "collision", steps=20, seed=14 + state_type)


def test_reset_distributions():
    """reset draws from a torch.Generator: integer x in [0, L), y in
    [0, H//2), speeds in [1.1, 2.7), everyone moving right; blank tables."""
    cfg = t_toy_4ue_3r().env
    gen = torch.Generator().manual_seed(0)
    s = tenv.reset(cfg, 64, gen, torch.float64, "cpu")
    assert s.pos_x.shape == (64, cfg.num_users)
    assert torch.equal(s.pos_x, s.pos_x.floor())
    assert 0 <= s.pos_x.min() and s.pos_x.max() < cfg.highway_length
    assert torch.all(s.pos_y == 0)  # highway_height 2 -> H//2 = 1
    assert 1.1 <= s.vel.min() and s.vel.max() < 2.7
    assert torch.all(s.direction == 1)
    assert torch.all(s.last_arrival == -1) and torch.all(s.table_seq == 0)


@pytest.mark.parametrize("impl,dtype,routed", [
    ("pallas", torch.float32, True),    # the kernel wrappers
    ("auto", torch.float32, False),     # CPU tensors: the canonical path
    ("xla", torch.float32, False),
    ("pallas", torch.float64, "float32-only"),
    ("bogus", torch.float32, "bad step_impl")])
def test_env_kernel_knobs(monkeypatch, impl, dtype, routed):
    """step_impl / hist_impl read as in the JAX package, at N = 40 (above
    the kernels' N >= 32 gate)."""
    _, tc = _cfgs(40, 5, step_impl=impl)
    tc = dataclasses.replace(tc, state=dataclasses.replace(
        tc.state, hist_impl="xla" if impl == "bogus" else impl))
    calls = []

    def spy(fn):
        def wrapped(*a, **k):
            calls.append(fn.__name__)
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(tenv, "channel_phase", spy(tenv.channel_phase))
    monkeypatch.setattr(tenv, "piggy_histogram", spy(tenv.piggy_histogram))
    s = tenv.reset(tc, 2, torch.Generator().manual_seed(0), dtype, "cpu")
    acts = torch.from_numpy(np.random.RandomState(0).randint(0, 5, (2, 40)))
    if isinstance(routed, str):
        with pytest.raises(ValueError, match=routed):
            tenv.step_channel(tc, s, acts, 0)
        return
    s, obs, rew = tenv.step_channel(tc, s, acts, 0)
    tenv.obtain_state(tc, s, obs, acts, rew)
    assert calls == (["channel_phase", "piggy_histogram"] if routed else [])
