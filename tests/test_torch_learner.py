"""The learner, the replay ring and the window sampler: the port against
the JAX package on the CPU (dtypes explicit: tests/conftest.py turns on
x64).

* (e) ``train_on_windows`` / ``train_on_packed`` in float64 from the same
  params and Adam state (convert.learner_from_numpy): loss within 1e-12
  and updated params within 1e-10 -- optax.adam and torch.optim.Adam
  order their arithmetic differently, so the match is to a tolerance; the
  target-sync cadence (tests/test_learner.py:84); windows vs packed inside
  the port at tests/test_learner.py:408-414's tolerances.
* (f) FusedWindowReplay after S+pad+3 lockstep adds (wraparound and mirror
  pad): buf, ptr and count bit-equal to JAX, float64 and bf16 storage;
  the mantissa guard; ``sample_window_rows_many`` with JAX's scores
  injected returns JAX's rows bit for bit.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diral_tpu.agents import drqn as jdrqn
from diral_tpu.agents.replay import FusedWindowReplay as JReplay
from diral_tpu.config import toy_4ue_3r
from diral_tpu.ops.pallas_lstm import padded_dim
from diral_tpu.train import loop as jloop
from diral_tpu_torch.agents import drqn as tdrqn
from diral_tpu_torch.agents.replay import FusedWindowReplay as TReplay
from diral_tpu_torch.config import toy_4ue_3r as t_toy_4ue_3r
from diral_tpu_torch.convert import learner_from_numpy
from diral_tpu_torch.train import loop as tloop

D, A, N = 23, 3, 4


def _agent(cfg, impl="xla", layers=(32, 32), **kw):
    net = dataclasses.replace(cfg.agent.network, lstm_impl=impl,
                              layers=layers)
    return dataclasses.replace(cfg.agent, network=net, **kw)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def learner_dict(learner) -> dict:
    adam = learner.opt_state[0]
    return {"params": _np(learner.params),
            "target_params": _np(learner.target_params),
            "mu": _np(adam.mu), "nu": _np(adam.nu),
            "count": int(adam.count)}


def _rows(NB, T, dtype, seed):
    rng = np.random.RandomState(seed)
    Dp = padded_dim(D)
    x = rng.normal(size=(NB, T + 1, D)).astype(dtype)
    windows = np.zeros((NB, T + 1, Dp), dtype)
    windows[..., :D] = x
    windows = windows.reshape(NB, (T + 1) * Dp)
    actions = rng.randint(0, A, (NB, T))
    rewards = rng.normal(size=(NB, T)).astype(dtype)
    return windows, actions, rewards


_windows_step = jax.jit(jdrqn.train_on_windows, static_argnames=("cfg",))
_packed_step = jax.jit(jdrqn.train_on_packed, static_argnames=("cfg",))


def _jax_learner(acfg, dtype, seed=0):
    """A JAX learner one Adam step in, with a target that differs."""
    lrn = jdrqn.init_learner(jax.random.PRNGKey(seed), D, A, acfg, dtype)
    lrn = lrn.replace(target_params=jax.tree.map(
        lambda p: p * 0.9, lrn.target_params))
    w, a, r = _rows(16, acfg.step_size, np.dtype(dtype), seed + 100)
    lrn, _ = _windows_step(lrn, jnp.asarray(w), jnp.asarray(a),
                           jnp.asarray(r), cfg=acfg)
    return lrn


@pytest.mark.parametrize("path", ["windows", "packed"])
def test_learner_step_matches_jax_float64(path):
    acfg = _agent(toy_4ue_3r(), hysteretic=(path == "packed"))
    tcfg = _agent(t_toy_4ue_3r(), hysteretic=(path == "packed"))
    jl = _jax_learner(acfg, jnp.float64)
    tl = learner_from_numpy(learner_dict(jl), tcfg)
    T = acfg.step_size
    Dp = padded_dim(D)
    w, a, r = _rows(40, T, np.float64, 7)
    if path == "windows":
        jl2, jloss = _windows_step(jl, jnp.asarray(w), jnp.asarray(a),
                                   jnp.asarray(r), cfg=acfg)
        tloss = tdrqn.train_on_windows(tl, torch.from_numpy(w),
                                       torch.from_numpy(a),
                                       torch.from_numpy(r), tcfg)
    else:
        s, ns = w[:, :T * Dp], w[:, Dp:]
        jl2, jloss = _packed_step(jl, jnp.asarray(s), jnp.asarray(a),
                                  jnp.asarray(r), jnp.asarray(ns), cfg=acfg)
        tloss = tdrqn.train_on_packed(
            tl, torch.from_numpy(np.ascontiguousarray(s)),
            torch.from_numpy(a), torch.from_numpy(r),
            torch.from_numpy(np.ascontiguousarray(ns)), tcfg)
    assert abs(float(tloss) - float(jloss)) <= 1e-12
    got = tl.params.tree()
    for g, leaves in _np(jl2.params).items():
        for k, v in leaves.items():
            assert np.abs(got[g][k].detach().numpy() - v).max() <= 1e-10, (g, k)
    # the optimizer state moved the same way
    adam = jl2.opt_state[0]
    p = tl.params.lstm.w
    st = tl.opt.state[p]
    assert int(st["step"]) == int(adam.count)
    assert np.abs(st["exp_avg"].numpy() - np.asarray(adam.mu["lstm"]["w"])
                  ).max() <= 1e-12


def test_target_sync_cadence():
    """Target params copy only when (t+1) % target_update == 0
    (drl_drqn.py:263-265)."""
    tcfg = _agent(t_toy_4ue_3r(), n_batch=1, target_update=7)
    jl = _jax_learner(_agent(toy_4ue_3r()), jnp.float64)
    w, a, r = (torch.from_numpy(v)[None] for v in _rows(8, 6, np.float64, 3))
    rows = {"windows": w, "actions": a, "rewards": r}
    for t, synced in ((10, False), (tcfg.target_update - 1, True)):
        tl = learner_from_numpy(learner_dict(jl), tcfg)
        tdrqn.train(tl, rows, t, tcfg)
        same = all(torch.equal(p, q) for p, q in zip(
            tl.params.parameters(), tl.target_params.parameters()))
        assert same == synced, t


@pytest.mark.parametrize("impl,layers", [("xla", (32, 32)),
                                         ("pallas", (128, 32))])
def test_windows_matches_packed_in_port(impl, layers):
    tcfg = _agent(t_toy_4ue_3r(), impl=impl, layers=layers)
    jl = _jax_learner(_agent(toy_4ue_3r(), impl="xla", layers=layers),
                      jnp.float32, seed=4)
    T, Dp = tcfg.step_size, padded_dim(D)
    w, a, r = (torch.from_numpy(v) for v in _rows(48, T, np.float32, 9))
    l1 = learner_from_numpy(learner_dict(jl), tcfg)
    l2 = learner_from_numpy(learner_dict(jl), tcfg)
    loss1 = tdrqn.train_on_windows(l1, w, a, r, tcfg)
    loss2 = tdrqn.train_on_packed(l2, w[:, :T * Dp].contiguous(), a, r,
                                  w[:, Dp:].contiguous(), tcfg)
    np.testing.assert_allclose(float(loss1), float(loss2), rtol=1e-6,
                               atol=1e-7)
    for p, q in zip(l1.params.parameters(), l2.params.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# Replay and sampler
# ---------------------------------------------------------------------------

B, S, PAD = 2, 16, 6


def _fill(jdtype, tdtype, adds, seed=0):
    rng = np.random.RandomState(seed)
    jr = jax.vmap(lambda _: JReplay.create(S, N, D, jdtype, num_actions=A,
                                           pad=PAD))(jnp.arange(B))
    tr = TReplay.create(B, S, N, D, tdtype, num_actions=A, pad=PAD)
    for _ in range(adds):
        st = rng.normal(size=(B, N, D))
        ac = rng.randint(0, A, (B, N))
        rw = rng.normal(size=(B, N))
        jr = JReplay.add_lockstep(jr, jnp.asarray(st), jnp.asarray(ac),
                                  jnp.asarray(rw))
        tr.add_lockstep(torch.from_numpy(st), torch.from_numpy(ac),
                        torch.from_numpy(rw))
    return jr, tr


@pytest.mark.parametrize("jdtype,tdtype", [
    (jnp.float64, torch.float64), (jnp.bfloat16, torch.bfloat16)])
def test_replay_add_lockstep_matches_jax(jdtype, tdtype):
    jr, tr = _fill(jdtype, tdtype, S + PAD + 3)
    np.testing.assert_array_equal(
        np.asarray(jr.buf, np.float64), tr.buf.to(torch.float64).numpy())
    assert (np.asarray(jr.ptr) == tr.ptr).all()
    assert (np.asarray(jr.count) == tr.count).all()
    assert tr.capacity == S and tr.user_stride == padded_dim(D)
    # the mirror pad repeats the first PAD ring slots
    assert torch.equal(tr.buf[:, S:], tr.buf[:, :PAD])


def test_replay_mantissa_guard():
    with pytest.raises(ValueError, match="exactly"):
        TReplay.create(1, 16, 2, 5, torch.bfloat16, num_actions=300, pad=2)
    with pytest.raises(ValueError, match="pad"):
        TReplay.create(1, 4, 2, 5, torch.float32, pad=4)
    TReplay.create(1, 16, 2, 5, torch.float32, num_actions=300, pad=2)


@pytest.mark.parametrize("windows_only", [True, False])
def test_sampler_rows_match_jax(windows_only):
    jr, tr = _fill(jnp.float64, torch.float64, S + 9, seed=1)
    step, batch, n = 3, 5, 2
    keys = jax.random.split(jax.random.PRNGKey(8), n)
    want = jloop.sample_window_rows_many(jr, keys, batch, step,
                                         windows_only=windows_only)
    scores = np.stack([np.asarray(jax.random.uniform(
        jax.random.split(k, 1)[0], (B * S,))) for k in keys])
    got = tloop.sample_window_rows_many(tr, torch.from_numpy(scores), batch,
                                        step, windows_only=windows_only)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
