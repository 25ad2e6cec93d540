"""The PS-DQN / PS-DRQN pieces: the port against the JAX package on the
CPU, float64, with the JAX package's random draws replayed.

* the GRU cell and scan within 1e-12;
* ``ps_dqn_apply`` and ``ps_drqn_apply_seq`` / ``_step``, dueling (mean
  vs sum of the advantages) and not, relu and linear, within 1e-12;
* ``TransitionReplay.put`` / ``sample`` and ``add_episodes_batch``
  bit-equal to JAX given JAX's indices; a put of more rows than the
  capacity against a numpy model (the last write wins);
* ``EpisodeReplay`` ingest and ``sample_windows`` bit-equal given JAX's
  episode and start draws;
* a ``train`` call of each learner -- the loss, the global-norm clip
  (firing), Adam and the target sync at ct = 0 -- within 1e-10;
* ``n_batches`` and the PS-DRQN rejection of ``unroll_step <=
  skip_error``.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diral_tpu.agents import dqn as jdqn
from diral_tpu.agents import ps_drqn as jdrqn
from diral_tpu.agents.replay import TransitionReplay as JReplay
from diral_tpu.config import load_config as jload
from diral_tpu.models import qnets as jq
from diral_tpu.models import recurrent as jr
from diral_tpu_torch.agents import dqn as tdqn
from diral_tpu_torch.agents import ps_drqn as tdrqn
from diral_tpu_torch.agents.replay import TransitionReplay as TReplay
from diral_tpu_torch.config import load_config as tload
from diral_tpu_torch.convert import (episode_replay_from_numpy,
                                     ps_dqn_learner_from_numpy,
                                     ps_drqn_learner_from_numpy,
                                     transition_replay_from_numpy)
from diral_tpu_torch.models import qnets as tq
from diral_tpu_torch.models import recurrent as tr
from diral_tpu_torch.models.qnets import ParamTree
from diral_tpu_torch.train import ps_loop

CONFIG = "configs/congested_6v_5r.yaml"
D, A = 25, 5


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree(params):
    return ParamTree({g: {k: _t(v) for k, v in leaves.items()}
                      for g, leaves in params.items()})


def _agent(cfg, dueling=False, activation="relu", layers=(16, 16), **kw):
    net = dataclasses.replace(cfg.agent.network, use_dueling=dueling,
                              activation=activation, layers=layers)
    return dataclasses.replace(cfg.agent, network=net, **kw)


def _close(got, want, atol=1e-12):
    if isinstance(got, torch.Tensor):
        got = got.detach()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


def test_gru_cell_and_scan():
    p = jr.gru_init(jax.random.PRNGKey(0), 7, 11, jnp.float64)
    tp = {k: _t(v) for k, v in p.items()}
    rng = np.random.RandomState(0)
    x, h = rng.normal(size=(5, 6, 7)), rng.normal(size=(5, 11))
    jh, _ = jr.gru_cell(p, jnp.asarray(h), jnp.asarray(x[:, 0]))
    th, _ = tr.gru_cell(tp, _t(h), _t(x[:, 0]))
    _close(th, jh)
    for h0 in (None, h):
        jn, jhs = jr.gru_scan(p, jnp.asarray(x),
                              None if h0 is None else jnp.asarray(h0))
        tn, ths = tr.gru_scan(tp, _t(x), None if h0 is None else _t(h0))
        _close(tn, jn)
        _close(ths, jhs)
    # the gate bias starts at 1 (TF GRUCell)
    assert torch.equal(tr.gru_init(torch.Generator().manual_seed(0), 7, 11,
                                   torch.float64)["bg"],
                       torch.ones(22, dtype=torch.float64))


@pytest.mark.parametrize("dueling,activation,layers", [
    (False, "relu", (16, 16)), (True, "relu", (16, 16)),
    (False, "Linear", (16,)), (True, "Linear", (16, 12))])
def test_ps_nets(dueling, activation, layers):
    jcfg, tcfg = (_agent(load(CONFIG), dueling, activation, layers)
                  for load in (jload, tload))
    rng = np.random.RandomState(1)
    x2, x3 = rng.normal(size=(9, D)), rng.normal(size=(4, 6, D))
    p = jq.ps_dqn_init(jax.random.PRNGKey(1), D, A, jcfg, jnp.float64)
    _close(tq.ps_dqn_apply(_tree(p), _t(x2), tcfg),
           jq.ps_dqn_apply(p, jnp.asarray(x2), jcfg))
    assert ("advantage" in p) == dueling and "b" not in p.get("advantage", {})
    p = jq.ps_drqn_init(jax.random.PRNGKey(2), D, A, jcfg, jnp.float64)
    tp = _tree(p)
    h0 = rng.normal(size=(4, layers[-1]))
    for h in (None, h0):
        jqv, jh = jq.ps_drqn_apply_seq(p, jnp.asarray(x3), jcfg,
                                       None if h is None else jnp.asarray(h))
        tqv, th = tq.ps_drqn_apply_seq(tp, _t(x3), tcfg,
                                       None if h is None else _t(h))
        _close(tqv, jqv)
        _close(th, jh)
    jqv, jh = jq.ps_drqn_apply_step(p, jnp.asarray(x2[:4]), jnp.asarray(h0),
                                    jcfg)
    tqv, th = tq.ps_drqn_apply_step(tp, _t(x2[:4]), _t(h0), tcfg)
    _close(tqv, jqv)
    _close(th, jh)
    assert tq.ps_drqn_hidden_size(tp) == layers[-1]


def _episodes(n_agents, L, seed):
    rng = np.random.RandomState(seed)
    return (rng.normal(size=(n_agents, L, D)),
            rng.randint(0, A, (n_agents, L)).astype(np.int32),
            rng.normal(size=(n_agents, L)),
            rng.rand(n_agents) < 0.5)


def _replay_dict(r):
    return {k: np.asarray(getattr(r, k)) for k in
            ("states", "actions", "rewards", "terminals", "masks", "head",
             "count")}


def _assert_replay_equal(t, j):
    for k in ("states", "actions", "rewards", "terminals", "masks"):
        np.testing.assert_array_equal(getattr(t, k).numpy(),
                                      np.asarray(getattr(j, k)), err_msg=k)
    assert (t.head, t.count) == (int(j.head), int(j.count))


def test_transition_replay_and_ingest():
    cap = 40
    jrep = JReplay.create(cap, D, jnp.float64)
    trep = TReplay.create(cap, D, torch.float64)
    for k in range(4):    # 3 x 12 rows, then a wrap
        s, a, r, term = _episodes(3, 4, seed=k)
        jrep = jdqn.add_episodes_batch(jrep, jnp.asarray(s), jnp.asarray(a),
                                       jnp.asarray(r), jnp.asarray(term))
        tdqn.add_episodes_batch(trep, _t(s), _t(a), _t(r), _t(term))
        _assert_replay_equal(trep, jrep)
    # add_episode is the one-agent batch
    s, a, r, _ = _episodes(1, 5, seed=9)
    jrep = jdqn.add_episode(jrep, jnp.asarray(s[0]), jnp.asarray(a[0]),
                            jnp.asarray(r[0]), True)
    tdqn.add_episode(trep, _t(s[0]), _t(a[0]), _t(r[0]), True)
    _assert_replay_equal(trep, jrep)
    key = jax.random.PRNGKey(5)
    idx = jax.random.randint(key, (16,), 0, max(int(jrep.count) - 1, 1))
    jb = jrep.sample(key, 16)
    tb = trep.sample(_t(idx))
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]),
                                      err_msg=k)
    # convert.transition_replay_from_numpy carries the ring as it is
    _assert_replay_equal(transition_replay_from_numpy(_replay_dict(jrep)),
                         jrep)


def test_put_more_rows_than_capacity():
    """A numpy model of the defined semantics: row i goes to (head + i) %
    capacity, in order, so the last write to a slot wins."""
    cap, n = 16, 45
    rep = TReplay.create(cap, 3, torch.float64)
    rep.put(torch.zeros(5, 3), torch.zeros(5, dtype=torch.int32),
            torch.zeros(5),
            torch.zeros(5, dtype=torch.bool), torch.ones(5))
    rng = np.random.RandomState(0)
    s, a = rng.normal(size=(n, 3)), rng.randint(0, 9, n).astype(np.int32)
    r, m = rng.normal(size=n), rng.rand(n)
    term = rng.rand(n) < 0.3
    model = {"states": np.array(rep.states), "actions": np.array(rep.actions),
             "rewards": np.array(rep.rewards),
             "terminals": np.array(rep.terminals),
             "masks": np.array(rep.masks)}
    for i in range(n):
        j = (rep.head + i) % cap
        for k, v in (("states", s), ("actions", a), ("rewards", r),
                     ("terminals", term), ("masks", m)):
            model[k][j] = v[i]
    rep.put(_t(s), _t(a), _t(r), _t(term), _t(m))
    for k, v in model.items():
        np.testing.assert_array_equal(getattr(rep, k).numpy(), v, err_msg=k)
    assert (rep.head, rep.count) == ((5 + n) % cap, cap)


def test_episode_replay_and_windows():
    E, L, batch, unroll = 6, 7, 24, 4
    jrep = jdrqn.EpisodeReplay.create(E, L, D, jnp.float64)
    trep = tdrqn.EpisodeReplay.create(E, L, D, torch.float64)
    rng = np.random.RandomState(3)
    for k in range(3):    # 4 + 4 + 1 episodes: wraps, ragged lengths
        n = 1 if k == 2 else 4
        s, a, r, term = _episodes(n, L, seed=20 + k)
        lengths = rng.randint(1, L + 1, n).astype(np.int32)
        jrep = jrep.add_episodes_batch(jnp.asarray(s), jnp.asarray(a),
                                       jnp.asarray(r), jnp.asarray(term),
                                       jnp.asarray(lengths))
        trep.add_episodes_batch(_t(s), _t(a), _t(r), _t(term), _t(lengths))
    s, a, r, _ = _episodes(1, L, seed=30)
    jrep = jrep.add_episode(jnp.asarray(s[0]), jnp.asarray(a[0]),
                            jnp.asarray(r[0]), True, 5)
    trep.add_episode(_t(s[0]), _t(a[0]), _t(r[0]), True, 5)
    for k in ("states", "actions", "rewards", "terminals", "lengths"):
        np.testing.assert_array_equal(getattr(trep, k).numpy(),
                                      np.asarray(getattr(jrep, k)), err_msg=k)
    assert (trep.ptr, trep.count) == (int(jrep.ptr), int(jrep.count))
    key = jax.random.PRNGKey(8)
    eps_idx, start = jax_window_draws(key, trep, batch)
    jb = jrep.sample_windows(key, batch, unroll)
    tb = trep.sample_windows(_t(eps_idx), _t(start), unroll)
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]),
                                      err_msg=k)
    conv = episode_replay_from_numpy(
        {k: np.asarray(getattr(jrep, k)) for k in
         ("states", "actions", "rewards", "terminals", "lengths", "ptr",
          "count")})
    assert torch.equal(conv.states, trep.states) and conv.ptr == trep.ptr
    # the port's own draws: episodes in range, starts inside the episode
    g = torch.Generator().manual_seed(0)
    e, st = trep.window_draws(-torch.log(-torch.log(torch.rand(
        batch, E, generator=g))), torch.rand(batch, generator=g))
    assert torch.all(st < trep.lengths[e]) and torch.all(st >= 0)


def jax_window_draws(key, replay, batch):
    """JAX's (episode, start) draws of sample_windows (ps_drqn.py:160-168)
    for the port's ``replay`` (equal to JAX's)."""
    k_ep, k_start = jax.random.split(key)
    E = replay.capacity
    valid = np.arange(E) < replay.count
    w = np.where(valid, replay.lengths.numpy(), 0).astype(np.float32)
    logits = jnp.log(jnp.maximum(jnp.asarray(w), 1e-9))
    eps_idx = jax.random.categorical(k_ep, logits, shape=(batch,))
    length = jnp.asarray(replay.lengths.numpy())[eps_idx]
    start = jax.random.randint(k_start, (batch,), 0, jnp.maximum(length, 1))
    return np.asarray(eps_idx), np.asarray(start)


def _learner_dict(lrn):
    adam = lrn.opt_state[1][0]    # chain(clip, adam)
    return {"params": jax.tree.map(np.asarray, lrn.params),
            "target_params": jax.tree.map(np.asarray, lrn.target_params),
            "mu": jax.tree.map(np.asarray, adam.mu),
            "nu": jax.tree.map(np.asarray, adam.nu),
            "count": int(adam.count)}


def _assert_learner_close(tl, jl, atol=1e-10):
    want = _learner_dict(jl)
    flat = {k: {f"{g}.{n}": v for g, ls in want[k].items()
                for n, v in ls.items()}
            for k in ("params", "target_params", "mu", "nu")}
    for name, p in tl.params.named_parameters():
        _close(p.detach(), flat["params"][name], atol)
        _close(tl.opt.state[p]["exp_avg"], flat["mu"][name], atol)
        _close(tl.opt.state[p]["exp_avg_sq"], flat["nu"][name], atol)
        assert int(tl.opt.state[p]["step"]) == want["count"]
    for name, p in tl.target_params.named_parameters():
        _close(p, flat["target_params"][name], atol)


def _global_norm(grads):
    return float(jnp.sqrt(sum(jnp.sum(g * g)
                              for g in jax.tree.leaves(grads))))


@pytest.mark.parametrize("dueling", [False, True])
def test_ps_dqn_train_step(dueling):
    """Two gradient steps with target_update 3: the sync after step 0
    (ct = 0) and none after step 1.  Rewards x 50 make the gradient's
    global norm exceed the 5.0 clip."""
    jcfg, tcfg = (_agent(load(CONFIG), dueling, batch_size=32,
                         target_update=3, learning_rate=1e-2)
                  for load in (jload, tload))
    jl = jdqn.init_learner(jax.random.PRNGKey(3), D, A, jcfg, jnp.float64)
    jl = jl.replace(target_params=jax.tree.map(lambda p: p * 0.5,
                                               jl.target_params))
    s, a, r, term = _episodes(6, 10, seed=4)
    jrep = jdqn.add_episodes_batch(
        JReplay.create(80, D, jnp.float64), jnp.asarray(s), jnp.asarray(a),
        jnp.asarray(r * 50), jnp.asarray(term))
    key = jax.random.PRNGKey(6)
    keys = jax.random.split(key, 2)
    idx = [jax.random.randint(k, (32,), 0, max(int(jrep.count) - 1, 1))
           for k in keys]
    b0 = jrep.sample(keys[0], 32)
    t0 = jdqn.td_targets(jl, b0, jcfg)
    g0 = jax.grad(jdqn.loss_fn)(jl.params, b0, t0, jcfg)
    assert _global_norm(g0) > 5.0          # the clip fires
    jl2, jloss = jdqn.train(jl, jrep, key, jcfg, 2)

    tl = ps_dqn_learner_from_numpy(_learner_dict(jl), tcfg)
    trep = transition_replay_from_numpy(_replay_dict(jrep))
    tloss = tdqn.train(tl, trep, [_t(i) for i in idx], tcfg)
    _close(tloss, jloss, 1e-10)
    _assert_learner_close(tl, jl2)
    # synced at ct = 0 only: the target is the params after step 0
    assert not all(torch.equal(p, q) for p, q in
                   zip(tl.params.parameters(), tl.target_params.parameters()))


def test_clip_is_optax_arithmetic():
    """Above the limit every gradient becomes (g / norm) * max_norm;
    below it nothing changes."""
    p = torch.nn.Parameter(torch.zeros(3, dtype=torch.float64))
    q = torch.nn.Parameter(torch.zeros(2, dtype=torch.float64))
    p.grad = torch.tensor([3.0, 4.0, 12.0], dtype=torch.float64)
    q.grad = torch.tensor([0.0, 84.0], dtype=torch.float64)
    tdqn.clip_by_global_norm([p, q], 5.0)        # norm 85
    assert torch.equal(p.grad, torch.tensor([3.0, 4.0, 12.0],
                                            dtype=torch.float64) / 85 * 5)
    assert torch.equal(q.grad, torch.tensor([0.0, 84.0],
                                            dtype=torch.float64) / 85 * 5)
    p.grad = torch.tensor([0.3, 0.4, 1.2], dtype=torch.float64)
    before = p.grad.clone()
    tdqn.clip_by_global_norm([p], 5.0)
    assert torch.equal(p.grad, before)


def test_ps_drqn_train_step():
    jcfg, tcfg = (_agent(load(CONFIG), False, batch_size=8, unroll_step=4,
                         target_update=2, learning_rate=1e-2)
                  for load in (jload, tload))
    jl = jdrqn.init_learner(jax.random.PRNGKey(7), D, A, jcfg, jnp.float64)
    jl = jl.replace(target_params=jax.tree.map(lambda p: p * 0.5,
                                               jl.target_params))
    s, a, r, term = _episodes(6, 9, seed=8)
    jrep = jdrqn.EpisodeReplay.create(6, 9, D, jnp.float64).add_episodes_batch(
        jnp.asarray(s), jnp.asarray(a), jnp.asarray(r * 50),
        jnp.asarray(term), jnp.asarray(np.array([9, 9, 5, 9, 3, 9], np.int32)))
    key = jax.random.PRNGKey(9)
    keys = jax.random.split(key, 3)
    b0 = jrep.sample_windows(keys[0], 8, 4)
    t0 = jdrqn.td_targets(jl, b0, jcfg)
    assert _global_norm(jax.grad(jdrqn.loss_fn)(jl.params, b0, t0,
                                                jcfg)) > 10.0
    jl2, jloss = jdrqn.train(jl, jrep, key, jcfg, 3)

    tl = ps_drqn_learner_from_numpy(_learner_dict(jl), tcfg)
    trep = episode_replay_from_numpy(
        {k: np.asarray(getattr(jrep, k)) for k in
         ("states", "actions", "rewards", "terminals", "lengths", "ptr",
          "count")})
    draws = [tuple(_t(v) for v in jax_window_draws(k, trep, 8)) for k in keys]
    tloss = tdrqn.train(tl, trep, draws, tcfg)
    _close(tloss, jloss, 1e-10)
    _assert_learner_close(tl, jl2)


def _ps_cfg(num_envs, **agent):
    cfg = tload(CONFIG)
    return dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine, num_envs=num_envs),
        agent=dataclasses.replace(cfg.agent, **agent))


def test_n_batches():
    """ps_loop.py:86-90; congested_6v_5r at 32 envs: 4800 transitions per
    episode -> 9 PS-DQN batches of 512, 1 PS-DRQN batch of 512 windows of
    8 steps."""
    cfg = _ps_cfg(32)
    assert ps_loop.n_batches(cfg, "ps-dqn") == 4800 // 512 == 9
    assert ps_loop.n_batches(cfg, "PS_DRQN") == 4800 // (512 * 8) == 1
    small = _ps_cfg(1, batch_size=64, unroll_step=4, training_freq=2)
    net = dataclasses.replace(small.agent.network, skip_error=1)
    small = dataclasses.replace(small, agent=dataclasses.replace(
        small.agent, network=net))
    assert ps_loop.n_batches(small, "ps-dqn") == 2 * 150 // 64
    assert ps_loop.n_batches(small, "ps-drqn") == 2 * 150 // (64 * 3) == 1
    assert ps_loop.n_batches(_ps_cfg(1), "ps-drqn") == 0   # no train call


@pytest.mark.parametrize("skip", [8, 9])
def test_ps_drqn_rejects_unroll_not_above_skip_error(skip):
    cfg = _ps_cfg(2, unroll_step=8)
    cfg = dataclasses.replace(cfg, agent=dataclasses.replace(
        cfg.agent, network=dataclasses.replace(cfg.agent.network,
                                               skip_error=skip)))
    with pytest.raises(ValueError, match="unroll_step > skip_error"):
        ps_loop.make_ps_functions(cfg, "ps-drqn", device="cpu")
    ps_loop.make_ps_functions(cfg, "ps-dqn", device="cpu")   # not used there
    with pytest.raises(ValueError, match="unknown PS algorithm"):
        ps_loop.make_ps_functions(cfg, "drqn", device="cpu")
