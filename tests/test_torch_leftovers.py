"""The JAX package's last leftovers in the port, held against diral_tpu in
float64 on the CPU (weights carried across with convert.py):

* ``envs/v2v_env.state_generator`` (the DQN-era [N, 2C+1] state) over a
  40-slot rollout against ``jenv.state_generator`` and the oracle's, as
  tests/test_env_parity.py:224-261 holds JAX's; ``reset_fixed_4ue`` equal
  to JAX's; ``get_step_fn`` picking the counterparts of JAX's flavours;
* ``agents/drqn.qvalues_all_agents`` on [T, N, D] (LSTM) and [N, D]
  (MLP) against JAX's;
* ``models/qnets.dense_init(scheme="reference")``: U[0,1) weights from
  the caller's generator and a 0.1 bias, the shapes of JAX's;
* ``train/loop.run_experiment`` equal to ``make_train_functions`` plus
  a run, its logs of the shapes of JAX's ``run_experiment``;
* ``utils/plotting``: each ``plot_*`` writes a PNG (where matplotlib is
  installed: the card's machine has none, and only the plots need it).
"""

import dataclasses
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diral_tpu.agents import drqn as jdrqn
from diral_tpu.config import toy_4ue_3r
from diral_tpu.envs import oracle as onp
from diral_tpu.envs import v2v_env as jenv
from diral_tpu.models import qnets as jq
from diral_tpu.train import loop as jloop
from diral_tpu_torch.agents import drqn as tdrqn
from diral_tpu_torch.config import toy_4ue_3r as t_toy_4ue_3r
from diral_tpu_torch.convert import learner_from_numpy
from diral_tpu_torch.envs import v2v_env as tenv
from diral_tpu_torch.models import qnets as tq
from diral_tpu_torch.train import loop as tloop
from diral_tpu_torch.train import runner

F64 = torch.float64
FIELDS = ("pos_x", "pos_y", "vel", "direction", "table_x", "table_y",
          "table_seq", "table_age", "last_arrival", "prev_obs", "pf_counter")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """These tests run many small ops; beside the suite's other workers,
    torch's intra-op threads would only contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _env_cfgs(state_type=2):
    def make(toy):
        base = toy().env
        return dataclasses.replace(base, state=dataclasses.replace(
            base.state, type=state_type))
    return make(toy_4ue_3r), make(t_toy_4ue_3r)


@pytest.mark.parametrize("state_type,seed", [(2, 9), (1, 13)])
def test_state_generator_matches_jax_and_oracle(state_type, seed):
    jcfg, tcfg = _env_cfgs(state_type)
    o = onp.OracleEnv(jcfg, np.random.RandomState(seed),
                      random.Random(seed + 1))
    s = jenv.reset_from(jcfg, o.pos_x, o.pos_y, o.vel, o.direction,
                        dtype=jnp.float64)
    ts = tenv.reset_from(tcfg, *(torch.tensor(np.asarray(v))[None]
                                 for v in (o.pos_x, o.pos_y, o.vel,
                                           o.direction)), dtype=F64)
    jit_step = jax.jit(jenv.step_collision, static_argnums=0)
    jit_gen = jax.jit(jenv.state_generator, static_argnums=0)
    rng = np.random.RandomState(seed + 2)
    for t in range(40):
        actions = rng.randint(0, jcfg.num_channels, size=jcfg.num_users)
        obs_o, _, _ = o.my_step(actions, t)
        s, obs_j, _ = jit_step(jcfg, s, jnp.asarray(actions), t)
        ts, obs_t, _ = tenv.step_collision(tcfg, ts,
                                           torch.from_numpy(actions)[None], t)
        want = np.asarray(o.state_generator(actions, obs_o))
        np.testing.assert_array_equal(
            np.asarray(jit_gen(jcfg, jnp.asarray(actions), obs_j)), want)
        got = tenv.state_generator(tcfg, torch.from_numpy(actions)[None],
                                   obs_t)
        assert got.shape == (1, jcfg.num_users, 2 * jcfg.num_channels + 1)
        assert got.dtype == F64
        np.testing.assert_array_equal(got[0].numpy(), want,
                                      err_msg=f"state_generator at t={t}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_reset_fixed_4ue_matches_jax(dtype):
    jcfg, tcfg = _env_cfgs()
    jdt = {torch.float32: jnp.float32, torch.float64: jnp.float64}[dtype]
    want = jenv.reset_fixed_4ue(jcfg, dtype=jdt)
    got = tenv.reset_fixed_4ue(tcfg, num_envs=3, dtype=dtype)
    for f in FIELDS:
        w, g = np.asarray(getattr(want, f)), getattr(got, f)
        assert g.shape == (3,) + w.shape, f
        for b in range(3):
            assert g[b].numpy().dtype == w.dtype, f
            np.testing.assert_array_equal(g[b].numpy(), w, err_msg=f)


@pytest.mark.parametrize("enable_channel", [False, True])
@pytest.mark.parametrize("design", [False, True])
def test_get_step_fn_picks_jax_flavours(enable_channel, design):
    jcfg, tcfg = _env_cfgs()
    j = jenv.get_step_fn(jcfg, enable_channel, design)
    t = tenv.get_step_fn(tcfg, enable_channel, design)
    assert t is getattr(tenv, j.__name__)
    assert j.__name__ == ("step_channel" if enable_channel else
                          "step_design" if design else "step_collision")


def _learner_dict(learner) -> dict:
    adam = learner.opt_state[0]
    tree = lambda x: jax.tree.map(np.asarray, x)  # noqa: E731
    return {"params": tree(learner.params),
            "target_params": tree(learner.target_params),
            "mu": tree(adam.mu), "nu": tree(adam.nu),
            "count": int(adam.count)}


@pytest.mark.parametrize("use_lstm", [True, False])
def test_qvalues_all_agents_matches_jax(use_lstm):
    def agent(toy):
        acfg = toy().agent
        return dataclasses.replace(acfg, network=dataclasses.replace(
            acfg.network, layers=(32, 32), lstm_impl="xla",
            use_lstm_input=use_lstm))
    jcfg, tcfg = agent(toy_4ue_3r), agent(t_toy_4ue_3r)
    T, N, D, A = jcfg.step_size, 4, 23, 3
    jl = jdrqn.init_learner(jax.random.PRNGKey(4), D, A, jcfg, jnp.float64)
    jl = jl.replace(params=jax.tree.map(   # layer norms away from 1 / 0
        lambda a: a + 0.1 * np.random.RandomState(a.size).normal(
            size=a.shape), jl.params))
    tl = learner_from_numpy(_learner_dict(jl), tcfg)
    rng = np.random.RandomState(5)
    history = rng.normal(size=(T, N, D) if use_lstm else (N, D))
    want = np.asarray(jdrqn.qvalues_all_agents(jl, jnp.asarray(history),
                                               jcfg))
    got = tdrqn.qvalues_all_agents(tl, torch.from_numpy(history), tcfg)
    assert got.shape == want.shape == (N, A) and not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_reference_dense_init(dtype):
    gen = torch.Generator().manual_seed(7)
    p = tq.dense_init(gen, 23, 17, dtype, scheme="reference")
    jp = jq.dense_init(jax.random.PRNGKey(0), 23, 17,
                       {torch.float32: jnp.float32,
                        torch.float64: jnp.float64}[dtype],
                       scheme="reference")
    for k in ("w", "b"):
        assert p[k].shape == jp[k].shape and p[k].dtype == dtype
    assert 0.0 <= float(p["w"].min()) and float(p["w"].max()) < 1.0
    assert float(p["w"].std()) > 0.2      # U[0,1): std 0.289
    np.testing.assert_array_equal(p["b"].numpy(), np.asarray(jp["b"]))
    np.testing.assert_array_equal(p["b"].numpy(),
                                  np.full(17, 0.1, p["b"].numpy().dtype))
    # the caller's generator, nothing else: the same draws from the same
    # state, and the glorot default unchanged
    again = torch.empty(23, 17, dtype=dtype).uniform_(
        0.0, 1.0, generator=torch.Generator().manual_seed(7))
    assert torch.equal(p["w"], again)
    glorot = tq.dense_init(torch.Generator().manual_seed(7), 23, 17, dtype)
    lim = (6.0 / 40) ** 0.5
    assert float(glorot["w"].abs().max()) <= lim
    assert not glorot["b"].any()


def _small(toy, **over):
    cfg = toy(time_slots=120, memory_size=64, explore=20, greedy=100000,
              training=True, train_after_episode=True, save_positions=False,
              pretrain_length=1)
    agent = dataclasses.replace(
        cfg.agent, batch_size=8, n_batch=1, target_update=50,
        network=dataclasses.replace(cfg.agent.network, layers=(32, 32),
                                    lstm_impl="xla"))
    return dataclasses.replace(cfg, agent=agent, engine=dataclasses.replace(
        cfg.engine, num_envs=2, seed=3), **over)


def test_run_experiment_is_make_train_functions_and_a_run():
    cfg = _small(t_toy_4ue_3r)
    carry, logs = tloop.run_experiment(cfg, seed=5, num_slots=60, dtype=F64,
                                       device="cpu")
    fns = tloop.make_train_functions(cfg, F64, "cpu")
    draws = tloop.Draws(torch.Generator().manual_seed(5))
    c2 = fns.init_carry(draws)
    out = []
    for t in range(60):
        c2, o = fns.slot_step(c2, t, draws)
        out.append(o)
    want = runner._chunk_logs(out, F64, fns.device, None)
    assert list(logs) == list(want)
    for k in want:
        np.testing.assert_array_equal(logs[k], want[k], err_msg=k)
    for p, q in zip(carry.learner.params.parameters(),
                    c2.learner.params.parameters()):
        assert torch.equal(p, q)
    assert torch.equal(carry.env_state.pos_x, c2.env_state.pos_x)
    assert (logs["loss"] != 0).any()          # train events ran
    # defaults: the config's seed and its schedule
    _, d_logs = tloop.run_experiment(cfg, dtype=F64, device="cpu")
    _, s_logs = tloop.run_experiment(cfg, seed=3, num_slots=120, dtype=F64,
                                     device="cpu")
    for k in d_logs:
        np.testing.assert_array_equal(d_logs[k], s_logs[k], err_msg=k)

    # the JAX package's run_experiment: the same log arrays and shapes
    jcfg = _small(toy_4ue_3r)
    _, jlogs = jloop.run_experiment(jcfg, seed=5, num_slots=60,
                                    dtype=jnp.float64)
    for k in ("sum_reward", "actions", "loss", "eps"):
        assert logs[k].shape == np.asarray(jlogs[k]).shape, k


@pytest.fixture
def plotting():
    pytest.importorskip("matplotlib")
    from diral_tpu_torch.utils import plotting
    return plotting


def test_plots_write_pngs(plotting, tmp_path):
    rng = np.random.RandomState(0)
    png = b"\x89PNG\r\n\x1a\n"
    paths = [
        plotting.plot_topology(rng.uniform(0, 100, 4), np.zeros(4),
                               actions=rng.randint(0, 3, 4),
                               communication_range=25, highway_length=100,
                               path=str(tmp_path / "topology.png")),
        plotting.plot_action_timeline(rng.randint(0, 3, (60, 2, 4)),
                                      path=str(tmp_path / "actions.png")),
        plotting.plot_learning_curve(rng.normal(size=(600, 2)),
                                     path=str(tmp_path / "rewards.png"),
                                     window=50),
    ]
    for p in paths:
        with open(p, "rb") as f:
            assert f.read(8) == png, p
