"""The whole training slice, float64 on the CPU: the port's
``make_train_functions`` against the JAX package's on a cut toy config,
with the JAX package's random draws replayed into the port through a
test-side ``Draws`` that walks loop.py's key chain (loop.py:430, 435, 452,
518, 547-560, 603; drqn.py:201-204; loop.py:170-171).

* (i) From JAX's ``init_carry`` (converted by
  convert.train_carry_from_numpy), 40 slots: identical actions every
  slot, bit-equal sum rewards, losses within 1e-10, final params within
  1e-9 (optax.adam and torch.optim.Adam order their arithmetic
  differently), the replay ring bit-equal.  The port's own ``init_carry``,
  given JAX's reset state and warmup/pretrain actions, equals JAX's init
  carry bit for bit.  The runner's chunks, cut across episodes or not,
  give the slot loop's results.
* (j) The ``train`` verb on the CPU writes the reference-layout results;
  without ``--device cpu`` (no GPU here) it raises; ``--resume`` starts
  cold where no checkpoint is and continues otherwise; ``--mesh data=2``
  without a process group raises, naming the options that form one.
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
import yaml

from diral_tpu.config import toy_4ue_3r
from diral_tpu.envs import v2v_env as jenv
from diral_tpu.train import loop as jloop
from diral_tpu_torch.config import toy_4ue_3r as t_toy_4ue_3r
from diral_tpu_torch.convert import train_carry_from_numpy
from diral_tpu_torch.envs import v2v_env as tenv
from diral_tpu_torch.models import qnets
from diral_tpu_torch.train import loop as tloop
from diral_tpu_torch.train import runner

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
SLOTS = 40
FIELDS = ("pos_x", "pos_y", "vel", "direction", "table_x", "table_y",
          "table_seq", "table_age", "last_arrival", "prev_obs", "pf_counter")


def _cut(cfg):
    env = dataclasses.replace(cfg.env, step_impl="xla")
    env = dataclasses.replace(env, state=dataclasses.replace(
        env.state, hist_impl="xla"))
    net = dataclasses.replace(cfg.agent.network, layers=(32, 32),
                              lstm_impl="xla")
    agent = dataclasses.replace(cfg.agent, network=net, batch_size=8,
                                n_batch=2, target_update=10)
    return dataclasses.replace(
        cfg, env=env, agent=agent, episode_interval=5, memory_size=64,
        explore=10, greedy=1000,
        engine=dataclasses.replace(cfg.engine, num_envs=2))


JCFG, TCFG = _cut(toy_4ue_3r()), _cut(t_toy_4ue_3r())
B, N, C = 2, JCFG.env.num_users, JCFG.env.num_channels
SEED = 3


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def carry_dict(c) -> dict:
    """The JAX TrainCarry as plain numpy dicts (convert.py's input)."""
    adam = c.learner.opt_state[0]
    return {
        "env_state": {f: np.asarray(getattr(c.env_state, f)) for f in FIELDS},
        "history": np.asarray(c.history), "state": np.asarray(c.state),
        "replay": {"buf": np.asarray(c.replay.buf),
                   "ptr": np.asarray(c.replay.ptr),
                   "count": np.asarray(c.replay.count)},
        "learner": {"params": _np(c.learner.params),
                    "target_params": _np(c.learner.target_params),
                    "mu": _np(adam.mu), "nu": _np(adam.nu),
                    "count": int(adam.count)},
        "eps_state": {"eps": np.asarray(c.eps_state.eps),
                      "episode": int(c.eps_state.episode)},
        "beta": np.asarray(c.beta),
        "sum_ia_prev": np.asarray(c.sum_ia_prev),
        "ia_counter": np.asarray(c.ia_counter),
        "prev_actions": np.asarray(c.prev_actions)}


def _t(a):
    return torch.from_numpy(np.array(a))


class JaxChainDraws(tloop.Draws):
    """The JAX package's draws, key for key: init from PRNGKey(seed), slots
    from the carried key (one split into (key, act, vel, train) per
    slot).  ``jcfg`` (default the cut toy config) fixes B, N and C;
    ``params`` (a JAX parameter tree as numpy) serves ``init_carry``'s
    parameter draw."""

    def __init__(self, slot_key, jcfg=None, seed=SEED, slots=SLOTS,
                 params=None):
        self.jcfg = JCFG if jcfg is None else jcfg
        self.B = self.jcfg.engine.num_envs
        self.N, self.C = self.jcfg.env.num_users, self.jcfg.env.num_channels
        self.tree = params
        k_env, k_act, k_pre, _, _ = jax.random.split(
            jax.random.PRNGKey(seed), 5)
        self.k_env, self.k_act, self.k_pre = k_env, k_act, k_pre
        self.n_pre = (self.jcfg.pretrain_length * self.jcfg.step_size * 5)
        self.slot_keys = []
        key = slot_key
        for _ in range(slots):
            key, k_a, k_v, k_t = jax.random.split(key, 4)
            self.slot_keys.append((k_a, k_v, k_t))

    @property
    def device(self):
        return torch.device("cpu")

    def reset(self, env_cfg, num_envs, dtype):
        js = jax.vmap(lambda k: jenv.reset(self.jcfg.env, k, jnp.float64))(
            jax.random.split(self.k_env, self.B))
        return tenv.EnvState(**{f: _t(getattr(js, f)) for f in FIELDS})

    def params(self, state_dim, num_actions, acfg, dtype):
        return qnets.DRQN(
            {g: {k: _t(v) for k, v in leaves.items()}
             for g, leaves in self.tree.items()}, acfg)

    def _sample(self, key):
        N, C = self.N, self.C
        return _t(jax.vmap(lambda k: jax.random.randint(k, (N,), 0, C))(
            jax.random.split(key, self.B)))

    def warmup_actions(self, env_cfg, B_):
        return self._sample(self.k_act)

    def pretrain_actions(self, i, env_cfg, B_):
        return self._sample(jax.random.split(self.k_pre, self.n_pre)[i])

    def _select_keys(self, t):
        ks = jax.random.split(self.slot_keys[t][0], self.B)
        return [jax.random.split(k) for k in ks]   # (ke, kp) per env

    def explore_actions(self, t, B_, N_, C_):
        return _t(np.stack([jax.random.randint(ke, (self.N,), 0, self.C)
                            for ke, _ in self._select_keys(t)]))

    def eps_greedy(self, t, B_, N_, C_):
        draws, rands = [], []
        for _, kp in self._select_keys(t):
            kd, kr = jax.random.split(kp)
            draws.append(np.asarray(jax.random.uniform(kd, (self.N,))))
            rands.append(np.asarray(jax.random.randint(kr, (self.N,), 0,
                                                       self.C)))
        return _t(np.stack(draws)), _t(np.stack(rands))

    def velocity_kicks(self, t, B_, N_):
        """update_velocity's draws: env b's kicks from split(k_vel, B)[b]
        (loop.py's slot_core vmaps E.update_velocity over them)."""
        N = self.N
        return _t(jax.vmap(lambda k: jax.random.randint(k, (N,), 1, 4))(
            jax.random.split(self.slot_keys[t][1], self.B)))

    def sampler_scores(self, t, n, BS):
        key, out = self.slot_keys[t][2], []
        for _ in range(n):
            key, kb = jax.random.split(key)
            out.append(np.asarray(jax.random.uniform(
                jax.random.split(kb, 1)[0], (BS,))))
        return _t(np.stack(out))


@pytest.fixture(scope="module")
def jax_run():
    init_fn, slot_step, _ = jloop.make_train_functions(JCFG, jnp.float64)
    carry0 = jax.jit(init_fn)(jax.random.PRNGKey(SEED))
    step = jax.jit(slot_step)
    carry, logs = carry0, []
    for t in range(SLOTS):
        carry, lg = step(carry, jnp.asarray(t, jnp.int32))
        logs.append(jax.tree.map(np.asarray, lg))
    return carry_dict(carry0), carry0.key, carry, logs


def test_init_carry_matches_jax(jax_run):
    d0, key, _, _ = jax_run
    fns = tloop.make_train_functions(TCFG, torch.float64, "cpu")
    jc = train_carry_from_numpy(d0, TCFG)
    tc = fns.init_carry(JaxChainDraws(key), learner=jc.learner)
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tc.env_state, f).numpy(),
                                      d0["env_state"][f], err_msg=f)
    np.testing.assert_array_equal(tc.history.numpy(), d0["history"])
    np.testing.assert_array_equal(tc.state.numpy(), d0["state"])
    np.testing.assert_array_equal(tc.replay.buf.numpy(), d0["replay"]["buf"])
    assert (tc.replay.ptr, tc.replay.count) == (jc.replay.ptr,
                                                jc.replay.count)
    assert tc.eps_state == jc.eps_state and tc.beta == jc.beta
    for f in ("sum_ia_prev", "ia_counter", "prev_actions"):
        assert torch.equal(getattr(tc, f), getattr(jc, f)), f


def test_slots_match_jax(jax_run):
    d0, key, jcarry, jlogs = jax_run
    fns = tloop.make_train_functions(TCFG, torch.float64, "cpu")
    carry = train_carry_from_numpy(d0, TCFG)
    draws = JaxChainDraws(key)
    n_train = 0
    for t in range(SLOTS):
        carry, lg = fns.slot_step(carry, t, draws)
        np.testing.assert_array_equal(lg["actions"].numpy(),
                                      jlogs[t]["actions"], err_msg=str(t))
        np.testing.assert_array_equal(lg["sum_reward"].numpy(),
                                      jlogs[t]["sum_reward"], err_msg=str(t))
        assert lg["eps"] == np.float32(jlogs[t]["eps"])
        loss = 0.0 if lg["loss"] is None else float(lg["loss"])
        n_train += lg["loss"] is not None
        assert abs(loss - float(jlogs[t]["loss"])) <= 1e-10, t
    assert n_train == 5   # t = 19, 24, 29, 34, 39
    got = carry.learner.params.tree()
    for g, leaves in _np(jcarry.learner.params).items():
        for k, v in leaves.items():
            assert np.abs(got[g][k].detach().numpy() - v).max() <= 1e-9
    np.testing.assert_array_equal(carry.replay.buf.numpy(),
                                  np.asarray(jcarry.replay.buf))
    assert carry.replay.ptr == int(jcarry.replay.ptr[0])
    np.testing.assert_array_equal(carry.history.numpy(),
                                  np.asarray(jcarry.history))


def test_runner_chunks_equal_slot_loop(tmp_path):
    """train_experiment in chunks that cut episodes (7 slots) and in one
    chunk gives, bit for bit, what a plain slot_step loop gives."""
    cfg = dataclasses.replace(TCFG, time_slots=SLOTS)

    def draws():
        return tloop.Draws(torch.Generator().manual_seed(5))

    fns = tloop.make_train_functions(cfg, torch.float64, "cpu")
    d = draws()
    carry, want = fns.init_carry(d), []
    for t in range(SLOTS):
        carry, lg = fns.slot_step(carry, t, d)
        want.append(lg)
    assert sum(lg["loss"] is not None for lg in want) == 5
    for chunk in (7, SLOTS):
        c, logs = runner.train_experiment(
            cfg, str(tmp_path / str(chunk)), chunk_size=chunk,
            dtype=torch.float64, verbose=False, device="cpu",
            draws=draws())
        np.testing.assert_array_equal(
            logs["actions"], np.stack([lg["actions"].numpy() for lg in want]))
        np.testing.assert_array_equal(
            logs["sum_reward"],
            np.stack([lg["sum_reward"].numpy() for lg in want]))
        np.testing.assert_array_equal(
            logs["loss"], [0.0 if lg["loss"] is None else float(lg["loss"])
                           for lg in want])
        for p, q in zip(c.learner.params.parameters(),
                        carry.learner.params.parameters()):
            assert torch.equal(p, q)


def test_bf16_compute_stores_ring_and_history_in_bf16():
    """compute_dtype bfloat16 in a float32 run stores the replay ring and
    the history window in bf16 (loop.py:367-378); env state and the carry
    stay float32, and the slice trains."""
    net = dataclasses.replace(TCFG.agent.network, compute_dtype="bfloat16")
    cfg = dataclasses.replace(TCFG, agent=dataclasses.replace(TCFG.agent,
                                                              network=net))
    fns = tloop.make_train_functions(cfg, torch.float32, "cpu")
    draws = tloop.Draws(torch.Generator().manual_seed(0))
    carry = fns.init_carry(draws)
    assert carry.replay.buf.dtype == carry.history.dtype == torch.bfloat16
    assert carry.state.dtype == carry.env_state.pos_x.dtype == torch.float32
    newest = carry.history[..., -fns.Dp:][..., :fns.D]
    assert torch.equal(newest, carry.state.to(torch.bfloat16))
    losses = []
    for t in range(SLOTS):
        carry, lg = fns.slot_step(carry, t, draws)
        if lg["loss"] is not None:
            losses.append(float(lg["loss"]))
    assert len(losses) == 5 and np.isfinite(losses).all()


def _cli(args, **kw):
    return subprocess.run([sys.executable, "-m", "diral_tpu_torch", *args],
                          cwd=ROOT, capture_output=True, text=True,
                          timeout=300, **kw)


def test_cli_train_on_cpu(tmp_path):
    raw = yaml.safe_load(open(os.path.join(ROOT, "configs",
                                           "toy_4ue_3r.yaml")))
    raw.update(time_slots=30, episode_interval=5, memory_size=64,
               explore=10, save_freq=20)
    raw["RLAgent"].update(batch_size=8)
    raw["RLAgent"]["network"]["layers"] = {1: 32, 2: 32}
    raw["Engine"] = {"num_envs": 2, "seed": 1}
    cfg = tmp_path / "cut.yaml"
    cfg.write_text(yaml.safe_dump(raw))
    out = _cli(["train", str(cfg), "--device", "cpu", "--workdir",
                str(tmp_path)], check=True)
    res = tmp_path / "save_results" / "test" / "toy_4ue_3r"
    rewards = np.load(res / "rewards_sim0.npy")
    actions = np.load(res / "actions_sim0.npy")
    assert rewards.shape == (30, 2) and actions.shape == (30, 2, 4)
    lines = [json.loads(x) for x in open(res / "metrics_sim0.jsonl")]
    assert [x["slot"] for x in lines] == [20, 30]
    assert "Time step 29" in out.stdout
    # without --device cpu the entry point asks for the card
    if not torch.cuda.is_available():
        bad = _cli(["train", str(cfg), "--workdir", str(tmp_path)])
        assert bad.returncode != 0 and "no CUDA device" in bad.stderr
    # --resume: a cold start where no checkpoint is, then a continuation
    resume = ["train", str(cfg), "--device", "cpu", "--workdir",
              str(tmp_path), "--resume"]
    ok = _cli(resume)
    assert ok.returncode == 0 and "no checkpoint yet" in ok.stdout, ok.stderr
    ok = _cli(resume)
    assert ok.returncode == 0 and "resumed from slot 30" in ok.stdout
    bad = _cli(["train", str(cfg), "--device", "cpu", "--mesh", "data=2"])
    assert bad.returncode != 0 and "needs 2 devices; only 1 visible" in \
        bad.stderr
    assert "--coordinator/--num-processes/--process-id" in bad.stderr
