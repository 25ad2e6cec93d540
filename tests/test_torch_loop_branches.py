"""The DRQN loop's branches that the toy slot test does not reach, float64
on the CPU: the port's ``make_train_functions`` against the JAX package's,
40 slots each on JAX's draws replayed (test_torch_train_slice.py's
``JaxChainDraws``, its velocity kicks from the slot's ``k_vel`` included).

Cut configs (published N, C and D; only envs, layers, batch and lengths
cut, as ``_cut`` does):

* congested_6v_5r: ``enable_channel`` (the channel step in the slots and
  in pretrain) on the design topology;
* dynamic_20v_15r: ``enable_channel`` with ``mobility_vary`` (a velocity
  kick at every episode end: 8 in 40 slots);
* the toy with ``ia_averaging`` and ``ia_penalty_enable``, on the
  collision step (information age stays 0 there) and on the channel step
  (where it moves).

Classes as in test_torch_train_slice.py: identical actions, bit-equal sum
rewards and eps every slot, losses within 1e-10, params within 1e-9, the
replay ring, history, env state and shaping counters bit-equal.
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diral_tpu.config import load_config as jload, toy_4ue_3r
from diral_tpu.train import loop as jloop
from diral_tpu_torch.config import load_config as tload
from diral_tpu_torch.config import toy_4ue_3r as t_toy_4ue_3r
from diral_tpu_torch.convert import train_carry_from_numpy
from diral_tpu_torch.train import loop as tloop
from test_torch_train_slice import FIELDS, JaxChainDraws, _cut, carry_dict

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
SLOTS, SEED = 40, 7


def _yaml(name):
    path = os.path.join(ROOT, "configs", name)
    return _cut(jload(path)), _cut(tload(path))


def _ia(channel):
    flags = dict(ia_averaging=True, ia_penalty_enable=True,
                 enable_channel=channel)
    return (_cut(dataclasses.replace(toy_4ue_3r(), **flags)),
            _cut(dataclasses.replace(t_toy_4ue_3r(), **flags)))


CASES = {
    "congested_6v_5r": lambda: _yaml("congested_6v_5r.yaml"),
    "dynamic_20v_15r": lambda: _yaml("dynamic_20v_15r.yaml"),
    "toy_ia_collision": lambda: _ia(False),
    "toy_ia_channel": lambda: _ia(True),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    jcfg, tcfg = CASES[request.param]()
    init_fn, slot_step, _ = jloop.make_train_functions(jcfg, jnp.float64)
    carry0 = jax.jit(init_fn)(jax.random.PRNGKey(SEED))
    step = jax.jit(slot_step)
    carry, logs = carry0, []
    for t in range(SLOTS):
        carry, lg = step(carry, jnp.asarray(t, jnp.int32))
        logs.append(jax.tree.map(np.asarray, lg))
    return dict(name=request.param, jcfg=jcfg, tcfg=tcfg,
                d0=carry_dict(carry0), key=carry0.key, jcarry=carry,
                jlogs=logs)


def _draws(c):
    return JaxChainDraws(c["key"], c["jcfg"], SEED, SLOTS,
                         params=c["d0"]["learner"]["params"])


def test_branches_are_reached(case):
    """Each cut config runs the branch it is here for."""
    jcfg, d0, jc = case["jcfg"], case["d0"], case["jcarry"]
    name = case["name"]
    assert jcfg.env.num_users == {"congested_6v_5r": 6,
                                  "dynamic_20v_15r": 20}.get(name, 4)
    if name == "congested_6v_5r":
        assert jcfg.enable_channel and jcfg.env.enable_design_topology
        assert (d0["env_state"]["pos_y"] > 0).any()
    if name == "dynamic_20v_15r":
        assert jcfg.enable_channel and jcfg.env.mobility_vary
        kicks = sum(t % jcfg.episode_interval == jcfg.episode_interval - 1
                    for t in range(SLOTS))
        assert kicks >= 3
        assert not np.array_equal(np.asarray(jc.env_state.vel),
                                  d0["env_state"]["vel"])
    if name.startswith("toy_ia"):
        assert jcfg.ia_averaging and jcfg.ia_penalty_enable
        penalty = jcfg.ia_penalty_value
        D = jcfg.env.state_space
        buf = np.asarray(jc.replay.buf).reshape(*jc.replay.buf.shape[:2],
                                                jcfg.env.num_users, -1)
        assert (buf[..., D] == penalty + 0.0).any() or (
            np.asarray(jc.ia_counter) > 0).any()
    if name == "toy_ia_channel":
        assert (np.asarray(jc.sum_ia_prev) != 0).any()


def test_init_carry_matches_jax(case):
    """The port's own warmup and pretrain (the channel step where the
    config enables it) on JAX's reset and actions give JAX's init carry."""
    d0, tcfg = case["d0"], case["tcfg"]
    fns = tloop.make_train_functions(tcfg, torch.float64, "cpu")
    tc = fns.init_carry(_draws(case))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(tc.env_state, f).numpy(),
                                      d0["env_state"][f], err_msg=f)
    np.testing.assert_array_equal(tc.history.numpy(), d0["history"])
    np.testing.assert_array_equal(tc.state.numpy(), d0["state"])
    np.testing.assert_array_equal(tc.replay.buf.numpy(), d0["replay"]["buf"])
    got = tc.learner.params.tree()
    for g, leaves in d0["learner"]["params"].items():
        for k, v in leaves.items():
            np.testing.assert_array_equal(got[g][k].detach().numpy(), v)


def test_slots_match_jax(case):
    d0, tcfg, jc, jlogs = (case["d0"], case["tcfg"], case["jcarry"],
                           case["jlogs"])
    fns = tloop.make_train_functions(tcfg, torch.float64, "cpu")
    carry = train_carry_from_numpy(d0, tcfg)
    draws = _draws(case)
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
    for g, leaves in jax.tree.map(np.asarray, jc.learner.params).items():
        for k, v in leaves.items():
            assert np.abs(got[g][k].detach().numpy() - v).max() <= 1e-9
    np.testing.assert_array_equal(carry.replay.buf.numpy(),
                                  np.asarray(jc.replay.buf))
    assert carry.replay.ptr == int(jc.replay.ptr[0])
    np.testing.assert_array_equal(carry.history.numpy(),
                                  np.asarray(jc.history))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(carry.env_state, f).numpy(),
                                      np.asarray(getattr(jc.env_state, f)),
                                      err_msg=f)
    for f in ("sum_ia_prev", "ia_counter", "prev_actions"):
        np.testing.assert_array_equal(getattr(carry, f).numpy(),
                                      np.asarray(getattr(jc, f)), err_msg=f)
