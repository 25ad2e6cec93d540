"""The DRQN schedule's late branches, float64 on the CPU: the port's
``make_train_functions`` against the JAX package's on JAX's draws
replayed (test_torch_train_slice.py's ``JaxChainDraws``), with the whole
schedule cut so that one run of ``SLOTS`` slots crosses every branch of
the slot (loop.py:512-640):

* ``explore`` (random actions, eps frozen) into the eps-greedy band at
  slot 10 (eps decays once an episode);
* the greedy switch at slot 40 (``greedy_after``: greedy actions, eps
  frozen again at its last value);
* ``training_stop`` at slot 55, which only the per-slot cadence reads
  (``train_after_episode: False``, the ``toy_per_slot`` case: training
  every slot from the first full batch, none from slot 55 on); the
  published configs train after each episode and never read it;
* a target sync every 10 slots at a train event (drqn.py:225): six in
  the episodic cases, five in the per-slot one.

Cases: congested_6v_5r and dynamic_20v_15r as published (N, C, D, the
channel step, dynamic's velocity kicks), the toy, and the toy on the
per-slot cadence; only envs, layers, batch and lengths cut, as ``_cut``
does.  Classes as in test_torch_loop_branches.py: identical actions,
bit-equal sum rewards and eps every slot, losses within 1e-10, params
within 1e-9, the replay ring, history and env state bit-equal.  Then each
package's final params drive its own greedy evaluation from the same
start states: the actions of every step must be equal.
"""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diral_tpu.config import load_config as jload, toy_4ue_3r
from diral_tpu.envs import v2v_env as jenv
from diral_tpu.train import evaluate as jeval
from diral_tpu.train import loop as jloop
from diral_tpu_torch.config import load_config as tload
from diral_tpu_torch.config import toy_4ue_3r as t_toy_4ue_3r
from diral_tpu_torch.convert import train_carry_from_numpy
from diral_tpu_torch.envs import v2v_env as tenv
from diral_tpu_torch.train import evaluate as teval
from diral_tpu_torch.train import loop as tloop
from test_torch_train_slice import FIELDS, JaxChainDraws, _cut, carry_dict

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
SLOTS, SEED, EVAL_STEPS = 75, 11, 20
EXPLORE, GREEDY, STOP, SYNC = 10, 40, 55, 10


def _schedule(cfg, per_slot=False):
    cfg = _cut(cfg)
    return dataclasses.replace(
        cfg, explore=EXPLORE, greedy=GREEDY, training_stop=STOP,
        train_after_episode=not per_slot,
        agent=dataclasses.replace(cfg.agent, target_update=SYNC))


def _yaml(name):
    path = os.path.join(ROOT, "configs", name)
    return _schedule(jload(path)), _schedule(tload(path))


CASES = {
    "congested_6v_5r": lambda: _yaml("congested_6v_5r.yaml"),
    "dynamic_20v_15r": lambda: _yaml("dynamic_20v_15r.yaml"),
    "toy_4ue_3r": lambda: (_schedule(toy_4ue_3r()),
                           _schedule(t_toy_4ue_3r())),
    "toy_per_slot": lambda: (_schedule(toy_4ue_3r(), True),
                             _schedule(t_toy_4ue_3r(), True)),
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Many small ops; beside the suite's other workers torch's intra-op
    threads would only contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


@pytest.fixture(scope="module")
def port_run(case):
    """The port's run from JAX's init carry on JAX's draws: the final
    carry, each slot's logs and the target net after every slot."""
    fns = tloop.make_train_functions(case["tcfg"], torch.float64, "cpu")
    carry = train_carry_from_numpy(case["d0"], case["tcfg"])
    draws = JaxChainDraws(case["key"], case["jcfg"], SEED, SLOTS,
                          params=case["d0"]["learner"]["params"])
    logs, targets = [], []
    for t in range(SLOTS):
        carry, lg = fns.slot_step(carry, t, draws)
        logs.append(lg)
        targets.append([p.detach().clone() for p in
                        carry.learner.target_params.parameters()])
    return carry, logs, targets


def _train_slots(case):
    cfg = case["jcfg"]
    if cfg.train_after_episode:
        return [t for t in range(SLOTS)
                if t % cfg.episode_interval == cfg.episode_interval - 1
                and t > cfg.agent.batch_size + 10]
    return [t for t in range(SLOTS) if t < STOP
            and float(case["jlogs"][t]["loss"]) != 0.0]


def test_schedule_crosses_every_branch(case, port_run):
    """The cut schedule reaches the eps-greedy band, the greedy switch,
    training_stop (per-slot cadence) and several target syncs, in both
    packages alike."""
    jlogs, (_, logs, targets) = case["jlogs"], port_run
    eps = [float(lg["eps"]) for lg in jlogs]
    assert len(set(eps[:EXPLORE])) == 1            # frozen while exploring
    assert eps[GREEDY - 1] < eps[EXPLORE]          # decayed in the mid band
    assert len(set(eps[GREEDY - 1:])) == 1         # frozen after the switch
    train = _train_slots(case)
    assert [t for t in range(SLOTS) if logs[t]["loss"] is not None] == train
    if case["jcfg"].train_after_episode:
        assert train[0] == 19 and train[-1] == SLOTS - 1
    else:
        assert train[-1] == STOP - 1 and len(train) > 40
    syncs = [t for t in train if (t + 1) % SYNC == 0]
    assert len(syncs) >= 5
    # the target net moves only at a sync
    moved = [t for t in range(1, SLOTS) if any(
        not torch.equal(a, b) for a, b in zip(targets[t - 1], targets[t]))]
    assert moved == [t for t in syncs if t > 0]


def test_slots_match_jax(case, port_run):
    jc, jlogs = case["jcarry"], case["jlogs"]
    carry, logs, _ = port_run
    for t in range(SLOTS):
        lg = logs[t]
        np.testing.assert_array_equal(lg["actions"].numpy(),
                                      jlogs[t]["actions"], err_msg=str(t))
        np.testing.assert_array_equal(lg["sum_reward"].numpy(),
                                      jlogs[t]["sum_reward"], err_msg=str(t))
        assert lg["eps"] == np.float32(jlogs[t]["eps"]), t
        loss = 0.0 if lg["loss"] is None else float(lg["loss"])
        assert abs(loss - float(jlogs[t]["loss"])) <= 1e-10, t
    for net, jnet in ((carry.learner.params, jc.learner.params),
                      (carry.learner.target_params, jc.learner.target_params)):
        got = net.tree()
        for g, leaves in jax.tree.map(np.asarray, jnet).items():
            for k, v in leaves.items():
                assert np.abs(got[g][k].detach().numpy() - v).max() <= 1e-9
    np.testing.assert_array_equal(carry.replay.buf.numpy(),
                                  np.asarray(jc.replay.buf))
    assert carry.replay.ptr == int(jc.replay.ptr[0])
    assert carry.replay.count == int(jc.replay.count[0])
    np.testing.assert_array_equal(carry.history.numpy(),
                                  np.asarray(jc.history))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(carry.env_state, f).numpy(),
                                      np.asarray(getattr(jc.env_state, f)),
                                      err_msg=f)


def test_greedy_eval_of_final_params_matches_jax(case, port_run):
    """Each package's final params through its own greedy rollout from
    the same start states: the same actions at every step."""
    jcfg, tcfg = case["jcfg"], case["tcfg"]
    env, acfg = jcfg.env, jcfg.agent
    B, N, D, T = (jcfg.engine.num_envs, env.num_users, env.state_space,
                  acfg.step_size)
    rng = np.random.RandomState(N + SEED)
    topo = (rng.randint(0, env.highway_length, (B, N)).astype(np.float64),
            np.zeros((B, N)), rng.uniform(1.1, 2.7, (B, N)), np.ones((B, N)))
    jparams = case["jcarry"].learner.params
    j_actions, t_actions = [], []

    def j_act(actor, env_state, history, k, t):
        x = jnp.transpose(history, (0, 2, 1, 3)).reshape(B * N, T, D)
        from diral_tpu.models import qnets as jq
        from diral_tpu.agents import policies as jpol
        q = jq.drqn_apply(jparams, x, acfg).reshape(B, N, -1)
        a = jpol.greedy_action(q)
        jax.debug.callback(lambda v: j_actions.append(np.asarray(v)), a,
                           ordered=True)
        return a, actor

    js = jax.vmap(lambda x, y, v, d: jenv.reset_from(
        env, x, y, v, d, dtype=jnp.float64))(*(jnp.asarray(a) for a in topo))
    jax.jit(lambda c: jeval._rollout_metrics(jcfg, j_act, c, EVAL_STEPS))(
        (js, jnp.zeros((B, T, N, D), jnp.float64), (),
         jax.random.PRNGKey(0)))

    inner = teval.drqn_act_fn(tcfg, port_run[0].learner.params)

    def t_act(actor, env_state, history, gen, t):
        a, actor = inner(actor, env_state, history, gen, t)
        t_actions.append(a.numpy().copy())
        return a, actor

    ts = tenv.reset_from(tcfg.env, *topo, dtype=torch.float64)
    with torch.no_grad():
        teval._rollout_metrics(
            tcfg, t_act, (ts, torch.zeros((B, T, N, D), dtype=torch.float64),
                          (), torch.Generator()), EVAL_STEPS)
    assert len(j_actions) == len(t_actions) == EVAL_STEPS
    for t, (a, b) in enumerate(zip(j_actions, t_actions)):
        np.testing.assert_array_equal(b, a, err_msg=f"eval step {t}")
