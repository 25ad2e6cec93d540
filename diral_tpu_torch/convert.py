"""Carry DRQN parameters, a learner and a whole training carry from the JAX
package's structures into the port.

The inputs are plain dicts of numpy arrays under the JAX field names (a
test flattens the flax structs into them; the port imports no JAX):

* a parameter tree: nested dicts {"lstm": {"w", "b"}, "fc2": {"w", "b"},
  "ln2": {"scale", "bias"}, "head": {"w", "b"}, ...}.  The port's
  ``qnets.DRQN`` uses the same names and [in, out] layouts, so the
  conversion renames paths to ``group.leaf`` keys;
* a learner: {"params", "target_params": trees, "mu", "nu": trees (optax
  adam's moments), "count": int (its step count)} -- mapped to
  ``torch.optim.Adam``'s ``exp_avg``, ``exp_avg_sq`` and ``step``;
* a training carry: {"env_state": {EnvState field: array}, "history",
  "state", "replay": {"buf", "ptr", "count"}, "learner": as above,
  "eps_state": {"eps", "episode"}, "beta", "sum_ia_prev", "ia_counter",
  "prev_actions"}.  The replay's ``ptr`` / ``count`` (one per env, all
  equal: the envs advance in lockstep) become host integers.
"""

from __future__ import annotations

import numpy as np
import torch

from diral_tpu_torch.config import AgentConfig, ExperimentConfig


def _tensor(value, device=None) -> torch.Tensor:
    return torch.from_numpy(np.array(value, copy=True)).to(device)


def drqn_params_from_numpy(tree: dict) -> dict[str, torch.Tensor]:
    """Nested {group: {leaf: array}} -> state_dict {"group.leaf": tensor}
    (dtype kept, copied)."""
    return {f"{group}.{leaf}": _tensor(value)
            for group, leaves in tree.items()
            for leaf, value in leaves.items()}


def learner_from_numpy(d: dict, cfg: AgentConfig, device=None):
    """The port's ``drqn.DRQNLearner`` from a JAX learner dict."""
    from diral_tpu_torch.agents import drqn
    from diral_tpu_torch.models import qnets

    net = qnets.DRQN({g: {k: _tensor(v, device) for k, v in leaves.items()}
                      for g, leaves in d["params"].items()}, cfg)
    learner = drqn.init_learner(net, cfg)
    learner.target_params.load_state_dict(
        drqn_params_from_numpy(d["target_params"]))
    for name, p in net.named_parameters():
        group, leaf = name.split(".")
        learner.opt.state[p] = {
            "step": torch.tensor(float(d["count"]), dtype=torch.float32),
            "exp_avg": _tensor(d["mu"][group][leaf], device),
            "exp_avg_sq": _tensor(d["nu"][group][leaf], device),
        }
    return learner


def _lockstep(v) -> int:
    v = np.asarray(v).reshape(-1)
    if not (v == v[0]).all():
        raise ValueError(f"replay pointers differ across envs: {v}")
    return int(v[0])


def train_carry_from_numpy(d: dict, cfg: ExperimentConfig, device=None):
    """The port's ``loop.TrainCarry`` from a JAX training-carry dict."""
    from diral_tpu_torch.agents.policies import EpsGreedyState
    from diral_tpu_torch.agents.replay import FusedWindowReplay
    from diral_tpu_torch.envs.v2v_env import EnvState
    from diral_tpu_torch.train.loop import TrainCarry

    rp = d["replay"]
    window = cfg.agent.step_size if cfg.agent.network.use_lstm_input else 1
    replay = FusedWindowReplay(
        buf=_tensor(rp["buf"], device), ptr=_lockstep(rp["ptr"]),
        count=_lockstep(rp["count"]), pad=window,
        num_users=cfg.env.num_users, dim=cfg.env.state_space)
    eps = d["eps_state"]
    return TrainCarry(
        env_state=EnvState(**{k: _tensor(v, device)
                              for k, v in d["env_state"].items()}),
        history=_tensor(d["history"], device),
        state=_tensor(d["state"], device),
        replay=replay,
        learner=learner_from_numpy(d["learner"], cfg.agent, device),
        eps_state=EpsGreedyState(eps=np.float32(eps["eps"]),
                                 episode=int(eps["episode"])),
        beta=np.float32(d["beta"]),
        sum_ia_prev=_tensor(d["sum_ia_prev"], device),
        ia_counter=_tensor(d["ia_counter"], device),
        prev_actions=_tensor(d["prev_actions"], device))
