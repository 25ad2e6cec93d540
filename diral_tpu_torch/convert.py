"""Carry parameters, learners, replays and a whole DRQN training carry
from the JAX package's structures into the port.

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
  equal: the envs advance in lockstep) become host integers;
* a PPO learner: {"params", "old_params", "mu", "nu", "count"} (optax
  adam); a PS-DQN / PS-DRQN learner: {"params", "target_params", "mu",
  "nu", "count"} (the adam inside their clip chain);
* a transition replay {"states", "actions", "rewards", "terminals",
  "masks", "head", "count"} and an episode replay {"states", "actions",
  "rewards", "terminals", "lengths", "ptr", "count"}.
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


def _tree(tree: dict, device=None) -> dict:
    return {g: {k: _tensor(v, device) for k, v in leaves.items()}
            for g, leaves in tree.items()}


def _adam_state(opt, net, d: dict, device=None) -> None:
    """optax adam's mu / nu / count -> ``torch.optim.Adam``'s exp_avg /
    exp_avg_sq / step for every parameter of ``net``."""
    for name, p in net.named_parameters():
        group, leaf = name.split(".")
        opt.state[p] = {
            "step": torch.tensor(float(d["count"]), dtype=torch.float32),
            "exp_avg": _tensor(d["mu"][group][leaf], device),
            "exp_avg_sq": _tensor(d["nu"][group][leaf], device),
        }


def _load_rest(learner, second: str, d: dict, device=None):
    """Load the learner's second net (``target_params`` or
    ``old_params``, from ``d[second]``) and its Adam state."""
    getattr(learner, second).load_state_dict(
        drqn_params_from_numpy(d[second]))
    _adam_state(learner.opt, learner.params, d, device)
    return learner


def learner_from_numpy(d: dict, cfg: AgentConfig, device=None):
    """The port's ``drqn.DRQNLearner`` from a JAX learner dict."""
    from diral_tpu_torch.agents import drqn
    from diral_tpu_torch.models import qnets

    learner = drqn.init_learner(qnets.DRQN(_tree(d["params"], device), cfg),
                                cfg)
    return _load_rest(learner, "target_params", d, device)


def ppo_learner_from_numpy(d: dict, device=None):
    """The port's ``ppo.PPOLearner`` from a JAX PPO learner dict."""
    from diral_tpu_torch.agents import ppo
    from diral_tpu_torch.models.qnets import ParamTree

    learner = ppo.init_learner(ParamTree(_tree(d["params"], device)))
    return _load_rest(learner, "old_params", d, device)


def ps_dqn_learner_from_numpy(d: dict, cfg: AgentConfig, device=None):
    """The port's ``dqn.PSDQNLearner`` from a JAX PS-DQN learner dict."""
    from diral_tpu_torch.agents import dqn
    from diral_tpu_torch.models.qnets import ParamTree

    learner = dqn.init_learner(ParamTree(_tree(d["params"], device)), cfg)
    return _load_rest(learner, "target_params", d, device)


def ps_drqn_learner_from_numpy(d: dict, cfg: AgentConfig, device=None):
    """The port's PS-DRQN learner (a ``dqn.PSDQNLearner``: the same
    fields) from a JAX PS-DRQN learner dict."""
    return ps_dqn_learner_from_numpy(d, cfg, device)


def transition_replay_from_numpy(d: dict, device=None):
    """The port's ``TransitionReplay`` from a JAX one's fields."""
    from diral_tpu_torch.agents.replay import TransitionReplay

    return TransitionReplay(
        **{k: _tensor(d[k], device) for k in ("states", "actions", "rewards",
                                              "terminals", "masks")},
        head=int(d["head"]), count=int(d["count"]))


def episode_replay_from_numpy(d: dict, device=None):
    """The port's ``ps_drqn.EpisodeReplay`` from a JAX one's fields."""
    from diral_tpu_torch.agents.ps_drqn import EpisodeReplay

    return EpisodeReplay(
        **{k: _tensor(d[k], device) for k in ("states", "actions", "rewards",
                                              "terminals", "lengths")},
        ptr=int(d["ptr"]), count=int(d["count"]))


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
