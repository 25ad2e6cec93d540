"""Parameter-shared recurrent DQN with truncated BPTT
(diral_tpu/agents/ps_drqn.py; reference algorithms/ps_drqn.py
``DeepRecurrentQNetwork``), the episode-replay GRU variant with a carried
per-agent hidden state.

Semantics, as the JAX package reconstructs them from the reference:

* an episode replay of fixed capacity (the reference caps it at
  ``num_users`` episodes, ps_drqn.py:109-111): an [E, L, ...] ring with a
  length per episode;
* length-weighted episode draws (ps_drqn.py:329-331,354) and a random
  ``unroll_step`` window per drawn episode, zero-padded, the window's
  last filled step masked out unless it is terminal (ps_drqn.py:358-374);
  next states are the in-episode shift (clamped), equivalent to the
  reference's flat shift under the mask;
* Double-DQN sequence targets with terminal cut (ps_drqn.py:233-271), the
  masked TD loss, Adam behind a global-norm clip at 10.0
  (ps_drqn.py:82-85);
* inference carries a per-agent GRU hidden state across slots
  (ps_drqn.py:168-231).

Random draws are taken in as tensors: ``window_draws`` turns Gumbel noise
and uniforms into (episode, start) indices -- the categorical draw over
log-lengths and the uniform start the JAX package takes -- and
``sample_windows`` is deterministic given them.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

# the learner (params, target, Adam) and its clipped train loop are
# PS-DQN's; init_learner is re-exported for train/ps_loop's per-algo module
from diral_tpu_torch.agents.dqn import (PSDQNLearner, eps_greedy_pure,  # noqa: F401
                                        init_learner, train_steps)
from diral_tpu_torch.config import AgentConfig
from diral_tpu_torch.models import qnets

MAX_GRAD_NORM = 10.0  # ps_drqn.py:84


@dataclass
class EpisodeReplay:
    """Fixed-capacity episode store; ``ptr`` and ``count`` are host
    integers, the buffers are updated in place."""

    states: torch.Tensor     # [E, L, D]
    actions: torch.Tensor    # [E, L] int32
    rewards: torch.Tensor    # [E, L]
    terminals: torch.Tensor  # [E, L] bool
    lengths: torch.Tensor    # [E] int32
    ptr: int = 0
    count: int = 0

    @property
    def capacity(self) -> int:
        return self.states.shape[0]

    @classmethod
    def create(cls, capacity: int, max_len: int, state_dim: int,
               dtype=torch.float32, device=None) -> "EpisodeReplay":
        def z(*shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=device)
        return cls(states=z(capacity, max_len, state_dim),
                   actions=z(capacity, max_len, dt=torch.int32),
                   rewards=z(capacity, max_len),
                   terminals=z(capacity, max_len, dt=torch.bool),
                   lengths=z(capacity, dt=torch.int32))

    def add_episode(self, states, actions, rewards, terminated: bool,
                    length: int) -> None:
        """states [L, D] zero-padded, ``length`` filled steps; the terminal
        flag sits on the last filled step iff the episode terminated
        (ps_drqn.py:290-300)."""
        dev = self.states.device
        self.add_episodes_batch(
            states[None], actions[None], rewards[None],
            torch.tensor([bool(terminated)], device=dev),
            torch.tensor([int(length)], dtype=torch.int32, device=dev))

    def add_episodes_batch(self, states, actions, rewards, terminated,
                           lengths) -> None:
        """A episodes at consecutive ring slots (ps_drqn.py:273-300):
        states [A, L, D], actions / rewards [A, L], terminated [A] bool,
        lengths [A] int.  A <= capacity."""
        A = lengths.shape[0]
        E, L, _ = self.states.shape
        if A > E:
            raise ValueError(f"{A} episodes into a ring of {E}")
        dev = self.states.device
        idx = (self.ptr + torch.arange(A, device=dev)) % E
        lengths = lengths.to(dev, torch.int32)
        term = ((torch.arange(L, device=dev)[None, :] == lengths[:, None] - 1)
                & terminated.to(dev, torch.bool)[:, None])
        self.states[idx] = states.to(self.states.dtype)
        self.actions[idx] = actions.to(torch.int32)
        self.rewards[idx] = rewards.to(self.rewards.dtype)
        self.terminals[idx] = term
        self.lengths[idx] = lengths
        self.ptr = (self.ptr + A) % E
        self.count = min(self.count + A, E)

    def episode_logits(self):
        """log of the filled episodes' lengths (1e-9 for empty slots):
        the categorical draw's logits (ps_drqn.py:329-331,354)."""
        valid = torch.arange(self.capacity, device=self.lengths.device) < self.count
        w = torch.where(valid, self.lengths, 0).to(torch.float32)
        return torch.log(torch.clamp(w, min=1e-9))

    def window_draws(self, gumbel, uniform):
        """(episode [batch], start [batch]) from Gumbel noise [batch, E]
        (categorical over ``episode_logits``, by the Gumbel-max rule) and
        uniforms [batch] (start uniform in [0, max(length, 1)))."""
        eps_idx = torch.argmax(gumbel + self.episode_logits(), dim=-1)
        length = torch.clamp(self.lengths[eps_idx], min=1)
        start = torch.floor(uniform * length).long()
        return eps_idx, torch.minimum(start, length.long() - 1)

    def sample_windows(self, eps_idx, start, unroll: int) -> dict:
        """The windows of episodes ``eps_idx`` from steps ``start``
        (ps_drqn.py:354-374): [batch, unroll, ...] arrays and the mask."""
        E, L, D = self.states.shape
        batch = eps_idx.shape[0]
        dev = self.states.device
        length = self.lengths[eps_idx].long()
        real = torch.clamp(length - start, max=unroll)
        offs = torch.arange(unroll, device=dev)[None, :]
        pos = start[:, None] + offs                        # [batch, unroll]
        inb = offs < real[:, None]
        pos_c = torch.clamp(pos, max=L - 1)
        rows = eps_idx[:, None]
        zero = torch.zeros((), dtype=self.states.dtype, device=dev)
        states = torch.where(inb[..., None], self.states[rows, pos_c], zero)
        actions = torch.where(inb, self.actions[rows, pos_c], 0)
        rewards = torch.where(inb, self.rewards[rows, pos_c],
                              torch.zeros((), dtype=self.rewards.dtype,
                                          device=dev))
        terminals = inb & self.terminals[rows, pos_c]
        npos = torch.clamp(pos + 1, max=L - 1)
        next_states = torch.where(inb[..., None], self.states[rows, npos], zero)
        mask = inb.to(states.dtype)
        bidx = torch.arange(batch, device=dev)
        last_slot = torch.clamp(real - 1, min=0)
        last_term = terminals[bidx, last_slot]
        mask[bidx, last_slot] = torch.where(last_term, mask[bidx, last_slot],
                                            zero)
        return {"states": states, "actions": actions, "rewards": rewards,
                "terminals": terminals, "next_states": next_states,
                "mask": mask}


def init_hidden(cfg: AgentConfig, num_agents: int, dtype=torch.float32,
                device=None):
    return torch.zeros((num_agents, cfg.network.layers[-1]), dtype=dtype,
                       device=device)


def infer_actions(learner: PSDQNLearner, obs, hidden, eps, draw,
                  rand_actions, cfg: AgentConfig):
    """One slot of carried-hidden eps-greedy inference for all agents
    (ps_drqn.py:195-231). obs [M, D], hidden [M, H] -> (actions [M],
    new hidden)."""
    with torch.no_grad():
        q, new_h = qnets.ps_drqn_apply_step(learner.params, obs, hidden, cfg)
    return eps_greedy_pure(q, eps, draw, rand_actions), new_h


def td_targets(learner: PSDQNLearner, batch, cfg: AgentConfig):
    """Double-DQN over [batch, unroll] sequences (ps_drqn.py:233-271):
    zero initial hidden per window, flat [batch*unroll] targets."""
    with torch.no_grad():
        ns = batch["next_states"]
        tq, _ = qnets.ps_drqn_apply_seq(learner.target_params, ns, cfg)
        if cfg.network.use_double:
            oq, _ = qnets.ps_drqn_apply_seq(learner.params, ns, cfg)
            next_v = torch.gather(tq, 1, torch.argmax(oq, dim=1)[:, None])[:, 0]
        else:
            next_v = tq.max(dim=1).values
        r = batch["rewards"].reshape(-1)
        return torch.where(batch["terminals"].reshape(-1), r,
                           r + cfg.gamma * next_v)


def loss_fn(params, batch, targets, cfg: AgentConfig):
    q, _ = qnets.ps_drqn_apply_seq(params, batch["states"], cfg)
    acts = batch["actions"].reshape(-1).long()
    chosen = torch.gather(q, 1, acts[:, None])[:, 0]
    td = torch.square(targets - chosen)
    m = batch["mask"].reshape(-1)
    return torch.sum(td * m) / torch.clamp(torch.sum(m), min=1.0)


def train(learner: PSDQNLearner, replay: EpisodeReplay, draws,
          cfg: AgentConfig):
    """One window-batch gradient step per (eps_idx, start) pair of
    ``draws`` (ps_drqn.py:353-398)."""
    return train_steps(
        learner, (replay.sample_windows(e, s, cfg.unroll_step)
                  for e, s in draws), td_targets, loss_fn, MAX_GRAD_NORM, cfg)
