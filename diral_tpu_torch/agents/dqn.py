"""Parameter-shared feedforward DQN learner (diral_tpu/agents/dqn.py;
reference algorithms/ps_dqn.py ``DeepQNetwork``), the episode-ingesting,
mask/terminal-aware variant.

Semantics, as the JAX package reconstructs them from the reference:

* episode ingest with the mask/terminal convention: mask all ones, the
  last step masked out unless the episode terminated (ps_dqn.py:258-294);
* Double-DQN target with terminal cut: where(terminal, r, r + gamma *
  next_v) (ps_dqn.py:237-256);
* masked TD loss sum(td^2 * mask) / max(sum(mask), 1) (ps_dqn.py:100-104);
* Adam behind a global-norm gradient clip at 5.0 (ps_dqn.py:107-111),
  the clip written with optax's arithmetic (``clip_by_global_norm``);
* ``n_batches`` gradient steps per train call; the target syncs AFTER
  the step whenever ct % target_update == 0, ct = 0 included
  (ps_dqn.py:324-349);
* eps-greedy inference: random where U < eps (ps_dqn.py:200-235).

Random draws (eps-greedy uniforms and random actions, replay indices) are
taken in as tensors.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import torch

from diral_tpu_torch.agents.replay import TransitionReplay
from diral_tpu_torch.config import AgentConfig
from diral_tpu_torch.models import qnets
from diral_tpu_torch.models.qnets import ParamTree

MAX_GRAD_NORM = 5.0  # ps_dqn.py:110


@dataclass
class PSDQNLearner:
    params: ParamTree         # online net (trained)
    target_params: ParamTree  # target net (no gradients)
    opt: torch.optim.Adam


def init_learner(params: ParamTree, cfg: AgentConfig) -> PSDQNLearner:
    return PSDQNLearner(
        params=params,
        target_params=copy.deepcopy(params).requires_grad_(False),
        opt=torch.optim.Adam(params.parameters(), lr=cfg.learning_rate))


def clip_by_global_norm(params, max_norm: float) -> None:
    """optax.clip_by_global_norm on the ``.grad`` of ``params``, in place:
    g_norm = sqrt(sum of every squared entry); g stays where g_norm <
    max_norm, else becomes (g / g_norm) * max_norm.  (PyTorch's
    ``clip_grad_norm_`` scales by max_norm / (norm + 1e-6), another
    number.)  No host sync: the choice is a ``torch.where``."""
    grads = [p.grad for p in params if p.grad is not None]
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    keep = g_norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / g_norm) * max_norm))


def sync_target(learner) -> None:
    with torch.no_grad():
        for t, p in zip(learner.target_params.parameters(),
                        learner.params.parameters()):
            t.copy_(p)


def eps_greedy_pure(q, eps, draw, rand_actions):
    """Random where ``draw < eps``, else the first-index argmax
    (ps_dqn.py:200-235). q [M, A], draw [M], rand_actions [M] -> [M]."""
    return torch.where(draw < float(eps), rand_actions.long(),
                       torch.argmax(q, dim=1))


def infer_actions(learner: PSDQNLearner, obs, eps, draw, rand_actions,
                  cfg: AgentConfig):
    """Batched eps-greedy. obs [M, D] -> actions [M] int64."""
    with torch.no_grad():
        q = qnets.ps_dqn_apply(learner.params, obs, cfg)
    return eps_greedy_pure(q, eps, draw, rand_actions)


def add_episode(replay: TransitionReplay, states, actions, rewards,
                terminated: bool) -> None:
    """One agent-episode stream [L, ...] (ps_dqn.py:275-289)."""
    add_episodes_batch(replay, states[None], actions[None], rewards[None],
                       torch.tensor([bool(terminated)],
                                    device=replay.states.device))


def add_episodes_batch(replay: TransitionReplay, states, actions, rewards,
                       terminated) -> None:
    """One ``put`` of A agent-episodes of L steps (states [A, L, D],
    actions / rewards [A, L], terminated [A] bool), agent-major -- the
    reference's per-agent ``_add_to_replay_buffer`` loop
    (ps_dqn.py:258-294): terminals all False but a terminated episode's
    last step, and the last step's mask 0 where the episode did NOT
    terminate (its ring successor is another agent's first step)."""
    A, L = actions.shape
    dev = replay.states.device
    last = torch.arange(A * L, device=dev) % L == L - 1
    term_row = terminated.to(dev, torch.bool).repeat_interleave(L)
    term = last & term_row
    mask = torch.where(last & ~term_row, 0.0, 1.0).to(replay.masks.dtype)
    replay.put(states.reshape(A * L, -1), actions.reshape(A * L),
               rewards.reshape(A * L), term, mask)


def td_targets(learner: PSDQNLearner, batch, cfg: AgentConfig):
    """Double-DQN with terminal cut (ps_dqn.py:237-256); no gradient."""
    with torch.no_grad():
        ns = batch["next_states"]
        tq = qnets.ps_dqn_apply(learner.target_params, ns, cfg)
        if cfg.network.use_double:
            oq = qnets.ps_dqn_apply(learner.params, ns, cfg)
            next_v = torch.gather(tq, 1, torch.argmax(oq, dim=1)[:, None])[:, 0]
        else:
            next_v = tq.max(dim=1).values
        r = batch["rewards"]
        return torch.where(batch["terminals"], r, r + cfg.gamma * next_v)


def loss_fn(params, batch, targets, cfg: AgentConfig):
    q = qnets.ps_dqn_apply(params, batch["states"], cfg)
    chosen = torch.gather(q, 1, batch["actions"].long()[:, None])[:, 0]
    td = torch.square(targets - chosen)
    m = batch["masks"]
    return torch.sum(td * m) / torch.clamp(torch.sum(m), min=1.0)


def apply_step(learner, loss, max_norm: float):
    """Backward, the global-norm clip, one Adam step (in place)."""
    learner.opt.zero_grad(set_to_none=True)
    loss.backward()
    clip_by_global_norm(learner.params.parameters(), max_norm)
    learner.opt.step()


def train_steps(learner: PSDQNLearner, batches, targets_fn, loss, max_norm,
                cfg: AgentConfig):
    """One clipped Adam step per batch of ``batches``; the target syncs
    after each step with ct % target_update == 0, ct = 0 included
    (ps_dqn.py:347-349, ps_drqn.py:353-398).  Returns the mean loss (0-dim
    tensor); ``learner`` is updated in place."""
    losses = []
    for ct, batch in enumerate(batches):
        targets = targets_fn(learner, batch, cfg)
        value = loss(learner.params, batch, targets, cfg)
        apply_step(learner, value, max_norm)
        if ct % cfg.target_update == 0:
            sync_target(learner)
        losses.append(value.detach())
    return torch.stack(losses).mean()


def train(learner: PSDQNLearner, replay: TransitionReplay, indices,
          cfg: AgentConfig):
    """``len(indices)`` gradient steps, step j on the rows
    ``indices[j]`` [batch] (ps_dqn.py:324-349)."""
    return train_steps(learner, (replay.sample(idx) for idx in indices),
                       td_targets, loss_fn, MAX_GRAD_NORM, cfg)
