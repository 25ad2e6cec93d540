"""Parameter-shared Double-DQN / DRQN learner (diral_tpu/agents/drqn.py;
reference algorithms/drl_drqn.py ``DRQN``).

One learner serves all agents: an online ``qnets.DRQN``, a target copy
(no gradients) and ``torch.optim.Adam``.  Semantics:

* Double-DQN target: online-net argmax on next states, target-net gather
  (drl_drqn.py:267-292); target = last-step window reward + gamma * next_v,
  never differentiated.
* Optional hysteretic TD scaling: negative TD errors / 10
  (drl_drqn.py:76-80).
* ``n_batch`` gradient steps per train call on rows all drawn before the
  first step, then a target sync when (t + 1) % target_update == 0
  (drl_drqn.py:199-265).

``optax.adam`` and ``torch.optim.Adam`` order their arithmetic
differently (torch divides the bias-corrected moments in another order),
so the port matches the JAX learner to a tolerance, not bit for bit.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import torch

from diral_tpu_torch.config import AgentConfig
from diral_tpu_torch.models import qnets
from diral_tpu_torch.utils import spans


@dataclass
class DRQNLearner:
    params: qnets.DRQN          # online net (trained)
    target_params: qnets.DRQN   # target net (no gradients)
    opt: torch.optim.Adam


def make_optimizer(net: qnets.DRQN, cfg: AgentConfig) -> torch.optim.Adam:
    return torch.optim.Adam(net.parameters(), lr=cfg.learning_rate)


def init_learner(net: qnets.DRQN, cfg: AgentConfig) -> DRQNLearner:
    """Learner around ``net``; the target starts as a copy of it."""
    target = copy.deepcopy(net).requires_grad_(False)
    return DRQNLearner(params=net, target_params=target,
                       opt=make_optimizer(net, cfg))


def qvalues_all_agents(learner: DRQNLearner, history, cfg: AgentConfig):
    """Q for every agent in one forward (drqn.py:53-63): history [T, N, D]
    (the reference's history deque, main_test.py:125) on the LSTM path --
    through ``lstm_impl``, so K1 on a CUDA device -- or [N, D] on the MLP
    path.  Returns [N, A]."""
    with torch.no_grad():
        x = history.transpose(0, 1) if cfg.network.use_lstm_input else history
        return qnets.drqn_apply(learner.params, x, cfg)


def _last(x):
    return x[:, -1] if x.dim() == 2 else x


def td_targets(learner: DRQNLearner, rewards, next_states, cfg: AgentConfig):
    """Double-DQN (or max) targets (drl_drqn.py:267-292); no gradient.  The
    online and target forwards on next_states share one K4 launch on the
    kernel path (qnets.drqn_apply_dual)."""
    with torch.no_grad():
        if cfg.network.use_double:
            oq, tq = qnets.drqn_apply_dual(learner.params,
                                           learner.target_params,
                                           next_states, cfg)
            act = torch.argmax(oq, dim=1)
            next_v = torch.gather(tq, 1, act[:, None])[:, 0]
        else:
            tq = qnets.drqn_apply(learner.target_params, next_states, cfg)
            next_v = tq.max(dim=1).values
        return _last(rewards) + cfg.gamma * next_v


def _td_loss(q, actions, targets, cfg: AgentConfig):
    """Squared TD error with optional hysteretic scaling (drl_drqn.py:76-80)."""
    acts = _last(actions).long()
    chosen = torch.gather(q, 1, acts[:, None])[:, 0]
    h = chosen - targets
    if cfg.hysteretic:
        h = torch.where(h < 0, h / 10.0, h)
    return torch.square(h).mean()


def loss_fn(params, states, actions, targets, cfg: AgentConfig):
    return _td_loss(qnets.drqn_apply(params, states, cfg), actions, targets,
                    cfg)


def _step(learner: DRQNLearner, loss):
    learner.opt.zero_grad(set_to_none=True)
    loss.backward()
    learner.opt.step()
    return loss.detach()


def train_on_packed(learner: DRQNLearner, states, actions, rewards,
                    next_states, cfg: AgentConfig):
    """One gradient step on an already-repacked row batch; states /
    next_states are [NB, T, D] or flat [NB, T*Dp] windows.  Returns the
    loss (a 0-dim tensor; the step updates ``learner`` in place)."""
    targets = td_targets(learner, rewards, next_states, cfg)
    return _step(learner, loss_fn(learner.params, states, actions, targets,
                                  cfg))


def windows_loss(learner: DRQNLearner, windows, actions, rewards,
                 cfg: AgentConfig):
    """The TD loss on COMBINED flat (T+1)-step window rows
    [NB, (T+1)*Dp]: the loss forward and both Double-DQN target forwards
    in one triple pass (qnets.drqn_apply_triple -> K2, backward K3)."""
    q_s, q_na, q_nb = qnets.drqn_apply_triple(
        learner.params, learner.target_params, windows, cfg)
    with torch.no_grad():
        if cfg.network.use_double:
            act = torch.argmax(q_na, dim=1)
            next_v = torch.gather(q_nb, 1, act[:, None])[:, 0]
        else:
            next_v = q_nb.max(dim=1).values
        targets = _last(rewards) + cfg.gamma * next_v
    return _td_loss(q_s, actions, targets, cfg)


def train_on_windows(learner: DRQNLearner, windows, actions, rewards,
                     cfg: AgentConfig):
    """One gradient step on ``windows_loss``; semantics equal
    ``train_on_packed`` on the sliced arrays."""
    return _step(learner, windows_loss(learner, windows, actions, rewards,
                                       cfg))


def sync_target(learner: DRQNLearner) -> None:
    with torch.no_grad():
        for t, p in zip(learner.target_params.parameters(),
                        learner.params.parameters()):
            t.copy_(p)


def train(learner: DRQNLearner, rows: dict, time_step: int,
          cfg: AgentConfig):
    """The reference ``train`` call (drl_drqn.py:199-265): ``n_batch``
    gradient steps on pre-drawn row batches (loop.sample_window_rows_many:
    ``windows`` on the LSTM path, ``states`` / ``next_states`` otherwise,
    each with a leading [n_batch] axis), then the target sync when
    (time_step + 1) % target_update == 0.  Returns the last step's loss."""
    loss = None
    for k in range(cfg.n_batch):
        with spans.span("learner.step"):
            loss = _train_step(learner, rows, k, cfg)
    if (time_step + 1) % cfg.target_update == 0:
        with spans.span("learner.sync"):
            sync_target(learner)
    return loss


def _train_step(learner: DRQNLearner, rows: dict, k: int, cfg: AgentConfig):
    """Gradient step ``k`` of ``train`` on its pre-drawn rows."""
    a, r = rows["actions"][k], rows["rewards"][k]
    if "windows" in rows:
        return train_on_windows(learner, rows["windows"][k], a, r, cfg)
    s, ns = rows["states"][k], rows["next_states"][k]
    if not cfg.network.use_lstm_input:
        # rows carry one padded flat step; the MLP consumes [NB, D]
        D = learner.params.fc1.w.shape[0]
        s, ns, a, r = s[:, :D], ns[:, :D], a[:, -1], r[:, -1]
    return train_on_packed(learner, s, a, r, ns, cfg)
