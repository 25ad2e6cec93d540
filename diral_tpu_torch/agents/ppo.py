"""Parameter-shared PPO learner (diral_tpu/agents/ppo.py; reference
algorithms/ps_ppo.py).

Reference semantics, as the JAX package keeps them:

* clipped surrogate over a frozen old-policy snapshot taken at the start
  of every update (ps_ppo.py:61-77,97);
* combined loss = actor + 0.5 * critic + entropy bonus with the hardcoded
  e_coef = 0.01 (ps_ppo.py:85-90) and the hardcoded combined-optimizer lr
  3e-4 (ps_ppo.py:90); the config's ``a_lr`` / ``c_lr`` are dead knobs
  there and here;
* ``update_step`` epochs per update batch (ps_ppo.py:104-108);
* advantages: GAE (``gae``) or empirical return - V(s)
  (``discounted_returns``, ps_ppo.py:56,99), standardised per update batch
  with the population std (ddof 0, as ``jnp.std``).

The optimizer is ``torch.optim.Adam`` with optax.adam's constants; the
two order their arithmetic differently, so the port matches the JAX
learner to a tolerance, not bit for bit (agents/drqn.py).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from diral_tpu_torch.config import AgentConfig
from diral_tpu_torch.models import actor_critic as ac
from diral_tpu_torch.models.qnets import ParamTree

PPO_COMBINED_LR = 3e-4   # ps_ppo.py:90
PPO_E_COEF = 0.01        # ps_ppo.py:85


@dataclass
class PPOLearner:
    params: ParamTree        # trained
    old_params: ParamTree    # the snapshot of the last update (no grad)
    opt: torch.optim.Adam


def make_optimizer(params: ParamTree) -> torch.optim.Adam:
    return torch.optim.Adam(params.parameters(), lr=PPO_COMBINED_LR)


def init_learner(params: ParamTree) -> PPOLearner:
    return PPOLearner(params=params,
                      old_params=copy.deepcopy(params).requires_grad_(False),
                      opt=make_optimizer(params))


def choose_actions(learner: PPOLearner, x, gumbel, cfg: AgentConfig):
    """Sample from the softmax policy (ps_ppo.py:140-144) by the Gumbel-max
    rule, as ``jax.random.categorical`` does: argmax(gumbel + logits).
    x: [M, ...], gumbel: [M, A] -> actions [M] int64."""
    with torch.no_grad():
        logits = ac.ppo_policy_logits(learner.params, x, cfg)
        return torch.argmax(gumbel + logits, dim=-1)


def values(learner: PPOLearner, x, cfg: AgentConfig):
    with torch.no_grad():
        return ac.ppo_value(learner.params, x, cfg)


def gae(rewards, vals, last_value, gamma: float, lam: float = 0.95):
    """Generalized advantage estimation over the time axis.
    rewards, vals: [T, ...]; last_value: [...] bootstrap.  Returns
    (advantages [T, ...], returns [T, ...])."""
    next_vals = torch.cat([vals[1:], last_value[None]], dim=0)
    deltas = rewards + gamma * next_vals - vals
    adv = torch.zeros_like(last_value)
    advs = []
    for t in reversed(range(deltas.shape[0])):
        adv = deltas[t] + gamma * lam * adv
        advs.append(adv)
    advs = torch.stack(advs[::-1])
    return advs, advs + vals


def discounted_returns(rewards, last_value, gamma: float):
    """Plain discounted return bootstrap (the reference driver's scheme)."""
    ret = last_value
    rets = []
    for t in reversed(range(rewards.shape[0])):
        ret = rewards[t] + gamma * ret
        rets.append(ret)
    return torch.stack(rets[::-1])


def ppo_loss(params, old_params, batch, cfg: AgentConfig,
             e_coef: float = PPO_E_COEF, normalize_adv: bool = True):
    """Combined clipped-surrogate + value + entropy loss (ps_ppo.py:61-90).
    Returns (loss, (actor loss, critic loss, mean entropy)).
    ``normalize_adv`` standardises the advantages per batch (absent from
    the reference, ps_ppo.py:56; the JAX package's default)."""
    states = batch["states"]
    logits = ac.ppo_policy_logits(params, states, cfg)
    with torch.no_grad():
        old_logits = ac.ppo_policy_logits(old_params, states, cfg)
    logp = F.log_softmax(logits, dim=-1)
    old_logp = F.log_softmax(old_logits, dim=-1)
    a = batch["actions"].long()[:, None]
    ratio = torch.exp(torch.gather(logp, 1, a)[:, 0]
                      - torch.gather(old_logp, 1, a)[:, 0])
    adv = batch["advantages"]
    if normalize_adv:
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
    surr = ratio * adv
    clipped = torch.clamp(ratio, 1.0 - cfg.eps_clip, 1.0 + cfg.eps_clip) * adv
    aloss = -torch.mean(torch.minimum(surr, clipped))

    v = ac.ppo_value(params, states, cfg)
    closs = torch.mean(torch.square(batch["returns"] - v))

    probs = F.softmax(logits, dim=-1)
    logp_clip = torch.log(torch.clamp(probs, 1e-10, 1.0))  # ps_ppo.py:86
    entropy = -torch.sum(probs * logp_clip, dim=-1)
    eloss = -torch.sum(torch.mean(entropy, dim=-1)) * e_coef
    return aloss + 0.5 * closs + eloss, (aloss, closs, entropy.mean())


def update(learner: PPOLearner, batch, cfg: AgentConfig):
    """One PPO update (ps_ppo.py:95-108): snapshot the old policy, then
    ``update_step`` combined-loss Adam epochs over the whole batch
    {"states" [M, ...], "actions" [M], "advantages" [M], "returns" [M]}.
    Updates ``learner`` in place; returns the last epoch's metrics as
    0-dim tensors."""
    with torch.no_grad():
        for o, p in zip(learner.old_params.parameters(),
                        learner.params.parameters()):
            o.copy_(p)
    metrics = None
    for _ in range(cfg.update_step):
        loss, (aloss, closs, ent) = ppo_loss(learner.params,
                                             learner.old_params, batch, cfg)
        learner.opt.zero_grad(set_to_none=True)
        loss.backward()
        learner.opt.step()
        metrics = {"loss": loss.detach(), "actor_loss": aloss.detach(),
                   "critic_loss": closs.detach(), "entropy": ent.detach()}
    return learner, metrics
