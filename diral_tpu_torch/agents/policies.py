"""Exploration policies (diral_tpu/agents/policies.py; reference
algorithms/policies.py: Random/Greedy/EpsilonGreedy/Softmax/Boltzman).

Schedule state is small and advances on slot indices the host knows, so
it lives on the host: ``EpsGreedyState`` and ``BoltzmanState`` hold numpy
float32 scalars (float32 as in the JAX package, policies.py:33-36) and
plain ints, and no slot waits on the device to read them.

Each random function is a pure part that takes its draws as tensors (so
it can be held against the JAX package on the same draws) and a thin
wrapper that draws them from a ``torch.Generator``.  Actions are batched
over any leading shape: qvalues [..., A] -> actions [...] int64.

The driver's slot-indexed mode switch (main_test.py:127-136: uniform
random before ``explore`` slots, the learned policy until ``greedy``
slots, pure greedy after) is ``driver_mode_actions``.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import numpy as np
import torch

EPS_FLOOR = 0.001  # policies.py:62-63


def greedy_action(qvalues):
    """First-index argmax, matching np.argmax tie-breaking
    (policies.py:24-31). [..., A] -> [...] int64."""
    return torch.argmax(qvalues, dim=-1)


def random_action(generator, shape, num_actions: int, device=None):
    """Uniform action ids in [0, num_actions)."""
    return torch.randint(0, num_actions, shape, generator=generator,
                         device=device)


def _scalar(v):
    """A schedule value for a comparison: tensors keep their dtype (so
    torch promotes as JAX does), host scalars become Python floats holding
    their exact value."""
    return v if isinstance(v, torch.Tensor) else float(v)


# ---------------------------------------------------------------------------
# Epsilon-greedy
# ---------------------------------------------------------------------------


@dataclass
class EpsGreedyState:
    """Carried epsilon schedule: decays once per episode change
    (policies.py:45-63)."""

    eps: np.float32
    episode: int = 0   # last episode the decay fired for


def eps_greedy_init(eps_init: float) -> EpsGreedyState:
    return EpsGreedyState(eps=np.float32(eps_init), episode=0)


def eps_greedy_update(state: EpsGreedyState, episode: int, eps_decay: float,
                      eps_min: float = EPS_FLOOR) -> EpsGreedyState:
    """Multiply-decay with floor, fired when the episode counter advances.
    Float32 arithmetic, as ``state.eps * eps_decay`` is in JAX."""
    if episode <= state.episode:
        return state
    eps = np.maximum(state.eps * np.float32(eps_decay), np.float32(eps_min))
    return replace(state, eps=np.float32(eps), episode=int(episode))


def eps_greedy_action_pure(qvalues, eps, draw, rand_actions):
    """Greedy where ``draw > eps``, else ``rand_actions``
    (policies.py:45-54).  draw: [...] uniforms in [0, 1)."""
    return torch.where(draw > _scalar(eps), greedy_action(qvalues),
                       rand_actions)


def eps_greedy_action(generator, qvalues, eps):
    shape, a = qvalues.shape[:-1], qvalues.shape[-1]
    draw = torch.rand(shape, generator=generator, device=qvalues.device)
    rand = random_action(generator, shape, a, qvalues.device)
    return eps_greedy_action_pure(qvalues, eps, draw, rand)


# ---------------------------------------------------------------------------
# Softmax (temperature-annealed)
# ---------------------------------------------------------------------------


def softmax_temperature_schedule(temperature: float,
                                 episodes: int) -> np.ndarray:
    """Geometric anneal 1.0 -> temperature over the first 2/3 of episodes,
    then constant (policies.py:86-90)."""
    warm = int(episodes * 2.0 / 3)
    return np.concatenate(
        [np.geomspace(1.0, temperature, warm),
         np.repeat(temperature, episodes - warm)]).astype(np.float32)


def softmax_temperature(schedule: np.ndarray, episode: int,
                        temperature: float) -> float:
    """T[episode]; out-of-schedule episodes fall back to the base
    temperature (policies.py:92-101), as a float32 value."""
    if episode < schedule.shape[0]:
        return float(schedule[max(episode, 0)])
    return float(np.float32(temperature))


def softmax_action_pure(qvalues, temp: float, gumbel):
    """Sample from softmax(Q / temp) with the Gumbel-max trick: ``gumbel``
    [..., A] standard Gumbel noise (what jax.random.categorical adds)."""
    return torch.argmax(gumbel + qvalues / temp, dim=-1)


def gumbel_noise(generator, shape, dtype, device=None):
    """Standard Gumbel draws, -log(-log(U)) with U in [tiny, 1)."""
    u = torch.rand(shape, generator=generator, dtype=dtype, device=device)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(dtype).tiny)))


def softmax_action(generator, qvalues, schedule, episode: int,
                   temperature: float):
    """(actions, temperature used)."""
    temp = softmax_temperature(schedule, episode, temperature)
    gumbel = gumbel_noise(generator, qvalues.shape, qvalues.dtype,
                          qvalues.device)
    return softmax_action_pure(qvalues, temp, gumbel), temp


# ---------------------------------------------------------------------------
# Boltzmann
# ---------------------------------------------------------------------------


@dataclass
class BoltzmanState:
    """Carried beta, annealed every 50 slots below slot 5000
    (policies.py:153-156)."""

    beta: np.float32


def boltzman_init(beta: float) -> BoltzmanState:
    return BoltzmanState(beta=np.float32(beta))


def boltzman_update(state: BoltzmanState, time_slot: int) -> BoltzmanState:
    if time_slot % 50 == 0 and time_slot < 5000:
        return BoltzmanState(beta=np.float32(state.beta - np.float32(0.001)))
    return state


def boltzman_action_pure(qvalues, state: BoltzmanState, time_slot: int,
                         draw, rand_actions, *, explore_start: float,
                         explore_stop: float, decay_rate: float,
                         alpha: float):
    """Random where ``draw`` falls under the exponentially decaying
    exploration probability, else the argmax of the alpha-mixed Boltzmann
    distribution (policies.py:144-178)."""
    a = qvalues.shape[-1]
    explore_p = explore_stop + (explore_start - explore_stop) * math.exp(
        -decay_rate * time_slot)
    eb = torch.exp(float(state.beta) * qvalues)
    prob = (1.0 - alpha) * eb / eb.sum(dim=-1, keepdim=True) + alpha / a
    return torch.where(draw < explore_p, rand_actions, greedy_action(prob))


def boltzman_action(generator, qvalues, state: BoltzmanState, time_slot: int,
                    **kw):
    shape, a = qvalues.shape[:-1], qvalues.shape[-1]
    draw = torch.rand(shape, generator=generator, device=qvalues.device)
    rand = random_action(generator, shape, a, qvalues.device)
    return boltzman_action_pure(qvalues, state, time_slot, draw, rand, **kw)


# ---------------------------------------------------------------------------
# Driver-mode composition
# ---------------------------------------------------------------------------


def driver_mode_actions_pure(qvalues, eps_state: EpsGreedyState,
                             time_slot: int, explore_until: int,
                             greedy_after: int, rand, draw, eps_rand):
    """The main-loop mode switch (main_test.py:127-136): ``rand`` while
    t < explore_until, eps-greedy (``draw``, ``eps_rand``) while
    t < greedy_after, greedy after."""
    if time_slot < explore_until:
        return rand
    if time_slot < greedy_after:
        return eps_greedy_action_pure(qvalues, eps_state.eps, draw, eps_rand)
    return greedy_action(qvalues)


def driver_mode_actions(generator, qvalues, eps_state: EpsGreedyState,
                        time_slot: int, explore_until: int,
                        greedy_after: int):
    shape, a = qvalues.shape[:-1], qvalues.shape[-1]
    if time_slot < explore_until:
        return random_action(generator, shape, a, qvalues.device)
    if time_slot < greedy_after:
        return eps_greedy_action(generator, qvalues, eps_state.eps)
    return greedy_action(qvalues)
