"""Semi-Persistent Scheduling (SPS), the 5G mode-4 baseline
(diral_tpu/agents/sps.py; reference algorithms/v2x_sps.py:24-99),
batched over [B, N] agents.

* counter > 0 -> repeat the previous subframe, decrement (v2x_sps.py:86-90);
* on expiry -> counter ~ U{5, 16}; keep with p = 0.8, else reselect
  (v2x_sps.py:92-98);
* reselection -> threshold grown by +3 dB until >= max(C // 5, 1)
  candidates other than the previous action, stable ascending-RSSI rank,
  uniform pick among the first min(max(C // 5, 1), |candidates|)
  (v2x_sps.py:36-74).

Each random function is a pure part that takes its uniform draws as
tensors (so it can be held against the JAX package on the same
shortlists) and a thin wrapper that draws them from a ``torch.Generator``.
``toy_rssi`` is the free-space sensing proxy of the toy world.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from diral_tpu_torch.ops.distance import pairwise_distances

NOISE_FLOOR_DB = -117.0   # idle-channel sensing level (v2x_sps.py:20 comment)
RX_BUSY_DB = -90.0        # reference scale: active resources sense much hotter
_INV_LN10 = 0.4342944819032518  # 1 / ln(10), as jnp.log10 multiplies by it


@dataclass
class SPSState:
    prev_action: torch.Tensor  # [B, N] int64
    counter: torch.Tensor      # [B, N] int64


def sps_init(generator: torch.Generator, num_envs: int, num_users: int,
             num_channels: int, device=None) -> SPSState:
    shape = (num_envs, num_users)
    # txSubframe = randint(0, C) inclusive in the reference (v2x_sps.py:13)
    # -- clipped into range
    prev = torch.randint(0, num_channels + 1, shape, generator=generator,
                         device=device).clamp(max=num_channels - 1)
    counter = torch.randint(5, 16, shape, generator=generator, device=device)
    return SPSState(prev_action=prev, counter=counter)


def resource_shortlist(rssi, prev_action, rssi_threshold: float):
    """Candidate ranking of v2x_sps.py:24-74.  rssi: [..., C], prev_action:
    [...].  Returns (order [..., C], shortlist_len [...]): the shortlist is
    ``order[..., :shortlist_len]``.  Requires C >= 2."""
    c = rssi.shape[-1]
    min_sa = max(c // 5, 1)   # 20% of the window, floored at 1
    not_prev = torch.arange(c, device=rssi.device) != prev_action[..., None]

    def count(thr):
        return (not_prev & (rssi < thr[..., None])).sum(dim=-1)

    top = float(rssi.max())
    if not math.isfinite(top):
        raise ValueError("SPS sensing values must be finite")
    # The +3 dB relaxation loop (a while_loop in the JAX package) runs a
    # bound of steps every agent shares: past the largest RSSI every other
    # resource qualifies, and an agent that has enough stops growing.
    thr = torch.full(prev_action.shape, rssi_threshold, dtype=rssi.dtype,
                     device=rssi.device)
    for _ in range(max(0, math.floor((top - rssi_threshold) / 3.0) + 2)):
        thr = torch.where(count(thr) < min_sa, thr + 3.0, thr)
    candidates = not_prev & (rssi < thr[..., None])
    masked = torch.where(candidates, rssi, torch.full_like(rssi, math.inf))
    order = torch.argsort(masked, dim=-1, stable=True)
    return order, torch.clamp(candidates.sum(dim=-1), max=min_sa)


def choose_new_resource(rssi, prev_action, rssi_threshold: float, pick_u):
    """Pure reselection: ``pick_u`` [...] uniform draws in [0, 1) pick
    uniformly among the shortlist.  Returns [...] int64."""
    if rssi.shape[-1] == 1:  # one-resource window: nothing to reselect
        return torch.zeros(prev_action.shape, dtype=torch.int64,
                           device=rssi.device)
    order, length = resource_shortlist(rssi, prev_action, rssi_threshold)
    pick = torch.minimum(torch.floor(pick_u * length).long(), length - 1)
    return torch.gather(order, -1, pick[..., None])[..., 0]


def sps_step_pure(state: SPSState, rssi, rssi_threshold: float,
                  counter_draw, keep_u, pick_u):
    """One scheduling round of every agent, given its draws: counter_draw
    U{5, 16} ints, keep_u and pick_u U[0, 1).  Returns (actions, state')."""
    expired = state.counter == 0
    keep = keep_u < 0.8
    chosen = choose_new_resource(rssi, state.prev_action, rssi_threshold,
                                 pick_u)
    reselect = expired & ~keep
    actions = torch.where(reselect, chosen, state.prev_action)
    counter = torch.where(expired, counter_draw, state.counter - 1)
    # prev_action updates only on actual reselection (v2x_sps.py:98-99)
    return actions, SPSState(prev_action=actions, counter=counter)


def sps_step(generator: torch.Generator, state: SPSState, rssi,
             rssi_threshold: float):
    """All agents advance one scheduling round. rssi: [B, N, C] sensed dB."""
    shape, dev = state.counter.shape, state.counter.device
    counter_draw = torch.randint(5, 17, shape, generator=generator,
                                 device=dev)  # U{5,16}, v2x_sps.py:92
    keep_u = torch.rand(shape, generator=generator, device=dev)
    pick_u = torch.rand(shape, generator=generator, device=dev)
    return sps_step_pure(state, rssi, rssi_threshold, counter_draw, keep_u,
                         pick_u)


def toy_rssi(cfg, pos_x, pos_y, last_actions):
    """Free-space sensing proxy: per (listener, channel), the strongest
    received power over last slot's transmitters on that channel; idle
    channels sense the noise floor.  [B, N] x3 -> [B, N, C]."""
    n, c = cfg.num_users, cfg.num_channels
    D = pairwise_distances(pos_x, pos_y)
    # received power in dB ~ -20 log10(d); transmitter itself excluded
    power = RX_BUSY_DB - 20.0 * (torch.log(torch.clamp(D, min=1.0))
                                 * _INV_LN10)
    eye = torch.eye(n, dtype=torch.bool, device=D.device)
    ninf = torch.full((), -math.inf, dtype=D.dtype, device=D.device)
    on_channel = F.one_hot(last_actions.long(), c).bool()     # [B, tx, C]
    p = torch.where(eye, ninf, power)[..., None]              # [B, u, tx, 1]
    contrib = torch.where(on_channel[:, None, :, :], p, ninf)  # [B, u, tx, C]
    return torch.clamp(contrib.amax(dim=2), min=NOISE_FLOOR_DB)
