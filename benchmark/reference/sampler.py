"""Plain reference of the replay's window sampler: per draw, the
``batch`` lowest uniform scores over every (env, start) whose window of
``step + 1`` slots lies in the filled ring, as a sample without
replacement (the reference's ``Memory.sample``, one row per env)."""

from __future__ import annotations

import torch


def pick(scores, capacity: int, ptr: int, count: int, step: int,
         batch: int):
    """scores [n, B*capacity] -> (env ids [n, batch], ring slots
    [n, batch, step + 1]) of the chosen windows, oldest slot first."""
    S = capacity
    valid = count - step
    col = torch.arange(scores.shape[1], device=scores.device) % S
    masked = torch.where(col < valid, scores,
                         torch.full((), float("inf"), dtype=scores.dtype,
                                    device=scores.device))
    flat = torch.sort(masked, dim=1, stable=True).indices[:, :batch]
    env, start = flat // S, flat % S
    base = ((ptr - count) % S + start) % S
    return env, base[..., None] + torch.arange(step + 1,
                                               device=scores.device)
