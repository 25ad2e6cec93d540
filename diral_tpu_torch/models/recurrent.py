"""The LSTM cell of the DRQN Q-net (diral_tpu/models/recurrent.py;
reference TF1 ``BasicLSTMCell``, algorithms/drl_drqn.py:117).

One [in + hidden, 4*hidden] weight, gate order i, g, f, o, forget-gate
bias offset +1.0.  ``lstm_scan`` hoists the input projection of every
step out of the time loop.  This is the canonical full-precision path
(float64 on the CPU for parity); the bf16-product kernel is
ops/lstm_window.py.  The GRU of the PS-DRQN net comes with that slice.
"""

from __future__ import annotations

import math

import torch


def lstm_init(generator: torch.Generator, in_dim: int, hidden: int,
              dtype=torch.float32, device=None):
    """{"w": glorot-uniform [in+H, 4H], "b": zeros [4H]}."""
    shape = (in_dim + hidden, 4 * hidden)
    lim = math.sqrt(6.0 / (shape[0] + shape[1]))
    w = torch.empty(shape, dtype=dtype, device=device)
    w.uniform_(-lim, lim, generator=generator)
    return {"w": w, "b": torch.zeros(4 * hidden, dtype=dtype, device=device)}


def _gates_to_state(c, gates):
    i, g, f, o = gates.chunk(4, dim=-1)
    new_c = c * torch.sigmoid(f + 1.0) + torch.sigmoid(i) * torch.tanh(g)
    return new_c, torch.tanh(new_c) * torch.sigmoid(o)


def lstm_cell(params, carry, x):
    """One step. carry = (c, h) each [B, H]; x [B, D]."""
    c, h = carry
    gates = torch.cat([x, h], dim=-1) @ params["w"] + params["b"]
    new_c, new_h = _gates_to_state(c, gates)
    return (new_c, new_h), new_h


def lstm_scan(params, xs, carry=None):
    """xs [B, T, D] -> (final (c, h), hs [B, T, H])."""
    b, t, _ = xs.shape
    hidden = params["w"].shape[1] // 4
    d = params["w"].shape[0] - hidden
    if carry is None:
        zero = torch.zeros((b, hidden), dtype=xs.dtype, device=xs.device)
        carry = (zero, zero)
    w_h = params["w"][d:]
    xg = xs @ params["w"][:d] + params["b"]  # [B, T, 4H], one contraction
    c, h = carry
    hs = []
    for step in range(t):
        c, h = _gates_to_state(c, xg[:, step] + h @ w_h)
        hs.append(h)
    return (c, h), torch.stack(hs, dim=1)
