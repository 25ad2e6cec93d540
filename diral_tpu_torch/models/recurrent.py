"""Recurrent cells (diral_tpu/models/recurrent.py): the LSTM of the DRQN
Q-net and the PPO encoders (reference TF1 ``BasicLSTMCell``,
algorithms/drl_drqn.py:117) and the GRU of the PS-DRQN net (TF1
``GRUCell``, algorithms/ps_drqn.py:146).

LSTM: one [in + hidden, 4*hidden] weight, gate order i, g, f, o,
forget-gate bias offset +1.0.  GRU: a [in + hidden, 2*hidden] gate weight
(r, z) with bias initialised to 1.0 and a [in + hidden, hidden] candidate
weight applied to ``concat([x, r*h])``.  This is the JAX package's GRU
formula, not ``torch.nn.GRU``'s (which puts r inside the hidden
product's bias).  The scans hoist the input projection of every step out
of the time loop.  These are the canonical full-precision paths (float64
on the CPU for parity); the bf16-product LSTM kernel is
ops/lstm_window.py.
"""

from __future__ import annotations

import math

import torch


def _glorot(generator, shape, dtype, device):
    lim = math.sqrt(6.0 / (shape[0] + shape[1]))
    w = torch.empty(shape, dtype=dtype, device=device)
    return w.uniform_(-lim, lim, generator=generator)


def lstm_init(generator: torch.Generator, in_dim: int, hidden: int,
              dtype=torch.float32, device=None):
    """{"w": glorot-uniform [in+H, 4H], "b": zeros [4H]}."""
    w = _glorot(generator, (in_dim + hidden, 4 * hidden), dtype, device)
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


# ---------------------------------------------------------------------------
# GRU
# ---------------------------------------------------------------------------


def gru_init(generator: torch.Generator, in_dim: int, hidden: int,
             dtype=torch.float32, device=None):
    """{"wg": glorot [in+H, 2H], "bg": ones [2H] (TF GRUCell gate bias),
    "wc": glorot [in+H, H], "bc": zeros [H]}."""
    return {
        "wg": _glorot(generator, (in_dim + hidden, 2 * hidden), dtype, device),
        "bg": torch.ones(2 * hidden, dtype=dtype, device=device),
        "wc": _glorot(generator, (in_dim + hidden, hidden), dtype, device),
        "bc": torch.zeros(hidden, dtype=dtype, device=device),
    }


def gru_cell(params, h, x):
    """One step. h [B, H], x [B, D] -> (new h, new h)."""
    xh = torch.cat([x, h], dim=-1)
    r, z = torch.sigmoid(xh @ params["wg"] + params["bg"]).chunk(2, dim=-1)
    cand = torch.tanh(torch.cat([x, r * h], dim=-1) @ params["wc"]
                      + params["bc"])
    new_h = z * h + (1.0 - z) * cand
    return new_h, new_h


def gru_scan(params, xs, h=None):
    """xs [B, T, D] -> (final h, hs [B, T, H]); the input halves of both
    projections are one whole-window product each."""
    b, t, _ = xs.shape
    hidden = params["wc"].shape[1]
    d = params["wg"].shape[0] - hidden
    if h is None:
        h = torch.zeros((b, hidden), dtype=xs.dtype, device=xs.device)
    wg_h, wc_h = params["wg"][d:], params["wc"][d:]
    xg = xs @ params["wg"][:d] + params["bg"]  # [B, T, 2H]
    xc = xs @ params["wc"][:d] + params["bc"]  # [B, T, H]
    hs = []
    for step in range(t):
        r, z = torch.sigmoid(xg[:, step] + h @ wg_h).chunk(2, dim=-1)
        cand = torch.tanh(xc[:, step] + (r * h) @ wc_h)
        h = z * h + (1.0 - z) * cand
        hs.append(h)
    return h, torch.stack(hs, dim=1)
