"""K1: the DRQN Q-net's LSTM window forward (BasicLSTMCell over a short
history window, only the last hidden state consumed; reference
algorithms/drl_drqn.py:109-155) as a hand-written CUDA kernel and its
plain PyTorch version.

Window layout, as in diral_tpu/ops/pallas_lstm.py: FLAT [B, T*Dp], each
step's D features at lane offset t*Dp, ``Dp = round_up(D + 2, 16)``.
Pad lanes meet zero rows of the padded input-weight matrix, so they are
inert whatever they hold.

Numerics are the TPU kernel's precision class: x, Wx, Wh and h are
rounded to bfloat16 before each product, products are summed in float32,
gate math is float32.  The canonical full-precision path is
models/recurrent.lstm_scan (the float64 CPU parity path).

* ``lstm_last_flat_plain`` -- that arithmetic in PyTorch: operands
  rounded to bf16, then float32 matmuls.  bf16 x bf16 products are exact
  in float32, so it differs from the kernel only in the order of sums.
* ``lstm_last_flat`` / ``lstm_last`` -- the wrappers: CPU tensors run the
  plain version, CUDA tensors launch ``csrc/lstm_window.cu`` or raise.
  ``lstm_last_flat.launches`` counts kernel launches.

Forward only: the backward (TPU kernel ``_bwd_kernel``) comes with the
training slice.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from diral_tpu_torch.ops import _build


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def padded_dim(d: int) -> int:
    """Per-step lane stride of the flat window layout (pallas_lstm.py:55-68):
    ``round_up(d + 2, 16)``; the +2 leaves room for the replay's fused
    reward/action channels."""
    return _round_up(d + 2, 16)


def flatten_window(x):
    """[B, T, D] -> the flat [B, T*Dp] layout (zero pad lanes)."""
    b, t, d = x.shape
    return F.pad(x, (0, padded_dim(d) - d)).reshape(b, t * padded_dim(d))


def unflatten_window(x2, T: int, D: int):
    """Inverse of ``flatten_window`` (drops pad lanes)."""
    return x2.reshape(x2.shape[0], T, padded_dim(D))[..., :D]


def supported(x_dtype, hidden: int) -> bool:
    """Shapes/dtypes the kernel serves (pallas_lstm.py:561-566): float32 or
    bfloat16 windows and H a multiple of 128.  Float64 -- the CPU parity
    suite -- takes the canonical lstm_scan."""
    return x_dtype in (torch.float32, torch.bfloat16) and hidden % 128 == 0


def _split_weights(w, D: int, Dp: int):
    """(Wx padded to Dp rows with zeros, Wh), both rounded to bfloat16."""
    wx = F.pad(w[:D], (0, 0, 0, Dp - D)).to(torch.bfloat16)
    return wx, w[D:].to(torch.bfloat16)


def _gate_math(c, gates, H: int):
    i, g, f, o = gates.split(H, dim=-1)
    si = torch.sigmoid(i)
    tg = torch.tanh(g)
    sf = torch.sigmoid(f + 1.0)   # BasicLSTMCell forget bias
    so = torch.sigmoid(o)
    c = c * sf + si * tg
    return c, torch.tanh(c) * so


def lstm_last_flat_plain(x2, w, b, T: int):
    """Plain PyTorch version of K1.  x2: [B, T*Dp]; w: [D+H, 4H]; b: [4H].
    Returns [B, H] in x2's dtype."""
    f32 = torch.float32
    H = w.shape[1] // 4
    D = w.shape[0] - H
    Dp = padded_dim(D)
    if x2.shape[1] != T * Dp:
        raise ValueError(f"window width {x2.shape[1]} != T*Dp = {T * Dp}")
    wx, wh = (m.to(f32) for m in _split_weights(w, D, Dp))
    bias = b.to(f32)
    h = torch.zeros((x2.shape[0], H), dtype=f32, device=x2.device)
    c = torch.zeros_like(h)
    for t in range(T):
        xt = x2[:, t * Dp:(t + 1) * Dp].to(torch.bfloat16).to(f32)
        hb = h.to(torch.bfloat16).to(f32)
        gates = xt @ wx + hb @ wh + bias
        c, h = _gate_math(c, gates, H)
    return h.to(x2.dtype)


def lstm_last_flat(x2, w, b, T: int):
    """Fused LSTM over a FLAT padded window -> last hidden [B, H] in x2's
    dtype.  x2: [B, T*Dp]; w: [D+H, 4H]; b: [4H]."""
    if x2.device.type == "cpu":
        return lstm_last_flat_plain(x2, w, b, T)
    if x2.device.type != "cuda":
        raise ValueError(f"lstm_last_flat: unsupported device {x2.device}")
    H = w.shape[1] // 4
    D = w.shape[0] - H
    Dp = padded_dim(D)
    B = x2.shape[0]
    if not supported(x2.dtype, H) or H > 1024:
        raise ValueError(f"lstm_last_flat: unsupported dtype={x2.dtype}, "
                         f"hidden={H} (float32/bfloat16, H % 128 == 0, "
                         f"H <= 1024)")
    if x2.dim() != 2 or x2.shape[1] != T * Dp or not x2.is_contiguous():
        raise ValueError(f"lstm_last_flat: x2 must be a contiguous "
                         f"[B, {T * Dp}] window, got {tuple(x2.shape)}")
    if w.device != x2.device or b.device != x2.device:
        raise ValueError("lstm_last_flat: w, b and x2 on different devices")
    if tuple(b.shape) != (4 * H,):
        raise ValueError(f"lstm_last_flat: bias shape {tuple(b.shape)}")
    lib = _build.library("lstm_window")
    wpk = torch.cat(_split_weights(w, D, Dp), dim=0).contiguous()
    bias = b.to(torch.float32).contiguous()
    out = torch.empty((B, H), dtype=x2.dtype, device=x2.device)
    _build.launch(lib, "lstm_window_launch",
                  [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5, x2.device,
                  x2, wpk, bias, out, B, T, Dp, H,
                  int(x2.dtype == torch.bfloat16))
    lstm_last_flat.launches += 1
    return out


lstm_last_flat.launches = 0


def lstm_last(x, w, b):
    """Fused LSTM over a [B, T, D] window -> last hidden [B, H]; semantics
    of ``lstm_scan(params, x)[1][:, -1]`` within the bf16-product
    precision class."""
    return lstm_last_flat(flatten_window(x).contiguous(), w, b, x.shape[1])
