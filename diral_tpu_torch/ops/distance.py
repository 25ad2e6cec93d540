"""Pairwise vehicle geometry as dense batched [B, N, N] ops
(diral_tpu/ops/distance.py; reference envs/network.py:318-349)."""

from __future__ import annotations

import numpy as np
import torch


def sqrt(x):
    """IEEE (correctly rounded) square root.  PyTorch's CPU sqrt kernel is
    vectorised through a math library that is one ULP off on some inputs
    (float32 and float64), which would break bit parity with NumPy, XLA
    and the CUDA kernels; NumPy's is exact, and so is ``torch.sqrt`` on a
    CUDA tensor."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.detach().numpy()))
    return torch.sqrt(x)


def pairwise_distances(pos_x, pos_y):
    """D[b, i, j] = euclidean distance between vehicles i and j of env b.
    [B, N] -> [B, N, N]."""
    dx = pos_x[..., :, None] - pos_x[..., None, :]
    dy = pos_y[..., :, None] - pos_y[..., None, :]
    return sqrt(dx * dx + dy * dy)


def signed_dx(pos_x):
    """sign[b, i, j] = +1 if j is strictly right of i else -1
    (reference network.py:334-349 ``dist_sign`` convention)."""
    dx = pos_x[..., None, :] - pos_x[..., :, None]  # [i, j] = x_j - x_i
    one = torch.ones((), dtype=pos_x.dtype, device=pos_x.device)
    return torch.where(dx > 0.0, one, -one)
