"""K6: the type-2 positional distribution (view-based piggy histogram,
reference envs/network.py:473-513) as a hand-written CUDA kernel and its
plain PyTorch version.

Both compute what the TPU kernel diral_tpu/ops/pallas_kernels.py::
_piggy_hist_kernel computes: signed table distances, the staleness /
off-diagonal / range gates, the clipped floor rule for the bin index and
``hits * (1 / count)``.  That floor rule agrees with ``np.histogram`` to
within one ULP at the bin edges; the canonical, bit-exact histogram is
the env's "xla" path (ops/histogram.py).

* ``piggy_histogram_plain`` -- the floor-rule arithmetic in PyTorch, in
  the inputs' dtype; what the kernel is held against, bit for bit.
* ``piggy_histogram`` -- the wrapper: CPU tensors run the plain version,
  CUDA tensors launch ``csrc/piggy_hist.cu`` or raise.
  ``piggy_histogram.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from diral_tpu_torch.ops import _build
from diral_tpu_torch.ops.distance import sqrt

STALENESS_CUTOFF = 20


def _consts(bin_range: float, nbins: int, dtype):
    """(R, nbins / 2R) rounded to ``dtype`` once, as the TPU kernel's
    weakly-typed Python constants are."""
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    return (float(np_dtype(bin_range)),
            float(np_dtype(nbins / (2.0 * bin_range))))


def piggy_histogram_plain(table_x, table_y, pos_x, pos_y, table_age,
                          bin_range: float, nbins: int):
    """[B, N, N] tables, [B, N] positions, [B, N, N] ages -> [B, N, nbins]."""
    n = table_x.shape[-1]
    R, scale = _consts(bin_range, nbins, table_x.dtype)
    dx = table_x - pos_x[:, :, None]
    dy = table_y - pos_y[:, :, None]
    d = sqrt(dx * dx + dy * dy)
    signed = torch.where(dx > 0.0, d, -d)
    eye = torch.eye(n, dtype=torch.bool, device=d.device)
    valid = (table_age < STALENESS_CUTOFF) & ~eye & (d < R)
    idx = torch.floor((signed + R) * scale).clamp(0, nbins - 1).long()
    idx = torch.where(valid, idx, torch.full_like(idx, nbins))  # spill bin
    hits = torch.zeros(idx.shape[:-1] + (nbins + 1,), dtype=torch.int32,
                       device=d.device)
    hits.scatter_add_(-1, idx, torch.ones_like(idx, dtype=torch.int32))
    cnt = valid.sum(dim=-1).to(d.dtype)
    inv = torch.where(cnt > 0, torch.reciprocal(cnt), torch.zeros_like(cnt))
    return hits[..., :nbins].to(d.dtype) * inv[..., None]


def piggy_histogram(table_x, table_y, pos_x, pos_y, table_age,
                    bin_range: float, nbins: int):
    """K6 wrapper; same contract as ``piggy_histogram_plain``.  CUDA inputs
    must be float32 tables/positions and int32 ages, contiguous."""
    if table_x.device.type == "cpu":
        return piggy_histogram_plain(table_x, table_y, pos_x, pos_y,
                                     table_age, bin_range, nbins)
    if table_x.device.type != "cuda":
        raise ValueError(
            f"piggy_histogram: unsupported device {table_x.device}")
    b, n = pos_x.shape
    dev = table_x.device
    f32 = torch.float32
    for name, ten, dt, shp in (
            ("table_x", table_x, f32, (b, n, n)),
            ("table_y", table_y, f32, (b, n, n)),
            ("pos_x", pos_x, f32, (b, n)), ("pos_y", pos_y, f32, (b, n)),
            ("table_age", table_age, torch.int32, (b, n, n))):
        _build.check_tensor(name, ten, dt, shp, dev)
    R, scale = _consts(bin_range, nbins, f32)
    lib = _build.library("piggy_hist")
    out = torch.empty((b, n, nbins), dtype=f32, device=dev)
    _build.launch(lib, "piggy_hist_launch",
                  [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                  + [ctypes.c_float] * 2, dev,
                  table_x, table_y, pos_x, pos_y, table_age, out, b, n, nbins,
                  R, scale)
    piggy_histogram.launches += 1
    return out


piggy_histogram.launches = 0
