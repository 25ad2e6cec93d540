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
* ``_k6_plan`` -- the kernel's launch shape from (B, N, nbins) alone.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import numpy as np
import torch

from diral_tpu_torch.ops import _build
from diral_tpu_torch.ops.distance import sqrt

STALENESS_CUTOFF = 20
SMS = 132                 # streaming multiprocessors of an H100 SXM
MAX_WARPS = 8             # csrc/piggy_hist.cu kMaxWarps
SMEM_LIMIT = 48 * 1024    # shared bytes a block takes without opting in
MAX_BINS = SMEM_LIMIT // 4   # one warp's int histogram within 48 KB
WAVE_WARPS = SMS * 64     # warps resident on the card at once
ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
            + [ctypes.c_int] * 3)


class K6Plan(NamedTuple):
    warps: int            # warps a block; a warp takes one vehicle row
    rows_per_warp: int    # rows a warp takes in turn
    tiles: int            # row tiles an env: ceil(N / (warps rows_per_warp))
    grid: tuple           # (B * tiles,): one block per (env, row tile)
    vec: int              # table entries a lane loads at once: 4 or 1
    smem: int             # bytes: one int histogram of nbins a warp


@functools.lru_cache(maxsize=256)
def _k6_plan(B: int, N: int, nbins: int) -> K6Plan:
    """K6's launch shape from (envs, vehicles, bins) alone.

    One warp per (env, vehicle row).  A warp takes ``rows_per_warp`` rows,
    more than one only where B N exceeds the warps the card holds at once
    (132 SMs x 64).  Warps a block: the most, up to 8, within 48 KB of
    shared memory (4 nbins bytes a warp) and no more than an env's rows
    need, that still give >= 132 blocks; where B N rows cannot fill 132
    blocks, one warp a block.  Rows of an env are split into tiles of
    warps x rows_per_warp; the grid is one block per (env, tile).  Loads are 16 bytes (4 entries) where N % 4 ==
    0, else one entry.  Raises ValueError for B, N or nbins below 1 and
    for nbins above 12288 (one warp's histogram would pass 48 KB)."""
    if min(B, N, nbins) < 1:
        raise ValueError(f"piggy_histogram: B={B}, N={N}, nbins={nbins} "
                         f"must be >= 1")
    if nbins > MAX_BINS:
        raise ValueError(f"piggy_histogram: nbins={nbins} > {MAX_BINS}")
    rpw = -(-B * N // WAVE_WARPS)
    most = min(MAX_WARPS, SMEM_LIMIT // (4 * nbins), -(-N // rpw))
    warps = next((w for w in range(most, 0, -1)
                  if B * -(-N // (w * rpw)) >= SMS), 1)
    tiles = -(-N // (warps * rpw))
    return K6Plan(warps, rpw, tiles, (B * tiles,), 4 if N % 4 == 0 else 1,
                  4 * warps * nbins)


@functools.lru_cache(maxsize=64)
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
    _check(table_x, table_y, pos_x, pos_y, table_age, b, n, dev)
    plan = _k6_plan(b, n, nbins)
    R, scale = _consts(bin_range, nbins, torch.float32)
    lib = _build.library("piggy_hist")
    out = torch.empty((b, n, nbins), dtype=torch.float32, device=dev)
    _build.launch(lib, "piggy_hist_launch", ARGTYPES, dev, table_x, table_y,
                  pos_x, pos_y, table_age, out, b, n, nbins, R, scale,
                  plan.warps, plan.rows_per_warp, plan.vec)
    piggy_histogram.launches += 1
    return out


piggy_histogram.launches = 0


def _check(table_x, table_y, pos_x, pos_y, table_age, b, n, dev):
    """The kernel's inputs: float32 tables and positions, int32 ages, all
    on ``dev`` and contiguous."""
    f32 = torch.float32
    _build.check_tensor("table_x", table_x, f32, (b, n, n), dev)
    _build.check_tensor("table_y", table_y, f32, (b, n, n), dev)
    _build.check_tensor("pos_x", pos_x, f32, (b, n), dev)
    _build.check_tensor("pos_y", pos_y, f32, (b, n), dev)
    _build.check_tensor("table_age", table_age, torch.int32, (b, n, n), dev)


def launch_floor(table_x, table_y, pos_x, pos_y, table_age, bin_range: float,
                 nbins: int):
    """``dtt_noop_launch``, an empty kernel, through ``piggy_histogram``'s
    launch path and argument list without its checks or allocation: its
    time is the least a wrapper on that path can take."""
    b, n = pos_x.shape
    plan = _k6_plan(b, n, nbins)
    R, scale = _consts(bin_range, nbins, torch.float32)
    _build.launch(_build.library("piggy_hist"), "dtt_noop_launch", ARGTYPES,
                  table_x.device, table_x, table_y, pos_x, pos_y, table_age,
                  table_x, b, n, nbins, R, scale, plan.warps,
                  plan.rows_per_warp, plan.vec)
