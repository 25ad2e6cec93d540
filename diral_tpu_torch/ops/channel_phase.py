"""K5: the per-channel walk of ``step_channel`` (reference
envs/test_env.py:351-443), as a hand-written CUDA kernel in two passes and
its plain PyTorch version.

Only the piggyback merge is sequential over channels: a receiver merges
the LIVE neighbour table of its accepted transmitter (vehicle.py:35-47,
61), so an entry merged on channel k travels on from channel k' > k in
the same slot.  Everything else -- the nearest in-range transmitter of
each (channel, receiver), PRR and rewards, the obs column and
last_arrival -- depends on positions and the channel's transmitter set
alone, and entry (i, j) of the merge reads entry (src, j) only, so each
column's chain is independent of the others.

* ``channel_phase_plain`` -- the canonical loop of
  diral_tpu/envs/v2v_env.py:522-566 on batched [B, ...] tensors, in the
  inputs' dtype.  The env's "xla" path and the CPU tests run it; on the
  card it is what the kernel is held against, bit for bit, in float32.
* ``channel_phase`` -- the wrapper: CPU tensors run the plain version,
  CUDA tensors launch the two passes of ``csrc/channel_phase.cu`` or
  raise.  The accept pass (one block per env) finds every accepted
  (receiver, transmitter) pair at once and writes rewards, obs and
  last_arrival, and the env's pairs in channel order into scratch; the
  merge pass (one block per env and slice of ``width`` columns, lanes
  as columns) walks that list per column with the slice of the tables
  in shared memory.  ``_k5_plan`` sizes both from the shape alone.

Deviation from the TPU kernel (diral_tpu/ops/pallas_step.py): the row
gather of table_seq is an integer load, not a one-hot matmul on float32
images, so the TPU kernel's ``MAX_EXACT_SEQ = 2**24`` limit on sequence
numbers does not apply here.  ``last_arrival`` stays in its natural
[tx, rx] layout.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from diral_tpu_torch.ops import _build
from diral_tpu_torch.ops.distance import pairwise_distances

NO_TX_DIST = 100000.0
SMEM_LIMIT = 232_448      # shared bytes a block may use on Hopper
MAX_USERS = 255           # the kernel packs user ids in 8 bits
MERGE_WIDTH = 32          # columns per merge block: one a lane
MERGE_WARPS = 32


class K5Plan(NamedTuple):
    accept_grid: tuple    # (B,): one block per env
    accept_threads: int
    accept_smem: int      # bytes
    merge_grid: tuple     # (B, column slices)
    merge_threads: int
    merge_smem: int       # bytes
    width: int            # columns per merge block


def _k5_plan(B: int, N: int, C: int) -> K5Plan:
    """Both passes' launch shapes from (envs, users, channels) alone.

    Accept: one block per env of 4-32 warps (one a user, up to 32), shared
    memory for positions, actions, ranks, counts and offsets (9N + 2
    words), the in-range and transmitter bitmasks (2N ceil(N/32) words)
    and the accepted source of each (rank, receiver) (N^2 bytes).
    Merge: one block of ``MERGE_WARPS`` warps per env and slice of
    ``MERGE_WIDTH`` columns, shared memory for the slice of table_x/y/seq
    (12 N width bytes), the per-channel offsets (N + 1 words) and the
    pair list (2 N^2 bytes).  ``csrc/channel_phase.cu`` computes the
    same byte counts and refuses a plan that disagrees.

    Raises ValueError for B, N or C below 1 and for N > 255 (ids are 8
    bits); every N <= 255 fits in 232,448 bytes (228,994 at N = 255), so
    it takes every shape the one-block-per-env kernel it replaced took
    (N^2 4 + (2N + C) 4 + 3N bytes, N <= 239) and C is not limited."""
    if min(B, N, C) < 1:
        raise ValueError(f"channel_phase: B={B}, N={N}, C={C} must be >= 1")
    if N > MAX_USERS:
        raise ValueError(f"channel_phase: N={N} users, the kernel packs "
                         f"ids in 8 bits (N <= {MAX_USERS})")
    words = -(-N // 32)
    accept_smem = 4 * (9 * N + 2) + 8 * N * words + N * N
    merge_smem = 12 * N * MERGE_WIDTH + 4 * (N + 1) + 2 * N * N
    return K5Plan((B,), 32 * min(32, max(4, N)), accept_smem,
                  (B, -(-N // MERGE_WIDTH)), 32 * MERGE_WARPS, merge_smem,
                  MERGE_WIDTH)


def closest_tx(D, tx_mask, comm_range):
    """Per-receiver nearest in-range transmitter (network.py:378-398).

    D: [B, N, N], tx_mask: [B, N].  Returns (dist, tx_id, has), each
    [B, N]; dist is NO_TX_DIST and has False when no transmitter is in
    range.  ``argmin`` takes the first occurrence, as the reference's
    strict-< scan over ascending user ids does."""
    no_tx = torch.full((), NO_TX_DIST, dtype=D.dtype, device=D.device)
    cand = torch.where(tx_mask[:, None, :] & (D < comm_range), D, no_tx)
    dist = cand.amin(dim=-1)
    tx_id = cand.argmin(dim=-1)
    return dist, tx_id, dist < NO_TX_DIST


def merge_rows(table_x, table_y, table_seq, table_age, rx_mask, tx_ids):
    """Each receiver with ``rx_mask`` merges row ``tx_ids`` of the live
    tables into its own row, entry-wise where the source sequence number
    is strictly newer (vehicle.py:35-47).  [B, N, N] tables, [B, N] masks."""
    n = table_seq.shape[-1]
    idx = tx_ids[:, :, None].expand(-1, -1, n)
    src_seq = torch.gather(table_seq, 1, idx)
    newer = (src_seq > table_seq) & rx_mask[:, :, None]
    return (torch.where(newer, torch.gather(table_x, 1, idx), table_x),
            torch.where(newer, torch.gather(table_y, 1, idx), table_y),
            torch.where(newer, src_seq, table_seq),
            torch.where(newer, torch.zeros_like(table_age), table_age))


def channel_phase_plain(pos_x, pos_y, actions, table_x, table_y, table_seq,
                        table_age, last_arrival, t, num_channels: int,
                        comm_range: float, design: int, merge: bool):
    """The canonical channel walk (v2v_env.py:522-566), batched.

    pos_x/pos_y: [B, N], actions: [B, N] ints, tables and last_arrival:
    [B, N, N] (last_arrival is [tx, rx]), t: slot index.  Returns
    (table_x, table_y, table_seq, table_age, last_arrival, rewards [B, N],
    obs [B, N, C])."""
    if design not in (2, 3, 4):
        raise ValueError("my_step_ch defined for reward designs 2/3/4 only")
    b, n = pos_x.shape
    dtype, dev = pos_x.dtype, pos_x.device
    R = comm_range
    D = pairwise_distances(pos_x, pos_y)
    ids = torch.arange(n, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    zero = torch.zeros((), dtype=dtype, device=dev)
    r_solo = torch.full((), math.e if design == 4 else 1.0, dtype=dtype,
                        device=dev)
    tx, ty, ts, ta, la = table_x, table_y, table_seq, table_age, last_arrival
    rews = torch.zeros((b, n), dtype=dtype, device=dev)
    obs = torch.zeros((b, n, num_channels), dtype=dtype, device=dev)
    for ch in range(num_channels):
        txm = actions == ch                                   # [B, N]
        tot = txm.sum(dim=1)                                  # [B]
        invoked = ~txm & (tot > 0)[:, None]
        _, cid, has = closest_tx(D, txm, R)

        # PRR per transmitter (test_env.py:384-404): receivers = non-tx in
        # range; received iff the receiver's nearest in-range tx is you
        aud = txm[:, :, None] & (~txm)[:, None, :] & (D < R)  # [B, tx, rx]
        in_range = aud.sum(dim=2)
        mine = cid[:, None, :] == ids[None, :, None]
        received = (aud & has[:, None, :] & mine).sum(dim=2)
        prr = torch.where(in_range > 0,
                          received.to(dtype) / in_range.to(dtype), one)
        if design == 3:
            r_coll = 1.0 - torch.exp(1.0 - prr)
        elif design == 4:
            r_coll = -torch.exp(1.0 - prr)
        else:
            r_coll = -(1.0 - prr)
        r_tx = torch.where((tot > 1)[:, None], r_coll, r_solo)
        rews = torch.where(txm, r_tx, rews)

        obs[:, :, ch] = torch.where(txm, zero, torch.where(invoked, one, zero))

        # last_arrival (test_env.py:427-436): -1 for out-of-range pairs of
        # every receiver that scanned, slot index for the accepted tx
        oor = txm[:, :, None] & invoked[:, None, :] & (D >= R)
        la = torch.where(oor, torch.full_like(la, -1), la)
        accepted = invoked & has
        arr = accepted[:, None, :] & mine
        la = torch.where(arr, torch.full_like(la, int(t)), la)
        if merge:
            tx, ty, ts, ta = merge_rows(tx, ty, ts, ta, accepted, cid)
    return tx, ty, ts, ta, la, rews, obs


def channel_phase(pos_x, pos_y, actions, table_x, table_y, table_seq,
                  table_age, last_arrival, t, num_channels: int,
                  comm_range: float, design: int, merge: bool):
    """K5 wrapper; same contract as ``channel_phase_plain``.  CUDA inputs
    must be float32 positions/tables, int32 actions/seq/age/last_arrival,
    contiguous, with N <= 255 (``_k5_plan``).  ``channel_phase.launches``
    counts calls that launched the kernel: one per call, though a call
    launches two passes."""
    if pos_x.device.type == "cpu":
        return channel_phase_plain(pos_x, pos_y, actions, table_x, table_y,
                                   table_seq, table_age, last_arrival, t,
                                   num_channels, comm_range, design, merge)
    if pos_x.device.type != "cuda":
        raise ValueError(f"channel_phase: unsupported device {pos_x.device}")
    if design not in (2, 3, 4):
        raise ValueError("my_step_ch defined for reward designs 2/3/4 only")
    b, n = pos_x.shape
    dev = pos_x.device
    f32, i32 = torch.float32, torch.int32
    for name, ten, dt, shp in (
            ("pos_x", pos_x, f32, (b, n)), ("pos_y", pos_y, f32, (b, n)),
            ("actions", actions, i32, (b, n)),
            ("table_x", table_x, f32, (b, n, n)),
            ("table_y", table_y, f32, (b, n, n)),
            ("table_seq", table_seq, i32, (b, n, n)),
            ("table_age", table_age, i32, (b, n, n)),
            ("last_arrival", last_arrival, i32, (b, n, n))):
        _build.check_tensor(name, ten, dt, shp, dev)
    plan = _k5_plan(b, n, num_channels)
    lib = _build.library("channel_phase")
    outs = [torch.empty_like(table_x), torch.empty_like(table_y),
            torch.empty_like(table_seq), torch.empty_like(table_age),
            torch.empty_like(last_arrival),
            torch.empty((b, n), dtype=f32, device=dev),
            torch.empty((b, n, num_channels), dtype=f32, device=dev)]
    # the accepted (receiver | source << 8) pairs of each env in channel
    # order, and [active channels, their N + 1 offsets] per env
    pairs = torch.empty((b, n * n), dtype=torch.int16, device=dev)
    meta = torch.empty((b, n + 2), dtype=i32, device=dev)
    _build.launch(lib, "channel_phase_launch",
                  [ctypes.c_void_p] * 17 + [ctypes.c_int] * 4
                  + [ctypes.c_float] + [ctypes.c_int] * 8, dev,
                  pos_x, pos_y, actions, table_x, table_y, table_seq,
                  table_age, last_arrival, *outs, pairs, meta, b, n,
                  num_channels, int(t), float(np.float32(comm_range)),
                  design, int(bool(merge)), plan.accept_threads,
                  plan.accept_smem, plan.merge_grid[1], plan.merge_threads,
                  plan.merge_smem, plan.width)
    channel_phase.launches += 1
    return tuple(outs)


channel_phase.launches = 0
