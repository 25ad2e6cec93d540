"""K5's two-pass design on the CPU: the plan, and an emulation of both
passes in the kernel's own order.

``csrc/channel_phase.cu`` runs only on the card.  What its design rests
on is checked here:

* ``_k5_plan(B, N, C)``: every column in exactly one merge slice, shared
  memory within 232,448 bytes, every shape the one-block-per-env kernel
  it replaced accepted (N^2 4 + (2N + C) 4 + 3N bytes) still accepted,
  N > 255 refused.
* A numpy emulation of the accept pass (active channels ranked by their
  lowest user, transmitter and in-range bitmasks walked in ascending id,
  the nearest in-range transmitter of every (channel, receiver), PRR,
  obs, last_arrival, the pair list in channel order with per-channel
  offsets) and of the merge pass (slices of ``width`` columns with lanes
  as columns, the block's warps splitting a channel's pairs, run here in
  a random warp order; table_age zeroed where seq grew), held bit for
  bit against ``channel_phase_plain`` and against
  ``diral_tpu.ops.pallas_step.channel_phase`` (Pallas interpret mode,
  vmapped over envs).  Design 3/4 rewards are held to one ULP of exp
  against JAX (XLA's and PyTorch's CPU expf differ; ROADMAP Queue 3).  Sequence numbers above 2^24 are held against the plain
  version only: the TPU kernel gathers them as float32 (MAX_EXACT_SEQ).
* The property that lets the accept pass run every channel at once: row
  i of last_arrival and reward i change only on channel actions[i].

Positions have y = 0, as every random reset gives (XLA contracts
``dx*dx + dy*dy`` into a fused multiply-add on the CPU)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diral_tpu.ops.pallas_step import channel_phase as jax_channel_phase
from diral_tpu_torch.ops import channel_phase as K5

R = 250.0
NONE = 0xFF
NAMES = ("table_x", "table_y", "table_seq", "table_age", "last_arrival",
         "rewards", "obs")


def old_kernel_fits(n, c):
    """Shared bytes of the one-block-per-env kernel this design replaced."""
    return n * n * 4 + (2 * n + c) * 4 + 3 * n <= K5.SMEM_LIMIT


def inputs(b, n, c, seed, cluster=False, seq_hi=50, odd_actions=False):
    rng = np.random.RandomState(seed)
    if cluster:   # everyone within range: long merge chains
        px = np.tile(np.linspace(0.0, 120.0, n), (b, 1))
    else:
        px = rng.randint(0, 800, (b, n)) + rng.uniform(0, 1, (b, n)).round(2)
    acts = rng.randint(0, c, (b, n))
    if odd_actions:   # -1 and C transmit on no channel
        acts = np.where(rng.rand(b, n) < 0.25,
                        rng.choice([-1, c], (b, n)), acts)
    return dict(
        pos_x=px.astype(np.float32), pos_y=np.zeros((b, n), np.float32),
        actions=acts.astype(np.int32),
        table_x=rng.uniform(0, 800, (b, n, n)).astype(np.float32),
        table_y=rng.uniform(0, 2, (b, n, n)).astype(np.float32),
        table_seq=rng.randint(0, seq_hi, (b, n, n)).astype(np.int32),
        table_age=rng.randint(0, 40, (b, n, n)).astype(np.int32),
        last_arrival=rng.randint(-1, 10, (b, n, n)).astype(np.int32))


ORDER = ("pos_x", "pos_y", "actions", "table_x", "table_y", "table_seq",
         "table_age", "last_arrival")


# --------------------------------------------------------------- emulation

def bits(mask_row):
    """A boolean row as the kernel's 32-bit words (bit j % 32 of word j // 32)."""
    n = mask_row.shape[0]
    return [sum(1 << (j - q * 32) for j in range(q * 32, min(n, q * 32 + 32))
                if mask_row[j]) for q in range(-(-n // 32))]


def accept_pass(px, py, acts, la_in, t, c, merge):
    """One env of channel_phase_accept_kernel."""
    n = px.shape[0]
    words = -(-n // 32)
    act = np.where((acts >= 0) & (acts < c), acts, -1)
    first = [act[u] >= 0 and not (act[:u] == act[u]).any() for u in range(n)]
    k_active = sum(first)
    kof = np.array([-1 if act[u] < 0 else
                    sum(first[w] and act[w] < act[u] for w in range(n))
                    for u in range(n)])
    chan = {kof[u]: act[u] for u in range(n) if first[u]}
    dx = px[:, None] - px[None, :]
    dy = py[:, None] - py[None, :]
    D = np.sqrt(dx * dx + dy * dy)          # float32, every op rounded
    inr = D < np.float32(R)
    inr_w = [bits(inr[i]) for i in range(n)]
    txm = [bits(kof == k) for k in range(k_active)]

    res = np.full((k_active, n), NONE)
    recv, cnt = np.zeros(n, np.int64), np.zeros(k_active, np.int64)
    obs = np.zeros((n, c), np.float32)
    for item in range(k_active * n):
        k, r = divmod(item, n)
        if kof[r] == k:
            continue
        best, got = np.float32(K5.NO_TX_DIST), NONE
        for q in range(words):
            m = txm[k][q] & inr_w[r][q]
            while m:                          # __ffs: ascending ids
                low = m & -m
                tx = q * 32 + low.bit_length() - 1
                m ^= low
                if D[r, tx] < best:           # strict: the first wins ties
                    best, got = D[r, tx], tx
        obs[r, chan[k]] = 1.0
        if got != NONE:
            recv[got] += 1
            cnt[k] += 1
        res[k, r] = got

    prr = np.ones(n, np.float32)
    crowded = np.zeros(n, bool)
    for u in range(n):
        k = kof[u]
        if k < 0:
            continue
        tot = sum(bin(w).count("1") for w in txm[k])
        in_range = sum(bin(inr_w[u][q] & ~txm[k][q]).count("1")
                       for q in range(words))
        if in_range > 0:
            prr[u] = np.float32(recv[u]) / np.float32(in_range)
        crowded[u] = tot > 1

    la = la_in.copy()
    for i in range(n):
        k = kof[i]
        if k >= 0:
            la[i] = np.where(res[k] == i, t,
                             np.where((kof != k) & ~inr[i], -1, la[i]))

    off = np.concatenate([[0], np.cumsum(cnt)]).astype(np.int64)
    pairs = [r | (int(res[k, r]) << 8) for k in range(k_active)
             for r in range(n) if res[k, r] != NONE]
    return dict(la=la, prr=prr, crowded=crowded, is_tx=kof >= 0, obs=obs,
                pairs=pairs, off=off, K=k_active if merge else 0)


def merge_pass(tx, ty, ts, ta, acc, plan, rng):
    """One env of channel_phase_merge_kernel, block by block: lanes are
    the slice's columns, a warp takes every ``warps``-th pair of a
    channel, and the warps run here in a random order."""
    n = tx.shape[0]
    W, warps = plan.width, plan.merge_threads // 32
    out = [tx.copy(), ty.copy(), ts.copy(), ta.copy()]
    for y in range(plan.merge_grid[1]):
        cols = y * W + np.arange(W)
        ok = cols < n
        sx, sy = np.zeros((n, W), np.float32), np.zeros((n, W), np.float32)
        ss = np.zeros((n, W), np.int32)
        sx[:, ok], sy[:, ok], ss[:, ok] = (tx[:, cols[ok]], ty[:, cols[ok]],
                                           ts[:, cols[ok]])
        for k in range(acc["K"]):
            s, e = acc["off"][k], acc["off"][k + 1]
            for w in rng.permutation(warps):      # warps in any order
                for p in range(s + w, e, warps):
                    row, src = acc["pairs"][p] & 0xFF, acc["pairs"][p] >> 8
                    newer = ss[src] > ss[row]
                    ss[row] = np.where(newer, ss[src], ss[row])
                    sx[row] = np.where(newer, sx[src], sx[row])
                    sy[row] = np.where(newer, sy[src], sy[row])
        out[0][:, cols[ok]], out[1][:, cols[ok]] = sx[:, ok], sy[:, ok]
        out[2][:, cols[ok]] = ss[:, ok]
        # a merge takes only a strictly newer seq: merged iff seq grew
        out[3][:, cols[ok]] = np.where(ss[:, ok] > ts[:, cols[ok]], 0,
                                       ta[:, cols[ok]])
    return out


def emulate(st, t, c, design, merge, seed=0):
    """Both passes over every env; rewards from PRR as plain's [B, N]
    expressions (the same element positions, so PyTorch's CPU exp takes
    the same vector or scalar path for each)."""
    b, n = st["pos_x"].shape
    plan = K5._k5_plan(b, n, c)
    rng = np.random.RandomState(seed)
    tabs = [[], [], [], []]
    la, obs = [], []
    prr, crowded, is_tx = (np.zeros((b, n), np.float32), np.zeros((b, n), bool),
                           np.zeros((b, n), bool))
    for e in range(b):
        acc = accept_pass(st["pos_x"][e], st["pos_y"][e], st["actions"][e],
                          st["last_arrival"][e], t, c, merge)
        la.append(acc["la"])
        obs.append(acc["obs"])
        prr[e], crowded[e], is_tx[e] = acc["prr"], acc["crowded"], acc["is_tx"]
        for lst, arr in zip(tabs, merge_pass(
                st["table_x"][e], st["table_y"][e], st["table_seq"][e],
                st["table_age"][e], acc, plan, rng)):
            lst.append(arr)
    p = torch.from_numpy(prr)
    if design == 3:
        r_coll = 1.0 - torch.exp(1.0 - p)
    elif design == 4:
        r_coll = -torch.exp(1.0 - p)
    else:
        r_coll = -(1.0 - p)
    r_solo = torch.full((), np.e if design == 4 else 1.0, dtype=torch.float32)
    rews = torch.where(torch.from_numpy(is_tx),
                       torch.where(torch.from_numpy(crowded), r_coll, r_solo),
                       torch.zeros((), dtype=torch.float32))
    return tuple(torch.from_numpy(np.stack(x)) for x in tabs) + (
        torch.from_numpy(np.stack(la)), rews, torch.from_numpy(np.stack(obs)))


# ------------------------------------------------------------------- tests

def run_steps(st, c, design, merge, steps, seed, against_jax=True):
    """``steps`` slots, each slot's tables fed to the next: the emulation
    equals plain bit for bit, and JAX's interpret kernel (exp: one ULP)."""
    rng = np.random.RandomState(seed)
    b, n = st["pos_x"].shape
    jfn = jax.vmap(lambda px, py, a, tx, ty, ts, ta, la, t: jax_channel_phase(
        px, py, a, tx, ty, ts, ta, la, t, c, R, design, merge),
        in_axes=(0,) * 8 + (None,))
    for t in range(steps):
        if t:
            acts = rng.randint(0, c, (b, n))
            st["actions"] = np.where(st["actions"] < 0, -1, np.where(
                st["actions"] >= c, c, acts)).astype(np.int32)
        emu = emulate(st, t, c, design, merge, seed=seed + t)
        plain = K5.channel_phase_plain(
            *(torch.from_numpy(st[k]) for k in ORDER), t, c, R, design, merge)
        for name, e, p in zip(NAMES, emu, plain):
            assert torch.equal(e, p), f"{name} vs plain, t={t}"
        if against_jax:
            jout = jfn(*(jnp.asarray(st[k]) for k in ORDER), t)
            for name, e, j in zip(NAMES, emu, jout):
                msg = f"{name} vs JAX, n={n} c={c} design={design} t={t}"
                if name == "rewards" and design in (3, 4):
                    np.testing.assert_allclose(
                        e.numpy(), np.asarray(j), rtol=0,
                        atol=float(np.spacing(np.float32(np.e))), err_msg=msg)
                else:
                    np.testing.assert_array_equal(e.numpy(), np.asarray(j),
                                                  err_msg=msg)
        for k, o in zip(ORDER[3:], emu[:5]):
            st[k] = o.numpy()
    return st


@pytest.mark.parametrize("design", [2, 3, 4])
@pytest.mark.parametrize("merge", [True, False])
def test_emulation_designs(design, merge):
    """N = 37: the last merge slice holds 5 of 32 columns."""
    run_steps(inputs(2, 37, 8, 10 * design + merge), 8, design, merge, 2,
              seed=design)


def test_emulation_cluster():
    """Everyone in range: many pairs per channel, several groups per warp,
    two-hop chains within one slot; seq up to 5e5."""
    st = inputs(2, 34, 6, 11, cluster=True, seq_hi=500_000)
    before = st["table_seq"].copy()
    st = run_steps(st, 6, 2, True, 2, seed=12)
    assert not np.array_equal(st["table_seq"], before)


def test_emulation_out_of_range_actions():
    """Actions -1 and C transmit on no channel: reward 0, their
    last_arrival rows untouched, receivers on every active channel."""
    run_steps(inputs(3, 24, 5, 21, odd_actions=True), 5, 2, True, 2, seed=22)


@pytest.mark.parametrize("n,c", [(1, 3), (100, 50)])
def test_emulation_sizes(n, c):
    """N = 1 (one column, no receiver) and the 100v/50r shape (100 is not
    a multiple of 32)."""
    run_steps(inputs(2, n, c, n + c), c, 2, True, 1, seed=n)


def test_emulation_one_channel():
    run_steps(inputs(2, 20, 1, 31), 1, 3, True, 2, seed=32)


def test_emulation_seq_above_2_24():
    """Integer seq gather: values past 2^24 merge exactly (plain only; the
    TPU kernel is exact below MAX_EXACT_SEQ = 2^24)."""
    st = inputs(2, 40, 6, 41, cluster=True)
    st["table_seq"] = (st["table_seq"] + (1 << 24) + 1).astype(np.int32)
    st["table_seq"][:, :, ::3] += 1     # odd values, above float32's reach
    before = st["table_seq"].copy()
    st = run_steps(st, 6, 2, True, 2, seed=42, against_jax=False)
    assert not np.array_equal(st["table_seq"], before)


@pytest.mark.parametrize("seed", [0, 1])
def test_rows_change_only_on_own_channel(seed):
    """The walk cut after channel ch is the plain walk with C = ch + 1:
    between consecutive cuts, only the rows of last_arrival and the
    rewards of the users that transmit on ch may change."""
    b, n, c = 3, 30, 6
    st = inputs(b, n, c, 50 + seed, odd_actions=True)
    args = [torch.from_numpy(st[k]) for k in ORDER]
    prev_la, prev_r = args[7], torch.zeros((b, n))
    changed = 0
    for ch in range(c):
        out = K5.channel_phase_plain(*args, 9, ch + 1, R, 2, True)
        rows = (out[4] != prev_la).any(-1) | (out[5] != prev_r)
        assert bool((torch.from_numpy(st["actions"])[rows] == ch).all()), ch
        changed += int(rows.sum())
        prev_la, prev_r = out[4], out[5]
    full = K5.channel_phase_plain(*args, 9, c, R, 2, True)
    assert torch.equal(full[4], prev_la) and torch.equal(full[5], prev_r)
    assert changed > 0


@pytest.mark.parametrize("n", [1, 2, 31, 32, 33, 37, 64, 100, 128, 200,
                               239, 240, 255])
def test_plan_shapes(n):
    """Each column in exactly one merge slice, shared memory within the
    block limit, warp-multiple threads."""
    for b, c in ((1, 1), (16, 50), (2048, 333)):
        p = K5._k5_plan(b, n, c)
        assert p.accept_grid == (b,) and p.merge_grid[0] == b
        cover = np.zeros(n, np.int64)
        for y in range(p.merge_grid[1]):
            cols = np.arange(y * p.width, (y + 1) * p.width)
            assert (cols < n).any()           # no empty slice
            cover[cols[cols < n]] += 1
        assert (cover == 1).all()
        assert max(p.accept_smem, p.merge_smem) <= K5.SMEM_LIMIT
        for threads in (p.accept_threads, p.merge_threads):
            assert threads % 32 == 0 and 128 <= threads <= 1024


def test_plan_takes_every_shape_the_old_kernel_took():
    took = 0
    for n in range(1, 260):
        for c in (1, 2, 50, 333, 5000, 58_000):
            if old_kernel_fits(n, c):
                K5._k5_plan(16, n, c)
                took += 1
    assert took > 0 and max(n for n in range(1, 260)
                            if old_kernel_fits(n, 1)) == 239


@pytest.mark.parametrize("b,n,c", [(16, 256, 50), (16, 300, 1), (0, 10, 5),
                                   (4, 0, 5), (4, 10, 0)])
def test_plan_refuses(b, n, c):
    with pytest.raises(ValueError):
        K5._k5_plan(b, n, c)
