"""The host side of K3's tensor-core row pass (lstm_bwd_rows_tc_kernel in
csrc/lstm_window.cu), which the CPU can check without the card.

* ``_bwd_plan`` (ops/lstm_window) over the toy, 100v/50r, PPO and a grid
  of shapes -- B in {1, 97, 2047, 4096, 25600} x D in {23, 100} x every
  H that K3 takes (multiples of 128 up to 1024): a row tile of 16 or 32,
  shared memory within the H100's 227 KB a block (the forward sweep's
  buffers, or the backward sweep's A tile and dh, whichever is larger),
  blocks that cover every row exactly, >= 132 blocks wherever 16-row
  tiles allow it, and the largest tile that does.  The plan is a
  function of the shape alone.  H = 1024 has a plan (16 rows).
* ``_bwd_fragments``: a permutation of the packed bf16 weights, and
  element (n, k) read through the kernel's index math -- uint4
  32 * (nt * KP + kp) + lane, bf16 4 * j + 2 * khalf + pair -- is P[n, k].
* A lane-by-lane emulation of ``bwd_tiles`` (ldmatrix A fragments from
  the kernel's addresses in the dgates tile, B fragments from its weight
  stream, mma.sync m16n8k16 by the PTX layouts) gives dh = A @ Wh^T and
  dx = A @ Wx^T for every (row, column) exactly once, and dh[row, unit]
  lands in the thread (warp, chunk, m tile, lane, element) that holds the
  cell (row, unit) in ``gate_step``'s epilogue.
* A float32 emulation of the whole row pass -- the recompute forward
  through test_torch_lstm_fwd_plan's lane-level ``gate_step`` emulator,
  the elementwise
  backward in the kernel's expression order, dh and dx through the
  emulation above, then the dW/db sums -- is within the K3 class (1e-3
  of the largest value) of ``lstm_window_bwd_plain``.
* ``_FlatOp`` asks K3 for dx only when the window requires grad: a spy on
  ``lstm_window_bwd`` sees ``need_dx=False`` for a window without grad,
  the weight gradients equal the ``need_dx=True`` path's bit for bit, and
  a window that requires grad still gets dx.
"""

import numpy as np
import pytest
import torch

from diral_tpu_torch.ops import lstm_window as K
from test_torch_lstm_fwd_plan import _bf64, _emulate_gate_step

SMEM = 232_448
WARPS = 16
MAIN = [(2048, 23, 256), (25600, 100, 256), (96, 25, 128), (2400, 25, 128),
        (4096, 100, 512), (512, 23, 1024)]
GRID = [(B, D, H) for B in (1, 97, 2047, 4096, 25600) for D in (23, 100)
        for H in range(128, 1025, 128)]


def _smem(bm, Dp, H):
    fwd = 4 * bm * (Dp + 8) + bm * (4 * (H + 8) + 4 * H)
    return max(fwd, 2 * bm * (4 * H + 8) + 4 * bm * H)


@pytest.mark.parametrize("B,D,H", MAIN + GRID)
def test_bwd_plan_fits_and_covers(B, D, H):
    Dp = K.padded_dim(D)
    plan = K._bwd_plan(B, Dp, H)
    assert plan.bm in (16, 32)
    assert plan.smem == _smem(plan.bm, Dp, H) <= SMEM
    # every row in exactly one block
    assert plan.blocks * plan.bm >= B > (plan.blocks - 1) * plan.bm
    # the SMs filled where 16-row tiles allow it, by the largest such tile
    if -(-B // 16) >= 132:
        assert plan.blocks >= 132
        if plan.bm == 16 and -(-B // 32) >= 132:
            assert _smem(32, Dp, H) > SMEM
    else:
        assert plan.bm == 16


def test_bwd_plan_main_shapes():
    """The tiles the main path runs: 32 rows at the 100v/50r train
    event, 16 rows at the toy and PPO shapes and at H = 1024."""
    assert K._bwd_plan(25600, 112, 256) == (32, 800, 98_816)
    assert K._bwd_plan(2048, 32, 256) == (16, 128, 49_408)
    assert K._bwd_plan(2400, 32, 128) == (16, 150, 24_832)
    assert K._bwd_plan(512, 32, 1024) == (16, 32, 196_864)


def test_bwd_plan_is_a_function_of_the_shape(monkeypatch):
    shapes = [(B, K.padded_dim(D), H) for B, D, H in MAIN + GRID]
    first = [K._bwd_plan(*s) for s in shapes]

    def no_card(*_a, **_k):
        raise AssertionError("the plan asked about the card")

    for name in ("is_available", "device_count", "get_device_properties",
                 "current_device"):
        monkeypatch.setattr(torch.cuda, name, no_card)
    assert [K._bwd_plan(*s) for s in shapes] == first


def test_bwd_plan_refuses_only_what_no_tile_fits():
    # a 16-row tile at H = 1024 holds windows up to Dp = 1568
    assert K._bwd_plan(64, 1568, 1024).bm == 16
    with pytest.raises(ValueError, match="no row-pass tile"):
        K._bwd_plan(64, 1584, 1024)


def _weights(D, H, seed):
    rng = np.random.RandomState(seed)
    w = torch.from_numpy(rng.normal(0, 0.1, (D + H, 4 * H)).astype(np.float32))
    return w, K.padded_dim(D)


@pytest.mark.parametrize("D,H", [(23, 128), (25, 128), (100, 256), (23, 512)])
def test_bwd_fragments_are_a_permutation(D, H):
    w, Dp = _weights(D, H, 1)
    packed = K._packed(w, D, Dp)
    frag = K._bwd_fragments(w, D, Dp)
    assert frag.dtype == torch.bfloat16 and frag.is_contiguous()
    assert frag.numel() == packed.numel() == (Dp + H) * 4 * H
    back = frag.permute(0, 2, 1, 4, 5, 3, 6).reshape(Dp + H, 4 * H)
    assert torch.equal(back, packed)
    assert torch.equal(frag.flatten().sort().values,
                       packed.flatten().sort().values)


@pytest.mark.parametrize("D,H", [(23, 128), (100, 256), (23, 512)])
def test_bwd_fragment_index_math(D, H):
    """Element (n, k) where the kernel reads it is P[n, k]."""
    w, Dp = _weights(D, H, 2)
    packed = K._packed(w, D, Dp)
    flat = K._bwd_fragments(w, D, Dp).flatten()
    KP = H // 8
    n = torch.arange(Dp + H)[:, None]
    k = torch.arange(4 * H)[None, :]
    nt, g = n // 8, n % 8
    kp, kk = k // 32, k % 32
    j, khalf, tig, pair = kk // 16, (kk % 16) // 8, (kk % 8) // 2, kk % 2
    uint4 = 32 * (nt * KP + kp) + 4 * g + tig
    idx = 8 * uint4 + 4 * j + 2 * khalf + pair
    assert torch.equal(flat[idx], packed)


LANE = np.arange(32)
G_, TIG = LANE // 4, LANE % 4


def _a_fragment(a, mi, kt):
    """The 16 x 16 A operand that ldmatrix.x4 hands mma.sync, read from
    the kernel's addresses: lane l points at row 16*mi + l % 16, column
    8*(l // 16) + 16*kt; register j of lane l is row l // 4, columns
    2*(l % 4) + (0, 1) of the matrix lanes 8j..8j+7 point at; mma's A
    element a_{2j+h} sits at row g + 8*(j % 2), column 2*tig + h +
    8*(j // 2)."""
    A = np.zeros((16, 16))
    for j in range(4):
        src = 8 * j + LANE // 4            # the lane whose address is used
        r = 16 * mi + src % 16
        c = 8 * (src // 16) + 16 * kt + 2 * TIG
        for h in range(2):
            A[G_ + 8 * (j % 2), 2 * TIG + h + 8 * (j // 2)] = a[r, c + h]
    return A


def _emulate_bwd_tiles(a, words, nt0, n, KP, MB):
    """bwd_tiles for one warp, lane by lane: {(nt, mi): acc [32 lanes, 4]}
    for the warp's n tiles nt0..nt0+n-1 against the A tile a [16*MB, 4H]
    (words: the fragments as uint4s of 8 values)."""
    out = {}
    for nt in range(nt0, nt0 + n):
        acc = np.zeros((MB, 32, 4))
        for kp in range(KP):
            b = words[32 * (nt * KP + kp) + LANE]     # [32 lanes, 8]
            for j in range(2):
                # B element b_i at k = 2*tig + i % 2 + 8*(i // 2), n = g
                Bm = np.zeros((16, 8))
                for i in range(4):
                    Bm[2 * TIG + i % 2 + 8 * (i // 2), G_] = b[:, 4 * j + i]
                for mi in range(MB):
                    D = _a_fragment(a, mi, 2 * kp + j) @ Bm
                    # C element c_e at row g + 8*(e // 2), column
                    # 2*tig + e % 2
                    for e in range(4):
                        acc[mi, :, e] += D[G_ + 8 * (e // 2), 2 * TIG + e % 2]
        for mi in range(MB):
            out[nt, mi] = acc[mi]
    return out


def _owner(row, unit, H):
    """(warp, chunk ci, m tile, lane, element) that holds cell (row, unit)
    in gate_step's epilogue: unit chunk uc = warp*NC + ci, row 16*mi +
    lane/4 + 8*(e // 2), unit 8*uc + 2*(lane % 4) + e % 2."""
    NC, uc = H // (8 * WARPS), unit // 8
    lane = 4 * ((row % 16) % 8) + (unit % 8) // 2
    return (uc // NC, uc % NC, row // 16, lane,
            2 * ((row % 16) // 8) + unit % 2)


def _row_pass_products(a, words, Dp, H, MB, want_dx):
    """dh [16*MB, H] and dx [16*MB, Dp] of one block's products as the
    kernel's warps form them, with the hit count of each output and, for
    dh, the owner of each value."""
    NC, KP, BM = H // (8 * WARPS), H // 8, 16 * MB
    ntx = Dp // 8
    per = -(-ntx // WARPS)
    dh, dx = np.full((BM, H), np.nan), np.full((BM, Dp), np.nan)
    dh_hits, dx_hits = np.zeros((BM, H), int), np.zeros((BM, Dp), int)
    owners = {}
    for warp in range(WARPS):
        tiles = _emulate_bwd_tiles(a, words, ntx + warp * NC, NC, KP, MB)
        for (nt, mi), acc in tiles.items():
            ci = nt - ntx - warp * NC
            for lane in range(32):
                for e in range(4):
                    row = 16 * mi + lane // 4 + 8 * (e // 2)
                    unit = 8 * (nt - ntx) + 2 * (lane % 4) + e % 2
                    dh[row, unit] = acc[lane, e]
                    dh_hits[row, unit] += 1
                    owners[row, unit] = (warp, ci, mi, lane, e)
        n = min(per, ntx - warp * per)
        if want_dx and n > 0:
            tiles = _emulate_bwd_tiles(a, words, warp * per, n, KP, MB)
            for (nt, mi), acc in tiles.items():
                for lane in range(32):
                    for e in range(4):
                        row = 16 * mi + lane // 4 + 8 * (e // 2)
                        col = 8 * nt + 2 * (lane % 4) + e % 2
                        dx[row, col] = acc[lane, e]
                        dx_hits[row, col] += 1
    return dh, dx, dh_hits, dx_hits, owners


@pytest.mark.parametrize("D,H,MB", [(23, 128, 1), (25, 128, 2),
                                    (100, 256, 1)])
def test_bwd_product_emulation(D, H, MB):
    w, Dp = _weights(D, H, 3)
    rng = np.random.RandomState(4)
    BM = 16 * MB
    a = _bf64(rng.normal(0, 0.05, (BM, 4 * H)).astype(np.float32))
    words = K._bwd_fragments(w, D, Dp).to(torch.float64).numpy().reshape(-1, 8)
    P = K._packed(w, D, Dp).to(torch.float64).numpy()
    dh, dx, dh_hits, dx_hits, owners = _row_pass_products(a, words, Dp, H,
                                                          MB, True)
    np.testing.assert_allclose(dh, a @ P[Dp:].T, rtol=0, atol=1e-12)
    np.testing.assert_allclose(dx, a @ P[:Dp].T, rtol=0, atol=1e-12)
    assert (dh_hits == 1).all() and (dx_hits == 1).all()
    assert all(owners[r, u] == _owner(r, u, H)
               for r in range(BM) for u in range(H))


def _gate_math32(gates, c, H):
    """cell() in float32: (c', h', activations [4, rows, H])."""
    f = lambda v: torch.from_numpy(np.asarray(v, np.float32))
    gi, gg, gf, go = (f(gates[:, q * H:(q + 1) * H]) for q in range(4))
    si, tg = torch.sigmoid(gi), torch.tanh(gg)
    sf, so = torch.sigmoid(gf + 1.0), torch.sigmoid(go)
    c = c * sf + si * tg
    return c, torch.tanh(c) * so, (si, tg, sf, so)


def _emulate_row_pass(x2, w, b, g, T, MB):
    """The row pass of every block of 16*MB rows in float32, products in
    the kernel's layouts: returns dx [B, T*Dp], the per-step (bf16 x,
    bf16 h stash, float32 dgates) and the stash."""
    D, H, Dp = K._dims(w)
    B, BM = x2.shape[0], 16 * MB
    frag = K._fragments(w, D, Dp).to(torch.float64).numpy().reshape(-1)
    words = K._bwd_fragments(w, D, Dp).to(torch.float64).numpy().reshape(-1, 8)
    bias = b.float()
    nblk = -(-B // BM)
    xp = torch.zeros((nblk * BM, T * Dp))
    xp[:B] = x2
    gp = torch.zeros((nblk * BM, H))
    gp[:B] = g
    dx = torch.zeros((nblk * BM, T * Dp))
    hst = torch.zeros((T, nblk * BM, H))
    dgs = torch.zeros((T, nblk * BM, 4 * H))
    for blk in range(nblk):
        rows = slice(blk * BM, (blk + 1) * BM)
        h = torch.zeros((BM, H))
        c = torch.zeros((BM, H))
        cs, acts = [c], []
        for t in range(T):
            xt = _bf64(xp[rows, t * Dp:(t + 1) * Dp])
            hst[t, rows] = K._bf(h)
            sums, _, _ = _emulate_gate_step(xt, [_bf64(h)], frag, Dp, H,
                                            MB, 1)
            c, h, act = _gate_math32(np.float32(sums[0]) + bias.numpy(),
                                     c, H)
            cs.append(c)
            acts.append(act)
        dh, dc = gp[rows].clone(), torch.zeros((BM, H))
        for t in reversed(range(T)):
            si, tg, sf, so = acts[t]
            tc = torch.tanh(cs[t + 1])
            do_ = dh * tc
            dao = do_ * so * (1.0 - so)
            dct = dc + dh * so * (1.0 - tc * tc)
            daf = dct * cs[t] * sf * (1.0 - sf)
            dai = dct * tg * si * (1.0 - si)
            dag = dct * si * (1.0 - tg * tg)
            dc = dct * sf
            dgates = torch.cat([dai, dag, daf, dao], dim=1)
            dgs[t, rows] = dgates
            e_dh, e_dx, *_ = _row_pass_products(_bf64(dgates), words, Dp, H,
                                                MB, True)
            dh = torch.from_numpy(e_dh.astype(np.float32))
            dx[rows, t * Dp:(t + 1) * Dp] = torch.from_numpy(
                e_dx.astype(np.float32))
    terms = [(K._bf(x2[:, t * Dp:(t + 1) * Dp]), hst[t, :B], dgs[t, :B])
             for t in range(T)]
    return dx[:B], terms, hst[:, :B]


@pytest.mark.parametrize("B,MB", [(20, 1), (40, 2)])
def test_row_pass_emulation_matches_plain(B, MB):
    """The emulated row pass (and the reduction's sums over its outputs)
    is within the K3 class of the plain version, with bf16 h stash rows
    equal to bf16 of the emulated forward's h."""
    T, D, H = 3, 23, 128
    rng = np.random.RandomState(5)
    lim = np.sqrt(6.0 / (D + 5 * H))
    w = torch.from_numpy(rng.uniform(-lim, lim, (D + H, 4 * H))
                         .astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.1, 4 * H).astype(np.float32))
    x2 = K.flatten_window(torch.from_numpy(
        rng.normal(size=(B, T, D)).astype(np.float32))).contiguous()
    g = torch.from_numpy(rng.normal(size=(B, H)).astype(np.float32))
    Dp = K.padded_dim(D)
    dx, terms, hst = _emulate_row_pass(x2, w, b, g, T, MB)
    dwx = sum(xt.T @ K._bf(dg) for xt, _, dg in terms)
    dwh = sum(ht.T @ K._bf(dg) for _, ht, dg in terms)
    db = sum(dg.sum(dim=0) for *_, dg in terms)
    pdx, pdw, pdb = K.lstm_window_bwd_plain(x2, w, b, g, T, True)
    for got, want in ((dx, pdx), (dwx[:D], pdw[:D]), (dwh, pdw[D:]),
                      (db, pdb)):
        assert float((got - want).abs().max()) <= 1e-3 * float(
            want.abs().max())
    assert (dx.reshape(B, T, Dp)[..., D:] == 0).all()   # pad lanes
    # the stash at step t is bf16 of the forward's h after t steps
    assert torch.equal(hst[0], torch.zeros((B, H)))
    for t in range(1, T):
        ht = K.lstm_last_flat_plain(x2[:, :t * Dp], w, b, t)
        assert float((hst[t] - K._bf(ht)).abs().max()) <= 2 ** -7


def _flat_inputs(seed, B=12, T=3, D=23, H=128):
    rng = np.random.RandomState(seed)
    w = torch.from_numpy(rng.normal(0, 0.1, (D + H, 4 * H)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.1, 4 * H).astype(np.float32))
    x2 = K.flatten_window(torch.from_numpy(
        rng.normal(size=(B, T, D)).astype(np.float32))).contiguous()
    gw = torch.from_numpy(rng.normal(size=(B, H)).astype(np.float32))
    return x2, w, b, gw, T


@pytest.mark.parametrize("window_grad", [False, True])
def test_flat_op_asks_for_dx_only_when_the_window_needs_it(monkeypatch,
                                                           window_grad):
    x2, w, b, gw, T = _flat_inputs(6)
    seen, real = [], K.lstm_window_bwd

    def spy(*args, need_dx=True):
        seen.append(need_dx)
        return real(*args, need_dx=need_dx)

    monkeypatch.setattr(K, "lstm_window_bwd", spy)
    tx = x2.clone().requires_grad_(window_grad)
    tw, tb = w.clone().requires_grad_(), b.clone().requires_grad_()
    (K.lstm_last_flat(tx, tw, tb, T) * gw).sum().backward()
    assert seen == [window_grad]
    pdx, pdw, pdb = real(x2, w, b, gw, T, need_dx=True)
    assert torch.equal(tw.grad, pdw) and torch.equal(tb.grad, pdb)
    if window_grad:
        assert torch.equal(tx.grad, pdx)
    else:
        assert tx.grad is None
