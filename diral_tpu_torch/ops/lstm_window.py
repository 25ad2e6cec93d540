"""The DRQN Q-net's LSTM window kernels (BasicLSTMCell over a short history
window, only the last hidden state consumed; reference
algorithms/drl_drqn.py:109-155) as hand-written CUDA kernels, each beside
its plain PyTorch version.  Sources: ``csrc/lstm_window.cu``.

* K1 ``lstm_last_flat``: one LSTM over the window (pallas_lstm
  ``_fwd_kernel``).
* K4 ``lstm_last_flat_dual``: two LSTMs (online and target weights) over
  the same window (``_fwd_dual_kernel``); forward only.
* K2 ``lstm_last_flat_triple``: over a combined (T+1)-step window, the
  online net on steps 0..T-1 (differentiable), the online and the target
  net on steps 1..T (``_fwd_triple_kernel``).
* K3 ``lstm_window_bwd``: the recompute-forward backward (``_bwd_kernel``):
  (dx or None, dw, db) for a cotangent of the last hidden state.  K1's
  and K2's ``torch.autograd.Function`` take it as their backward.

Window layout, as in diral_tpu/ops/pallas_lstm.py: FLAT [B, T*Dp], each
step's D features at lane offset t*Dp, ``Dp = round_up(D + 2, 16)``.
Pad lanes meet zero rows of the padded input-weight matrix, so they are
inert whatever they hold, and their dx is zero.

Numerics are the TPU kernels' precision class: x, Wx, Wh, h and (in the
backward) dgates are rounded to bfloat16 before each product, products
are summed in float32, gate math is float32; db sums the unrounded
dgates.  The canonical full-precision path is models/recurrent.lstm_scan
(the float64 CPU parity path).  bf16 x bf16 products are exact in
float32, so a plain version differs from its kernel only in the order of
sums (and last bits of exp/tanh).

Wrappers: CPU tensors run the plain version, CUDA tensors launch the
kernel or raise.  Each wrapper's ``launches`` counts kernel launches (a K3
call counts once, though it is three launches: the row pass, then the
dW/db reduction as a split-K partial pass and an in-order combine).

The forwards (K1, K4, K2) share one tensor-core step: per step the gate
sums [x_t | h] @ W run on ``mma.sync`` bf16 tiles in one fixed k order,
so K4 equals two K1 calls and K2 equals K1 and K4 bit for bit.  Two host
pieces feed them, both functions of the shape alone and CPU-tested
(tests/test_torch_lstm_fwd_plan.py): ``_fwd_plan`` picks the rows of a
block (16, 32 or 64) that fit 227 KB of shared memory and fill the
H100's 132 SMs where B allows, and refuses a shape that no tile fits (K2
and K4 at H = 1024); ``_fragments`` permutes each net's packed bf16
weights into the order of the mma B fragments, so each warp streams its
units' weights from L2 with 16-byte loads.  K1's cells divide without a
branch and its first step skips the h tiles (zeros); chip_smoke.py holds
it bit-equal to K4, which does neither.

K3's reduction cuts the T*B rows into S chunks by ``_reduce_plan``, a
function of the shape alone (never of the card), so dW and db are the
same bits on any card; the wrapper allocates the float32 partials
[S, Dp+H+1, 4H] (the last row holds db's) with the rest of the scratch.
K3's row pass recomputes the forward with the forwards' tensor-core step,
so its activations and its bf16 h stash equal K1's forward bit for bit,
and forms dh = bf16(dgates) @ Wh^T and dx = bf16(dgates) @ Wx^T on
``mma.sync`` tiles too, against the packed weights that
``_bwd_fragments`` permutes into B-fragment order; ``_bwd_plan`` (shape
only, CPU-tested in tests/test_torch_k3_rows_plan.py) picks its row
tile.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
import torch.nn.functional as F

from diral_tpu_torch.ops import _build

_PTR, _INT = ctypes.c_void_p, ctypes.c_int


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
    """Shapes/dtypes the kernels serve (pallas_lstm.py:561-566): float32 or
    bfloat16 windows and H a multiple of 128.  Float64 -- the CPU parity
    suite -- takes the canonical lstm_scan."""
    return x_dtype in (torch.float32, torch.bfloat16) and hidden % 128 == 0


def _dims(w):
    H = w.shape[1] // 4
    D = w.shape[0] - H
    return D, H, padded_dim(D)


def _split_weights(w, D: int, Dp: int):
    """(Wx padded to Dp rows with zeros, Wh), both rounded to bfloat16."""
    wx = F.pad(w[:D], (0, 0, 0, Dp - D)).to(torch.bfloat16)
    return wx, w[D:].to(torch.bfloat16)


def _gate_math(c, gates, H: int):
    """(c', h', (si, tg, sf, so)) of one BasicLSTMCell step."""
    i, g, f, o = gates.split(H, dim=-1)
    si = torch.sigmoid(i)
    tg = torch.tanh(g)
    sf = torch.sigmoid(f + 1.0)   # BasicLSTMCell forget bias
    so = torch.sigmoid(o)
    c = c * sf + si * tg
    return c, torch.tanh(c) * so, (si, tg, sf, so)


def _bf(t):
    """Round to bfloat16, compute in float32."""
    return t.to(torch.bfloat16).to(torch.float32)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _check_width(x2, width: int):
    if x2.shape[1] != width:
        raise ValueError(f"window width {x2.shape[1]} != {width}")


def lstm_last_flat_plain(x2, w, b, T: int):
    """Plain PyTorch version of K1.  x2: [B, T*Dp]; w: [D+H, 4H]; b: [4H].
    Returns [B, H] in x2's dtype."""
    f32 = torch.float32
    D, H, Dp = _dims(w)
    _check_width(x2, T * Dp)
    wx, wh = (m.to(f32) for m in _split_weights(w, D, Dp))
    bias = b.to(f32)
    h = torch.zeros((x2.shape[0], H), dtype=f32, device=x2.device)
    c = torch.zeros_like(h)
    for t in range(T):
        gates = _bf(x2[:, t * Dp:(t + 1) * Dp]) @ wx + _bf(h) @ wh + bias
        c, h, _ = _gate_math(c, gates, H)
    return h.to(x2.dtype)


def lstm_last_flat_dual_plain(x2, wa, ba, wb, bb, T: int):
    """Plain PyTorch version of K4: two K1 forwards over the same window."""
    return (lstm_last_flat_plain(x2, wa, ba, T),
            lstm_last_flat_plain(x2, wb, bb, T))


def lstm_last_flat_triple_plain(x2c, w, b, wt, bt, T: int):
    """Plain PyTorch version of K2.  x2c: [B, (T+1)*Dp].  Returns (h_s,
    h_na, h_nb): the online net over steps 0..T-1, the online and the
    target net over steps 1..T."""
    _, _, Dp = _dims(w)
    _check_width(x2c, (T + 1) * Dp)
    h_s = lstm_last_flat_plain(x2c[:, :T * Dp], w, b, T)
    h_na, h_nb = lstm_last_flat_dual_plain(x2c[:, Dp:], w, b, wt, bt, T)
    return h_s, h_na, h_nb


def _bwd_plain_terms(x2, w, b, g, T: int, need_dx: bool):
    """K3's plain recompute and backward sweep: (dx or None, terms), where
    terms lists, for t = T-1 down to 0, (bf16 x_t [B, Dp], bf16 h_{t-1}
    [B, H], unrounded float32 dgates_t [B, 4H]) -- the rows that dW and db
    sum over."""
    f32 = torch.float32
    D, H, Dp = _dims(w)
    _check_width(x2, T * Dp)
    wx, wh = (m.to(f32) for m in _split_weights(w, D, Dp))
    bias = b.to(f32)
    B, dev = x2.shape[0], x2.device
    xs = [_bf(x2[:, t * Dp:(t + 1) * Dp]) for t in range(T)]
    h = torch.zeros((B, H), dtype=f32, device=dev)
    c = torch.zeros_like(h)
    h_prev, cs, acts = [], [c], []
    for t in range(T):
        h_prev.append(_bf(h))
        gates = xs[t] @ wx + h_prev[t] @ wh + bias
        c, h, act = _gate_math(c, gates, H)
        cs.append(c)
        acts.append(act)
    dh = g.to(f32)
    dc = torch.zeros_like(dh)
    dx = (torch.zeros((B, T * Dp), dtype=x2.dtype, device=dev)
          if need_dx else None)
    terms = []
    for t in reversed(range(T)):
        si, tg, sf, so = acts[t]
        c_prev = cs[t]
        tc = torch.tanh(cs[t + 1])
        do_ = dh * tc
        dao = do_ * so * (1.0 - so)
        dct = dc + dh * so * (1.0 - tc * tc)
        daf = dct * c_prev * sf * (1.0 - sf)
        dai = dct * tg * si * (1.0 - si)
        dag = dct * si * (1.0 - tg * tg)
        dgates = torch.cat([dai, dag, daf, dao], dim=1)  # i, g, f, o
        dc = dct * sf
        dgb = _bf(dgates)
        dh = dgb @ wh.T
        if need_dx:
            dx[:, t * Dp:(t + 1) * Dp] = (dgb @ wx.T).to(x2.dtype)
        terms.append((xs[t], h_prev[t], dgates))
    return dx, terms


def lstm_window_bwd_plain(x2, w, b, g, T: int, need_dx: bool = True):
    """Plain PyTorch version of K3, the arithmetic of pallas_lstm
    ``_bwd_kernel``: recompute the forward (h_{t-1} rounded to bf16, c in
    float32), then sweep back from the cotangent ``g`` [B, H] of the last
    hidden state; dgates are rounded to bf16 before the dh, dx and dW
    products, db sums them unrounded.  Returns (dx [B, T*Dp] in x2's dtype
    or None, dw [D+H, 4H] in w's dtype, db [4H] in b's dtype)."""
    f32 = torch.float32
    D, H, Dp = _dims(w)
    dx, terms = _bwd_plain_terms(x2, w, b, g, T, need_dx)
    dwx = torch.zeros((Dp, 4 * H), dtype=f32, device=x2.device)
    dwh = torch.zeros((H, 4 * H), dtype=f32, device=x2.device)
    db = torch.zeros(4 * H, dtype=f32, device=x2.device)
    for x_t, h_t, dgates in terms:
        dgb = _bf(dgates)
        dwx += x_t.T @ dgb
        dwh += h_t.T @ dgb
        db += dgates.sum(dim=0)
    dw = torch.cat([dwx[:D], dwh], dim=0).to(w.dtype)
    return dx, dw, db.to(b.dtype)


# ---------------------------------------------------------------------------
# Kernel launches (CUDA tensors)
# ---------------------------------------------------------------------------


def _check_cuda(name, x2, steps: int, *params):
    """Validate what a kernel takes: a CUDA window [B, steps*Dp] in float32
    or bfloat16 whose rows are contiguous (any row stride), and (w, b)
    pairs on its device with w [D+H, 4H], b [4H], H % 128 == 0, H <= 1024.
    Returns (D, H, Dp)."""
    if x2.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x2.device}")
    D, H, Dp = _dims(params[0])
    width = steps * Dp
    if not supported(x2.dtype, H) or H > 1024:
        raise ValueError(f"{name}: unsupported dtype={x2.dtype}, hidden={H} "
                         f"(float32/bfloat16, H % 128 == 0, H <= 1024)")
    if x2.dim() != 2 or x2.shape[1] != width or x2.stride(1) != 1:
        raise ValueError(f"{name}: x must be a [B, {width}] window with "
                         f"contiguous rows, got {tuple(x2.shape)}")
    for p in params:
        if p.device != x2.device:
            raise ValueError(f"{name}: weights and window on different "
                             f"devices")
    for wi, bi in zip(params[0::2], params[1::2]):
        if tuple(wi.shape) != (D + H, 4 * H) or tuple(bi.shape) != (4 * H,):
            raise ValueError(f"{name}: weight {tuple(wi.shape)} / bias "
                             f"{tuple(bi.shape)} do not match [D+H, 4H]")
    return D, H, Dp


def _packed(w, D: int, Dp: int):
    """K3's weight layout: [Wx padded to Dp rows; Wh] in bf16."""
    return torch.cat(_split_weights(w, D, Dp), dim=0).contiguous()


def _fragments(w, D: int, Dp: int):
    """The forwards' weight layout: ``_packed`` [K = Dp+H, 4H] permuted into
    the order of mma.sync m16n8k16 B fragments, a contiguous tensor whose
    memory is [H/8 chunks uc, K/16 k tiles kt, 2, 32 lanes, 8]: lane
    l = 4*g + tig holds, as two 16-byte words, gates (i, g) then (f, o)
    of column q*H + 8*uc + g at rows 16*kt + 2*tig + (0, 1, 8, 9) -- the
    B registers {b0, b1}, {b2, b3} of each gate's n8 tile.  A permutation
    of the packed weights."""
    wpk = _packed(w, D, Dp)
    K, G = wpk.shape
    H = G // 4
    # k = 16*kt + 8*khalf + 2*tig + pair; n = H*(2*qh + ql) + 8*uc + g
    v = wpk.reshape(K // 16, 2, 4, 2, 2, 2, H // 8, 8)
    return v.permute(6, 0, 4, 7, 2, 5, 1, 3).contiguous()


def _bwd_fragments(w, D: int, Dp: int):
    """K3's row-pass weight layout for dh = A @ Wh^T and dx = A @ Wx^T
    (A: bf16 dgates [rows, 4H]): ``_packed`` P [Dp+H, 4H] read as the
    col-major B [K = 4H, N = Dp+H] of those products and permuted into
    mma.sync m16n8k16 B-fragment order, a contiguous tensor whose memory
    is [(Dp+H)/8 n tiles nt, H/8 k pairs kp, 32 lanes, 8]: lane
    l = 4*g + tig holds, as one 16-byte word, P[8*nt + g, k] at
    k = 32*kp + 16*j + 8*khalf + 2*tig + pair in position
    4*j + 2*khalf + pair -- the B registers {b0, b1}, {b2, b3} of k tiles
    2*kp and 2*kp + 1.  n tiles 0..Dp/8-1 are Wx, the rest Wh.  A
    permutation of the packed weights."""
    wpk = _packed(w, D, Dp)
    N, K = wpk.shape
    # n = 8*nt + g; k = 32*kp + 16*j + 8*khalf + 2*tig + pair
    v = wpk.reshape(N // 8, 8, K // 32, 2, 2, 4, 2)
    return v.permute(0, 2, 1, 5, 3, 4, 6).contiguous()


# The forwards' plan: blocks of 16 warps (512 threads, so at most 128
# registers a thread) over _FWD_ROWS rows; at most _FWD_MAX_MTILES m16
# row tiles in one product (per tile a thread holds 16 accumulator
# floats and 4 A-fragment registers); _FWD_SMEM bytes of shared memory a
# block may use and _FWD_SMS SMs to fill (the H100's); shared rows
# padded by _FWD_PAD bf16.
_FWD_ROWS = (64, 32, 16)
_FWD_MAX_MTILES = 4
_FWD_SMEM = 232_448
_FWD_SMS = 132
_FWD_PAD = 8


class FwdPlan(NamedTuple):
    """A forward launch: ``bm`` rows a block, ``blocks`` blocks, ``smem``
    bytes of dynamic shared memory a block."""
    bm: int
    blocks: int
    smem: int


def _fwd_smem(bm: int, Dp: int, H: int, recs: int) -> int:
    """Shared memory of a forward block (csrc fwd_smem_bytes): the bf16 x
    tile [2][bm][Dp+pad] and, per recurrence, bf16 h [2][bm][H+pad] and
    float32 c [bm][H]."""
    return 4 * bm * (Dp + _FWD_PAD) + recs * bm * (4 * (H + _FWD_PAD) + 4 * H)


def _fwd_plan(B: int, Dp: int, H: int, recs: int) -> FwdPlan:
    """The forward plan for the shape alone: ``recs`` recurrences a block
    (K1 1, K4 2, K2 3 -- K2 stacks two of them as 2*bm rows of one
    product).  The largest row tile that fits shared memory and the
    accumulator and still gives >= ``_FWD_SMS`` blocks, else the smallest
    that fits; ValueError where none fits."""
    stack = 2 if recs == 3 else 1
    fits = [bm for bm in _FWD_ROWS
            if stack * bm // 16 <= _FWD_MAX_MTILES
            and _fwd_smem(bm, Dp, H, recs) <= _FWD_SMEM]
    if not fits:
        raise ValueError(
            f"no tensor-core forward tile fits H={H}, Dp={Dp} with {recs} "
            f"recurrence(s): {_fwd_smem(16, Dp, H, recs)} bytes of shared "
            f"memory at 16 rows, over {_FWD_SMEM}")
    bm = next((bm for bm in fits if -(-B // bm) >= _FWD_SMS), fits[-1])
    return FwdPlan(bm, -(-B // bm), _fwd_smem(bm, Dp, H, recs))


# K3's row pass: the forwards' blocks of 16 warps over _BWD_ROWS rows
# (at most 2 m16 tiles: the recompute forward also keeps each cell's four
# activations in registers), within the same shared memory and SMs.
_BWD_ROWS = (32, 16)


class BwdPlan(NamedTuple):
    """K3's row-pass launch: ``bm`` rows a block, ``blocks`` blocks,
    ``smem`` bytes of dynamic shared memory a block."""
    bm: int
    blocks: int
    smem: int


def _bwd_smem(bm: int, Dp: int, H: int) -> int:
    """Shared memory of a row-pass block (csrc rows_smem_bytes): the
    forward sweep's (``_fwd_smem``, one recurrence), reused by the
    backward sweep for the bf16 A tile [bm][4H+pad] and float32 dh
    [bm][H]."""
    return max(_fwd_smem(bm, Dp, H, 1),
               2 * bm * (4 * H + _FWD_PAD) + 4 * bm * H)


def _bwd_plan(B: int, Dp: int, H: int) -> BwdPlan:
    """K3's row-pass plan for the shape alone (T does not enter: the c
    history lives in device scratch).  The largest row tile that fits
    and still gives >= ``_FWD_SMS`` blocks, else the smallest that fits;
    ValueError where none fits."""
    fits = [bm for bm in _BWD_ROWS if _bwd_smem(bm, Dp, H) <= _FWD_SMEM]
    if not fits:
        raise ValueError(
            f"no row-pass tile fits H={H}, Dp={Dp}: {_bwd_smem(16, Dp, H)} "
            f"bytes of shared memory at 16 rows, over {_FWD_SMEM}")
    bm = next((bm for bm in fits if -(-B // bm) >= _FWD_SMS), fits[-1])
    return BwdPlan(bm, -(-B // bm), _bwd_smem(bm, Dp, H))


def _bias(b):
    return b.to(torch.float32).contiguous()


def _library():
    """The kernels' library, built before anything is allocated on the
    device, so a missing toolkit raises first."""
    return _build.library("lstm_window")


def _launch(lib, symbol, argtypes, x2, *args):
    """Launch ``symbol``: ``argtypes`` declares the leading arguments, the
    rest of ``args`` are ints, then x2's type flag."""
    ints = [_INT] * (len(args) - len(argtypes) + 1)
    _build.launch(lib, symbol, argtypes + ints, x2.device, *args,
                  int(x2.dtype == torch.bfloat16))


def _fwd_check(name, x2, steps: int, recs: int, *params):
    """``_check_cuda`` and the forward plan: (D, H, Dp, plan)."""
    D, H, Dp = _check_cuda(name, x2, steps, *params)
    try:
        plan = _fwd_plan(x2.shape[0], Dp, H, recs)
    except ValueError as e:
        raise ValueError(f"{name}: {e}") from None
    return D, H, Dp, plan


def _k1(x2, w, b, T: int):
    D, H, Dp, plan = _fwd_check("lstm_last_flat", x2, T, 1, w, b)
    lib = _library()
    out = torch.empty((x2.shape[0], H), dtype=x2.dtype, device=x2.device)
    _launch(lib, "lstm_window_launch", [_PTR, _INT, _PTR, _PTR, _PTR], x2,
            x2, x2.stride(0), _fragments(w, D, Dp), _bias(b), out,
            x2.shape[0], T, Dp, H, plan.bm)
    lstm_last_flat.launches += 1
    return out


def _k2(x2c, w, b, wt, bt, T: int):
    D, H, Dp, plan = _fwd_check("lstm_last_flat_triple", x2c, T + 1, 3,
                                w, b, wt, bt)
    lib = _library()
    outs = [torch.empty((x2c.shape[0], H), dtype=x2c.dtype,
                        device=x2c.device) for _ in range(3)]
    _launch(lib, "lstm_triple_launch", [_PTR, _INT] + [_PTR] * 7, x2c,
            x2c, x2c.stride(0), _fragments(w, D, Dp), _bias(b),
            _fragments(wt, D, Dp), _bias(bt), *outs, x2c.shape[0], T, Dp, H,
            plan.bm)
    lstm_last_flat_triple.launches += 1
    return tuple(outs)


# K3's reduction plan: output tiles of _RED_TILE x _RED_TILE, chunks of
# about _RED_CHUNK rows and at least _RED_MIN_ROWS, enough of them for
# _RED_MIN_BLOCKS blocks (two waves of the H100's 132 SMs), and at most
# _RED_SCRATCH bytes of partials.
_RED_TILE = 128
_RED_CHUNK = 2048
_RED_MIN_ROWS = 64
_RED_MIN_BLOCKS = 264
_RED_SCRATCH = 256 << 20


class ReducePlan(NamedTuple):
    """How K3's reduction splits its T*B rows: ``per_step`` chunks per
    step, ``splits`` = T * per_step in all; split s is chunk
    k = s % per_step of step t = s // per_step, rows k*B // per_step up to
    (k+1)*B // per_step of that step (``chunks``)."""
    per_step: int
    splits: int

    def chunks(self, B: int):
        """[(t, row0, row1)] of each split, in order of s."""
        p = self.per_step
        return [(s // p, (s % p) * B // p, (s % p + 1) * B // p)
                for s in range(self.splits)]


def _reduce_plan(B: int, T: int, Dp: int, H: int) -> ReducePlan:
    """K3's reduction plan for the shape (B, T, Dp, H), and nothing else:
    chunks of about ``_RED_CHUNK`` rows, more where that leaves fewer
    than ``_RED_MIN_BLOCKS`` blocks, never under ``_RED_MIN_ROWS`` rows
    (a step of fewer rows is one chunk), never over ``_RED_SCRATCH``
    bytes of partials; a chunk never crosses a step."""
    M, G = Dp + H, 4 * H
    tiles = -(-M // _RED_TILE) * (G // _RED_TILE)
    split_bytes = 4 * (M + 1) * G
    if T * split_bytes > _RED_SCRATCH:
        raise ValueError(f"lstm_window_bwd: T={T}, Dp={Dp}, H={H} needs "
                         f"{T * split_bytes} bytes of partials, over "
                         f"{_RED_SCRATCH}")
    per_step = max(-(-B // _RED_CHUNK), -(-_RED_MIN_BLOCKS // (T * tiles)))
    per_step = min(per_step, max(1, B // _RED_MIN_ROWS),
                   _RED_SCRATCH // (T * split_bytes))
    return ReducePlan(per_step, T * per_step)


def _k3_launch(x2, w, b, g, T: int, need_dx: bool):
    """K3 on the card: (dx or None, dw, db, hstash), the last the row
    pass's bf16 h_{t-1} stash [T, B, H] (K1's h after t steps, rounded).
    ``_k3`` drops the stash; chip_smoke.py holds it against K1."""
    D, H, Dp = _check_cuda("lstm_window_bwd", x2, T, w, b)
    if x2.data_ptr() % 16 or x2.stride(0) % 8:
        raise ValueError("lstm_window_bwd: window rows must start at "
                         "16-byte boundaries (row stride a multiple of 8)")
    lib = _library()
    B, dev = x2.shape[0], x2.device
    g = g.to(x2.dtype).contiguous()
    if tuple(g.shape) != (B, H):
        raise ValueError(f"lstm_window_bwd: cotangent {tuple(g.shape)} != "
                         f"{(B, H)}")
    plan = _reduce_plan(B, T, Dp, H)
    try:
        rows = _bwd_plan(B, Dp, H)
    except ValueError as e:
        raise ValueError(f"lstm_window_bwd: {e}") from None
    f32 = torch.float32
    gates = torch.empty((T, B, 4 * H), dtype=f32, device=dev)
    hstash = torch.empty((T, B, H), dtype=torch.bfloat16, device=dev)
    cst = torch.empty((T, rows.blocks * rows.bm * H), dtype=f32, device=dev)
    part = torch.empty((plan.splits, Dp + H + 1, 4 * H), dtype=f32,
                       device=dev)
    dx = (torch.empty((B, T * Dp), dtype=x2.dtype, device=dev)
          if need_dx else None)
    dw = torch.empty((Dp + H, 4 * H), dtype=f32, device=dev)
    db = torch.empty(4 * H, dtype=f32, device=dev)
    _launch(lib, "lstm_bwd_launch", [_PTR, _INT] + [_PTR] * 11, x2,
            x2, x2.stride(0), _fragments(w, D, Dp), _bwd_fragments(w, D, Dp),
            _bias(b), g, gates, hstash, cst, dx, dw, db, part, plan.per_step,
            B, T, Dp, H, rows.bm)
    lstm_window_bwd.launches += 1
    dw = torch.cat([dw[:D], dw[Dp:]], dim=0).to(w.dtype)
    return dx, dw, db.to(b.dtype), hstash


def _k3(x2, w, b, g, T: int, need_dx: bool):
    return _k3_launch(x2, w, b, g, T, need_dx)[:3]


def _on_cpu(x2) -> bool:
    return x2.device.type == "cpu"


def _forward_k1(x2, w, b, T: int):
    return lstm_last_flat_plain(x2, w, b, T) if _on_cpu(x2) else _k1(x2, w, b, T)


def _forward_k2(x2c, w, b, wt, bt, T: int):
    if _on_cpu(x2c):
        return lstm_last_flat_triple_plain(x2c, w, b, wt, bt, T)
    return _k2(x2c, w, b, wt, bt, T)


# ---------------------------------------------------------------------------
# Public wrappers
# ---------------------------------------------------------------------------


def lstm_window_bwd(x2, w, b, g, T: int, need_dx: bool = True):
    """K3: (dx or None, dw, db) of ``h_last = lstm_last_flat(x2, w, b, T)``
    for the cotangent ``g`` [B, H].  dw and db do not depend on
    ``need_dx``."""
    if _on_cpu(x2):
        return lstm_window_bwd_plain(x2, w, b, g, T, need_dx)
    return _k3(x2, w, b, g, T, need_dx)


lstm_window_bwd.launches = 0


class _FlatOp(torch.autograd.Function):
    """K1 with K3 as its backward: the counterpart of pallas_lstm
    ``_flat_op``.  K3 forms dx only when the window requires grad (the
    PPO encoders' windows are observations that need none); dw and db
    are the same either way."""

    @staticmethod
    def forward(ctx, x2, w, b, T):
        ctx.save_for_backward(x2, w, b)
        ctx.T = T
        return _forward_k1(x2, w, b, T)

    @staticmethod
    def backward(ctx, g):
        x2, w, b = ctx.saved_tensors
        dx, dw, db = lstm_window_bwd(x2, w, b, g, ctx.T,
                                     need_dx=ctx.needs_input_grad[0])
        return dx, dw, db, None


class _TripleOp(torch.autograd.Function):
    """K2 with K3 (``need_dx=False``, on the first T*Dp lanes) as the
    backward of h_s: the counterpart of pallas_lstm ``_triple_op``.  h_na
    and h_nb are non-differentiable (the Double-DQN target is never
    differentiated, drl_drqn.py:267-292); the window and the target
    weights get no gradient."""

    @staticmethod
    def forward(ctx, x2c, w, b, wt, bt, T):
        hs, hna, hnb = _forward_k2(x2c, w, b, wt, bt, T)
        ctx.mark_non_differentiable(hna, hnb)
        ctx.save_for_backward(x2c, w, b)
        ctx.T = T
        return hs, hna, hnb

    @staticmethod
    def backward(ctx, g_s, _g_na, _g_nb):
        x2c, w, b = ctx.saved_tensors
        T = ctx.T
        _, dw, db = lstm_window_bwd(x2c[:, :T * _dims(w)[2]], w, b, g_s, T,
                                    need_dx=False)
        return None, dw, db, None, None, None


def _wants_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def lstm_last_flat(x2, w, b, T: int):
    """K1: fused LSTM over a FLAT padded window -> last hidden [B, H] in
    x2's dtype.  x2: [B, T*Dp]; w: [D+H, 4H]; b: [4H].  Differentiable
    (K3 backward) when an input requires grad."""
    if _wants_grad(x2, w, b):
        return _FlatOp.apply(x2, w, b, T)
    return _forward_k1(x2, w, b, T)


lstm_last_flat.launches = 0


def lstm_last_flat_dual(x2, wa, ba, wb, bb, T: int):
    """K4: (h_last under weights a, h_last under weights b) for the same
    flat windows.  Forward only: the outputs carry no gradient (the
    Double-DQN target path)."""
    with torch.no_grad():
        if _on_cpu(x2):
            return lstm_last_flat_dual_plain(x2, wa, ba, wb, bb, T)
        D, H, Dp, plan = _fwd_check("lstm_last_flat_dual", x2, T, 2,
                                    wa, ba, wb, bb)
        lib = _library()
        ha, hb = (torch.empty((x2.shape[0], H), dtype=x2.dtype,
                              device=x2.device) for _ in range(2))
        _launch(lib, "lstm_dual_launch", [_PTR, _INT] + [_PTR] * 6, x2,
                x2, x2.stride(0), _fragments(wa, D, Dp), _bias(ba),
                _fragments(wb, D, Dp), _bias(bb), ha, hb, x2.shape[0], T, Dp,
                H, plan.bm)
        lstm_last_flat_dual.launches += 1
        return ha, hb


lstm_last_flat_dual.launches = 0


def lstm_last_flat_triple(x2c, w, b, wt, bt, T: int):
    """K2: (h_s, h_na, h_nb) over a combined flat (T+1)-step window
    [B, (T+1)*Dp]: the loss forward (steps 0..T-1, differentiable through
    K3 when w or b requires grad) and the Double-DQN target pair (steps
    1..T, online + target nets, no gradient)."""
    if _wants_grad(w, b):
        return _TripleOp.apply(x2c, w, b, wt, bt, T)
    return _forward_k2(x2c, w, b, wt, bt, T)


lstm_last_flat_triple.launches = 0


def lstm_last(x, w, b):
    """Fused LSTM over a [B, T, D] window -> last hidden [B, H]; semantics
    of ``lstm_scan(params, x)[1][:, -1]`` within the bf16-product
    precision class."""
    return lstm_last_flat(flatten_window(x).contiguous(), w, b, x.shape[1])
