"""K6's launch plan, K7's cached edges and the shared launch path, on the
CPU.

``csrc/piggy_hist.cu`` runs only on the card.  What its launch rests on is
checked here:

* ``_k6_plan(B, N, nbins)``: the kernel's block -> (env, row) map covers
  every (env, vehicle row) exactly once; 16-byte loads only where N % 4 ==
  0, and then a lane's four entries cover the row exactly once; shared
  memory (one int histogram of nbins a warp) within 48 KB up to nbins =
  1024 and beyond, so no opt-in attribute; >= 132 blocks wherever B * N
  rows allow; a float32 emulation of the kernel over that map equals
  ``piggy_histogram_plain`` bit for bit.
* ``lanes_hist._edges``: the cached ctypes edges equal ``np.linspace(...,
  dtype=float32)`` bit for bit at the configs' (+-500, 20) and (+-500, 50).
* ``_build.launch`` on a stand-in library object: each C entry is bound
  once (``argtypes`` set on the first call only), tensors go as their
  pointers and the stream last, a non-zero return raises with
  ``dtt_error_string``'s text, and the device is switched only where it is
  not the current one.
* Both wrappers' host paths on tensors that report a CUDA device: K6 hands
  the plan to the C entry; K7 the cached edges and hist / cnt as two
  contiguous views of one allocation.
"""

import ctypes
import itertools

import numpy as np
import pytest
import torch

from diral_tpu_torch.ops import _build
from diral_tpu_torch.ops import lanes_hist as K7
from diral_tpu_torch.ops import piggy_hist as K6

BS = (1, 5, 16, 256)
NS = (1, 4, 6, 37, 100, 255, 256)
BINS = (1, 20, 50, 128, 1024)
SHAPES = list(itertools.product(BS, NS, BINS))


def kernel_rows(plan, B, N):
    """(env, row) of every (block, warp, k) the kernel runs a row for, in
    piggy_hist_kernel's index math; rows past N are skipped there."""
    blk, warp, k = np.meshgrid(np.arange(plan.grid[0]), np.arange(plan.warps),
                               np.arange(plan.rows_per_warp), indexing="ij")
    b, tile = blk // plan.tiles, blk % plan.tiles
    u = (tile * plan.rows_per_warp + k) * plan.warps + warp
    keep = u < N
    return b[keep], u[keep]


@pytest.mark.parametrize("B,N,nbins", SHAPES)
def test_k6_plan_covers_each_row_once(B, N, nbins):
    plan = K6._k6_plan(B, N, nbins)
    assert plan.grid == (B * plan.tiles,)
    assert plan.tiles == -(-N // (plan.warps * plan.rows_per_warp))
    b, u = kernel_rows(plan, B, N)
    seen = np.zeros((B, N), np.int64)
    np.add.at(seen, (b, u), 1)
    assert (seen == 1).all()
    # a tile holds rows of one env only, and no warp is idle in every tile
    assert plan.warps <= -(-N // plan.rows_per_warp)


@pytest.mark.parametrize("B,N,nbins", SHAPES)
def test_k6_plan_limits(B, N, nbins):
    plan = K6._k6_plan(B, N, nbins)
    assert plan.vec == (4 if N % 4 == 0 else 1)
    assert plan.smem == 4 * plan.warps * nbins <= 48 * 1024
    assert 1 <= plan.warps <= K6.MAX_WARPS
    if B * N >= K6.SMS:
        assert plan.grid[0] >= K6.SMS
    # more than one row a warp only past the warps the card holds at once
    assert (plan.rows_per_warp == 1) == (B * N <= K6.WAVE_WARPS)


@pytest.mark.parametrize("N", NS)
def test_k6_loads_cover_the_row(N):
    """With 16-byte loads (N % 4 == 0) a lane's q = lane, lane + 32, ... <
    N / 4 take entries 4q .. 4q + 3; with one-entry loads j = lane, lane +
    32, ... < N.  Either way every entry exactly once."""
    if K6._k6_plan(1, N, 20).vec == 4:
        j = [4 * q + c for lane in range(32) for q in range(lane, N // 4, 32)
             for c in range(4)]
    else:
        j = [j for lane in range(32) for j in range(lane, N, 32)]
    assert sorted(j) == list(range(N))


def test_k6_plan_shapes_and_refusals():
    assert K6._k6_plan(16, 100, 50) == K6.K6Plan(8, 1, 13, (208,), 4, 1600)
    assert K6._k6_plan(16, 100, 50).grid[0] > 16     # > one block an env
    assert K6._k6_plan(1, 1, K6.MAX_BINS).smem == 48 * 1024
    for bad in ((0, 4, 20), (4, 0, 20), (4, 4, 0), (4, 4, K6.MAX_BINS + 1)):
        with pytest.raises(ValueError):
            K6._k6_plan(*bad)


def k6_emulate(table_x, table_y, pos_x, pos_y, table_age, R, nbins):
    """float32 numpy emulation of piggy_hist_kernel over its plan's map:
    each (block, warp, k) row counts its entries into its own histogram
    (integer adds) and writes hits * (1 / count)."""
    B, N = pos_x.shape
    plan = K6._k6_plan(B, N, nbins)
    Rf, scale = (np.float32(c) for c in K6._consts(R, nbins, torch.float32))
    out = np.full((B, N, nbins), np.nan, np.float32)
    for b, u in zip(*kernel_rows(plan, B, N)):
        dx = table_x[b, u] - pos_x[b, u]
        dy = table_y[b, u] - pos_y[b, u]
        d = np.sqrt(dx * dx + dy * dy)
        valid = (table_age[b, u] < K6.STALENESS_CUTOFF) & (d < Rf)
        valid[u] = False
        signed = np.where(dx > 0, d, -d)
        idx = np.clip(np.floor((signed + Rf) * scale).astype(np.int64), 0,
                      nbins - 1)
        hist = np.bincount(idx[valid], minlength=nbins)
        cnt = int(valid.sum())
        inv = np.float32(1) / np.float32(cnt) if cnt else np.float32(0)
        out[b, u] = hist.astype(np.float32) * inv
    return out


@pytest.mark.parametrize("B,N,nbins", [(3, 37, 50), (2, 100, 20),
                                       (5, 8, 128), (1, 1, 20)])
def test_k6_emulation_matches_plain(B, N, nbins):
    rng = np.random.RandomState(N + nbins)
    R = 500.0
    pos_x = rng.randint(0, 2000, (B, N)).astype(np.float32)
    offs = rng.uniform(-700, 700, (B, N, N))
    edge = rng.randint(0, nbins + 1, (B, N, N)) * (2 * R / nbins) - R
    offs = np.where(rng.rand(B, N, N) < 0.25, edge, offs)
    a = [(pos_x[:, :, None] + offs).astype(np.float32),
         np.zeros((B, N, N), np.float32), pos_x, np.zeros((B, N), np.float32),
         rng.randint(0, 30, (B, N, N)).astype(np.int32)]
    want = K6.piggy_histogram_plain(*map(torch.from_numpy, a), R, nbins)
    np.testing.assert_array_equal(k6_emulate(*a, R, nbins), want.numpy())


@pytest.mark.parametrize("lo,hi,nbins", [(-500.0, 500.0, 20),
                                         (-500.0, 500.0, 50)])
def test_k7_cached_edges_are_linspace(lo, hi, nbins):
    want = np.linspace(lo, hi, nbins + 1, dtype=np.float32)
    got = K7._edges(lo, hi, nbins)
    assert isinstance(got, ctypes.Array) and len(got) == nbins + 1
    np.testing.assert_array_equal(
        np.frombuffer(bytes(got), np.float32).view(np.uint32),
        want.view(np.uint32))
    assert K7._edges(lo, hi, nbins) is got       # made once


class _Entry:
    """A stand-in C entry: records calls and every ``argtypes`` set."""

    def __init__(self, ret=0):
        self.ret, self.calls, self.argtype_sets = ret, [], 0
        self.restype = None
        self._argtypes = None

    @property
    def argtypes(self):
        return self._argtypes

    @argtypes.setter
    def argtypes(self, value):
        self.argtype_sets += 1
        self._argtypes = value

    def __call__(self, *args):
        self.calls.append(args)
        return self.ret


class _Lib:
    """A stand-in kernel library: ``kernel_launch`` returns ``ret``;
    ``dtt_error_string`` names the error."""

    def __init__(self, ret=0):
        self.kernel_launch = _Entry(ret)
        self.dtt_error_string = lambda err: b"an illegal memory access"


@pytest.fixture
def stream(monkeypatch):
    """The raw stream 777 on the current device."""
    monkeypatch.setattr(_build, "_ENTRIES", {})
    monkeypatch.setattr(_build, "_stream", lambda device: (777, False))


def test_launch_binds_each_entry_once(stream):
    lib = _Lib()
    t = torch.zeros(4)
    types = [ctypes.c_void_p, ctypes.c_int, ctypes.c_float]
    for _ in range(3):
        _build.launch(lib, "kernel_launch", types, torch.device("cuda"),
                      t, 5, 0.5)
    fn = lib.kernel_launch
    assert fn.argtype_sets == 1
    assert fn.argtypes == [*types, ctypes.c_void_p]
    assert fn.restype is ctypes.c_int
    assert fn.calls == [(t.data_ptr(), 5, 0.5, 777)] * 3
    # another library's entry of the same name is bound on its own
    other = _Lib()
    _build.launch(other, "kernel_launch", types, torch.device("cuda"), t, 5,
                  0.5)
    assert other.kernel_launch.argtype_sets == 1
    assert fn.argtype_sets == 1


def test_launch_raises_on_a_cuda_error(stream):
    lib = _Lib(ret=700)
    with pytest.raises(RuntimeError, match="kernel_launch: CUDA error 700: "
                       "an illegal memory access"):
        _build.launch(lib, "kernel_launch", [ctypes.c_int],
                      torch.device("cuda"), 1)
    assert lib.kernel_launch.calls == [(1, 777)]


@pytest.mark.parametrize("switch", [False, True])
def test_launch_switches_device_only_when_needed(monkeypatch, switch):
    monkeypatch.setattr(_build, "_ENTRIES", {})
    monkeypatch.setattr(_build, "_stream", lambda device: (9, switch))
    entered = []

    class Device:
        def __init__(self, device):
            self.device = device

        def __enter__(self):
            entered.append(self.device)

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "device", Device)
    lib = _Lib()
    dev = torch.device("cuda", 1)
    _build.launch(lib, "kernel_launch", [ctypes.c_int], dev, 3)
    assert entered == ([dev] if switch else [])
    assert lib.kernel_launch.calls == [(3, 9)]


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so a wrapper takes its
    kernel branch on a machine without a GPU."""

    @property
    def device(self):
        return torch.device("cuda")


@pytest.fixture
def fake_card(monkeypatch, stream):
    """Wrappers' kernel branch on the CPU: inputs report a CUDA device,
    ``torch.empty`` for the card allocates on the CPU, the libraries are
    stand-ins that record their calls."""
    empty = torch.empty
    monkeypatch.setattr(torch, "empty", lambda *a, device=None, **k:
                        empty(*a, **k))
    libs = {}

    def library(name):
        lib = libs.setdefault(name, _Lib())
        lib.piggy_hist_launch = lib.lanes_hist_launch = lib.kernel_launch
        return lib

    monkeypatch.setattr(_build, "library", library)
    return libs


def _cuda(*shape, dtype=torch.float32):
    return torch.zeros(*shape, dtype=dtype).as_subclass(_FakeCuda)


def test_k6_wrapper_hands_the_plan_to_the_kernel(fake_card):
    b, n, nbins = 16, 100, 50
    ins = [_cuda(b, n, n), _cuda(b, n, n), _cuda(b, n), _cuda(b, n),
           _cuda(b, n, n, dtype=torch.int32)]
    before = K6.piggy_histogram.launches
    out = K6.piggy_histogram(*ins, 500.0, nbins)
    assert K6.piggy_histogram.launches == before + 1
    assert out.shape == (b, n, nbins) and out.is_contiguous()
    (args,) = fake_card["piggy_hist"].kernel_launch.calls
    plan = K6._k6_plan(b, n, nbins)
    R, scale = K6._consts(500.0, nbins, torch.float32)
    assert args[:5] == tuple(t.data_ptr() for t in ins)
    assert args[5] == out.data_ptr()
    assert args[6:] == (b, n, nbins, R, scale, plan.warps,
                        plan.rows_per_warp, plan.vec, 777)
    assert len(args) == len(K6.ARGTYPES) + 1


def test_k7_wrapper_edges_and_one_allocation(fake_card):
    b, n, nbins = 16, 6, 20
    s, v = _cuda(b, n * n), _cuda(b, n * n, dtype=torch.bool)
    before = K7.lanes_histogram.launches
    hist, cnt = K7.lanes_histogram(s, v, n, nbins, -500.0, 500.0)
    assert K7.lanes_histogram.launches == before + 1
    assert hist.shape == (b, n, nbins) and cnt.shape == (b, n)
    assert hist.is_contiguous() and cnt.is_contiguous()
    assert hist.untyped_storage().data_ptr() == cnt.untyped_storage().data_ptr()
    assert cnt.data_ptr() == hist.data_ptr() + 4 * b * n * nbins
    (args,) = fake_card["lanes_hist"].kernel_launch.calls
    assert args == (s.data_ptr(), v.data_ptr(), hist.data_ptr(),
                    cnt.data_ptr(), K7._edges(-500.0, 500.0, nbins), b, n,
                    nbins, 777)
