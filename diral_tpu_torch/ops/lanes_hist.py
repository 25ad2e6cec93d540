"""K7: the exact batched count histogram of the type-2 positional
distribution at small N (N*N <= 128), as a hand-written CUDA kernel and
its plain PyTorch version.

Both compute what diral_tpu/ops/pallas_kernels.py::_lanes_hist_kernel
(wrapper ``piggy_histogram_lanes``) computes: for env b and vehicle u, the
count of u's valid neighbour entries in each bin, with ``np.histogram``
membership against the exact ``np.linspace(lo, hi, nbins + 1)`` edges
(right-open bins, the last one right-closed; out-of-range values count
nowhere), and the count of u's valid entries.  The counts are integers
held in float32, so kernel, plain version and the canonical
``masked_count_histogram`` agree bit for bit.  The caller divides by the
count (envs/v2v_env.py).

* ``lanes_histogram_plain`` -- the membership form of ops/histogram.py.
* ``lanes_histogram`` -- the wrapper: CPU tensors run the plain version,
  CUDA tensors launch ``csrc/lanes_hist.cu`` or raise.
  ``lanes_histogram.launches`` counts kernel launches.

The TPU kernel packs 128 // (N*N) envs into the lanes and reduces with a
0/1 selection matmul; those are TPU layout devices, and the CUDA kernel
is a plain exact one-thread-per-count kernel instead.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from diral_tpu_torch.ops import _build
from diral_tpu_torch.ops.histogram import bin_membership

MAX_BINS = 128      # csrc/lanes_hist.cu kMaxBins
MAX_ROW_PAIRS = 128  # N*N <= 128, the TPU kernel's lane budget
ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3


@functools.lru_cache(maxsize=64)
def _edges(lo: float, hi: float, nbins: int):
    """``np.linspace(lo, hi, nbins + 1)`` in float32, the exact edges the
    kernel compares against, as a ready ctypes array (made once per
    (lo, hi, nbins))."""
    e = np.linspace(lo, hi, nbins + 1, dtype=np.float32)
    return (ctypes.c_float * (nbins + 1))(*e.tolist())


def lanes_histogram_plain(signed, valid, n: int, nbins: int, lo: float,
                          hi: float):
    """signed [B, N*N] float, valid [B, N*N] bool (or 0/1) ->
    (hist [B, N, nbins], cnt [B, N]) in signed's dtype."""
    b = signed.shape[0]
    s = signed.reshape(b, n, n)
    v = valid.reshape(b, n, n) != 0
    member = bin_membership(s, lo, hi, nbins) & v[..., None]
    hist = member.to(signed.dtype).sum(dim=-2)
    return hist, v.sum(dim=-1).to(signed.dtype)


def lanes_histogram(signed, valid, n: int, nbins: int, lo: float, hi: float):
    """K7 wrapper; same contract as ``lanes_histogram_plain``.  CUDA inputs
    must be a contiguous float32 ``signed`` and a contiguous bool
    ``valid``, both [B, N*N] with N*N <= 128."""
    if signed.device.type == "cpu":
        return lanes_histogram_plain(signed, valid, n, nbins, lo, hi)
    if signed.device.type != "cuda":
        raise ValueError(
            f"lanes_histogram: unsupported device {signed.device}")
    b = signed.shape[0]
    if n * n > MAX_ROW_PAIRS or not 0 < nbins <= MAX_BINS or b <= 0:
        raise ValueError(f"lanes_histogram: needs N*N <= {MAX_ROW_PAIRS}, "
                         f"0 < nbins <= {MAX_BINS} and B > 0; got N={n}, "
                         f"nbins={nbins}, B={b}")
    dev = signed.device
    _build.check_tensor("signed", signed, torch.float32, (b, n * n), dev)
    _build.check_tensor("valid", valid, torch.bool, (b, n * n), dev)
    lib = _build.library("lanes_hist")
    # hist and cnt: two contiguous views of one allocation
    buf = torch.empty(b * n * (nbins + 1), dtype=torch.float32, device=dev)
    hist = buf.as_strided((b, n, nbins), (n * nbins, nbins, 1))
    cnt = buf.as_strided((b, n), (n, 1), b * n * nbins)
    _build.launch(lib, "lanes_hist_launch", ARGTYPES, dev, signed, valid,
                  hist, cnt, _edges(lo, hi, nbins), b, n, nbins)
    lanes_histogram.launches += 1
    return hist, cnt


lanes_histogram.launches = 0
