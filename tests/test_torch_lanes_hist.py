"""K7, the envs-in-lanes count histogram, and the env's ``hist_impl``
gate that reaches it.

* diral_tpu_torch.ops.lanes_hist.lanes_histogram_plain (what the CUDA
  kernel is held against on the card) equals the JAX package's
  ``piggy_histogram_lanes`` (the TPU kernel in Pallas interpret mode,
  float32) bit for bit, for batches that are and are not multiples of the
  TPU pack width 128 // (N*N), with values on the exact edges, at +-R,
  out of range, and invalid entries; and it equals the canonical
  ``masked_count_histogram``.
* The gate: ``hist_impl="lanes"`` sends N*N <= 128 float32 envs to
  ``lanes_histogram`` and every other case (N*N > 128, float64) to the
  canonical op, never to K6; in every case the positional distribution
  is bit-equal to ``hist_impl="xla"``'s.
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from diral_tpu.ops.pallas_kernels import piggy_histogram_lanes as jax_lanes
from diral_tpu_torch.config import toy_4ue_3r as t_toy_4ue_3r
from diral_tpu_torch.envs import v2v_env as tenv
from diral_tpu_torch.ops import lanes_hist as K7
from diral_tpu_torch.ops.histogram import masked_count_histogram

RANGE, NBINS = 500.0, 20


def inputs(b, n, seed, dtype=np.float32):
    """signed [B, N*N] with a quarter of the values on the exact
    np.linspace edges, some at +-R and out of range; valid [B, N*N]."""
    rng = np.random.RandomState(seed)
    v = rng.uniform(-650, 650, (b, n * n))
    edges = np.linspace(-RANGE, RANGE, NBINS + 1, dtype=dtype)
    on_edge = edges[rng.randint(0, NBINS + 1, (b, n * n))]
    pick = rng.rand(b, n * n)
    v = np.where(pick < 0.25, on_edge, v)
    v = np.where((pick >= 0.25) & (pick < 0.3),
                 np.where(rng.rand(b, n * n) < 0.5, -RANGE, RANGE), v)
    return v.astype(dtype), rng.rand(b, n * n) < 0.7


@pytest.mark.parametrize("b,n", [(16, 6), (5, 6), (1, 4), (3, 11)])
def test_plain_matches_tpu_kernel(b, n):
    signed, valid = inputs(b, n, seed=10 * b + n)
    jh, jc = jax_lanes(jnp.asarray(signed), jnp.asarray(valid), n, NBINS,
                       -RANGE, RANGE)
    ts, tv = torch.from_numpy(signed), torch.from_numpy(valid)
    th, tc = K7.lanes_histogram_plain(ts, tv, n, NBINS, -RANGE, RANGE)
    assert th.shape == (b, n, NBINS) and tc.shape == (b, n)
    assert th.dtype == tc.dtype == torch.float32
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    # edge values really were binned: the in-range valid ones all count
    inside = valid & (np.abs(signed) <= RANGE)
    assert th.sum().item() == inside.sum()
    # the wrapper on CPU tensors is the plain version
    wh, wc = K7.lanes_histogram(ts, tv, n, NBINS, -RANGE, RANGE)
    assert torch.equal(wh, th) and torch.equal(wc, tc)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plain_equals_canonical_histogram(dtype):
    b, n = 7, 6
    signed, valid = inputs(b, n, seed=3, dtype=dtype)
    ts, tv = torch.from_numpy(signed), torch.from_numpy(valid)
    th, tc = K7.lanes_histogram_plain(ts, tv, n, NBINS, -RANGE, RANGE)
    want = masked_count_histogram(ts.reshape(b, n, n), tv.reshape(b, n, n),
                                  -RANGE, RANGE, NBINS)
    assert torch.equal(th, want)
    assert torch.equal(tc, tv.reshape(b, n, n).sum(-1).to(th.dtype))


def _env(n, hist_impl):
    cfg = t_toy_4ue_3r().env
    cfg = dataclasses.replace(cfg, num_users=n, num_channels=3)
    return dataclasses.replace(cfg, state=dataclasses.replace(
        cfg.state, hist_impl=hist_impl))


@pytest.mark.parametrize("n,dtype,routed", [
    (4, torch.float32, True), (6, torch.float32, True),
    (11, torch.float32, True), (12, torch.float32, False),
    (6, torch.float64, False)])
def test_lanes_gate(monkeypatch, n, dtype, routed):
    calls = []

    def spy(*a, **k):
        calls.append(a[2])
        return K7.lanes_histogram(*a, **k)

    def no_k6(*_a, **_k):
        raise AssertionError("hist_impl='lanes' reached K6")

    monkeypatch.setattr(tenv, "lanes_histogram", spy)
    monkeypatch.setattr(tenv, "piggy_histogram", no_k6)
    lanes, xla = _env(n, "lanes"), _env(n, "xla")
    s = tenv.reset(lanes, 5, torch.Generator().manual_seed(n), dtype, "cpu")
    rng = np.random.RandomState(n)
    for t in range(12):
        acts = torch.from_numpy(rng.randint(0, 3, (5, n)))
        s, _, _ = tenv.step_collision(lanes, s, acts, t)
        got = tenv.positional_dist_piggy_type2(lanes, s)
        want = tenv.positional_dist_piggy_type2(xla, s)
        assert torch.equal(got, want)
    assert calls == ([n] * 12 if routed else [])
    assert got.abs().sum() > 0   # the tables filled: real histograms
