"""K2, K3 and K4 and their autograd Functions: the port against the JAX
package on the CPU (Pallas in interpret mode, as tests/test_pallas_lstm.py
runs it).  Dtypes are explicit: tests/conftest.py turns on x64.

* (a) K3 plain version (ops/lstm_window.lstm_window_bwd_plain, what the
  CUDA kernel is held against on the card) vs pallas_lstm._bwd_impl:
  max |diff| / max |JAX| <= 1e-3 for dx, dw and db.  Both round h_{t-1}
  and dgates to bf16 before the products and sum in float32; the order of
  the sums differs, and a last-bit difference in the recomputed h or in
  dgates can flip a bf16 rounding (measured <= 4.1e-4).  dw and db are
  bit-equal between the two need_dx modes.
* (b) K2 / K4 plain versions vs lstm_last_flat_triple / _dual
  (interpret): <= 1e-4 on h with a median below 1e-6 (the K1 class, see
  tests/test_torch_lstm.py); plain K2 equals plain K1 / K4 on the same
  steps, and plain K4 two plain K1 calls, bit for bit.
* (c) the autograd Functions (K1 with K3 backward; K2 with K3 backward on
  h_s) vs jax.grad through the JAX custom VJPs: <= 1e-3 relative to the
  largest gradient.  h_na and h_nb carry no grad_fn; the window gets no
  gradient through K2.
* (d) qnets.drqn_apply_triple / _dual: float64 on the plain path vs JAX
  <= 1e-12; lstm_impl="pallas" in float32 (plain versions vs interpret)
  <= 1e-4.
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diral_tpu.config import toy_4ue_3r
from diral_tpu.models import qnets as jq
from diral_tpu.models.recurrent import lstm_init as j_lstm_init
from diral_tpu.ops import pallas_lstm
from diral_tpu_torch.config import toy_4ue_3r as t_toy_4ue_3r
from diral_tpu_torch.convert import drqn_params_from_numpy
from diral_tpu_torch.models import qnets as tq
from diral_tpu_torch.ops import lstm_window as K


def _net(D, H, seed):
    p = j_lstm_init(jax.random.PRNGKey(seed), D, H, jnp.float32)
    b = np.random.RandomState(seed).normal(0, 0.3, 4 * H).astype(np.float32)
    return np.array(p["w"]), b


def _window(B, steps, D, seed):
    x = np.random.RandomState(seed).normal(size=(B, steps, D))
    return np.asarray(pallas_lstm.flatten_window(
        jnp.asarray(x.astype(np.float32))))


def _t(a):
    return torch.from_numpy(np.array(a))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("B,T,D,H", [(64, 6, 23, 128), (37, 6, 100, 256),
                                     (97, 6, 100, 512), (2047, 6, 23, 256)])
def test_k3_plain_matches_tpu_backward(B, T, D, H):
    w, b = _net(D, H, 0)
    x2 = _window(B, T, D, 1)
    g = np.random.RandomState(2).normal(size=(B, H)).astype(np.float32)
    Dp = K.padded_dim(D)
    got = {}
    for need_dx in (True, False):
        jdx, jdw, jdb = pallas_lstm._bwd_impl(
            jnp.asarray(x2), jnp.asarray(w), jnp.asarray(b), jnp.asarray(g),
            T, Dp, need_dx=need_dx)
        dx, dw, db = K.lstm_window_bwd_plain(_t(x2), _t(w), _t(b), _t(g), T,
                                             need_dx)
        assert dw.shape == (D + H, 4 * H) and dw.dtype == torch.float32
        assert _rel(dw, jdw) <= 1e-3 and _rel(db, jdb) <= 1e-3
        if need_dx:
            assert dx.shape == (B, T * Dp)
            assert _rel(dx, jdx) <= 1e-3
            # pad lanes meet zero weight rows: their dx is exactly zero
            assert not dx.reshape(B, T, Dp)[..., D:].any()
        else:
            assert dx is None
        got[need_dx] = (dw, db)
        # the wrapper on CPU tensors is the plain version
        wd = K.lstm_window_bwd(_t(x2), _t(w), _t(b), _t(g), T, need_dx)
        assert torch.equal(wd[1], dw) and torch.equal(wd[2], db)
    assert torch.equal(got[True][0], got[False][0])
    assert torch.equal(got[True][1], got[False][1])


@pytest.mark.parametrize("B,T,D,H", [(64, 6, 23, 128), (37, 6, 100, 256)])
def test_k2_k4_plain_match_tpu_kernels(B, T, D, H):
    (w, b), (wt, bt) = _net(D, H, 3), _net(D, H, 4)
    Dp = K.padded_dim(D)
    x2c = _window(B, T + 1, D, 5)
    jw = [jnp.asarray(a) for a in (w, b, wt, bt)]
    want3 = pallas_lstm.lstm_last_flat_triple(jnp.asarray(x2c), *jw, T)
    want2 = pallas_lstm.lstm_last_flat_dual(jnp.asarray(x2c[:, Dp:]), *jw, T)
    tw = [_t(a) for a in (w, b, wt, bt)]
    got3 = K.lstm_last_flat_triple_plain(_t(x2c), *tw, T)
    got2 = K.lstm_last_flat_dual_plain(_t(x2c[:, Dp:]), *tw, T)
    for got, want in zip(got3 + got2, tuple(want3) + tuple(want2)):
        gap = np.abs(got.numpy() - np.asarray(want))
        assert gap.max() <= 1e-4 and np.median(gap) < 1e-6, (
            gap.max(), np.median(gap))
    # the plain versions are K1 on the same steps, bit for bit
    k1 = K.lstm_last_flat_plain
    assert torch.equal(got3[0], k1(_t(x2c[:, :T * Dp]), tw[0], tw[1], T))
    assert torch.equal(got3[1], got2[0]) and torch.equal(got3[2], got2[1])
    assert torch.equal(got2[0], k1(_t(x2c[:, Dp:]), tw[0], tw[1], T))
    assert torch.equal(got2[1], k1(_t(x2c[:, Dp:]), tw[2], tw[3], T))
    # and the wrappers on CPU tensors are the plain versions
    assert all(torch.equal(p, q) for p, q in zip(
        K.lstm_last_flat_triple(_t(x2c), *tw, T), got3))
    assert all(torch.equal(p, q) for p, q in zip(
        K.lstm_last_flat_dual(_t(x2c[:, Dp:]), *tw, T), got2))


def test_k1_function_gradients_match_jax():
    B, T, D, H = 48, 6, 23, 128
    w, b = _net(D, H, 6)
    x2 = _window(B, T, D, 7)
    gw = np.random.RandomState(8).normal(size=(B, H)).astype(np.float32)

    def jloss(x_, w_, b_):
        return jnp.sum(pallas_lstm.lstm_last_flat(x_, w_, b_, T) * gw)

    jg = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(x2), jnp.asarray(w), jnp.asarray(b))
    tx, tw, tb = (_t(a).requires_grad_() for a in (x2, w, b))
    h = K.lstm_last_flat(tx, tw, tb, T)
    assert h.grad_fn is not None
    (h * _t(gw)).sum().backward()
    for got, want in zip((tx.grad, tw.grad, tb.grad), jg):
        assert _rel(got, want) <= 1e-3
    # without grad it stays a plain forward
    with torch.no_grad():
        assert K.lstm_last_flat(tx, tw, tb, T).grad_fn is None


def test_triple_function_gradients_match_jax():
    B, T, D, H = 40, 6, 23, 128
    (w, b), (wt, bt) = _net(D, H, 9), _net(D, H, 10)
    x2c = _window(B, T + 1, D, 11)
    rng = np.random.RandomState(12)
    gw = rng.normal(size=(3, B, H)).astype(np.float32)

    def jloss(w_, b_):
        hs, hna, hnb = pallas_lstm.lstm_last_flat_triple(
            jnp.asarray(x2c), w_, b_, jnp.asarray(wt), jnp.asarray(bt), T)
        # the target-path cotangents are ignored by contract
        return jnp.sum(hs * gw[0]) + jnp.sum(jax.lax.stop_gradient(
            hna * gw[1] + hnb * gw[2]))

    jdw, jdb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(w), jnp.asarray(b))
    tx = _t(x2c).requires_grad_()
    tw, tb = _t(w).requires_grad_(), _t(b).requires_grad_()
    twt, tbt = _t(wt), _t(bt)
    hs, hna, hnb = K.lstm_last_flat_triple(tx, tw, tb, twt, tbt, T)
    assert hna.grad_fn is None and hnb.grad_fn is None
    assert not hna.requires_grad and not hnb.requires_grad
    (hs * _t(gw[0])).sum().backward()
    assert tx.grad is None
    assert _rel(tw.grad, jdw) <= 1e-3 and _rel(tb.grad, jdb) <= 1e-3


def _cfgs(impl, layers):
    def one(c):
        net = dataclasses.replace(c.agent.network, lstm_impl=impl,
                                  layers=layers)
        return dataclasses.replace(c.agent, network=net)
    return one(toy_4ue_3r()), one(t_toy_4ue_3r())


@pytest.mark.parametrize("impl,dtype,layers,tol", [
    ("xla", np.float64, (32, 32), 1e-12),
    ("pallas", np.float32, (128, 32), 1e-4)])
def test_drqn_apply_triple_and_dual(impl, dtype, layers, tol):
    jcfg, tcfg = _cfgs(impl, layers)
    D, A, B, T = 23, 3, 24, jcfg.step_size
    Dp = K.padded_dim(D)
    jd = jnp.float64 if dtype == np.float64 else jnp.float32
    pa = jq.drqn_init(jax.random.PRNGKey(13), D, A, jcfg, jd)
    pb = jq.drqn_init(jax.random.PRNGKey(14), D, A, jcfg, jd)
    na, nb = (tq.DRQN({g: {k: v for k, v in l.items()} for g, l in
                       _tree(p).items()}, tcfg) for p in (pa, pb))
    x = np.random.RandomState(15).normal(size=(B, T + 1, D)).astype(dtype)
    x2c = np.asarray(pallas_lstm.flatten_window(jnp.asarray(x)))
    want = jq.drqn_apply_triple(pa, pb, jnp.asarray(x2c), jcfg)
    got = tq.drqn_apply_triple(na, nb, _t(x2c), tcfg)
    for g, w in zip(got, want):
        assert np.abs(g.detach().numpy() - np.asarray(w)).max() <= tol
    assert got[0].grad_fn is not None
    assert got[1].grad_fn is None and got[2].grad_fn is None
    want = jq.drqn_apply_dual(pa, pb, jnp.asarray(x2c[:, Dp:]), jcfg)
    got = tq.drqn_apply_dual(na, nb, _t(x2c[:, Dp:]), tcfg)
    for g, w in zip(got, want):
        assert np.abs(g.detach().numpy() - np.asarray(w)).max() <= tol
    # the combined window must ride the padded stride
    with pytest.raises(ValueError, match="stride"):
        tq.drqn_apply_triple(na, nb, _t(x2c[:, :-1]), tcfg)


def _tree(p):
    return {g: {k: _t(v) for k, v in leaves.items()}
            for g, leaves in jax.tree.map(np.asarray, p).items()}
