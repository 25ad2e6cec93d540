"""K1 and the DRQN Q-net: the port against the JAX package on the CPU.

* K1 plain version (ops/lstm_window.lstm_last_flat_plain, what the CUDA
  kernel is held against on the card) vs the JAX package's Pallas LSTM
  window kernel (pallas_lstm.lstm_last, interpret mode), float32.  Both
  round x, W and h to bfloat16 before each product and sum in float32;
  the order of the sums differs, and XLA's float32 tanh/sigmoid differ
  from PyTorch's in the last bits.  Over one step (T = 1) that leaves h
  within 1e-6.  Over the slice's window (T = 6) a last-bit difference in
  h can flip its bf16 rounding before the next step, which moves the
  later gates by up to |w| * 2^-8 * |h|; the largest gap then depends on
  the seed and reaches the 1e-5 range, so the tolerance there is 1e-4 on
  h (the precision class, as on the card), while the median gap must
  stay below 1e-6.
* lstm_scan, lstm_cell and drqn_apply with lstm_impl="xla" vs the JAX package in
  float64, params carried across by convert.py: 1e-12 (sums in another
  order, and XLA's tanh/sigmoid differ from PyTorch's in the last bits).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diral_tpu.config import toy_4ue_3r
from diral_tpu.models import qnets as jq
from diral_tpu.models.recurrent import lstm_cell as j_lstm_cell
from diral_tpu.models.recurrent import lstm_init as j_lstm_init
from diral_tpu.models.recurrent import lstm_scan as j_lstm_scan
from diral_tpu.ops import pallas_lstm
from diral_tpu_torch.config import toy_4ue_3r as t_toy_4ue_3r
from diral_tpu_torch.convert import drqn_params_from_numpy
from diral_tpu_torch.models import qnets as tq
from diral_tpu_torch.models.recurrent import lstm_cell as t_lstm_cell
from diral_tpu_torch.models.recurrent import lstm_scan as t_lstm_scan
from diral_tpu_torch.ops import lstm_window as K1


def _params(D, H, dtype, seed=0):
    p = j_lstm_init(jax.random.PRNGKey(seed), D, H, dtype)
    # a nonzero bias exercises the bias path of both
    b = np.random.RandomState(seed).normal(0, 0.3, 4 * H).astype(
        np.dtype(dtype))
    return {"w": np.array(p["w"]), "b": b}


@pytest.mark.parametrize("B,T,D,H,tol", [
    # one step: no h feeds back, so only the order of the sums and the
    # last bits of tanh/sigmoid differ
    (64, 1, 23, 128, 1e-6), (37, 1, 100, 256, 1e-6),
    # the slice's window: bf16 flips of h may move later steps
    (64, 6, 23, 128, 1e-4), (37, 6, 100, 256, 1e-4)])
def test_k1_plain_matches_tpu_kernel(B, T, D, H, tol):
    p = _params(D, H, jnp.float32)
    x = np.random.RandomState(1).normal(size=(B, T, D)).astype(np.float32)
    want = np.asarray(pallas_lstm.lstm_last(jnp.asarray(x), jnp.asarray(p["w"]),
                                            jnp.asarray(p["b"])))
    x2 = K1.flatten_window(torch.from_numpy(x))
    np.testing.assert_array_equal(
        x2.numpy(), np.asarray(pallas_lstm.flatten_window(jnp.asarray(x))))
    got = K1.lstm_last_flat_plain(x2, torch.from_numpy(p["w"]),
                                  torch.from_numpy(p["b"]), T)
    assert got.shape == (B, H) and got.dtype == torch.float32
    gap = np.abs(got.numpy() - want)
    assert gap.max() <= tol and np.median(gap) < 1e-6, (gap.max(),
                                                          np.median(gap))
    # the wrappers on CPU tensors are the plain version
    w, b = torch.from_numpy(p["w"]), torch.from_numpy(p["b"])
    assert torch.equal(K1.lstm_last_flat(x2, w, b, T), got)
    assert torch.equal(K1.lstm_last(torch.from_numpy(x), w, b), got)


def test_flat_layout_helpers():
    assert K1.padded_dim(23) == pallas_lstm.padded_dim(23) == 32
    assert K1.padded_dim(100) == 112
    x = torch.randn(5, 6, 23, dtype=torch.float64)
    assert torch.equal(K1.unflatten_window(K1.flatten_window(x), 6, 23), x)
    assert K1.supported(torch.float32, 256) and K1.supported(torch.bfloat16, 128)
    assert not K1.supported(torch.float64, 256)
    assert not K1.supported(torch.float32, 100)


def test_lstm_scan_f64():
    p = _params(23, 64, jnp.float64, seed=3)
    x = np.random.RandomState(4).normal(size=(16, 6, 23))
    (jc, jh), jhs = j_lstm_scan({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x))
    (tc, th), ths = t_lstm_scan({k: torch.from_numpy(v) for k, v in p.items()},
                                torch.from_numpy(x))
    np.testing.assert_allclose(ths.numpy(), np.asarray(jhs), rtol=0, atol=1e-12)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=0, atol=1e-12)
    # one step of the concatenated-input cell from that carry
    jcell = j_lstm_cell({k: jnp.asarray(v) for k, v in p.items()},
                        (jc, jh), jnp.asarray(x[:, 0]))[1]
    tcell = t_lstm_cell({k: torch.from_numpy(v) for k, v in p.items()},
                        (tc, th), torch.from_numpy(x[:, 0]))[1]
    np.testing.assert_allclose(tcell.numpy(), np.asarray(jcell), rtol=0,
                               atol=1e-12)


def _agent_cfgs(layers):
    def make(toy):
        acfg = toy().agent
        return dataclasses.replace(acfg, network=dataclasses.replace(
            acfg.network, layers=layers, lstm_impl="xla"))
    return make(toy_4ue_3r), make(t_toy_4ue_3r)


@pytest.mark.parametrize("layers", [(32, 32), (64, 48, 32)])
@pytest.mark.parametrize("flat", [False, True])
def test_drqn_apply_f64(layers, flat):
    jcfg, tcfg = _agent_cfgs(layers)
    D, A, T = 23, 3, jcfg.step_size
    jparams = jq.drqn_init(jax.random.PRNGKey(5), D, A, jcfg, jnp.float64)
    jparams = jax.tree.map(
        lambda a: a + 0.1 * np.random.RandomState(a.size).normal(size=a.shape),
        jparams)  # layer-norm scale/bias away from their 1/0 init
    net = tq.drqn_init(torch.Generator().manual_seed(0), D, A, tcfg,
                       torch.float64)
    net.load_state_dict(drqn_params_from_numpy(
        jax.tree.map(np.asarray, jparams)))
    x = np.random.RandomState(6).normal(size=(40, T, D))
    if flat:
        xj = pallas_lstm.flatten_window(jnp.asarray(x))
        xt = K1.flatten_window(torch.from_numpy(x))
    else:
        xj, xt = jnp.asarray(x), torch.from_numpy(x)
    want = np.asarray(jq.drqn_apply(jparams, xj, jcfg))
    with torch.no_grad():
        got = net(xt)
    assert got.shape == (40, A)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_lstm_impl_dispatch_on_cpu():
    """auto on a CPU tensor takes lstm_scan; pallas takes the K1 wrapper
    (whose CPU path is the plain version) and refuses float64."""
    p = {k: torch.from_numpy(v) for k, v in _params(23, 128, jnp.float32).items()}
    x = torch.from_numpy(
        np.random.RandomState(7).normal(size=(8, 6, 23)).astype(np.float32))
    scan = t_lstm_scan(p, x)[1][:, -1]
    assert torch.equal(tq._lstm_last(p, x, "auto", 6), scan)
    assert torch.equal(tq._lstm_last(p, x, "xla", 6), scan)
    assert torch.equal(tq._lstm_last(p, x, "pallas", 6),
                       K1.lstm_last(x, p["w"], p["b"]))
    with pytest.raises(ValueError, match="unsupported"):
        tq._lstm_last({k: v.double() for k, v in p.items()}, x.double(),
                      "pallas", 6)


def test_state_dict_names_follow_jax_tree():
    _, tcfg = _agent_cfgs((32, 32))
    net = tq.drqn_init(torch.Generator().manual_seed(0), 23, 3, tcfg)
    assert set(net.state_dict()) == {
        "lstm.w", "lstm.b", "fc2.w", "fc2.b", "ln2.scale", "ln2.bias",
        "head.w", "head.b"}
    assert net.lstm.w.shape == (23 + 32, 4 * 32)  # JAX [in, out] layout
