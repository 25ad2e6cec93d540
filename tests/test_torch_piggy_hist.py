"""K6 plain version vs the JAX package's piggy-histogram kernel.

diral_tpu_torch.ops.piggy_hist.piggy_histogram_plain (what the CUDA
kernel is held against on the card) against
diral_tpu.ops.pallas_kernels.piggy_histogram (the TPU kernel in Pallas
interpret mode, vmapped over envs), float32, bit for bit.  Stored and
live y positions are 0, as every random reset gives them (XLA contracts
``dx*dx + dy*dy`` into a fused multiply-add; the port rounds two ops)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diral_tpu.ops.pallas_kernels import piggy_histogram as jax_piggy
from diral_tpu_torch.ops import piggy_hist as K6

B = 3
RANGE = 500.0


def inputs(n, nbins, seed):
    rng = np.random.RandomState(seed)
    pos_x = rng.randint(0, 2000, (B, n)).astype(np.float32)
    offs = rng.uniform(-700, 700, (B, n, n)).astype(np.float32)
    # a quarter of the entries land exactly on a floor-rule bin edge
    width = 2 * RANGE / nbins
    edge = (rng.randint(0, nbins + 1, (B, n, n)) * width - RANGE)
    offs = np.where(rng.rand(B, n, n) < 0.25, edge, offs).astype(np.float32)
    return dict(table_x=pos_x[:, :, None] + offs,
                table_y=np.zeros((B, n, n), np.float32),
                pos_x=pos_x, pos_y=np.zeros((B, n), np.float32),
                table_age=rng.randint(0, 30, (B, n, n)).astype(np.int32))


@pytest.mark.parametrize("n,nbins", [(8, 20), (40, 50)])
def test_plain_matches_tpu_kernel(n, nbins):
    a = inputs(n, nbins, seed=n)
    jout = jax.vmap(lambda tx, ty, px, py, age: jax_piggy(
        tx, ty, px, py, age, RANGE, nbins))(
            *(jnp.asarray(a[k]) for k in ("table_x", "table_y", "pos_x",
                                          "pos_y", "table_age")))
    args = [torch.from_numpy(a[k]) for k in ("table_x", "table_y", "pos_x",
                                             "pos_y", "table_age")]
    tout = K6.piggy_histogram_plain(*args, RANGE, nbins)
    assert tout.shape == (B, n, nbins) and tout.dtype == torch.float32
    np.testing.assert_array_equal(tout.numpy(), np.asarray(jout))
    # the wrapper on CPU tensors is the plain version
    assert torch.equal(K6.piggy_histogram(*args, RANGE, nbins), tout)
    # rows with visible neighbours are distributions
    sums = tout.sum(-1)
    assert torch.all((sums == 0) | ((sums - 1).abs() < 1e-5))
