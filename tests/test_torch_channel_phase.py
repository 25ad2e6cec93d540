"""K5 plain version vs the JAX package's channel-phase kernel.

diral_tpu_torch.ops.channel_phase.channel_phase_plain (the canonical walk
the CUDA kernel is held against on the card) against
diral_tpu.ops.pallas_step.channel_phase (the TPU kernel, run in Pallas
interpret mode on the CPU, vmapped over envs), float32, bit for bit:
tables incl. transitive same-slot merges, last_arrival, rewards of designs
2/3/4 and the half-duplex observations.  Scenarios follow
tests/test_pallas_step.py.  Positions have y = 0, as every random reset
gives (XLA contracts ``dx*dx + dy*dy`` into a fused multiply-add, which
the port rounds as two operations)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diral_tpu.ops.pallas_step import channel_phase as jax_channel_phase
from diral_tpu_torch.ops import channel_phase as K5

B = 3


def scenario(n, seed, seq_hi=50, cluster=False):
    rng = np.random.RandomState(seed)
    if cluster:  # everyone within range: long accept chains
        pos_x = np.tile(np.linspace(0.0, 120.0, n), (B, 1))
        age = np.zeros((B, n, n), np.int32)
    else:
        pos_x = rng.randint(0, 800, (B, n)).astype(np.float64)
        pos_x += rng.uniform(0, 1, (B, n)).round(2)
        age = rng.randint(0, 40, (B, n, n)).astype(np.int32)
    return dict(
        pos_x=pos_x.astype(np.float32),
        pos_y=np.zeros((B, n), np.float32),
        table_x=rng.uniform(0, 800, (B, n, n)).astype(np.float32),
        table_y=rng.uniform(0, 2, (B, n, n)).astype(np.float32),
        table_seq=rng.randint(0, seq_hi, (B, n, n)).astype(np.int32),
        table_age=age,
        last_arrival=rng.randint(-1, 10, (B, n, n)).astype(np.int32),
    )


ORDER = ("pos_x", "pos_y", None, "table_x", "table_y", "table_seq",
         "table_age", "last_arrival")


def assert_same(sc, c, design, merge, steps=3, seed=0):
    rng = np.random.RandomState(seed)
    n = sc["pos_x"].shape[1]
    jfn = jax.vmap(lambda px, py, a, tx, ty, ts, ta, la, t: jax_channel_phase(
        px, py, a, tx, ty, ts, ta, la, t, c, 250.0, design, merge),
        in_axes=(0,) * 8 + (None,))
    jstate = [jnp.asarray(sc[k]) if k else None for k in ORDER]
    tstate = [torch.from_numpy(sc[k]) if k else None for k in ORDER]
    for t in range(steps):
        acts = rng.randint(0, c, (B, n)).astype(np.int32)
        jstate[2], tstate[2] = jnp.asarray(acts), torch.from_numpy(acts)
        jout = jfn(*jstate, t)
        tout = K5.channel_phase_plain(*tstate, t, c, 250.0, design, merge)
        names = ("table_x", "table_y", "table_seq", "table_age",
                 "last_arrival", "rewards", "obs")
        for name, jo, to in zip(names, jout, tout):
            msg = f"{name} n={n} c={c} design={design} merge={merge} t={t}"
            if name == "rewards" and design in (3, 4):
                # exp(): XLA's CPU expf and PyTorch's CPU expf differ by one
                # ULP on some inputs (ROADMAP Queue 3): one ULP of exp's
                # output, which lies in [1/e, e]; on the card the kernel
                # and the plain version share CUDA's expf
                np.testing.assert_allclose(
                    to.numpy(), np.asarray(jo), rtol=0,
                    atol=float(np.spacing(np.float32(np.e))), err_msg=msg)
            else:
                np.testing.assert_array_equal(to.numpy(), np.asarray(jo),
                                              err_msg=msg)
        # the wrapper on CPU tensors is the plain version
        wout = K5.channel_phase(*tstate, t, c, 250.0, design, merge)
        for to, wo in zip(tout, wout):
            assert torch.equal(to, wo)
        jstate[3:8] = jout[:5]
        tstate[3:8] = tout[:5]


@pytest.mark.parametrize("n,c,design", [(12, 5, 2), (40, 15, 3),
                                        (33, 20, 4), (24, 8, 2)])
def test_plain_matches_tpu_kernel(n, c, design):
    assert_same(scenario(n, n + design), c, design, merge=True,
                seed=n + c)


def test_merge_off():
    """No piggy merge: tables pass through untouched."""
    assert_same(scenario(24, 3), 8, 2, merge=False, seed=5)


def test_transitive_same_slot_merge():
    """An entry must travel two hops within one slot: everyone within
    range, so accept chains are long; seq numbers up to 5e5, past the
    values where a float32 one-hot gather through bf16 would corrupt
    them (the TPU kernel's trap)."""
    n = 34
    sc = scenario(n, 11, seq_hi=500_000, cluster=True)
    assert_same(sc, 6, 2, merge=True, seed=12)
    # a two-hop chain really happens in this scenario
    tstate = [torch.from_numpy(sc[k]) if k else None for k in ORDER]
    tstate[2] = torch.from_numpy(
        np.random.RandomState(12).randint(0, 6, (B, n)).astype(np.int32))
    out = K5.channel_phase_plain(*tstate, 0, 6, 250.0, 2, True)
    assert not torch.equal(out[2], tstate[5])
