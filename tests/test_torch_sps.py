"""SPS baseline: the port (diral_tpu_torch.agents.sps) against the JAX
package (diral_tpu.agents.sps).  ``toy_rssi`` must agree exactly; the pure
reselection part, given the same RSSI, must produce the shortlist JAX's
``_choose_new_resource`` picks from (its draws come from another
generator, so the picks themselves are compared as sets)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diral_tpu.agents import sps as JS
from diral_tpu.config import toy_4ue_3r
from diral_tpu_torch.agents import sps as TS
from diral_tpu_torch.config import toy_4ue_3r as t_toy_4ue_3r


@pytest.mark.parametrize("n,c", [(4, 3), (30, 10)])
def test_toy_rssi_exact(n, c):
    jcfg = dataclasses.replace(toy_4ue_3r().env, num_users=n, num_channels=c)
    tcfg = dataclasses.replace(t_toy_4ue_3r().env, num_users=n,
                               num_channels=c)
    rng = np.random.RandomState(n)
    B = 3
    # env-like positions: integer starts moved by real-valued speeds, y = 0
    px = rng.randint(0, 400, (B, n)) + rng.uniform(0, 30, (B, n))
    py = np.zeros((B, n))
    last = rng.randint(0, c, (B, n))
    want = jax.vmap(lambda x, y, a: JS.toy_rssi(jcfg, x, y, a))(
        jnp.asarray(px), jnp.asarray(py), jnp.asarray(last))
    got = TS.toy_rssi(tcfg, torch.from_numpy(px), torch.from_numpy(py),
                      torch.from_numpy(last))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_shortlist_matches_jax_choose():
    rng = np.random.RandomState(0)
    for trial in range(12):
        c = int(rng.choice([5, 10, 20]))
        rssi = rng.uniform(-120, -80, size=c)
        prev = int(rng.randint(0, c))
        thr = -110.0
        order, length = TS.resource_shortlist(torch.from_numpy(rssi),
                                              torch.tensor(prev), thr)
        shortlist = set(order[: int(length)].tolist())
        keys = jax.random.split(jax.random.PRNGKey(trial), 64)
        jpicks = set(np.asarray(jax.vmap(
            lambda k: JS._choose_new_resource(k, jnp.asarray(rssi),
                                              jnp.asarray(prev), thr))(keys))
            .tolist())
        assert jpicks == shortlist, (trial, jpicks, shortlist)
        assert prev not in shortlist
        # the pure pick covers the whole shortlist over its draws
        u = torch.linspace(0, 0.999, 50, dtype=torch.float64)
        picks = TS.choose_new_resource(
            torch.from_numpy(rssi).expand(50, c), torch.full((50,), prev),
            thr, u)
        assert set(picks.tolist()) == shortlist


def test_shortlist_relaxes_threshold():
    """Nothing under the threshold: +3 dB steps until C // 5 qualify."""
    rssi = torch.tensor([[-100.0, -99.0, -101.0, -98.0, -97.0,
                          -96.0, -95.0, -94.0, -93.0, -92.0]])
    order, length = TS.resource_shortlist(rssi, torch.tensor([2]), -110.0)
    assert int(length) == 2 and order[0, :2].tolist() == [0, 1]


def test_sps_step_pure_semantics():
    state = TS.SPSState(prev_action=torch.tensor([[0, 1, 2, 0]]),
                        counter=torch.tensor([[3, 0, 0, 1]]))
    rssi = torch.tensor([[[-100.0, -117.0, -117.0]] * 4])
    counter_draw = torch.tensor([[9, 7, 12, 5]])
    keep_u = torch.tensor([[0.5, 0.9, 0.1, 0.9]])   # agent 1 reselects
    pick_u = torch.zeros((1, 4), dtype=torch.float64)
    acts, new = TS.sps_step_pure(state, rssi, -110.0, counter_draw, keep_u,
                                 pick_u)
    assert acts.tolist() == [[0, 2, 2, 0]]
    assert new.counter.tolist() == [[2, 7, 12, 0]]
    assert new.prev_action.tolist() == [[0, 2, 2, 0]]


def test_sps_step_draws_in_range():
    gen = torch.Generator().manual_seed(0)
    st = TS.sps_init(gen, 5, 8, 6)
    assert st.prev_action.shape == (5, 8)
    assert int(st.prev_action.max()) <= 5 and int(st.counter.min()) >= 5
    rssi = torch.full((5, 8, 6), -117.0, dtype=torch.float64)
    for _ in range(30):
        acts, st = TS.sps_step(gen, st, rssi, -110.0)
        assert int(acts.min()) >= 0 and int(acts.max()) < 6
        assert 0 <= int(st.counter.min()) and int(st.counter.max()) <= 16
