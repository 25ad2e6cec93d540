"""A run with the timed path broken underneath comes out not correct, for
each fault a training cell can have: a gradient step that leaves the
weights unchanged, half of the batch left out of the loss's mean, and an
answer (a reward) altered where the env produces it.  The cells run on
one card, so there is no exchange between cards to leave out."""

import pytest

from benchmark.tests.helpers import CELLS, SEED, cell, run_tiny

EXPECT = {"unchanged": "update_gap", "half_batch": "loss_gap",
          "reward": "env_gap"}


@pytest.mark.parametrize("fault", sorted(EXPECT))
def test_fault_is_caught(fault):
    with cell(CELLS[1]).algorithm.planted(fault):
        result = run_tiny(CELLS[1], seed=SEED + 3)
    assert not result["correct"]
    c = result["checks"][EXPECT[fault]]
    assert c["value"] > c["limit"]
