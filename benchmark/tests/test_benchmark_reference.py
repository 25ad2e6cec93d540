"""The plain float32 reference against the port's CPU path at a tiny
size: every number of the check stays far under its limit; the bf16
control (the program's ``compute_dtype: bfloat16`` path) fails one."""

import pytest

from benchmark.reference import check
from benchmark.tests.helpers import CELLS, SEED, cell, run_tiny


@pytest.mark.parametrize("name", CELLS)
def test_reference_agrees(name):
    result = run_tiny(name, seed=SEED + 1)
    limits = cell(name).limits
    for k, c in result["checks"].items():
        assert c["value"] <= limits[k] / 10, (k, c)
    assert result["correct"]


@pytest.mark.parametrize("name", CELLS)
def test_bf16_control_fails(name):
    result = run_tiny(name, seed=SEED + 2,
                      overrides={"network.compute_dtype": "bfloat16"})
    assert not result["correct"]
    failed = [k for k, c in result["checks"].items()
              if c["value"] > c["limit"]]
    assert failed and set(failed) <= set(check.NUMBERS)
