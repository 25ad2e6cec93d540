"""Tests of the benchmark's harness.  Most run here on the CPU at tiny
sizes; the few that need the card carry the ``card`` marker and decide
inside the test whether one is present:

    python -m pytest benchmark/tests -q            # here
    python -m pytest benchmark/tests -q -m card    # on the card
"""

import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA device; skips where there is none")


def pytest_sessionstart(session):
    # tiny CPU runs: a few threads each, so that parallel workers share
    # the host's cores instead of oversubscribing them
    import torch
    torch.set_num_threads(2)
