"""Action selection (diral_tpu/agents/policies.py; reference
algorithms/policies.py).  The evaluation slice needs the greedy policy
only; the exploration policies come with the training slice."""

from __future__ import annotations

import torch


def greedy_action(qvalues):
    """First-index argmax, matching np.argmax tie-breaking
    (policies.py:24-31). [..., A] -> [...] int64."""
    return torch.argmax(qvalues, dim=-1)
