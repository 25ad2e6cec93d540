"""Carry DRQN parameters from the JAX package's tree into the port.

The JAX tree is nested dicts of arrays (``jax.tree.map(np.asarray,
params)`` gives numpy leaves): {"lstm": {"w", "b"}, "fc2": {"w", "b"},
"ln2": {"scale", "bias"}, "head": {"w", "b"}, ...}.  The port's
``qnets.DRQN`` uses the same names and the same [in, out] layouts, so the
conversion is a renaming of paths to ``group.leaf`` keys.
"""

from __future__ import annotations

import numpy as np
import torch


def drqn_params_from_numpy(tree: dict) -> dict[str, torch.Tensor]:
    """Nested {group: {leaf: array}} -> state_dict {"group.leaf": tensor}
    (dtype kept, copied)."""
    return {f"{group}.{leaf}": torch.from_numpy(np.array(value, copy=True))
            for group, leaves in tree.items()
            for leaf, value in leaves.items()}
