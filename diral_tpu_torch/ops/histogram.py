"""Fixed-range histograms that reproduce ``np.histogram``'s uniform-bin
path bit for bit (diral_tpu/ops/histogram.py; reference
envs/network.py:460,500).

``np.histogram`` fixes its float-derived bin index up against the EXACT
``np.linspace`` edges, so the final index is interval membership
(right-open bins, the last one right-closed).  Membership is tested here
directly against those edges, embedded as constants: ``torch.linspace``
computes interior points with other float arithmetic and would move
values that land exactly on an edge.
"""

from __future__ import annotations

import numpy as np
import torch

_NP_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def uniform_edges(lo, hi, nbins: int, dtype, device=None):
    """``np.linspace(lo, hi, nbins + 1)`` bit for bit, as a tensor."""
    edges = np.linspace(lo, hi, nbins + 1, dtype=_NP_DTYPES[dtype])
    return torch.as_tensor(edges, device=device)


def bin_membership(values, lo, hi, nbins: int):
    """[..., M, nbins] bool: value lies in bin k (np.histogram semantics);
    all False for out-of-range values."""
    edges = uniform_edges(lo, hi, nbins, values.dtype, values.device)
    v = values[..., None]
    last = torch.arange(nbins, device=values.device) == nbins - 1
    below_hi = torch.where(last, v <= edges[1:], v < edges[1:])
    return (v >= edges[:-1]) & below_hi


def masked_count_histogram(values, valid, lo, hi, nbins: int):
    """Count histogram of ``values[valid]`` over [lo, hi].
    values, valid: [..., M] -> [..., nbins] in the values' dtype."""
    member = bin_membership(values, lo, hi, nbins) & valid[..., None]
    return member.to(values.dtype).sum(dim=-2)


def masked_weighted_histogram(values, weights, valid, lo, hi, nbins: int):
    """Weighted histogram (np.histogram with ``weights=``) of valid entries."""
    member = bin_membership(values, lo, hi, nbins) & valid[..., None]
    return (member.to(values.dtype) * weights[..., None]).sum(dim=-2)
