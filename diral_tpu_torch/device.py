"""Device choice for the port's entry points.

Entry points run on the CUDA device unless the caller asks for the CPU.
Without a CUDA device they raise: nothing quietly falls back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises when CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' "
            "(CLI: --device cpu) to run the plain PyTorch path on the CPU")
    return dev
