"""Published peaks by card name (``torch.cuda.get_device_name``): NVIDIA's
data sheet for the H100 SXM, dense rates without sparsity, at its 700 W
limit.  A card that is not listed has no peaks, and the shares of a peak
or a roofline are not reported for it."""

from __future__ import annotations

import subprocess

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_flops": 989e12,     # tensor cores
        "hbm_bytes": 3.35e12,     # bytes/s
    },
}


def for_card(name: str):
    return PEAKS.get(name)


def power_limit_w(index: int = 0):
    """The card's power limit in W as ``nvidia-smi`` reads it, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30, check=True).stdout.split()
        return float(out[index])
    except (OSError, subprocess.SubprocessError, IndexError, ValueError):
        return None
