"""Per-kernel profile of the training loop (thin shim, the counterpart of
scripts/profile_slot.py).

The implementation lives in diral_tpu_torch/train/profiling.py and is
also ``python -m diral_tpu_torch profile <config>``.

Usage:
    python -m diral_tpu_torch.scripts.profile_slot \\
        [configs/scale_100v_50r.yaml] [--envs 16] [--slots 100] [--top 25]
        [--dtype float32] [--trace-dir DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser(prog="profile_slot")
    ap.add_argument("config", nargs="?", default="configs/scale_100v_50r.yaml")
    ap.add_argument("--envs", type=int, default=16)
    ap.add_argument("--slots", type=int, default=100)
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--trace-dir", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from diral_tpu_torch.train.profiling import profile_training

    out = profile_training(args.config, envs=args.envs, slots=args.slots,
                           top=args.top, dtype=args.dtype,
                           trace_dir=args.trace_dir, device=args.device)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
