"""The LSTM window kernels alone at given event shapes
(scripts/kernel_ceiling.py's counterpart).

Times K1 (fwd), K4 (dual), K2 (triple) and K1 + K3 as one autograd
backward (fwd+bwd) at (rows, T, H, D) shapes: the quantity a train event
is chasing.  The scale row is the 100v/50r event's batch (25,600 rows),
the shape of PERF.md's kernel table, so its times cross-check that
table's.

Timing: the two-length difference of bench_event.py (CUDA events around
R and 2R eager reps, the median of ``--timeit-n``).

Usage:
    python -m diral_tpu_torch.scripts.kernel_ceiling [--shapes toy,scale]
        [--reps 48] [--timeit-n 5]
        [--out FILE] [--device cuda|cpu]
Writes a table to stderr and one JSON line to stdout: {shape: the JAX
script's keys}.  A run on the card also writes it, with the card's
``nvidia-smi`` line under ``card``, to ``--out`` (default
results/torch_kernel_ceilings.json); a CPU run writes a file only to an
``--out`` it is given.
"""

from __future__ import annotations

import argparse
import json
import os

import torch

from diral_tpu_torch.bench import ROOT, card, device_init, log
from diral_tpu_torch.device import resolve_device
from diral_tpu_torch.scripts.bench_event import tflops, timeit_diff

DEFAULT_OUT = os.path.join(ROOT, "results", "torch_kernel_ceilings.json")

SHAPES = {
    # rows = num_users * batch_size of the event's gradient-step batch
    "toy": dict(rows=2048, T=6, H=256, D=23),
    "scale": dict(rows=25600, T=6, H=256, D=100),
}


def bench_shape(name, rows, T, H, D, reps, n, dev) -> dict:
    """Times and achieved TFLOP/s of the four kernel calls at one shape,
    with the JAX script's keys."""
    from diral_tpu_torch.models.recurrent import lstm_init
    from diral_tpu_torch.ops import lstm_window as K

    Dp = K.padded_dim(D)
    gen = torch.Generator(device=dev).manual_seed(0)
    pa = lstm_init(gen, D, H, torch.float32, dev)
    pb = lstm_init(gen, D, H, torch.float32, dev)
    x = torch.randn((rows, T * Dp), generator=gen, device=dev)
    xc = torch.randn((rows, (T + 1) * Dp), generator=gen, device=dev)
    xg = x.clone().requires_grad_()

    @torch.no_grad()
    def fwd():
        K.lstm_last_flat(x, pa["w"], pa["b"], T)

    @torch.no_grad()
    def dual():
        K.lstm_last_flat_dual(x, pa["w"], pa["b"], pb["w"], pb["b"], T)

    @torch.no_grad()
    def triple():
        K.lstm_last_flat_triple(xc, pa["w"], pa["b"], pb["w"], pb["b"], T)

    def fwdbwd():
        torch.autograd.grad(K.lstm_last_flat(xg, pa["w"], pa["b"], T).sum(),
                            xg)

    fwd_flops = rows * T * (2 * Dp * 4 * H + 2 * H * 4 * H)
    t_f = timeit_diff(fwd, reps, n, dev, f"{name} fwd (K1)")
    t_d = timeit_diff(dual, reps, n, dev, f"{name} dual (K4)")
    t_t = timeit_diff(triple, reps, n, dev, f"{name} triple (K2)")
    t_fb = timeit_diff(fwdbwd, max(reps // 2, 8), n, dev,
                       f"{name} fwd+bwd (K1 + K3)")
    return {
        "rows": rows, "T": T, "H": H, "D": D, "Dp": Dp,
        "fwd_ms": round(t_f * 1e3, 3), "fwd_tflops": tflops(fwd_flops, t_f),
        "dual_ms": round(t_d * 1e3, 3),
        "dual_tflops": tflops(2 * fwd_flops, t_d),
        "triple_ms": round(t_t * 1e3, 3),
        "triple_tflops": tflops(
            3 * fwd_flops - rows * T * 2 * Dp * 4 * H, t_t),
        "fwdbwd_ms": round(t_fb * 1e3, 3),
        "fwdbwd_tflops": tflops(4 * fwd_flops, t_fb),
        "fwd_flops_g": round(fwd_flops / 1e9, 2),
    }


def measure(shapes=("toy", "scale"), reps: int = 48, timeit_n: int = 5,
            device=None) -> dict:
    """{shape name: bench_shape's dict} for the named ``SHAPES``."""
    dev = resolve_device(device)
    device_init(dev)
    out = {}
    for name in shapes:
        r = reps if name == "toy" else max(reps // 6, 6)
        out[name] = bench_shape(name, reps=r, n=timeit_n, dev=dev,
                                **SHAPES[name])
        log(f"{name}: {json.dumps(out[name])}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="kernel_ceiling")
    ap.add_argument("--shapes", default="toy,scale")
    ap.add_argument("--reps", type=int, default=48)
    ap.add_argument("--timeit-n", type=int, default=5)
    ap.add_argument("--out", default=None,
                    help="default results/torch_kernel_ceilings.json on the "
                         "card, no file on the CPU")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    out = measure(args.shapes.split(","), args.reps, args.timeit_n,
                  args.device)
    print(json.dumps(out), flush=True)
    dev = resolve_device(args.device)
    path = args.out or (DEFAULT_OUT if dev.type == "cuda" else None)
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(dict(out, card=card(dev)), f, indent=1)
        log(f"written to {path}")
    return out


if __name__ == "__main__":
    main()
