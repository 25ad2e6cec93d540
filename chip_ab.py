#!/usr/bin/env python3
"""Times the LSTM window kernels of several checkouts on the card, one
process each, to compare two commits within one call.

    python3 chip_ab.py TREE [TREE ...]

Each TREE is a checkout of this repository, for instance the parent
commit unpacked with ``git archive`` into a directory that .gitignore
lists; give parent, change, change, parent to see the spread between
runs of one tree.  Each tree builds its own kernels and prints one line
``AB {json}`` (times in ms, NVIDIA name and power limit on the first
line): CUDA-event times (median of 9 after 3 warm-up calls) and
torch.profiler device times of K1 at the serving shape (1600 rows, D =
100), the PPO update shape (2400 rows, D = 25, H = 128) and the toy and
100v/50r train-event shapes (2048 rows, D = 23; 25,600 rows, D = 100),
of K2 and K4 at the last two, cuDNN's LSTM forwards beside each
(``cudnn1`` / ``cudnn2`` / ``cudnn3``: one, two or three forwards); K3
(``lstm_window_bwd``) at the last three without and with dx (``K3`` /
``K3dx``), its row pass's and its reduction's (partial + combine) device
times without dx (``K3rows`` / ``K3red``) and cuDNN's forward + grad of
the weights (``cudnn_grad``); K5 (``channel_phase``) at chip_smoke.py's
timing input (16 envs x 100 users x 50 channels, ``k5_inputs`` seed 99,
taken from the chip_smoke.py beside this file so that every tree gets the
same input): CUDA events (``K5``), device time of all its launches
(``K5dev``) and of the two passes where the tree has them
(``K5accept`` / ``K5merge``); the 100v/50r greedy serving slot, 30
``evaluate_drqn`` slots (``serve_slot_ms``: host clock per slot, median
of 3 runs after a warm one; ``serve_busy_ms`` / ``serve_K5_ms``: device
busy time and K5's device time per slot under torch.profiler); and the
100v/50r train event after 400 slots of training (host clock, median
of 5 after a warm one) with its device busy time.  Needs one CUDA device
and nvcc; imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
T = 6
SHAPES = (("1600", 1600, 100, 256), ("2400h128", 2400, 25, 128),
          ("2048", 2048, 23, 256), ("25600", 25600, 100, 256))


def time_tree(root: str) -> dict:
    """The forwards, cuDNN and the 100v/50r train event of one checkout."""
    os.chdir(root)
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from diral_tpu_torch.config import load_config
    from diral_tpu_torch.models import qnets
    from diral_tpu_torch.ops import channel_phase as K5
    from diral_tpu_torch.ops import lstm_window as K1
    from diral_tpu_torch.train import evaluate, loop, runner

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    def cuda_ms(fn, reps=9, warmup=3):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    def device_ms(fn, kernels, reps=5):
        """Device ms per call of the kernels whose names hold one of
        ``kernels`` (a name or a tuple of names)."""
        kernels = (kernels,) if isinstance(kernels, str) else kernels
        fn()
        torch.cuda.synchronize()
        _, rows, _ = cs.device_profile(
            torch, lambda: [fn() for _ in range(reps)], reps)
        return sum(ms for key, ms, _ in rows
                   if any(k in key for k in kernels))

    out = {"tree": os.path.basename(os.path.normpath(root))}
    for tag, B, D, H in SHAPES:
        Dp = K1.padded_dim(D)
        x2c, w, b, wt, bt, g = cs.lstm_train_inputs(
            torch, np, K1, dev, B, D, H, T + 1, 7, torch.float32)
        x2, xn = x2c[:, :T * Dp].contiguous(), x2c[:, Dp:]
        calls = {"K1": (lambda: K1.lstm_last_flat(x2, w, b, T),
                        "lstm_window")}
        if B >= 2048:
            calls["K2"] = (lambda: K1.lstm_last_flat_triple(x2c, w, b, wt,
                                                            bt, T),
                           "lstm_triple")
            calls["K4"] = (lambda: K1.lstm_last_flat_dual(xn, w, b, wt, bt,
                                                          T), "lstm_dual")
        for k, (fn, kernel) in calls.items():
            out[f"{k}_{tag}"] = cuda_ms(fn)
            out[f"{k}dev_{tag}"] = device_ms(fn, kernel)
        x3 = K1.unflatten_window(x2, T, D).contiguous()
        xn3 = K1.unflatten_window(xn, T, D).contiguous()
        lstm = cs.cudnn_lstm(torch, w, b, D, H, dev)
        lstm_t = cs.cudnn_lstm(torch, wt, bt, D, H, dev)
        with torch.no_grad():
            out[f"cudnn1_{tag}"] = cuda_ms(lambda: lstm(x3))
            if B >= 2048:
                out[f"cudnn2_{tag}"] = cuda_ms(lambda: (lstm(xn3),
                                                        lstm_t(xn3)))
                out[f"cudnn3_{tag}"] = cuda_ms(lambda: (
                    lstm(x3), lstm(xn3), lstm_t(xn3)))
        if B >= 2048 or H == 128:   # K3's shapes
            def k3(need_dx):
                return lambda: K1.lstm_window_bwd(x2, w, b, g, T, need_dx)

            out[f"K3_{tag}"] = cuda_ms(k3(False))
            out[f"K3dx_{tag}"] = cuda_ms(k3(True))
            out[f"K3rows_{tag}"] = device_ms(k3(False), "lstm_bwd_rows")
            out[f"K3red_{tag}"] = device_ms(
                k3(False), ("lstm_bwd_partial", "lstm_bwd_combine"))
            params = [p.requires_grad_() for p in lstm.parameters()]
            out[f"cudnn_grad_{tag}"] = cuda_ms(lambda: torch.autograd.grad(
                lstm(x3)[0][:, -1], params, grad_outputs=g))

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)
    k5_args = here.k5_inputs(torch, np, dev, 99)

    def k5():
        return K5.channel_phase(*k5_args, 7, 50, 250.0, 2, True)

    out["K5"] = cuda_ms(k5)
    k5()
    torch.cuda.synchronize()
    _, rows, _ = cs.device_profile(torch, lambda: [k5() for _ in range(20)],
                                   20)
    for key, kernel in (("K5dev", "channel_phase"),
                        ("K5accept", "channel_phase_accept"),
                        ("K5merge", "channel_phase_merge")):
        out[key] = sum(ms for k, ms, _ in rows if kernel in k)

    scale = load_config(os.path.join(root, "configs", "scale_100v_50r.yaml"))
    params = qnets.drqn_init(torch.Generator(device=dev).manual_seed(0),
                             scale.env.state_space, scale.env.num_channels,
                             scale.agent, torch.float32, dev)
    slots = 30

    def serve():
        evaluate.evaluate_drqn(scale, params, 5, steps=slots, device=dev)

    times = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        serve()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / slots)
    out["serve_slot_ms"] = statistics.median(times[1:])
    _, rows, busy = cs.device_profile(torch, serve, slots)
    out["serve_busy_ms"] = busy
    out["serve_K5_ms"] = sum(ms for key, ms, _ in rows
                             if "channel_phase" in key)

    run = dataclasses.replace(scale, time_slots=400)
    with tempfile.TemporaryDirectory() as wd:
        carry, _ = runner.train_experiment(run, wd, device=dev, verbose=False)
    fns = loop.make_train_functions(run, device=dev)
    draws = loop.Draws(torch.Generator(device=dev).manual_seed(5))

    def event():
        fns.train_call(carry.learner, carry.replay, run.time_slots - 1, draws)

    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        event()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["event_100v50r_ms"] = statistics.median(times[1:])
    _, rows, busy = cs.device_profile(torch, lambda: [event(), event()], 2)
    out["event_100v50r_busy_ms"] = busy
    out["event_100v50r_top"] = [
        (key[:60], ms) for key, ms, _ in sorted(rows, key=lambda r: -r[1])[:4]]
    return out


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device available", file=sys.stderr)
        return 2
    if argv[:1] == ["--one"]:
        print("AB " + json.dumps(time_tree(os.path.abspath(argv[1]))),
              flush=True)
        return 0
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    rc = 0
    for tree in argv:
        res = subprocess.run([sys.executable, os.path.abspath(__file__),
                              "--one", tree], capture_output=True, text=True)
        lines = [ln for ln in res.stdout.splitlines() if ln.startswith("AB ")]
        if res.returncode or not lines:
            print(f"chip_ab: {tree} failed (exit {res.returncode}):\n"
                  f"{res.stderr[-3000:]}", file=sys.stderr)
            rc = 1
        for ln in lines:
            print(ln, flush=True)
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
