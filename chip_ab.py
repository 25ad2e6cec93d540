#!/usr/bin/env python3
"""Times the kernels of several checkouts on the card, one process each,
to compare two commits within one call.

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
the weights (``cudnn_grad``); first of all (before any profiler pass)
K6 (``piggy_histogram``, 16 x 100 x 50) and K7 (``lanes_histogram``, the
PPO shape): CUDA events (median of 25), device time (``K6dev`` /
``K7dev``), the wrapper's host time and each of its host steps
(``host_steps_us``: checks, constants, allocation, library, binding,
stream or device context, argument conversion, the C call; mean us over
1000 calls, median of 5 rounds), the launch floor (``floor``: the empty
``dtt_noop_launch`` through the same path, where the tree has it), and
the PPO rollout slot (ppo_congested x 16 envs under hist_impl="lanes",
K7 once a slot: ``ppo_slot_ms``, host clock per slot, median of 3
episodes after a warm one); K5 (``channel_phase``) at chip_smoke.py's
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

    spec = importlib.util.spec_from_file_location(
        "chip_smoke_here", os.path.join(HERE, "chip_smoke.py"))
    here = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(here)

    out = {"tree": os.path.basename(os.path.normpath(root))}
    # K6, K7 and the launch floor first, before any profiler pass
    out.update(hist_times(torch, np, here, dev, cuda_ms, device_ms))
    out.update(ppo_slot(torch, root, dev))
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


def old_steps(torch, _build, K6, K7, k6, k7):
    """The host steps of one K6 and one K7 call as the wrappers before the
    cached launch path take them (checks, constants or edges,
    allocations, library, ctypes binding, device context, argument
    conversion, the C call), each a function to time alone.  Also the
    cheaper candidates for each: the stream without a device switch, the
    raw stream, pointers as plain ints."""
    import ctypes

    import numpy as np

    f32, i32 = torch.float32, torch.int32
    tx, ty, px, py, age, R, nb = k6
    s, v, n, nbins, lo, hi = k7
    dev = tx.device     # cuda:0, as the wrappers take it from the tensors
    b = px.shape[0]
    b7 = s.shape[0]
    vp, ci, cf = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    out6 = torch.empty((b, px.shape[1], nb), dtype=f32, device=dev)
    hist = torch.empty((b7, n, nbins), dtype=f32, device=dev)
    cnt = torch.empty((b7, n), dtype=f32, device=dev)
    edges = np.linspace(lo, hi, nbins + 1, dtype=np.float32)
    Rf, scale = K6._consts(R, nb, f32)
    n6 = px.shape[1]
    args6 = [tx, ty, px, py, age, out6, b, n6, nb, Rf, scale]
    args7 = [s, v, hist, cnt, vp(edges.ctypes.data), b7, n, nbins]
    lib6, lib7 = _build.library("piggy_hist"), _build.library("lanes_hist")

    def checks6():
        for name, ten, dt, shp in (
                ("table_x", tx, f32, (b, n6, n6)),
                ("table_y", ty, f32, (b, n6, n6)),
                ("pos_x", px, f32, (b, n6)), ("pos_y", py, f32, (b, n6)),
                ("table_age", age, i32, (b, n6, n6))):
            _build.check_tensor(name, ten, dt, shp, dev)

    def checks7():
        if n * n > 128 or not 0 < nbins <= 128 or b7 <= 0:
            raise ValueError
        _build.check_tensor("signed", s, f32, (b7, n * n), dev)
        _build.check_tensor("valid", v, torch.bool, (b7, n * n), dev)

    def bind(lib, symbol, types):
        def go():
            fn = getattr(lib, symbol)
            fn.restype = ctypes.c_int
            fn.argtypes = [*types(), vp]
            return fn
        return go

    types6 = lambda: [vp] * 6 + [ci] * 3 + [cf] * 2
    types7 = lambda: [vp] * 5 + [ci] * 3

    def context():
        with torch.cuda.device(dev):
            return torch.cuda.current_stream(dev).cuda_stream

    def convert(args):
        return lambda: [vp(a.data_ptr()) if isinstance(a, torch.Tensor)
                        else a for a in args]

    def convert_int(args):
        return lambda: [a.data_ptr() if isinstance(a, torch.Tensor) else a
                        for a in args]

    fn6 = bind(lib6, "piggy_hist_launch", types6)()
    fn7 = bind(lib7, "lanes_hist_launch", types7)()
    stream = torch.cuda.current_stream(dev).cuda_stream
    c6, c7 = convert(args6)(), convert(args7)()
    i6, i7 = convert_int(args6)(), convert_int(args7)()
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    raw = getattr(torch._C, "_cuda_getCurrentRawStream", None)
    steps = {
        "K6": {"checks": checks6,
               "consts": lambda: K6._consts(R, nb, f32),
               "alloc": lambda: torch.empty((b, n6, nb), dtype=f32,
                                            device=dev),
               "library": lambda: _build.library("piggy_hist"),
               "bind": bind(lib6, "piggy_hist_launch", types6),
               "device": context, "convert": convert(args6),
               "call": lambda: fn6(*c6, vp(stream)),
               "convert_int": convert_int(args6),
               "call_int": lambda: fn6(*i6, stream)},
        "K7": {"checks": checks7,
               "consts": lambda: vp(np.linspace(lo, hi, nbins + 1,
                                                dtype=np.float32).ctypes.data),
               "alloc": lambda: (torch.empty((b7, n, nbins), dtype=f32,
                                             device=dev),
                                 torch.empty((b7, n), dtype=f32, device=dev)),
               "library": lambda: _build.library("lanes_hist"),
               "bind": bind(lib7, "lanes_hist_launch", types7),
               "device": context, "convert": convert(args7),
               "call": lambda: fn7(*c7, vp(stream)),
               "convert_int": convert_int(args7),
               "call_int": lambda: fn7(*i7, stream)},
        "stream": {"current_stream": lambda: torch.cuda.current_stream(
                       dev).cuda_stream,
                   "current_device": torch.cuda.current_device,
                   "loop": lambda: None}}
    if raw is not None:
        steps["stream"]["raw_stream"] = lambda: raw(idx)
    return steps


def new_steps(torch, _build, K6, K7, k6, k7):
    """The same host steps as ``old_steps`` on the cached launch path:
    checks, the cached plan and constants / edges, one allocation (K7: two
    views of it; also the two-allocation and split alternatives), the
    library, the cached binding (``_build.entry``), the raw stream
    (``_build._stream``), pointers as ints, the C call."""
    tx, ty, px, py, age, R, nb = k6
    s, v, n, nbins, lo, hi = k7
    dev = tx.device
    f32 = torch.float32
    b, n6 = px.shape
    b7 = s.shape[0]
    lib6, lib7 = _build.library("piggy_hist"), _build.library("lanes_hist")
    plan = K6._k6_plan(b, n6, nb)
    Rf, scale = K6._consts(R, nb, f32)
    out6 = torch.empty((b, n6, nb), dtype=f32, device=dev)
    buf = torch.empty(b7 * n * (nbins + 1), dtype=f32, device=dev)
    hist = buf.as_strided((b7, n, nbins), (n * nbins, nbins, 1))
    cnt = buf.as_strided((b7, n), (n, 1), b7 * n * nbins)
    args6 = [tx, ty, px, py, age, out6, b, n6, nb, Rf, scale, plan.warps,
             plan.rows_per_warp, plan.vec]
    args7 = [s, v, hist, cnt, K7._edges(lo, hi, nbins), b7, n, nbins]

    def checks7():
        if n * n > 128 or not 0 < nbins <= 128 or b7 <= 0:
            raise ValueError
        _build.check_tensor("signed", s, f32, (b7, n * n), dev)
        _build.check_tensor("valid", v, torch.bool, (b7, n * n), dev)

    def alloc7():
        out = torch.empty(b7 * n * (nbins + 1), dtype=f32, device=dev)
        return (out.as_strided((b7, n, nbins), (n * nbins, nbins, 1)),
                out.as_strided((b7, n), (n, 1), b7 * n * nbins))

    def alloc7_split():
        h, c = torch.empty(b7 * n * (nbins + 1), dtype=f32, device=dev).split(
            (b7 * n * nbins, b7 * n))
        return h.view(b7, n, nbins), c.view(b7, n)

    def convert(args):
        return lambda: [a.data_ptr() if isinstance(a, torch.Tensor) else a
                        for a in args]

    fn6 = _build.entry(lib6, "piggy_hist_launch", K6.ARGTYPES)
    fn7 = _build.entry(lib7, "lanes_hist_launch", K7.ARGTYPES)
    stream, _ = _build._stream(dev)
    i6, i7 = convert(args6)(), convert(args7)()
    return {
        "K6": {"checks": lambda: K6._check(tx, ty, px, py, age, b, n6, dev),
               "consts": lambda: (K6._k6_plan(b, n6, nb),
                                  K6._consts(R, nb, f32)),
               "alloc": lambda: torch.empty((b, n6, nb), dtype=f32,
                                            device=dev),
               "library": lambda: _build.library("piggy_hist"),
               "bind": lambda: _build.entry(lib6, "piggy_hist_launch",
                                            K6.ARGTYPES),
               "device": lambda: _build._stream(dev),
               "convert": convert(args6),
               "call": lambda: fn6(*i6, stream)},
        "K7": {"checks": checks7,
               "consts": lambda: K7._edges(lo, hi, nbins),
               "alloc": alloc7,
               "alloc_two": lambda: (
                   torch.empty((b7, n, nbins), dtype=f32, device=dev),
                   torch.empty((b7, n), dtype=f32, device=dev)),
               "alloc_split": alloc7_split,
               "library": lambda: _build.library("lanes_hist"),
               "bind": lambda: _build.entry(lib7, "lanes_hist_launch",
                                            K7.ARGTYPES),
               "device": lambda: _build._stream(dev),
               "convert": convert(args7),
               "call": lambda: fn7(*i7, stream)}}


def hist_times(torch, np, here, dev, cuda_ms, device_ms) -> dict:
    """K6 at 16 x 100 x 50 (chip_smoke.py's ``k6_inputs`` seed 5) and K7
    at the PPO shape (16 x 6, 20 bins, ``lanes_inputs`` seed 40): CUDA
    events (median of 25 single calls), torch.profiler device time, the
    wrapper's mean host time and each host step's (``host_steps``); the
    launch floor, ``dtt_noop_launch`` through ``_build.launch`` with K6's
    arguments, where the tree has it (else null)."""
    import ctypes

    from diral_tpu_torch.ops import _build
    from diral_tpu_torch.ops import lanes_hist as K7
    from diral_tpu_torch.ops import piggy_hist as K6

    R, NB = 500.0, 50
    k6 = here.k6_inputs(torch, np, dev, 5)
    s, v = here.lanes_inputs(torch, np, dev, 16, 6, 20, R, 40)
    k6_call = lambda: K6.piggy_histogram(*k6, R, NB)
    k7_call = lambda: K7.lanes_histogram(s, v, 6, 20, -R, R)
    lib = _build.library("piggy_hist")
    if hasattr(K6, "launch_floor"):
        noop = lambda: K6.launch_floor(*k6, R, NB)
    elif hasattr(lib, "dtt_noop_launch"):   # the launch path before entry()
        o = torch.empty((16, 100, NB), device=dev)
        Rf, scale = K6._consts(R, NB, torch.float32)
        types = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                 + [ctypes.c_float] * 2)
        noop = lambda: _build.launch(lib, "dtt_noop_launch", types, dev,
                                     *k6, o, 16, 100, NB, Rf, scale)
    else:
        noop = None
    def host_us(fn):    # mean of 1000 calls, median of 5 rounds
        return here.host_us(torch, fn, warmup=200, rounds=5)

    # host clocks first: before this process runs torch.profiler
    out = {"K6_host_us": host_us(k6_call), "K7_host_us": host_us(k7_call),
           "floor_host_us": noop and host_us(noop)}
    steps = (new_steps if hasattr(_build, "entry") else old_steps)(
        torch, _build, K6, K7, (*k6, R, NB), (s, v, 6, 20, -R, R))
    out["host_steps_us"] = {k: {name: host_us(fn)
                                for name, fn in group.items()}
                            for k, group in steps.items()}
    out.update({"K6": cuda_ms(k6_call, reps=25),
                "K7": cuda_ms(k7_call, reps=25),
                "floor": noop and cuda_ms(noop, reps=25),
                "K6dev": device_ms(k6_call, "piggy_hist"),
                "K7dev": device_ms(k7_call, "lanes_hist")})
    out["floor_host_us_after_profile"] = noop and host_us(noop)
    return out


def ppo_slot(torch, root, dev, slots_runs=3) -> dict:
    """The PPO rollout slot (ppo_congested, 16 envs, hist_impl="lanes":
    K7 once a slot): host clock per slot of ``rollout`` (median of
    ``slots_runs`` episodes after a warm one) and K7 launches per slot."""
    from diral_tpu_torch.config import load_config
    from diral_tpu_torch.ops import lanes_hist as K7
    from diral_tpu_torch.train import ppo_loop

    cfg = load_config(os.path.join(root, "configs", "ppo_congested.yaml"))
    cfg = dataclasses.replace(cfg, env=dataclasses.replace(
        cfg.env, state=dataclasses.replace(cfg.env.state, hist_impl="lanes")))
    fns = ppo_loop.make_ppo_functions(cfg, device=dev)
    draws = ppo_loop.PPODraws(torch.Generator(device=dev).manual_seed(3))
    env_state, history = fns.init_state(draws)
    lrn = fns.init_learner(draws)
    fns.rollout(env_state, history, lrn, 0, draws)
    L = cfg.episode_interval
    times, before = [], K7.lanes_histogram.launches
    for ep in range(1, slots_runs + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fns.rollout(env_state, history, lrn, ep, draws)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3 / L)
    return {"ppo_slot_ms": statistics.median(times),
            "ppo_slot_K7": (K7.lanes_histogram.launches - before)
            / (slots_runs * L)}


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
