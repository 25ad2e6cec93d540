#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (diral_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (nvcc).  Phases, in order; any
failure exits non-zero:

1. the card's name and power limit (nvidia-smi);
2. build every kernel of diral_tpu_torch/csrc from the checkout, in
   parallel, and print the build time;
3. kernel phases: each kernel against its plain PyTorch version on the
   card, at the shapes of the 100v/50r serving path, inputs from a numpy
   seed -- K1 LSTM window (max |dh| <= 1e-4), K5 channel walk (bit-exact),
   K6 piggy histogram (bit-exact); kernel / plain / library times (CUDA
   events, median of 7 after warm-up);
4. reference phase: a small env (N = 40) stepped through the kernels on the
   card and through the plain versions on the CPU, same actions: tables,
   observations, rewards and state vectors bit-equal, Q-values within
   1e-3;
5. slice phase: ``compare_drqn_vs_sps`` on configs/scale_100v_50r.yaml
   (16 envs, float32) with every launch counter set to 0 just before and
   read just after (each kernel must have launched at least once per
   step), then ``evaluate_drqn`` on the toy config at 256 envs (K1 only);
6. a ``kernels`` JSON line and, last, the ``ok`` JSON line.

It imports nothing of JAX nor of the JAX package.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time

STEPS = 300
BF16_PEAK = 989e12      # H100 SXM dense bf16 tensor-core FLOP/s
F32_PEAK = 67e12        # H100 SXM float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12


def log(msg):
    print(msg, flush=True)


def bound(flops, nbytes, peak):
    """The least time the card could take: the larger of the operations
    over ``peak`` and the bytes (each input read once, each output
    written once) over the memory rate."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return dict(bound_ms=max(t_ops, t_bytes) * 1e3,
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                flops=flops, bytes=nbytes)


def profile_slots(torch, evaluate, cfg, params, dev, steps=30):
    """Where a greedy slot's time goes: torch.profiler over ``steps`` slots
    of evaluate_drqn; device time by kernel, and the device's busy share
    of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    evaluate.evaluate_drqn(cfg, params, 5, steps=3, device=dev)  # warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        evaluate.evaluate_drqn(cfg, params, 5, steps=steps, device=dev)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, getattr(e, "self_device_time_total", 0.0) / 1e3, e.count)
            for e in prof.key_averages() if e.device_type == cuda]
    busy = sum(ms for _, ms, _ in rows)
    log(f"profile greedy DRQN 100v/50r, {steps} slots: wall "
        f"{wall_ms / steps:.3f} ms/slot, device busy {busy / steps:.3f} "
        f"ms/slot ({100 * busy / wall_ms:.1f}% of wall), "
        f"{sum(c for *_, c in rows) / steps:.0f} kernels/slot")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:8]:
        log(f"  {100 * ms / max(busy, 1e-9):5.1f}%  {ms / steps:8.4f} ms/slot"
            f"  x{count / steps:.0f}  {key[:90]}")
    ours = {k: sum(ms for key, ms, _ in rows if k in key)
            for k in ("lstm_window", "channel_phase", "piggy_hist")}
    log("  kernels of the port: " + ", ".join(
        f"{k} {100 * v / max(busy, 1e-9):.1f}%" for k, v in ours.items()))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    import numpy as np

    from diral_tpu_torch.config import load_config
    from diral_tpu_torch.envs import v2v_env as E
    from diral_tpu_torch.models import qnets
    from diral_tpu_torch.models.recurrent import lstm_scan
    from diral_tpu_torch.ops import _build
    from diral_tpu_torch.ops import channel_phase as K5
    from diral_tpu_torch.ops import lstm_window as K1
    from diral_tpu_torch.ops import piggy_hist as K6
    from diral_tpu_torch.ops.distance import pairwise_distances
    from diral_tpu_torch.train import evaluate

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # 1. card identity
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")

    # 2. build
    t0 = time.perf_counter()
    reports = _build.build_all()
    log(f"build: {len(reports)} kernels in {time.perf_counter() - t0:.2f} s")
    for name, rep in sorted(reports.items()):
        for line in rep.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    def cuda_ms(fn, reps=7, warmup=2):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times)

    rows = {}
    failures = []

    # 3a. K1: LSTM window forward at the slice's shapes (B = 16 envs x 100
    # vehicles, T = 6, D = 100, H = 256), float32 and bfloat16 windows,
    # plus the toy shape (D = 23, B = 1024 = 256 envs x 4 vehicles)
    def k1_inputs(B, D, H, T=6, seed=0, dtype=torch.float32):
        rng = np.random.RandomState(seed)
        lim = math.sqrt(6.0 / (D + H + 4 * H))
        w = rng.uniform(-lim, lim, (D + H, 4 * H)).astype(np.float32)
        b = rng.normal(0, 0.1, 4 * H).astype(np.float32)
        x = rng.normal(size=(B, T, D)).astype(np.float32)
        x2 = K1.flatten_window(torch.from_numpy(x)).to(dev, dtype).contiguous()
        return x2, torch.from_numpy(w).to(dev), torch.from_numpy(b).to(dev), T

    def bf16_ulp(v):
        return torch.ldexp(torch.ones_like(v),
                           torch.floor(torch.log2(v.abs().clamp(min=1e-30)))
                           .int() - 7)

    errs = {}
    for label, B, D, H, dtype in (("scale f32", 1600, 100, 256, torch.float32),
                                  ("scale bf16", 1600, 100, 256, torch.bfloat16),
                                  ("toy f32", 1024, 23, 256, torch.float32)):
        x2, w, b, T = k1_inputs(B, D, H, dtype=dtype)
        got = K1.lstm_last_flat(x2, w, b, T).float()
        want = K1.lstm_last_flat_plain(x2, w, b, T).float()
        torch.cuda.synchronize()
        errs[label] = err = float((got - want).abs().max())
        if dtype == torch.bfloat16:
            # both round h to bf16 at the end: two float32 values 1e-4 apart
            # may land one bf16 step apart
            ok = bool(((got - want).abs() <= 1e-4 + bf16_ulp(want)).all())
        else:
            ok = err <= 1e-4
        log(f"K1 {label}: B={B} T={T} D={D} H={H} max|dh|={err:.3e} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"K1 {label}")
    k1_err = errs["scale f32"]   # the main path's shape and type

    x2, w, b, T = k1_inputs(1600, 100, 256)
    B, H, D = 1600, 256, 100
    Dp = K1.padded_dim(D)
    k1_ms = cuda_ms(lambda: K1.lstm_last_flat(x2, w, b, T))
    k1_plain_ms = cuda_ms(lambda: K1.lstm_last_flat_plain(x2, w, b, T))
    x3 = K1.unflatten_window(x2, T, D).contiguous()
    f32_loop_ms = cuda_ms(lambda: lstm_scan({"w": w, "b": b}, x3))
    # library yardstick: cuDNN's LSTM (float32, TF32 off) with the cell's
    # gate order (i, g, f, o -> i, f, g, o) and +1 forget bias folded in
    lstm = torch.nn.LSTM(D, H, batch_first=True).to(dev)
    perm = torch.cat([torch.arange(0, H), torch.arange(2 * H, 3 * H),
                      torch.arange(H, 2 * H), torch.arange(3 * H, 4 * H)]).to(dev)
    with torch.no_grad():
        lstm.weight_ih_l0.copy_(w[:D].t()[perm])
        lstm.weight_hh_l0.copy_(w[D:].t()[perm])
        lstm.bias_ih_l0.copy_(b[perm] + torch.cat(
            [torch.zeros(H, device=dev), torch.ones(H, device=dev),
             torch.zeros(2 * H, device=dev)]))
        lstm.bias_hh_l0.zero_()
        cudnn_gap = float((lstm(x3)[0][:, -1]
                           - lstm_scan({"w": w, "b": b}, x3)[1][:, -1])
                          .abs().max())
        lib_ms = cuda_ms(lambda: lstm(x3))
    log(f"K1 scale f32: kernel {k1_ms:.4f} ms  plain {k1_plain_ms:.4f} ms  "
        f"f32 matmul loop {f32_loop_ms:.4f} ms  cuDNN LSTM {lib_ms:.4f} ms "
        f"(cuDNN vs f32 loop max|dh| {cudnn_gap:.2e})")
    rows["K1"] = dict(name="K1 lstm_window (LSTM window forward)",
                      route="cuda", source="diral_tpu_torch/csrc/lstm_window.cu",
                      replaces="diral_tpu/ops/pallas_lstm.py:91",
                      max_abs_err=k1_err, ms=k1_ms, plain_ms=k1_plain_ms,
                      library_ms=lib_ms, f32_loop_ms=f32_loop_ms,
                      **bound(2.0 * B * T * (D + H) * 4 * H,
                              4 * (x2.numel() + w.numel() + b.numel() + B * H),
                              BF16_PEAK))

    # 3b. K5: channel walk, 16 envs, N = 100, C = 50
    NE, N, C, R = 16, 100, 50, 250.0

    def k5_inputs(seed, cluster=False, seq_hi=500_000):
        rng = np.random.RandomState(seed)
        if cluster:   # everyone within range: long merge chains
            px = np.tile(np.linspace(0.0, 200.0, N), (NE, 1))
        else:
            px = rng.randint(0, 2000, (NE, N)) + rng.uniform(0, 30, (NE, N))
        f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
        i = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
        return [f(px), f(rng.randint(0, 2, (NE, N))),
                i(rng.randint(0, C, (NE, N))),
                f(rng.uniform(0, 2000, (NE, N, N))),
                f(rng.uniform(0, 2, (NE, N, N))),
                i(rng.randint(0, seq_hi, (NE, N, N))),
                i(rng.randint(0, 40, (NE, N, N))),
                i(rng.randint(-1, 10, (NE, N, N)))]

    k5_err = 0.0
    cases = [(d, m, False) for d in (2, 3, 4) for m in (True, False)]
    cases.append((2, True, True))
    for k, (design, merge, cluster) in enumerate(cases):
        args = k5_inputs(10 + k, cluster)
        got = K5.channel_phase(*args, 7, C, R, design, merge)
        want = K5.channel_phase_plain(*args, 7, C, R, design, merge)
        torch.cuda.synchronize()
        same = all(torch.equal(g, h) for g, h in zip(got, want))
        err = max(float((g.double() - h.double()).abs().max())
                  for g, h in zip(got, want))
        k5_err = max(k5_err, err)
        log(f"K5 design={design} merge={merge} cluster={cluster}: "
            f"max|diff|={err:.3e} {'bit-exact' if same else 'FAIL'}")
        if not same:
            failures.append(f"K5 design={design} merge={merge}")

    args = k5_inputs(99)
    k5_ms = cuda_ms(lambda: K5.channel_phase(*args, 7, C, R, 2, True))
    k5_plain_ms = cuda_ms(lambda: K5.channel_phase_plain(*args, 7, C, R, 2,
                                                         True))
    # operations this input needs: distances (6 per pair), and per busy
    # channel a closest-tx scan, PRR and last_arrival pass over its
    # transmitters (3 per receiver-transmitter pair) and one compare per
    # entry of every merging receiver's row
    D_ = pairwise_distances(args[0], args[1])
    ops = 6.0 * NE * N * N
    for ch in range(C):
        txm = args[2] == ch
        tot = txm.sum(1)
        reach = (txm[:, None, :] & (D_ < R)).any(-1) & ~txm & (tot > 0)[:, None]
        ops += 3.0 * N * float(tot.sum()) + N * float(reach.sum())
    nbytes = 4 * (3 * NE * N + 2 * 5 * NE * N * N + NE * N + NE * N * C)
    rows["K5"] = dict(name="K5 channel_phase (step_channel walk)", route="cuda",
                      source="diral_tpu_torch/csrc/channel_phase.cu",
                      replaces="diral_tpu/ops/pallas_step.py:60",
                      max_abs_err=k5_err, ms=k5_ms, plain_ms=k5_plain_ms,
                      library_ms=None, **bound(ops, nbytes, F32_PEAK))
    log(f"K5: kernel {k5_ms:.4f} ms  plain {k5_plain_ms:.4f} ms  "
        f"bound {rows['K5']['bound_ms']:.5f} ms ({rows['K5']['bound_by']})")

    # 3c. K6: piggy histogram, 16 envs, N = 100, 50 bins over +-500
    NB, RNG = 50, 500.0
    rng = np.random.RandomState(5)
    px = rng.randint(0, 2000, (NE, N)).astype(np.float32)
    offs = rng.uniform(-700, 700, (NE, N, N))
    edge = rng.randint(0, NB + 1, (NE, N, N)) * (2 * RNG / NB) - RNG
    offs = np.where(rng.rand(NE, N, N) < 0.25, edge, offs)
    t = lambda a, dt=np.float32: torch.from_numpy(
        np.ascontiguousarray(a, dt)).to(dev)
    k6_args = [t(px[:, :, None] + offs), t(rng.randint(0, 2, (NE, N, N))),
               t(px), t(rng.randint(0, 2, (NE, N))),
               t(rng.randint(0, 30, (NE, N, N)), np.int32)]
    got = K6.piggy_histogram(*k6_args, RNG, NB)
    want = K6.piggy_histogram_plain(*k6_args, RNG, NB)
    torch.cuda.synchronize()
    k6_err = float((got - want).abs().max())
    same = torch.equal(got, want)
    log(f"K6: max|diff|={k6_err:.3e} {'bit-exact' if same else 'FAIL'}")
    if not same:
        failures.append("K6")
    k6_ms = cuda_ms(lambda: K6.piggy_histogram(*k6_args, RNG, NB))
    k6_plain_ms = cuda_ms(lambda: K6.piggy_histogram_plain(*k6_args, RNG, NB))
    rows["K6"] = dict(name="K6 piggy_hist (type-2 positional distribution)",
                      route="cuda", source="diral_tpu_torch/csrc/piggy_hist.cu",
                      replaces="diral_tpu/ops/pallas_kernels.py:36",
                      max_abs_err=k6_err, ms=k6_ms, plain_ms=k6_plain_ms,
                      library_ms=None,
                      **bound(12.0 * NE * N * N,
                              4 * (3 * NE * N * N + 2 * NE * N + NE * N * NB),
                              F32_PEAK))
    log(f"K6: kernel {k6_ms:.4f} ms  plain {k6_plain_ms:.4f} ms  "
        f"bound {rows['K6']['bound_ms']:.5f} ms ({rows['K6']['bound_by']})")

    # 4. reference phase: kernels on the card vs plain versions on the CPU
    scale = load_config(os.path.join(here, "configs", "scale_100v_50r.yaml"))
    import dataclasses
    small = dataclasses.replace(scale.env, num_users=40, num_channels=10)
    cpu_env = dataclasses.replace(small, step_impl="pallas", state=dataclasses
                                  .replace(small.state, hist_impl="pallas"))
    gen = torch.Generator(device="cpu").manual_seed(3)
    s_cpu = E.reset(small, 2, gen, torch.float32, "cpu")
    s_gpu = E.EnvState(**{k: v.to(dev) for k, v in vars(s_cpu).items()})
    acfg = dataclasses.replace(scale.agent, network=dataclasses.replace(
        scale.agent.network, lstm_impl="pallas"))
    net_cpu = qnets.drqn_init(torch.Generator().manual_seed(4),
                              small.state_space, small.num_channels, acfg)
    net_gpu = qnets.DRQN({g: {k: v.detach().to(dev) for k, v in leaves.items()}
                          for g, leaves in net_cpu.tree().items()}, acfg)
    hist_cpu = torch.zeros((2, 6, 40, small.state_space))
    ref_ok, q_gap = True, 0.0
    rng = np.random.RandomState(6)
    with torch.inference_mode():
        for step in range(8):
            acts = torch.from_numpy(rng.randint(0, 10, (2, 40)))
            s_cpu, o_cpu, r_cpu = E.step_channel(cpu_env, s_cpu, acts, step)
            s_gpu, o_gpu, r_gpu = E.step_channel(small, s_gpu, acts.to(dev), step)
            v_cpu = E.obtain_state(cpu_env, s_cpu, o_cpu, acts, r_cpu)
            v_gpu = E.obtain_state(small, s_gpu, o_gpu, acts.to(dev), r_gpu)
            pairs = [(o_cpu, o_gpu), (r_cpu, r_gpu), (v_cpu, v_gpu)] + [
                (getattr(s_cpu, f), getattr(s_gpu, f))
                for f in ("table_x", "table_y", "table_seq", "table_age",
                          "last_arrival", "pos_x")]
            ref_ok &= all(torch.equal(a, b.cpu()) for a, b in pairs)
            hist_cpu = torch.cat([hist_cpu[:, 1:], v_cpu[:, None]], dim=1)
            x = hist_cpu.transpose(1, 2).reshape(80, 6, -1)
            q_cpu = qnets.drqn_apply(net_cpu, x, acfg)
            q_gpu = qnets.drqn_apply(net_gpu, x.to(dev), acfg)
            q_gap = max(q_gap, float((q_cpu - q_gpu.cpu()).abs().max()))
    ref_ok &= q_gap <= 1e-3
    log(f"reference (N=40, C=10, 8 steps, card kernels vs CPU plain): env "
        f"{'bit-exact' if ref_ok else 'FAIL'}, max|dQ|={q_gap:.2e}")
    if not ref_ok:
        failures.append("reference phase")

    # 5. slice: DIRAL vs SPS on the 100v/50r config through the kernels
    params = qnets.drqn_init(torch.Generator(device=dev).manual_seed(0),
                             scale.env.state_space, scale.env.num_channels,
                             scale.agent, torch.float32, dev)
    wrappers = {"K1": K1.lstm_last_flat, "K5": K5.channel_phase,
                "K6": K6.piggy_histogram}
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = evaluate.compare_drqn_vs_sps(scale, params, 1, steps=STEPS,
                                       device=dev)
    torch.cuda.synchronize()
    t_cmp = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    for k, n in launches.items():
        rows[k]["launches"] = n
    log(f"slice compare-sps 100v/50r: {STEPS} steps x 2 policies in "
        f"{t_cmp:.2f} s; launches {launches}")
    log(json.dumps(res))
    vals = [v for m in (res["drqn"], res["sps"]) for v in m.values()]
    ok_vals = (all(math.isfinite(v) for v in vals)
               and 0.0 <= res["drqn"]["mean_prr"] <= 1.0
               and 0.0 <= res["sps"]["mean_prr"] <= 1.0)
    if not ok_vals:
        failures.append("slice metrics")
    for k in ("K1", "K5", "K6"):
        if launches[k] < STEPS:
            failures.append(f"{k} launched {launches[k]} < {STEPS} times")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    evaluate.evaluate_drqn(scale, params, 2, steps=STEPS, device=dev)
    torch.cuda.synchronize()
    t_drqn = time.perf_counter() - t0
    log(f"greedy DRQN 100v/50r: {STEPS / t_drqn:.1f} slots/s "
        f"({16 * 100 * STEPS / t_drqn:.0f} agent-decisions/s)")
    profile_slots(torch, evaluate, scale, params, dev)

    toy = load_config(os.path.join(here, "configs", "toy_4ue_3r.yaml"))
    toy = dataclasses.replace(toy, engine=dataclasses.replace(toy.engine,
                                                              num_envs=256))
    tparams = qnets.drqn_init(torch.Generator(device=dev).manual_seed(0),
                              toy.env.state_space, toy.env.num_channels,
                              toy.agent, torch.float32, dev)
    before = K1.lstm_last_flat.launches
    evaluate.evaluate_drqn(toy, tparams, 2, steps=20, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tres = evaluate.evaluate_drqn(toy, tparams, 3, steps=STEPS, device=dev)
    torch.cuda.synchronize()
    t_toy = time.perf_counter() - t0
    k1_toy = K1.lstm_last_flat.launches - before
    log(f"greedy DRQN toy 4v/3r x 256 envs: {STEPS / t_toy:.1f} slots/s, "
        f"K1 launches {k1_toy}; {json.dumps(tres)}")
    if k1_toy < STEPS + 20 or not all(math.isfinite(v) for v in tres.values()):
        failures.append("toy slice")

    # 6. results
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{k: r.get(k) for k in order} | {
        k: v for k, v in r.items() if k not in order} for r in rows.values()]
    if failures:
        print("chip_smoke FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
