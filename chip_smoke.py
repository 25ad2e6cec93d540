#!/usr/bin/env python3
"""On-card check of the PyTorch/CUDA port (diral_tpu_torch).

    python3 chip_smoke.py

Needs one CUDA device and the CUDA toolkit (nvcc).  Phases, in order; any
failure exits non-zero:

1. the card's name and power limit (nvidia-smi);
2. build every kernel of diral_tpu_torch/csrc from the checkout, in
   parallel, and print the build time and each kernel's registers, static
   shared memory and spills (``nvcc -Xptxas -v``);
3. kernel phases: each serving kernel against its plain PyTorch version
   on the card, at the shapes of the 100v/50r serving path, inputs from a
   numpy seed -- K1 LSTM window (the K1 class: each |dh| within 1e-4
   plus one bf16 step, the median below 1e-6), K5 channel walk
   (bit-exact; also at N = 37 / C = 8, N = 255, actions -1 and C and a
   real 100v/50r env's state, each with its two-pass plan, and its
   passes' device times), K6 piggy histogram (bit-exact at 16 x 100 x 50,
   N = 37, N = 255 with 128 bins, N = 1, B = 1 with 20 bins and a real
   100v/50r env's tables, each with its plan; its device time, wrapper
   host time and the launch floor: ``dtt_noop_launch``, an empty kernel,
   through the same launch path); K7 lanes histogram (bit-exact) at the
   PPO shape, the toy serving shape, a batch that is not a multiple of the
   TPU pack width and N*N = 121, with its device and host times; kernel /
   plain / library times (CUDA events, median of 7 after warm-up);
4. reference phases: a small env (N = 40) stepped through the kernels on
   the card and through the plain versions on the CPU, same actions:
   tables, observations, rewards and state vectors bit-equal, Q-values
   within 1e-3; the same for an N = 6 env batch under
   ``hist_impl="lanes"`` (K7 on the card);
5. serving slice: ``compare_drqn_vs_sps`` on configs/scale_100v_50r.yaml
   (16 envs, float32) with every launch counter set to 0 just before and
   read just after (each kernel must have launched at least once per
   step), then ``evaluate_drqn`` on the toy config at 256 envs (K1 only,
   then 20 slots under ``hist_impl="lanes"``: K7 too);
6. training kernels at the toy (2048 rows, D = 23) and 100v/50r (25,600
   rows, D = 100) train-event shapes, float32 and bfloat16 windows: K2 and
   K4 bit-equal to K1; K1, K2, K4 in the K1 class of their plain versions
   (each |dh| within 1e-4 plus one bf16 step, the median below 1e-6) --
   the forwards also at ragged batches (97 and 2047 rows, D = 23), H = 128
   (96 and 2400 rows, D = 25) and H = 512 (4096 rows, D = 100), f32 and
   bf16, each with its plan (rows per block, blocks, shared memory), and
   K1 at H = 1024 with K2 and K4 refused there; K3 within 1e-3 of the
   largest plain value for dWx, dWh, db and dx (plus one bf16 step for a
   bf16 dx), with ``need_dx`` on and off giving bit-equal dW and db, two
   calls on the same inputs bit-equal and the row pass's bf16 h stash
   bit-equal to K1's forward after t steps -- also at H = 512 (4096 rows,
   D = 100), H = 1024 (512 rows, D = 23) and at ragged batches (97 and
   2047 rows, D = 23); times against the bound, the plain version and
   cuDNN's LSTM, and K3's row pass and reduction (partial + combine)
   device times from torch.profiler, each beside its own bound; then K1
   at configs[4]'s acting shape (102,400 rows, D = 100, f32 and bf16):
   bit-equal to K4 on the same weights (K1's cells divide without a
   branch and its step 0 skips the zero h tiles; K4 runs cell() as
   written and every k tile), rows 0..1599 bit-equal to a 1600-row call,
   the same with inputs scaled by 40 (the cells' fallback to cell()) and
   with zero rows and -0.0 biases, K1's reciprocal bit-equal to
   __fdiv_rn(1, y) at every float y in [1, 2^126), and K1's time (CUDA
   events and torch.profiler) beside the bound;
7. learner phase (toy shape): ``train_on_windows`` (K2 + K3) and
   ``train_on_packed`` (K1 + K3, K4) on one sampled row batch give
   the same loss and step; the card's gradients match the CPU's plain
   versions within 1e-3 of the largest;
8. training slice: ``train_experiment`` on the toy config (1500 slots) and
   on the 100v/50r config (400 slots, 16 envs) with launch counters set to
   0 just before and read just after, a finite loss, slots/s and ms per
   train event; the ``train`` verb once through the CLI;
9. PPO slice: ``run_ppo`` on configs/ppo_congested.yaml at full width
   (16 envs, H = 128) under ``hist_impl="lanes"``, 20 episodes, launch
   counters around it (K7, K1, K3 at least as often as the code implies),
   episodes/s, ms per PPO update and a torch.profiler pass over updates
   (before it, K1 and K3 with dx at 96 and 2400 rows, H = 128, held as in
   phase 6, K3's passes timed at 2400 rows);
   ``compare_ppo_vs_sps`` for 300 slots; the ``train-ppo`` verb;
10. PS slice: ``run_ps`` on configs/congested_6v_5r.yaml at 32 envs under
   ``hist_impl="lanes"``, PS-DQN and PS-DRQN for 8 episodes each, finite
   losses, K7 launches; the ``train-ps`` verb;
11. a torch.profiler pass over toy and 100v/50r train events;
12. run management (train/checkpoint.py, sweep.py, profiling.py), each
   phase with its seconds:
   (a) the PRR configs through ``train_experiment`` at their published
       widths -- congested_6v_5r (design topology) and dynamic_20v_15r
       (velocity kicks), both on the channel step -- 550 slots each (two
       train events), launch counters around each, finite losses;
   (b) exact resume at full width on 100v/50r (save_model, save_freq
       300): B stops at 300, C resumes it to 350 (launch counters around
       C), A runs 350 slots uninterrupted; C's carry (nets, Adam, replay,
       env, history, schedules), its generator state and its sum_reward /
       actions arrays must equal A's bit for bit; the checkpoint's bytes,
       its save and restore seconds and the slots/s of A and C;
   (c) ``eval --checkpoint DIR --best`` on B's directory (learner only);
   (d) ``train-sweep configs/toy_4ue_3r.yaml --seeds 2`` (550 slots, a
       100-slot eval), row 0's sum_reward bit-equal to a standalone
       ``train_experiment(seed=0)``;
   (e) the ``profile`` verb on 100v/50r (16 envs, 100 slots): its
       top_ops name the csrc kernels of K1, K2, K3, K5 and K6, its
       ``--trace-dir`` (a temporary directory) gets a Chrome trace; its
       category table;
   (f) the full-schedule scripts (diral_tpu_torch/scripts): ``seed_campaign``
       on the toy, 2 seeds x 600 slots, ``--save-freq 100``, a 20-slot
       eval on 16 envs, uncut and then cut after seed 1's second
       checkpoint and started again -- rows bit-equal apart from timings,
       the finished seed not run again, the open one resumed from slot 200
       --; ``full_run`` on 100v/50r (300 slots, a 20-slot eval) with
       K1, K2, K3, K5 and K6 launched;
   (g) online serving (diral_tpu_torch/interop): the port's C++ RealNeS
       stand-in built from the checkout (g++, no protobuf), then the
       ``serve`` verb at 8 users / 6 channels: ``--mode compare`` for 200
       rounds, ``ps-dqn``, ``drqn-rssi`` and ``drqn`` for 100 each over
       framed, then ``drqn`` over zmq (the simulator loading the libzmq
       ``transport.libzmq_path`` finds, pyzmq's bundled copy on a machine
       without a system one; none is a failure), each with finite
       stats and losses, rounds / 10 train calls and its learner on the
       card, its requests/s and host ms per request (waiting on the
       simulator, inference, training); no K1-K7 launch; a torch.profiler
       pass over 40 rounds for the device's busy share per request;
   (h) the measurement entry points (diral_tpu_torch/bench.py and
       scripts/{bench_event,kernel_ceiling}.py) at cut lengths: the
       headline (8192 toy envs x 32 steps), kernel parity in full, the
       100v/50r engine (2048 envs x 8 steps), the toy training loop (256
       envs, 4 chunks of 50 slots from slot 612, float32 with its
       training-off split, then bf16), ``bench_event`` (R = 4) and
       ``kernel_ceiling`` at the toy shape; the JSON keys must equal the
       JAX scripts', every rate be finite and positive, parity pass, and
       the launch counters read per section: none of K1-K7 on the toy
       headline, K5 and K6 on the 100v/50r engine, K1, K2 and K3 on the
       train loop, K1-K4 in ``bench_event`` and ``kernel_ceiling``;
       then the device's busy share under torch.profiler of headline,
       scale and train-loop steps and of K1 + K3 at the toy event shape;
   (i) the parallel layer (diral_tpu_torch/parallel): the ``train`` verb
       on 100v/50r, 16 envs x 400 slots (six train events), with
       ``--resume`` so that each run writes its checkpoint: once without
       a mesh, then ``--mesh data=1`` as one rank over NCCL, ``--mesh
       data=2`` and ``--mesh data=1,model=2`` as two ranks sharing the
       card over gloo (rank 0 in this process, rank 1 a subprocess);
       each mesh run's rewards, actions and checkpoint (learner, Adam,
       ring, env, generator) bit-equal to the one-process run's, K1, K2,
       K3, K5 and K6 launched on rank 0, the backend and each rank's
       device printed, every train event of ``data=2`` one data-group
       all-reduce of ``sampler_collective_bytes``' bytes (none at data=1:
       a group of one is skipped), and the device bytes a checkpoint save
       adds on rank 0 at most ``SAVE_CHUNK_BYTES``; one all-reduce of the
       sampler's batch through a one-rank NCCL group, asked for
       explicitly; then ``width_report --no-run`` and a measured run cut
       to 64 envs x 4 chunks of 100 slots;
   (j) the PPO and PS campaign drivers (diral_tpu_torch/scripts):
       ``ppo_campaign`` on configs/ppo_congested.yaml, 2 seeds x 40
       episodes, ``--save-freq 10``, a 20-slot eval on 16 envs, uncut
       and then cut after seed 1's second checkpoint and started again;
       ``ps_campaign`` (the toy x 16 envs), 1 seed x 20 episodes of each
       algorithm, ``--save-freq 5``, cut after PS-DRQN's second
       checkpoint -- rows bit-equal apart from timings, only the open run
       started again and resumed from its checkpoint, K1 and K3 launched
       by the uncut PPO campaign (the PS toy runs launch none: N = 4);
       then ``drqn.qvalues_all_agents`` at 100v/50r (100 agents) through
       K1, its last hidden state in the K1 class of K1's plain version
       and its Q within 1e-3 of the largest of the plain path's;
   (k) the reference's six-config suite (diral_tpu_torch/scripts/
       ref_sweep.py), 600 slots a config, ``--save-freq 100``, a 20-slot
       eval on 16 envs: uncut in this process with the launch counters
       around it (K1, K2, K3 at D = 13, 23 and 43; none of K4-K7), then
       cut after the first config's second checkpoint and started again
       with ``--jobs 2`` -- rows bit-equal apart from timings, the cut
       config resumed from slot 200, the others run from slot 0;
   then the script's total seconds;
13. a ``kernels`` JSON line and, last, the ``ok`` JSON line.

It imports nothing of JAX nor of the JAX package.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import re
import statistics
import struct
import subprocess
import sys
import time

# the card's peaks and one bf16 step: one copy, in the bench module
from diral_tpu_torch.bench import (
    BF16_PEAK, F32_PEAK, HBM_BYTES_PER_S, bf16_ulp)

STEPS = 300


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


def device_profile(torch, fn, per):
    """torch.profiler over ``fn()``: (wall ms, [(kernel, device ms, count)],
    busy device ms), each divided by ``per`` (slots or events)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / per
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.key, getattr(e, "self_device_time_total", 0.0) / 1e3 / per,
             e.count / per) for e in prof.key_averages()
            if e.device_type == cuda]
    return wall_ms, rows, sum(ms for _, ms, _ in rows)


def kernel_device_ms(torch, call, names, reps, failures, label, tries=3):
    """Device ms per call of each kernel whose name holds one of ``names``,
    from torch.profiler over ``reps`` calls of ``call``.  The profiler can
    drop a window's kernel records (seen once for K7's 20 launches), so
    each window opens with a 20 ms pause before the first launch, and a
    window that holds fewer than ``reps`` records of a name is traced
    again, up to ``tries`` windows; a name still short is not measured:
    None, and ``label`` goes to ``failures``."""
    def window():
        time.sleep(0.02)
        for _ in range(reps):
            call()

    for attempt in range(1, tries + 1):
        torch.cuda.synchronize()
        _, prow, _ = device_profile(torch, window, reps)
        # per name: (device ms, records) per call
        got = {n: (sum(ms for k, ms, _ in prow if n in k),
                   sum(c for k, _, c in prow if n in k)) for n in names}
        short = [n for n, (_, c) in got.items() if c < 1]
        if not short:
            return {n: ms for n, (ms, _) in got.items()}
        log(f"{label}: profiler window {attempt} of {tries} holds fewer "
            f"than {reps} records of " + ", ".join(short))
    failures.append(f"{label}: device time not measured")
    return {n: (None if n in short else ms) for n, (ms, _) in got.items()}


def ms_text(ms):
    return "not measured" if ms is None else f"{ms:.4f}"


def log_profile(title, unit, wall_ms, rows, busy, top):
    log(f"{title}: wall {wall_ms:.3f} ms/{unit}, device busy {busy:.3f} "
        f"ms/{unit} ({100 * busy / wall_ms:.1f}% of wall), "
        f"{sum(c for *_, c in rows):.0f} kernels/{unit}")
    for key, ms, count in sorted(rows, key=lambda r: -r[1])[:top]:
        log(f"  {100 * ms / max(busy, 1e-9):5.1f}%  {ms:8.4f} ms/{unit}"
            f"  x{count:.0f}  {key[:90]}")


def profile_slots(torch, evaluate, cfg, params, dev, steps=30):
    """Where a greedy slot's time goes: torch.profiler over ``steps`` slots
    of evaluate_drqn; device time by kernel, and the device's busy share
    of the wall time."""
    evaluate.evaluate_drqn(cfg, params, 5, steps=3, device=dev)  # warm
    torch.cuda.synchronize()
    wall_ms, rows, busy = device_profile(
        torch, lambda: evaluate.evaluate_drqn(cfg, params, 5, steps=steps,
                                              device=dev), steps)
    log_profile(f"profile greedy DRQN 100v/50r, {steps} slots", "slot",
                wall_ms, rows, busy, 8)
    ours = {k: sum(ms for key, ms, _ in rows if k in key)
            for k in ("lstm_window", "channel_phase", "piggy_hist")}
    log("  kernels of the port: " + ", ".join(
        f"{k} {100 * v / max(busy, 1e-9):.1f}%" for k, v in ours.items()))


def cudnn_lstm(torch, w, b, D, H, dev):
    """cuDNN's float32 LSTM holding the cell's weights: gate order (i, g, f,
    o -> i, f, g, o) and the +1 forget bias folded into the bias."""
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
    return lstm


def ptxas_stats(report):
    """[(kernel, its registers, static shared memory and spills)] from an
    ``nvcc -Xptxas -v`` report; kernel names as base<template args>."""
    out, label, spill = [], None, ""
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            mangled = m.group(1)
            base = re.search(r"\d([a-z][a-z_]*_kernel)", mangled)
            targs = (mangled.split("_kernelI", 1)[1].split("Ev", 1)[0]
                     if "_kernelI" in mangled else "")
            args = re.findall(r"Li(\d+)E", targs)
            if targs:
                args.append("bf16" if "bfloat16" in targs else "f32")
            label = (f"{base.group(1)}<{','.join(args)}>" if base
                     else mangled)
        elif label and "spill" in line:
            spill = line.strip()
        elif label and "registers" in line:
            out.append((label, f"{line.split(':', 1)[1].strip()}; {spill}"))
            label, spill = None, ""
    return out


def lstm_train_inputs(torch, np, K1, dev, B, D, H, steps, seed, dtype):
    """Online and target LSTM weights, a flat window of ``steps`` steps
    and a cotangent of h, from a numpy seed."""
    rng = np.random.RandomState(seed)
    lim = math.sqrt(6.0 / (D + H + 4 * H))

    def net():
        return (torch.from_numpy(rng.uniform(-lim, lim, (D + H, 4 * H))
                                 .astype(np.float32)).to(dev),
                torch.from_numpy(rng.normal(0, 0.1, 4 * H)
                                 .astype(np.float32)).to(dev))

    (w, b), (wt, bt) = net(), net()
    x = rng.normal(size=(B, steps, D)).astype(np.float32)
    x2 = K1.flatten_window(torch.from_numpy(x)).to(dev, dtype).contiguous()
    g = torch.from_numpy(rng.normal(size=(B, H)).astype(np.float32)).to(
        dev, dtype)
    return x2, w, b, wt, bt, g


def k3_gaps(torch, grads, plain, D):
    """K3's (dx, dW, db) against its plain version: the largest gap of
    dWx, dWh, db and dx over the largest plain value of each, whether
    every gap is within 1e-3 of that value (plus one bf16 step for a bf16
    dx: the two roundings may land one step apart), and the largest gap."""
    (dx, dw, db), (pdx, pdw, pdb) = grads, plain
    rel, ok, abs_g = {}, True, 0.0
    for name, got, want in (("dWx", dw[:D], pdw[:D]),
                            ("dWh", dw[D:], pdw[D:]), ("db", db, pdb),
                            ("dx", dx, pdx)):
        bf16 = got.dtype == torch.bfloat16
        got, want = got.float(), want.float()
        gap = (got - want).abs()
        scale = float(want.abs().max())
        rel[name] = float(gap.max()) / scale
        abs_g = max(abs_g, float(gap.max()))
        allow = 1e-3 * scale
        if bf16:
            allow = allow + bf16_ulp(want)
        ok &= bool((gap <= allow).all())
    return rel, ok, abs_g


def k3_check(torch, K1, label, x2, w, b, g, T, D, failures):
    """K3 against its plain version (``k3_gaps``), dW and db bit-equal with
    ``need_dx`` on and off, every output bit-equal across two calls on the
    same inputs, and the row pass's bf16 h stash at step t bit-equal to
    K1's forward over the first t steps, rounded to bf16 (zero at t = 0).
    Returns (rel, ok, abs_g) of ``k3_gaps``."""
    grads = K1.lstm_window_bwd(x2, w, b, g, T, True)
    again = K1.lstm_window_bwd(x2, w, b, g, T, True)
    no_dx = K1.lstm_window_bwd(x2, w, b, g, T, False)
    plain = K1.lstm_window_bwd_plain(x2, w, b, g, T, True)
    hstash = K1._k3_launch(x2, w, b, g, T, True)[3]
    Dp = K1.padded_dim(D)
    stash = [torch.zeros_like(hstash[0])] + [
        K1.lstm_last_flat(x2[:, :t * Dp], w, b, t).to(torch.bfloat16)
        for t in range(1, T)]
    torch.cuda.synchronize()
    rel, ok, abs_g = k3_gaps(torch, grads, plain, D)
    modes = (torch.equal(grads[1], no_dx[1])
             and torch.equal(grads[2], no_dx[2]))
    repeat = all(torch.equal(p, q) for p, q in zip(grads, again))
    same_h = all(torch.equal(hstash[t], stash[t]) for t in range(T))
    B, H = x2.shape[0], w.shape[1] // 4
    S = K1._reduce_plan(B, T, Dp, H).splits
    plan = K1._bwd_plan(B, Dp, H)
    log(f"K3 {label}: B={B} T={T} D={D} H={H} S={S}, row pass {plan.bm} "
        f"rows x {plan.blocks} blocks, {plan.smem} B shared; vs plain rel "
        + " ".join(f"{k}={v:.2e}" for k, v in rel.items())
        + f" {'ok' if ok else 'FAIL'}; need_dx on/off dW, db "
        f"{'bit-equal' if modes else 'FAIL'}; two calls "
        f"{'bit-equal' if repeat else 'FAIL'}; h stash vs K1 "
        f"{'bit-equal' if same_h else 'FAIL'}")
    for bad, what in ((not ok, "vs plain"), (not modes, "need_dx modes"),
                      (not repeat, "two calls differ"),
                      (not same_h, "h stash vs K1")):
        if bad:
            failures.append(f"K3 {label}: {what}")
    return rel, ok, abs_g


def k3_pass_ms(torch, K1, x2, w, b, g, T, need_dx, reps=3):
    """K3's two phases on the card under torch.profiler, device ms per
    call -- the row pass and the reduction (partial + combine passes) --
    each beside its own bound, its products at the bf16 peak or its bytes
    at 3.35 TB/s, whichever is larger.  The row pass: the recompute
    forward, dh and (``need_dx``) dx products; the window, the cotangent
    and the weights read once, the float32 dgates, the bf16 h stash and dx
    written once.  The reduction: the dgates, the window and the stash
    read once, dW and db written once."""
    torch.cuda.synchronize()
    _, prow, _ = device_profile(
        torch, lambda: [K1.lstm_window_bwd(x2, w, b, g, T, need_dx)
                        for _ in range(reps)], reps)
    B, H = x2.shape[0], w.shape[1] // 4
    Dp, xb = x2.shape[1] // T, x2.element_size()
    R, G = T * B, 4 * H
    return dict(
        rows_ms=sum(ms for k, ms, _ in prow if "lstm_bwd_rows" in k),
        reduce_ms=sum(ms for k, ms, _ in prow
                      if "lstm_bwd_partial" in k or "lstm_bwd_combine" in k),
        rows_bound_ms=bound(
            2.0 * R * G * (Dp + 2 * H + (Dp if need_dx else 0)),
            R * (xb * Dp * (2 if need_dx else 1) + 4 * G + 2 * H)
            + xb * B * H + 2 * (Dp + H) * G + 4 * G, BF16_PEAK)["bound_ms"],
        reduce_bound_ms=bound(2.0 * R * (Dp + H) * G,
                              R * (4 * G + xb * Dp + 2 * H)
                              + 4 * (Dp + H + 1) * G, BF16_PEAK)["bound_ms"])


def fwd_check(torch, K1, label, x2c, w, b, wt, bt, T, failures):
    """The forwards on one combined (T+1)-step window: K2 and K4 bit-equal
    to K1 (steps 0..T-1 and 1..T), and K1, K2 and K4 within the K1 class
    of their plain versions.  Returns the largest |dh| of each."""
    D, H = w.shape[0] - w.shape[1] // 4, w.shape[1] // 4
    B, Dp = x2c.shape[0], K1.padded_dim(D)
    x2, xn = x2c[:, :T * Dp], x2c[:, Dp:]
    hs, hna, hnb = K1.lstm_last_flat_triple(x2c, w, b, wt, bt, T)
    ha, hb = K1.lstm_last_flat_dual(xn, w, b, wt, bt, T)
    singles = (K1.lstm_last_flat(x2, w, b, T),
               K1.lstm_last_flat(xn, w, b, T),
               K1.lstm_last_flat(xn, wt, bt, T))
    torch.cuda.synchronize()
    same = all(torch.equal(p, q) for p, q in
               zip((hs, hna, hnb, ha, hb), singles + singles[1:]))
    plain = K1.lstm_last_flat_triple_plain(x2c, w, b, wt, bt, T)
    plain = plain + plain[1:]
    # the K1 class: sum order may flip the bf16 rounding of an
    # intermediate h, which moves later steps by up to |w| * 2^-8 * |h|
    # -- at 25,600 rows such a flip reaches past 1e-4 in float32 -- so
    # each value may be 1e-4 plus one bf16 step of it apart (phase 3's
    # rule for K1 too), and the median gap must stay below 1e-6
    err, ok = {"K1": 0.0, "K2": 0.0, "K4": 0.0}, True
    for k, got, want in zip(("K2",) * 3 + ("K4",) * 2 + ("K1",) * 3,
                            (hs, hna, hnb, ha, hb) + singles,
                            plain + plain[:3]):
        got, want = got.float(), want.float()
        gap = (got - want).abs()
        err[k] = max(err[k], float(gap.max()))
        ok &= bool((gap <= 1e-4 + bf16_ulp(want)).all())
        ok &= float(gap.median()) < 1e-6
    plans = "; ".join(
        f"{k} {p.bm} rows x {p.blocks} blocks, {p.smem} B shared"
        for k, p in (("K1", K1._fwd_plan(B, Dp, H, 1)),
                     ("K4", K1._fwd_plan(B, Dp, H, 2)),
                     ("K2", K1._fwd_plan(B, Dp, H, 3))))
    log(f"forwards {label}: B={B} T={T} D={D} H={H} ({plans}); K2/K4 vs K1 "
        f"{'bit-equal' if same else 'FAIL'}; vs plain max|dh| K1="
        f"{err['K1']:.3e} K2={err['K2']:.3e} K4={err['K4']:.3e} "
        f"{'ok' if ok else 'FAIL'}")
    for bad, what in ((not same, "bit-equal to K1"), (not ok, "vs plain")):
        if bad:
            failures.append(f"forwards {label}: {what}")
    return err


def train_kernel_phase(torch, np, K1, dev, cuda_ms, bound, failures):
    """Phase 6: K2, K3 and K4 against K1 and their plain versions, the
    forwards also at ragged batches, H = 128 and H = 512, K3 also at H =
    512 and at ragged batches; returns the kernel rows (times at the
    100v/50r train-event shape)."""
    T, H = 6, 256
    rows = {}
    for label, B, D, dtype in (
            ("toy f32", 2048, 23, torch.float32),
            ("toy bf16", 2048, 23, torch.bfloat16),
            ("scale f32", 25600, 100, torch.float32),
            ("scale bf16", 25600, 100, torch.bfloat16)):
        Dp = K1.padded_dim(D)
        x2c, w, b, wt, bt, g = lstm_train_inputs(torch, np, K1, dev, B, D, H,
                                                 T + 1, 7, dtype)
        x2, xn = x2c[:, :T * Dp], x2c[:, Dp:]
        err_h = fwd_check(torch, K1, label, x2c, w, b, wt, bt, T, failures)
        rel, _, abs_g = k3_check(torch, K1, label, x2, w, b, g, T, D,
                                 failures)
        if dtype != torch.float32:
            continue

        # times, float32 windows
        xs3 = K1.unflatten_window(x2, T, D).contiguous()
        xn3 = K1.unflatten_window(xn, T, D).contiguous()
        lstm, lstm_t = (cudnn_lstm(torch, w, b, D, H, dev),
                        cudnn_lstm(torch, wt, bt, D, H, dev))
        lib_params = [p.requires_grad_() for p in lstm.parameters()]
        with torch.no_grad():
            lib2 = cuda_ms(lambda: (lstm(xs3), lstm(xn3), lstm_t(xn3)))
            lib4 = cuda_ms(lambda: (lstm(xn3), lstm_t(xn3)))
        lib3 = cuda_ms(lambda: torch.autograd.grad(
            lstm(xs3)[0][:, -1], lib_params, grad_outputs=g.float()))
        t2 = cuda_ms(lambda: K1.lstm_last_flat_triple(x2c, w, b, wt, bt, T))
        p2 = cuda_ms(lambda: K1.lstm_last_flat_triple_plain(x2c, w, b, wt,
                                                            bt, T))
        t4 = cuda_ms(lambda: K1.lstm_last_flat_dual(xn, w, b, wt, bt, T))
        p4 = cuda_ms(lambda: K1.lstm_last_flat_dual_plain(xn, w, b, wt, bt,
                                                          T))
        t3 = cuda_ms(lambda: K1.lstm_window_bwd(x2, w, b, g, T, False))
        t3dx = cuda_ms(lambda: K1.lstm_window_bwd(x2, w, b, g, T, True))
        p3 = cuda_ms(lambda: K1.lstm_window_bwd_plain(x2, w, b, g, T, False))
        passes = k3_pass_ms(torch, K1, x2, w, b, g, T, False)
        G4 = 4 * H
        wbytes = 4 * (w.numel() + b.numel())
        f2 = 2.0 * B * G4 * ((T + 1) * D + 2 * T * H + T * (D + H))
        f3 = 2.0 * B * G4 * (2 * T * (D + H) + T * H)
        f4 = 2.0 * 2 * B * T * (D + H) * G4
        b2 = 4 * x2c.numel() + 2 * wbytes + 3 * 4 * B * H
        b3 = 4 * (B * T * Dp + B * H) + wbytes + 4 * ((D + H) * G4 + G4)
        b4 = 4 * B * T * Dp + 2 * wbytes + 2 * 4 * B * H
        log(f"train kernels {label} times: K2 {t2:.4f} ms (plain {p2:.4f}, "
            f"3 cuDNN forwards {lib2:.4f}); K4 {t4:.4f} ms (plain {p4:.4f}, "
            f"2 cuDNN forwards {lib4:.4f}); K3 {t3:.4f} ms, with dx "
            f"{t3dx:.4f} (plain {p3:.4f}, cuDNN forward + grad {lib3:.4f}); "
            f"K3 device ms per call: row pass {passes['rows_ms']:.4f} (its "
            f"bound {passes['rows_bound_ms']:.4f}), reduction "
            f"{passes['reduce_ms']:.4f} (its bound "
            f"{passes['reduce_bound_ms']:.4f})")
        if label != "scale f32":
            continue
        common = dict(route="cuda", source="diral_tpu_torch/csrc/lstm_window.cu")
        rows["K2"] = dict(
            name="K2 lstm_triple (train-step triple forward)", **common,
            replaces="diral_tpu/ops/pallas_lstm.py:322",
            max_abs_err=err_h["K2"],
            ms=t2, plain_ms=p2, library_ms=lib2, **bound(f2, b2, BF16_PEAK))
        rows["K3"] = dict(
            name="K3 lstm_bwd (recompute backward, need_dx=False; 3 launches)",
            **common, replaces="diral_tpu/ops/pallas_lstm.py:106",
            max_abs_err=abs_g, max_rel_err=max(rel.values()), ms=t3,
            ms_need_dx=t3dx, plain_ms=p3, library_ms=lib3,
            splits=K1._reduce_plan(B, T, Dp, H).splits, **passes,
            **bound(f3, b3, BF16_PEAK))
        rows["K4"] = dict(
            name="K4 lstm_dual (online + target forward)", **common,
            replaces="diral_tpu/ops/pallas_lstm.py:255",
            max_abs_err=err_h["K4"],
            ms=t4, plain_ms=p4, library_ms=lib4, **bound(f4, b4, BF16_PEAK))

    # the forwards at ragged batches, H = 128 and H = 512, f32 and bf16
    for label, B, D, Hs in (("ragged 97", 97, 23, 256),
                            ("ragged 2047", 2047, 23, 256),
                            ("H=128 96", 96, 25, 128),
                            ("H=128 2400", 2400, 25, 128),
                            ("H=512", 4096, 100, 512)):
        for dtype, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
            x2c, w, b, wt, bt, _ = lstm_train_inputs(torch, np, K1, dev, B, D,
                                                     Hs, T + 1, 9, dtype)
            fwd_check(torch, K1, f"{label} {name}", x2c, w, b, wt, bt, T,
                      failures)

    # H = 1024: K1 has a plan (16-row tiles), K2 and K4 are refused
    x2c, w, b, wt, bt, _ = lstm_train_inputs(torch, np, K1, dev, 512, 23,
                                             1024, T + 1, 10, torch.float32)
    x2 = x2c[:, :T * K1.padded_dim(23)]
    got = K1.lstm_last_flat(x2, w, b, T)
    want = K1.lstm_last_flat_plain(x2, w, b, T)
    torch.cuda.synchronize()
    gap = (got - want).abs()
    ok = bool((gap <= 1e-4 + bf16_ulp(want)).all()
              and float(gap.median()) < 1e-6)
    refused = []
    for name, call in (("K2", lambda: K1.lstm_last_flat_triple(
            x2c, w, b, wt, bt, T)), ("K4", lambda: K1.lstm_last_flat_dual(
                x2c[:, K1.padded_dim(23):], w, b, wt, bt, T))):
        try:
            call()
        except ValueError as e:
            refused.append(name if "no tensor-core forward tile" in str(e)
                           else f"{name} ({e})")
    ok &= refused == ["K2", "K4"]
    log(f"forwards H=1024 (512 rows, D=23): K1 vs plain max|dh| "
        f"{float(gap.max()):.3e}; refused {refused} {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("forwards H=1024")

    # K3 alone at H = 512, H = 1024 and at batches that cut into ragged
    # chunks
    for label, B, D, H in (("H=512", 4096, 100, 512),
                           ("H=1024", 512, 23, 1024),
                           ("ragged 97", 97, 23, 256),
                           ("ragged 2047", 2047, 23, 256)):
        x2, w, b, _, _, g = lstm_train_inputs(torch, np, K1, dev, B, D, H, T,
                                              8, torch.float32)
        k3_check(torch, K1, label, x2, w, b, g, T, D, failures)
    return rows


def rcp_check(torch, K1, dev):
    """K1's branch-free reciprocal against __fdiv_rn(1, y) at every float
    y in [1, 2^126) (csrc lstm_rcp_check): (floats differing, least such
    y or None)."""
    lib = K1._library()
    count = torch.zeros(1, dtype=torch.int64, device=dev)
    first = torch.full((1,), -1, dtype=torch.int32, device=dev)
    lo, hi = 0x3F800000, 0x7E800000   # 1.0, 2^126
    K1._build.launch(lib, "lstm_rcp_check", [ctypes.c_uint, ctypes.c_uint,
                                            ctypes.c_void_p, ctypes.c_void_p],
                     dev, lo, hi, count, first)
    torch.cuda.synchronize()
    least = int(first.item()) & 0xFFFFFFFF
    return int(count.item()), (
        None if least == 0xFFFFFFFF else
        struct.unpack("<f", struct.pack("<I", least))[0])


def act_kernel_phase(torch, np, K1, dev, cuda_ms, failures):
    """Phase 6 at the acting shape of configs[4] (102,400 rows, T = 6, D =
    100, H = 256), float32 and bfloat16 windows: K1, whose cells divide
    without a branch and whose step 0 skips the zero h tiles, bit-equal
    to K4 (which runs cell() as written and every k tile) on the same
    weights, rows 0..1599 of the call bit-equal to a 1600-row call, the
    same at 1600 rows with inputs scaled by 40 (sigmoids whose 1 +
    exp(-v) passes 2^126 take cell()) and with half the rows zero and
    every third bias -0.0; K1's reciprocal bit-equal to __fdiv_rn(1, y)
    at every float y in [1, 2^126).  Returns the K1 row's fields for this
    shape: its CUDA-event and device time (f32) beside the bound."""
    B, D, H, T = 102_400, 100, 256, 6
    Dp = K1.padded_dim(D)
    differ, least = rcp_check(torch, K1, dev)
    log(f"K1 reciprocal vs __fdiv_rn(1, y), every float y in [1, 2^126): "
        f"{differ} differ (least {least}) {'ok' if differ == 0 else 'FAIL'}")
    if differ:
        failures.append("K1 reciprocal")
    out = {}
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        x2, w, b, _, _, _ = lstm_train_inputs(torch, np, K1, dev, B, D, H, T,
                                              11, dtype)
        got = K1.lstm_last_flat(x2, w, b, T)
        exact, _ = K1.lstm_last_flat_dual(x2, w, b, w, b, T)
        head = K1.lstm_last_flat(x2[:1600], w, b, T)
        xs, ws, bs = x2[:1600] * 40, w * 40, b * 40
        sat = K1.lstm_last_flat(xs, ws, bs, T)
        sat_exact, _ = K1.lstm_last_flat_dual(xs, ws, bs, ws, bs, T)
        xz, bz = x2[:1600].clone(), b.clone()
        xz[:800] = 0
        bz[::3] = -0.0
        zero = K1.lstm_last_flat(xz, w, bz, T)
        zero_exact, _ = K1.lstm_last_flat_dual(xz, w, bz, w, bz, T)
        torch.cuda.synchronize()
        checks = (("K1 vs K4", torch.equal(got, exact)),
                  ("rows :1600 vs a 1600-row call",
                   torch.equal(got[:1600], head)),
                  ("saturated K1 vs K4", torch.equal(sat, sat_exact)),
                  ("zero rows, -0.0 biases, K1 vs K4",
                   torch.equal(zero, zero_exact)))
        plan = K1._fwd_plan(B, Dp, H, 1)
        log(f"K1 act {name}: B={B} T={T} D={D} H={H} ({plan.bm} rows x "
            f"{plan.blocks} blocks, {plan.smem} B shared); " + "; ".join(
                f"{k} {'bit-equal' if ok else 'FAIL'}" for k, ok in checks))
        for what, ok in checks:
            if not ok:
                failures.append(f"K1 act {name}: {what}")
        if dtype != torch.float32:
            continue
        lim = bound(2.0 * B * T * (D + H) * 4 * H,
                    4 * (B * T * Dp + (D + H) * 4 * H + 4 * H + B * H),
                    BF16_PEAK)
        ms = cuda_ms(lambda: K1.lstm_last_flat(x2, w, b, T))
        dev_ms = kernel_device_ms(
            torch, lambda: K1.lstm_last_flat(x2, w, b, T),
            ["lstm_window_tc_kernel"], 5, failures,
            "K1 act")["lstm_window_tc_kernel"]
        log(f"K1 act f32 time: {ms:.4f} ms (device {ms_text(dev_ms)}); "
            f"bound {lim['bound_ms']:.4f} ms ({lim['bound_by']})")
        out = dict(act_rows=B, act_ms=ms, act_device_ms=dev_ms,
                   act_bound_ms=lim["bound_ms"])
    return out


def ppo_kernel_phase(torch, np, K1, dev, cuda_ms, rows, failures):
    """K1 and K3 (with dx, the most a PPO encoder's backward can ask: its
    windows need no gradient, so the PPO run's K3 calls skip dx) at the PPO
    path's shapes, float32: T = 6, D = 25, H = 128 over 96 rows (an actor
    step: 16 envs x 6 vehicles) and 2400 rows (an update: 25 slots x 96).
    Each against its plain version -- K1 within 1e-4, K3 as ``k3_check``
    holds it -- and, at 2400 rows, times against the bound, the plain
    version and cuDNN's LSTM, and K3's two phases' device times.
    Recorded as ``ppo_shape`` in the K1 and K3 rows."""
    T, D, H = 6, 25, 128
    Dp, G4 = K1.padded_dim(D), 4 * H
    err1 = err3 = rel3 = 0.0
    for B in (96, 2400):
        x2, w, b, _, _, g = lstm_train_inputs(torch, np, K1, dev, B, D, H,
                                              T, 12, torch.float32)
        h = K1.lstm_last_flat(x2, w, b, T)
        ph = K1.lstm_last_flat_plain(x2, w, b, T)
        torch.cuda.synchronize()
        e1 = float((h - ph).abs().max())
        log(f"K1 at the PPO shape ({B} rows, T={T} D={D} H={H}): "
            f"max|dh|={e1:.3e} {'ok' if e1 <= 1e-4 else 'FAIL'}")
        if e1 > 1e-4:
            failures.append(f"K1 at the PPO shape ({B} rows)")
        rel, _, e3 = k3_check(torch, K1, f"PPO shape, dx ({B} rows)", x2, w,
                              b, g, T, D, failures)
        err1, err3 = max(err1, e1), max(err3, e3)
        rel3 = max(rel3, max(rel.values()))

    # times at 2400 rows
    x3 = K1.unflatten_window(x2, T, D).contiguous()
    lstm = cudnn_lstm(torch, w, b, D, H, dev)
    lib_params = [p.requires_grad_() for p in lstm.parameters()]
    with torch.no_grad():
        lib1 = cuda_ms(lambda: lstm(x3))
    lib3 = cuda_ms(lambda: torch.autograd.grad(
        lstm(x3)[0][:, -1], lib_params, grad_outputs=g))
    t1 = cuda_ms(lambda: K1.lstm_last_flat(x2, w, b, T))
    p1 = cuda_ms(lambda: K1.lstm_last_flat_plain(x2, w, b, T))
    t3 = cuda_ms(lambda: K1.lstm_window_bwd(x2, w, b, g, T, True))
    p3 = cuda_ms(lambda: K1.lstm_window_bwd_plain(x2, w, b, g, T, True))
    wbytes = 4 * (w.numel() + b.numel())
    rows["K1"]["ppo_shape"] = dict(
        rows=B, H=H, max_abs_err=err1, ms=t1, plain_ms=p1, library_ms=lib1,
        **bound(2.0 * B * T * (D + H) * G4,
                4 * (B * T * Dp + B * H) + wbytes, BF16_PEAK))
    rows["K3"]["ppo_shape"] = dict(
        rows=B, H=H, need_dx=True, max_abs_err=err3, max_rel_err=rel3,
        ms=t3, plain_ms=p3, library_ms=lib3,
        splits=K1._reduce_plan(B, T, Dp, H).splits,
        **k3_pass_ms(torch, K1, x2, w, b, g, T, True),
        **bound(2.0 * B * G4 * (2 * T * (D + H) + T * H + T * D),
                4 * (2 * B * T * Dp + B * H) + wbytes
                + 4 * ((D + H) * G4 + G4), BF16_PEAK))
    for k in ("K1", "K3"):
        r = rows[k]["ppo_shape"]
        log(f"{k} at the PPO update shape ({B} rows, H={H}): kernel "
            f"{r['ms']:.4f} ms  plain {r['plain_ms']:.4f} ms  cuDNN "
            f"{r['library_ms']:.4f} ms  bound {r['bound_ms']:.5f} ms "
            f"({r['bound_by']})" + (
                f"; device ms per call: row pass {r['rows_ms']:.4f} (its "
                f"bound {r['rows_bound_ms']:.5f}), reduction "
                f"{r['reduce_ms']:.4f} (its bound "
                f"{r['reduce_bound_ms']:.5f})" if k == "K3" else ""))


def clone_learner(torch, drqn, qnets, learner, acfg, device):
    """An independent learner with the same online and target weights and
    a fresh Adam state, on ``device``."""
    def tree(net):
        return {g: {k: v.detach().to(device).clone() for k, v in l.items()}
                for g, l in net.tree().items()}
    out = drqn.init_learner(qnets.DRQN(tree(learner.params), acfg), acfg)
    out.target_params.load_state_dict(
        {f"{g}.{k}": v for g, l in tree(learner.target_params).items()
         for k, v in l.items()})
    return out


def profile_train_events(torch, label, fns, carry, t, draws, reps):
    """torch.profiler over ``reps`` train events: device time by kernel and
    the device's busy share of the wall time."""
    def events():
        for _ in range(reps):
            fns.train_call(carry.learner, carry.replay, t, draws)

    log_profile(f"profile {label} train event", "event",
                *device_profile(torch, events, reps), 10)


def lanes_inputs(torch, np, dev, B, N, nbins, R, seed):
    """signed [B, N*N] float32 with a quarter of the values on the exact
    np.linspace edges and some at +-R or out of range; valid [B, N*N]."""
    rng = np.random.RandomState(seed)
    v = rng.uniform(-1.3 * R, 1.3 * R, (B, N * N))
    edges = np.linspace(-R, R, nbins + 1, dtype=np.float32)
    pick = rng.rand(B, N * N)
    v = np.where(pick < 0.25, edges[rng.randint(0, nbins + 1, (B, N * N))], v)
    v = np.where((pick >= 0.25) & (pick < 0.3),
                 np.where(rng.rand(B, N * N) < 0.5, -R, R), v)
    return (torch.from_numpy(v.astype(np.float32)).to(dev),
            torch.from_numpy(rng.rand(B, N * N) < 0.7).to(dev))


def k7_phase(torch, np, K7, dev, cuda_ms, failures):
    """K7 against its plain version, bit for bit, at the PPO shape (16
    envs x 6), the toy serving shape (256 x 4), a batch that is not a
    multiple of the TPU pack width (5 x 6) and N*N = 121 (3 x 11); times
    at the PPO shape.  Returns the kernel row."""
    nbins, R = 20, 500.0
    err = 0.0
    for k, (label, B, N) in enumerate((("PPO", 16, 6), ("toy serving", 256, 4),
                                       ("odd batch", 5, 6),
                                       ("N*N=121", 3, 11))):
        s, v = lanes_inputs(torch, np, dev, B, N, nbins, R, 40 + k)
        gh, gc = K7.lanes_histogram(s, v, N, nbins, -R, R)
        ph, pc = K7.lanes_histogram_plain(s, v, N, nbins, -R, R)
        torch.cuda.synchronize()
        same = torch.equal(gh, ph) and torch.equal(gc, pc)
        gap = max(float((gh - ph).abs().max()), float((gc - pc).abs().max()))
        err = max(err, gap)
        log(f"K7 {label}: B={B} N={N} bins={nbins}: max|diff|={gap:.3e} "
            f"{'bit-exact' if same else 'FAIL'}; counted "
            f"{int(gh.sum())} of {int(v.sum())} valid entries")
        if not same:
            failures.append(f"K7 {label}")
    B, N = 16, 6
    s, v = lanes_inputs(torch, np, dev, B, N, nbins, R, 40)
    call = lambda: K7.lanes_histogram(s, v, N, nbins, -R, R)
    host = host_us(torch, call)
    ms = cuda_ms(call)
    plain_ms = cuda_ms(lambda: K7.lanes_histogram_plain(s, v, N, nbins, -R,
                                                        R))
    call()
    device_ms = kernel_device_ms(torch, call, ["lanes_hist"], 20, failures,
                                 "K7 PPO shape")["lanes_hist"]
    # bytes: signed (4) and valid (1) per entry in, hist and cnt out;
    # operations: two compares, an and and an add per (entry, bin)
    row = dict(name="K7 lanes_hist (envs-in-lanes count histogram)",
               route="cuda", source="diral_tpu_torch/csrc/lanes_hist.cu",
               replaces="diral_tpu/ops/pallas_kernels.py:121",
               max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
               device_ms=device_ms, host_us=host,
               **bound(4.0 * B * N * N * nbins,
                       5 * B * N * N + 4 * B * N * (nbins + 1), F32_PEAK))
    log(f"K7 PPO shape: kernel {ms:.4f} ms (device {ms_text(device_ms)}, "
        f"wrapper host {host:.2f} us)  plain {plain_ms:.4f} ms  bound "
        f"{row['bound_ms']:.6f} ms ({row['bound_by']})")
    return row


def lanes_reference_phase(torch, np, E, K7, cfg, dev, failures):
    """An N = 6 env batch under hist_impl="lanes", stepped on the card (K7)
    and on the CPU (its plain version) with the same actions: tables,
    rewards and state vectors bit-equal."""
    import dataclasses

    env = dataclasses.replace(cfg.env, enable_design_topology=False)
    gen = torch.Generator(device="cpu").manual_seed(8)
    s_cpu = E.reset(env, 16, gen, torch.float32, "cpu")
    s_gpu = E.EnvState(**{k: v.to(dev) for k, v in vars(s_cpu).items()})
    rng = np.random.RandomState(9)
    before, ok = K7.lanes_histogram.launches, True
    with torch.inference_mode():
        for step in range(25):
            acts = torch.from_numpy(rng.randint(0, env.num_channels, (16, 6)))
            s_cpu, o_cpu, r_cpu = E.step_channel(env, s_cpu, acts, step)
            s_gpu, o_gpu, r_gpu = E.step_channel(env, s_gpu, acts.to(dev),
                                                 step)
            v_cpu = E.obtain_state(env, s_cpu, o_cpu, acts, r_cpu)
            v_gpu = E.obtain_state(env, s_gpu, o_gpu, acts.to(dev), r_gpu)
            pairs = [(r_cpu, r_gpu), (v_cpu, v_gpu)] + [
                (getattr(s_cpu, f), getattr(s_gpu, f))
                for f in ("table_x", "table_seq", "table_age", "pos_x")]
            ok &= all(torch.equal(a, b.cpu()) for a, b in pairs)
    torch.cuda.synchronize()
    n = K7.lanes_histogram.launches - before
    ok &= n == 25 and float(v_cpu[..., 5:].abs().sum()) > 0
    log(f"reference lanes (N=6, 16 envs, 25 steps, K7 on the card vs CPU "
        f"plain): {'bit-exact' if ok else 'FAIL'}, K7 launches {n}")
    if not ok:
        failures.append("lanes reference phase")


def finite(np, *arrays):
    return all(np.isfinite(np.asarray(a, dtype=np.float64)).all()
               for a in arrays)


def run_cli(here, argv, timeout=600):
    out = subprocess.run([sys.executable, "-m", "diral_tpu_torch", *argv],
                         cwd=here, capture_output=True, text=True,
                         timeout=timeout, env=dict(os.environ, PYTHONPATH=here))
    try:
        res = json.loads(out.stdout.strip().splitlines()[-1])
    except (IndexError, ValueError):
        res = None
    return out, res


def ppo_phase(torch, np, here, cfg, dev, zero_counts, read_counts, evaluate,
              failures, episodes=20):
    """Phase 9: the PPO slice at full width under hist_impl="lanes".
    Returns the main path's label."""
    from diral_tpu_torch.train import ppo_loop

    L, B, N = cfg.episode_interval, cfg.engine.num_envs, cfg.env.num_users
    epochs = cfg.agent.update_step
    # per episode: K7 in every obtain_state (+1 in init_state); K1 for the
    # actor every slot, the values (one call) and the bootstrap, and 3
    # forwards per epoch; K3 for the two backwards per epoch
    need = {"K7": episodes * L + 1, "K1": episodes * (L + 2 + 3 * epochs),
            "K3": episodes * 2 * epochs}
    path = f"ppo_congested x {B} envs ({episodes} episodes)"
    zero_counts()
    t0 = time.perf_counter()
    learner, logs = ppo_loop.run_ppo(cfg, seed=0, num_episodes=episodes,
                                     device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts(path)
    ok = (finite(np, *logs.values())
          and all(counts[k] >= n for k, n in need.items()))

    fns = ppo_loop.make_ppo_functions(cfg, device=dev)
    draws = ppo_loop.PPODraws(torch.Generator(device=dev).manual_seed(3))
    env_state, history = fns.init_state(draws)
    lrn = fns.init_learner(draws)
    _, history, traj = fns.rollout(env_state, history, lrn, 0, draws)
    times = []
    for _ in range(6):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fns.learn(lrn, traj, history)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
    update_ms = statistics.median(times[1:])
    log(f"PPO {path}: {episodes / wall:.3f} episodes/s, "
        f"{episodes * L / wall:.1f} slots/s ({wall:.2f} s); PPO update "
        f"({L * B * N} rows x {epochs} epochs) {update_ms:.3f} ms (median "
        f"of 5); last loss {float(logs['loss'][-1]):.6g}, mean sum reward "
        f"{float(logs['mean_sum_reward'].mean()):.4f}; launches {counts} "
        f"(need {need}) {'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("PPO slice")
    log_profile("profile PPO update", "update", *device_profile(
        torch, lambda: [fns.learn(lrn, traj, history) for _ in range(2)], 2),
        10)
    wall_ms, prow, busy = device_profile(
        torch, lambda: fns.rollout(env_state, history, lrn, 1, draws), L)
    log_profile(f"profile PPO rollout ({L} slots)", "slot", wall_ms, prow,
                busy, 8)
    ours = {k: sum(ms for key, ms, _ in prow if k in key)
            for k in ("lanes_hist", "lstm_window")}
    log("  kernels of the port: " + ", ".join(
        f"{k} {v * 1e3:.2f} us/slot ({100 * v / max(busy, 1e-9):.1f}%)"
        for k, v in ours.items()))

    zero_counts()
    t0 = time.perf_counter()
    res = evaluate.compare_ppo_vs_sps(cfg, learner.params, 1, steps=STEPS,
                                      device=dev)
    torch.cuda.synchronize()
    t_cmp = time.perf_counter() - t0
    counts = read_counts(f"compare-ppo-sps ({STEPS} x 2 slots)")
    vals = [v for m in (res["ppo"], res["sps"]) for v in m.values()]
    ok = (finite(np, vals) and 0.0 <= res["ppo"]["mean_prr"] <= 1.0
          and counts["K1"] >= STEPS and counts["K7"] >= STEPS)
    log(f"compare-ppo-sps ppo_congested: {STEPS} steps x 2 policies in "
        f"{t_cmp:.2f} s; launches {counts} {'ok' if ok else 'FAIL'}; "
        f"{json.dumps(res)}")
    if not ok:
        failures.append("compare-ppo-sps")

    cli, out = run_cli(here, ["train-ppo", os.path.join(
        here, "configs", "ppo_congested.yaml"), "--episodes", "4"])
    ok = cli.returncode == 0 and out is not None and out.get("episodes") == 4
    log(f"CLI train-ppo --episodes 4: exit {cli.returncode}, {out} "
        f"{'ok' if ok else 'FAIL: ' + cli.stderr[-2000:]}")
    if not ok:
        failures.append("CLI train-ppo")
    return path


def ps_phase(torch, np, here, cfg, dev, zero_counts, read_counts, failures,
             episodes=8):
    """Phase 10: PS-DQN and PS-DRQN on congested_6v_5r under
    hist_impl="lanes"."""
    from diral_tpu_torch.train import ps_loop

    B, L = cfg.engine.num_envs, cfg.episode_interval
    for algo in ps_loop.ALGOS:
        path = f"{algo} congested_6v_5r x {B} envs ({episodes} episodes)"
        zero_counts()
        t0 = time.perf_counter()
        _, logs = ps_loop.run_ps(cfg, algo, seed=0, num_episodes=episodes,
                                 device=dev)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts(path)
        nb = ps_loop.n_batches(cfg, algo)
        ok = (finite(np, *logs.values()) and nb > 0
              and bool((logs["loss"] > 0).all())
              and counts["K7"] >= episodes * L + 1)
        log(f"{path}: {episodes / wall:.3f} episodes/s ({wall:.2f} s), "
            f"{nb} batches/episode; losses "
            f"{[round(float(x), 6) for x in logs['loss']]}; eps "
            f"{float(logs['eps'][0]):.6g} -> {float(logs['eps'][-1]):.6g}; "
            f"K7 launches {counts['K7']} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"PS slice {algo}")
    cli, out = run_cli(here, ["train-ps", os.path.join(
        here, "configs", "congested_6v_5r.yaml"), "--algo", "ps-drqn",
        "--episodes", "2", "--num-envs", str(B)])
    ok = (cli.returncode == 0 and out is not None
          and out.get("algo") == "ps-drqn" and out.get("episodes") == 2)
    log(f"CLI train-ps --algo ps-drqn --episodes 2: exit {cli.returncode}, "
        f"{out} {'ok' if ok else 'FAIL: ' + cli.stderr[-2000:]}")
    if not ok:
        failures.append("CLI train-ps")


def k5_inputs(torch, np, dev, seed, NE=16, N=100, C=50, cluster=False,
              seq_hi=500_000, odd_actions=False):
    """K5's arguments for NE envs of N users and C channels from a numpy
    seed: positions over 2000 m (``cluster``: all within 200 m, long merge
    chains), y in {0, 1}, random tables; ``odd_actions``: a quarter of the
    actions are -1 or C, which transmit on no channel."""
    rng = np.random.RandomState(seed)
    if cluster:
        px = np.tile(np.linspace(0.0, 200.0, N), (NE, 1))
    else:
        px = rng.randint(0, 2000, (NE, N)) + rng.uniform(0, 30, (NE, N))
    py = rng.randint(0, 2, (NE, N))
    acts = rng.randint(0, C, (NE, N))
    tables = [rng.uniform(0, 2000, (NE, N, N)), rng.uniform(0, 2, (NE, N, N)),
              rng.randint(0, seq_hi, (NE, N, N)),
              rng.randint(0, 40, (NE, N, N)), rng.randint(-1, 10, (NE, N, N))]
    if odd_actions:
        odd = np.random.RandomState(seed + 1000)
        acts = np.where(odd.rand(NE, N) < 0.25,
                        odd.choice([-1, C], (NE, N)), acts)
    f = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(dev)
    i = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(dev)
    return [f(px), f(py), i(acts), f(tables[0]), f(tables[1]), i(tables[2]),
            i(tables[3]), i(tables[4])]


def k6_inputs(torch, np, dev, seed, NE=16, N=100, NB=50, RNG=500.0):
    """K6's tables and positions for NE envs of N vehicles from a numpy
    seed: stored positions within 700 m of the live ones, a quarter of
    them exactly on a floor-rule bin edge of NB bins over +-RNG, y in
    {0, 1}, ages 0-29."""
    rng = np.random.RandomState(seed)
    px = rng.randint(0, 2000, (NE, N)).astype(np.float32)
    offs = rng.uniform(-700, 700, (NE, N, N))
    edge = rng.randint(0, NB + 1, (NE, N, N)) * (2 * RNG / NB) - RNG
    offs = np.where(rng.rand(NE, N, N) < 0.25, edge, offs)
    t = lambda a, dt=np.float32: torch.from_numpy(
        np.ascontiguousarray(a, dt)).to(dev)
    return [t(px[:, :, None] + offs), t(rng.randint(0, 2, (NE, N, N))),
            t(px), t(rng.randint(0, 2, (NE, N))),
            t(rng.randint(0, 30, (NE, N, N)), np.int32)]


def host_us(torch, fn, reps=1000, warmup=100, rounds=1):
    """Host microseconds per call of ``fn``: the median over ``rounds`` of
    the mean over ``reps`` calls (time.perf_counter_ns), after ``warmup``
    calls and a synchronize."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    means = []
    for _ in range(rounds):
        t0 = time.perf_counter_ns()
        for _ in range(reps):
            fn()
        means.append((time.perf_counter_ns() - t0) / reps / 1e3)
        torch.cuda.synchronize()
    return statistics.median(means)


def k6_phase(torch, np, K6, E, load_config, here, dev, cuda_ms, failures):
    """K6 against its plain version on the card, bit for bit: 16 x 100 x
    50 (the timing input), N = 37 (one-entry loads), N = 255 with 128
    bins, N = 1, B = 1 with 20 bins, and the tables of a real 100v/50r
    env after 8 slots; each case prints its plan.  Times at 16 x 100 x
    50: CUDA events, the device time (torch.profiler), the wrapper's host
    time, and the launch floor (``launch_floor``: the empty kernel through
    the same launch path).  Returns the kernel row."""
    NB, RNG = 50, 500.0
    err = 0.0

    def check(label, args, nb, rng):
        nonlocal err
        b, n = args[2].shape
        p = K6._k6_plan(b, n, nb)
        got = K6.piggy_histogram(*args, rng, nb)
        want = K6.piggy_histogram_plain(*args, rng, nb)
        torch.cuda.synchronize()
        same = torch.equal(got, want)
        gap = float((got - want).abs().max())
        err = max(err, gap)
        log(f"K6 {label} (B={b} N={n} bins={nb}): max|diff|={gap:.3e} "
            f"{'bit-exact' if same else 'FAIL'}; plan {p.grid[0]} blocks x "
            f"{p.warps} warps, {p.rows_per_warp} row(s) a warp, loads of "
            f"{p.vec}, {p.smem} B; {int((got > 0).sum())} bins hit")
        if not same:
            failures.append(f"K6 {label}")

    k6_args = k6_inputs(torch, np, dev, 5)
    check("16 x 100", k6_args, NB, RNG)
    check("N=37", k6_inputs(torch, np, dev, 6, N=37), NB, RNG)
    check("N=255, 128 bins", k6_inputs(torch, np, dev, 7, N=255, NB=128),
          128, RNG)
    check("N=1", k6_inputs(torch, np, dev, 8, N=1), NB, RNG)
    check("B=1, 20 bins", k6_inputs(torch, np, dev, 9, NE=1, NB=20), 20, RNG)
    scale = load_config(os.path.join(here, "configs", "scale_100v_50r.yaml"))
    gen = torch.Generator(device=dev).manual_seed(24)
    st = E.reset(scale.env, 16, gen, torch.float32, dev)
    for t in range(8):
        acts = E.sample_actions(scale.env, gen, 16, dev)
        st, _, _ = E.step_channel(scale.env, st, acts, t)
    check("100v/50r env after 8 slots", [getattr(st, f).contiguous() for f in (
        "table_x", "table_y", "pos_x", "pos_y", "table_age")],
        scale.env.state.num_bins, float(scale.env.bin_range))

    NE, N = 16, 100
    call = lambda: K6.piggy_histogram(*k6_args, RNG, NB)
    floor = lambda: K6.launch_floor(*k6_args, RNG, NB)
    host = host_us(torch, call)
    floor_host = host_us(torch, floor)
    k6_ms = cuda_ms(call)
    floor_ms = cuda_ms(floor)
    plain_ms = cuda_ms(lambda: K6.piggy_histogram_plain(*k6_args, RNG, NB))
    call()
    device_ms = kernel_device_ms(torch, call, ["piggy_hist"], 20, failures,
                                 "K6 16 x 100")["piggy_hist"]
    row = dict(name="K6 piggy_hist (type-2 positional distribution)",
               route="cuda", source="diral_tpu_torch/csrc/piggy_hist.cu",
               replaces="diral_tpu/ops/pallas_kernels.py:36",
               max_abs_err=err, ms=k6_ms, plain_ms=plain_ms, library_ms=None,
               device_ms=device_ms, host_us=host, floor_ms=floor_ms,
               floor_host_us=floor_host,
               **bound(12.0 * NE * N * N,
                       4 * (3 * NE * N * N + 2 * NE * N + NE * N * NB),
                       F32_PEAK))
    log(f"K6: kernel {k6_ms:.4f} ms (device {ms_text(device_ms)}, wrapper "
        f"host {host:.2f} us)  launch floor {floor_ms:.4f} ms (host "
        f"{floor_host:.2f} us)  plain {plain_ms:.4f} ms  bound "
        f"{row['bound_ms']:.5f} ms ({row['bound_by']})")
    return row


def k5_phase(torch, np, K5, E, load_config, here, dev, cuda_ms, failures):
    """K5 against its plain version on the card, bit for bit: the seven
    16 x 100 x 50 cases (designs 2/3/4 x merge on/off, a cluster), N = 37
    / C = 8, N at the plan's limit (255), actions -1 and C, and the state
    of a real 100v/50r env after 8 slots.  Each case prints its plan
    (grids, threads, shared bytes, width); phase 2 prints the accept and
    merge passes' registers and spills (nvcc -Xptxas -v).  Times
    at the 16 x 100 x 50 input (seed 99): CUDA events for the wrapper,
    torch.profiler device time of both passes and of each, the bound."""
    from diral_tpu_torch.ops.distance import pairwise_distances

    R, C = 250.0, 50

    def check(label, args, c, design, merge, t=7):
        b, n = args[0].shape
        p = K5._k5_plan(b, n, c)
        got = K5.channel_phase(*args, t, c, R, design, merge)
        want = K5.channel_phase_plain(*args, t, c, R, design, merge)
        torch.cuda.synchronize()
        same = all(torch.equal(g, h) for g, h in zip(got, want))
        err = max(float((g.double() - h.double()).abs().max())
                  for g, h in zip(got, want))
        log(f"K5 {label} (B={b} N={n} C={c} design={design} merge={merge}): "
            f"max|diff|={err:.3e} {'bit-exact' if same else 'FAIL'}; plan "
            f"accept {p.accept_grid} x {p.accept_threads} threads, "
            f"{p.accept_smem} B; merge {p.merge_grid} x {p.merge_threads} "
            f"threads, {p.merge_smem} B, width {p.width}")
        if not same:
            failures.append(f"K5 {label} design={design} merge={merge}")
        return err

    err = 0.0
    cases = [(d, m, False) for d in (2, 3, 4) for m in (True, False)]
    cases.append((2, True, True))
    for k, (design, merge, cluster) in enumerate(cases):
        err = max(err, check("cluster" if cluster else "random",
                             k5_inputs(torch, np, dev, 10 + k, cluster=cluster),
                             C, design, merge))
    check("N=37", k5_inputs(torch, np, dev, 20, N=37, C=8), 8, 3, True)
    check("N at the plan's limit", k5_inputs(
        torch, np, dev, 21, N=K5.MAX_USERS, C=8), 8, 2, True)
    check("N at the plan's limit, cluster", k5_inputs(
        torch, np, dev, 22, N=K5.MAX_USERS, C=50, cluster=True), 50, 4, True)
    check("actions -1 and C", k5_inputs(torch, np, dev, 23, odd_actions=True),
          C, 2, True)
    scale = load_config(os.path.join(here, "configs", "scale_100v_50r.yaml"))
    gen = torch.Generator(device=dev).manual_seed(24)
    st = E.reset(scale.env, 16, gen, torch.float32, dev)
    for t in range(8):
        acts = E.sample_actions(scale.env, gen, 16, dev)
        st, _, _ = E.step_channel(scale.env, st, acts, t)
    acts = E.sample_actions(scale.env, gen, 16, dev).to(torch.int32)
    state = [getattr(st, f).contiguous() for f in (
        "pos_x", "pos_y", "table_x", "table_y", "table_seq", "table_age",
        "last_arrival")]
    check("100v/50r env after 8 slots", state[:2] + [acts] + state[2:], C,
          scale.env.reward_design, True, t=8)

    NE, N = 16, 100
    args = k5_inputs(torch, np, dev, 99)
    call = lambda: K5.channel_phase(*args, 7, C, R, 2, True)
    k5_ms = cuda_ms(call)
    k5_plain_ms = cuda_ms(lambda: K5.channel_phase_plain(*args, 7, C, R, 2,
                                                         True))
    call()
    dev_ms = kernel_device_ms(torch, call, ["channel_phase_accept",
                                            "channel_phase_merge"], 20,
                              failures, "K5 16 x 100 x 50")
    accept_ms = dev_ms["channel_phase_accept"]
    merge_ms = dev_ms["channel_phase_merge"]
    both_ms = (None if None in (accept_ms, merge_ms)
               else accept_ms + merge_ms)
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
    row = dict(name="K5 channel_phase (step_channel walk)", route="cuda",
               source="diral_tpu_torch/csrc/channel_phase.cu",
               replaces="diral_tpu/ops/pallas_step.py:60",
               max_abs_err=err, ms=k5_ms, plain_ms=k5_plain_ms,
               library_ms=None, device_ms=both_ms,
               accept_ms=accept_ms, merge_ms=merge_ms,
               **bound(ops, nbytes, F32_PEAK))
    log(f"K5: kernel {k5_ms:.4f} ms (device {ms_text(both_ms)}: "
        f"accept {ms_text(accept_ms)}, merge {ms_text(merge_ms)})  plain "
        f"{k5_plain_ms:.4f} ms  bound {row['bound_ms']:.5f} ms "
        f"({row['bound_by']})")
    return row


def carry_diff(torch, ckpt, a, b):
    """Paths where two training carries differ (bit for bit)."""
    def walk(x, y, path):
        if isinstance(x, dict):
            if x.keys() != y.keys():
                return [path]
            return [p for k in x for p in walk(x[k], y[k], f"{path}.{k}")]
        if isinstance(x, (list, tuple)):
            return [p for u, v in zip(x, y) for p in walk(u, v, path)]
        if isinstance(x, torch.Tensor):
            same = x.dtype == y.dtype and torch.equal(x, y.to(x.device))
        else:
            same = x == y
        return [] if same else [path]
    return walk(ckpt.carry_state(a), ckpt.carry_state(b), "carry")


def cli_json(cli, argv):
    """One verb of the CLI in this process: (its stdout, its last line as
    JSON or None)."""
    import contextlib
    import io

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli.main(argv)
    out = buf.getvalue()
    try:
        return out, json.loads(out.strip().splitlines()[-1])
    except (IndexError, ValueError):
        return out, None


def prr_train_phase(torch, np, here, dev, load_config, runner, ckpt,
                    evaluate, zero_counts, read_counts, failures, slots=550):
    """(a) The PRR configs through ``train_experiment`` at their published
    widths: congested_6v_5r (design topology, channel step) and
    dynamic_20v_15r (channel step, velocity kicks), ``slots`` slots each
    (train events at 524 and 549), launch counters around each run.  Then
    dynamic_20v_15r again with K5 and K6 forced on
    (configs/torch_dynamic_20v_15r_kernels.yaml; N = 20 is below the auto
    gate): K5 and K6 launched at least once a slot, and sum rewards,
    losses and actions bit-equal to the auto run's.  K6 multiplies the
    counts by the reciprocal of the neighbour count where the env's own
    histogram divides, as JAX's Pallas kernel and its XLA path do; the
    phase counts the (hits, count) pairs at which the two roundings differ
    on the card and on the CPU, and names the carry tensors in which the
    two runs part, with their elements that differ before and after
    rounding to bfloat16 (the precision at which K1-K3 read the history
    windows).  Last the feedforward toy (toy_4ue_3r_mlp), which launches
    none of K1-K4, and its greedy eval on the [T, D] windows: the argmax
    runs over T * C ids, and the ids >= C (no transmission) are counted."""
    import dataclasses
    import tempfile

    def train(name, need, none=()):
        cfg = load_config(os.path.join(here, "configs", f"{name}.yaml"))
        cfg = dataclasses.replace(cfg, time_slots=slots)
        with tempfile.TemporaryDirectory() as wd:
            zero_counts()
            t0 = time.perf_counter()
            carry, out = runner.train_experiment(cfg, wd, device=dev,
                                                 verbose=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts(f"train {name} ({slots} slots)")
        losses = out["loss"][out["loss"] != 0]
        events = losses.size
        need = need(events)
        ok = (events >= 2 and finite(np, out["loss"], out["sum_reward"])
              and all(counts[k] >= n for k, n in need.items())
              and all(counts[k] == 0 for k in none))
        log(f"train {name} x {cfg.engine.num_envs} envs: {slots} slots in "
            f"{wall:.2f} s ({slots / wall:.1f} slots/s incl. warmup and "
            f"pretrain), {events} train events, last loss "
            f"{losses[-1] if events else float('nan'):.6g}, mean sum reward "
            f"{out['sum_reward'].mean():.4f}; launches {counts} (need {need}"
            f"{', none of ' + '/'.join(none) if none else ''})"
            f" {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"train {name}")
        return carry, out

    def lstm(events):
        return {"K1": slots, "K2": 2 * events, "K3": 2 * events}

    def parted(x, y, path="carry", out=None):
        """{path: [elements that differ, of all, differ in bfloat16]}."""
        out = {} if out is None else out
        if isinstance(x, dict):
            for k in x:
                parted(x[k], y[k], f"{path}.{k}", out)
        elif isinstance(x, (list, tuple)):
            for i, (u, v) in enumerate(zip(x, y)):
                parted(u, v, f"{path}[{i}]", out)
        elif isinstance(x, torch.Tensor) and not torch.equal(x, y):
            row = [int((x != y).sum()), x.numel()]
            if x.is_floating_point():
                row.append(int((x.bfloat16() != y.bfloat16()).sum()))
            out[path] = row
        return out

    train("congested_6v_5r", lstm)
    auto_carry, auto = train("dynamic_20v_15r", lstm)
    forced_carry, forced = train(
        "torch_dynamic_20v_15r_kernels",
        lambda events: dict(lstm(events), K5=slots, K6=slots))
    equal = {k: bool(np.array_equal(forced[k], auto[k]))
             for k in ("sum_reward", "loss", "actions")}
    log(f"dynamic_20v_15r with K5 + K6 forced against auto: bit-equal "
        f"{equal} {'ok' if all(equal.values()) else 'FAIL'}")
    if not all(equal.values()):
        failures.append("dynamic_20v_15r K5 + K6 forced vs auto")
    differ = {}
    for where in (dev, torch.device("cpu")):
        hits = torch.arange(20, dtype=torch.float32, device=where)[:, None]
        cnt = torch.arange(1, 20, dtype=torch.float32, device=where)[None]
        differ[where.type] = int((hits / cnt != hits * torch.reciprocal(
            cnt)).sum())
    log(f"hits / count against hits * (1 / count), float32, hits 0-19 x "
        f"count 1-19: pairs that differ {differ}")
    split = parted(ckpt.carry_state(auto_carry),
                   ckpt.carry_state(forced_carry))
    log(f"dynamic_20v_15r K5 + K6 forced against auto, carry tensors that "
        f"differ [elements, of, in bfloat16]: {split or 'none'}")

    carry, _ = train("toy_4ue_3r_mlp", lambda events: {},
                     none=("K1", "K2", "K3", "K4"))
    cfg = load_config(os.path.join(here, "configs", "toy_4ue_3r_mlp.yaml"))
    act, seen = evaluate.drqn_act_fn(cfg, carry.learner.params), []

    def recording(*args):
        actions, actor = act(*args)
        seen.append(actions)
        return actions, actor

    gen = torch.Generator(device=dev).manual_seed(0)
    state, history = evaluate._start(cfg, gen, torch.float32, dev)
    with torch.inference_mode():
        metrics = evaluate._rollout_metrics(cfg, recording,
                                            (state, history, (), gen), 100)
    ids = torch.stack(seen)
    C = cfg.env.num_channels
    ok = (all(math.isfinite(v) for v in metrics.values())
          and 0.0 <= metrics["mean_prr"] <= 1.0)
    log(f"toy_4ue_3r_mlp greedy eval on the [T, D] windows, 100 slots: "
        f"{metrics}; {int((ids >= C).sum())} of {ids.numel()} ids >= C "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("toy_4ue_3r_mlp window eval")


def resume_phase(torch, np, here, dev, load_config, runner, ckpt, cli,
                 zero_counts, read_counts, failures):
    """(b) Exact resume at full width on 100v/50r (save_model, save_freq
    300): B stops at 300, C resumes B to 350, A runs 350 uninterrupted;
    C's carry, generator state and arrays must equal A's bit for bit.
    (c) ``eval --checkpoint DIR --best`` on B's directory.  Returns the
    launch counts of C."""
    import dataclasses
    import shutil
    import tempfile

    base = load_config(os.path.join(here, "configs", "scale_100v_50r.yaml"))
    cfg = dataclasses.replace(base, time_slots=350, save_freq=300,
                              save_model=True)
    root = tempfile.mkdtemp(prefix="diral_resume_")
    name = cfg.experiment_name
    try:
        wb, wa = os.path.join(root, "b"), os.path.join(root, "a")
        ck_b = os.path.join(wb, "save_model", "test", name)
        t0 = time.perf_counter()
        runner.train_experiment(dataclasses.replace(cfg, time_slots=300), wb,
                                device=dev, verbose=False)
        torch.cuda.synchronize()
        t_b = time.perf_counter() - t0
        zero_counts()
        t0 = time.perf_counter()
        cc, oc = runner.train_experiment(cfg, wb, device=dev, verbose=False,
                                         resume=True)
        torch.cuda.synchronize()
        t_c = time.perf_counter() - t0
        counts = read_counts("train --resume 100v/50r x 16 envs (300 -> 350)")
        gen_c = torch.load(os.path.join(ck_b, "ckpt_350.pt"),
                           weights_only=True, mmap=True)["generator"]
        gen_c = dict(gen_c, state=gen_c["state"].clone())
        # (c) eval of B's best snapshot through the CLI, learner only
        t0 = time.perf_counter()
        out, res = cli_json(cli, ["eval", os.path.join(here, "configs",
                                                       "scale_100v_50r.yaml"),
                                  "--checkpoint", ck_b, "--best",
                                  "--steps", "50"])
        t_eval = time.perf_counter() - t0
        best = json.load(open(ck_b + "_best/best_metric.json"))
        ok_eval = (res is not None and 0.0 <= res["mean_prr"] <= 1.0
                   and f"loaded checkpoint at slot {best['step']}" in out)
        log(f"eval --checkpoint --best (100v/50r, 50 slots): "
            f"{out.strip().splitlines()[0] if out.strip() else ''}; "
            f"best_metric {best}; {json.dumps(res)}; {t_eval:.2f} s "
            f"{'ok' if ok_eval else 'FAIL'}")
        if not ok_eval:
            failures.append("eval --checkpoint --best")
        shutil.rmtree(wb)

        t0 = time.perf_counter()
        ca, oa = runner.train_experiment(cfg, wa, device=dev, verbose=False)
        torch.cuda.synchronize()
        t_a = time.perf_counter() - t0
        ck_a = os.path.join(wa, "save_model", "test", name)
        path = os.path.join(ck_a, "ckpt_350.pt")
        gen_a = torch.load(path, weights_only=True, mmap=True)["generator"]
        nbytes = os.path.getsize(path)
        diff = carry_diff(torch, ckpt, ca, cc)
        same_gen = torch.equal(gen_a["state"], gen_c["state"])
        same_arrays = all(np.array_equal(oa[k], oc[k])
                          for k in ("sum_reward", "actions"))
        events_a = int((oa["loss"] != 0).sum())
        same_loss = np.array_equal(oa["loss"][300:], oc["loss"][300:])

        # save and restore of the full carry, timed alone
        gen = torch.Generator(device=dev).manual_seed(1)
        scratch = os.path.join(root, "timing")
        save_s, restore_s = [], []
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ckpt.save(scratch, 350, ca, gen, max_to_keep=1)
            save_s.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            ckpt.restore(scratch, ca, gen)
            torch.cuda.synchronize()
            restore_s.append(time.perf_counter() - t0)
        ok = (not diff and same_gen and same_arrays and same_loss
              and events_a == 4 and np.isnan(oc["loss"][:300]).all()
              and all(counts[k] >= n for k, n in
                      {"K1": 50, "K2": 4, "K3": 4, "K5": 50,
                       "K6": 50}.items()))
        log(f"resume 100v/50r x {cfg.engine.num_envs} envs: A 350 slots "
            f"{t_a:.2f} s "
            f"({350 / t_a:.1f} slots/s incl. init), B 300 slots {t_b:.2f} s, "
            f"C 300 -> 350 {t_c:.2f} s ({50 / t_c:.1f} slots/s incl. init and "
            f"restore); train events in A {events_a}; checkpoint "
            f"{nbytes} bytes, save {save_s[-1]:.3f} s / restore "
            f"{restore_s[-1]:.3f} s (second of two; first {save_s[0]:.3f} / "
            f"{restore_s[0]:.3f} s); C vs A: carry "
            f"{'bit-equal' if not diff else 'DIFFERS at ' + ', '.join(diff)}, "
            f"generator {'equal' if same_gen else 'DIFFERS'}, sum_reward / "
            f"actions {'equal' if same_arrays else 'DIFFER'}, losses after "
            f"the cut {'equal' if same_loss else 'DIFFER'}; launches in C "
            f"{counts} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("resume 100v/50r")
        return dict(bytes=nbytes, save_s=save_s[-1], restore_s=restore_s[-1],
                    a_slots_per_s=350 / t_a, c_slots_per_s=50 / t_c)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def sweep_phase(torch, np, here, dev, load_config, runner, cli, failures,
                slots=550):
    """(d) ``train-sweep configs/toy_4ue_3r.yaml --seeds 2`` through the
    CLI (train events at 524 and 549), with row 0's sum_reward held bit for
    bit against a standalone ``train_experiment(seed=0)``."""
    import dataclasses
    import tempfile

    from diral_tpu_torch.train import sweep

    caught = {}
    real = sweep.run_seed_sweep

    def recording(*a, **k):
        caught["out"] = real(*a, **k)
        return caught["out"]

    path = os.path.join(here, "configs", "toy_4ue_3r.yaml")
    sweep.run_seed_sweep = recording
    try:
        t0 = time.perf_counter()
        _, rows = cli_json(cli, ["train-sweep", path, "--seeds", "2",
                                 "--slots", str(slots), "--eval-steps",
                                 "100"])
        t_sweep = time.perf_counter() - t0
    finally:
        sweep.run_seed_sweep = real
    _, logs = caught["out"]
    cfg = dataclasses.replace(load_config(path), time_slots=slots)
    with tempfile.TemporaryDirectory() as wd:
        _, alone = runner.train_experiment(cfg, wd, seed=0, device=dev,
                                           verbose=False)
    same = (np.array_equal(logs["sum_reward"][0], alone["sum_reward"])
            and np.array_equal(logs["loss"][0], alone["loss"]))
    keys = {"seed", "final_mean_sum_reward", "drqn_prr", "sps_prr",
            "prr_improvement"}
    ok = (same and rows is not None and len(rows) == 2
          and all(set(r) == keys for r in rows)
          and (logs["loss"] != 0).sum() == 4 and finite(np, logs["loss"]))
    log(f"train-sweep toy --seeds 2 --slots {slots}: {t_sweep:.2f} s "
        f"(train and eval); rows {json.dumps(rows)}; row 0 vs standalone "
        f"train_experiment(seed=0): {'bit-equal' if same else 'DIFFERS'} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("train-sweep")


def profile_phase(here, cli, failures):
    """(e) The ``profile`` verb on 100v/50r, 16 envs, 100 slots: its
    top_ops must name the csrc kernels of K1, K2, K3, K5 and K6, and its
    Chrome trace (``--trace-dir``, a temporary directory) must hold
    events."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as trace_dir:
        _, res = cli_json(cli, ["profile",
                                os.path.join(here, "configs",
                                             "scale_100v_50r.yaml"),
                                "--num-envs", "16", "--slots", "100",
                                "--top", "500", "--trace-dir", trace_dir])
        path = os.path.join(trace_dir, "trace.json")
        trace_mb = os.path.getsize(path) / 2**20 if os.path.exists(path) else 0
    wall = time.perf_counter() - t0
    names = [o["op"] for o in (res or {}).get("top_ops", [])]
    want = {"K1": "lstm_window_tc_kernel", "K2": "lstm_triple_tc_kernel",
            "K3": "lstm_bwd_rows_tc_kernel", "K5": "channel_phase_",
            "K6": "piggy_hist_kernel"}
    found = {k: any(w in n for n in names) for k, w in want.items()}
    ok = (res is not None and all(found.values())
          and res["slots_per_sec"] > 0 and trace_mb > 0)
    log(f"profile 100v/50r x 16 envs, 100 slots: {wall:.2f} s; slots/s "
        f"{res and res['slots_per_sec']}; csrc kernels named {found}; trace "
        f"{trace_mb:.1f} MiB {'ok' if ok else 'FAIL'}")
    if res:
        total = sum(res["categories"].values()) or 1.0
        for cat, ms in res["categories"].items():
            log(f"  {cat:16s} {ms:10.2f} ms  {100 * ms / total:5.1f}%")
        for o in res["top_ops"][:12]:
            log(f"  {o['ms']:8.2f} ms x{o['n']:<6d} {o['op'][:90]}")
    if not ok:
        failures.append("profile verb")


def campaign_phase(torch, np, here, zero_counts, peek_counts, failures):
    """(f) The full-schedule scripts on the card.  ``seed_campaign`` on
    the toy, 2 seeds x 600 slots (train events at 524-599), ``--save-freq
    100``, a 20-slot eval on 16 envs: uncut, then cut by a checkpoint
    write that raises after seed 1's second one and started again; the
    rows must be bit-equal apart from their timing fields, the finished
    seed must not run again and the open one must resume from slot 200.
    Then ``full_run`` on 100v/50r, 300 slots with a 20-slot eval: finite
    results of JAX's keys, K1, K2, K3, K5 and K6 launched."""
    import contextlib
    import io
    import shutil
    import tempfile

    from diral_tpu_torch.scripts import full_run, seed_campaign
    from diral_tpu_torch.train import checkpoint as ckpt

    def quiet(fn, argv):
        with contextlib.redirect_stdout(io.StringIO()):
            return fn(argv)

    def results(rows):
        return [{k: v for k, v in r.items()
                 if k not in seed_campaign.RUN_FIELDS} for r in rows]

    toy = os.path.join(here, "configs", "toy_4ue_3r.yaml")
    root = tempfile.mkdtemp(prefix="diral_campaign_")
    args = ["--seeds", "2", "--slots", "600", "--save-freq", "100",
            "--eval-steps", "20", "--eval-envs", "16"]
    real_save, real_run = ckpt.save, full_run.run
    try:
        zero_counts()
        t0 = time.perf_counter()
        uncut = quiet(seed_campaign.main, [
            toy, os.path.join(root, "uncut.json"), *args, "--workdir",
            os.path.join(root, "uncut")])
        t_uncut = time.perf_counter() - t0
        counts = peek_counts()
        saves, ran = [], []

        def cutting_save(directory, step, *a, **k):
            path = real_save(directory, step, *a, **k)
            if f"{os.sep}seed1{os.sep}" in str(directory):
                saves.append(step)
                if len(saves) == 2:
                    raise RuntimeError("cut after seed 1's second checkpoint")
            return path

        def spy(*a, **k):
            ran.append(k["seed"])
            return real_run(*a, **k)

        cut_argv = [toy, os.path.join(root, "cut.json"), *args, "--workdir",
                    os.path.join(root, "cut")]
        ckpt.save = cutting_save
        t0 = time.perf_counter()
        try:
            quiet(seed_campaign.main, cut_argv)
            was_cut = False
        except RuntimeError:
            was_cut = True
        finally:
            ckpt.save = real_save
        full_run.run = spy
        try:
            again = quiet(seed_campaign.main, cut_argv)
        finally:
            full_run.run = real_run
        t_cut = time.perf_counter() - t0
        same = results(again["rows"]) == results(uncut["rows"])
        resumed = [r["resumed_from"] for r in again["rows"]]
        ok = (was_cut and same and ran == [1] and resumed == [[], [200]]
              and saves == [100, 200]
              and all(counts[k] >= 8 for k in ("K1", "K2", "K3"))
              and finite(np, [r["prr_improvement"] for r in uncut["rows"]]))
        log(f"seed_campaign toy x 2 seeds x 600 slots (--save-freq 100, "
            f"eval 20 x 16 envs): uncut {t_uncut:.2f} s, cut at seed 1's "
            f"slot 200 and restarted {t_cut:.2f} s; rows "
            f"{'bit-equal' if same else 'DIFFER'} apart from timings, "
            f"seeds run on restart {ran}, resumed_from {resumed}; "
            f"launches in the uncut campaign {counts}; ΔPRR "
            f"{[r['prr_improvement'] for r in uncut['rows']]}, slots/s "
            f"{[r['slots_per_sec'] for r in uncut['rows']]} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("seed_campaign cut and restarted")

        zero_counts()
        t0 = time.perf_counter()
        summ = quiet(full_run.main, [
            os.path.join(here, "configs", "scale_100v_50r.yaml"),
            os.path.join(root, "scale"), "--slots", "300", "--eval-steps",
            "20"])
        t_scale = time.perf_counter() - t0
        counts = peek_counts()
        comp = summ["compare_vs_sps"]
        ok = (set(summ) >= {"config", "time_slots", "train_seconds",
                            "slots_per_sec", "reward_curve_deciles",
                            "compare_vs_sps", "eval_seconds"}
              and len(summ["reward_curve_deciles"]) == 10
              and finite(np, summ["reward_curve_deciles"],
                         comp["prr_improvement"])
              and all(0.0 <= comp[p]["mean_prr"] <= 1.0
                      for p in ("drqn", "sps"))
              and all(counts[k] > 0 for k in ("K1", "K2", "K3", "K5", "K6")))
        log(f"full_run 100v/50r x 16 envs, 300 slots, eval 20 x 16 envs: "
            f"{t_scale:.2f} s (build {summ['build_seconds']} s, init "
            f"{summ['init_seconds']} s, loop {summ['loop_seconds']} s, eval "
            f"{summ['eval_seconds']} s); DRQN PRR "
            f"{comp['drqn']['mean_prr']:.4f}, SPS PRR "
            f"{comp['sps']['mean_prr']:.4f}; launches {counts} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("full_run 100v/50r")
    finally:
        ckpt.save, full_run.run = real_save, real_run
        shutil.rmtree(root, ignore_errors=True)


def episode_campaign_phase(torch, np, here, dev, zero_counts, read_counts,
                           failures):
    """(j) ``ppo_campaign`` and ``ps_campaign`` on the card, each uncut and
    then cut by a checkpoint write that raises after the second one of
    its last run and started again: rows bit-equal apart from their
    timing fields, only the cut run started again, from its checkpoint.
    Then ``qvalues_all_agents`` through K1 against the plain path."""
    import contextlib
    import io
    import shutil
    import tempfile

    from diral_tpu_torch.agents import drqn
    from diral_tpu_torch.config import load_config
    from diral_tpu_torch.models import qnets
    from diral_tpu_torch.ops import lstm_window as K1
    from diral_tpu_torch.scripts import episode_campaign as ec
    from diral_tpu_torch.scripts import ppo_campaign, ps_campaign
    from diral_tpu_torch.train import checkpoint as ckpt

    def results(summary):
        return [{k: v for k, v in r.items() if k not in ec.RUN_FIELDS}
                for r in summary["runs"]]

    root = tempfile.mkdtemp(prefix="diral_episode_campaign_")
    specs = (
        ("ppo_campaign", ppo_campaign, "save_ppo", f"{os.sep}seed1{os.sep}",
         ["--config", os.path.join(here, "configs", "ppo_congested.yaml"),
          "--seeds", "2", "--episodes", "40", "--save-freq", "10",
          "--eval-steps", "20", "--eval-envs", "16", "--reference",
          os.path.join(here, "results", "ppo_seeds.json")],
         [10, 20], ("K1", "K3")),
        ("ps_campaign", ps_campaign, "save_ps",
         f"ps-drqn{os.sep}seed0{os.sep}",
         ["--seeds", "1", "--episodes", "20", "--save-freq", "5",
          "--eval-steps", "20", "--reference",
          os.path.join(here, "results", "ps_campaign.json")],
         [5, 10], ()))
    try:
        for name, mod, save_name, marker, args, cuts, need in specs:
            def run(tag):
                with contextlib.redirect_stdout(io.StringIO()):
                    return mod.main([*args, "--out",
                                     os.path.join(root, f"{name}_{tag}.json"),
                                     "--workdir",
                                     os.path.join(root, f"{name}_{tag}")])
            label = f"{name} (uncut)"
            zero_counts()
            t0 = time.perf_counter()
            uncut = run("uncut")
            t_uncut = time.perf_counter() - t0
            counts = read_counts(label)
            real_save, real_seed = getattr(ckpt, save_name), mod.run_seed
            saves, ran = [], []

            def cutting(d, e, *a, **k):
                path = real_save(d, e, *a, **k)
                if marker in str(d):
                    saves.append(e)
                    if len(saves) == 2:
                        raise RuntimeError("cut after the second checkpoint")
                return path

            def spy(*a, **k):
                ran.append(k["seed"])
                return real_seed(*a, **k)
            t0 = time.perf_counter()
            setattr(ckpt, save_name, cutting)
            try:
                run("cut")
                was_cut = False
            except RuntimeError:
                was_cut = True
            finally:
                setattr(ckpt, save_name, real_save)
            mod.run_seed = spy
            try:
                again = run("cut")
            finally:
                mod.run_seed = real_seed
            t_cut = time.perf_counter() - t0
            same = results(again) == results(uncut)
            resumed = [r["resumed_from"] for r in again["runs"]]
            deltas = [r["compare_vs_sps"]["prr_improvement"]
                      for r in uncut["runs"]]
            ok = (was_cut and same and saves == cuts and len(ran) == 1
                  and resumed[-1] == [cuts[-1]]
                  and all(r == [] for r in resumed[:-1])
                  and all(counts[k] > 0 for k in need)
                  and finite(np, deltas))
            log(f"{name}: uncut {t_uncut:.2f} s, cut at episode {cuts[-1]} "
                f"of its last run and restarted {t_cut:.2f} s; rows "
                f"{'bit-equal' if same else 'DIFFER'} apart from timings, "
                f"runs started again {len(ran)}, resumed_from {resumed}; "
                f"launches in the uncut campaign {counts}; ΔPRR {deltas}, "
                f"slots/s {[r['slots_per_sec'] for r in uncut['runs']]} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"{name} cut and restarted")
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # qvalues_all_agents at 100v/50r: [T, N, D] through K1
    cfg = load_config(os.path.join(here, "configs", "scale_100v_50r.yaml"))
    acfg, env = cfg.agent, cfg.env
    gen = torch.Generator(device=dev).manual_seed(21)
    learner = drqn.init_learner(qnets.drqn_init(
        gen, env.state_space, env.num_channels, acfg, device=dev), acfg)
    history = torch.randn(acfg.step_size, env.num_users, env.state_space,
                          generator=gen, device=dev)
    zero_counts()
    q = drqn.qvalues_all_agents(learner, history, acfg)
    counts = read_counts("qvalues_all_agents 100v/50r (100 agents)")
    real = K1.lstm_last_flat
    K1.lstm_last_flat = K1.lstm_last_flat_plain
    try:
        q_plain = drqn.qvalues_all_agents(learner, history, acfg)
    finally:
        K1.lstm_last_flat = real
    lstm = learner.params.tree()["lstm"]
    x = history.transpose(0, 1)
    with torch.no_grad():
        h = K1.lstm_last(x, lstm["w"], lstm["b"])
        h_plain = K1.lstm_last_flat_plain(K1.flatten_window(x).contiguous(),
                                          lstm["w"], lstm["b"], x.shape[1])
    torch.cuda.synchronize()
    gap = (h - h_plain).abs()
    q_gap = float((q - q_plain).abs().max())
    q_scale = float(q_plain.abs().max())
    ok = (counts["K1"] == 1 and tuple(q.shape) == (env.num_users,
                                                   env.num_channels)
          and bool((gap <= 1e-4 + bf16_ulp(h_plain)).all())
          and float(gap.median()) < 1e-6 and finite(np, q.cpu().numpy())
          and q_gap <= 1e-3 * max(1.0, q_scale))
    log(f"qvalues_all_agents 100v/50r: history {tuple(history.shape)} -> Q "
        f"{tuple(q.shape)}; K1 launches {counts['K1']}; max|dh| vs K1 plain "
        f"{float(gap.max()):.3e} (median {float(gap.median()):.3e}); max|dQ| "
        f"vs the plain path {q_gap:.3e} of max|Q| {q_scale:.3e} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append("qvalues_all_agents through K1")


def ref_sweep_phase(torch, np, here, zero_counts, read_counts, failures,
                    slots=600, save_freq=100, extra=()):
    """(k) ``ref_sweep``, the reference's six-config suite, on the card at
    ``slots`` slots a config (train events from slot 524), ``--save-freq``
    ``save_freq``, a 20-slot eval on 16 envs.  Uncut in this process,
    with the launch counters around it (K1-K3 at D = 13 / 23 / 43, H =
    256; K4-K7 never: N = 4); then cut by a checkpoint write that raises
    after the first config's second checkpoint and started again with
    ``--jobs 2``: rows bit-equal to the uncut suite's apart from their
    timing fields, the first config resumed from its checkpoint, the
    others run from slot 0.  ``extra``: more options for every run
    (``("--device", "cpu")`` rehearses the phase on the CPU)."""
    import contextlib
    import io
    import shutil
    import tempfile

    from diral_tpu_torch.scripts import ref_sweep
    from diral_tpu_torch.train import checkpoint as ckpt

    def quiet(argv):
        with contextlib.redirect_stdout(io.StringIO()):
            return ref_sweep.main(argv)

    def results(artifact):
        return [{k: v for k, v in r.items()
                 if k not in ref_sweep.seed_campaign.RUN_FIELDS}
                for r in artifact["rows"]]

    root = tempfile.mkdtemp(prefix="diral_ref_sweep_")
    args = ["--slots", str(slots), "--save-freq", str(save_freq),
            "--eval-steps", "20", "--eval-envs", "16", *extra]
    first = ref_sweep.SUITE[0][0]
    real_save = ckpt.save
    saves = []

    def cutting_save(directory, step, *a, **k):
        path = real_save(directory, step, *a, **k)
        if f"{os.sep}{first}{os.sep}" in str(directory):
            saves.append(step)
            if len(saves) == 2:
                raise RuntimeError(f"cut after {first}'s second checkpoint")
        return path

    try:
        label = f"ref_sweep (6 configs x {slots} slots)"
        zero_counts()
        t0 = time.perf_counter()
        uncut = quiet([os.path.join(root, "uncut"), *args])
        t_uncut = time.perf_counter() - t0
        counts = read_counts(label)
        cut_argv = [os.path.join(root, "cut"), *args]
        ckpt.save = cutting_save
        t0 = time.perf_counter()
        try:
            quiet(cut_argv)
            was_cut = False
        except RuntimeError:
            was_cut = True
        finally:
            ckpt.save = real_save
        again = quiet([*cut_argv, "--jobs", "2"])
        t_cut = time.perf_counter() - t0
        same = results(again) == results(uncut)
        resumed = [r["resumed_from"] for r in again["rows"]]
        widths = [r["state_space"] for r in uncut["rows"]]
        ok = (was_cut and same and saves == [save_freq, 2 * save_freq]
              and resumed == [[2 * save_freq]] + [[]] * 5
              and widths == [13, 23, 23, 23, 23, 43]
              and all(counts[k] >= 6 for k in ("K1", "K2", "K3"))
              and not any(counts[k] for k in ("K4", "K5", "K6", "K7"))
              and finite(np, [r["prr_improvement"] for r in uncut["rows"]],
                         [r["reward_curve_deciles"] for r in uncut["rows"]]))
        log(f"ref_sweep 6 configs x {slots} slots (--save-freq {save_freq}, "
            f"eval 20 x 16 envs): uncut {t_uncut:.2f} s in this process, "
            f"cut at {first}'s slot {2 * save_freq} and restarted with "
            f"--jobs 2 {t_cut:.2f} s; rows "
            f"{'bit-equal' if same else 'DIFFER'} apart from timings, "
            f"resumed_from {resumed}; state_space {widths}; launches in "
            f"the uncut suite {counts}; ΔPRR "
            f"{[r['prr_improvement'] for r in uncut['rows']]}, slots/s "
            f"{[r['slots_per_sec'] for r in uncut['rows']]} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append("ref_sweep cut and restarted")
    finally:
        ckpt.save = real_save
        shutil.rmtree(root, ignore_errors=True)


def serve_phase(torch, np, here, card, zero_counts, peek_counts, failures,
                compare_rounds=200, rounds=100):
    """(g) Online serving on the card: the port's C++ RealNeS stand-in
    built from the checkout, then the ``serve`` verb (8 users, 6 channels,
    ``--train-every 10 --n-batches 4 --eps 0.5``) in ``compare`` mode for
    ``compare_rounds`` rounds and in ``ps-dqn`` and ``drqn-rssi`` modes
    for ``rounds`` each, over the framed transport, then ``drqn`` over
    framed and over zmq (the simulator loading the libzmq that
    ``transport.libzmq_path`` finds: the system's, else pyzmq's bundled
    copy; none is a failure), their requests/s side by side.  Each run must
    give finite stats and losses, rounds / train_every train calls and a
    learner whose every tensor is on the card; it prints its requests/s
    and the host ms per request spent waiting on the simulator, in
    inference and in training.  A torch.profiler pass over 40 rounds of
    ``drqn`` gives the device's busy share per request.  The serve path
    launches none of K1-K7: their counters must stay at 0."""
    from diral_tpu_torch.interop import gateway_env, serve
    from diral_tpu_torch.interop.transport import libzmq_error, libzmq_path
    from diral_tpu_torch.train import cli

    t0 = time.perf_counter()
    binary = gateway_env.build_simulator()
    log(f"serve: simulator {os.path.relpath(binary, here)} ready in "
        f"{time.perf_counter() - t0:.2f} s (g++ -O2, wire.h codec)")
    spied = []
    real = {"serve_and_learn": serve.serve_and_learn,
            "serve_and_learn_dqn": serve.serve_and_learn_dqn}

    def spy(fn):
        def wrapped(*a, **k):
            learner, stats = fn(*a, **k)
            spied.append((learner, dict(stats)))
            return learner, stats
        return wrapped

    def tensors(learner):
        """The nets and Adam's moments (Adam keeps its step count on the
        host unless asked for a fused or capturable step)."""
        yield from learner.params.parameters()
        yield from learner.target_params.parameters()
        for st in learner.opt.state.values():
            yield from (v for k, v in st.items()
                        if k != "step" and isinstance(v, torch.Tensor))

    def per_request(timing):
        n = max(timing["requests"], 1)
        return (f"{timing['requests'] / timing['seconds']:.1f} requests/s; "
                f"host ms/request: sim {1e3 * timing['wait_s'] / n:.4f}, "
                f"inference {1e3 * timing['infer_s'] / n:.4f}, training "
                f"{1e3 * timing['train_s'] / n:.4f}, total "
                f"{1e3 * timing['seconds'] / n:.4f}")

    zmq_lib, zmq_why = libzmq_path(), libzmq_error()
    try:
        import zmq  # noqa: F401
    except ImportError:
        zmq_why = "pyzmq is not installed"
    runs = [("compare", compare_rounds, "framed"), ("ps-dqn", rounds, "framed"),
            ("drqn-rssi", rounds, "framed"), ("drqn", rounds, "framed")]
    if zmq_why is None:
        log(f"serve --transport zmq: the simulator loads {zmq_lib}")
        runs.append(("drqn", rounds, "zmq"))
    else:
        log(f"serve --transport zmq: FAIL, no libzmq to load ({zmq_why})")
        failures.append("serve --transport zmq: no libzmq")
    rates = {}
    serve.serve_and_learn = spy(real["serve_and_learn"])
    serve.serve_and_learn_dqn = spy(real["serve_and_learn_dqn"])
    try:
        zero_counts()
        for mode, n_rounds, transport in runs:
            spied.clear()
            argv = ["serve", "--mode", mode, "--users", "8", "--channels",
                    "6", "--rounds", str(n_rounds), "--train-every", "10",
                    "--n-batches", "4", "--eps", "0.5", "--transport",
                    transport]
            t0 = time.perf_counter()
            _, res = cli_json(cli, argv)
            wall = time.perf_counter() - t0
            learned = res and (res["drqn"] if mode == "compare" else res)
            bad = []
            if learned is None or len(spied) != 1:
                bad.append("no result")
            else:
                losses = spied[0][1]["losses"]
                if not finite(np, learned["mean_reward"],
                              learned["mean_prr"], learned["mean_prr_tail"],
                              losses):
                    bad.append("non-finite stats or losses")
                if (learned["train_calls"] != n_rounds // 10
                        or len(losses) != n_rounds // 10):
                    bad.append("train calls")
                if not all(t.device.type == "cuda"
                           for t in tensors(spied[0][0])):
                    bad.append("a learner tensor off the card")
                if mode == "compare" and not finite(
                        np, res["prr_improvement"],
                        res["sps"]["mean_prr_tail"]):
                    bad.append("non-finite SPS stats")
            ok = not bad
            parts = [("learner", learned)] if learned else []
            if learned and mode == "compare":
                parts.append(("sps", res["sps"]))
            for who, stats in parts:
                log(f"serve --mode {mode} --transport {transport} "
                    f"({n_rounds} rounds x 8 users, {who}): "
                    + per_request(stats["timing"]))
            if learned and mode == "drqn":
                rates[transport] = learned["timing"]
            log(f"serve --mode {mode} --transport {transport}: {wall:.2f} s, "
                + (f"mean PRR {learned['mean_prr']:.4f}, tail "
                   f"{learned['mean_prr_tail']:.4f}, train calls "
                   f"{learned['train_calls']}, last loss "
                   f"{spied[0][1]['losses'][-1]:.5f}" if learned else
                   "no result")
                + (f"; SPS tail {res['sps']['mean_prr_tail']:.4f}, ΔPRR "
                   f"{res['prr_improvement']:+.4f}"
                   if learned and mode == "compare" else "")
                + (" ok" if ok else f" FAIL ({', '.join(bad)})"))
            if not ok:
                failures.append(f"serve --mode {mode} --transport {transport}")
        if len(rates) == 2:
            per = {t: (v["requests"] / v["seconds"],
                       1e3 * v["seconds"] / max(v["requests"], 1))
                   for t, v in rates.items()}
            log(f"serve --mode drqn, zmq beside framed: "
                f"{per['zmq'][0]:.1f} against {per['framed'][0]:.1f} "
                f"requests/s ({per['zmq'][0] / per['framed'][0]:.3f}x), "
                f"{per['zmq'][1]:.4f} against {per['framed'][1]:.4f} host "
                f"ms a request")
        counts = peek_counts()
        log(f"serve: K1-K7 launches over the serve runs {counts} "
            f"{'ok' if not any(counts.values()) else 'FAIL'}")
        if any(counts.values()):
            failures.append("serve path launched a K kernel")
    finally:
        serve.serve_and_learn = real["serve_and_learn"]
        serve.serve_and_learn_dqn = real["serve_and_learn_dqn"]

    # where a served request's time goes on the device: 40 rounds of
    # PS-DRQN in dist mode (4 train calls), the CLI's default agent
    acfg = serve.tuned_agent()
    env = gateway_env.GatewayEnv(port=0, sim_start=True, sim_users=8,
                                 sim_channels=6, sim_rounds=45, sim_seed=1,
                                 state_design=2, pos_dist=2, reward_design=2)
    try:
        wall_ms, prow, busy = device_profile(
            torch, lambda: serve.serve_and_learn(
                env, acfg, 40, train_every=10, n_batches=4, eps=0.5,
                eps_final=0.02, seed=1), 320)
        env.bridge.restart_env()
        env.sim_process.wait(timeout=10)
        env.sim_process = None
    finally:
        env.close()
    log_profile("profile serve --mode drqn, 40 rounds x 8 users (profiler "
                "on)", "request", wall_ms, prow, busy, 6)
    log(f"serve: {card}")


# the root bench.py's and scripts' JSON keys, in their order
# (tests/test_torch_bench.py holds these lists against the JAX sources)
JAX_BENCH_KEYS = [
    "metric", "value", "unit", "vs_baseline", "device_init_s", "compile_s",
    "value_min", "spread", "dispatch_latency_ms", "scale_env_steps_per_sec",
    "train_slots_per_sec", "train_slots_per_sec_bf16"]
JAX_EVENT_KEYS = [
    "dtype", "shape", "event_ms", "sampler_ms", "target_ms",
    "grad_presampled_ms", "grad_fused_ms", "adam_ms", "kernel_fwd_ms",
    "kernel_dual_ms", "kernel_triple_ms", "kernel_fwdbwd_ms",
    "kernel_fwd_tflops", "kernel_dual_tflops", "kernel_triple_tflops",
    "kernel_fwdbwd_tflops", "pieces_sum_ms"]
JAX_CEILING_KEYS = [
    "rows", "T", "H", "D", "Dp", "fwd_ms", "fwd_tflops", "dual_ms",
    "dual_tflops", "triple_ms", "triple_tflops", "fwdbwd_ms",
    "fwdbwd_tflops", "fwd_flops_g"]


def bench_phase(torch, card, zero_counts, peek_counts, failures):
    """(h) The measurement entry points on the card at cut lengths (the
    full ``bench`` verb runs in a call of its own): 32 headline steps, 8
    scale steps, chunks of 50 training slots, R = 4 event reps.  Each
    section runs with the K1-K7 launch counters set to 0 just before and
    read just after: ``need`` names the kernels it must launch, ``none``
    a section that must launch none."""
    from diral_tpu_torch import bench
    from diral_tpu_torch.scripts import bench_event, kernel_ceiling

    dev = torch.device("cuda")
    every = ("K1", "K2", "K3", "K4", "K5", "K6", "K7")

    def section(label, fn, need=(), none=False):
        zero_counts()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        got = peek_counts()
        launched = {k: n for k, n in got.items() if n}
        log(f"bench {label}: {time.perf_counter() - t0:.1f} s, launches "
            f"{launched or 'none'}")
        missing = [k for k in need if not got[k]]
        if missing:
            failures.append(f"bench {label}: {', '.join(missing)} never "
                            f"launched")
        if none and launched:
            failures.append(f"bench {label}: launched {launched}, "
                            f"expected none")
        return out

    head = section(f"headline (toy, {bench.NUM_ENVS} envs x 32 steps)",
                   lambda: bench.headline(bench.NUM_ENVS, 32, dev),
                   none=True)
    if not section("kernel parity", lambda: bench.bench_kernel_parity(
            device=dev), need=every):
        failures.append("bench kernel parity")
    scale = section("scale (100v/50r, 2048 envs x 8 steps)",
                    lambda: bench.bench_scale(2048, 8, dev),
                    need=("K5", "K6"))
    train = section("train loop (toy, 256 envs, 4 x 50 slots, float32 + "
                    "split)", lambda: bench.bench_train_loop(256, 50,
                                                             device=dev),
                    need=("K1", "K2", "K3"))
    train_bf16 = section(
        "train loop (toy, 256 envs, 4 x 50 slots, bfloat16)",
        lambda: bench.bench_train_loop(256, 50, "bfloat16", split=False,
                                       device=dev),
        need=("K1", "K2", "K3"))
    out = bench.bench_line(head, scale, train, train_bf16)
    log(f"bench line (cut lengths): {json.dumps(out)}")
    if list(out) != JAX_BENCH_KEYS:
        failures.append(f"bench line keys {list(out)} != bench.py's")
    rates = [out[k] for k in ("value", "value_min",
                              "scale_env_steps_per_sec",
                              "train_slots_per_sec",
                              "train_slots_per_sec_bf16")]
    if not bench.finite_positive(*rates, out["spread"]):
        failures.append(f"bench line: a rate is not finite and positive "
                        f"({rates})")

    ev = section("bench_event (float32, R=4, 256 envs)",
                 lambda: bench_event.measure(
                     "float32", reps=4, envs=256, warm_slots=25,
                     timeit_n=3, device=dev),
                 need=("K1", "K2", "K3", "K4"))
    log(f"bench_event: {json.dumps(ev)}")
    ms = [v for k, v in ev.items() if k.endswith("_ms")]
    if list(ev) != JAX_EVENT_KEYS or not all(math.isfinite(v) for v in ms) \
            or not ev["event_ms"] > 0:
        failures.append("bench_event: keys or times")
    kc = section("kernel_ceiling (toy)", lambda: kernel_ceiling.measure(
        ["toy"], reps=8, timeit_n=3, device=dev),
        need=("K1", "K2", "K3", "K4"))
    if list(kc["toy"]) != JAX_CEILING_KEYS or not all(
            math.isfinite(kc["toy"][k]) for k in ("fwd_ms", "dual_ms",
                                                  "triple_ms", "fwdbwd_ms")):
        failures.append("kernel_ceiling: keys or times")
    bench_busy(torch, bench)
    log(f"bench: {card}")


def bench_busy(torch, bench):
    """Where the bench's sections spend their time: the device's busy
    share of the wall under torch.profiler over 16 headline steps (8192
    toy envs), 16 scale steps (2048 100v/50r envs), 50 training slots
    (toy, 256 envs: two train events) and 24 reps of K1 + K3 (autograd)
    at the toy event's shape (2048 rows)."""
    from diral_tpu_torch.envs import v2v_env as E
    from diral_tpu_torch.models.recurrent import lstm_init
    from diral_tpu_torch.ops import lstm_window as K1
    from diral_tpu_torch.train.loop import Draws, make_train_functions
    from diral_tpu_torch.train.runner import run_chunks

    dev = torch.device("cuda")
    for label, cfg, envs, step in (
            ("headline toy", bench.toy_4ue_3r().env, bench.NUM_ENVS,
             E.step_collision),
            ("scale 100v/50r", bench.load_config(os.path.join(
                bench.ROOT, "configs", "scale_100v_50r.yaml")).env, 2048,
             E.step_channel)):
        gen = torch.Generator(device=dev).manual_seed(0)
        held = [E.reset(cfg, envs, gen, torch.float32, dev)]

        def steps(n, cfg=cfg, envs=envs, step=step, gen=gen, held=held):
            held[0], r, sv = bench.rollout(
                cfg, held[0], lambda _i: E.sample_actions(cfg, gen, envs,
                                                          dev),
                0, n, step=step)
            torch.stack([r, sv]).tolist()

        steps(4)
        wall, prow, busy = device_profile(torch, lambda: steps(16), 16)
        log_profile(f"bench {label} x {envs} envs, 16 steps (profiler on)",
                    "step", wall, prow, busy, 4)

    cfg = bench.train_bench_config(256)
    fns = make_train_functions(cfg, torch.float32, dev)
    draws = Draws(torch.Generator(device=dev).manual_seed(0))
    held = [fns.init_carry(draws)]

    def slots(t0):
        for held[0], _, _ in run_chunks(fns, held[0], draws, t0, t0 + 50, 50,
                                        torch.float32):
            pass

    slots(612)
    wall, prow, busy = device_profile(torch, lambda: slots(662), 50)
    log_profile("bench train loop toy x 256 envs, 50 slots, 2 events "
                "(profiler on)", "slot", wall, prow, busy, 4)

    gen = torch.Generator(device=dev).manual_seed(0)
    p = lstm_init(gen, 23, 256, torch.float32, dev)
    x = torch.randn((2048, 6 * K1.padded_dim(23)), generator=gen,
                    device=dev).requires_grad_()

    def fwdbwd():
        for _ in range(24):
            torch.autograd.grad(K1.lstm_last_flat(x, p["w"], p["b"], 6)
                                .sum(), x)

    fwdbwd()
    wall, prow, busy = device_profile(torch, fwdbwd, 24)
    log_profile("bench K1 + K3 (autograd) x 2048 rows, 24 reps (profiler "
                "on)", "rep", wall, prow, busy, 4)


def parallel_phase(torch, np, here, card, zero_counts, read_counts,
                   failures, envs=16, slots=400, extra=()):
    """(i) The parallel layer on the card (see the module docstring).
    ``extra``: options added to every ``train`` command (a rehearsal on
    the CPU passes ``--device cpu``)."""
    import contextlib
    import dataclasses
    import io
    import shutil
    import tempfile

    from diral_tpu_torch.bench import _free_port
    from diral_tpu_torch.config import load_config
    from diral_tpu_torch.parallel import mesh as pmesh
    from diral_tpu_torch.scripts import width_report
    from diral_tpu_torch.train import checkpoint as ckpt
    from diral_tpu_torch.train import cli
    from diral_tpu_torch.train.loop import sampler_collective_bytes, \
        train_events
    from chip_mesh import same

    yaml_path = os.path.join(here, "configs", "scale_100v_50r.yaml")
    cfg = load_config(yaml_path)
    cfg = dataclasses.replace(cfg, time_slots=slots, engine=dataclasses.replace(
        cfg.engine, num_envs=envs))
    coll = sampler_collective_bytes(cfg)
    events = train_events(cfg, 0, slots)
    name = cfg.experiment_name
    base = ["train", yaml_path, "--num-envs", str(envs), "--slots",
            str(slots), "--resume", *extra]
    root = tempfile.mkdtemp(prefix="diral_parallel_")

    plain_save = ckpt.save

    def measured_save(into):
        """``checkpoint.save`` noting the device bytes it adds on this
        process's card (its peak over what was allocated before)."""
        def save(*a, **kw):
            if not torch.cuda.is_available():   # a rehearsal on the CPU
                into.append(0)
                return plain_save(*a, **kw)
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            path = plain_save(*a, **kw)
            torch.cuda.synchronize()
            into.append(torch.cuda.max_memory_allocated() - before)
            return path
        return save

    def nccl_one_rank():
        """One all-reduce of the sampler's batch through a one-rank NCCL
        group, asked for directly (the mesh skips a group of one)."""
        import torch.distributed as dist

        from diral_tpu_torch.parallel import distributed

        with contextlib.redirect_stdout(io.StringIO()) as out:
            distributed.initialize(f"127.0.0.1:{_free_port()}", 1, 0)
        try:
            mesh = pmesh.make_mesh(1)
            x = torch.randn(coll["gathered_elems"], device="cuda",
                            generator=torch.Generator("cuda").manual_seed(0))
            y = x.clone()
            dist.all_reduce(y, group=mesh.data_group)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist.all_reduce(y, op=dist.ReduceOp.MAX, group=mesh.data_group)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            return mesh.backend, torch.equal(x, y), ms, out.getvalue()
        finally:
            distributed.shutdown()

    def run(label, mesh=None, ranks=1):
        wd = os.path.join(root, re.sub(r"\W+", "_", label))
        argv = base + ["--workdir", wd]
        procs = []
        if mesh:
            argv += ["--mesh", mesh, "--coordinator",
                     f"127.0.0.1:{_free_port()}", "--num-processes",
                     str(ranks)]
            procs = [subprocess.Popen(
                [sys.executable, "-m", "diral_tpu_torch", *argv,
                 "--process-id", str(r)], cwd=here, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True,
                env=dict(os.environ, PYTHONPATH=here))
                for r in range(1, ranks)]
            argv += ["--process-id", "0"]
        pmesh.COLLECTIVES = []
        zero_counts()
        buf = io.StringIO()
        save_bytes = []
        t0 = time.perf_counter()
        ok = True
        try:
            with contextlib.redirect_stdout(buf):
                ckpt.save = measured_save(save_bytes)
                cli.main(argv)
        except Exception as e:   # recorded as a failure below
            log(f"parallel {label}: rank 0 raised {e!r}")
            ok = False
        finally:
            ckpt.save = plain_save
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = read_counts(f"parallel {label}")
        text = buf.getvalue()
        for p in procs:
            try:
                out, _ = p.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
            text += out
            if p.returncode != 0:
                log(f"parallel {label}: rank 1 exit {p.returncode}:\n"
                    f"{out[-3000:]}")
                ok = False
        for line in text.splitlines():
            if line.startswith("backend:"):
                log(f"parallel {label}: {line}")
        res = os.path.join(wd, "save_results", "test", name)
        step = ckpt.latest_step(os.path.join(wd, "save_model", "test",
                                             name))
        if step is None or not os.path.exists(os.path.join(
                res, "rewards_sim0.npy")):
            ok = False
        collectives, pmesh.COLLECTIVES = pmesh.COLLECTIVES, None
        return {"ok": ok, "wall": wall, "counts": counts, "wd": wd,
                "step": step, "collectives": collectives,
                "save_bytes": max(save_bytes, default=None)}

    def results(r):
        res = os.path.join(r["wd"], "save_results", "test", name)
        blob = torch.load(os.path.join(
            r["wd"], "save_model", "test", name, f"ckpt_{r['step']}.pt"),
            map_location="cpu", weights_only=True, mmap=True)
        return (np.load(os.path.join(res, "rewards_sim0.npy")),
                np.load(os.path.join(res, "actions_sim0.npy")), blob)

    try:
        ref = run("one process")
        log(f"parallel one process: {slots} slots in {ref['wall']:.2f} s, "
            f"launches {ref['counts']}")
        if not ref["ok"]:
            failures.append("parallel: the one-process run")
            return
        want = results(ref)
        need = ("K1", "K2", "K3", "K5", "K6")
        for label, mesh, ranks in (
                ("nccl data=1 (one rank)", "data=1", 1),
                ("gloo data=2 (two ranks, one card)", "data=2", 2),
                ("gloo data=1,model=2 (two ranks, one card)",
                 "data=1,model=2", 2)):
            r = run(label, mesh, ranks)
            got = results(r) if r["ok"] else None
            bit = got is not None and all(
                np.array_equal(a, b) for a, b in zip(got[:2], want[:2])) \
                and same(got[2], want[2])
            ar = [c for c in r["collectives"] if c["op"] == "all_reduce"]
            data = 2 if mesh == "data=2" else 1
            want_ar = events if data > 1 else 0
            saved_ok = (r["save_bytes"] is not None
                        and r["save_bytes"] <= pmesh.SAVE_CHUNK_BYTES)
            per_event = (len(ar) == want_ar and all(
                c["axis"] == "data" and c["numel"] == coll["gathered_elems"]
                and c["bytes"] == coll["bytes_per_event"] for c in ar))
            other = {}
            for c in r["collectives"]:
                if c["op"] != "all_reduce":
                    key = f"{c['op']}/{c['axis']}"
                    other[key] = other.get(key, 0) + 1
            launched = all(r["counts"][k] for k in need)
            log(f"parallel {label}: {slots} slots in {r['wall']:.2f} s "
                f"(one process {ref['wall']:.2f} s); launches on rank 0 "
                f"{r['counts']}; {events} train events, "
                f"{len(ar)} all_reduce(s) of "
                f"{sorted({c['numel'] for c in ar})} elements = "
                f"{sorted({c['bytes'] for c in ar})} B each "
                f"(sampler_collective_bytes: {coll['bytes_per_event']} B, "
                f"{'1 a train event' if data > 1 else 'none: a data group of one'}"
                f"); other collectives {other}; device bytes a save adds on "
                f"rank 0: {r['save_bytes']} (one-process run "
                f"{ref['save_bytes']}; limit {pmesh.SAVE_CHUNK_BYTES}); "
                f"rewards, actions and checkpoint at slot {r['step']} "
                f"bit-equal to one process: {bit}")
            if not (r["ok"] and bit and per_event and launched and saved_ok):
                failures.append(f"parallel {label}")
            if mesh == "data=1" and torch.cuda.is_available():
                backend, same_ar, ms, line = nccl_one_rank()
                log(f"parallel explicit one-rank all_reduce of "
                    f"{coll['bytes_per_event']} B: {line.strip()}; "
                    f"equal: {same_ar}; {ms:.3f} ms")
                if backend != "nccl" or not same_ar:
                    failures.append("parallel one-rank NCCL all_reduce")

        # (4) the width report: the arithmetic, then a measured run cut
        # to 64 envs
        with contextlib.redirect_stdout(io.StringIO()):
            arith = width_report.main(["--no-run", "--out", os.path.join(
                root, "width_arith.json")])
            cut = width_report.main(["--envs", "64", "--slots", "100",
                                     "--out", os.path.join(root,
                                                           "width_cut.json")])
        m, run_ = arith["hbm_model"]["float32"], cut.get("measured_run", {})
        log(f"width_report: {card}; {arith['memory_bytes']:,} B x "
            f"{arith['budget_fraction']}; float32 {m['per_env_mb']} MiB/env "
            f"-> B_max {m['largest_B_one_chip']} (pow2 "
            f"{m['largest_pow2_B']}), {m['chips_for_8192_envs']} cards for "
            f"8192 envs; cut run {json.dumps(run_)}")
        rates = [run_.get(k) for k in ("slots_per_sec", "env_slots_per_sec",
                                       "agent_steps_per_sec")]
        if not (m["largest_pow2_B"] >= 1 and all(
                isinstance(v, float) and math.isfinite(v) and v > 0
                for v in rates) and run_.get("peak_bytes", 0) > 0):
            failures.append("parallel width_report")
    except Exception as e:   # recorded as a failure
        log(f"parallel phase raised {e!r}")
        failures.append("parallel phase")
    finally:
        shutil.rmtree(root, ignore_errors=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    started = last = time.perf_counter()

    def mark(label):
        nonlocal last
        now = time.perf_counter()
        log(f"[{label}: {now - last:.1f} s]")
        last = now
    import numpy as np

    from diral_tpu_torch.config import load_config
    from diral_tpu_torch.envs import v2v_env as E
    from diral_tpu_torch.models import qnets
    from diral_tpu_torch.models.recurrent import lstm_scan
    from diral_tpu_torch.ops import _build
    from diral_tpu_torch.ops import channel_phase as K5
    from diral_tpu_torch.ops import lanes_hist as K7
    from diral_tpu_torch.ops import lstm_window as K1
    from diral_tpu_torch.ops import piggy_hist as K6
    from diral_tpu_torch.scripts import full_run
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
        for label, stats in ptxas_stats(rep):
            log(f"  {name} {label}: {stats}")

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

    errs = {}
    for label, B, D, H, dtype in (("scale f32", 1600, 100, 256, torch.float32),
                                  ("scale bf16", 1600, 100, 256, torch.bfloat16),
                                  ("toy f32", 1024, 23, 256, torch.float32)):
        x2, w, b, T = k1_inputs(B, D, H, dtype=dtype)
        got = K1.lstm_last_flat(x2, w, b, T).float()
        want = K1.lstm_last_flat_plain(x2, w, b, T).float()
        torch.cuda.synchronize()
        gap = (got - want).abs()
        errs[label] = err = float(gap.max())
        # the K1 class (phase 6's rule): each value within 1e-4 plus one
        # bf16 step of it -- a bf16 output, or an intermediate h whose
        # rounding the sum order flipped, lands one step apart -- and the
        # median gap below 1e-6
        ok = (bool((gap <= 1e-4 + bf16_ulp(want)).all())
              and float(gap.median()) < 1e-6)
        log(f"K1 {label}: B={B} T={T} D={D} H={H} max|dh|={err:.3e} median "
            f"{float(gap.median()):.1e} {'ok' if ok else 'FAIL'}")
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
    lstm = cudnn_lstm(torch, w, b, D, H, dev)
    with torch.no_grad():
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
    rows["K5"] = k5_phase(torch, np, K5, E, load_config, here, dev, cuda_ms,
                          failures)

    # 3c. K6: piggy histogram, 16 envs, N = 100, 50 bins over +-500, and
    # the launch floor beside K6 and K7
    rows["K6"] = k6_phase(torch, np, K6, E, load_config, here, dev, cuda_ms,
                          failures)

    # 3d. K7: the lanes histogram
    rows["K7"] = k7_phase(torch, np, K7, dev, cuda_ms, failures)
    rows["K7"]["floor_ms"] = rows["K6"]["floor_ms"]

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

    def with_lanes(cfg, **engine):
        env = dataclasses.replace(cfg.env, state=dataclasses.replace(
            cfg.env.state, hist_impl="lanes"))
        return dataclasses.replace(cfg, env=env, engine=dataclasses.replace(
            cfg.engine, **engine))

    ppo_cfg = with_lanes(load_config(os.path.join(here, "configs",
                                                  "ppo_congested.yaml")))
    lanes_reference_phase(torch, np, E, K7, ppo_cfg, dev, failures)

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
        rows[k]["launches_by_path"] = {"serve 100v/50r (300 x 2 slots)": n}
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
    K7.lanes_histogram.launches = 0
    torch.cuda.synchronize()
    lres = evaluate.evaluate_drqn(with_lanes(toy), tparams, 3, steps=20,
                                  device=dev)
    torch.cuda.synchronize()
    k7_toy = K7.lanes_histogram.launches
    rows["K7"]["launches_by_path"] = {"serve toy 256 envs (lanes, 20 slots)":
                                      k7_toy}
    log(f"greedy DRQN toy x 256 envs, hist_impl='lanes': K7 launches "
        f"{k7_toy}; {json.dumps(lres)}")
    if k7_toy < 20 or not all(math.isfinite(v) for v in lres.values()):
        failures.append("toy slice (lanes)")

    # 6. training kernels K2, K3, K4
    rows.update(train_kernel_phase(torch, np, K1, dev, cuda_ms, bound,
                                   failures))
    rows["K1"].update(act_kernel_phase(torch, np, K1, dev, cuda_ms,
                                       failures))

    from diral_tpu_torch.agents import drqn
    from diral_tpu_torch.train import loop, runner

    train_wrappers = full_run.kernel_wrappers()

    def zero_counts():
        for fn in train_wrappers.values():
            fn.launches = 0
        torch.cuda.synchronize()

    def read_counts(path):
        torch.cuda.synchronize()
        got = {k: fn.launches for k, fn in train_wrappers.items()}
        for k, n in got.items():
            if n:
                rows[k].setdefault("launches_by_path", {})[path] = n
        return got

    # 7. learner phase, toy shape: 4 envs so that the pretrain ring holds
    # more valid windows (4 x 174) than one batch draws (512)
    toy1 = load_config(os.path.join(here, "configs", "toy_4ue_3r.yaml"))
    lcfg = dataclasses.replace(
        toy1, engine=dataclasses.replace(toy1.engine, num_envs=4),
        agent=dataclasses.replace(toy1.agent, network=dataclasses.replace(
            toy1.agent.network, lstm_impl="pallas")))
    acfg = lcfg.agent
    fns = loop.make_train_functions(lcfg, device=dev)
    draws = loop.Draws(torch.Generator(device=dev).manual_seed(11))
    carry = fns.init_carry(draws)
    with torch.no_grad():   # a target net that differs from the online one
        for p in carry.learner.target_params.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=draws.gen,
                                      device=dev))
    scores = draws.sampler_scores(0, 1, fns.B * carry.replay.capacity)
    rw = loop.sample_window_rows_many(carry.replay, scores, acfg.batch_size,
                                      fns.T, windows_only=True)
    rs = loop.sample_window_rows_many(carry.replay, scores, acfg.batch_size,
                                      fns.T)
    la = carry.learner
    lb = clone_learner(torch, drqn, qnets, la, acfg, dev)
    lg = clone_learner(torch, drqn, qnets, la, acfg, dev)
    lc = clone_learner(torch, drqn, qnets, la, acfg, "cpu")
    zero_counts()
    loss_w = float(drqn.train_on_windows(la, rw["windows"][0],
                                         rw["actions"][0], rw["rewards"][0],
                                         acfg))
    loss_p = float(drqn.train_on_packed(lb, rs["states"][0], rs["actions"][0],
                                        rs["rewards"][0],
                                        rs["next_states"][0], acfg))
    lcounts = read_counts("learner phase (1 + 1 steps)")
    lstm_grad = float(lb.params.lstm.w.grad.abs().max())
    same_loss = abs(loss_w - loss_p) <= 1e-6 * abs(loss_p) + 1e-7
    same_step = all(torch.allclose(p, q, rtol=1e-5, atol=1e-6)
                    for p, q in zip(la.params.parameters(),
                                    lb.params.parameters()))
    grads = []
    for lrn, dv in ((lg, dev), (lc, "cpu")):
        batch = [rw[k][0].to(dv) for k in ("windows", "actions", "rewards")]
        loss = drqn.windows_loss(lrn, *batch, acfg)
        grads.append(torch.autograd.grad(loss, list(lrn.params.parameters())))
    grad_rel = max(float((gg.cpu() - gc).abs().max())
                   / max(float(gc.abs().max()), 1e-30)
                   for gg, gc in zip(*grads))
    ok_l = (same_loss and same_step and grad_rel <= 1e-3 and lstm_grad > 0
            and all(lcounts[k] >= 1 for k in ("K1", "K2", "K4"))
            and lcounts["K3"] >= 2)
    log(f"learner (toy, {acfg.batch_size * 4} rows): loss windows "
        f"{loss_w:.9g} packed {loss_p:.9g}; params after one step "
        f"{'agree' if same_step else 'DIFFER'}; max|dL/dW_lstm| {lstm_grad:.3e};"
        f" card vs CPU plain gradients max rel {grad_rel:.2e}; launches "
        f"{lcounts}; {'ok' if ok_l else 'FAIL'}")
    if not ok_l:
        failures.append("learner phase")

    # 8. training slice: toy (full width, 1500 slots) and 100v/50r
    def event_ms(cfg_run, carry, reps):
        fns = loop.make_train_functions(cfg_run, device=dev)
        d = loop.Draws(torch.Generator(device=dev).manual_seed(5))
        t_last = cfg_run.time_slots - 1
        times = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fns.train_call(carry.learner, carry.replay, t_last, d)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times[1:]), fns, d

    import tempfile

    def train_run(cfg_run, label, need):
        with tempfile.TemporaryDirectory() as wd:
            zero_counts()
            t0 = time.perf_counter()
            carry, out = runner.train_experiment(cfg_run, wd, device=dev,
                                                 verbose=False)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            counts = read_counts(label)
        losses = out["loss"][out["loss"] != 0]
        ok = (np.isfinite(out["loss"]).all() and losses.size > 0
              and all(counts[k] >= n for k, n in need.items()))
        log(f"train {label}: {cfg_run.time_slots} slots in {wall:.2f} s "
            f"({cfg_run.time_slots / wall:.1f} slots/s incl. warmup, pretrain "
            f"and {losses.size} train events); last loss "
            f"{losses[-1] if losses.size else float('nan'):.6g}; "
            f"mean sum reward (env 0) {out['sum_reward'][:, 0].mean():.4f}; "
            f"launches {counts} (need {need}) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"train {label}")
        return carry

    toy_run = dataclasses.replace(toy1, time_slots=1500)
    tcarry = train_run(toy_run, "toy 4v/3r (1500 slots)",
                       {"K1": 1500, "K2": 80, "K3": 80})
    toy_ev, tfns, tdraws = event_ms(toy_run, tcarry, 5)
    log(f"toy train event (n_batch {toy_run.agent.n_batch} x "
        f"{toy_run.agent.batch_size * 4} rows): {toy_ev:.3f} ms")
    with tempfile.TemporaryDirectory() as wd:
        cli = subprocess.run(
            [sys.executable, "-m", "diral_tpu_torch", "train",
             os.path.join(here, "configs", "toy_4ue_3r.yaml"), "--slots",
             "600", "--workdir", wd], cwd=here, capture_output=True,
            text=True, timeout=600,
            env=dict(os.environ, PYTHONPATH=here))
        res_dir = os.path.join(wd, "save_results", "test", "toy_4ue_3r")
        files = sorted(os.listdir(res_dir)) if os.path.isdir(res_dir) else []
    ok_cli = cli.returncode == 0 and {"rewards_sim0.npy",
                                      "actions_sim0.npy"} <= set(files)
    log(f"CLI train toy --slots 600: exit {cli.returncode}, files {files} "
        f"{'ok' if ok_cli else 'FAIL: ' + cli.stderr[-2000:]}")
    if not ok_cli:
        failures.append("CLI train")

    scale_run = dataclasses.replace(scale, time_slots=400)
    scarry = train_run(scale_run, "100v/50r x 16 envs (400 slots)",
                       {"K1": 400, "K2": 12, "K3": 12, "K5": 580, "K6": 580})
    scale_ev, sfns, sdraws = event_ms(scale_run, scarry, 3)
    log(f"100v/50r train event (n_batch {scale_run.agent.n_batch} x "
        f"{scale_run.agent.batch_size * 100} rows): {scale_ev:.3f} ms")
    for k in ("K1", "K2", "K3", "K5", "K6"):
        rows[k]["launches"] = rows[k].get("launches_by_path", {}).get(
            "100v/50r x 16 envs (400 slots)", 0)
    rows["K4"]["launches"] = lcounts["K4"]

    # 9. PPO slice (K1, K3, K7) and 10. PS slice (K7)
    ppo_kernel_phase(torch, np, K1, dev, cuda_ms, rows, failures)
    ppo_path = ppo_phase(torch, np, here, ppo_cfg, dev, zero_counts,
                         read_counts, evaluate, failures)
    rows["K7"]["launches"] = rows["K7"]["launches_by_path"].get(ppo_path, 0)
    ps_cfg = with_lanes(load_config(os.path.join(here, "configs",
                                                 "congested_6v_5r.yaml")),
                        num_envs=32)
    ps_phase(torch, np, here, ps_cfg, dev, zero_counts, read_counts, failures)

    # 11. where a train event's time goes
    profile_train_events(torch, "toy", tfns, tcarry, toy_run.time_slots - 1,
                         tdraws, 3)
    profile_train_events(torch, "100v/50r", sfns, scarry,
                         scale_run.time_slots - 1, sdraws, 2)

    # 12. run management: (a) the PRR configs through train, (b) exact
    # resume at 100v/50r, (c) eval of its best snapshot, (d) the seed
    # sweep, (e) the profile verb
    from diral_tpu_torch.train import checkpoint as ckpt
    from diral_tpu_torch.train import cli

    mark("phases 1-11")
    prr_train_phase(torch, np, here, dev, load_config, runner, ckpt,
                    evaluate, zero_counts, read_counts, failures)
    mark("(a) PRR configs through train")
    resume_phase(torch, np, here, dev, load_config, runner, ckpt, cli,
                 zero_counts, read_counts, failures)
    mark("(b) resume and (c) eval --checkpoint --best")
    sweep_phase(torch, np, here, dev, load_config, runner, cli, failures)
    mark("(d) train-sweep")
    profile_phase(here, cli, failures)
    mark("(e) profile")
    campaign_phase(torch, np, here, zero_counts,
                   lambda: {k: fn.launches for k, fn in
                            train_wrappers.items()}, failures)
    mark("(f) seed_campaign and full_run")
    serve_phase(torch, np, here, card, zero_counts,
                lambda: {k: fn.launches for k, fn in
                         train_wrappers.items()}, failures)
    mark("(g) serve")
    bench_phase(torch, card, zero_counts,
                lambda: {k: fn.launches for k, fn in
                         train_wrappers.items()}, failures)
    mark("(h) bench, bench_event, kernel_ceiling")
    parallel_phase(torch, np, here, card, zero_counts, read_counts, failures)
    mark("(i) parallel")
    episode_campaign_phase(torch, np, here, dev, zero_counts, read_counts,
                           failures)
    mark("(j) ppo_campaign, ps_campaign, qvalues_all_agents")
    ref_sweep_phase(torch, np, here, zero_counts, read_counts, failures)
    mark("(k) ref_sweep")
    log(f"total {time.perf_counter() - started:.1f} s")

    # 13. results
    order = ("name", "route", "source", "replaces", "launches", "max_abs_err",
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = [{k: rows[i].get(k) for k in order} | {
        k: v for k, v in rows[i].items() if k not in order}
        for i in sorted(rows)]
    if failures:
        print("chip_smoke FAILED: " + "; ".join(failures), file=sys.stderr)
        return 1
    log(json.dumps({"kernels": kernels}))
    # the run uses one card (cuda:0); "count" is the run contract's
    # torch.cuda.device_count(), 1 on the one-card machine it is run on
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
