"""Decompose the DRQN train event on the card (scripts/bench_event.py's
counterpart).

Times the event and its pieces in isolation at bench.py's training config
(toy, 256 envs, batch 512 x n_batch 2, H = 256), and the LSTM kernels K1,
K4 and K2 alone and K1 + K3 as one autograd backward, at the event's
shapes: the ceiling the event is chasing.

Timing: every piece runs as R and 2R eager reps between two CUDA events,
and the per-rep cost is (T(2R) - T(R)) / R, each T the median of
``--timeit-n`` runs after a settle run of each length; the R and 2R runs
alternate, so that a drift of the host's speed falls on both.  In eager
PyTorch the difference cancels only the constant costs (the sync, the
first call); each rep's own launches stay in, as they do in the training
loop, and where a piece is host-bound (the toy shapes: the device idles
most of a rep) the host's noise stays in too.  The
JAX script's ``_poison`` (a carried accumulator threaded into each rep's
input) is not needed: it kept XLA from hoisting a loop-invariant body out
of its scan, and eager PyTorch runs every call it is given.

Usage:
    python -m diral_tpu_torch.scripts.bench_event [--dtype float32]
        [--reps 96] [--envs 256] [--warm-slots 1100] [--timeit-n 7]
        [--out FILE] [--device cuda|cpu]
Writes a per-piece table to stderr and one JSON line (the JAX script's
keys) to stdout; ``--out`` also writes it to FILE (default: none).
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from diral_tpu_torch.bench import device_init, log, train_bench_config
from diral_tpu_torch.device import resolve_device


def timed_run(fn, reps: int, dev) -> float:
    """Seconds of ``reps`` back-to-back calls of ``fn``: CUDA events on the
    card, the host clock (the CPU computes as it goes) on the CPU."""
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    return time.perf_counter() - t


def timeit_diff(fn, reps: int, n: int, dev, label: str = "") -> float:
    """Per-rep seconds by the two-length difference (T(2R) - T(R)) / R:
    a settle run of each length, then ``n`` runs of R and of 2R in turn,
    the median of each."""
    timed_run(fn, reps, dev)
    timed_run(fn, 2 * reps, dev)
    ts1, ts2 = [], []
    for _ in range(n):
        ts1.append(timed_run(fn, reps, dev))
        ts2.append(timed_run(fn, 2 * reps, dev))
    m1, m2 = statistics.median(ts1), statistics.median(ts2)
    per = (m2 - m1) / reps
    log(f"{label:46s} {per * 1e3:8.3f} ms/rep   (T({reps})={m1 * 1e3:.1f}, "
        f"T({2 * reps})={m2 * 1e3:.1f}, spread "
        f"{max(ts2) / max(min(ts2), 1e-9):.2f}x)")
    return per


def tflops(flops: float, sec: float):
    """Achieved TFLOP/s, or None for a noise-negative difference."""
    return None if sec <= 0 else round(flops / sec / 1e12, 1)


def measure(dtype: str = "float32", reps: int = 96, envs: int = 256,
            warm_slots: int = 1100, timeit_n: int = 7, device=None) -> dict:
    """The pieces of one train event at bench.py's training config
    (``train_bench_config``) with ``envs`` envs, timed; returns the JAX
    script's result dict."""
    from diral_tpu_torch.agents import drqn
    from diral_tpu_torch.ops import lstm_window as K
    from diral_tpu_torch.train import loop as L
    from diral_tpu_torch.train.runner import run_chunks

    dev = resolve_device(device)
    device_init(dev)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = train_bench_config(envs, dtype)
    acfg = cfg.agent
    N = cfg.env.num_users
    T = acfg.step_size
    H = acfg.network.layers[0]
    D = cfg.env.state_space
    Dp = K.padded_dim(D)
    NB = N * acfg.batch_size              # rows per gradient-step batch
    R, nt = reps, timeit_n

    fns = L.make_train_functions(cfg, torch.float32, dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    draws = L.Draws(gen)
    carry = fns.init_carry(draws)
    for carry, _, _ in run_chunks(fns, carry, draws, 0, warm_slots,
                                  max(warm_slots, 1), torch.float32):
        pass
    log(f"carry warmed ({warm_slots} slots)")
    replay, learner = carry.replay, carry.learner
    use_lstm = acfg.network.use_lstm_input
    S = replay.capacity

    def scores(n):
        return torch.rand((n, fns.B * S), generator=gen, device=dev)

    # analytic model FLOPs (matmul 2mnk only), per LSTM forward pass
    fwd_flops = NB * T * (2 * Dp * 4 * H + 2 * H * 4 * H)

    # -- the full event, as the loop runs it (sampler + n_batch steps) ---
    def full():
        rows = L.sample_window_rows_many(replay, scores(acfg.n_batch),
                                         acfg.batch_size, T,
                                         windows_only=use_lstm)
        drqn.train(learner, rows, 1000, acfg)

    # -- sampler alone: n_batch draws, gather and repack ----------------
    def sampler():
        L.sample_window_rows_many(replay, scores(acfg.n_batch),
                                  acfg.batch_size, T, windows_only=True)

    # -- one pre-sampled batch: target / gradient steps -----------------
    rows = L.sample_window_rows_many(replay, scores(1), acfg.batch_size, T)
    s1, ns1 = rows["states"][0], rows["next_states"][0]
    a1, r1 = rows["actions"][0], rows["rewards"][0]
    rows_w = L.sample_window_rows_many(replay, scores(1), acfg.batch_size, T,
                                       windows_only=True)
    w1, aw, rw = (rows_w["windows"][0], rows_w["actions"][0],
                  rows_w["rewards"][0])

    def target():
        drqn.td_targets(learner, r1, ns1, acfg)

    def grad():
        drqn.train_on_packed(learner, s1, a1, r1, ns1, acfg)

    def grad_fused():
        drqn.train_on_windows(learner, w1, aw, rw, acfg)

    # -- Adam alone, on fixed gradients ---------------------------------
    net = learner.params
    net.zero_grad(set_to_none=True)
    drqn.loss_fn(net, s1, a1, drqn.td_targets(learner, r1, ns1, acfg),
                 acfg).backward()
    fixed = [p.grad.detach().clone() for p in net.parameters()]

    def adam():
        for p, g in zip(net.parameters(), fixed):
            p.grad = g
        learner.opt.step()

    # -- the LSTM kernels alone, at the event's shapes ------------------
    kdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    kgen = torch.Generator(device=dev).manual_seed(3)
    kx = torch.randn((NB, T * Dp), generator=kgen, device=dev).to(kdt)
    kxc = torch.randn((NB, (T + 1) * Dp), generator=kgen,
                      device=dev).to(kdt)
    lstm, lstm_t = net.tree()["lstm"], learner.target_params.tree()["lstm"]
    w, b = (lstm[k].detach().to(kdt) for k in ("w", "b"))
    wt, bt = (lstm_t[k].detach().to(kdt) for k in ("w", "b"))
    kxg = kx.clone().requires_grad_()

    @torch.no_grad()
    def kfwd():
        K.lstm_last_flat(kx, w, b, T)

    @torch.no_grad()
    def kdual():
        K.lstm_last_flat_dual(kx, w, b, wt, bt, T)

    @torch.no_grad()
    def ktriple():
        K.lstm_last_flat_triple(kxc, w, b, wt, bt, T)

    def kfwdbwd():
        # K1 forward and K3 (with dx) as its autograd backward
        torch.autograd.grad(K.lstm_last_flat(kxg, w, b, T).sum(), kxg)

    log(f"\n-- pieces ({dtype}), per-rep = (T(2R)-T(R))/R, R={R}, median "
        f"of {nt}; NB={NB} rows, T={T}, H={H}, Dp={Dp} --")
    t_full = timeit_diff(full, R, nt, dev,
                         f"full event (n_batch={acfg.n_batch})")
    t_samp = timeit_diff(sampler, R, nt, dev,
                         f"sampler: {acfg.n_batch}x(sort+gather+repack)")
    t_tgt = timeit_diff(target, R, nt, dev,
                        "td_targets: dual fwd + heads (1 batch)")
    t_grad = timeit_diff(grad, R, nt, dev, "grad step, presampled (1 batch)")
    t_gradf = timeit_diff(grad_fused, R, nt, dev,
                          "grad step FUSED triple (1 batch)")
    t_adam = timeit_diff(adam, R, nt, dev, "adam update, fixed grads")
    t_kf = timeit_diff(kfwd, R, nt, dev, "LSTM kernel fwd alone (K1)")
    t_kd = timeit_diff(kdual, R, nt, dev, "LSTM dual kernel alone (K4)")
    t_kt = timeit_diff(ktriple, R, nt, dev, "LSTM triple kernel alone (K2)")
    t_kfb = timeit_diff(kfwdbwd, R, nt, dev,
                        "LSTM kernel fwd+bwd alone (K1 + K3)")

    result = {
        "dtype": dtype,
        "shape": {"rows": NB, "T": T, "H": H, "Dp": Dp,
                  "n_batch": acfg.n_batch},
        "event_ms": round(t_full * 1e3, 3),
        "sampler_ms": round(t_samp * 1e3, 3),
        "target_ms": round(t_tgt * 1e3, 3),
        "grad_presampled_ms": round(t_grad * 1e3, 3),
        "grad_fused_ms": round(t_gradf * 1e3, 3),
        "adam_ms": round(t_adam * 1e3, 3),
        "kernel_fwd_ms": round(t_kf * 1e3, 3),
        "kernel_dual_ms": round(t_kd * 1e3, 3),
        "kernel_triple_ms": round(t_kt * 1e3, 3),
        "kernel_fwdbwd_ms": round(t_kfb * 1e3, 3),
        # achieved matmul TFLOP/s of each kernel piece (analytic 2mnk)
        "kernel_fwd_tflops": tflops(fwd_flops, t_kf),
        "kernel_dual_tflops": tflops(2 * fwd_flops, t_kd),
        # triple = 3 recurrences minus the shared online x-projections
        "kernel_triple_tflops": tflops(
            3 * fwd_flops - NB * T * 2 * Dp * 4 * H, t_kt),
        "kernel_fwdbwd_tflops": tflops(4 * fwd_flops, t_kfb),
        # n_batch fused grad steps (each includes its target) + sampler
        "pieces_sum_ms": round((t_samp + acfg.n_batch * t_gradf) * 1e3, 3),
    }
    log(f"\nevent {result['event_ms']} ms vs pieces sum "
        f"{result['pieces_sum_ms']} ms (sampler + n_batch*grad); kernel "
        f"ceilings fwd/dual/fwd+bwd = {result['kernel_fwd_tflops']}/"
        f"{result['kernel_dual_tflops']}/{result['kernel_fwdbwd_tflops']} "
        f"TFLOP/s")
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(prog="bench_event")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--reps", type=int, default=96,
                    help="base rep count R (pieces time at R and 2R)")
    ap.add_argument("--envs", type=int, default=256)
    ap.add_argument("--warm-slots", type=int, default=1100)
    ap.add_argument("--timeit-n", type=int, default=7)
    ap.add_argument("--out", default=None,
                    help="also write the JSON to this file")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    result = measure(args.dtype, args.reps, args.envs, args.warm_slots,
                     args.timeit_n, args.device)
    blob = json.dumps(result)
    print(blob, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(blob + "\n")
    return result


if __name__ == "__main__":
    main()
