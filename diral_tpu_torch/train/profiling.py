"""Per-kernel training-loop profiler: where one slot's device time goes
(diral_tpu/train/profiling.py; ``python -m diral_tpu_torch profile``).

Runs a warm chunk of the training loop, times three more (each ended by
``torch.cuda.synchronize()``, the median rate kept), then traces one chunk
under ``torch.profiler`` with CUDA activity and sums the device time of
every kernel by name.  The hand-written kernels of ``csrc/`` (K1-K7) take
the place of the JAX package's ``pallas/custom-call`` category; GEMMs are
cuBLAS / CUTLASS kernels.

Device times of kernels that overlap (another stream, a copy engine) add
up past the wall time; the wall denominator is the measured slots/s.  On
the CPU there is no device time: categories and top ops come back empty
and the rate stays valid, as the JAX package's does on its CPU backend.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import re
import statistics
import sys
import time

import torch


def _log(*a):
    print(*a, file=sys.stderr, flush=True)


# kernel name -> readable category, by substrings of the demangled name
_CATEGORY_PATTERNS = [
    (r"lstm_\w*kernel|channel_phase_\w*kernel|piggy_hist_kernel"
     r"|lanes_hist_kernel|noop_kernel", "csrc kernel"),
    (r"gemm|gemv|cublas|cutlass|xmma|splitkreduce", "matmul"),
    (r"memcpy|memset", "memcpy/memset"),
    (r"sort|radix", "sort"),
    (r"philox|random|distribution|rng", "rng"),
    (r"reduce", "reduce"),
    (r"elementwise|vectorized|unrolled|index|gather|scatter|cat|copy"
     r"|where|fill", "elementwise"),
]


def categorize(name: str) -> str:
    low = name.lower()
    for pat, cat in _CATEGORY_PATTERNS:
        if re.search(pat, low):
            return cat
    return "other"


def device_kernels(prof):
    """(ms by kernel name, launches by kernel name) of a finished
    ``torch.profiler.profile``'s device events."""
    by_name, occurrences = collections.Counter(), collections.Counter()
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.key_averages():
        if e.device_type == cuda:
            by_name[e.key] += e.self_device_time_total / 1e3
            occurrences[e.key] += e.count
    return by_name, occurrences


def profile_training(config_path: str, envs: int = 16, slots: int = 100,
                     top: int = 25, dtype: str = "float32",
                     trace_dir: str | None = None, device=None) -> dict:
    """Measure steady-state slots/s, trace one chunk, print the per-kernel
    attribution table (stderr) and return the summary dict.  ``dtype`` is
    the network's compute dtype ("float32" or "bfloat16": a bf16 ring and
    history).  The traced chunk's Chrome trace goes to
    ``<trace_dir>/trace.json`` when ``trace_dir`` is given; the table is
    read from the profiler itself."""
    from torch.profiler import ProfilerActivity, profile

    from diral_tpu_torch.config import load_config
    from diral_tpu_torch.device import resolve_device
    from diral_tpu_torch.train.loop import Draws, make_train_functions
    from diral_tpu_torch.train.runner import run_chunks

    dev = resolve_device(device)
    cfg = load_config(config_path)
    cfg = dataclasses.replace(
        cfg, save_positions=False,
        engine=dataclasses.replace(cfg.engine, num_envs=envs),
        agent=dataclasses.replace(
            cfg.agent, network=dataclasses.replace(
                cfg.agent.network, compute_dtype=dtype)))
    I = cfg.episode_interval
    slots = (slots // I) * I or I

    fns = make_train_functions(cfg, torch.float32, dev)
    draws = Draws(torch.Generator(device=dev).manual_seed(0))
    carry = fns.init_carry(draws)

    def run(carry, t0):
        for carry, _, logs in run_chunks(fns, carry, draws, t0, t0 + slots,
                                         slots, torch.float32):
            pass   # the chunk's host logs are its sync
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return carry

    t0 = (cfg.agent.batch_size + 100 + I - 1) // I * I
    t = time.perf_counter()
    carry = run(carry, t0)
    _log(f"first chunk: {time.perf_counter() - t:.1f}s")

    rates = []
    for i in range(1, 4):
        t = time.perf_counter()
        carry = run(carry, t0 + i * slots)
        rates.append(slots / (time.perf_counter() - t))
    rate = statistics.median(rates)
    _log(f"train rate: {rate:,.1f} slots/s ({envs} envs, "
         f"{cfg.env.num_users}v/{cfg.env.num_channels}r, {dtype})")

    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        carry = run(carry, t0 + 10 * slots)
    if trace_dir:
        os.makedirs(trace_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))

    by_name, occ = device_kernels(prof)
    total = sum(by_name.values())
    out = {"config": config_path, "envs": envs, "dtype": dtype,
           "slots_per_sec": round(rate, 1), "categories": {},
           "top_ops": []}
    if total == 0:
        _log("no device kernels in the trace (the CPU has no device "
             "time); rate above still valid")
        return out
    by_cat = collections.Counter()
    for name, ms in by_name.items():
        by_cat[categorize(name)] += ms

    _log(f"\nsummed kernel time: {total:.1f} ms over {slots} slots "
         f"(overlapping kernels add up; wall = slots/s above)")
    _log(f"{'category':24s} {'ms':>9s} {'share':>7s}")
    for cat, ms in by_cat.most_common():
        _log(f"{cat:24s} {ms:9.2f} {ms / total:6.1%}")
    _log(f"\ntop {top} kernels:")
    _log(f"{'kernel':58s} {'ms':>8s} {'n':>6s} {'share':>7s}")
    for name, ms in by_name.most_common(top):
        _log(f"{name[:58]:58s} {ms:8.2f} {occ[name]:6d} {ms / total:6.1%}")
    out["categories"] = {k: round(v, 2) for k, v in by_cat.most_common()}
    out["top_ops"] = [{"op": n, "ms": round(ms, 2), "n": occ[n]}
                      for n, ms in by_name.most_common(top)]
    return out
