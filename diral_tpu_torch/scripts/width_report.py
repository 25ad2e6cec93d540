"""BASELINE configs[4] at width on one card (scripts/width_report.py's
counterpart): the per-env memory arithmetic of 100v/50r as a function of
the env count B, a short measured training run at the largest
power-of-two B one card holds, and the card count for the full 8192-env
config.

The memory model, per env, from the port's carry shapes:

  replay ring   [S + pad, N*Dp] * itemsize   (agents/replay.py, pad = T)
  history       [N, T*Dp]       * itemsize
  env state     4 [N, N] + last_arrival [N, N] (4-byte) tables, 5 [N]
                vectors, prev_obs [N, C]
  the rest      state [N, D], the shaping counters and previous actions

The learner, Adam and the train event's gathered batch do not grow with B.
``GATHER_COPY_FACTOR`` is 1: XLA:TPU copies the whole replay ring for
the window gather (the JAX script's factor 2); the port's gather
(train/loop.py) indexes the ring in place and copies only the batch.  The
measured run checks that: it reports ``torch.cuda.max_memory_allocated``
per env beside the model's bytes.

The budget is the card's ``total_memory`` x ``BUDGET``; without a card
(``--no-run --device cpu``) the nominal ``H100_NOMINAL_BYTES``.

Usage:
    python -m diral_tpu_torch.scripts.width_report [--config YAML]
        [--envs B] [--slots 2000] [--dtype float32|bfloat16] [--out FILE]
        [--no-run] [--device cuda|cpu]
Prints the report on stdout; a run on the card writes it to ``--out``
(default results/torch_width_scale.json); a CPU run writes a file only to
an ``--out`` it is given.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import torch

from diral_tpu_torch.bench import ROOT, card, log

DEFAULT_OUT = os.path.join(ROOT, "results", "torch_width_scale.json")
BUDGET = 0.85                   # headroom for the slot's working set
GATHER_COPY_FACTOR = 1.0        # the gather copies the batch, not the ring
H100_NOMINAL_BYTES = 80 * 10**9  # "80 GB": the budget without a card
# H100 SXM NVLink 4 spec figure (bidirectional aggregate per GPU): turns
# the sampler's bytes into a PROJECTED time, not a measurement
NVLINK_SPEC_BYTES_PER_S = 900e9
FULL_CONFIG_ENVS = 8192         # BASELINE.json configs[4]


def per_env_bytes(cfg, itemsize: int) -> dict:
    from diral_tpu_torch.ops.lstm_window import padded_dim

    N, C, D = cfg.env.num_users, cfg.env.num_channels, cfg.env.state_space
    T = cfg.agent.step_size
    window = T if cfg.agent.network.use_lstm_input else 1
    Dp = padded_dim(D)
    replay = (cfg.memory_size + window) * N * Dp * itemsize
    history = N * T * Dp * itemsize
    env = 5 * N * N * 4 + 5 * N * 4 + N * C * 4
    rest = N * D * 4 + 4 + 2 * N * 4
    return {"replay": replay, "history": history, "env_state": env,
            "carry_rest": rest, "total": replay + history + env + rest}


def memory_model(cfg, memory_bytes: int) -> dict:
    """{dtype label: the per-env bytes and the largest B} for float32 and
    bf16 storage of the ring and the history."""
    budget = memory_bytes * BUDGET
    out = {}
    for name, item in (("float32", 4), ("bfloat16_storage", 2)):
        pe = per_env_bytes(cfg, item)
        peak = pe["total"] + (GATHER_COPY_FACTOR - 1) * pe["replay"]
        bmax = int(budget // peak)
        out[name] = {
            "per_env_bytes": pe,
            "per_env_mb": round(pe["total"] / 2**20, 2),
            "per_env_peak_mb_with_gather_copy": round(peak / 2**20, 2),
            "largest_B_one_chip": bmax,
            "largest_pow2_B": 1 << (bmax.bit_length() - 1),
        }
    return out


def measured_run(cfg, B: int, slots: int, dtype: str, dev) -> dict:
    """Train ``B`` envs from slot ``batch_size + 100`` (rounded up to an
    episode): one chunk of ``slots`` to warm, then three timed; the
    median rate."""
    from diral_tpu_torch.train.loop import make_train_functions
    from diral_tpu_torch.train.runner import run_chunks, seeded_draws

    run_cfg = dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine, num_envs=B),
        agent=dataclasses.replace(cfg.agent, network=dataclasses.replace(
            cfg.agent.network, compute_dtype=dtype)))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t = time.perf_counter()
    fns = make_train_functions(run_cfg, torch.float32, dev)
    draws = seeded_draws(run_cfg, 0, 0, dev)
    carry = fns.init_carry(draws)
    init_s = time.perf_counter() - t
    I = run_cfg.episode_interval
    t0 = (run_cfg.agent.batch_size + 100 + I - 1) // I * I
    times = []
    for i in range(4):
        t = time.perf_counter()
        start = t0 + i * slots
        # the chunk's host read of its logs ends its device work
        for carry, _, _ in run_chunks(fns, carry, draws, start,
                                      start + slots, slots, torch.float32):
            pass
        times.append(time.perf_counter() - t)
    rate = sorted(slots / s for s in times[1:])[1]
    N = run_cfg.env.num_users
    run = {
        "num_envs": B, "slots": slots, "dtype": dtype,
        "init_s": round(init_s, 3),
        "compile_plus_first_s": round(times[0], 3),
        "slots_per_sec": round(rate, 2),
        "env_slots_per_sec": round(rate * B, 1),
        "agent_steps_per_sec": round(rate * B * N, 1),
    }
    if dev.type == "cuda":
        peak = torch.cuda.max_memory_allocated(dev)
        run["peak_bytes"] = peak
        run["measured_peak_bytes_per_env"] = round(peak / B)
    return run


def main(argv=None) -> dict:
    from diral_tpu_torch.config import load_config
    from diral_tpu_torch.device import resolve_device
    from diral_tpu_torch.train.loop import sampler_collective_bytes

    p = argparse.ArgumentParser(prog="width_report")
    p.add_argument("--config",
                   default=os.path.join(ROOT, "configs",
                                        "scale_100v_50r.yaml"))
    p.add_argument("--envs", type=int, default=None,
                   help="override the measured run's env count")
    p.add_argument("--slots", type=int, default=2000)
    p.add_argument("--dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--out", default=None)
    p.add_argument("--no-run", action="store_true",
                   help="arithmetic only, skip the measured run")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = load_config(args.config)

    card_line = card(dev)
    if dev.type == "cuda":
        mem = torch.cuda.get_device_properties(dev).total_memory
        source = "torch.cuda total_memory"
    else:
        mem, source = H100_NOMINAL_BYTES, "nominal H100 80 GB (no card)"
    log(f"card: {card_line}; memory {mem:,} B ({source}), budget "
        f"{BUDGET:.0%}")
    out = {"config": os.path.relpath(args.config, ROOT), "card": card_line,
           "memory_bytes": mem, "memory_source": source,
           "budget_fraction": BUDGET,
           "gather_copy_factor": GATHER_COPY_FACTOR,
           "hbm_model": memory_model(cfg, mem)}
    for name, m in out["hbm_model"].items():
        log(f"{name}: {m['per_env_mb']:.2f} MiB/env "
            f"(replay {m['per_env_bytes']['replay'] / 2**20:.2f}) -> B_max "
            f"{m['largest_B_one_chip']} (pow2 {m['largest_pow2_B']})")

    # the full config sharded over cards: the sampler's gathered batch is
    # the one collective of a train event (train/loop.py)
    coll = sampler_collective_bytes(cfg)
    out["sampler_collective"] = coll
    ms = coll["ring_bytes_per_device_per_event"] / NVLINK_SPEC_BYTES_PER_S
    for m in out["hbm_model"].values():
        m["chips_for_8192_envs"] = max(1, FULL_CONFIG_ENVS
                                       // m["largest_pow2_B"])
        m["ring_bytes_per_device_per_event"] = (
            coll["ring_bytes_per_device_per_event"])
        m["collective_ms_per_event_at_nvlink_spec"] = round(ms * 1e3, 3)
    log(f"sampler collective: {coll['bytes_per_event'] / 2**20:.1f} MiB "
        f"gathered a train event, ring "
        f"{coll['ring_bytes_per_device_per_event'] / 2**20:.1f} MiB a "
        f"device -> {ms * 1e3:.3f} ms projected at the NVLink spec figure "
        f"({NVLINK_SPEC_BYTES_PER_S / 1e9:.0f} GB/s; not measured)")

    if not args.no_run:
        key = "bfloat16_storage" if args.dtype == "bfloat16" else "float32"
        model = out["hbm_model"][key]
        B = args.envs or model["largest_pow2_B"]
        log(f"measured run: B={B}, 4 x {args.slots} slots, {args.dtype}")
        run = measured_run(cfg, B, args.slots, args.dtype, dev)
        pe = model["per_env_bytes"]
        run["modelled_peak_bytes_per_env"] = round(
            pe["total"] + (GATHER_COPY_FACTOR - 1) * pe["replay"])
        out["measured_run"] = run
        log(f"B={B}: {run['slots_per_sec']:,.2f} slots/s = "
            f"{run['env_slots_per_sec']:,.0f} env-slots/s = "
            f"{run['agent_steps_per_sec']:,.0f} agent-steps/s (median of 3)"
            + (f"; peak {run['measured_peak_bytes_per_env'] / 2**20:.2f} "
               f"MiB/env measured vs "
               f"{run['modelled_peak_bytes_per_env'] / 2**20:.2f} modelled"
               if "peak_bytes" in run else ""))

    print(json.dumps(out), flush=True)
    path = args.out or (DEFAULT_OUT if dev.type == "cuda" else None)
    if path:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
        log(f"wrote {path}")
    return out


if __name__ == "__main__":
    main()
