"""Full-schedule experiment script (scripts/full_run.py): train the whole
schedule, then greedy-evaluate the final learner against the SPS baseline
(train/evaluate.py), in one process, without a checkpoint round-trip.

    python -m diral_tpu_torch.scripts.full_run <config.yaml> <workdir>
        [--slots N] [--num-envs B] [--seed S] [--eval-steps 500]
        [--eval-envs 16] [--dtype D] [--save-freq N] [--device cuda|cpu]

Writes ``<workdir>/summary.json`` and prints it as one line: the JAX
script's keys (``config``, ``time_slots``, ``train_seconds``,
``slots_per_sec``, ``reward_curve_deciles``, ``compare_vs_sps``,
``eval_seconds``), then ``device`` (the card's name and power limit),
``resumed_from`` (the slot each restart resumed from), ``build_seconds``
(nvcc, before training), ``init_seconds`` and ``loop_seconds`` (the
runner's init -- warmup, pretrain, a restore -- and its slot loop;
``train_seconds`` is their sum) and ``launches``: how often each kernel
K1-K7 was launched in this start's ``train`` and ``eval`` (the wrappers'
counters; a start that resumed counts from its restore, all 0 on the
CPU).

Departures from the JAX script (ROADMAP Queue 3, run-management
departures); none changes a number of the run:

* ``--device cuda|cpu`` takes the place of ``--cpu``: the run is on the
  card unless ``--device cpu``, and raises where there is none.
* A run resumes.  A start in a workdir that holds a checkpoint continues
  from the newest (``train_experiment(resume=True)``; an empty workdir is
  a cold start), so a run can span calls that are cut.  ``save_results``
  is forced on with ``save_model``: the npy dumps re-seed the reward
  curve of the slots before the restore.  ``train_seconds`` and
  ``slots_per_sec`` cover the last start only: the slots it trained over
  its seconds.
* ``<workdir>/run.json`` holds the first start's config path (or the
  name of a config given in code), options and a hash of the loaded
  config; a later start with any difference
  refuses and names the field.
* ``--save-freq N`` overrides the config's ``save_freq``: how often the
  run checkpoints and dumps its results (and the size of its log
  chunks); the training is the same slot for slot.

What a run writes: ``save_model`` is forced on, as in the JAX script, so
a checkpoint lands every ``save_freq`` slots and at the end (the last 3
kept) and the best-reward snapshot beside it.  A 100v/50r checkpoint is
753,942,965 bytes (its replay ring), so its 100,000 slots at the config's
``save_freq`` 10,000 write 10 rolling checkpoints and up to 10 snapshots,
~15 GB; the toy's checkpoint (``memory_size`` 1024, 4 vehicles) is a few
MB.  ``seed_campaign`` runs this script with no checkpoint at all unless
it is given ``--save-freq``.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
import subprocess
import time

import numpy as np
import torch

from diral_tpu_torch.config import ExperimentConfig, load_config
from diral_tpu_torch.device import resolve_device
from diral_tpu_torch.train import checkpoint as ckpt
from diral_tpu_torch.train import evaluate, runner

_DTYPE = {"float32": torch.float32, "float64": torch.float64}


def configure(cfg: ExperimentConfig, slots=None, num_envs=None, dtype=None,
              save_freq=None) -> ExperimentConfig:
    """The JAX script's overrides (``--slots``, ``--num-envs``, ``--dtype``
    for the nets' compute dtype), plus ``--save-freq``."""
    if slots:
        cfg = dataclasses.replace(cfg, time_slots=slots)
    if num_envs:
        cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
            cfg.engine, num_envs=num_envs))
    if dtype:
        cfg = dataclasses.replace(cfg, agent=dataclasses.replace(
            cfg.agent, network=dataclasses.replace(
                cfg.agent.network, compute_dtype=dtype)))
    if save_freq:
        cfg = dataclasses.replace(cfg, save_freq=save_freq)
    return cfg


def decile_curve(sum_reward) -> list[float]:
    """Mean per-slot sum reward of env 0 over the schedule's tenths
    (scripts/full_run.py:70-74)."""
    sr = np.asarray(sum_reward)[:, 0]
    n10 = max(1, len(sr) // 10)
    return [round(float(sr[i * n10:(i + 1) * n10].mean()), 3)
            for i in range(10) if i * n10 < len(sr)]


def kernel_wrappers() -> dict:
    """{K1..K7: the wrapper that launches that kernel}; each wrapper adds
    one to its ``launches`` where it launches its kernel."""
    from diral_tpu_torch.ops import (channel_phase, lanes_hist, lstm_window,
                                     piggy_hist)

    return {"K1": lstm_window.lstm_last_flat,
            "K2": lstm_window.lstm_last_flat_triple,
            "K3": lstm_window.lstm_window_bwd,
            "K4": lstm_window.lstm_last_flat_dual,
            "K5": channel_phase.channel_phase,
            "K6": piggy_hist.piggy_histogram,
            "K7": lanes_hist.lanes_histogram}


def launch_counts() -> dict:
    """The K1-K7 wrappers' launch counters."""
    return {k: fn.launches for k, fn in kernel_wrappers().items()}


def _since(before: dict) -> dict:
    now = launch_counts()
    return {k: now[k] - before[k] for k in now}


def device_info(dev: torch.device) -> dict:
    """The device's name and, for a card, its power limit as nvidia-smi
    reads it (a card may be set below its maximum, and then runs slower)."""
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    limit = None
    try:
        smi = subprocess.run(
            ["nvidia-smi", "-i", str(idx), "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        limit = smi.stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        pass
    return {"name": torch.cuda.get_device_name(idx), "power_limit": limit}


def write_json(path: str, obj) -> None:
    """``obj`` to ``path`` through a temporary file, so a kill leaves the
    old file or the new one."""
    with open(path + ".tmp", "w") as f:
        json.dump(obj, f, indent=2)
    os.replace(path + ".tmp", path)


def guard(workdir: str, ident: dict) -> dict:
    """``<workdir>/run.json``: written at the first start with ``ident``
    (the config path, each option, the config's hash) and an empty
    ``resumed_from``; a later start with a different ``ident`` raises,
    naming the field.  Returns the record."""
    path = os.path.join(workdir, "run.json")
    if not os.path.exists(path):
        record = dict(ident, resumed_from=[])
        write_json(path, record)
        return record
    with open(path) as f:
        record = json.load(f)
    for key, value in ident.items():
        if record.get(key) != value:
            raise ValueError(
                f"{path}: {key} was {record.get(key)!r} at the run's first "
                f"start and is {value!r} now; this run continues only under "
                f"its own options (start it in a new workdir)")
    return record


def setup(config, *, name=None, slots=None, num_envs=None, seed=0,
          eval_steps=500, eval_envs=16, dtype=None, save_freq=None,
          device=None, campaign=False):
    """(the run's config, its device, its ``run.json`` identity).

    ``config``: a YAML path, or an ``ExperimentConfig`` with ``name``, the
    label that stands for it in ``run.json`` and the summary (ref_sweep's
    suite builds its configs in code).

    ``campaign``: seed_campaign's settings -- no model, result or
    position files, as in the JAX campaign, unless ``save_freq`` is given:
    then the run checkpoints every ``save_freq`` slots (rolling only, no
    best snapshot) and dumps its results for the reward curve of a
    resumed run."""
    dev = resolve_device(device)
    if isinstance(config, ExperimentConfig):
        if not name:
            raise ValueError("a config given as an ExperimentConfig needs "
                             "a name for run.json")
        base = config
    else:
        base, name = load_config(config), config
    cfg = configure(base, slots, num_envs, dtype, save_freq)
    if campaign:
        cfg = dataclasses.replace(cfg, save_model=False,
                                  save_results=save_freq is not None,
                                  save_positions=False)
    else:
        cfg = dataclasses.replace(cfg, save_model=True, save_results=True)
    ident = dict(config=name, slots=slots, num_envs=num_envs, seed=seed,
                 eval_steps=eval_steps, eval_envs=eval_envs, dtype=dtype,
                 save_freq=save_freq, device=dev.type, campaign=campaign,
                 config_sha256=hashlib.sha256(repr(cfg).encode()).hexdigest())
    return cfg, dev, ident


def run(config, workdir: str, *, seed=0, eval_steps=500, eval_envs=16,
        verbose=True, **options) -> dict:
    """Train ``config``'s schedule into ``workdir`` (resuming from its
    newest checkpoint), evaluate the final learner against SPS, write
    ``<workdir>/summary.json``; returns the summary.  ``config`` and
    ``options`` (``name`` among them): ``setup``'s."""
    cfg, dev, ident = setup(config, seed=seed, eval_steps=eval_steps,
                            eval_envs=eval_envs, **options)
    os.makedirs(workdir, exist_ok=True)
    record = guard(workdir, ident)
    # cfg.save_results is on exactly where the run checkpoints
    checkpoints = cfg.save_results
    start = ckpt.latest_step(runner.checkpoint_dir(cfg, workdir))
    if checkpoints and start is not None:
        record["resumed_from"].append(start)
        write_json(os.path.join(workdir, "run.json"), record)
    info = device_info(dev)
    if verbose:
        print(f"device: {info}", flush=True)

    t0 = time.perf_counter()
    if dev.type == "cuda":
        from diral_tpu_torch.ops import _build

        _build.build_all()
    build_s = time.perf_counter() - t0
    float_dtype = _DTYPE[cfg.engine.dtype]
    timing = {}
    counted = launch_counts()
    t0 = time.perf_counter()
    carry, logs = runner.train_experiment(
        cfg, workdir=workdir, seed=seed, resume=checkpoints,
        dtype=float_dtype, verbose=verbose, device=dev, timing=timing)
    train_s = time.perf_counter() - t0
    launches = {"train": _since(counted)}
    counted = launch_counts()
    curve = decile_curve(logs["sum_reward"])
    if verbose:
        print(f"train done in {train_s:.0f}s; curve(deciles)={curve}",
              flush=True)

    t0 = time.perf_counter()
    eval_cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, num_envs=eval_envs))
    # the rollouts are seeded 1, as JAX's PRNGKey(1)
    comp = evaluate.compare_drqn_vs_sps(eval_cfg, carry.learner.params, 1,
                                        steps=eval_steps, dtype=float_dtype,
                                        device=dev)
    launches["eval"] = _since(counted)
    summary = {
        "config": ident["config"],
        "time_slots": cfg.time_slots,
        "train_seconds": round(train_s, 1),
        "slots_per_sec": round((cfg.time_slots - timing["start_slot"])
                               / train_s, 1),
        "reward_curve_deciles": curve,
        "compare_vs_sps": comp,
        "eval_seconds": round(time.perf_counter() - t0, 1),
        "device": info,
        "resumed_from": record["resumed_from"],
        "build_seconds": round(build_s, 3),
        "init_seconds": round(timing["init_seconds"], 3),
        "loop_seconds": round(timing["loop_seconds"], 3),
        "launches": launches,
    }
    write_json(os.path.join(workdir, "summary.json"), summary)
    return summary


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m diral_tpu_torch.scripts.full_run",
        description="Train a config's full schedule, then evaluate it "
                    "against SPS; writes <workdir>/summary.json.")
    p.add_argument("config")
    p.add_argument("workdir")
    p.add_argument("--slots", type=int, default=None)
    p.add_argument("--num-envs", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--eval-steps", type=int, default=500)
    p.add_argument("--eval-envs", type=int, default=16)
    p.add_argument("--dtype", default=None,
                   help="network compute dtype override (e.g. bfloat16)")
    p.add_argument("--save-freq", type=int, default=None,
                   help="checkpoint and result-dump period in slots "
                        "(overrides the config's save_freq)")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    return p


def main(argv=None) -> dict:
    args = parser().parse_args(argv)
    summary = run(args.config, args.workdir, slots=args.slots,
                  num_envs=args.num_envs, seed=args.seed,
                  eval_steps=args.eval_steps, eval_envs=args.eval_envs,
                  dtype=args.dtype, save_freq=args.save_freq,
                  device=args.device)
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
