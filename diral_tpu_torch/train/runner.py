"""Host-side experiment runner (diral_tpu/train/runner.py): chunks of slots
on the device, the host reading the logs once per chunk to append them,
print the reference-style episode line, write ``metrics_sim*.jsonl``, dump
the npy results every ``save_freq`` slots (main_test.py:238-258) and
checkpoint (main_test.py:260-264; train/checkpoint.py).  The
multi-simulation outer loop matches ``marl_test``'s
``for simulation in range(simulations)`` (main_test.py:43-44).

Under a mesh (parallel/mesh.py; one process per device, joined by
parallel/distributed.py) each rank steps its env shard; the per-env logs
are all-gathered over the data group once per chunk, so every rank holds
the whole run's logs and takes the same checkpoint decisions, and only
process 0 writes the host-local artifacts (runner.py:165-175).
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from diral_tpu_torch.config import ExperimentConfig
from diral_tpu_torch.device import resolve_device
from diral_tpu_torch.parallel import distributed
from diral_tpu_torch.parallel import mesh as pmesh
from diral_tpu_torch.train import checkpoint as ckpt
from diral_tpu_torch.train.loop import Draws, make_train_functions
from diral_tpu_torch.train.metrics import ResultWriter


def _chunk_logs(logs, dtype, device, mesh=None):
    """Per-slot logs of one chunk -> host arrays (the chunk's one sync).
    Slots without a train event log a zero loss, as the JAX package does.
    Under a ``mesh`` the env-axis logs are all-gathered over the data
    group (the loss is replicated)."""
    zero = torch.zeros((), dtype=dtype, device=device)
    out = {
        "sum_reward": torch.stack([l["sum_reward"] for l in logs]),
        "actions": torch.stack([l["actions"] for l in logs]),
        "loss": torch.stack([zero if l["loss"] is None
                             else l["loss"].to(dtype) for l in logs]),
    }
    if logs[0]["pos_x"] is not None:
        out["pos_x"] = torch.stack([l["pos_x"] for l in logs])
    if mesh is not None:
        out.update({k: pmesh.all_gather(v, mesh, 1)
                    for k, v in out.items() if k != "loss"})
    out = {k: v.cpu().numpy() for k, v in out.items()}
    out["eps"] = np.asarray([l["eps"] for l in logs], np.float32)
    return out


def seeded_draws(cfg: ExperimentConfig, seed: int | None, simulation: int,
                 device) -> Draws:
    """A run's default draws: one generator on ``device`` seeded from
    (seed, simulation), seed defaulting to the config's."""
    base = cfg.engine.seed if seed is None else seed
    return Draws(torch.Generator(device=device).manual_seed(
        base * 1_000_003 + simulation))


def run_chunks(fns, carry, draws: Draws, t: int, end: int, chunk: int,
               dtype):
    """The slot loop from slot ``t`` to ``end`` in chunks of ``chunk``:
    yields (carry, slot after the chunk, the chunk's host logs, all
    envs' under a mesh).  Under a mesh ``draws`` are ``fns.sharded``'s."""
    while t < end:
        n = min(chunk, end - t)
        logs = []
        for s in range(t, t + n):
            carry, out = fns.slot_step(carry, s, draws)
            logs.append(out)
        t += n
        yield carry, t, _chunk_logs(logs, dtype, fns.device, fns.mesh)


def checkpoint_dir(cfg: ExperimentConfig, workdir: str,
                   simulation: int = 0) -> str:
    """Where ``train_experiment`` checkpoints simulation ``simulation``."""
    name = cfg.experiment_name or "experiment"
    return os.path.join(workdir, "save_model", "test",
                        name + (f"_sim{simulation}" if simulation else ""))


def train_experiment(cfg: ExperimentConfig, workdir: str = ".",
                     seed: int | None = None, chunk_size: int | None = None,
                     resume: bool = False, simulation: int = 0,
                     dtype=torch.float32, verbose: bool = True, mesh=None,
                     device=None, draws: Draws | None = None,
                     timing: dict | None = None):
    """Run one simulation of the experiment on ``device`` (default CUDA).
    Returns (carry, logs dict of host arrays: sum_reward [T, B], actions
    [T, B, N], loss [T], pos_x [T, B, N] when save_positions).

    ``draws`` defaults to a generator seeded from (seed, simulation); that
    generator's state is checkpointed with the carry, so ``resume``
    continues the run bit for bit.  Draws the caller passes in are used
    as given and not checkpointed.  With ``save_model`` or ``resume`` a
    checkpoint is written to ``<workdir>/save_model/test/<experiment>``
    every ``save_freq`` slots and at the end; ``save_model`` also keeps
    the snapshot of the best all-env chunk-mean sum reward in ``<dir>_best``
    with ``best_metric.json``.  ``resume`` on a directory without a
    checkpoint is a cold start.  Simulation k > 0 checkpoints into
    ``<experiment>_sim<k>``: the JAX package gives every simulation the
    one directory, so a later simulation overwrites the first one's
    checkpoints and resumes from its final slot.

    ``mesh``: a parallel/mesh.py ``Mesh`` or a spec string like
    ``"data=2"`` / ``"data=2,model=2"``; this process is one of its ranks
    (parallel/distributed.initialize, one process per device).  Env
    instances shard over "data", the learner is replicated (over "model"
    too); the results are the one-device run's bit for bit.  The
    returned logs cover every env on every rank; only process 0 writes
    files, and checkpoints are the one-device files.

    ``timing``, when given, receives the slot the loop started from
    (``start_slot``: 0, or the restored checkpoint's), ``init_seconds``
    (from the call to the first slot: the carry's init, warmup, pretrain
    and any restore) and ``loop_seconds`` (the slot loop, its checkpoint
    writes included); each chunk's host read of its logs ends its device
    work, so the two add up to the call's wall time."""
    started = time.perf_counter()
    if isinstance(mesh, str):
        mesh = pmesh.mesh_from_spec(mesh)
    if mesh is not None and cfg.engine.num_envs % mesh.data:
        raise ValueError(
            f"num_envs={cfg.engine.num_envs} must be divisible by the "
            f"data-axis size {mesh.data} (--mesh)")
    dev = resolve_device(device)
    trace = None
    if cfg.env.load_positions:
        # recorded-mobility replay fixture (main_test.py:118)
        trace = np.load(cfg.env.load_file_pos)
        if verbose:
            print(f"Load the saved positions !!! ({trace.shape})")
    fns = make_train_functions(cfg, dtype, dev, trace, mesh)
    chunk = chunk_size or max(1, min(cfg.save_freq, 5000))
    gen = None
    if draws is None:
        draws = seeded_draws(cfg, seed, simulation, dev)
        gen = draws.gen
    draws = fns.sharded(draws)
    carry = fns.init_carry(draws)

    name = cfg.experiment_name or "experiment"
    ckpt_dir = checkpoint_dir(cfg, workdir, simulation)
    # the best-reward snapshot: greedy evaluation can take the policy
    # from before a collapse at the greedy switch (eval --best)
    best_dir = ckpt_dir + "_best"
    marker = os.path.join(best_dir, "best_metric.json")
    best_metric = float("-inf")
    if cfg.save_model and resume and os.path.exists(marker):
        with open(marker) as f:
            best_metric = json.load(f)["mean_sum_reward"]
    t = 0
    if resume:
        # a restart loop passes --resume unconditionally: an empty
        # checkpoint directory is a cold start, not an error
        if ckpt.latest_step(ckpt_dir) is None:
            if verbose:
                print("no checkpoint yet; starting fresh")
        else:
            carry, t = ckpt.restore(ckpt_dir, carry, gen, mesh=mesh)
            if verbose:
                print(f"resumed from slot {t}")
    # every rank has read the checkpoint directory before rank 0 writes
    # there: a model replica shares no collective with rank 0 that would
    # otherwise hold it back
    if mesh is not None:
        pmesh.barrier(mesh)

    # host-local artifacts are process 0's alone under a mesh
    primary = distributed.is_primary()
    writer = ResultWriter(workdir, name, simulation) if primary else None
    rewards, actions, positions, losses = [], [], [], []
    if t > 0 and primary:
        # the npy dumps cover the whole run: re-seed them with the slots
        # already dumped; losses are not dumped, so those slots get NaN
        prev_r, prev_a, prev_p = writer.load_arrays(upto=t)
        if prev_r is not None:
            rewards.append(prev_r)
            losses.append(np.full((prev_r.shape[0],), np.nan, np.float32))
        if prev_a is not None:
            actions.append(prev_a)
        if cfg.save_positions and prev_p is not None:
            positions.append(prev_p)

    start_slot, looped = t, time.perf_counter()
    for carry, t, logs in run_chunks(fns, carry, draws, t, cfg.time_slots,
                                     chunk, dtype):
        rewards.append(logs["sum_reward"])
        actions.append(logs["actions"])
        losses.append(logs["loss"])
        if "pos_x" in logs:
            positions.append(logs["pos_x"])
        eps = float(logs["eps"][-1])
        mean_r = float(logs["sum_reward"][:, 0].mean())
        due = t % cfg.save_freq == 0 or t >= cfg.time_slots
        if writer is not None:
            if verbose:
                writer.episode_line(t - 1, eps,
                                    cfg.env.num_channels - mean_r, mean_r)
            # "seconds": this start's slot loop so far (the port's addition)
            writer.log({"slot": t, "eps": eps, "mean_sum_reward": mean_r,
                        "loss": float(logs["loss"][-1]),
                        "seconds": round(time.perf_counter() - looped, 3)})
        if writer is not None and cfg.save_results and due:
            writer.save_arrays(np.concatenate(rewards),
                               np.concatenate(actions),
                               np.concatenate(positions) if positions
                               else None)
        # a resumed run writes checkpoints too, or the next restart has
        # nothing to load
        # (every rank saves: the gathers are collective)
        if (cfg.save_model or resume) and due:
            ckpt.save(ckpt_dir, t, carry, gen, mesh=mesh)
            all_env_mean = float(logs["sum_reward"].mean())
            if cfg.save_model and all_env_mean > best_metric:
                best_metric = all_env_mean
                ckpt.save(best_dir, t, carry, gen, max_to_keep=1, mesh=mesh)
                if primary:
                    with open(marker, "w") as f:
                        json.dump({"step": t,
                                   "mean_sum_reward": best_metric}, f)
    if writer is not None:
        writer.close()
    if timing is not None:
        timing.update(start_slot=start_slot,
                      init_seconds=looped - started,
                      loop_seconds=time.perf_counter() - looped)
    out = {"sum_reward": np.concatenate(rewards),
           "actions": np.concatenate(actions),
           "loss": np.concatenate(losses)}
    if positions:
        out["pos_x"] = np.concatenate(positions)
    return carry, out


def run_all_simulations(cfg: ExperimentConfig, workdir: str = ".", **kw):
    """marl_test's outer loop (main_test.py:43-44); a ``mesh`` spec is
    built once for all simulations."""
    if isinstance(kw.get("mesh"), str):
        kw["mesh"] = pmesh.mesh_from_spec(kw["mesh"])
    results = []
    for sim in range(cfg.simulations):
        print(f"-=-= experiment: {cfg.experiment_name} SIMULATION "
              f"{sim + 1} =-=-")
        results.append(train_experiment(cfg, workdir, simulation=sim, **kw))
    return results
