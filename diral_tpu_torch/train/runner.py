"""Host-side experiment runner (diral_tpu/train/runner.py): chunks of slots
on the device, the host reading the logs once per chunk to append them,
print the reference-style episode line, write ``metrics_sim*.jsonl`` and
dump the npy results every ``save_freq`` slots (main_test.py:238-258).
The multi-simulation outer loop matches ``marl_test``'s
``for simulation in range(simulations)`` (main_test.py:43-44).

Not in this slice: checkpoints (``save_model``, ``resume``; ROADMAP
Queue 1 item 4) and a device mesh (item 9) -- both raise.
"""

from __future__ import annotations

import numpy as np
import torch

from diral_tpu_torch.config import ExperimentConfig
from diral_tpu_torch.device import resolve_device
from diral_tpu_torch.train.loop import Draws, make_train_functions
from diral_tpu_torch.train.metrics import ResultWriter


def _chunk_logs(logs, dtype, device):
    """Per-slot logs of one chunk -> host arrays (the chunk's one sync).
    Slots without a train event log a zero loss, as the JAX package does."""
    zero = torch.zeros((), dtype=dtype, device=device)
    out = {
        "sum_reward": torch.stack([l["sum_reward"] for l in logs]),
        "actions": torch.stack([l["actions"] for l in logs]),
        "loss": torch.stack([zero if l["loss"] is None
                             else l["loss"].to(dtype) for l in logs]),
    }
    if logs[0]["pos_x"] is not None:
        out["pos_x"] = torch.stack([l["pos_x"] for l in logs])
    out = {k: v.cpu().numpy() for k, v in out.items()}
    out["eps"] = np.asarray([l["eps"] for l in logs], np.float32)
    return out


def train_experiment(cfg: ExperimentConfig, workdir: str = ".",
                     seed: int | None = None, chunk_size: int | None = None,
                     resume: bool = False, simulation: int = 0,
                     dtype=torch.float32, verbose: bool = True, mesh=None,
                     device=None, draws: Draws | None = None):
    """Run one simulation of the experiment on ``device`` (default CUDA).
    Returns (carry, logs dict of host arrays: sum_reward [T, B], actions
    [T, B, N], loss [T], pos_x [T, B, N] when save_positions).  ``draws``
    defaults to a generator seeded from (seed, simulation)."""
    if resume or cfg.save_model:
        raise NotImplementedError(
            "checkpoints (save_model / --resume) are not ported yet "
            "(ROADMAP Queue 1 item 4, Checkpoint)")
    if mesh is not None:
        raise NotImplementedError(
            "a device mesh is not ported yet (ROADMAP Queue 1 item 9, "
            "Parallel)")
    dev = resolve_device(device)
    trace = None
    if cfg.env.load_positions:
        # recorded-mobility replay fixture (main_test.py:118)
        trace = np.load(cfg.env.load_file_pos)
        if verbose:
            print(f"Load the saved positions !!! ({trace.shape})")
    fns = make_train_functions(cfg, dtype, dev, trace)
    chunk = chunk_size or max(1, min(cfg.save_freq, 5000))
    if draws is None:
        base = cfg.engine.seed if seed is None else seed
        gen = torch.Generator(device=dev).manual_seed(
            base * 1_000_003 + simulation)
        draws = Draws(gen)
    carry = fns.init_carry(draws)

    writer = ResultWriter(workdir, cfg.experiment_name or "experiment",
                          simulation)
    parts = []
    t = 0
    while t < cfg.time_slots:
        n = min(chunk, cfg.time_slots - t)
        logs = []
        for s in range(t, t + n):
            carry, out = fns.slot_step(carry, s, draws)
            logs.append(out)
        parts.append(_chunk_logs(logs, dtype, dev))
        t += n

        eps = float(parts[-1]["eps"][-1])
        mean_r = float(parts[-1]["sum_reward"][:, 0].mean())
        if verbose:
            writer.episode_line(t - 1, eps, cfg.env.num_channels - mean_r,
                                mean_r)
        writer.log({"slot": t, "eps": eps, "mean_sum_reward": mean_r,
                    "loss": float(parts[-1]["loss"][-1])})
        if cfg.save_results and (t % cfg.save_freq == 0
                                 or t >= cfg.time_slots):
            cat = {k: np.concatenate([p[k] for p in parts])
                   for k in parts[0]}
            writer.save_arrays(cat["sum_reward"], cat["actions"],
                               cat.get("pos_x"))
    writer.close()
    out = {k: np.concatenate([p[k] for p in parts])
           for k in ("sum_reward", "actions", "loss", "pos_x")
           if k in parts[0]}
    return carry, out


def run_all_simulations(cfg: ExperimentConfig, workdir: str = ".", **kw):
    """marl_test's outer loop (main_test.py:43-44)."""
    results = []
    for sim in range(cfg.simulations):
        print(f"-=-= experiment: {cfg.experiment_name} SIMULATION "
              f"{sim + 1} =-=-")
        results.append(train_experiment(cfg, workdir, simulation=sim, **kw))
    return results
