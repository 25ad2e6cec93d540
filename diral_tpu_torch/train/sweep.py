"""Multi-seed training (diral_tpu/train/sweep.py): one experiment per seed.

The JAX package vmaps its whole training step over a leading seed axis, so
a sweep is one compiled program.  Here the seeds run one after another
through the runner's own chunk loop (runner.run_chunks), each drawing from
the generator ``runner.train_experiment(cfg, seed=s, simulation=0)``
seeds, so every row of the sweep IS that standalone run.  A batched seed
axis on the card is later work (ROADMAP Queue 1).
"""

from __future__ import annotations

import numpy as np
import torch

from diral_tpu_torch.config import ExperimentConfig
from diral_tpu_torch.device import resolve_device
from diral_tpu_torch.train.loop import make_train_functions
from diral_tpu_torch.train.runner import run_chunks, seeded_draws


def run_seed_sweep(cfg: ExperimentConfig, seeds, chunk_size: int = 5000,
                   dtype=torch.float32, verbose: bool = True, device=None):
    """Train len(seeds) independent experiments on ``device`` (default
    CUDA).  Returns (carries, logs): one carry per seed, logs["sum_reward"]
    [S, time_slots, num_envs] and logs["loss"] [S, time_slots]."""
    dev = resolve_device(device)
    fns = make_train_functions(cfg, dtype, dev)
    chunk = max(1, min(cfg.save_freq, chunk_size))
    carries, rewards, losses = [], [], []
    for s in seeds:
        draws = seeded_draws(cfg, s, 0, dev)
        carry = fns.init_carry(draws)
        r, l = [], []
        for carry, t, logs in run_chunks(fns, carry, draws, 0,
                                         cfg.time_slots, chunk, dtype):
            r.append(logs["sum_reward"])
            l.append(logs["loss"])
            if verbose:
                print(f"seed {s} slot {t}: mean sum_r "
                      f"{logs['sum_reward'][:, 0].mean():.3f}", flush=True)
        carries.append(carry)
        rewards.append(np.concatenate(r))
        losses.append(np.concatenate(l))
    return carries, {"sum_reward": np.stack(rewards),
                     "loss": np.stack(losses)}


def split_seed(carries, i: int):
    """Seed ``i``'s full training state (e.g. to evaluate its policy with
    train/evaluate.py)."""
    return carries[i]
