"""What the PPO and PS-DQN / PS-DRQN campaign drivers share
(``ppo_campaign.py``, ``ps_campaign.py``): per-seed workdirs under the
``run.json`` guard, a finished seed's row read back, an open seed resumed
from its newest checkpoint, J open seeds trained at once, and the band
checks against the JAX package's artifacts.

A seed's workdir holds ``run.json`` (``full_run.guard``: the first
start's options and config hash; a start under others refuses),
``ckpt/ckpt_<episodes>.pt`` (with ``--save-freq N``: every N episodes and
at the end, the last 3 kept; ``checkpoint.save_ppo`` / ``save_ps``) and,
once the seed is done, ``summary.json`` (its row).  Without
``--save-freq`` a seed writes no checkpoint, as the JAX scripts, and a
cut seed starts again from episode 0.

``train_s`` of a row is the loop seconds of every segment that made the
result, summed: each segment's from its start (or restore) to its last
checkpoint, and the last segment's to its end; the seconds a cut segment
spent after its last checkpoint are not counted, since its episodes run
again.  ``slots_per_sec`` is the schedule's slots over ``train_s``.  The
JAX scripts time one uncut run from its first call, compile included.
"""

from __future__ import annotations

import json
import math
import multiprocessing
import os
import time
from concurrent.futures import ProcessPoolExecutor

import torch

from diral_tpu_torch.scripts import full_run
from diral_tpu_torch.train import checkpoint as ckpt

# a row's fields that say how and where its seed ran, not what it learned
RUN_FIELDS = ("train_s", "slots_per_sec", "device", "resumed_from")


def open_seed(workdir: str, ident: dict) -> dict:
    """The seed's ``run.json`` record (written at its first start; a start
    with another ``ident`` raises, naming the field)."""
    os.makedirs(workdir, exist_ok=True)
    return full_run.guard(workdir, ident)


def train(fns, draws, episodes: int, workdir: str, record: dict,
          save_freq, restore, save):
    """``fns.run`` over ``episodes`` episodes.  With ``save_freq`` it
    resumes from the newest checkpoint in ``<workdir>/ckpt``
    (``restore(directory)`` -> ``checkpoint.EpisodeStart``, setting the
    draws' generator; the episode is appended to ``resumed_from``) and
    checkpoints every ``save_freq`` episodes and after the last
    (``save(directory, episodes_done, carry, logs, seconds)``).  Returns
    (``fns.run``'s result, logs, loop seconds of every segment)."""
    directory = os.path.join(workdir, "ckpt")
    start = None
    if save_freq and ckpt.latest_step(directory) is not None:
        start = restore(directory)
        record["resumed_from"].append(start.episode)
        full_run.write_json(os.path.join(workdir, "run.json"), record)
    base = start.seconds if start is not None else 0.0
    t0 = time.perf_counter()

    def seconds():
        if fns.device.type == "cuda":
            torch.cuda.synchronize(fns.device)
        return base + time.perf_counter() - t0

    def after(done, carry, logs):
        if done % save_freq == 0 or done == episodes:
            save(directory, done, carry, logs(), seconds())
    result, logs = fns.run(draws, episodes, start=start,
                           after_episode=after if save_freq else None)
    return result, logs, seconds()


def finish(workdir: str, row: dict) -> dict:
    full_run.write_json(os.path.join(workdir, "summary.json"), row)
    return row


def run_seeds(tasks: dict, run_seed, ident, jobs: int = 1) -> list:
    """The rows of ``tasks`` ({key: ``run_seed``'s keyword arguments, one
    of them ``workdir``}), in their order.  A task whose ``summary.json``
    exists is read back after its ``run.json`` accepts ``ident(**kw)``;
    the others run, ``jobs`` at a time, one process each."""
    rows = {}
    for key, kw in tasks.items():
        path = os.path.join(kw["workdir"], "summary.json")
        if os.path.exists(path):
            full_run.guard(kw["workdir"], ident(**kw))
            with open(path) as f:
                rows[key] = json.load(f)
            print(f"{key}: finished earlier, its row read back", flush=True)
    todo = [k for k in tasks if k not in rows]
    if jobs > 1 and len(todo) > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(min(jobs, len(todo)), mp_context=ctx) as ex:
            futures = {k: ex.submit(run_seed, **tasks[k]) for k in todo}
            for k in todo:
                rows[k] = futures[k].result()
                print(f"{k}: {json.dumps(rows[k])}", flush=True)
    else:
        for k in todo:
            rows[k] = run_seed(**tasks[k])
            print(f"{k}: {json.dumps(rows[k])}", flush=True)
    return [rows[k] for k in tasks]


def mean_std(values) -> tuple[float, float]:
    """Mean and population std (ddof 0), as scripts/render_results.py:200
    computes them."""
    n = len(values)
    mean = sum(values) / n
    return mean, (sum((x - mean) ** 2 for x in values) / n) ** 0.5


def band(port, jax) -> dict:
    """The band test of two seed samples: |mean difference| <= 3 *
    sqrt(s_jax^2 / n_jax + s_port^2 / n_port), population stds."""
    pm, ps = mean_std(port)
    jm, js = mean_std(jax)
    limit = 3.0 * math.sqrt(js ** 2 / len(jax) + ps ** 2 / len(port))
    return {"port_mean": pm, "port_std": ps, "port_n": len(port),
            "jax_mean": jm, "jax_std": js, "jax_n": len(jax),
            "abs_diff": abs(pm - jm), "limit": limit,
            "inside": abs(pm - jm) <= limit}


def reference_runs(path: str | None):
    """The ``runs`` of the JAX package's artifact at ``path``, or None
    where there is none."""
    if not path or not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)["runs"]


def write(out: str, summary: dict) -> dict:
    if os.path.dirname(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
    full_run.write_json(out, summary)
    print(json.dumps({k: v for k, v in summary.items() if k != "runs"}),
          flush=True)
    return summary
