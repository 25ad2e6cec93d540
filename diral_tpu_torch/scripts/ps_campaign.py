"""PS-DQN / PS-DRQN campaign (scripts/ps_campaign.py): both
parameter-shared flavours on the toy 4ue/3r scenario under the full
episode schedule, ``--seeds`` seeds each, every trained policy
greedy-evaluated against SPS (``--eval-steps`` slots x 16 envs,
train/evaluate.compare_ps_vs_sps, seeded ``100 + seed``).  The config is
the JAX script's: ``toy_4ue_3r(save_positions=False)`` with ``num_envs
= --num-envs``, ``batch_size`` 64 and ``target_update`` 1000 (the
reference PS agents' own defaults, ps_dqn.py:58-61).

    python -m diral_tpu_torch.scripts.ps_campaign [--seeds 3]
        [--episodes N] [--num-envs 16] [--eval-steps 500]
        [--out results/torch_ps_campaign.json] [--save-freq N]
        [--workdir ROOT] [--jobs J] [--device cuda|cpu]
        [--reference results/ps_campaign.json]

``out`` has the JAX artifact's keys (``config``, ``episodes``,
``num_envs``, ``eval_steps``, ``runs``: PS-DQN's seeds, then PS-DRQN's),
each row JAX's (``algo``, ``seed``, ``train_s``, ``slots_per_sec``,
``curve_deciles``, ``final_decile_sum_r``, ``compare_vs_sps``) plus
``device`` and ``resumed_from``; the artifact adds ``seeds`` (n per
algo), ``cli``, ``device`` and, where the JAX artifact ``--reference``
exists, ``checks`` (``checks`` below).

Departures from the JAX script, as in ppo_campaign.py (ROADMAP Queue 3):
``--device``, the eval's generator, the port's own default ``--out``,
per-seed workdirs ``<ROOT>/<algo>/seed<k>/`` resumable with
``--save-freq N`` episodes, ``--jobs J`` open runs at once (over both
algorithms), ``train_s`` summed over segments.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import shlex
import sys

import numpy as np
import torch

from diral_tpu_torch.config import toy_4ue_3r
from diral_tpu_torch.device import resolve_device
from diral_tpu_torch.scripts import episode_campaign as ec
from diral_tpu_torch.scripts import full_run
from diral_tpu_torch.train import checkpoint as ckpt
from diral_tpu_torch.train import evaluate, ps_loop

CONFIG = ("toy_4ue_3r + PS defaults (batch 64, target_update 1000, "
          "training_freq 1, unroll 8)")
# a run that holds one channel per user for good: every receiver in range
# decodes its nearest transmitter (PRR near 1) while the channels collide
# (sum reward near -16 at 4 users, the JAX artifact's collapsed rows)
COLLAPSE_PRR, COLLAPSE_REWARD = 0.95, -15.0


def ps_config(num_envs: int = 16):
    """The JAX script's config (scripts/ps_campaign.py:53-58)."""
    cfg = toy_4ue_3r(save_positions=False)
    return dataclasses.replace(
        cfg, engine=dataclasses.replace(cfg.engine, num_envs=num_envs),
        agent=dataclasses.replace(cfg.agent, batch_size=64,
                                  target_update=1000))


def setup(algo: str, *, seed=0, episodes=None, num_envs=16, eval_steps=500,
          save_freq=None, device=None, **_):
    """(config, device, episodes, the run's ``run.json`` identity)."""
    dev = resolve_device(device)
    cfg = ps_config(num_envs)
    episodes = episodes or cfg.time_slots // cfg.episode_interval
    ident = dict(algo=algo, seed=seed, episodes=episodes, num_envs=num_envs,
                 eval_steps=eval_steps, save_freq=save_freq, device=dev.type,
                 config_sha256=hashlib.sha256(repr(cfg).encode()).hexdigest())
    return cfg, dev, episodes, ident


def run_seed(algo: str, workdir: str, *, seed=0, episodes=None, num_envs=16,
             eval_steps=500, save_freq=None, device=None) -> dict:
    """Train ``algo`` seed ``seed`` into ``workdir`` (resuming with
    ``save_freq``), evaluate it against SPS, write ``summary.json``;
    returns the row."""
    cfg, dev, episodes, ident = setup(
        algo, seed=seed, episodes=episodes, num_envs=num_envs,
        eval_steps=eval_steps, save_freq=save_freq, device=device)
    record = ec.open_seed(workdir, ident)
    fns = ps_loop.make_ps_functions(cfg, algo, device=dev)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    carry, logs, train_s = ec.train(
        fns, ps_loop.PSDraws(gen), episodes, workdir, record, save_freq,
        lambda d: ckpt.restore_ps(d, algo, cfg.agent, dev, gen),
        lambda d, e, c, logs, s: ckpt.save_ps(d, e, c, logs, algo, gen, s))
    r = np.asarray(logs["mean_sum_reward"], np.float64)
    n10 = max(1, len(r) // 10)
    curve = [round(float(r[i * n10:(i + 1) * n10].mean()), 3)
             for i in range(10) if i * n10 < len(r)]
    comp = evaluate.compare_ps_vs_sps(cfg, carry.learner.params, 100 + seed,
                                      steps=eval_steps, algo=algo,
                                      device=dev)
    return ec.finish(workdir, {
        "algo": algo, "seed": seed, "train_s": round(train_s, 1),
        "slots_per_sec": round(episodes * cfg.episode_interval / train_s, 1),
        "curve_deciles": curve, "final_decile_sum_r": curve[-1],
        "compare_vs_sps": comp, "device": full_run.device_info(dev),
        "resumed_from": record["resumed_from"]})


def collapsed(row) -> bool:
    """A fixed-assignment collapse: the policy's PRR >= 0.95 with a mean
    sum reward <= -15 (at 4 users)."""
    own = row["compare_vs_sps"][row["algo"].replace("-", "_")]
    return (own["mean_prr"] >= COLLAPSE_PRR
            and own["mean_sum_reward"] <= COLLAPSE_REWARD)


def checks(runs, reference) -> dict:
    """Per algorithm, against the JAX artifact's runs: ΔPRR and SPS PRR in
    the band; each run labelled a collapse or a learner; the collapse
    count and the learners' ΔPRR range beside JAX's (reported, not held:
    at n = 5 the count is a binomial draw)."""
    out = {}
    for algo in ps_loop.ALGOS:
        mine = [r for r in runs if r["algo"] == algo]
        ref = [r for r in reference if r["algo"] == algo]
        if not mine or not ref:
            continue

        def delta(rs):
            return [r["compare_vs_sps"]["prr_improvement"] for r in rs]

        def learners(rs):
            d = [r["compare_vs_sps"]["prr_improvement"] for r in rs
                 if not collapsed(r)]
            return [min(d), max(d)] if d else None
        out[algo] = {
            "prr_improvement": ec.band(delta(mine), delta(ref)),
            "n_positive": sum(x > 0 for x in delta(mine)),
            "jax_n_positive": sum(x > 0 for x in delta(ref)),
            "sps_prr": ec.band(
                [r["compare_vs_sps"]["sps"]["mean_prr"] for r in mine],
                [r["compare_vs_sps"]["sps"]["mean_prr"] for r in ref]),
            "labels": ["collapse" if collapsed(r) else "learner"
                       for r in mine],
            "n_collapse": sum(map(collapsed, mine)),
            "jax_n_collapse": sum(map(collapsed, ref)),
            "learner_prr_improvement_range": learners(mine),
            "jax_learner_prr_improvement_range": learners(ref),
        }
    return out


def run_campaign(out="results/torch_ps_campaign.json", *, seeds=3,
                 episodes=None, num_envs=16, eval_steps=500, save_freq=None,
                 workdir=None, jobs=1, device=None,
                 reference="results/ps_campaign.json", cli=None) -> dict:
    """Run (or finish) both algorithms' seeds and write ``out``; returns
    it."""
    dev = resolve_device(device)
    root = workdir or out.rsplit(".json", 1)[0] + "_seeds"
    tasks = {f"{algo} seed {k}": dict(
        algo=algo, workdir=f"{root}/{algo}/seed{k}", seed=k,
        episodes=episodes, num_envs=num_envs, eval_steps=eval_steps,
        save_freq=save_freq, device=dev.type)
        for algo in ps_loop.ALGOS for k in range(seeds)}
    runs = ec.run_seeds(tasks, run_seed, lambda **kw: setup(**kw)[3], jobs)
    summary = {"config": CONFIG,
               "episodes": setup("ps-dqn", episodes=episodes,
                                 num_envs=num_envs, device=dev)[2],
               "num_envs": num_envs, "eval_steps": eval_steps,
               "runs": runs, "seeds": seeds,
               "cli": cli or ("python -m diral_tpu_torch.scripts."
                              f"ps_campaign --seeds {seeds}"),
               "device": full_run.device_info(dev)}
    ref = ec.reference_runs(reference)
    if ref:
        summary["checks"] = checks(runs, ref)
    return ec.write(out, summary)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m diral_tpu_torch.scripts.ps_campaign",
        description="Full-schedule PS-DQN and PS-DRQN runs on the toy over "
                    "seeds 0..S-1, each evaluated against SPS; writes one "
                    "JSON artifact.")
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--episodes", type=int, default=None,
                   help="default: the toy schedule's time_slots/interval")
    p.add_argument("--num-envs", type=int, default=16)
    p.add_argument("--eval-steps", type=int, default=500)
    p.add_argument("--out", default="results/torch_ps_campaign.json")
    p.add_argument("--save-freq", type=int, default=None,
                   help="checkpoint every N episodes so that an open run "
                        "resumes (default: no checkpoint)")
    p.add_argument("--workdir", default=None,
                   help="root of the per-run workdirs (default: <out "
                        "without .json>_seeds)")
    p.add_argument("--jobs", type=int, default=1,
                   help="runs trained at a time, one process each")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    p.add_argument("--reference", default="results/ps_campaign.json",
                   help="the JAX artifact the band checks read")
    return p


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    a = parser().parse_args(argv)
    return run_campaign(
        a.out, seeds=a.seeds, episodes=a.episodes, num_envs=a.num_envs,
        eval_steps=a.eval_steps, save_freq=a.save_freq, workdir=a.workdir,
        jobs=a.jobs, device=a.device, reference=a.reference,
        cli="python -m diral_tpu_torch.scripts.ps_campaign "
            + " ".join(map(shlex.quote, argv)))


if __name__ == "__main__":
    main()
