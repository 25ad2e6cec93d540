"""PPO seed campaign (scripts/ppo_campaign.py): ``--seeds`` full-schedule
PS-PPO runs of one config, each followed by a greedy (argmax-logit) eval
against SPS (``--eval-steps`` slots x ``--eval-envs`` envs,
train/evaluate.compare_ppo_vs_sps, seeded ``100 + seed``).

    python -m diral_tpu_torch.scripts.ppo_campaign
        [--config configs/ppo_congested.yaml] [--seeds 3] [--episodes N]
        [--eval-steps 500] [--eval-envs 16]
        [--out results/torch_ppo_seeds.json] [--save-freq N]
        [--workdir ROOT] [--jobs J] [--device cuda|cpu]
        [--reference results/ppo_seeds.json]

``out`` has the JAX artifact's keys (``config``, ``episodes``,
``eval_steps``, ``eval_envs``, ``runs``), each row JAX's (``seed``,
``train_s``, ``slots_per_sec``, ``sum_r_first100``, ``sum_r_last100``,
``compare_vs_sps``) plus ``device`` (the card's name and power limit)
and ``resumed_from``; the artifact adds ``seeds`` (n), ``cli``,
``device`` and, where the JAX artifact ``--reference`` exists,
``checks``: the band tests against it (``checks`` below).

Departures from the JAX script (ROADMAP Queue 3; none changes a number
of a run): ``--device`` in place of ``--cpu``; the eval's generator
seeded ``100 + seed`` in place of ``PRNGKey(100 + seed)``; the default
``--out`` is the port's own file; per-seed workdirs ``<ROOT>/seed<k>/``
(default ``<out without .json>_seeds``), resumable with ``--save-freq
N`` episodes, ``--jobs J`` open seeds at once; ``train_s`` sums the loop
seconds of every segment (episode_campaign.py).
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import shlex
import sys

import numpy as np
import torch

from diral_tpu_torch.config import load_config
from diral_tpu_torch.device import resolve_device
from diral_tpu_torch.scripts import episode_campaign as ec
from diral_tpu_torch.scripts import full_run
from diral_tpu_torch.train import checkpoint as ckpt
from diral_tpu_torch.train import evaluate, ppo_loop


def setup(config: str, *, seed=0, episodes=None, eval_steps=500,
          eval_envs=16, save_freq=None, device=None, **_):
    """(config, device, episodes, the seed's ``run.json`` identity)."""
    dev = resolve_device(device)
    cfg = load_config(config)
    episodes = episodes or cfg.time_slots // cfg.episode_interval
    ident = dict(config=config, seed=seed, episodes=episodes,
                 eval_steps=eval_steps, eval_envs=eval_envs,
                 save_freq=save_freq, device=dev.type,
                 config_sha256=hashlib.sha256(repr(cfg).encode()).hexdigest())
    return cfg, dev, episodes, ident


def run_seed(config: str, workdir: str, *, seed=0, episodes=None,
             eval_steps=500, eval_envs=16, save_freq=None,
             device=None) -> dict:
    """Train seed ``seed`` into ``workdir`` (resuming with ``save_freq``),
    evaluate it against SPS, write ``summary.json``; returns the row."""
    cfg, dev, episodes, ident = setup(
        config, seed=seed, episodes=episodes, eval_steps=eval_steps,
        eval_envs=eval_envs, save_freq=save_freq, device=device)
    record = ec.open_seed(workdir, ident)
    if dev.type == "cuda":
        from diral_tpu_torch.ops import _build

        _build.build_all()
    fns = ppo_loop.make_ppo_functions(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(int(seed))
    learner, logs, train_s = ec.train(
        fns, ppo_loop.PPODraws(gen), episodes, workdir, record, save_freq,
        lambda d: ckpt.restore_ppo(d, dev, gen),
        lambda d, e, carry, logs, s: ckpt.save_ppo(d, e, carry, logs, gen,
                                                   s))
    r = np.asarray(logs["mean_sum_reward"], np.float64)
    eval_cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, num_envs=eval_envs))
    comp = evaluate.compare_ppo_vs_sps(eval_cfg, learner.params, 100 + seed,
                                       steps=eval_steps, device=dev)
    return ec.finish(workdir, {
        "seed": seed, "train_s": round(train_s, 1),
        "slots_per_sec": round(episodes * cfg.episode_interval / train_s, 1),
        "sum_r_first100": round(float(r[:100].mean()), 3),
        "sum_r_last100": round(float(r[-100:].mean()), 3),
        "compare_vs_sps": comp, "device": full_run.device_info(dev),
        "resumed_from": record["resumed_from"]})


def checks(runs, reference) -> dict:
    """The PPO band checks against the JAX artifact's runs: ΔPRR in the
    band, the count below SPS (ΔPRR < 0, render_results.py:201), SPS PRR
    in the band, and sum_r rising from the first to the last 100
    episodes in every seed."""
    def delta(rs):
        return [r["compare_vs_sps"]["prr_improvement"] for r in rs]

    def sps(rs):
        return [r["compare_vs_sps"]["sps"]["mean_prr"] for r in rs]
    return {
        "prr_improvement": ec.band(delta(runs), delta(reference)),
        "n_below_sps": sum(x < 0 for x in delta(runs)),
        "jax_n_below_sps": sum(x < 0 for x in delta(reference)),
        "sps_prr": ec.band(sps(runs), sps(reference)),
        "sum_r_rising": [r["sum_r_last100"] > r["sum_r_first100"]
                         for r in runs],
    }


def run_campaign(config="configs/ppo_congested.yaml",
                 out="results/torch_ppo_seeds.json", *, seeds=3,
                 episodes=None, eval_steps=500, eval_envs=16, save_freq=None,
                 workdir=None, jobs=1, device=None,
                 reference="results/ppo_seeds.json", cli=None) -> dict:
    """Run (or finish) the campaign and write ``out``; returns it."""
    dev = resolve_device(device)
    root = workdir or out.rsplit(".json", 1)[0] + "_seeds"
    tasks = {f"seed {k}": dict(config=config, workdir=f"{root}/seed{k}",
                               seed=k, episodes=episodes,
                               eval_steps=eval_steps, eval_envs=eval_envs,
                               save_freq=save_freq, device=dev.type)
             for k in range(seeds)}
    runs = ec.run_seeds(tasks, run_seed, lambda **kw: setup(**kw)[3], jobs)
    summary = {"config": config,
               "episodes": setup(config, episodes=episodes, device=dev)[2],
               "eval_steps": eval_steps, "eval_envs": eval_envs,
               "runs": runs, "seeds": seeds,
               "cli": cli or ("python -m diral_tpu_torch.scripts."
                              f"ppo_campaign --config {config} --seeds "
                              f"{seeds}"),
               "device": full_run.device_info(dev)}
    ref = ec.reference_runs(reference)
    if ref:
        summary["checks"] = checks(runs, ref)
    return ec.write(out, summary)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m diral_tpu_torch.scripts.ppo_campaign",
        description="Full-schedule PS-PPO runs over seeds 0..S-1, each "
                    "evaluated against SPS; writes one JSON artifact.")
    p.add_argument("--config", default="configs/ppo_congested.yaml")
    p.add_argument("--seeds", type=int, default=3)
    p.add_argument("--episodes", type=int, default=None)
    p.add_argument("--eval-steps", type=int, default=500)
    p.add_argument("--eval-envs", type=int, default=16)
    p.add_argument("--out", default="results/torch_ppo_seeds.json")
    p.add_argument("--save-freq", type=int, default=None,
                   help="checkpoint every N episodes so that an open seed "
                        "resumes (default: no checkpoint)")
    p.add_argument("--workdir", default=None,
                   help="root of the per-seed workdirs (default: <out "
                        "without .json>_seeds)")
    p.add_argument("--jobs", type=int, default=1,
                   help="seeds trained at a time, one process each")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    p.add_argument("--reference", default="results/ppo_seeds.json",
                   help="the JAX artifact the band checks read")
    return p


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    a = parser().parse_args(argv)
    return run_campaign(
        a.config, a.out, seeds=a.seeds, episodes=a.episodes,
        eval_steps=a.eval_steps, eval_envs=a.eval_envs,
        save_freq=a.save_freq, workdir=a.workdir, jobs=a.jobs,
        device=a.device, reference=a.reference,
        cli="python -m diral_tpu_torch.scripts.ppo_campaign "
            + " ".join(map(shlex.quote, argv)))


if __name__ == "__main__":
    main()
