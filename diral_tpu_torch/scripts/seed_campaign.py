"""Seed-replication campaign (scripts/seed_campaign.py): ``--seeds``
full-schedule runs of one config, each greedy-evaluated against SPS with
full_run's protocol, and one JSON artifact with the per-seed rows and the
distribution the RESULTS.md tables render from.

    python -m diral_tpu_torch.scripts.seed_campaign <config.yaml> <out.json>
        [--seeds 5] [--first-seed 0] [--slots N] [--eval-steps 500]
        [--eval-envs 16] [--dtype D] [--save-freq N] [--workdir ROOT]
        [--jobs J] [--device cuda|cpu] [--reference JAX.json]

``out`` has the JAX artifact's keys (``config``, ``time_slots``,
``seeds``, ``eval_steps``, ``eval_envs``, ``cli``, ``rows``,
``prr_improvement_mean`` / ``_std`` (ddof 1) / ``_min`` / ``_max``,
``n_below_sps``), ``device`` and, with ``--reference``, ``checks``: the
band checks against that JAX campaign.  ``seeds`` is JAX's count, or,
with ``--first-seed K`` above 0, the list of seeds run (K..K+S-1).  Each
row has JAX's keys (``seed``, ``train_seconds``, ``slots_per_sec``,
``final_decile_sum_reward``, ``reward_curve_deciles``, ``drqn_prr``,
``sps_prr``, ``prr_improvement``) and ``device``, ``resumed_from``,
``init_seconds``, ``loop_seconds``, ``eval_seconds`` and ``launches``
from the seed's summary.

A campaign survives being cut, so it can span calls with a time cap
(departures from the JAX script, ROADMAP Queue 3; none changes a number):

* Seed k runs ``full_run.run`` into ``<ROOT>/seed<k>/`` (``--workdir
  ROOT``, default ``<out without .json>_seeds``), not into one shared
  directory.  A seed whose ``summary.json`` exists is not run again: its
  row is read back.  ``run.json`` there refuses a start under other
  options, naming the field.
* Without ``--save-freq`` a seed writes no file but its ``run.json`` and
  ``summary.json`` (no checkpoint, as the JAX campaign): a seed that is
  cut starts again from slot 0.  100v/50r runs so: a seed takes a few
  minutes, and its checkpoint would be 753,942,965 bytes.
* With ``--save-freq N`` a seed checkpoints every N slots (the last 3
  kept) and dumps its results, and an open seed resumes from its newest
  checkpoint; the dumps give a resumed seed the reward curve of the
  whole schedule.  The toy runs so (``--save-freq 10000``; a checkpoint
  of a few MB).
* ``--jobs J`` trains J open seeds at a time, each in a process of its
  own on the same device; each has its own generator, so a seed's row is
  the one it has alone.
* ``--device cuda|cpu`` takes the place of ``--cpu``, as in full_run.
* ``--first-seed K`` runs seeds K..K+S-1 (JAX's script runs 0..S-1), so
  that more seeds of a committed campaign go to a new artifact; a seed's
  row is the one it has in any campaign.

A campaign that outlasts one machine session runs under a ``timeout``
below the session's cap with ``--workdir`` on storage the next session
gets again (README, "Full runs and seed campaigns"); a kill mid-write
is safe, since every file is written to a temporary one and renamed.
"""

from __future__ import annotations

import argparse
import json
import os
import shlex
import sys

import numpy as np

from diral_tpu_torch.device import resolve_device
from diral_tpu_torch.scripts import episode_campaign, full_run

# a row's fields that say how and where its seed ran, not what it learned
RUN_FIELDS = ("train_seconds", "slots_per_sec", "init_seconds",
              "loop_seconds", "eval_seconds", "device", "resumed_from",
              "launches")


def seed_row(seed: int, summary: dict) -> dict:
    """A JAX campaign row (scripts/seed_campaign.py:80-89) from a seed's
    full_run summary, then the port's additions."""
    comp = summary["compare_vs_sps"]
    curve = summary["reward_curve_deciles"]
    row = {
        "seed": seed,
        "train_seconds": summary["train_seconds"],
        "slots_per_sec": summary["slots_per_sec"],
        "final_decile_sum_reward": curve[-1],
        "reward_curve_deciles": curve,
        "drqn_prr": round(comp["drqn"]["mean_prr"], 4),
        "sps_prr": round(comp["sps"]["mean_prr"], 4),
        "prr_improvement": round(comp["prr_improvement"], 4),
    }
    row.update({k: summary[k] for k in ("device", "resumed_from",
                                        "init_seconds", "loop_seconds",
                                        "eval_seconds")})
    # summaries written before launches were counted lack them, e.g.
    # results/torch_toy_seed0.json, which ref_sweep's flagship check reads
    if "launches" in summary:
        row["launches"] = summary["launches"]
    return row


def run_ident(**kw) -> dict:
    """The ``run.json`` identity of a ``full_run.run`` task."""
    return full_run.setup(**{k: v for k, v in kw.items()
                             if k not in ("workdir", "verbose")})[2]


def campaign_stats(rows) -> dict:
    """The distribution of the rows' PRR improvements
    (scripts/seed_campaign.py:98-110)."""
    imp = np.array([r["prr_improvement"] for r in rows])
    return {
        "prr_improvement_mean": round(float(imp.mean()), 4),
        "prr_improvement_std": round(float(imp.std(ddof=1)), 4)
        if len(imp) > 1 else 0.0,
        "prr_improvement_min": round(float(imp.min()), 4),
        "prr_improvement_max": round(float(imp.max()), 4),
        # "collapse" = the trained policy fails to beat SPS at all
        "n_below_sps": int((imp <= 0).sum()),
    }


# SPS PRR's rule: within this of the JAX campaign's.  Every seed
# evaluates with rollouts seeded 1, so each package's SPS PRR is one value
# for all its seeds and the band test's stds are 0.
SPS_PRR_TOLERANCE = 0.01


def checks(rows, reference) -> dict:
    """The band checks against the JAX campaign's rows: ΔPRR in the band
    (population stds), the count below SPS, SPS PRR within
    ``SPS_PRR_TOLERANCE``."""
    def col(rs, key):
        return [r[key] for r in rs]
    sps = episode_campaign.band(col(rows, "sps_prr"), col(reference,
                                                          "sps_prr"))
    sps.update(limit=SPS_PRR_TOLERANCE,
               inside=sps["abs_diff"] <= SPS_PRR_TOLERANCE)
    return {
        "prr_improvement": episode_campaign.band(
            col(rows, "prr_improvement"), col(reference, "prr_improvement")),
        "n_below_sps": campaign_stats(rows)["n_below_sps"],
        "jax_n_below_sps": campaign_stats(reference)["n_below_sps"],
        "sps_prr": sps,
    }


def run_campaign(config: str, out: str, *, seeds=5, first_seed=0,
                 slots=None, eval_steps=500, eval_envs=16, dtype=None,
                 save_freq=None, workdir=None, jobs=1, device=None,
                 reference=None, cli=None) -> dict:
    """Run (or finish) the campaign and write ``out``; returns its
    summary."""
    dev = resolve_device(device)
    root = workdir or os.path.splitext(out)[0] + "_seeds"
    tasks = {f"seed {k}": dict(
        config=config, workdir=os.path.join(root, f"seed{k}"), slots=slots,
        seed=k, eval_steps=eval_steps, eval_envs=eval_envs, dtype=dtype,
        save_freq=save_freq, device=dev.type, campaign=True, verbose=False)
        for k in range(first_seed, first_seed + seeds)}
    summaries = episode_campaign.run_seeds(tasks, full_run.run, run_ident,
                                           jobs)
    rows = [seed_row(first_seed + i, s) for i, s in enumerate(summaries)]
    first = summaries[0]
    summary = {
        "config": config,
        "time_slots": first["time_slots"],
        "seeds": (list(range(first_seed, first_seed + seeds)) if first_seed
                  else seeds),
        "eval_steps": eval_steps,
        "eval_envs": eval_envs,
        "cli": cli or (f"python -m diral_tpu_torch.scripts.seed_campaign "
                       f"{config} {out} --seeds {seeds}"),
        "rows": rows,
        **campaign_stats(rows),
        "device": full_run.device_info(dev),
    }
    if reference:
        with open(reference) as f:
            summary["checks"] = checks(rows, json.load(f)["rows"])
    if os.path.dirname(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
    full_run.write_json(out, summary)
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"}),
          flush=True)
    return summary


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m diral_tpu_torch.scripts.seed_campaign",
        description="Full-schedule runs of one config over seeds K..K+S-1, "
                    "each evaluated against SPS; writes one JSON artifact.")
    p.add_argument("config")
    p.add_argument("out")
    p.add_argument("--seeds", type=int, default=5)
    p.add_argument("--first-seed", type=int, default=0,
                   help="run seeds K..K+S-1 (default 0)")
    p.add_argument("--slots", type=int, default=None)
    p.add_argument("--eval-steps", type=int, default=500)
    p.add_argument("--eval-envs", type=int, default=16)
    p.add_argument("--dtype", default=None)
    p.add_argument("--save-freq", type=int, default=None,
                   help="checkpoint every N slots so that an open seed "
                        "resumes (default: no checkpoint)")
    p.add_argument("--workdir", default=None,
                   help="root of the per-seed workdirs (default: <out "
                        "without .json>_seeds)")
    p.add_argument("--jobs", type=int, default=1,
                   help="seeds trained at a time, one process each")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    p.add_argument("--reference", default=None,
                   help="the JAX campaign artifact to compute the band "
                        "checks against (e.g. results/congested_seeds5.json)")
    return p


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser().parse_args(argv)
    cli = ("python -m diral_tpu_torch.scripts.seed_campaign "
           + " ".join(map(shlex.quote, argv)))
    return run_campaign(args.config, args.out, seeds=args.seeds,
                        first_seed=args.first_seed,
                        slots=args.slots, eval_steps=args.eval_steps,
                        eval_envs=args.eval_envs, dtype=args.dtype,
                        save_freq=args.save_freq, workdir=args.workdir,
                        jobs=args.jobs, device=args.device,
                        reference=args.reference, cli=cli)


if __name__ == "__main__":
    main()
