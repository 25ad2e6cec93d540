"""The reference's experiment suite (scripts/ref_sweep.py): the gamma
sweep {0.3, 0.5, 0.7, 0.95} and the num_bins sweep {10, 20, 40} -- the six
configs the reference's main_test.py:279-283 hard-codes -- each trained
over its full 250,002-slot schedule, greedy-evaluated against SPS with
full_run's protocol, one row a config.

    python -m diral_tpu_torch.scripts.ref_sweep [outdir] [--out ART.json]
        [--slots N] [--seed S] [--eval-steps 500] [--eval-envs 16]
        [--save-freq N] [--jobs J] [--ref-configs DIR] [--device cuda|cpu]

The configs are the reference's YAMLs where ``--ref-configs`` names the
reference checkout's ``configs/4ue_3r_toy`` directory, else the same six
experiments built from ``config.toy_4ue_3r()`` with ``agent.gamma`` and
``env.state.num_bins`` replaced (the JAX package's tests hold the two
equal); ``state_space`` follows ``num_bins``: 13, 23 or 43.

Each config runs ``full_run.run`` into ``<outdir>/<name>/`` with the
campaign settings of ``seed_campaign`` (no model snapshot, as the JAX
script's ``save_model=False``), so it has the ``run.json`` guard, with
``--save-freq N`` rolling checkpoints and an exact resume, its
``summary.json`` read back once it is finished, and ``--jobs J`` configs
trained at once, one process each.  The rollouts of the evaluation are
seeded 1, as JAX's ``PRNGKey(1)``.

Writes ``<outdir>/sweep.json`` (a list of rows, as the JAX script) and,
with ``--out``, the artifact: ``rows``, ``device``, ``cli`` and
``checks``, the suite's rules held against the JAX package's
``results/ref_sweep.json`` and the port's toy runs (``checks``).  Rows
have JAX's keys (scripts/ref_sweep.py:105-117) and ``device``,
``resumed_from``, ``init_seconds``, ``loop_seconds`` and
``eval_seconds``.

Departures from the JAX script: ``--device cuda|cpu`` replaces ``--cpu``;
the reference directory is an option, not a fixed path; per-config
workdirs resume; ``train_seconds`` / ``slots_per_sec`` cover a config's
last start (full_run's).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import shlex
import sys

from diral_tpu_torch.config import load_config, toy_4ue_3r
from diral_tpu_torch.device import resolve_device
from diral_tpu_torch.scripts import episode_campaign, full_run, seed_campaign

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RESULTS = os.path.join(ROOT, "results")

# The published set (reference main_test.py:279-283): (short name, gamma,
# num_bins).  Short names match the reference filenames' tails.
SUITE = [
    ("r2_b10_mg_o_index_dis_07", 0.7, 10),
    ("r2_b20_mg_o_index_dis_03", 0.3, 20),
    ("r2_b20_mg_o_index_dis_05", 0.5, 20),
    ("r2_b20_mg_o_index_dis_07", 0.7, 20),
    ("r2_b20_mg_o_index_dis_95", 0.95, 20),
    ("r2_b40_mg_o_index_dis_07", 0.7, 40),
]
# the suite's member that is the flagship toy config
FLAGSHIP = "r2_b20_mg_o_index_dis_07"

# what the checks read: the JAX suite, the port's toy seed 0 (the
# flagship's own run) and the two packages' toy full runs, whose ΔPRR
# spreads set the band
JAX_SWEEP = os.path.join(RESULTS, "ref_sweep.json")
TOY_SEED0 = os.path.join(RESULTS, "torch_toy_seed0.json")
JAX_TOY_RUNS = [os.path.join(RESULTS, f"toy_full_{tag}.json")
                for tag in ("250k", "s1", "s2")]
PORT_TOY_CAMPAIGN = os.path.join(RESULTS, "torch_toy_seeds3.json")
# fields a row shares with the flagship's own run when both are the same
# values of config, seed 0 and the same evaluation
SAME_RUN_FIELDS = ("reward_curve_deciles", "drqn_prr", "sps_prr",
                   "prr_improvement")
# a greedy evaluation at this PRR or above is a collapse to a fixed
# schedule (render_results.py's star)
COLLAPSED_PRR = 0.999


def load_suite(ref_dir=None) -> list:
    """[(name, ExperimentConfig)]: the reference YAMLs in ``ref_dir`` where
    they exist, else the same experiments built from the flagship."""
    configs = []
    for name, gamma, bins in SUITE:
        path = ref_dir and os.path.join(
            ref_dir, f"config_toy_4ue_3r_tests_db_{name}.yaml")
        if path and os.path.exists(path):
            cfg = load_config(path)
        else:
            base = toy_4ue_3r()
            cfg = dataclasses.replace(
                base,
                agent=dataclasses.replace(base.agent, gamma=gamma),
                env=dataclasses.replace(
                    base.env, state=dataclasses.replace(
                        base.env.state, num_bins=bins)))
        configs.append((name, cfg))
    return configs


def suite_row(name: str, cfg, summary: dict) -> dict:
    """A JAX suite row (scripts/ref_sweep.py:105-117) from a config's
    full_run summary, then the port's additions."""
    comp = summary["compare_vs_sps"]
    curve = summary["reward_curve_deciles"]
    row = {
        "config": name,
        "gamma": cfg.agent.gamma,
        "num_bins": cfg.env.state.num_bins,
        "state_space": cfg.env.state_space,
        "train_seconds": summary["train_seconds"],
        "slots_per_sec": summary["slots_per_sec"],
        "reward_curve_deciles": curve,
        "final_mean_sum_reward": curve[-1],
        "drqn_prr": round(comp["drqn"]["mean_prr"], 4),
        "sps_prr": round(comp["sps"]["mean_prr"], 4),
        "prr_improvement": round(comp["prr_improvement"], 4),
    }
    row.update({k: summary[k] for k in ("device", "resumed_from",
                                        "init_seconds", "loop_seconds",
                                        "eval_seconds")})
    return row


def _load(path):
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def _same_values(a, b) -> bool:
    """Two configs equal in every value but their label."""
    return (dataclasses.replace(a, experiment_name="")
            == dataclasses.replace(b, experiment_name=""))


def checks(rows, jax_rows, *, flagship_cfg=None, toy_seed0=None,
           jax_toy=(), port_toy=(), time_slots=None) -> dict:
    """The suite's rules (PERF.md §6), each with what it read.

    Held: the six SPS PRRs equal (SPS reads no state; one eval protocol);
    the flagship row equal to the port's toy seed 0 run in
    ``SAME_RUN_FIELDS`` where config values and schedule are the same
    (None where they are not); |ΔPRR_port - ΔPRR_jax| <= 3 sqrt(s_jax^2 +
    s_port^2) for each row whose JAX evaluation did not collapse, the s
    being the population stds of each package's toy full-run ΔPRRs;
    ``final_mean_sum_reward`` above the curve's first decile in every row.
    Reported: the b10 collapse, the orders by gamma and bins, slots/s."""
    by = {r["config"]: r for r in rows}
    jby = {r["config"]: r for r in jax_rows or ()}
    out = {}
    sps = [r["sps_prr"] for r in rows]
    out["sps_equal"] = {"values": sps, "met": len(set(sps)) == 1}

    det = {"met": None}
    mine = by.get(FLAGSHIP)
    if mine is not None and toy_seed0 is not None:
        theirs = seed_campaign.seed_row(0, toy_seed0)
        same_cfg = (flagship_cfg is not None and _same_values(
            flagship_cfg, load_config(os.path.join(ROOT,
                                                   toy_seed0["config"]))))
        same_schedule = time_slots == toy_seed0["time_slots"]
        det = {"config_values_equal": same_cfg,
               "same_schedule": same_schedule,
               "fields": {f: {"suite": mine[f], "toy_seed0": theirs[f]}
                          for f in SAME_RUN_FIELDS},
               "met": (all(mine[f] == theirs[f] for f in SAME_RUN_FIELDS)
                       if same_cfg and same_schedule else None)}
    out["determinism"] = det

    if jby and jax_toy and port_toy:
        s_jax = episode_campaign.mean_std(jax_toy)[1]
        s_port = episode_campaign.mean_std(port_toy)[1]
        limit = 3.0 * math.sqrt(s_jax ** 2 + s_port ** 2)
        held = {}
        for name, j in jby.items():
            if name not in by or j["drqn_prr"] >= COLLAPSED_PRR:
                continue
            diff = abs(by[name]["prr_improvement"] - j["prr_improvement"])
            held[name] = {"port": by[name]["prr_improvement"],
                          "jax": j["prr_improvement"], "abs_diff": diff,
                          "inside": diff <= limit}
        out["band"] = {"s_jax": s_jax, "s_port": s_port, "limit": limit,
                       "rows": held,
                       "met": bool(held) and all(h["inside"]
                                                 for h in held.values())}

    learning = {r["config"]: r["final_mean_sum_reward"]
                > r["reward_curve_deciles"][0] for r in rows}
    out["learning"] = {"rows": learning, "met": all(learning.values())}

    def order(rs, key):
        return [r["config"] for r in sorted(rs, key=key)]
    b20 = [r for r in rows if r["num_bins"] == 20]
    g07 = [r for r in rows if r["gamma"] == 0.7]
    out["reported"] = {
        "collapsed": {r["config"]: {"port": r["drqn_prr"] >= COLLAPSED_PRR,
                                    "jax": (jby[r["config"]]["drqn_prr"]
                                            >= COLLAPSED_PRR
                                            if r["config"] in jby else None)}
                      for r in rows},
        "order_by_gamma": {
            "port": order(b20, lambda r: -r["prr_improvement"]),
            "jax": order([jby[r["config"]] for r in b20
                          if r["config"] in jby],
                         lambda r: -r["prr_improvement"])},
        "order_by_bins": {
            "port": order(g07, lambda r: -r["prr_improvement"]),
            "jax": order([jby[r["config"]] for r in g07
                          if r["config"] in jby],
                         lambda r: -r["prr_improvement"])},
        "slots_per_sec": {r["config"]: r["slots_per_sec"] for r in rows},
    }
    out["held_met"] = all(out[k]["met"] for k in
                          ("sps_equal", "determinism", "band", "learning")
                          if k in out)
    return out


def suite_checks(rows, suite, time_slots) -> dict:
    """``checks`` against the committed artifacts in ``results/``."""
    toy = _load(PORT_TOY_CAMPAIGN)
    jax_toy = [d["compare_vs_sps"]["prr_improvement"]
               for d in map(_load, JAX_TOY_RUNS) if d]
    return checks(rows, _load(JAX_SWEEP), flagship_cfg=dict(suite)[FLAGSHIP],
                  toy_seed0=_load(TOY_SEED0), jax_toy=jax_toy,
                  port_toy=[r["prr_improvement"] for r in toy["rows"]]
                  if toy else (), time_slots=time_slots)


def run_suite(outdir="runs/ref_sweep", *, out=None, slots=None, seed=0,
              eval_steps=500, eval_envs=16, save_freq=None, jobs=1,
              ref_dir=None, device=None, cli=None) -> dict:
    """Run (or finish) the suite into ``outdir``; write ``sweep.json``
    there and, with ``out``, the artifact.  Returns the artifact."""
    dev = resolve_device(device)
    suite = load_suite(ref_dir)
    tasks = {name: dict(config=dataclasses.replace(cfg,
                                                   experiment_name=name),
                        name=name, workdir=os.path.join(outdir, name),
                        slots=slots, seed=seed, eval_steps=eval_steps,
                        eval_envs=eval_envs, save_freq=save_freq,
                        device=dev.type, campaign=True, verbose=False)
             for name, cfg in suite}
    summaries = episode_campaign.run_seeds(tasks, full_run.run,
                                           seed_campaign.run_ident, jobs)
    rows = [suite_row(name, cfg, s)
            for (name, cfg), s in zip(suite, summaries)]
    os.makedirs(outdir, exist_ok=True)
    full_run.write_json(os.path.join(outdir, "sweep.json"), rows)
    time_slots = summaries[0]["time_slots"]
    artifact = {
        "suite": "reference main_test.py:279-283",
        "time_slots": time_slots,
        "seed": seed,
        "eval_steps": eval_steps,
        "eval_envs": eval_envs,
        "cli": cli or f"python -m diral_tpu_torch.scripts.ref_sweep {outdir}",
        "rows": rows,
        "device": full_run.device_info(dev),
        "checks": suite_checks(rows, suite, time_slots),
    }
    if out:
        if os.path.dirname(out):
            os.makedirs(os.path.dirname(out), exist_ok=True)
        full_run.write_json(out, artifact)
    print(json.dumps({k: v for k, v in artifact.items() if k != "rows"}),
          flush=True)
    return artifact


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m diral_tpu_torch.scripts.ref_sweep",
        description="Train the reference's six-config suite (gamma and "
                    "num_bins sweeps), each evaluated against SPS.")
    p.add_argument("outdir", nargs="?", default="runs/ref_sweep")
    p.add_argument("--out", default=None,
                   help="the artifact with rows, device, cli and checks "
                        "(e.g. results/torch_ref_sweep.json)")
    p.add_argument("--eval-steps", type=int, default=500)
    p.add_argument("--eval-envs", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--slots", type=int, default=None,
                   help="override time_slots (smoke testing)")
    p.add_argument("--save-freq", type=int, default=None,
                   help="checkpoint every N slots so that an open config "
                        "resumes (default: no checkpoint)")
    p.add_argument("--jobs", type=int, default=1,
                   help="configs trained at a time, one process each")
    p.add_argument("--ref-configs", default=None,
                   help="the reference checkout's configs/4ue_3r_toy "
                        "directory (default: build the six from the "
                        "flagship)")
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    return p


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser().parse_args(argv)
    cli = ("python -m diral_tpu_torch.scripts.ref_sweep "
           + " ".join(map(shlex.quote, argv)))
    return run_suite(args.outdir, out=args.out, slots=args.slots,
                     seed=args.seed, eval_steps=args.eval_steps,
                     eval_envs=args.eval_envs, save_freq=args.save_freq,
                     jobs=args.jobs, ref_dir=args.ref_configs,
                     device=args.device, cli=cli)


if __name__ == "__main__":
    main()
