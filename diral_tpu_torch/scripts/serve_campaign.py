"""Seed replication of the online DIRAL-vs-SPS comparison: seeds
0..S-1 of ``serve --mode compare`` (interop/serve.compare_sps_over_gateway
with the verb's tuned agent), one process per seed, and one JSON artifact
in the shape of the JAX package's results/serve_compare_seeds3.json.

    python -m diral_tpu_torch.scripts.serve_campaign <out.json>
        [--seeds 6] [--rounds 2500] [--users 8] [--channels 6]
        [--device cuda|cpu]

The protocol is the JAX package's (RESULTS.md:443-485): the ``serve``
verb's tuned agent, a train call of 4 batches every 10 rounds, eps 0.5
-> 0.02, the framed transport.

``out`` has JAX's keys (``protocol``, ``cli``, ``rows``,
``prr_improvement_mean`` / ``_std`` (ddof 1) / ``_min`` / ``_max``,
``n_below_sps``) and ``device``; each row has JAX's keys (``drqn``,
``sps``, ``prr_improvement``, ``seed``, ``wall_seconds``), the stats
dicts with their ``timing``, and ``device``.

A seed is host-bound and single-threaded (the simulator sets the pace,
one request at a time), so the seeds are served at once, as many as the
host has cores, each in a process of its own with one CPU thread for
PyTorch, all on the same card.  Each seed has its own simulator and its
own generator, so its row is the one it has alone.  The artifact is
rewritten as each seed ends.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import shlex
import sys
import time
from concurrent.futures import ProcessPoolExecutor

from diral_tpu_torch.device import resolve_device
from diral_tpu_torch.scripts.full_run import device_info, write_json
from diral_tpu_torch.scripts.seed_campaign import campaign_stats


def run_seed(seed: int, opts: dict, device: str) -> dict:
    """One seed's comparison; returns its row."""
    import torch

    from diral_tpu_torch.interop.serve import (compare_sps_over_gateway,
                                               tuned_agent)

    torch.set_num_threads(1)
    dev = resolve_device(device)
    t0 = time.perf_counter()
    res = compare_sps_over_gateway(tuned_agent(), seed=seed, device=dev,
                                   **opts)
    return {**res, "seed": seed,
            "wall_seconds": round(time.perf_counter() - t0, 1),
            "device": device_info(dev)}


def run_campaign(out: str, *, seeds=6, rounds=2500, users=8, channels=6,
                 device=None, cli=None) -> dict:
    dev = resolve_device(device)
    opts = dict(sim_users=users, sim_channels=channels, rounds=rounds,
                train_every=10, n_batches=4, eps=0.5, eps_final=0.02,
                transport="framed")
    summary = {
        "protocol": (
            f"compare_sps_over_gateway: PS-DRQN learning online vs SPS, "
            f"same world seed per row; {users} users / {channels} channels, "
            f"{rounds} rounds, train_every=10, n_batches=4, eps 0.5->0.02, "
            f"framed transport, learner on {dev.type}, one process per "
            f"seed"),
        "cli": cli or f"python -m diral_tpu_torch.scripts.serve_campaign {out}",
        "rows": [],
        "device": device_info(dev),
    }
    if os.path.dirname(out):
        os.makedirs(os.path.dirname(out), exist_ok=True)
    rows = {}

    def done(row):
        rows[row["seed"]] = row
        print(f"seed {row['seed']}: ΔPRR {row['prr_improvement']:+.4f} "
              f"(DRQN tail {row['drqn']['mean_prr_tail']:.4f}, SPS tail "
              f"{row['sps']['mean_prr_tail']:.4f}), {row['wall_seconds']} s",
              flush=True)
        summary["rows"] = [rows[k] for k in sorted(rows)]
        summary.update(campaign_stats(summary["rows"]))
        write_json(out, summary)

    jobs = min(seeds, os.cpu_count() or 1)
    if jobs > 1:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(min(jobs, seeds), mp_context=ctx) as ex:
            futures = [ex.submit(run_seed, k, opts, dev.type)
                       for k in range(seeds)]
            for f in futures:
                done(f.result())
    else:
        for k in range(seeds):
            done(run_seed(k, opts, dev.type))
    print(json.dumps({k: v for k, v in summary.items() if k != "rows"}),
          flush=True)
    return summary


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m diral_tpu_torch.scripts.serve_campaign",
        description="The online DIRAL-vs-SPS comparison over seeds "
                    "0..S-1; writes one JSON artifact.")
    p.add_argument("out")
    p.add_argument("--seeds", type=int, default=6)
    p.add_argument("--rounds", type=int, default=2500)
    p.add_argument("--users", type=int, default=8)
    p.add_argument("--channels", type=int, default=6)
    p.add_argument("--device", default=None,
                   help="cuda (the default) or cpu")
    return p


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parser().parse_args(argv)
    cli = ("python -m diral_tpu_torch.scripts.serve_campaign "
           + " ".join(map(shlex.quote, argv)))
    return run_campaign(args.out, seeds=args.seeds, rounds=args.rounds,
                        users=args.users, channels=args.channels,
                        device=args.device, cli=cli)


if __name__ == "__main__":
    main()
