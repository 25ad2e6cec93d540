"""Episode rates of the campaign loops, alone and with several processes
sharing one card: what a PPO / PS campaign's ``--jobs`` and chip time are
planned from.

    python -m diral_tpu_torch.scripts.episode_rate KIND:PROCS:EPISODES ...
        [--warm 3] [--device cuda|cpu]

KIND is ``ppo`` (configs/ppo_congested.yaml, ppo_campaign's default) or
``ps-dqn`` / ``ps-drqn`` (ps_campaign's toy config at 16 envs).  Every
process of every spec starts at once; each runs ``--warm`` episodes,
then times EPISODES more (ended by a device sync) and reports its
episodes/s.  Prints one JSON line: the card, the host's CPU count, the
specs, each process's rate and the wall seconds.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import torch

from diral_tpu_torch.config import load_config
from diral_tpu_torch.device import resolve_device
from diral_tpu_torch.scripts import full_run, ps_campaign
from diral_tpu_torch.train import ppo_loop, ps_loop

PPO_CONFIG = os.path.join(os.path.dirname(__file__), os.pardir, os.pardir,
                          "configs", "ppo_congested.yaml")
KINDS = ("ppo",) + ps_loop.ALGOS


def rate(kind: str, episodes: int, seed: int, warm: int, device: str):
    """Episodes/s of one process over ``episodes`` episodes after ``warm``
    (its first episodes build the kernels' bindings and warm the
    allocator)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    if kind == "ppo":
        fns = ppo_loop.make_ppo_functions(load_config(PPO_CONFIG),
                                          device=dev)
        draws = ppo_loop.PPODraws(gen)
        env_state, history = fns.init_state(draws)
        carry = (env_state, history, fns.init_learner(draws))
    else:
        fns = ps_loop.make_ps_functions(ps_campaign.ps_config(16), kind,
                                        device=dev)
        draws = ps_loop.PSDraws(gen)
        carry = fns.init_carry(draws)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    for ep in range(warm):
        carry, _ = fns.episode(carry, ep, draws)
    sync()
    t0 = time.perf_counter()
    for ep in range(warm, warm + episodes):
        carry, _ = fns.episode(carry, ep, draws)
    sync()
    return episodes / (time.perf_counter() - t0)


def parse(spec: str):
    kind, procs, episodes = spec.split(":")
    if kind not in KINDS:
        raise ValueError(f"unknown kind {kind!r} (one of {KINDS})")
    return kind, int(procs), int(episodes)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(
        prog="python -m diral_tpu_torch.scripts.episode_rate",
        description="Episodes/s of the PPO / PS campaign loops, several "
                    "processes at once.")
    p.add_argument("specs", nargs="+", help="KIND:PROCS:EPISODES")
    p.add_argument("--warm", type=int, default=3)
    p.add_argument("--device", default=None, help="cuda (the default) or cpu")
    a = p.parse_args(argv)
    dev = resolve_device(a.device)
    jobs = [(kind, episodes) for kind, procs, episodes in map(parse, a.specs)
            for _ in range(procs)]
    if dev.type == "cuda":
        from diral_tpu_torch.ops import _build

        _build.build_all()
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(len(jobs), mp_context=ctx) as ex:
        futures = [ex.submit(rate, kind, episodes, i, a.warm, dev.type)
                   for i, (kind, episodes) in enumerate(jobs)]
        rates = [f.result() for f in futures]
    out = {"device": full_run.device_info(dev), "cpu_count": os.cpu_count(),
           "specs": a.specs, "wall_s": round(time.perf_counter() - t0, 2),
           "episodes_per_s": [[k, round(r, 4)]
                              for (k, _), r in zip(jobs, rates)]}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
