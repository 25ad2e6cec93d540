"""Command-line interface of the port (diral_tpu/train/cli.py):

    python -m diral_tpu_torch train       <config.yaml> [--slots N] [--seed S]
                                          [--num-envs B] [--workdir DIR]
                                          [--device cuda|cpu]
    python -m diral_tpu_torch eval        <config.yaml> [--steps N] [--seed S]
                                          [--num-envs B] [--device cuda|cpu]
    python -m diral_tpu_torch compare-sps <config.yaml> [same options]
    python -m diral_tpu_torch train-ppo   <config.yaml> [--episodes N]
                                          [--seed S] [--num-envs B]
                                          [--device cuda|cpu]
    python -m diral_tpu_torch train-ps    <config.yaml> [--algo ps-dqn|ps-drqn]
                                          [--episodes N] [--seed S]
                                          [--num-envs B] [--device cuda|cpu]

``train`` runs every simulation of the config (runner.run_all_simulations)
and writes the reference-layout results under ``--workdir``.
``train-ppo`` (train/ppo_loop.run_ppo) and ``train-ps``
(train/ps_loop.run_ps; ``--algo`` defaults to the config's
``RLAgent.algorithm``) print one JSON line with the JAX verbs' keys.
For ``eval`` and ``compare-sps`` the parameters come from ``drqn_init``
with the port's generator seeded by ``--seed`` (the JAX verbs' behaviour
without ``--checkpoint``); the rollout itself is seeded 1, as in the JAX
verbs.  Runs on the CUDA device unless ``--device cpu``.  Other verbs
come with later slices.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import torch

_DTYPE = {"float32": torch.float32, "float64": torch.float64}


def _load(args):
    from diral_tpu_torch.config import load_config

    cfg = load_config(args.config)
    if getattr(args, "slots", None):
        cfg = dataclasses.replace(cfg, time_slots=args.slots)
    if args.num_envs:
        cfg = dataclasses.replace(
            cfg, engine=dataclasses.replace(cfg.engine,
                                            num_envs=args.num_envs))
    return cfg


def _params(args, cfg, device):
    from diral_tpu_torch.models.qnets import drqn_init

    if args.checkpoint:
        raise NotImplementedError(
            "--checkpoint: reading checkpoints is not ported yet "
            "(ROADMAP Queue 1 item 4, Checkpoint)")
    gen = torch.Generator(device=device).manual_seed(args.seed or 0)
    return drqn_init(gen, cfg.env.state_space, cfg.env.num_channels,
                     cfg.agent, _DTYPE[cfg.engine.dtype], device)


def cmd_eval(args):
    from diral_tpu_torch.device import resolve_device
    from diral_tpu_torch.train.evaluate import evaluate_drqn

    cfg = _load(args)
    dev = resolve_device(args.device)
    params = _params(args, cfg, dev)
    print(json.dumps(evaluate_drqn(cfg, params, 1, steps=args.steps,
                                   dtype=_DTYPE[cfg.engine.dtype],
                                   device=dev)))


def cmd_compare_sps(args):
    from diral_tpu_torch.device import resolve_device
    from diral_tpu_torch.train.evaluate import compare_drqn_vs_sps

    cfg = _load(args)
    dev = resolve_device(args.device)
    params = _params(args, cfg, dev)
    print(json.dumps(compare_drqn_vs_sps(cfg, params, 1, steps=args.steps,
                                         dtype=_DTYPE[cfg.engine.dtype],
                                         device=dev)))


# options of the JAX ``train`` verb that wait for their ROADMAP items
_NOT_YET = {"resume": "Queue 1 item 4, Checkpoint",
            "mesh": "Queue 1 item 9, Parallel",
            "coordinator": "Queue 1 item 9, Parallel",
            "profile": "Queue 1 item 10, Profiling"}


def cmd_train(args):
    from diral_tpu_torch.device import resolve_device
    from diral_tpu_torch.train.runner import run_all_simulations

    for opt, item in _NOT_YET.items():
        if getattr(args, opt):
            raise NotImplementedError(
                f"--{opt} is not ported yet (ROADMAP {item})")
    cfg = _load(args)
    dev = resolve_device(args.device)
    run_all_simulations(cfg, workdir=args.workdir, seed=args.seed,
                        dtype=_DTYPE[cfg.engine.dtype], device=dev)


def _reward_summary(sr) -> dict:
    return {"episodes": int(sr.shape[0]),
            "mean_sum_reward_first100": float(sr[:100].mean()),
            "mean_sum_reward_last100": float(sr[-100:].mean())}


def cmd_train_ppo(args):
    from diral_tpu_torch.device import resolve_device
    from diral_tpu_torch.train.ppo_loop import run_ppo

    cfg = _load(args)
    dev = resolve_device(args.device)
    _, logs = run_ppo(cfg, seed=args.seed or 0, num_episodes=args.episodes,
                      dtype=_DTYPE[cfg.engine.dtype], device=dev)
    print(json.dumps(_reward_summary(logs["mean_sum_reward"])))


def cmd_train_ps(args):
    from diral_tpu_torch.device import resolve_device
    from diral_tpu_torch.train.ps_loop import run_ps

    cfg = _load(args)
    algo = args.algo or cfg.agent.algorithm
    dev = resolve_device(args.device)
    _, logs = run_ps(cfg, algo, seed=args.seed or 0,
                     num_episodes=args.episodes,
                     dtype=_DTYPE[cfg.engine.dtype], device=dev)
    print(json.dumps({"algo": algo.lower(),
                      **_reward_summary(logs["mean_sum_reward"]),
                      "final_eps": float(logs["eps"][-1])}))


def main(argv=None):
    p = argparse.ArgumentParser(prog="diral_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    tp = sub.add_parser("train", help="DRQN training (the reference driver)")
    tp.add_argument("config")
    tp.add_argument("--slots", type=int, default=None,
                    help="override time_slots")
    tp.add_argument("--seed", type=int, default=None)
    tp.add_argument("--num-envs", type=int, default=None)
    tp.add_argument("--workdir", default=".")
    tp.add_argument("--device", default=None, help="cuda (default) or cpu")
    tp.add_argument("--resume", action="store_true",
                    help="not supported yet (ROADMAP Queue 1 item 4)")
    tp.add_argument("--mesh", default=None,
                    help="not supported yet (ROADMAP Queue 1 item 9)")
    tp.add_argument("--coordinator", default=None,
                    help="not supported yet (ROADMAP Queue 1 item 9)")
    tp.add_argument("--profile", default=None,
                    help="not supported yet (ROADMAP Queue 1 item 10)")
    tp.set_defaults(fn=cmd_train)
    for name, fn, help_ in (
            ("eval", cmd_eval, "greedy evaluation of a DRQN"),
            ("compare-sps", cmd_compare_sps, "DIRAL vs SPS PRR comparison")):
        sp = sub.add_parser(name, help=help_)
        sp.add_argument("config")
        sp.add_argument("--seed", type=int, default=None)
        sp.add_argument("--num-envs", type=int, default=None)
        sp.add_argument("--steps", type=int, default=500)
        sp.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
        sp.add_argument("--checkpoint", default=None,
                        help="not supported yet (ROADMAP Queue 1 item 4)")
        sp.set_defaults(fn=fn)
    for name, fn, help_ in (
            ("train-ppo", cmd_train_ppo, "on-policy PPO training"),
            ("train-ps", cmd_train_ps,
             "in-process PS-DQN / PS-DRQN training on the batched env")):
        sp = sub.add_parser(name, help=help_)
        sp.add_argument("config")
        sp.add_argument("--seed", type=int, default=None)
        sp.add_argument("--num-envs", type=int, default=None)
        sp.add_argument("--episodes", type=int, default=None)
        sp.add_argument("--device", default=None,
                        help="cuda (default) or cpu")
        if name == "train-ps":
            sp.add_argument("--algo", choices=["ps-dqn", "ps-drqn"],
                            default=None,
                            help="defaults to the config's RLAgent.algorithm")
        sp.set_defaults(fn=fn)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
