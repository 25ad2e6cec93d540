"""Command-line interface of the port (diral_tpu/train/cli.py):

    python -m diral_tpu_torch train       <config.yaml> [--slots N] [--seed S]
                                          [--num-envs B] [--workdir DIR]
                                          [--resume] [--profile DIR]
                                          [--device cuda|cpu]
    python -m diral_tpu_torch eval        <config.yaml> [--steps N] [--seed S]
                                          [--num-envs B] [--checkpoint DIR]
                                          [--best] [--device cuda|cpu]
    python -m diral_tpu_torch compare-sps <config.yaml> [same options]
    python -m diral_tpu_torch train-sweep <config.yaml> [--seeds S]
                                          [--slots N] [--eval-steps N]
                                          [--num-envs B] [--device cuda|cpu]
    python -m diral_tpu_torch train-ppo   <config.yaml> [--episodes N]
                                          [--seed S] [--num-envs B]
                                          [--device cuda|cpu]
    python -m diral_tpu_torch train-ps    <config.yaml> [--algo ps-dqn|ps-drqn]
                                          [--episodes N] [--seed S]
                                          [--num-envs B] [--device cuda|cpu]
    python -m diral_tpu_torch profile     <config.yaml> [--slots N] [--top K]
                                          [--dtype D] [--trace-dir DIR]
                                          [--num-envs B] [--device cuda|cpu]
    python -m diral_tpu_torch serve       [--mode drqn|drqn-rssi|ps-dqn|sps|
                                          compare] [--config YAML]
                                          [--users U] [--channels C]
                                          [--rounds R] [--train-every K]
                                          [--n-batches N] [--eps E]
                                          [--eps-final E] [--reward-design D]
                                          [--distance-reward] [--port P]
                                          [--transport framed|zmq]
                                          [--seed S] [--device cuda|cpu]
    python -m diral_tpu_torch bench       [--device cuda|cpu]

``train`` runs every simulation of the config (runner.run_all_simulations)
and writes the reference-layout results under ``--workdir``; ``--resume``
continues from the latest checkpoint there (a cold start when there is
none) and ``--profile DIR`` writes a torch.profiler Chrome trace of the run
into DIR; the profiler holds every event of the run in host memory until
it ends, so ``--profile`` is for short runs (``--slots``).  ``train-sweep`` trains seeds 0..S-1 (train/sweep.py) and prints
one JSON row per seed; ``profile`` prints train/profiling.py's summary.
``train-ppo`` (train/ppo_loop.run_ppo) and ``train-ps``
(train/ps_loop.run_ps; ``--algo`` defaults to the config's
``RLAgent.algorithm``) print one JSON line with the JAX verbs' keys.
``eval`` and ``compare-sps`` take the learner of ``--checkpoint DIR``'s
latest checkpoint (``--best``: of ``DIR_best``, the best-reward snapshot);
without one the parameters come from ``drqn_init`` with the port's
generator seeded by ``--seed``.  The rollout itself is seeded 1, as in
the JAX verbs.  ``serve`` serves the port's C++ RealNeS stand-in
(interop/serve.py, the simulator built into build/ at first use) and
prints one JSON line of stats with the JAX verb's keys (plus ``timing``);
``--transport zmq`` needs pyzmq and a loadable libzmq.so.5.  ``bench``
runs the benchmark of diral_tpu_torch/bench.py (headline, kernel parity,
100v/50r engine, training loop) and prints its JSON line; it exits 1
when the parity check or a section failed.  Every verb runs on the CUDA
device unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

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


def _ckpt_dir(args):
    """--best swaps in the best-metric snapshot the runner keeps beside
    the rolling checkpoints."""
    if args.best:
        return args.checkpoint.rstrip("/") + "_best"
    return args.checkpoint


def _params(args, cfg, device):
    from diral_tpu_torch.models.qnets import drqn_init
    from diral_tpu_torch.train import checkpoint as ckpt

    if args.checkpoint:
        learner, step = ckpt.load_learner(_ckpt_dir(args), cfg, device)
        print(f"loaded checkpoint at slot {step}")
        return learner.params
    if args.best:
        raise ValueError("--best needs --checkpoint DIR")
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
_NOT_YET = {"mesh": "Queue 1, Parallel", "coordinator": "Queue 1, Parallel"}


def cmd_train(args):
    from diral_tpu_torch.device import resolve_device
    from diral_tpu_torch.train.runner import run_all_simulations

    for opt, item in _NOT_YET.items():
        if getattr(args, opt):
            raise NotImplementedError(
                f"--{opt} is not ported yet (ROADMAP {item})")
    cfg = _load(args)
    dev = resolve_device(args.device)
    kw = dict(workdir=args.workdir, seed=args.seed, resume=args.resume,
              dtype=_DTYPE[cfg.engine.dtype], device=dev)
    if not args.profile:
        run_all_simulations(cfg, **kw)
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        run_all_simulations(cfg, **kw)
    os.makedirs(args.profile, exist_ok=True)
    prof.export_chrome_trace(os.path.join(args.profile, "trace.json"))
    print(f"profiler trace written to {args.profile}")


def cmd_train_sweep(args):
    from diral_tpu_torch.device import resolve_device
    from diral_tpu_torch.train.evaluate import compare_drqn_vs_sps
    from diral_tpu_torch.train.sweep import run_seed_sweep, split_seed

    cfg = _load(args)
    dev = resolve_device(args.device)
    dtype = _DTYPE[cfg.engine.dtype]
    seeds = list(range(args.seeds))
    carries, logs = run_seed_sweep(cfg, seeds, dtype=dtype, device=dev)
    sr = logs["sum_reward"][:, :, 0]          # [S, T]
    tail = sr[:, -max(1, sr.shape[1] // 10):].mean(axis=1)
    rows = []
    for i, s in enumerate(seeds):
        comp = compare_drqn_vs_sps(cfg, split_seed(carries, i).learner.params,
                                   1, steps=args.eval_steps, dtype=dtype,
                                   device=dev)
        rows.append({"seed": s,
                     "final_mean_sum_reward": round(float(tail[i]), 3),
                     "drqn_prr": round(comp["drqn"]["mean_prr"], 4),
                     "sps_prr": round(comp["sps"]["mean_prr"], 4),
                     "prr_improvement": round(comp["prr_improvement"], 4)})
    print(json.dumps(rows))


def cmd_profile(args):
    from diral_tpu_torch.train.profiling import profile_training

    print(json.dumps(profile_training(
        args.config, envs=args.num_envs or 16, slots=args.slots or 100,
        top=args.top, dtype=args.dtype, trace_dir=args.trace_dir,
        device=args.device)))


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


def cmd_serve(args):
    """Online serving against the port's C++ RealNeS stand-in: the
    reference's intended-but-never-runnable external-simulator mode
    (main_test.py:291-293 hard-disables it)."""
    from diral_tpu_torch.config import load_config
    from diral_tpu_torch.device import resolve_device
    from diral_tpu_torch.interop.gateway_env import GatewayEnv
    from diral_tpu_torch.interop.serve import (compare_sps_over_gateway,
                                               serve_and_learn,
                                               serve_and_learn_dqn, serve_sps,
                                               tuned_agent)

    dev = resolve_device(args.device)
    acfg = load_config(args.config).agent if args.config else tuned_agent()

    seed = args.seed or 0
    if args.mode == "compare":
        print(json.dumps(compare_sps_over_gateway(
            acfg, sim_users=args.users, sim_channels=args.channels,
            rounds=args.rounds, train_every=args.train_every,
            n_batches=args.n_batches, eps=args.eps,
            eps_final=args.eps_final, seed=seed,
            transport=args.transport, device=dev)))
        return

    sim_mode = {"drqn": "dist", "drqn-rssi": "syn", "ps-dqn": "syn",
                "sps": "sps"}[args.mode]
    env = GatewayEnv(port=args.port, sim_start=True, sim_users=args.users,
                     sim_channels=args.channels, sim_rounds=args.rounds + 5,
                     sim_seed=seed, sim_mode=sim_mode, state_design=2,
                     pos_dist=2, reward_design=args.reward_design,
                     distance_based_reward=args.distance_reward,
                     sim_transport=args.transport)
    try:
        if args.mode == "sps":
            print(json.dumps(serve_sps(env, args.rounds, seed=seed,
                                       device=dev)))
            return
        if args.mode == "ps-dqn":
            _, stats = serve_and_learn_dqn(
                env, acfg, args.rounds, train_every=args.train_every,
                n_batches=args.n_batches, eps=args.eps,
                eps_final=args.eps_final, seed=seed, device=dev)
        else:
            _, stats = serve_and_learn(
                env, acfg, args.rounds, train_every=args.train_every,
                n_batches=args.n_batches, eps=args.eps,
                eps_final=args.eps_final, seed=seed, mode=sim_mode,
                device=dev)
        stats["losses"] = stats["losses"][-5:]
        print(json.dumps(stats))
    finally:
        env.close()


def cmd_bench(args):
    from diral_tpu_torch import bench

    code = bench.main(args.device)
    if code:
        raise SystemExit(code)


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
                    help="continue from the latest checkpoint in --workdir")
    tp.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of the run into DIR "
                         "(short runs: every event is held in memory)")
    tp.add_argument("--mesh", default=None,
                    help="not supported yet (ROADMAP Queue 1, Parallel)")
    tp.add_argument("--coordinator", default=None,
                    help="not supported yet (ROADMAP Queue 1, Parallel)")
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
        sp.add_argument("--checkpoint", default=None, metavar="DIR",
                        help="evaluate the learner of DIR's latest "
                             "checkpoint")
        sp.add_argument("--best", action="store_true",
                        help="use the best-reward snapshot (DIR_best) "
                             "instead of the latest")
        sp.set_defaults(fn=fn)
    sp = sub.add_parser("train-sweep",
                        help="multi-seed training, one experiment per seed")
    sp.add_argument("config")
    sp.add_argument("--num-envs", type=int, default=None)
    sp.add_argument("--slots", type=int, default=None)
    sp.add_argument("--seeds", type=int, default=8,
                    help="number of seeds (0..N-1)")
    sp.add_argument("--eval-steps", type=int, default=500)
    sp.add_argument("--device", default=None, help="cuda (default) or cpu")
    sp.set_defaults(fn=cmd_train_sweep)
    sp = sub.add_parser("profile",
                        help="per-kernel device profile of the training loop")
    sp.add_argument("config")
    sp.add_argument("--num-envs", type=int, default=None)
    sp.add_argument("--slots", type=int, default=100)
    sp.add_argument("--top", type=int, default=25)
    sp.add_argument("--dtype", default="float32")
    sp.add_argument("--trace-dir", default=None,
                    help="write the Chrome trace here (default: none)")
    sp.add_argument("--device", default=None, help="cuda (default) or cpu")
    sp.set_defaults(fn=cmd_profile)
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
    sp = sub.add_parser(
        "serve", help="online serving against the C++ RealNeS stand-in")
    sp.add_argument("--config", default=None,
                    help="optional YAML for the agent section")
    sp.add_argument("--mode", default="drqn",
                    choices=["drqn", "drqn-rssi", "ps-dqn", "sps", "compare"],
                    help="drqn: neighbor-table states; drqn-rssi: RSSI "
                         "states; ps-dqn: feedforward PS-DQN on RSSI "
                         "states; sps: the SPS baseline online; compare: "
                         "DIRAL-vs-SPS tail PRR on the same world seed")
    sp.add_argument("--users", type=int, default=8)
    sp.add_argument("--channels", type=int, default=6)
    sp.add_argument("--rounds", type=int, default=400)
    sp.add_argument("--train-every", type=int, default=10)
    sp.add_argument("--n-batches", type=int, default=4)
    sp.add_argument("--eps", type=float, default=0.5)
    sp.add_argument("--eps-final", type=float, default=0.02)
    sp.add_argument("--reward-design", type=int, default=2)
    sp.add_argument("--distance-reward", action="store_true",
                    help="rewards from reported positions "
                         "(realness_env.py:120-191) instead of PRR")
    sp.add_argument("--port", type=int, default=0)
    sp.add_argument("--transport", default="framed",
                    choices=["framed", "zmq"],
                    help="wire flavor for bridge AND simulator: "
                         "length-prefixed TCP or real libzmq")
    sp.add_argument("--seed", type=int, default=None)
    sp.add_argument("--device", default=None, help="cuda (default) or cpu")
    sp.set_defaults(fn=cmd_serve)
    sp = sub.add_parser("bench", help="run the throughput benchmark")
    sp.add_argument("--device", default=None, help="cuda (default) or cpu")
    sp.set_defaults(fn=cmd_bench)
    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
