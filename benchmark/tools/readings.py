"""The readings that a cell's limits are set from, in one process on the
card: the check's numbers for a dozen seeds of the program as the
configuration states it (the lower readings), for the bf16 control
(``compute_dtype: bfloat16``, the program's own lower-precision path)
and for faults planted in the program (the upper readings).  Each run is
the cell's own set-up at its own sizes, followed by the check; the
benchmark's runs never call this.

    python3 benchmark/tools/readings.py --workload <name> --seeds 12 \
        --control 3 --faults 3 [--out FILE]

Faults: ``half_batch`` (the loss's mean over half of each batch),
``reward`` (the env step's reward of each env's first vehicle moved by
0.5 where it is produced), and on a data mesh ``exchange`` (the window
batch's all-reduce between the cards left out).  A cell on several
cards runs one process a card, as benchmark/run.py does.  A gradient step that leaves the weights
unchanged reads 1 in ``update_gap`` by that number's definition and
needs no run (benchmark/tests/test_benchmark_faults.py plants it on the
CPU)."""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import os
import sys
import time

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import capture, ranks, spec  # noqa: E402
from benchmark.harness.cell import join_mesh  # noqa: E402
from benchmark.reference import check  # noqa: E402
from diral_tpu_torch.agents import drqn  # noqa: E402
from diral_tpu_torch.config import load_config  # noqa: E402
from diral_tpu_torch.envs import v2v_env as E  # noqa: E402
from diral_tpu_torch.parallel import mesh as pmesh  # noqa: E402

SEED0 = 2_147_483_000


@contextlib.contextmanager
def planted(fault: str | None):
    """The program with ``fault`` planted for the duration."""
    if fault is None:
        yield
        return
    if fault == "half_batch":
        orig = drqn._td_loss

        def half(q, actions, targets, cfg):
            n = q.shape[0] // 2
            return orig(q[:n], actions[:n], targets[:n], cfg)
        drqn._td_loss = half
        try:
            yield
        finally:
            drqn._td_loss = orig
    elif fault == "reward":
        orig = E.step_channel

        def altered(cfg, state, actions, t, trace=None):
            state, obs, rews = orig(cfg, state, actions, t, trace)
            rews = rews.clone()
            rews[:, 0] += 0.5
            return state, obs, rews
        E.step_channel = altered
        try:
            yield
        finally:
            E.step_channel = orig
    elif fault == "exchange":
        orig = pmesh.all_reduce_sum
        pmesh.all_reduce_sum = lambda x, mesh: x
        try:
            yield
        finally:
            pmesh.all_reduce_sum = orig
    elif fault == "unchanged":
        orig = torch.optim.Adam.step

        def no_step(self, closure=None):
            return None
        torch.optim.Adam.step = no_step
        try:
            yield
        finally:
            torch.optim.Adam.step = orig
    else:
        raise ValueError(f"unknown fault {fault!r}")


def reading(cell, seed: int, device, overrides=None, fault=None,
            mesh=None):
    """The check's numbers for one seed of the cell's set-up (on rank 0;
    the other ranks of a mesh return None)."""
    tp = cell.traffic_params
    cfg = capture.program_config(load_config(cell.config_path), tp,
                                 overrides)
    with planted(fault):
        fns, carry, draws, _, cap = capture.set_up(
            cfg, seed, device, int(tp["start_slot"]), mesh=mesh)
    del fns, carry, draws
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = (check.run(cap, cfg, device)
               if mesh is None or mesh.rank == 0 else None)
    if mesh is not None:
        dist.barrier()
    return numbers


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--faults", type=int, default=3)
    p.add_argument("--seed0", type=int, default=SEED0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    cell = spec.cell(args.workload)
    device = torch.device(args.device)
    mesh, procs = None, []
    if cell.traffic_params.get("mesh"):
        port = args.port
        if args.rank == 0:
            port = ranks.free_port()
            procs = ranks.spawn(os.path.abspath(__file__), sys.argv[1:]
                                if argv is None else argv, cell.chips, port)
        device, mesh = join_mesh(cell.traffic_params["mesh"], args.rank,
                                 cell.chips, port, device)
    plan = [("sound", None, None)] * args.seeds
    plan += [("control", {"network.compute_dtype": "bfloat16"}, None)] \
        * args.control
    faults = ["half_batch", "reward"] + (["exchange"] if mesh else [])
    for fault in faults:
        plan += [(fault, None, fault)] * args.faults
    out = open(args.out, "w") if args.out and args.rank == 0 else None
    for k, (kind, overrides, fault) in enumerate(plan):
        seed = args.seed0 + 7919 * k
        started = time.perf_counter()
        numbers = reading(cell, seed, device, overrides, fault, mesh)
        if numbers is None:
            continue
        line = json.dumps({"workload": args.workload, "kind": kind,
                           "seed": seed, "numbers": numbers,
                           "seconds": time.perf_counter() - started})
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    if mesh is not None:
        from diral_tpu_torch.parallel import distributed
        distributed.shutdown()
    return 1 if any(ranks.join(procs)) else 0


if __name__ == "__main__":
    sys.exit(main())
