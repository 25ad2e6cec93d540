"""The readings that a cell's limits are set from, in one process on the
card: the check's numbers for a dozen seeds of the program as the
configuration states it (the lower readings), for the lower-precision
control and for faults planted in the program (the upper readings).
The control's overrides, the faults and how each is planted are the
cell's algorithm module's (``CONTROL``, ``faults``, ``planted``; DRQN's
in benchmark/algorithms/drqn.py).  Each run is the cell's own set-up at
its own sizes, followed by the check; the benchmark's runs never call
this.

    python3 benchmark/tools/readings.py --workload <name> --seeds 12 \
        --control 3 --faults 3 [--out FILE]

A cell on several cards runs one process a card, as benchmark/run.py
does."""

from __future__ import annotations

import argparse
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

from benchmark.harness import ranks, spec  # noqa: E402
from benchmark.harness.cell import join_mesh, program_config  # noqa: E402
from diral_tpu_torch.config import load_config  # noqa: E402

SEED0 = 2_147_483_000


def reading(cell, seed: int, device, overrides=None, fault=None,
            mesh=None):
    """The check's numbers for one seed of the cell's set-up (on rank 0;
    the other ranks of a mesh return None)."""
    tp, algo = cell.traffic_params, cell.algorithm
    cfg = program_config(load_config(cell.config_path), tp, overrides)
    with algo.planted(fault):
        session = algo.set_up(cfg, tp, seed, device, mesh)
    cap = session.capture
    session.close()
    del session
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = (algo.check(cap, cfg, device)
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
    algo = cell.algorithm
    plan = [("sound", None, None)] * args.seeds
    plan += [("control", algo.CONTROL, None)] * args.control
    for fault in algo.faults(mesh):
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
