"""Run one benchmark cell once and print its result as the last line of
standard output:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, traffic, limits and metrics are found by
name from ``BENCHMARK.json`` (see benchmark/README.md).  Exits non-zero
without a result when no CUDA device (or fewer than the cell asks for)
is present, when the program cannot be imported, or when JAX or the JAX
package was loaded by the time the window closed.  The numbers compared
with the reference, each beside its limit, are the last lines of
standard error and the result's last key."""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "diral_tpu")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # the other ranks of a cell on several cards (started by rank 0)
    p.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = p.parse_args(argv)

    import torch
    from benchmark.harness import spec
    try:
        # loads the cell's algorithm module, which imports the program
        cell = spec.cell(args.workload)
    except ImportError as exc:
        log(f"the program is not importable here: {exc}")
        return 2
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark measures the card and does not "
            "run elsewhere")
        return 3
    if torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA devices, "
            f"{torch.cuda.device_count()} present")
        return 3
    try:
        from benchmark.harness import cell as cell_run
        from benchmark.harness import ranks
    except ImportError as exc:
        log(f"the program is not importable here: {exc}")
        return 2
    procs, port = [], args.port
    if cell.chips > 1 and args.rank == 0:
        port = ranks.free_port()
        procs = ranks.spawn(os.path.abspath(__file__), sys.argv[1:] if argv
                            is None else argv, cell.chips, port)
    try:
        result = cell_run.run(
            cell, args.seed, args.seconds, bool(args.trace),
            torch.device("cuda", 0), T_START, log=log if args.rank == 0
            else (lambda *a: None), rank=args.rank, world=cell.chips,
            port=port)
    except BaseException:
        ranks.stop(procs)
        raise
    codes = ranks.join(procs)
    found = forbidden_modules()
    if found:
        log(f"loaded by the window's end: {', '.join(found)}")
        return 4
    if args.rank != 0:
        return 0
    if any(codes):
        log(f"ranks 1-{cell.chips - 1} exited with {codes}")
        return 5
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    log(f"correct {result['correct']}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
