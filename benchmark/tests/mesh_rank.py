"""One rank of a tiny run of the four-card cell on the CPU (gloo), for
test_benchmark_mesh.py: ``python mesh_rank.py RANK PORT OUT [FAULT]``;
rank 0 writes the result to OUT."""

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import torch  # noqa: E402

from benchmark.tests.helpers import MESH_CELL, SEED, cell  # noqa: E402
from benchmark.tests.helpers import run_tiny  # noqa: E402


def main():
    rank, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    fault = sys.argv[4] if len(sys.argv) > 4 else None
    torch.set_num_threads(1)
    with cell(MESH_CELL).algorithm.planted(fault):
        result = run_tiny(MESH_CELL, trace=True, seed=SEED + 5,
                          overrides={"engine.num_envs": 4}, rank=rank,
                          world=4, port=port)
    if rank == 0:
        with open(out, "w") as f:
            json.dump(result, f)


if __name__ == "__main__":
    main()
