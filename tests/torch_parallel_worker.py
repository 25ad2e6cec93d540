"""One rank of a multi-process run of the port's training slots, for
tests/test_torch_parallel.py (not collected: no ``test_`` prefix).

    python tests/torch_parallel_worker.py SPEC.pt RANK PORT

SPEC.pt (torch.save) holds ``world``, ``mesh`` (a spec string) and
``jobs``, each ``{"cfg", "dtype", "slots", "out"}`` plus either ``carry``
(a one-device TrainCarry, placed onto the mesh with ``shard_carry``) and
``draws`` (per-slot global draws: ``eps_draw`` / ``eps_rand`` /
``kicks`` / ``scores`` dicts keyed by slot), or ``seed`` (the carry from
``init_carry`` with a seeded generator's draws, sharded).  Every rank
steps the job's slots; rank 0 writes ``out``: the all-envs sum rewards
and actions, losses, the learner's state and the collectives issued on
each slot.  A job with ``save_dir`` also saves its carry there at the
last slot through ``checkpoint.save`` with ``SAVE_CHUNK_BYTES`` set to
``save_chunk``, and writes the save's collectives beside the rest.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__),
                                                os.pardir)))

from diral_tpu_torch.parallel import distributed  # noqa: E402
from diral_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from diral_tpu_torch.train import checkpoint  # noqa: E402
from diral_tpu_torch.train import loop  # noqa: E402


class TableDraws(loop.Draws):
    """Draws read from per-slot tables at the global B."""

    def __init__(self, table):
        self.table = table

    @property
    def device(self):
        return torch.device("cpu")

    def eps_greedy(self, t, B, N, C):
        return self.table["eps_draw"][t], self.table["eps_rand"][t]

    def velocity_kicks(self, t, B, N):
        return self.table["kicks"][t]

    def sampler_scores(self, t, n, BS):
        return self.table["scores"][t]


def run_job(job, mesh):
    fns = loop.make_train_functions(job["cfg"], job["dtype"], "cpu",
                                    mesh=mesh)
    if "carry" in job:
        carry = pmesh.shard_carry(job["carry"], mesh)
        draws = fns.sharded(TableDraws(job["draws"]))
    else:
        draws = fns.sharded(loop.Draws(
            torch.Generator().manual_seed(job["seed"])))
        carry = fns.init_carry(draws)
    logs, collectives = [], []
    for t in range(job["slots"]):
        pmesh.COLLECTIVES = []
        carry, lg = fns.slot_step(carry, t, draws)
        collectives.append(pmesh.COLLECTIVES)
        logs.append(lg)
    pmesh.COLLECTIVES = []
    if "save_dir" in job:
        pmesh.SAVE_CHUNK_BYTES = job["save_chunk"]
        checkpoint.save(job["save_dir"], job["slots"], carry, mesh=mesh)
    saved, pmesh.COLLECTIVES = pmesh.COLLECTIVES, None
    rewards = pmesh.all_gather(torch.stack([lg["sum_reward"] for lg in logs]),
                               mesh, 1)
    actions = pmesh.all_gather(torch.stack([lg["actions"] for lg in logs]),
                               mesh, 1)
    opt = carry.learner.opt.state_dict()
    if mesh.rank == 0:
        torch.save({
            "sum_reward": rewards, "actions": actions,
            "loss": [None if lg["loss"] is None else lg["loss"].item()
                     for lg in logs],
            "params": carry.learner.params.state_dict(),
            "target_params": carry.learner.target_params.state_dict(),
            "opt": opt, "collectives": collectives,
            "save_collectives": saved, "save_dir": job.get("save_dir")},
            job["out"])


def main():
    spec_path, rank, port = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
    spec = torch.load(spec_path, weights_only=False)
    distributed.initialize(f"127.0.0.1:{port}", spec["world"], rank, "cpu")
    try:
        mesh = pmesh.mesh_from_spec(spec["mesh"])
        for job in spec["jobs"]:
            run_job(job, mesh)
    finally:
        distributed.shutdown()


if __name__ == "__main__":
    main()
