"""Mesh and sharding layout of the actor-learner (diral_tpu/parallel/mesh.py).

Strategy, as in the JAX package:

* **DP ("data" axis)**: env instances shard over ranks -- every per-env
  carry tensor (``env_axis``: env state, history, state, replay ring,
  shaping counters, previous actions) holds the rank's slice of the env
  axis.  The learner sees experience from all shards through the
  cross-env window sample (train/loop.py): each rank gathers the windows
  it owns into a zeroed batch and ONE all-reduce over the data group
  completes it.  The batch is then replicated, every rank takes the same
  gradient steps, and that all-reduce doubles as the gradient sync.
* **"model" axis**: accepted, with the learner replicated on every rank
  of a model row.  GSPMD shards the wide learner matrices by columns and
  computes them column-parallel; the port's K1-K4 take whole matrices,
  so each model rank keeps and updates the whole learner itself (Adam is
  elementwise: the same result with no collective).  The model ranks of
  a data index hold the same env shard and take no part in a
  collective.

One process per device (parallel/distributed.py): rank r sits at data
index r // M, model index r % M -- JAX's ``make_mesh`` layout,
``reshape(n // M, M)`` -- and ``make_mesh`` builds one process group per
data column.  A collective over a group of one is skipped.

``COLLECTIVES``: set it to a list and every collective the process then
issues is noted there (op, axis, element count, bytes); None (the
default) notes nothing.  The all-reduce and the all-gather also open a
``parallel.<op>`` span (utils/spans.py) with the op and its bytes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from diral_tpu_torch.parallel import distributed
from diral_tpu_torch.utils import spans

# None, or a list that receives {"op", "axis", "numel", "bytes"} for every
# collective this process issues
COLLECTIVES: list[dict] | None = None

# rank 0's device bytes for one step of ``gather_to_primary`` (all the
# group's pieces together), so a checkpoint save never holds more than
# this on its card however many ranks send
SAVE_CHUNK_BYTES = 256 << 20


@dataclass(frozen=True)
class Mesh:
    data: int
    model: int = 1
    rank: int = 0
    backend: str | None = None     # None: one process, no collectives
    staged: bool = False           # gloo on CUDA tensors: via host memory
    data_group: object = None

    @property
    def distributed(self) -> bool:
        return self.backend is not None

    @property
    def data_index(self) -> int:
        return self.rank // self.model

    @property
    def model_index(self) -> int:
        return self.rank % self.model

    def env_slice(self, num_envs: int) -> tuple[int, int]:
        """(start, count) of this rank's env shard."""
        per = num_envs // self.data
        return self.data_index * per, per


def rank_layout(n: int, model_parallel: int = 1) -> np.ndarray:
    """Rank ids laid out as JAX's ``make_mesh`` lays out devices."""
    if n % model_parallel:
        raise ValueError(f"{n} ranks do not split into model={model_parallel}")
    ranks = np.arange(n)
    if model_parallel > 1:
        return ranks.reshape(n // model_parallel, model_parallel)
    return ranks


def mesh_from_spec(spec: str) -> Mesh:
    """Parse a CLI mesh spec: ``"data=8"`` or ``"data=4,model=2"``.

    One process per device: a mesh of n = data * model ranks needs a
    process group of exactly n processes (``--coordinator``,
    ``--num-processes``, ``--process-id``); unknown axes raise."""
    sizes = {"data": 1, "model": 1}
    for part in spec.split(","):
        name, _, val = part.partition("=")
        name = name.strip()
        if name not in sizes:
            raise ValueError(
                f"unknown mesh axis {name!r} in --mesh {spec!r} "
                f"(supported: data, model)")
        sizes[name] = int(val)
    n = sizes["data"] * sizes["model"]
    avail = distributed.process_count()
    if n != avail:
        raise ValueError(
            f"--mesh {spec!r} needs {n} devices; only {avail} visible "
            f"(the port runs one process per device: start {n} processes "
            f"with --coordinator/--num-processes/--process-id)"
            if n > avail else
            f"--mesh {spec!r} spans {n} devices but {avail} processes "
            f"joined the group (--num-processes must equal the mesh size)")
    return make_mesh(n, model_parallel=sizes["model"])


def make_mesh(n_devices: int | None = None, model_parallel: int = 1) -> Mesh:
    """The mesh over the run's n processes: ("data",) or ("data", "model").
    Every process must call it (``dist.new_group`` is collective)."""
    rt = distributed.runtime()
    world = 1 if rt is None else rt.world
    n = world if n_devices is None else n_devices
    if n != world:
        raise ValueError(f"a mesh of {n} ranks needs {n} processes; "
                         f"{world} joined")
    layout = rank_layout(n, model_parallel).reshape(-1, model_parallel)
    D, M = layout.shape
    if rt is None:
        return Mesh(D, M)
    data_groups = [dist.new_group(layout[:, m].tolist()) for m in range(M)]
    return Mesh(D, M, rt.rank, rt.backend, rt.staged,
                data_groups[rt.rank % M])


# ---------------------------------------------------------------------------
# Collectives over the data group (noted in COLLECTIVES)
# ---------------------------------------------------------------------------


def _issue(op: str, mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    if COLLECTIVES is not None:
        COLLECTIVES.append({"op": op, "axis": "data", "numel": x.numel(),
                            "bytes": x.numel() * x.element_size()})
    return (x.cpu() if mesh.staged else x).contiguous()


def _trivial(mesh: Mesh) -> bool:
    return not mesh.distributed or mesh.data == 1


def all_reduce_sum(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sum of ``x`` over the data group (``x`` itself in a group of
    one)."""
    if _trivial(mesh):
        return x
    with spans.span("parallel.all_reduce", op="all_reduce",
                    bytes=x.numel() * x.element_size()):
        y = _issue("all_reduce", mesh, x)
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=mesh.data_group)
        return y.to(x.device)


def all_gather(x: torch.Tensor, mesh: Mesh, dim: int = 0) -> torch.Tensor:
    """The data group's tensors concatenated along ``dim``, on every
    member."""
    if _trivial(mesh):
        return x
    with spans.span("parallel.all_gather", op="all_gather",
                    bytes=x.numel() * x.element_size()):
        y = _issue("all_gather", mesh, x)
        parts = [torch.empty_like(y) for _ in range(mesh.data)]
        dist.all_gather(parts, y, group=mesh.data_group)
        return torch.cat(parts, dim).to(x.device)


def barrier(mesh: Mesh) -> None:
    """Wait for every rank of the run (no-op in one process)."""
    if mesh.distributed and distributed.process_count() > 1:
        dist.barrier()


def gather_to_primary(x: torch.Tensor, mesh: Mesh,
                      out: torch.Tensor | None) -> None:
    """Stream the data group's shards of ``x`` (env axis first, each rank
    ``x.shape[0]`` envs, contiguous) into ``out`` on global rank 0: a
    host tensor of the global shape (None on the other ranks).  The
    shards go in steps of at most ``SAVE_CHUNK_BYTES`` for the whole
    group, so rank 0's card holds one step's pieces, not the global
    tensor.  Only the members of rank 0's data group take part; every
    one of them must call it."""
    if mesh.model_index != 0:
        return
    D = mesh.data
    flat = x.reshape(-1)
    whole = None if out is None else out.view(D, -1)
    step = max(1, min(flat.numel(),
                      SAVE_CHUNK_BYTES // (D * x.element_size())))
    # rank 0's receive buffers, made once: a list made anew each step
    # would hold the last step's pieces too while it forms (2 steps)
    bufs = None if whole is None else torch.empty(
        (D, step), dtype=x.dtype,
        device=torch.device("cpu") if mesh.staged else x.device)
    for a in range(0, flat.numel(), step):
        y = _issue("gather", mesh, flat[a:a + step])
        n = y.numel()
        dist.gather(y, None if bufs is None else list(bufs[:, :n].unbind(0)),
                    dst=0, group=mesh.data_group)
        if whole is not None:
            for r in range(D):
                whole[r, a:a + n].copy_(bufs[r, :n])


# ---------------------------------------------------------------------------
# Layout: the carry's env axis
# ---------------------------------------------------------------------------


ENV_FIELDS = ("history", "state", "sum_ia_prev", "ia_counter",
              "prev_actions")


def env_axis(carry) -> dict:
    """Every tensor of a TrainCarry that lies on the env axis -- the
    "data" mesh axis -- by name: ``env_state.<field>``, ``replay.buf``
    and the carry's own per-env fields.  Everything else (the learner,
    the ring's pointer and fill, the schedules) is replicated.  Sharding,
    checkpoint save and restore all read this one map."""
    env = carry.env_state
    out = {f"env_state.{f.name}": getattr(env, f.name)
           for f in dataclasses.fields(env)}
    out["replay.buf"] = carry.replay.buf
    out.update({k: getattr(carry, k) for k in ENV_FIELDS})
    return out


def with_env_axis(carry, tensors: dict):
    """``carry`` with its env-axis tensors replaced by ``tensors`` (keyed
    as ``env_axis`` keys them)."""
    env = {k.split(".", 1)[1]: v for k, v in tensors.items()
           if k.startswith("env_state.")}
    return carry.replace(
        env_state=carry.env_state.replace(**env),
        replay=dataclasses.replace(carry.replay, buf=tensors["replay.buf"]),
        **{k: tensors[k] for k in ENV_FIELDS})


def shard_carry(carry, mesh: Mesh):
    """Place a one-device carry onto the mesh: this rank's slice of every
    env-axis tensor; the learner, scalars and schedules as they are."""
    start, count = mesh.env_slice(carry.history.shape[0])
    return with_env_axis(carry, {
        k: x[start:start + count].clone()
        for k, x in env_axis(carry).items()})
