"""Multi-process initialization (diral_tpu/parallel/distributed.py).

The JAX package runs one SPMD program on every host and lets
``jax.distributed.initialize`` wire the slice.  The port runs one process
per device, each joined to one ``torch.distributed`` process group: every
process runs the same ``train`` command with its own ``--process-id``, and
the mesh (parallel/mesh.py) lays the ranks out over its axes.

The backend is chosen, never fallen back to.  Before the group forms,
every rank publishes its host name and card count on the rendezvous
store, so every rank takes the same decision from the same facts:

* ``nccl`` when every rank has a GPU of its own: on each host, the ranks
  there are no more than its cards;
* ``gloo`` on the CPU (``--device cpu``) and when ranks share a card:
  NCCL refuses two ranks on one device.  Gloo's collectives on CUDA
  tensors differ by collective, so the mesh stages every gloo collective
  through host memory explicitly (``staged``).

A rank's device is ``cuda:{i % torch.cuda.device_count()}``, where i is
its index among the ranks of its host (its process id on one host).  The
choice is printed on a line of its own.

Host-local artifacts (npy dumps, JSONL, checkpoints) are written by
process 0 only (train/runner.py, train/checkpoint.py).
"""

from __future__ import annotations

import json
import socket
from collections import Counter
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

from diral_tpu_torch.utils import spans


@dataclass(frozen=True)
class Runtime:
    """What ``initialize`` set up for this process."""

    backend: str            # "nccl" or "gloo"
    world: int
    rank: int
    device: torch.device    # this rank's device
    staged: bool            # gloo collectives on CUDA tensors go via host


_RUNTIME: Runtime | None = None


def runtime() -> Runtime | None:
    """The process group's set-up, or None in a single-process run."""
    return _RUNTIME


def choose_backend(device_type: str, ranks: list) -> str:
    """The backend for ranks that reported ``ranks[r] = (host, cards)``:
    NCCL when no host holds more ranks than cards, else gloo."""
    if device_type != "cuda":
        return "gloo"
    per_host = Counter(host for host, _ in ranks)
    cards = dict(ranks)
    return "nccl" if all(n <= cards[h] for h, n in per_host.items()) \
        else "gloo"


def local_index(ranks: list, rank: int) -> int:
    """Rank ``rank``'s index among the ranks on its own host."""
    host = ranks[rank][0]
    return sum(1 for h, _ in ranks[:rank] if h == host)


def _exchange_hosts(store, num_processes: int, process_id: int,
                    device_type: str) -> list:
    """Every rank's (host name, card count), published on the store."""
    cards = torch.cuda.device_count() if device_type == "cuda" else 0
    store.set(f"diral/host/{process_id}",
              json.dumps([socket.gethostname(), cards]))
    return [tuple(json.loads(store.get(f"diral/host/{r}")))
            for r in range(num_processes)]


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               device=None) -> torch.device:
    """Join this process to the run's process group; returns its device.

    A no-op when ``num_processes <= 1`` and no coordinator is given (the
    device is returned as it came).  With a coordinator
    (``"127.0.0.1:1234"``) the group is formed even for one process, so
    a one-rank mesh runs its collectives through the real backend.
    ``device`` is the device type the run asked for (default CUDA)."""
    global _RUNTIME
    from diral_tpu_torch.device import resolve_device

    dev = resolve_device(device)
    if coordinator_address is None:
        if num_processes is not None and num_processes > 1:
            raise ValueError(
                f"--num-processes {num_processes} needs --coordinator "
                "HOST:PORT (every process joins the group there)")
        return dev
    if num_processes is None or process_id is None:
        raise ValueError("--coordinator needs --num-processes and "
                         "--process-id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process-id {process_id} is outside "
                         f"[0, {num_processes})")
    if _RUNTIME is not None:
        if (_RUNTIME.world, _RUNTIME.rank) != (num_processes, process_id):
            raise RuntimeError("this process already joined another group")
        return _RUNTIME.device
    with spans.once("setup.process_group", world=num_processes):
        host, _, port = coordinator_address.rpartition(":")
        store = dist.TCPStore(host, int(port), num_processes,
                              process_id == 0,
                              timeout=timedelta(seconds=300))
        ranks = _exchange_hosts(store, num_processes, process_id, dev.type)
        backend = choose_backend(dev.type, ranks)
        if dev.type == "cuda":
            dev = torch.device("cuda", local_index(ranks, process_id)
                               % torch.cuda.device_count())
            torch.cuda.set_device(dev)
        staged = backend == "gloo" and dev.type == "cuda"
        kw = {"device_id": dev} if backend == "nccl" else {}
        # the rendezvous at tcp://HOST:PORT, through the store made above
        dist.init_process_group(backend, store=store,
                                world_size=num_processes, rank=process_id,
                                **kw)
    _RUNTIME = Runtime(backend, num_processes, process_id, dev, staged)
    how = {"nccl": "one card per rank",
           "gloo": ("ranks share a card; collectives staged through host "
                    "memory" if staged else "CPU tensors")}[backend]
    print(f"backend: {backend} ({num_processes} rank(s), {how}); "
          f"rank {process_id} on {dev}", flush=True)
    return dev


def shutdown() -> None:
    """Leave the process group (no-op without one)."""
    global _RUNTIME
    if _RUNTIME is not None:
        dist.destroy_process_group()
        _RUNTIME = None


def process_index() -> int:
    return 0 if _RUNTIME is None else _RUNTIME.rank


def process_count() -> int:
    return 1 if _RUNTIME is None else _RUNTIME.world


def is_primary() -> bool:
    return process_index() == 0

