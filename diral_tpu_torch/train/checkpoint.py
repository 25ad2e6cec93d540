"""Checkpoint / resume of a DRQN training run (diral_tpu/train/checkpoint.py).

The whole ``loop.TrainCarry`` is written with ``torch.save``: the online and
target nets' and Adam's ``state_dict``s, the replay ring with its host
pointer and fill count, every ``EnvState`` field, the history window, the
state, the epsilon and Boltzmann schedules and the shaping counters.  The
port's random stream lives outside the carry (a ``torch.Generator``,
loop.py's ``Draws``), so its state is written beside it; with it a resumed
run continues bit for bit where the saved one stopped.

A checkpoint is ``<directory>/ckpt_<step>.pt``, written to a temporary file
in the same directory and renamed into place, so a run cut mid-write leaves
the previous checkpoints whole.  Only the last ``max_to_keep`` are kept, as
Orbax's manager keeps them.  The file holds tensors, Python scalars and
plain containers only, so ``torch.load(..., weights_only=True)`` reads it;
tensors keep their dtype (a bf16 ring stays bf16).

Under a mesh (parallel/mesh.py) rank 0 gathers the env-axis tensors over
the data group (the learner is replicated) and writes the same file a
one-device run writes at that slot; every rank restores from it and
slices its own part.  So ``--resume``, ``eval --checkpoint`` and
``compare-sps --checkpoint`` work across mesh shapes, as Orbax's sharded
restore does for the JAX package.  Every rank calls ``save``: the gathers
are collective.  They stream each shard through rank 0's card in steps of
``mesh.SAVE_CHUNK_BYTES`` into file-backed host tensors, so a save needs
neither the global replay ring on a card nor in the process's memory.

A run directory of the JAX package (Orbax) is not readable here, and the
JAX package's restore shims for its older layouts have no counterpart.
"""

from __future__ import annotations

import dataclasses
import os
import re
import tempfile

import numpy as np
import torch

from diral_tpu_torch.parallel import mesh as pmesh

_NAME = re.compile(r"^ckpt_(\d+)\.pt$")


def _path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt_{step}.pt")


def steps(directory: str) -> list[int]:
    """The steps of the checkpoints in ``directory``, ascending."""
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_NAME.match,
                                               os.listdir(directory)) if m)


def latest_step(directory: str) -> int | None:
    found = steps(directory)
    return found[-1] if found else None


def _host_tensor(directory: str, shape, dtype) -> torch.Tensor:
    """A host tensor backed by an unlinked file in ``directory``: the
    page cache, not the process's memory, holds what a mesh save
    gathers, however many shards it comes from."""
    os.makedirs(directory, exist_ok=True)
    fd, path = tempfile.mkstemp(prefix=".gather_", dir=directory)
    os.close(fd)
    if not int(np.prod(shape)):
        os.remove(path)
        return torch.empty(shape, dtype=dtype)
    try:
        return torch.from_file(path, shared=True, dtype=dtype,
                               size=int(np.prod(shape))).view(shape)
    finally:
        os.remove(path)


def _nest(tree: dict, name: str, value) -> None:
    head, _, rest = name.partition(".")
    if rest:
        _nest(tree.setdefault(head, {}), rest, value)
    else:
        tree[head] = value


def _lookup(tree: dict, name: str):
    for part in name.split("."):
        tree = tree[part]
    return tree


def carry_state(carry, mesh=None, directory: str = ".") -> dict | None:
    """The carry as a ``weights_only``-loadable dict.  Under a mesh that
    shards envs: the one-device carry's, on rank 0 (None on the other
    ranks, which must call it too), each env-axis tensor streamed over
    the data group into a host tensor backed by a file in ``directory``
    (parallel/mesh.gather_to_primary)."""
    primary = mesh is None or mesh.rank == 0
    sharded = mesh is not None and mesh.distributed and mesh.data > 1

    def whole(x):
        if not sharded:
            return x
        out = None
        if primary:
            out = _host_tensor(directory, (mesh.data * x.shape[0],
                                           *x.shape[1:]), x.dtype)
        pmesh.gather_to_primary(x, mesh, out)
        return out

    # the gathers run in this order on every rank
    tensors = {k: whole(x) for k, x in pmesh.env_axis(carry).items()}
    if not primary:
        return None
    rp, lr = carry.replay, carry.learner
    state = {
        "replay": {"ptr": int(rp.ptr), "count": int(rp.count)},
        "learner": {"params": lr.params.state_dict(),
                    "target_params": lr.target_params.state_dict(),
                    "opt": lr.opt.state_dict()},
        "eps_state": {"eps": float(carry.eps_state.eps),
                      "episode": int(carry.eps_state.episode)},
        "beta": float(carry.beta),
    }
    for k, x in tensors.items():
        _nest(state, k, x)
    return state


def save(directory: str, step: int, carry, generator=None,
         max_to_keep: int = 3, mesh=None) -> str:
    """Write ``carry`` at slot ``step`` (and ``generator``'s state, when the
    run draws from one) atomically; drop all but the last ``max_to_keep``.
    Returns the checkpoint's path.  Under a ``mesh`` every rank calls it
    and rank 0 writes the one-device file."""
    state = carry_state(carry, mesh, directory)
    if state is None:
        return _path(directory, step)
    os.makedirs(directory, exist_ok=True)
    blob = {"step": int(step), "device": carry.history.device.type,
            "carry": state, "generator": None}
    if generator is not None:
        blob["generator"] = {"device": generator.device.type,
                             "state": generator.get_state()}
    fd, tmp = tempfile.mkstemp(prefix=".ckpt_", suffix=".tmp", dir=directory)
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(blob, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, _path(directory, step))
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    for old in steps(directory)[:-max_to_keep]:
        os.remove(_path(directory, old))
    return _path(directory, step)


def _load(directory: str, step: int | None, **kw):
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint found in {directory}")
    return torch.load(_path(directory, step), weights_only=True, **kw), step


def _into(dst: torch.Tensor, src: torch.Tensor, what: str) -> torch.Tensor:
    if src.shape != dst.shape or src.dtype != dst.dtype:
        raise ValueError(
            f"checkpoint {what}: {tuple(src.shape)} {src.dtype} does not fit "
            f"the run's {tuple(dst.shape)} {dst.dtype} (another config?)")
    return src.to(dst.device)


def restore(directory: str, carry, generator=None, step: int | None = None,
            mesh=None):
    """Load the checkpoint at ``step`` (default the latest) into the
    structure of ``carry`` (the run's fresh ``init_carry``, on its device)
    and ``generator``'s state into ``generator``.  Returns (carry, step).
    Under a ``mesh`` ``carry`` is this rank's shard and takes its slice
    of the one-device file (read through mmap).

    A generator's state is device-specific (a CUDA generator's is its
    Philox seed and offset): a checkpoint written with a generator of
    another device type is refused."""
    blob, step = _load(directory, step, map_location="cpu",
                       mmap=mesh is not None)
    lo, count = (0, None) if mesh is None else mesh.env_slice(
        blob["carry"]["history"].shape[0])

    def mine(x, dst):
        # this rank's slice, read from the mapped file straight to the
        # run's device (a copy out of the mapping on the CPU)
        if count is None:
            return x
        return x[lo:lo + count].to(dst.device, copy=True)
    saved = blob["generator"]
    if generator is not None:
        if saved is None:
            raise ValueError(f"checkpoint {step} in {directory} holds no "
                             "generator state to resume the run's draws")
        if saved["device"] != generator.device.type:
            raise ValueError(
                f"checkpoint {step} in {directory} was written with a "
                f"{saved['device']} generator; it cannot resume a run that "
                f"draws on {generator.device.type} (the random streams "
                "differ by device)")
        generator.set_state(saved["state"])
    s = blob["carry"]
    carry = pmesh.with_env_axis(carry, {
        k: _into(x, mine(_lookup(s, k), x), k)
        for k, x in pmesh.env_axis(carry).items()})
    lr = carry.learner
    lr.params.load_state_dict(s["learner"]["params"])
    lr.target_params.load_state_dict(s["learner"]["target_params"])
    lr.opt.load_state_dict(s["learner"]["opt"])
    eps = s["eps_state"]
    carry = carry.replace(
        replay=dataclasses.replace(carry.replay, ptr=s["replay"]["ptr"],
                                   count=s["replay"]["count"]),
        eps_state=dataclasses.replace(carry.eps_state,
                                      eps=np.float32(eps["eps"]),
                                      episode=eps["episode"]),
        beta=np.float32(s["beta"]))
    return carry, step


def load_learner(directory: str, cfg, device=None, step: int | None = None):
    """The learner of the checkpoint at ``step`` (default the latest) on
    ``device`` (any: a checkpoint written on the card evaluates on the CPU
    too), without building the rest of the carry.  Returns
    (drqn.DRQNLearner, step)."""
    from diral_tpu_torch.agents import drqn
    from diral_tpu_torch.device import resolve_device
    from diral_tpu_torch.models import qnets

    dev = resolve_device(device)
    # mmap: the replay ring beside the nets is never read
    blob, step = _load(directory, step, map_location="cpu", mmap=True)
    s = blob["carry"]["learner"]

    def net(sd):
        tree = {}
        for key, value in sd.items():
            group, leaf = key.split(".")
            tree.setdefault(group, {})[leaf] = value.clone().to(dev)
        return qnets.DRQN(tree, cfg.agent)

    learner = drqn.init_learner(net(s["params"]), cfg.agent)
    learner.target_params.load_state_dict(s["target_params"])
    learner.opt.load_state_dict(s["opt"])
    return learner, step
