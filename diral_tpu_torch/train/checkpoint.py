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


def carry_state(carry) -> dict:
    """The carry as a ``weights_only``-loadable dict."""
    env, rp, lr = carry.env_state, carry.replay, carry.learner
    return {
        "env_state": {f.name: getattr(env, f.name)
                      for f in dataclasses.fields(env)},
        "history": carry.history, "state": carry.state,
        "replay": {"buf": rp.buf, "ptr": int(rp.ptr),
                   "count": int(rp.count)},
        "learner": {"params": lr.params.state_dict(),
                    "target_params": lr.target_params.state_dict(),
                    "opt": lr.opt.state_dict()},
        "eps_state": {"eps": float(carry.eps_state.eps),
                      "episode": int(carry.eps_state.episode)},
        "beta": float(carry.beta),
        "sum_ia_prev": carry.sum_ia_prev, "ia_counter": carry.ia_counter,
        "prev_actions": carry.prev_actions,
    }


def save(directory: str, step: int, carry, generator=None,
         max_to_keep: int = 3) -> str:
    """Write ``carry`` at slot ``step`` (and ``generator``'s state, when the
    run draws from one) atomically; drop all but the last ``max_to_keep``.
    Returns the checkpoint's path."""
    os.makedirs(directory, exist_ok=True)
    blob = {"step": int(step), "device": carry.history.device.type,
            "carry": carry_state(carry), "generator": None}
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


def restore(directory: str, carry, generator=None, step: int | None = None):
    """Load the checkpoint at ``step`` (default the latest) into the
    structure of ``carry`` (the run's fresh ``init_carry``, on its device)
    and ``generator``'s state into ``generator``.  Returns (carry, step).

    A generator's state is device-specific (a CUDA generator's is its
    Philox seed and offset): a checkpoint written with a generator of
    another device type is refused."""
    blob, step = _load(directory, step, map_location="cpu")
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
    env = carry.env_state.replace(**{
        k: _into(getattr(carry.env_state, k), v, f"env_state.{k}")
        for k, v in s["env_state"].items()})
    rp = s["replay"]
    replay = dataclasses.replace(
        carry.replay, buf=_into(carry.replay.buf, rp["buf"], "replay.buf"),
        ptr=rp["ptr"], count=rp["count"])
    lr = carry.learner
    lr.params.load_state_dict(s["learner"]["params"])
    lr.target_params.load_state_dict(s["learner"]["target_params"])
    lr.opt.load_state_dict(s["learner"]["opt"])
    eps = s["eps_state"]
    carry = carry.replace(
        env_state=env, replay=replay,
        eps_state=dataclasses.replace(carry.eps_state,
                                      eps=np.float32(eps["eps"]),
                                      episode=eps["episode"]),
        beta=np.float32(s["beta"]),
        **{k: _into(getattr(carry, k), s[k], k)
           for k in ("history", "state", "sum_ia_prev", "ia_counter",
                     "prev_actions")})
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
