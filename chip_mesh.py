#!/usr/bin/env python3
"""The port's data mesh on several H100s, one NCCL rank a card.

    python3 chip_mesh.py [--phases abcdef] [--resumes MESH ...] [--logs DIR]

Needs at least two CUDA cards (four for the whole script) and the CUDA
toolkit; raises with fewer cards.  It builds the kernels once, prints every
card's name and power limit, ``nvidia-smi topo -m`` and ``nproc``, then
runs the phases below, each rank a process of its own started through the
port's own entry points (the ``train`` verb with ``--mesh/--coordinator/
--num-processes/--process-id``, ``bench.bench_scaling``).  A phase that
misses fails the run; the last line is one JSON object ``{"ok", "cards",
"phases"}`` with each phase's result and headline numbers.  ``--phases``
runs only the phases named ((b) and (c) need (a)); ``--logs`` copies
every rank's output there.

(a) ``train configs/scale_100v_50r.yaml --num-envs 16 --slots 400
    --resume`` on one card without a mesh, then under ``--mesh data=4``,
    ``data=2,model=2`` (four ranks) and ``data=2`` (two): every rank on a
    card of its own under the backend ``choose_backend`` names (NCCL),
    and sum rewards, actions, losses and the final checkpoint (learner,
    target, Adam, ring, env, generator) bit-equal to the one-card run's.
    The first mesh run sets ``NCCL_DEBUG=INFO`` and prints the transport
    rank 0's communicator chose.  Beside it ``row_invariance``: the acting
    forward's rows must not depend on the row count.
(b) ``parallel.mesh.COLLECTIVES`` of every rank of (a) and (c): in the
    slot loop exactly one data-group all-reduce of
    ``loop.sampler_collective_bytes`` a train event and nothing else; the
    runner's once-a-chunk log all-gathers and a save's gathers listed.
(c) ``data=4`` cut at slot 300 (after the train events at 274 and 299,
    so that the file holds a trained learner and Adam's moments) and
    resumed: equal to the uncut one-card run; its checkpoint equal to the
    one-card file of the same slot; the device bytes a save adds on rank
    0 at most ``mesh.SAVE_CHUNK_BYTES``;
    the same checkpoint resumed under ``data=4``, ``data=2,model=2``,
    ``data=2`` and one card (or the meshes ``--resumes`` names), each
    equal to the uncut run.
(d) ``__graft_entry__.dryrun_multichip(4)``'s counterpart: the toy at
    layers 32/32, batch 8, n_batch 2, two envs a data rank over
    ``data=2,model=2``, one train slot (t = 49) and one plain slot (t =
    50) held bit for bit against the same slots on one card.
(e) ``bench.bench_scaling`` at n = 1, 2, 4 (toy, 1024 envs a card, a
    64-slot timed chunk, three of them a count): env-slots/s (median and
    samples) and efficiency, beside ``nproc``.
(f) BASELINE configs[4]: ``train configs/scale_100v_50r.yaml --num-envs
    4096 --mesh data=4 --slots 1000`` (1024 envs a card) and 1024 envs at
    ``--mesh data=1``: slots/s over slots [300, 500), [500, 700) and
    [700, 900) (eight train events each) and their median, env-slots/s,
    the weak-scaling efficiency of each span and their median, each
    rank's peak device memory, the NCCL
    all-reduce's device time per train event beside ``width_report``'s
    NVLink projection, and torch.profiler's breakdown of one rank's slot
    over slots [900, 950) (K1, K5 + K6, the train event's K2 + K3,
    elementwise, sort, NCCL, idle) and its kernel launches; then the
    train event's all-reduce alone over the four ranks (``allreduce``
    mode: a barrier before each, CUDA events).  No checkpoint is
    written.

On the cards every rank process gets ``nproc / ranks`` intra-op threads
(``nproc / 4`` in (e) at every count).

``python3 chip_mesh.py rows`` (one card) prints ``row_invariance`` and
the acting forward's device time with and without its fixed-row
products (``act_forward_ms``) alone.

Each rank runs this file's ``rank`` mode (``python3 chip_mesh.py rank
OUT.json [--window A:B:...] [--profile P:Q] -- train ...``): the ``train``
verb's ``cli.main`` with ``COLLECTIVES`` on, its saves, log gathers and
slots instrumented, and a JSON record per rank.  The phase functions take
their widths and options as arguments, so that tests/test_torch_mesh_cards.py
rehearses them on the CPU over gloo (``--device cpu``) at cut widths.
Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
SCALE_YAML = os.path.join(HERE, "configs", "scale_100v_50r.yaml")
PHASE_TIMEOUT_S = 150           # one run's ranks, all together
WIDTH_TIMEOUT_S = 300           # (f)'s runs, 1024 envs a card
# the device kernels of each K id, by name
KERNEL_NAMES = {
    "K1": ("lstm_window_tc_kernel",),
    "K2": ("lstm_triple_tc_kernel",),
    "K3": ("lstm_bwd_rows_tc_kernel", "lstm_bwd_partial_kernel",
           "lstm_bwd_combine_kernel"),
    "K4": ("lstm_dual_tc_kernel",),
    "K5": ("channel_phase_accept_kernel", "channel_phase_merge_kernel"),
    "K6": ("piggy_hist_kernel",),
    "K7": ("lanes_hist_kernel",),
}


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# One rank of a train run (``rank`` mode)
# ---------------------------------------------------------------------------


def slot_category(name: str) -> str:
    """A device kernel's row in the slot breakdown: its K id, ``nccl``,
    or train/profiling.py's category."""
    from diral_tpu_torch.train.profiling import categorize

    for k, names in KERNEL_NAMES.items():
        if any(n in name for n in names):
            return k
    if "nccl" in name.lower():
        return "nccl"
    return categorize(name)


def breakdown(prof, wall_ms: float, slots: int) -> dict:
    """Device ms a slot by row (``slot_category``), with launches a slot,
    over a profiled window of ``slots`` slots and ``wall_ms``; ``idle`` is
    the wall less the device time (kernels on NCCL's stream overlap the
    rest, so a row of ``nccl`` also counts time spent waiting for the
    other ranks).  c10d's ``nccl:<op>`` ranges on the device timeline
    span the NCCL kernel exactly and are left out, not counted twice."""
    from diral_tpu_torch.train.profiling import device_kernels

    by_name, occ = device_kernels(prof)
    by_name = {n: ms for n, ms in by_name.items()
               if not n.startswith("nccl:")}
    rows: dict = {}
    for name, ms in by_name.items():
        r = rows.setdefault(slot_category(name), {"ms": 0.0, "kernels": 0})
        r["ms"] += ms / slots
        r["kernels"] += occ[name] / slots
    busy = sum(r["ms"] for r in rows.values())
    wall = wall_ms / slots
    return {"slots": slots, "wall_ms": wall, "busy_ms": busy,
            "idle_ms": wall - busy,
            "busy_share": busy / wall if wall else None, "rows": rows,
            "nccl_kernels": {n: {"ms": ms, "count": occ[n]}
                             for n, ms in by_name.items()
                             if "nccl" in n.lower()}}


def rank_main(out: str, argv: list, window=None, profile=None) -> None:
    """Run the ``train`` verb on ``argv`` as one rank and write its record
    to ``out``: the collectives it issued (each tagged ``save``, ``logs``
    or ``slot``), the device bytes each save added, the loop's timing,
    the seconds between each two consecutive slots of ``window`` (marks
    taken before the slot runs), a profile of slots [profile), its
    peak device memory, each kernel's launches and its losses."""
    import numpy as np
    import torch

    from diral_tpu_torch.parallel import mesh as pmesh
    from diral_tpu_torch.scripts import full_run
    from diral_tpu_torch.train import checkpoint as ckpt
    from diral_tpu_torch.train import cli, loop, runner

    rec = {"save_bytes": [], "timing": {}, "window_s": None,
           "profile": None, "peak_bytes": None}
    state = {"dev": None, "marks": {}, "prof": None}
    pmesh.COLLECTIVES = []
    wrappers = full_run.kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0

    def sync():
        if state["dev"] is not None and state["dev"].type == "cuda":
            torch.cuda.synchronize(state["dev"])

    def tagged(fn, tag):
        def call(*a, **kw):
            n0 = len(pmesh.COLLECTIVES)
            try:
                return fn(*a, **kw)
            finally:
                for c in pmesh.COLLECTIVES[n0:]:
                    c.setdefault("in", tag)
        return call

    plain_save = tagged(ckpt.save, "save")

    def measured_save(*a, **kw):
        dev = state["dev"]
        if dev is None or dev.type != "cuda":
            rec["save_bytes"].append(0)
            return plain_save(*a, **kw)
        torch.cuda.synchronize(dev)
        before = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        path = plain_save(*a, **kw)
        torch.cuda.synchronize(dev)
        rec["save_bytes"].append(torch.cuda.max_memory_allocated(dev)
                                 - before)
        return path

    plain_experiment = runner.train_experiment

    def experiment(*a, **kw):
        state["dev"] = torch.device(kw["device"])
        if state["dev"].type == "cuda":
            torch.cuda.reset_peak_memory_stats(state["dev"])
        carry, logs = plain_experiment(*a, timing=rec["timing"], **kw)
        sync()
        if state["dev"].type == "cuda":
            rec["peak_bytes"] = torch.cuda.max_memory_allocated(state["dev"])
        np.save(out + ".loss.npy", logs["loss"])
        return carry, logs

    plain_step = loop.TrainFunctions.slot_step

    def slot_step(self, carry, t, draws):
        if window and t in window:
            sync()
            state["marks"][t] = time.perf_counter()
        if profile and t == profile[0]:
            from torch.profiler import ProfilerActivity, profile as prof_

            acts = [ProfilerActivity.CPU]
            if state["dev"].type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            sync()
            state["prof"] = prof_(activities=acts)
            state["prof"].__enter__()
            state["marks"]["profile"] = time.perf_counter()
        carry, logs = plain_step(self, carry, t, draws)
        if profile and t == profile[1] - 1:
            sync()
            wall = (time.perf_counter() - state["marks"]["profile"]) * 1e3
            state["prof"].__exit__(None, None, None)
            rec["profile"] = breakdown(state["prof"], wall,
                                       profile[1] - profile[0])
        return carry, logs

    ckpt.save = measured_save
    runner._chunk_logs = tagged(runner._chunk_logs, "logs")
    runner.train_experiment = experiment
    loop.TrainFunctions.slot_step = slot_step
    cli.main(argv)
    if window and all(t in state["marks"] for t in window):
        rec["window_s"] = [state["marks"][b] - state["marks"][a]
                           for a, b in zip(window, window[1:])]
    rec["collectives"] = [dict(c, **{"in": c.get("in", "slot")})
                          for c in pmesh.COLLECTIVES]
    rec["launches"] = {k: fn.launches for k, fn in wrappers.items()}
    rec["device"] = None if state["dev"] is None else str(state["dev"])
    with open(out, "w") as f:
        json.dump(rec, f)


# ---------------------------------------------------------------------------
# One rank of the dry run (``dry`` mode)
# ---------------------------------------------------------------------------


def dryrun_config(data: int):
    """``__graft_entry__.dryrun_multichip``'s cut toy: layers 32/32, batch
    8, n_batch 2, two envs a data rank."""
    from diral_tpu_torch.config import toy_4ue_3r

    cfg = toy_4ue_3r(time_slots=64, memory_size=64, explore=0,
                     greedy=10_000, training=True, train_after_episode=True,
                     save_positions=False)
    return dataclasses.replace(
        cfg, agent=dataclasses.replace(
            cfg.agent, batch_size=8, n_batch=2, target_update=25,
            network=dataclasses.replace(cfg.agent.network,
                                        layers=(32, 32))),
        engine=dataclasses.replace(cfg.engine, num_envs=2 * data))


def dry_main(out: str, data: int, model: int, port: int | None,
             rank: int, device: str | None) -> None:
    """Slots 49 (a train event) and 50 of ``dryrun_config(data)`` over a
    ``data`` x ``model`` mesh (one process without a coordinator when
    ``port`` is None); writes the all-env logs, the loss and this rank's
    learner to ``out``."""
    import torch

    from diral_tpu_torch.parallel import distributed
    from diral_tpu_torch.parallel import mesh as pmesh
    from diral_tpu_torch.train.loop import Draws, make_train_functions

    cfg = dryrun_config(data)
    world = data * model
    dev = distributed.initialize(
        None if port is None else f"127.0.0.1:{port}",
        None if port is None else world, None if port is None else rank,
        device)
    try:
        mesh = None if port is None else pmesh.make_mesh(world, model)
        fns = make_train_functions(cfg, torch.float32, dev, mesh=mesh)
        draws = fns.sharded(Draws(torch.Generator(device=dev).manual_seed(0)))
        carry = fns.init_carry(draws)
        logs = {}
        for t in (49, 50):
            carry, lg = fns.slot_step(carry, t, draws)
            logs[t] = {
                "sum_reward": pmesh.all_gather(lg["sum_reward"], mesh)
                if mesh else lg["sum_reward"],
                "actions": pmesh.all_gather(lg["actions"], mesh)
                if mesh else lg["actions"],
                "loss": None if lg["loss"] is None else lg["loss"].detach()}
        learner = carry.learner
        blob = {"logs": logs, "params": learner.params.state_dict(),
                "target_params": learner.target_params.state_dict(),
                "opt": learner.opt.state_dict(),
                "backend": None if mesh is None else mesh.backend}
        torch.save(_to_cpu(blob), out)
    finally:
        distributed.shutdown()


def _to_cpu(x):
    import torch

    if isinstance(x, dict):
        return {k: _to_cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_to_cpu(v) for v in x)
    return x.cpu() if isinstance(x, torch.Tensor) else x


# ---------------------------------------------------------------------------
# One rank of the all-reduce alone (``allreduce`` mode)
# ---------------------------------------------------------------------------


def allreduce_main(out: str, world: int, rank: int, port: int,
                   device: str | None, yaml_path: str = SCALE_YAML,
                   reps: int = 10) -> None:
    """The train event's all-reduce alone: ``mesh.all_reduce_sum`` of
    ``sampler_collective_bytes`` of the config at ``yaml_path`` over a
    data=``world`` mesh,
    every rep after a barrier and a sync; writes this rank's ms (CUDA
    events on a card, the host clock on the CPU), median of ``reps``
    after two warm calls."""
    import statistics

    import torch

    from diral_tpu_torch.config import load_config
    from diral_tpu_torch.parallel import distributed
    from diral_tpu_torch.parallel import mesh as pmesh
    from diral_tpu_torch.train.loop import sampler_collective_bytes

    coll = sampler_collective_bytes(load_config(yaml_path))
    dev = distributed.initialize(f"127.0.0.1:{port}", world, rank, device)
    try:
        mesh = pmesh.make_mesh(world)
        cuda = dev.type == "cuda"
        times = []
        for i in range(reps + 2):
            # the sum is taken in place: a fresh input each rep
            x = torch.ones(coll["gathered_elems"], device=dev)
            pmesh.barrier(mesh)
            if cuda:
                torch.cuda.synchronize(dev)
                a, b = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                a.record()
            t0 = time.perf_counter()
            y = pmesh.all_reduce_sum(x, mesh)
            if cuda:
                b.record()
                torch.cuda.synchronize(dev)
            ms = a.elapsed_time(b) if cuda else (time.perf_counter()
                                                 - t0) * 1e3
            if i >= 2:
                times.append(ms)
        ok = bool(torch.all(y == world))
        with open(out, "w") as f:
            json.dump({"ms": statistics.median(times), "min_ms": min(times),
                       "bytes": coll["bytes_per_event"], "sum_ok": ok,
                       "backend": mesh.backend}, f)
    finally:
        distributed.shutdown()


# ---------------------------------------------------------------------------
# The parent's side
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Ctx:
    """What every phase shares: a scratch ``root``, the options added to
    every command (``("--device", "cpu")`` in a rehearsal), the backend a
    mesh must report, whether ranks sit on cards, and whether runs that
    do not depend on each other start together (a rehearsal's saving; on
    the cards they run one after another)."""

    root: str
    extra: tuple = ()
    backend: str = "nccl"
    cuda: bool = True
    timeout: float = PHASE_TIMEOUT_S
    env: dict = dataclasses.field(default_factory=dict)
    concurrent: bool = False
    hung: bool = False      # a run was killed at its time limit: stop


    @property
    def device(self) -> list:
        """``["--device", D]`` when the options name a device, else []."""
        e = list(self.extra)
        return e[e.index("--device"):e.index("--device") + 2] \
            if "--device" in e else []


def same(a, b) -> bool:
    import torch

    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same(a[k], b[k]) for k in a))
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(map(same, a, b))
    if isinstance(a, torch.Tensor):
        # torch.equal: an all-reduce may turn a -0.0 into +0.0
        return (isinstance(b, torch.Tensor) and a.dtype == b.dtype
                and a.shape == b.shape and torch.equal(a, b))
    return a == b


def start_ranks(ctx: Ctx, label: str, argv_of_rank, n: int,
                env: dict | None = None, share: int | None = None,
                timeout: float | None = None) -> dict:
    """Start ``argv_of_rank(r)`` for r < n, each under this interpreter
    from the checkout, its output to a file.  On the cards each process
    gets ``nproc / share`` intra-op threads (``share``: the processes
    that share the host at once, n by default), so that the ranks do not
    oversubscribe its cores.  ``timeout``: the run's limit
    (``ctx.timeout`` by default).  Refuses once a run has hung (a
    collective that never completes would hang the next run too)."""
    if ctx.hung:
        raise RuntimeError("an earlier run hung; no further run starts")
    tag = re.sub(r"\W+", "_", label)
    threads = ({"OMP_NUM_THREADS": str(max(1, (os.cpu_count() or 1)
                                           // (share or n)))}
               if ctx.cuda else {})
    procs = []
    for r in range(n):
        path = os.path.join(ctx.root, f"{tag}.rank{r}.log")
        f = open(path, "w")
        procs.append((subprocess.Popen(
            [sys.executable, *argv_of_rank(r)], cwd=HERE, stdout=f,
            stderr=subprocess.STDOUT,
            env={**os.environ, "PYTHONPATH": HERE, **threads, **ctx.env,
                 **(env or {})}), f, path))
    return {"label": label, "procs": procs, "t0": time.perf_counter(),
            "timeout": timeout or ctx.timeout}


def wait_ranks(ctx: Ctx, job: dict) -> tuple[bool, list, float]:
    """Wait at most the job's time limit from its start for every rank of
    ``job``, killing them all past it.  Returns (all exited 0, [output
    text], wall seconds)."""
    label, procs = job["label"], job["procs"]
    deadline = job["t0"] + job["timeout"]
    ok = True
    for p, _, _ in procs:
        try:
            p.wait(timeout=max(1.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            ok, ctx.hung = False, True
            log(f"{label}: past {job['timeout']:.0f} s; killing every rank")
            for q, _, _ in procs:
                q.kill()
            for q, _, _ in procs:
                q.wait()
            break
    wall = time.perf_counter() - job["t0"]
    texts = []
    for r, (p, f, path) in enumerate(procs):
        f.close()
        with open(path) as fh:
            texts.append(fh.read())
        if p.returncode != 0:
            ok = False
            log(f"{label}: rank {r} exit {p.returncode}:\n"
                f"{texts[-1][-3000:]}")
    return ok, texts, wall


def start_train(ctx: Ctx, label: str, train_argv: list, mesh=None, n=1,
                window=None, profile=None, env=None, workdir=None,
                timeout=None) -> dict:
    """Start the ``train`` verb on ``train_argv`` with ``--workdir`` (a
    new directory under ``ctx.root`` unless given), as one process or as
    ``n`` ranks of ``--mesh mesh``, each rank through ``rank`` mode."""
    from diral_tpu_torch.bench import _free_port

    tag = re.sub(r"\W+", "_", label)
    wd = workdir or os.path.join(ctx.root, tag)
    argv = ["train", *train_argv, *ctx.extra, "--workdir", wd]
    port = _free_port()
    outs = [os.path.join(ctx.root, f"{tag}.rank{r}.json") for r in range(n)]
    opts = []
    if window:
        opts += ["--window", ":".join(map(str, window))]
    if profile:
        opts += ["--profile", f"{profile[0]}:{profile[1]}"]

    def argv_of_rank(r):
        mesh_opts = [] if mesh is None else [
            "--mesh", mesh, "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", str(n), "--process-id", str(r)]
        return [__file__, "rank", outs[r], *opts, "--", *argv, *mesh_opts]

    return {"job": start_ranks(ctx, label, argv_of_rank, n, env,
                               timeout=timeout),
            "outs": outs, "wd": wd, "mesh": mesh, "n": n,
            "slots": int(train_argv[train_argv.index("--slots") + 1])}


def finish_train(ctx: Ctx, started: dict) -> dict:
    """A started train run, finished: ok, wall, per-rank records, output
    and backend lines, the workdir and its newest checkpoint slot."""
    from diral_tpu_torch.train import checkpoint as ckpt

    ok, texts, wall = wait_ranks(ctx, started["job"])
    recs = []
    for path in started["outs"]:
        if os.path.exists(path):
            with open(path) as f:
                recs.append(json.load(f))
        else:
            ok = False
            recs.append(None)
    name = None
    for line in texts[0].splitlines():
        m = re.search(r"-=-= experiment: (\S+) SIMULATION", line)
        if m:
            name = m.group(1)
    step = (ckpt.latest_step(os.path.join(started["wd"], "save_model",
                                          "test", name))
            if name else None)
    backends = [next((ln for ln in t.splitlines()
                      if ln.startswith("backend:")), None) for t in texts]
    return {"label": started["job"]["label"], "ok": ok, "wall": wall,
            "recs": recs, "texts": texts, "wd": started["wd"], "name": name,
            "step": step, "mesh": started["mesh"], "n": started["n"],
            "backends": backends, "slots": started["slots"],
            "loss": started["outs"][0] + ".loss.npy"}


def run_trains(ctx: Ctx, specs: list) -> list:
    """``start_train(ctx, *args, **kw)`` for each (args, kw) of ``specs``,
    finished; all started at once when ``ctx.concurrent``."""
    if ctx.concurrent:
        started = [start_train(ctx, *a, **kw) for a, kw in specs]
        return [finish_train(ctx, s) for s in started]
    return [finish_train(ctx, start_train(ctx, *a, **kw)) for a, kw in specs]


def results(run: dict, step: int | None = None):
    """(rewards, actions, losses, checkpoint at ``step`` or the newest)
    of a finished train run; the checkpoint is None without one."""
    import numpy as np
    import torch

    res = os.path.join(run["wd"], "save_results", "test", run["name"])
    step = run["step"] if step is None else step
    blob = None
    if step is not None:
        blob = torch.load(os.path.join(
            run["wd"], "save_model", "test", run["name"],
            f"ckpt_{step}.pt"), map_location="cpu", weights_only=True,
            mmap=True)
    return (np.load(os.path.join(res, "rewards_sim0.npy")),
            np.load(os.path.join(res, "actions_sim0.npy")),
            np.load(run["loss"]), blob)


def equal_runs(got: dict, want: dict) -> dict:
    """Which of rewards, actions, losses and the final checkpoint of
    ``got`` equal ``want``'s bit for bit."""
    import numpy as np

    a, b = results(got), results(want)
    return {"rewards": np.array_equal(a[0], b[0]),
            "actions": np.array_equal(a[1], b[1]),
            # NaN marks the slots a resumed run did not train here
            "losses": np.array_equal(a[2], b[2], equal_nan=True),
            "checkpoint": got["step"] == want["step"] and same(a[3], b[3])}


def backend_ok(ctx: Ctx, run: dict) -> bool:
    """Every rank reported ``ctx.backend``; on cards, each its own."""
    lines = run["backends"]
    if any(ln is None or not ln.startswith(f"backend: {ctx.backend} ")
           for ln in lines):
        return False
    if not ctx.cuda:
        return True
    cards = [re.search(r"on (cuda:\d+)", ln).group(1) for ln in lines]
    return len(set(cards)) == len(cards)


def nccl_transport(text: str) -> str | None:
    """The first line of rank 0's ``NCCL_DEBUG=INFO`` output that names a
    channel's transport (``Channel 00/0 : 0[0] -> 1[1] via P2P/CUMEM``),
    with whether NVLink SHARP (NVLS) was offered beside it."""
    info = [ln.split("NCCL INFO", 1)[1].strip() for ln in text.splitlines()
            if "NCCL INFO" in ln]
    via = next((ln for ln in info if " via " in ln), None)
    if via is None:
        return None
    nvls = any(ln.startswith("NVLS multicast support is available")
               for ln in info)
    return via + ("; NVLS offered" if nvls else "")


def phase_train(ctx: Ctx, yaml_path: str, envs: int, slots: int,
                meshes) -> tuple[bool, dict, dict]:
    """(a): one process without a mesh, then each (mesh, ranks) of
    ``meshes``; returns (ok, headline, the runs by label)."""
    base = [yaml_path, "--num-envs", str(envs), "--slots", str(slots),
            "--resume"]
    specs = [(("one card", base), {})] + [
        ((mesh, base, mesh, n),
         {"env": {"NCCL_DEBUG": "INFO"} if i == 0 and ctx.cuda else None})
        for i, (mesh, n) in enumerate(meshes)]
    ref, *rest = run_trains(ctx, specs)
    runs = {"one card": ref}
    head = {"one card": {"ok": ref["ok"], "wall_s": round(ref["wall"], 2)}}
    ok = ref["ok"]
    if not ok:
        return False, head, runs
    for i, ((mesh, n), r) in enumerate(zip(meshes, rest)):
        env = specs[i + 1][1]["env"]
        runs[mesh] = r
        eq = equal_runs(r, ref) if r["ok"] else {}
        good = r["ok"] and backend_ok(ctx, r) and eq and all(eq.values())
        head[mesh] = {"ok": bool(good), "ranks": n,
                      "wall_s": round(r["wall"], 2), "equal": eq}
        for ln in r["backends"]:
            log(f"(a) {mesh}: {ln}")
        if env:
            head["nccl_transport"] = nccl_transport(r["texts"][0])
            log(f"(a) NCCL transport on rank 0: {head['nccl_transport']}")
        log(f"(a) {mesh} ({n} ranks): {slots} slots in {r['wall']:.2f} s "
            f"(one card {ref['wall']:.2f} s); bit-equal to one card: {eq}")
        ok = ok and bool(good)
    return ok, head, runs


def phase_collectives(ctx: Ctx, cfg, runs: dict) -> tuple[bool, dict]:
    """(b) over every mesh run in ``runs`` with a data axis > 1."""
    from diral_tpu_torch.train.loop import sampler_collective_bytes, \
        train_events

    coll = sampler_collective_bytes(cfg)
    ok, head = True, {"bytes_per_event": coll["bytes_per_event"]}
    checked = 0
    for label, r in runs.items():
        if r["mesh"] is None or not r["ok"]:
            continue
        data = int(re.search(r"data=(\d+)", r["mesh"]).group(1))
        if data == 1:
            continue
        start = min(rec["timing"].get("start_slot", 0) for rec in r["recs"])
        events = train_events(cfg, start, r["slots"])
        counts = []
        for rank, rec in enumerate(r["recs"]):
            slot = [c for c in rec["collectives"] if c["in"] == "slot"]
            good = (len(slot) == events and all(
                c["op"] == "all_reduce" and c["axis"] == "data"
                and c["numel"] == coll["gathered_elems"]
                and c["bytes"] == coll["bytes_per_event"] for c in slot))
            other = {}
            for c in rec["collectives"]:
                if c["in"] != "slot":
                    key = f"{c['in']}:{c['op']}"
                    other[key] = other.get(key, 0) + 1
            counts.append({"slot_all_reduces": len(slot), "other": other,
                           "ok": good})
            ok = ok and good
        head[label] = {"train_events": events, "ranks": counts}
        checked += 1
        log(f"(b) {label}: {events} train events; per rank "
            + "; ".join(f"{c['slot_all_reduces']} all_reduce(s) of "
                        f"{coll['bytes_per_event']} B in the slot loop, "
                        f"outside it {c['other']}" for c in counts))
    return ok and checked > 0, head


def phase_checkpoint(ctx: Ctx, yaml_path: str, envs: int, slots: int,
                     cut: int, cut_mesh, resumes,
                     ref: dict) -> tuple[bool, dict, dict]:
    """(c): ``cut_mesh`` = (mesh, ranks) cut at ``cut`` and resumed to
    ``slots`` under each (mesh or None, ranks) of ``resumes``; each equal
    to ``ref`` (the uncut one-card run), the cut file equal to a one-card
    file of slot ``cut``."""
    import numpy as np

    from diral_tpu_torch.parallel import mesh as pmesh

    base = [yaml_path, "--num-envs", str(envs), "--resume"]
    mesh, n = cut_mesh
    one, first = run_trains(ctx, [
        (("one card cut", base + ["--slots", str(cut)]), {}),
        ((f"{mesh} cut", base + ["--slots", str(cut)], mesh, n), {})])
    runs = {"one card cut": one, f"{mesh} cut": first}
    head = {}
    if not (one["ok"] and first["ok"]):
        return False, {"cut runs ok": False}, runs
    file_eq = (first["step"] == cut == one["step"]
               and same(results(first)[3], results(one)[3]))
    save_bytes = first["recs"][0]["save_bytes"]
    save_ok = (bool(save_bytes) and max(save_bytes) <= pmesh.SAVE_CHUNK_BYTES
               and backend_ok(ctx, first))
    head["cut"] = {"slot": cut, "file_equal_one_card": file_eq,
                   "rank0_save_device_bytes": save_bytes,
                   "limit": pmesh.SAVE_CHUNK_BYTES}
    log(f"(c) {mesh} cut at {cut}: file equal to the one-card file: "
        f"{file_eq}; device bytes each save added on rank 0 {save_bytes} "
        f"(limit {pmesh.SAVE_CHUNK_BYTES})")
    ok = file_eq and save_ok
    specs = []
    for rmesh, rn in resumes:
        label = f"{rmesh or 'one card'} resumes {mesh}"
        wd = os.path.join(ctx.root, re.sub(r"\W+", "_", label))
        shutil.copytree(first["wd"], wd)
        specs.append(((label, base + ["--slots", str(slots)], rmesh, rn),
                      {"workdir": wd}))
    for ((label, _, rmesh, _), _), r in zip(specs, run_trains(ctx, specs)):
        runs[label] = r
        resumed = r["ok"] and f"resumed from slot {cut}" in r["texts"][0]
        eq = equal_runs(r, ref) if r["ok"] else {}
        # the slots before the cut were trained in the cut run
        if eq:
            eq["losses"] = bool(np.array_equal(results(r)[2][cut:],
                                               results(ref)[2][cut:]))
        good = (resumed and eq and all(eq.values())
                and (rmesh is None or backend_ok(ctx, r)))
        head[label] = {"ok": bool(good), "equal": eq,
                       "wall_s": round(r["wall"], 2)}
        log(f"(c) {label}: resumed at {cut}: {resumed}; bit-equal to the "
            f"uncut one-card run: {eq}")
        ok = ok and bool(good)
    return bool(ok), head, runs


def phase_dry(ctx: Ctx, data: int, model: int) -> tuple[bool, dict]:
    """(d): slots 49 and 50 over data x model ranks against one card."""
    import torch

    from diral_tpu_torch.bench import _free_port

    jobs = []
    for label, n in (("dry one card", 1),
                     (f"dry data={data},model={model}", data * model)):
        port = _free_port() if n > 1 else None
        tag = re.sub(r"\W+", "_", label)
        paths = [os.path.join(ctx.root, f"{tag}.{r}.pt") for r in range(n)]

        def argv_of_rank(r, port=port, paths=paths, n=n):
            return [__file__, "dry", paths[r], "--data", str(data),
                    "--model", str(model if n > 1 else 1), "--rank", str(r),
                    *(["--port", str(port)] if port else []), *ctx.device]

        jobs.append((start_ranks(ctx, label, argv_of_rank, n), paths))
        if not ctx.concurrent:
            jobs[-1] = (wait_ranks(ctx, jobs[-1][0]), paths)
    outs = []
    for job, paths in jobs:
        ok = (wait_ranks(ctx, job) if ctx.concurrent else job)[0]
        outs.append([torch.load(p, weights_only=True) for p in paths]
                    if ok else None)
    ref, got = outs
    if ref is None or got is None:
        return False, {"ran": False}
    ref = ref[0]
    logs_eq = {t: same(got[0]["logs"][t], ref["logs"][t]) for t in (49, 50)}
    keys = ("params", "target_params", "opt")
    learner_eq = [same({k: g[k] for k in keys}, {k: ref[k] for k in keys})
                  for g in got]
    trained = ref["logs"][49]["loss"] is not None
    backend = got[0]["backend"]
    ok = (all(logs_eq.values()) and all(learner_eq) and trained
          and backend == ctx.backend)
    head = {"ok": bool(ok), "logs_equal": logs_eq,
            "learner_equal_per_rank": learner_eq, "backend": backend,
            "t49_trained": trained}
    log(f"(d) dry run data={data},model={model} ({backend}): slot 49 / 50 "
        f"logs bit-equal to one card {logs_eq}; every rank's learner, "
        f"target and Adam bit-equal: {learner_eq}")
    return bool(ok), head


def phase_scaling(ctx: Ctx, devices: int, per_device_envs: int = 1024,
                  chunk: int = 64, repeats: int = 3) -> tuple[bool, dict]:
    """(e): ``bench.bench_scaling`` in a process of its own, ``repeats``
    timed chunks a device count (their median, each chunk's rate and
    each chunk's efficiency), every rank with ``nproc / devices`` threads
    at every count."""
    out = os.path.join(ctx.root, "scaling.json")
    ok, texts, wall = wait_ranks(ctx, start_ranks(
        ctx, "bench_scaling", lambda r: [
            __file__, "scaling", out, "--devices", str(devices),
            "--per-device-envs", str(per_device_envs), "--chunk",
            str(chunk), "--repeats", str(repeats), *ctx.device], 1,
        share=devices))
    for line in texts[0].splitlines():
        if line.startswith("scaling n="):
            log(f"(e) {line}")
    if not ok or not os.path.exists(out):
        return False, {"ran": False}
    with open(out) as f:
        got = json.load(f)
    rates = {int(k): v for k, v in got["rates"].items()}
    samples = {int(k): v for k, v in got["samples"].items()}
    eff = {n: rates[n] / (n * rates[1]) for n in rates}
    want = [1 << i for i in range(devices.bit_length())]
    good = (sorted(rates) == want and all(v > 0 for v in rates.values())
            and all(len(v) == repeats for v in samples.values()))
    head = {"ok": bool(good), "env_slots_per_s": rates,
            "samples": samples, "efficiency": eff,
            # chunk by chunk: the same slots, so the same train events
            "efficiency_chunks": {n: [a / (n * b) for a, b in
                                      zip(samples[n], samples[1])]
                                  for n in samples},
            "per_device_envs": per_device_envs, "chunk": chunk,
            "repeats": repeats, "nproc": os.cpu_count(),
            "threads_a_rank": max(1, (os.cpu_count() or 1) // devices)
            if ctx.cuda else None, "wall_s": round(wall, 2)}
    log(f"(e) bench_scaling: {json.dumps(head)}")
    return bool(good), head


def phase_width(ctx: Ctx, yaml_path: str, envs_per_card: int, cards: int,
                slots: int, window, profile) -> tuple[bool, dict]:
    """(f): ``envs_per_card * cards`` envs over ``--mesh data=cards``
    against ``envs_per_card`` at ``data=1``, both one NCCL rank a card;
    a rate over each span between consecutive slots of ``window``, the
    median and the efficiency of each span (the same slots, so the same
    train events, in both runs)."""
    from diral_tpu_torch.bench import _free_port
    from diral_tpu_torch.config import load_config
    from diral_tpu_torch.scripts import width_report
    from diral_tpu_torch.train.loop import sampler_collective_bytes, \
        train_events

    cfg = load_config(yaml_path)
    coll = sampler_collective_bytes(cfg)
    projected = (coll["ring_bytes_per_device_per_event"]
                 / width_report.NVLINK_SPEC_BYTES_PER_S * 1e3)
    spans = list(zip(window, window[1:]))
    events_window = [train_events(cfg, a, b) for a, b in spans]
    events_prof = train_events(cfg, *profile)
    head = {"projected_all_reduce_ms_at_nvlink_spec": projected,
            "bytes_per_event": coll["bytes_per_event"]}
    ok = True
    rates = {}
    specs = [((f"width data={n}", [yaml_path, "--num-envs",
                                   str(envs_per_card * n), "--slots",
                                   str(slots)], f"data={n}", n),
              {"window": window, "profile": profile,
               "timeout": max(ctx.timeout, WIDTH_TIMEOUT_S)})
             for n in (1, cards)]
    # the all-reduce alone: no rank waits for another's slot work (on
    # the cards after the runs; beside them in a rehearsal)
    port = _free_port()
    paths = [os.path.join(ctx.root, f"allreduce.{r}.json")
             for r in range(cards)]

    def allreduce_alone():
        return start_ranks(ctx, "all-reduce alone", lambda r: [
            __file__, "allreduce", paths[r], "--world", str(cards), "--rank",
            str(r), "--port", str(port), "--yaml", yaml_path, *ctx.device],
            cards)

    alone_job = allreduce_alone() if ctx.concurrent else None
    done = run_trains(ctx, specs)
    for n, r in zip((1, cards), done):
        envs, label = envs_per_card * n, r["label"]
        recs = [x for x in r["recs"] if x]
        good = r["ok"] and backend_ok(ctx, r) and len(recs) == n and all(
            x["window_s"] for x in recs) and r["step"] is None
        if not good:
            ok = False
            head[label] = {"ok": False}
            continue
        span_rates = [(b - a) / s for (a, b), s in zip(spans,
                                                        recs[0]["window_s"])]
        rates[n] = span_rates
        rate = statistics.median(span_rates)
        nccl = []
        for x in recs:
            p = x["profile"] or {}
            ms = sum(v["ms"] for v in p.get("nccl_kernels", {}).values())
            nccl.append(ms / events_prof if events_prof else None)
        prof0 = recs[0]["profile"]
        row = {"ok": True, "envs": envs, "ranks": n,
               "slots_per_s": rate, "env_slots_per_s": rate * envs,
               "slots_per_s_spans": span_rates,
               # each rank's profiled device ms a slot: the one that
               # lags shows here and waits least in NCCL
               "busy_ms": [(x["profile"] or {}).get("busy_ms")
                           for x in recs],
               "train_events_in_window": events_window,
               "peak_bytes": [x["peak_bytes"] for x in recs],
               "nccl_ms_per_event": nccl,
               "launches_rank0": recs[0]["launches"],
               "rank0_slot": prof0, "wall_s": round(r["wall"], 2)}
        head[label] = row
        log(f"(f) {label}: {envs} envs ({envs_per_card} a card), "
            f"{rate:.2f} slots/s = {rate * envs:,.0f} env-slots/s over "
            f"slots {window[0]}..{window[-1]} (median of {span_rates}; "
            f"{events_window} train events);"
            f" profiled busy ms a slot per rank {row['busy_ms']}; peak "
            f"device bytes per rank {row['peak_bytes']}; NCCL ms per "
            f"event per rank {nccl} (projected {projected:.3f} at the NVLink "
            f"spec); rank 0 launches {row['launches_rank0']}")
        if prof0:
            log(f"(f) {label} rank 0 slot over slots {profile[0]}.."
                f"{profile[1]} ({events_prof} train events): wall "
                f"{prof0['wall_ms']:.3f} ms, busy {prof0['busy_ms']:.3f} ms, "
                f"idle {prof0['idle_ms']:.3f} ms; " + ", ".join(
                    f"{k} {v['ms']:.4f} ms x{v['kernels']:.1f}"
                    for k, v in sorted(prof0["rows"].items(),
                                       key=lambda kv: -kv[1]["ms"])))
        if ctx.cuda and not (all(x["peak_bytes"] for x in recs) and prof0
                             and prof0["busy_ms"] > 0):
            ok = False
    ran, _, _ = wait_ranks(ctx, alone_job or allreduce_alone())
    alone = []
    for p in paths:
        if ran and os.path.exists(p):
            with open(p) as f:
                alone.append(json.load(f))
    good = ran and len(alone) == cards and all(
        a["sum_ok"] and a["backend"] == ctx.backend for a in alone)
    head["all_reduce_alone"] = {
        "ms": [a["ms"] for a in alone], "min_ms": [a["min_ms"] for a in alone],
        "bus_gb_per_s": [2 * (cards - 1) / cards * a["bytes"] / a["ms"] / 1e6
                         for a in alone], "ok": bool(good)}
    log(f"(f) the {coll['bytes_per_event']} B all-reduce alone over "
        f"{cards} ranks: {json.dumps(head['all_reduce_alone'])} "
        f"(projected {projected:.3f} ms at the NVLink spec)")
    ok = ok and good
    if len(rates) == 2:
        per_span = [b / a for a, b in zip(rates[1], rates[cards])]
        head["weak_scaling_efficiency"] = statistics.median(per_span)
        head["efficiency_spans"] = per_span
        log(f"(f) weak-scaling efficiency rate({cards}) / ({cards} rate(1))"
            f" = {head['weak_scaling_efficiency']:.4f} (median of the "
            f"spans {per_span})")
    return ok and len(rates) == 2, head


def row_invariance(device, rows: int = 1600, parts=(4, 2),
                   large: int | None = None) -> dict:
    """Whether the acting forward of 100v/50r gives each row the same
    bits whatever the row count: a seeded learner on ``rows`` window rows
    (16 envs x 100 users, the one-card run of (a)) and on its ``rows /
    p`` row shards (a data=p rank's).  ``plain``: stage by stage with one
    product a dense layer (K1's h, each dense layer, each layer norm, the
    Q head), {p: {stage: max |difference|}}; ``smallest``: for each dense
    layer that differs, how many of the leading-row counts m < ``rows`` give a
    product of m rows that differs from the same rows of the whole
    product, and the fewest and most such m; ``blocked``: the Q
    values of ``drqn_apply`` with products of min(``qnets.ACT_ROWS``, the
    whole's rows) rows (the training loop's acting forward: a shard is
    padded to the products one card makes), {p: max |difference|},
    also at ``large`` rows when given.  A ``blocked`` entry above 0
    breaks the mesh's bit-equality."""
    import torch

    from diral_tpu_torch.config import load_config
    from diral_tpu_torch.models import qnets
    from diral_tpu_torch.ops.lstm_window import padded_dim

    cfg = load_config(SCALE_YAML)
    acfg = cfg.agent
    gen = torch.Generator(device=device).manual_seed(0)
    D, T = cfg.env.state_space, acfg.step_size
    params = qnets.drqn_init(gen, D, cfg.env.num_channels, acfg,
                             torch.float32, device).tree()
    Dp = padded_dim(D)

    def windows(n):
        x = torch.rand(n, T, Dp, generator=gen, device=device)
        x[..., D:] = 0
        return x.reshape(n, T * Dp)

    def stages(x):
        out = {"K1 h": qnets._lstm_last(params["lstm"], x,
                                        acfg.network.lstm_impl, T)}
        h = out["K1 h"]
        for i in (2, 3):
            if f"fc{i}" not in params:
                continue
            out[f"fc{i} matmul"] = z = qnets.dense(params[f"fc{i}"], h)
            out[f"ln{i}"] = h = qnets.layer_norm(params[f"ln{i}"],
                                                 torch.relu(z))
        out["head matmul"] = qnets.dense(params["head"], h)
        return out

    def shard_diff(fn, x, p):
        n = x.shape[0] // p
        whole = fn(x)
        return {k: float((torch.cat([fn(x[i * n:(i + 1) * n])[k]
                                     for i in range(p)]) - v).abs().max())
                for k, v in whole.items()}

    x = windows(rows)
    report = {"rows": rows, "act_rows": qnets.ACT_ROWS, "plain": {},
              "smallest": {}, "blocked": {}}
    with torch.no_grad():
        whole = stages(x)
        for p in parts:
            report["plain"][p] = shard_diff(stages, x, p)
        # the layer's own input, so that each product is shown alone
        inputs = {"fc2 matmul": whole["K1 h"], "fc3 matmul": whole.get(
            "ln2"), "head matmul": whole.get("ln3", whole.get("ln2"))}
        for k, h in inputs.items():
            layer = {"fc2 matmul": "fc2", "fc3 matmul": "fc3",
                     "head matmul": "head"}[k]
            if layer not in params or h is None:
                continue
            full = h @ params[layer]["w"]
            bad = [m for m in range(1, rows) if not torch.equal(
                h[:m] @ params[layer]["w"], full[:m])]
            report["smallest"][k] = {
                "of": rows, "weight": list(params[layer]["w"].shape),
                "rows_that_differ": len(bad),
                "fewest": bad[0] if bad else None,
                "most": bad[-1] if bad else None}

        def blocked(total):
            rows = min(qnets.ACT_ROWS, total)
            return lambda x: {"q": qnets.drqn_apply(params, x, acfg, rows)}

        for p in parts:
            report["blocked"][p] = shard_diff(blocked(x.shape[0]), x, p)["q"]
        if large:
            xl = windows(large)
            report["blocked"][f"{large} rows / 4"] = shard_diff(
                blocked(large), xl, 4)["q"]
            report["plain"][f"{large} rows / 4"] = shard_diff(
                stages, xl, 4)
    return report


def act_forward_ms(device, rows: int, reps: int = 7,
                   total: int | None = None) -> dict:
    """Device ms of the acting forward at 100v/50r on ``rows`` window
    rows, with one product a dense layer and as the training loop makes
    it in a run of ``total`` rows (``rows`` by default): products of
    min(``qnets.ACT_ROWS``, total) rows.  CUDA events, the median of
    ``reps`` after a warm call."""
    import statistics

    import torch

    from diral_tpu_torch.config import load_config
    from diral_tpu_torch.models import qnets
    from diral_tpu_torch.ops.lstm_window import padded_dim

    cfg = load_config(SCALE_YAML)
    acfg = cfg.agent
    gen = torch.Generator(device=device).manual_seed(1)
    D, T = cfg.env.state_space, acfg.step_size
    params = qnets.drqn_init(gen, D, cfg.env.num_channels, acfg,
                             torch.float32, device).tree()
    x = torch.rand(rows, T * padded_dim(D), generator=gen, device=device)
    out = {}
    with torch.no_grad():
        for name, r in (("plain_ms", None),
                        ("blocked_ms", min(qnets.ACT_ROWS,
                                           total or rows))):
            times = []
            for i in range(reps + 1):
                a, b = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                a.record()
                qnets.drqn_apply(params, x, acfg, r)
                b.record()
                torch.cuda.synchronize(device)
                if i:
                    times.append(a.elapsed_time(b))
            out[name] = statistics.median(times)
    return out


def card_report() -> dict:
    """Every card's name and power limit, the topology and the cores."""
    def run(cmd):
        p = subprocess.run(cmd, capture_output=True, text=True)
        return (p.stdout + p.stderr).strip(), p.returncode

    smi, rc = run(["nvidia-smi", "--query-gpu=name,power.limit",
                   "--format=csv,noheader"])
    if rc:
        raise RuntimeError(f"nvidia-smi failed: {smi}")
    topo, topo_rc = run(["nvidia-smi", "topo", "-m"])
    nproc, _ = run(["nproc"])
    for line in smi.splitlines():
        log(line)
    log(f"nvidia-smi topo -m (exit {topo_rc}):\n{topo}")
    log(f"nproc: {nproc}")
    return {"cards": smi.splitlines(), "topo_exit": topo_rc,
            "nproc": nproc}


# the acting forward timed beside (a), (rows, the run's rows): one card
# at (a)'s width, a data=4 rank of it, a data=4 rank of (f), one card of (f)
ACT_CASES = ((1600, 1600), (400, 1600), (25600, 409600), (102400, 102400))

# the widths of the phases on the cards (a rehearsal passes its own)
WIDTHS = {
    "yaml": SCALE_YAML,     # (a)-(c) and (f)
    "envs": 16, "slots": 400, "cut": 300,             # (a)-(c)
    "invariance_rows": 1600,                          # 16 envs x 100 users
    "invariance_large": 102400,                       # 1024 envs x 100
    "scaling_envs": 1024, "scaling_chunk": 64,        # (e): its defaults
    "scaling_cards": None,                            # (e): None = all
    # (c)'s cut mesh and resumes, (mesh, ranks) each: None = by card count
    "cut_mesh": None, "resumes": None,
    "width_envs": 1024, "width_slots": 1000,          # (f), a card
    "window": (300, 500, 700, 900), "profile": (900, 950),
}


def run_phases(ctx: Ctx, cards: int, widths: dict,
               only: str = "abcdef") -> dict:
    """Phases (a)-(f) over ``cards`` ranks (2 or 4), or those named in
    ``only`` ((b) and (c) need (a)); {phase: headline}.  When
    ``ctx.concurrent`` (a rehearsal) (d)-(f) run beside (a)-(c)."""
    w = widths
    phases = {}

    def record(key, fn, *a):
        t = time.perf_counter()
        try:
            ok, head, *rest = fn(*a)
        except Exception as e:   # recorded as the phase's failure
            log(f"phase ({key}) raised {e!r}")
            ok, head, rest = False, {"raised": repr(e)}, [None]
        head = dict(head, ok=bool(ok), seconds=round(time.perf_counter()
                                                     - t, 1))
        phases[key] = head
        log(f"[phase ({key}): {'pass' if ok else 'FAIL'}, "
            f"{head['seconds']} s]")
        return rest[0] if rest else None

    def rest():
        for key, fn, *a in (
                ("d", phase_dry, ctx, 2 if cards >= 4 else 1, 2),
                ("e", phase_scaling, ctx, w["scaling_cards"] or cards,
                 w["scaling_envs"], w["scaling_chunk"]),
                ("f", phase_width, ctx, w["yaml"], w["width_envs"], cards,
                 w["width_slots"], w["window"], w["profile"])):
            if key in only:
                record(key, fn, *a)

    beside = threading.Thread(target=rest) if ctx.concurrent else None
    if beside:
        beside.start()
    if "a" in only:
        phase_train_checkpoint(ctx, cards, w, record, phases, "c" in only)
    if beside:
        beside.join()
    else:
        rest()
    return phases


def phase_train_checkpoint(ctx: Ctx, cards: int, w: dict, record,
                           phases: dict, cut: bool = True) -> None:
    """(a), (c) when ``cut`` and (b), in that order ((b) reads the others'
    runs), with the acting forward's ``row_invariance`` beside (a) and,
    on a card, its cost (``act_forward_ms``)."""
    import torch

    from diral_tpu_torch.config import load_config

    try:
        inv = row_invariance(torch.device("cuda", 0) if ctx.cuda
                             else torch.device("cpu"), w["invariance_rows"],
                             large=w["invariance_large"])
        if ctx.cuda:
            inv["act_forward"] = {f"{n} of {total}": act_forward_ms(
                torch.device("cuda", 0), n, total=total)
                for n, total in ACT_CASES}
    except Exception as e:   # a diagnosis: reported, not a phase
        inv = {"raised": repr(e)}
    if ctx.cuda:
        torch.cuda.empty_cache()
    log(f"the acting forward's rows against the row count (max |diff| of "
        f"{w['invariance_rows']} rows vs their shards): {json.dumps(inv)}")
    invariant = all(v == 0.0 for v in inv.get("blocked", {None: 1}).values())
    meshes = ([("data=4", 4), ("data=2,model=2", 4), ("data=2", 2)]
              if cards >= 4 else [("data=2", 2), ("data=1,model=2", 2)])
    resumes = w["resumes"] or ([("data=4", 4), ("data=2,model=2", 4),
                                ("data=2", 2), (None, 1)]
                               if cards >= 4 else [("data=2", 2), (None, 1)])
    runs = record("a", phase_train, ctx, w["yaml"], w["envs"], w["slots"],
                  meshes) or {}
    phases["a"]["row_invariance"] = inv
    if not invariant:
        log("(a) the acting forward's rows depend on the row count")
        phases["a"]["ok"] = False
    ref = runs.get("one card")
    if cut and ref is not None and ref["ok"]:
        runs.update(record("c", phase_checkpoint, ctx, w["yaml"], w["envs"],
                           w["slots"], w["cut"], w["cut_mesh"] or meshes[0],
                           resumes, ref)
                    or {})
    elif cut:
        phases["c"] = {"ok": False, "skipped": "no one-card run"}
    record("b", phase_collectives, ctx, load_config(w["yaml"]), runs)
    # the runs' checkpoints are done with: keep the disk light
    for r in runs.values():
        shutil.rmtree(r["wd"], ignore_errors=True)


def resume_meshes(names: list | None) -> list | None:
    """``--resumes`` as (c)'s (mesh or None, ranks) pairs: ``one`` is one
    card, a mesh spec takes the product of its axes' ranks."""
    if not names:
        return None
    return [(None, 1) if m == "one" else
            (m, math.prod(int(v) for v in re.findall(r"=(\d+)", m)))
            for m in names]


def main(logs: str | None = None, only: str = "abcdef",
         resumes: list | None = None) -> int:
    """The phases named in ``only`` on this machine's cards; ``logs``: a
    directory that receives every rank's output; ``resumes``: (c)'s
    resumes as mesh specs (``one`` for one card), else all of them."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        raise RuntimeError(
            f"chip_mesh.py needs at least two CUDA cards; this machine has "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    sys.path.insert(0, HERE)
    from diral_tpu_torch.ops import _build

    cards = min(torch.cuda.device_count(), 4)
    report = card_report()
    t0 = time.perf_counter()
    _build.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    started = time.perf_counter()
    root = tempfile.mkdtemp(prefix="diral_mesh_")
    try:
        widths = dict(WIDTHS, resumes=resume_meshes(resumes))
        phases = run_phases(Ctx(root), cards, widths, only)
    finally:
        if logs:
            os.makedirs(logs, exist_ok=True)
            for f in os.listdir(root):
                if f.endswith(".log"):
                    shutil.copy(os.path.join(root, f), logs)
        shutil.rmtree(root, ignore_errors=True)
    ok = all(p.get("ok") for p in phases.values())
    log(f"chip_mesh: {'every phase passed' if ok else 'FAILED'} in "
        f"{time.perf_counter() - started:.1f} s on {cards} cards "
        f"({report['cards'][0]})")
    print(json.dumps({"ok": ok, "cards": cards, "phases": phases},
                     default=str), flush=True)
    return 0 if ok else 1


def _window(text):
    return tuple(int(t) for t in text.split(":"))


def cli_main(argv) -> int:
    if not argv or argv[0].startswith("--"):
        p = argparse.ArgumentParser(prog="chip_mesh.py")
        p.add_argument("--logs", help="copy every rank's output here")
        p.add_argument("--phases", default="abcdef",
                       help="the phases to run, e.g. ef ((b), (c) need (a))")
        p.add_argument("--resumes", nargs="+", metavar="MESH",
                       help="(c)'s resumes, e.g. data=4 data=2 one "
                            "(default: every mesh of (a) and one card)")
        a = p.parse_args(argv)
        return main(a.logs, a.phases, a.resumes)
    mode, rest = argv[0], argv[1:]
    sys.path.insert(0, HERE)
    if mode == "rank":
        split = rest.index("--")
        p = argparse.ArgumentParser(prog="chip_mesh.py rank")
        p.add_argument("out")
        p.add_argument("--window", type=_window)
        p.add_argument("--profile", type=_window)
        a = p.parse_args(rest[:split])
        rank_main(a.out, rest[split + 1:], a.window, a.profile)
        return 0
    if mode == "rows":
        # the acting forward's row invariance and cost alone, on one card
        import torch

        from diral_tpu_torch.ops import _build

        _build.build_all(["lstm_window"])
        dev = torch.device("cuda", 0)
        card_report()
        log(json.dumps({"row_invariance": row_invariance(
            dev, WIDTHS["invariance_rows"],
            large=WIDTHS["invariance_large"]), "act_forward": {
                f"{n} of {total}": act_forward_ms(dev, n, total=total)
                for n, total in ACT_CASES}}))
        return 0
    if mode == "allreduce":
        p = argparse.ArgumentParser(prog="chip_mesh.py allreduce")
        p.add_argument("out")
        p.add_argument("--world", type=int, required=True)
        p.add_argument("--rank", type=int, required=True)
        p.add_argument("--port", type=int, required=True)
        p.add_argument("--yaml", default=SCALE_YAML)
        p.add_argument("--device")
        a = p.parse_args(rest)
        allreduce_main(a.out, a.world, a.rank, a.port, a.device, a.yaml)
        return 0
    if mode == "dry":
        p = argparse.ArgumentParser(prog="chip_mesh.py dry")
        p.add_argument("out")
        p.add_argument("--data", type=int, required=True)
        p.add_argument("--model", type=int, default=1)
        p.add_argument("--rank", type=int, default=0)
        p.add_argument("--port", type=int)
        p.add_argument("--device")
        a = p.parse_args(rest)
        dry_main(a.out, a.data, a.model, a.port, a.rank, a.device)
        return 0
    if mode == "scaling":
        from diral_tpu_torch import bench

        p = argparse.ArgumentParser(prog="chip_mesh.py scaling")
        p.add_argument("out")
        p.add_argument("--devices", type=int, required=True)
        p.add_argument("--per-device-envs", type=int, default=1024)
        p.add_argument("--chunk", type=int, default=64)
        p.add_argument("--repeats", type=int, default=1)
        p.add_argument("--device")
        a = p.parse_args(rest)
        samples = {}
        rates = bench.bench_scaling(a.per_device_envs, a.chunk, a.devices,
                                    a.device, a.repeats, samples)
        with open(a.out, "w") as f:
            json.dump({"rates": rates, "samples": samples}, f)
        return 0
    raise SystemExit(f"chip_mesh.py: unknown mode {mode!r}")


if __name__ == "__main__":
    sys.exit(cli_main(sys.argv[1:]))
