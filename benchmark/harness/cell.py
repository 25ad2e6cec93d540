"""One run of one training cell: set-up, the measured window, the traced
slots, the per-layer readers, and the check.

The core knows no agent: the cell's algorithm module (``spec.cell``
loads ``benchmark/algorithms/<algorithm>.py``; its docstring and
benchmark/README.md give the contract) builds the program and drives it
through the set-up, and hands this file a session whose window it runs
and a capture that it checks.

The window continues the set-up's state through the session's steps
(DRQN: ``runner.run_chunks``, the loop the ``train`` verb runs, in chunks
of the traffic's ``chunk_slots``), and ends at the first step after
``seconds`` (and after the traced slots).  Its rate counts every
env-slot over the whole wall time (each step ends on a sync).  An
episode's time runs between device events recorded after the last slot
of consecutive episodes, train event included; the events add no
synchronisation.

With ``trace`` the session wraps its calls into the layers in CUDA-event
spans over the whole window and ``record_function`` ranges, and the core
profiles the session's two ranges of slots: first with the host's ops
(for the layer attribution), then the device alone (busy and idle time,
the breakdown; see ``harness.trace``).  The steps that end after the
profiles give the traced run's rate by the host's clock
(``after_trace``: slots and seconds), which the profilers do not slow."""

from __future__ import annotations

import dataclasses
import gc
import math
import statistics
import time
from types import SimpleNamespace

import torch
import torch.distributed as dist

from benchmark.harness import peaks
from benchmark.harness import spec as spec_mod
from benchmark.harness.trace import WINDOW, Trace
from diral_tpu_torch.config import load_config
from diral_tpu_torch.parallel import distributed
from diral_tpu_torch.parallel import mesh as pmesh


class _Stamps:
    """Points on the device's timeline: CUDA events on the card, the host
    clock after a sync elsewhere (the CPU runs of the tests)."""

    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.points = []

    def mark(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.points.append(ev)
        else:
            self.points.append(time.perf_counter())

    def intervals_ms(self, pairs=None) -> list:
        p = self.points
        pairs = pairs if pairs is not None else list(zip(p[:-1], p[1:]))
        if self.cuda:
            return [a.elapsed_time(b) for a, b in pairs]
        return [(b - a) * 1e3 for a, b in pairs]


class _Spans:
    """A CUDA-event span and a ``record_function`` range per layer call."""

    def __init__(self, device, layers):
        self.stamps = _Stamps(device)
        self.pairs = {k: [] for k in layers}
        self.open = {}

    def begin(self, layer):
        self.stamps.mark()
        rf = torch.profiler.record_function(f"bench.{layer}")
        rf.__enter__()
        self.open[layer] = (self.stamps.points[-1], rf)

    def end(self, layer):
        start, rf = self.open.pop(layer)
        rf.__exit__(None, None, None)
        self.stamps.mark()
        self.pairs[layer].append((start, self.stamps.points[-1]))

    def ms(self):
        return {k: self.stamps.intervals_ms(v) for k, v in self.pairs.items()}


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def program_config(cfg_file_cfg, traffic: dict, overrides: dict | None):
    """The configuration as the cell runs it: the config file's, with the
    traffic's env count and nothing written to disk; ``overrides`` (tests
    and the readings tool) replace top-level, agent, network or engine
    fields by name."""
    cfg = dataclasses.replace(
        cfg_file_cfg, save_results=False, save_model=False,
        save_positions=False,
        engine=dataclasses.replace(cfg_file_cfg.engine,
                                   num_envs=int(traffic["num_envs"])))
    for key, value in (overrides or {}).items():
        group, _, leaf = key.rpartition(".")
        if group == "":
            cfg = dataclasses.replace(cfg, **{leaf: value})
        elif group == "agent":
            cfg = dataclasses.replace(
                cfg, agent=dataclasses.replace(cfg.agent, **{leaf: value}))
        elif group == "network":
            cfg = dataclasses.replace(cfg, agent=dataclasses.replace(
                cfg.agent, network=dataclasses.replace(
                    cfg.agent.network, **{leaf: value})))
        elif group == "engine":
            cfg = dataclasses.replace(
                cfg, engine=dataclasses.replace(cfg.engine, **{leaf: value}))
        else:
            raise KeyError(f"bad override {key!r}")
    return cfg


def verdict(numbers: dict, limits: dict, names) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}} in the order of ``names``):
    correct when every number is finite and at most its limit."""
    out = {k: {"value": numbers[k], "limit": limits[k]} for k in names}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
             for v in out.values())
    return ok, out


def _gathered(value, mesh) -> list:
    """``value`` of every rank (this rank's alone without a mesh)."""
    if mesh is None:
        return [value]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, value)
    return out


def join_mesh(spec: str, rank: int, world: int, port: int, device):
    """Join the run's process group as ``rank`` and lay out the mesh;
    returns (this rank's device, mesh)."""
    dev = distributed.initialize(f"127.0.0.1:{port}", world, rank,
                                 device=device.type)
    return dev, pmesh.mesh_from_spec(spec)


def run(cell: spec_mod.Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float, overrides=None,
        log=print, rank: int = 0, world: int = 1, port: int = 0):
    """The result line's fields for one run (``checks`` last); under a
    mesh every rank calls this, and ranks other than 0 return None."""
    tp = cell.traffic_params
    algo = cell.algorithm
    cfg = program_config(load_config(cell.config_path), tp, overrides)
    algo.supported(cfg)
    mesh = None
    if tp.get("mesh"):
        device, mesh = join_mesh(tp["mesh"], rank, world, port, device)
    session = algo.set_up(cfg, tp, seed, device, mesh)
    _sync(device)
    setup_s = time.perf_counter() - t_start - session.capture.seconds
    sh = session.shapes
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    stamps = _Stamps(device)
    spans = _Spans(device, session.layers) if trace else None
    undo = session.wrap_layers(spans) if trace else None
    # [first slot, end, activities, profile]: with the host's ops, then
    # the device alone (on the CPU, the host's ops twice)
    P = torch.profiler.ProfilerActivity
    on_card = device.type == "cuda"
    (first0, end0), (first1, end1) = session.profiles
    profiles = [[first0, end0, [P.CPU, P.CUDA] if on_card else [P.CPU],
                 None],
                [first1, end1, [P.CUDA] if on_card else [P.CPU], None]]
    traced = end1 - first1
    trace_end = end1

    def before_slot(s):
        for p in profiles:
            if trace and s == p[0]:
                _sync(device)
                p[3] = torch.profiler.profile(activities=p[2])
                p[3].start()
                if P.CPU in p[2]:
                    p.append(torch.profiler.record_function(WINDOW))
                    p[4].__enter__()

    def after_slot(s):
        if session.episode_end(s):
            stamps.mark()
        for p in profiles:
            if trace and s == p[1] - 1:
                _sync(device)
                if len(p) > 4:
                    p[4].__exit__(None, None, None)
                p[3].stop()

    start = t = session.start
    wall0 = time.perf_counter()
    stamps.mark()
    chunk_ends = []      # (slot, host clock) after each step's sync
    steps = session.steps(before_slot, after_slot)
    for t in steps:
        chunk_ends.append((t, time.perf_counter()))
        done = (time.perf_counter() - wall0 >= seconds
                and (not trace or t >= trace_end))
        if mesh is not None:
            # every rank stops after the same step: rank 0's clock decides
            flag = torch.tensor([float(done)], device=device)
            dist.broadcast(flag, 0)
            done = bool(flag.item())
        if done:
            break
    steps.close()
    _sync(device)
    wall = time.perf_counter() - wall0
    if undo is not None:
        undo()
    slots = t - start
    after = [c for c in chunk_ends if c[0] >= trace_end]
    after_trace = ((after[-1][0] - after[0][0], after[-1][1] - after[0][1])
                   if len(after) >= 2 else None)
    events = session.events(start, t)
    episodes = stamps.intervals_ms()
    memory_peak = max(_gathered(torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0, mesh))
    span_ms = spans.ms() if spans else {}
    ranges, parsed = ((Trace(profiles[0][3]), Trace(profiles[1][3]))
                      if trace else (None, None))
    traced_events = session.events(trace_end - traced, trace_end)
    # each rank's NCCL kernel ms a train event in the device-only profile
    nccl_s = parsed.nccl_s() if trace else 0.0
    nccl_ms = _gathered(1e3 * nccl_s / traced_events
                        if nccl_s > 0 and traced_events else None, mesh)
    # the device's busy seconds, averaged over the cards used
    busy = _gathered((parsed.busy_s, parsed.window_s) if trace else None,
                     mesh)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")

    metrics = {}
    # every end-to-end rate named ``*env_slots_per_s`` is the window's:
    # env-slots of all envs (of all ranks) over its whole wall time
    e2e = {m.name: slots * session.envs / wall for m in cell.end_to_end
           if m.name.endswith("env_slots_per_s")}
    e2e["setup_s"] = setup_s
    e2e["episode_ms_p90"] = (statistics.quantiles(
        episodes, n=10, method="inclusive")[8] if len(episodes) >= 2
        else None)
    if trace:
        ctx = SimpleNamespace(
            cfg=cfg, shapes=sh, slots=slots, events=events, wall_s=wall,
            after_trace=after_trace, spans=span_ms, trace=parsed,
            ranges=ranges, traced_slots=traced,
            nccl_ms_per_event=nccl_ms if mesh is not None else None,
            peaks=peaks.for_card(name))
        for m in cell.per_layer:
            value = spec_mod.reader(m.name, cell.root)(ctx)
            if value is not None:
                metrics[m.name] = {"value": value, "unit": m.unit}
    else:
        for m in cell.end_to_end:
            if e2e.get(m.name) is not None:
                metrics[m.name] = {"value": e2e[m.name], "unit": m.unit}
    log(f"window: {slots} slots, {events} train events, {len(episodes)} "
        f"episodes in {wall:.3f} s; set-up {setup_s:.3f} s; peak "
        f"{memory_peak} B")
    device_out = {"platform": "gpu" if device.type == "cuda" else "cpu",
                  "kind": name, "count": cell.chips,
                  "memory_peak_bytes": int(memory_peak)}
    if device.type == "cuda":
        device_out["power_limit_w"] = peaks.power_limit_w(device.index or 0)
    if parsed is not None:
        device_out["busy_s"] = statistics.fmean(b for b, _ in busy)
        device_out["window_s"] = statistics.fmean(w for _, w in busy)

    # the program's state goes before the reference runs
    breakdown = ({"device_ops": parsed.device_ops(),
                  "idle_gaps": parsed.idle_gaps()} if parsed else None)
    cap = session.capture
    session.close()
    del session, steps, undo, profiles, ranges, parsed
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if mesh is not None:
        distributed.shutdown()
        if rank != 0:
            return None
    checked = time.perf_counter()
    numbers = algo.check(cap, cfg, device)
    correct, checks = verdict(numbers, cell.limits, algo.LIMITS)
    log(f"check: {time.perf_counter() - checked:.3f} s")
    out = {"correct": bool(correct), "attempted": slots, "failed": 0,
           "metrics": metrics, "device": device_out}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out
