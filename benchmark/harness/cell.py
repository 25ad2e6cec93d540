"""One run of one training cell: set-up, the measured window, the traced
slots, the per-layer readers, and the check.

The window continues the set-up's carry with ``runner.run_chunks``, the
loop the ``train`` verb runs, in chunks of the traffic's ``chunk_slots``,
and ends at the first chunk boundary after ``seconds`` (and after the
traced slots).  Its rate counts
every env-slot over the whole wall time (each chunk ends on its log
read, a device sync).  An episode's time runs between device events
recorded after the last slot of consecutive episodes, train event
included; the events add no synchronisation.

With ``trace`` the harness wraps its calls into the layers (the acting
forward, the env step with the state assembly, the train event, and the
LSTM inside the acting forward) in CUDA-event spans over the whole
window and ``record_function`` ranges, and profiles two episodes' slots
from the window's second episode twice over: first with the host's ops
(for the layer attribution), then the device alone (busy and idle time,
the breakdown; see ``harness.trace``).  The chunks that end after the
profiles give the traced run's rate by the host's clock (``after_trace``:
slots and seconds), which the profilers do not slow."""

from __future__ import annotations

import gc
import statistics
import time
from types import SimpleNamespace

import torch
import torch.distributed as dist

from benchmark.harness import capture, peaks
from benchmark.harness import spec as spec_mod
from benchmark.harness.trace import WINDOW, Trace
from benchmark.reference import check
from benchmark.reference import env as ref_env
from diral_tpu_torch.config import load_config
from diral_tpu_torch.envs import v2v_env as E
from diral_tpu_torch.models import qnets
from diral_tpu_torch.parallel import distributed
from diral_tpu_torch.parallel import mesh as pmesh
from diral_tpu_torch.train import runner

FAR = 10 ** 12   # the window's nominal end: it stops on time, not on slots


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

    def __init__(self, device):
        self.stamps = _Stamps(device)
        self.pairs = {"act": [], "env": [], "train": []}
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


def _wrap_layers(fns, spans: _Spans):
    """Instance and module attributes that time the layer calls; returns
    the undo."""
    qvalues, step_env, train_call = fns.qvalues, fns.step_env, fns.train_call
    obtain_state, lstm_last = E.obtain_state, getattr(qnets, "_lstm_last",
                                                      None)

    def timed_qvalues(*a, **k):
        spans.begin("act")
        out = qvalues(*a, **k)
        spans.end("act")
        return out

    def timed_step_env(*a, **k):
        spans.begin("env")
        return step_env(*a, **k)

    def timed_obtain_state(*a, **k):
        out = obtain_state(*a, **k)
        if "env" in spans.open:
            spans.end("env")
        return out

    def timed_train_call(*a, **k):
        spans.begin("train")
        out = train_call(*a, **k)
        spans.end("train")
        return out

    def ranged_lstm(*a, **k):
        with torch.profiler.record_function("bench.lstm_fwd"):
            return lstm_last(*a, **k)

    fns.qvalues, fns.step_env = timed_qvalues, timed_step_env
    fns.train_call = timed_train_call
    E.obtain_state = timed_obtain_state
    if lstm_last is not None:
        qnets._lstm_last = ranged_lstm

    def undo():
        del fns.qvalues, fns.train_call
        fns.step_env = step_env
        E.obtain_state = obtain_state
        if lstm_last is not None:
            qnets._lstm_last = lstm_last
    return undo


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def shapes(cfg, fns) -> dict:
    acfg = cfg.agent
    return {"B": fns.B, "B_global": fns.B_global, "N": fns.N, "C": fns.C,
            "D": fns.D, "Dp": fns.Dp, "T": fns.T,
            "H1": acfg.network.layers[0], "H2": acfg.network.layers[1],
            "batch": acfg.batch_size, "n_batch": acfg.n_batch,
            "interval": cfg.episode_interval}


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
    cfg = capture.program_config(load_config(cell.config_path), tp,
                                 overrides)
    ref_env.check_supported(cfg)
    mesh = None
    if tp.get("mesh"):
        device, mesh = join_mesh(tp["mesh"], rank, world, port, device)
    fns, carry, draws, t, cap = capture.set_up(
        cfg, seed, device, int(tp["start_slot"]), mesh=mesh)
    _sync(device)
    setup_s = time.perf_counter() - t_start - cap.seconds
    sh = shapes(cfg, fns)
    I = cfg.episode_interval
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    stamps = _Stamps(device)
    spans = _Spans(device) if trace else None
    undo = _wrap_layers(fns, spans) if trace else None
    traced = 2 * I
    # [first slot, activities, profile]: with the host's ops, then the
    # device alone (on the CPU, the host's ops twice)
    P = torch.profiler.ProfilerActivity
    on_card = device.type == "cuda"
    profiles = [[t + I, [P.CPU, P.CUDA] if on_card else [P.CPU], None],
                [t + I + traced, [P.CUDA] if on_card else [P.CPU], None]]
    trace_end = t + I + 2 * traced
    slot_step = fns.slot_step

    def window_slot_step(carry_, s, draws_):
        for p in profiles:
            if trace and s == p[0]:
                _sync(device)
                p[2] = torch.profiler.profile(activities=p[1])
                p[2].start()
                if P.CPU in p[1]:
                    p.append(torch.profiler.record_function(WINDOW))
                    p[3].__enter__()
        out = slot_step(carry_, s, draws_)
        if s % I == I - 1:
            stamps.mark()
        for p in profiles:
            if trace and s == p[0] + traced - 1:
                _sync(device)
                if len(p) > 3:
                    p[3].__exit__(None, None, None)
                p[2].stop()
        return out

    fns.slot_step = window_slot_step
    start = t
    wall0 = time.perf_counter()
    stamps.mark()
    chunk_ends = []      # (slot, host clock) after each chunk's log read
    for carry, t, _ in runner.run_chunks(fns, carry, draws, start, FAR,
                                         int(tp["chunk_slots"]),
                                         torch.float32):
        chunk_ends.append((t, time.perf_counter()))
        done = (time.perf_counter() - wall0 >= seconds
                and (not trace or t >= trace_end))
        if mesh is not None:
            # every rank stops after the same chunk: rank 0's clock decides
            flag = torch.tensor([float(done)], device=device)
            dist.broadcast(flag, 0)
            done = bool(flag.item())
        if done:
            break
    _sync(device)
    wall = time.perf_counter() - wall0
    del fns.slot_step
    if undo is not None:
        undo()
    slots = t - start
    after = [c for c in chunk_ends if c[0] >= trace_end]
    after_trace = ((after[-1][0] - after[0][0], after[-1][1] - after[0][1])
                   if len(after) >= 2 else None)
    events = sum(1 for s in range(start, t) if fns.train_gate(s, carry.replay))
    episodes = stamps.intervals_ms()
    memory_peak = max(_gathered(torch.cuda.max_memory_allocated(device)
                                if device.type == "cuda" else 0, mesh))
    span_ms = spans.ms() if spans else {}
    ranges, parsed = ((Trace(profiles[0][2]), Trace(profiles[1][2]))
                      if trace else (None, None))
    traced_events = sum(1 for s in range(trace_end - traced, trace_end)
                        if fns.train_gate(s, carry.replay))
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
    e2e = {m.name: slots * sh["B_global"] / wall for m in cell.end_to_end
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
            value = spec_mod.reader(m.name)(ctx)
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
    del carry, fns, draws, profiles, ranges, parsed
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    if mesh is not None:
        distributed.shutdown()
        if rank != 0:
            return None
    checked = time.perf_counter()
    numbers = check.run(cap, cfg, device)
    correct, checks = check.verdict(numbers, cell.limits)
    log(f"check: {time.perf_counter() - checked:.3f} s")
    out = {"correct": bool(correct), "attempted": slots, "failed": 0,
           "metrics": metrics, "device": device_out}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out
