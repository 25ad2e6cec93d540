"""Reading a ``torch.profiler`` trace of the window's traced slots.

Two profiles are taken.  The first records the host's ops as well, which
slows the host several-fold, so it is read only for what its kernels'
own durations give: the layer attribution.  The second records the
device alone (and the CUDA runtime calls) and gives the busy and idle
time and the breakdown.

Layer spans: the harness wraps its calls into the layers in
``record_function`` ranges named ``bench.<layer>``.  The profiler marks
each range on the device's timeline too (a user annotation from the
first to the last kernel the range launched); a range's device seconds
are the union of the kernel intervals inside its annotations.  The train
event's LSTM backward runs on autograd's thread under the backward node
of the op, found by name; its device seconds are those of the kernels
the profiler links to that node and its children.  Busy time is the
union of all device operations (kernels, copies, sets; not annotations)
inside the traced window; an idle gap is named by what the host thread
that ran the window was doing at its middle: the innermost ``bench.*``
range and the innermost op."""

from __future__ import annotations

import collections
import re

import torch

WINDOW = "bench.window"
NCCL_KERNEL = re.compile(r"^nccl(Dev)?Kernel")
# a collective's range as torch.distributed marks it on the device's
# timeline: an annotation, never a kernel
NCCL_RANGE = re.compile(r"^nccl:")
BACKWARD_LSTM = re.compile(r"(?i)backward.*(lstm|triple|flatop)"
                           r"|(lstm|triple|flatop).*backward")


def _device_time_s(evt) -> float:
    us = getattr(evt, "device_time_total", None)
    if us is None:
        us = evt.cuda_time_total
    return us / 1e6


def _is_device(evt) -> bool:
    return evt.device_type == torch.autograd.DeviceType.CUDA


def _union(spans) -> list:
    merged = []
    for a, b in sorted(spans):
        if b <= a:
            continue
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _overlap_us(merged, a, b) -> float:
    return sum(max(0.0, min(b, y) - max(a, x)) for x, y in merged
               if y > a and x < b)


class Trace:
    """The parts of a finished profile that the metric readers use."""

    def __init__(self, prof):
        events = list(prof.events())
        self.cpu = [e for e in events if not _is_device(e)]
        marks = {e.name for e in self.cpu
                 if getattr(e, "is_user_annotation", False)}
        device = [e for e in events if _is_device(e)]
        self.annotations = [e for e in device
                            if getattr(e, "is_user_annotation", False)
                            or e.name in marks or e.name.startswith("bench.")
                            or NCCL_RANGE.match(e.name)]
        notes = set(map(id, self.annotations))
        self.device = [e for e in device if id(e) not in notes]
        win = [e for e in self.cpu if e.name == WINDOW]
        if win:
            self.t0, self.t1 = win[0].time_range.start, win[0].time_range.end
            self.thread = win[0].thread
        else:
            # a device-only profile: from its first to its last record
            spans = [e.time_range for e in events]
            self.t0 = min(r.start for r in spans)
            self.t1 = max(r.end for r in spans)
            threads = collections.Counter(e.thread for e in self.cpu)
            self.thread = threads.most_common(1)[0][0] if threads else None
        self.window_s = (self.t1 - self.t0) / 1e6
        self.busy = _union((max(e.time_range.start, self.t0),
                            min(e.time_range.end, self.t1))
                           for e in self.device)
        self.busy_s = sum(b - a for a, b in self.busy) / 1e6
        self._all = _union((e.time_range.start, e.time_range.end)
                           for e in self.device)

    def range_device_s(self, name: str) -> tuple[float, int]:
        """(device seconds, count) of the host ranges called ``name``:
        the union of the kernel intervals inside their device-side
        annotations."""
        calls = sum(1 for e in self.cpu if e.name == name)
        marks = [e for e in self.annotations if e.name == name]
        us = sum(_overlap_us(self._all, e.time_range.start,
                             e.time_range.end) for e in marks)
        return us / 1e6, calls

    def backward_lstm_s(self) -> tuple[float, int]:
        """(device seconds, count) under the LSTM op's backward nodes,
        the outermost of nested matches only."""
        hits = [e for e in self.cpu if BACKWARD_LSTM.search(e.name)]
        outer = [e for e in hits if not any(
            o is not e and o.thread == e.thread
            and o.time_range.start <= e.time_range.start
            and e.time_range.end <= o.time_range.end for o in hits)]
        return sum(_device_time_s(e) for e in outer), len(outer)

    def nccl_s(self) -> float:
        """Device seconds of the NCCL kernels inside the window."""
        return sum((min(e.time_range.end, self.t1)
                    - max(e.time_range.start, self.t0)) / 1e6
                   for e in self.device if NCCL_KERNEL.match(e.name)
                   and e.time_range.end > self.t0
                   and e.time_range.start < self.t1)

    def device_ops(self, top: int = 10) -> list:
        by = collections.Counter()
        for e in self.device:
            if self.t0 <= e.time_range.start < self.t1:
                by[e.name] += (e.time_range.end - e.time_range.start) / 1e6
        return [[n, s] for n, s in by.most_common(top)]

    def idle_gaps(self, top: int = 10) -> list:
        """Idle device time inside the window, summed by what the host
        thread was doing at each gap's middle."""
        host = sorted((e for e in self.cpu if e.thread == self.thread
                       and e.name != WINDOW),
                      key=lambda e: (e.time_range.start, -e.time_range.end))
        gaps, edge = [], self.t0
        for a, b in self.busy + [[self.t1, self.t1]]:
            if a > edge:
                gaps.append((edge, a))
            edge = max(edge, b)
        by = collections.Counter()
        stack, i = [], 0
        for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = (a + b) / 2
            while i < len(host) and host[i].time_range.start <= mid:
                e = host[i]
                while stack and stack[-1].time_range.end < e.time_range.start:
                    stack.pop()
                stack.append(e)
                i += 1
            while stack and stack[-1].time_range.end < mid:
                stack.pop()
            live = [e for e in stack if e.time_range.end >= mid]
            bench = [e.name for e in live if e.name.startswith("bench.")]
            ops = [e.name for e in live if not e.name.startswith("bench.")]
            label = "/".join(x for x in (bench[-1] if bench else None,
                                         ops[-1] if ops else None) if x)
            by[label or "host"] += (b - a) / 1e6
        return [[n, s] for n, s in by.most_common(top)]
