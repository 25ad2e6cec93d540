"""The port's own spans: which layer the host is in, on the clock that
``torch.profiler`` stamps its events with.

``span(name, t=None, **attrs)`` is a context manager around one piece of
a layer's work, named ``<layer>.<what>`` (``loop.slot``, ``nets.act``,
``learner.step``, ``parallel.all_reduce``, ...).  Tracing is on after
``enable(True)`` or while a torch profiler records; off, a span reads
one flag and returns a shared no-op object: no clock reading, no
``record_function``, no CUDA call, no sync.  On, each span appends one
record when it closes: its name, the enclosing span (``parent``, by
``id``), the slot or train event ``t`` it belongs to (given to the
unit's outermost span, inherited below it), the rank, the thread,
``t0_ns`` / ``t1_ns`` from ``time.time_ns()`` (the Unix clock, which the
profiler's events use too) and ``attrs`` (such as a collective's bytes).
Under a profiler a span also enters ``record_function("diral.<name>")``,
so that a profile of host ops, such as ``train --profile DIR``'s trace,
shows the program's ranges beside the kernels.

``once(name, **attrs)`` is a span of the run's set-up (``setup.*``): it
runs once a run, so it records whether tracing is on or off.

Clock anchor: a profile of the device alone records the CUDA runtime's
calls but no ``record_function`` range.  So while a profiler records,
each unit's outermost span (the one given ``t``) first makes one
``cudaStreamQuery`` call between two ``time.time_ns()`` stamps
(``anchors()``); the runtime call's row in the profile and the two
stamps place every record on the profile's timeline.

Records go to a buffer of ``CAPACITY`` records; once it is full, later
records are counted (``dropped()``) and not kept.  ``records()`` lists
them, ``reset()`` empties the buffer, ``gather()`` collects every
rank's over the default process group.
"""

from __future__ import annotations

import itertools
import threading
import time

import torch
import torch.autograd.profiler as _profiler
import torch.distributed as dist

CAPACITY = 1 << 18
FIELDS = ("id", "name", "parent", "t", "rank", "thread", "t0_ns", "t1_ns",
          "attrs")
ANCHOR_FIELDS = ("t", "rank", "thread", "t0_ns", "t1_ns")

_enabled = False
_records: list = []
_anchors: list = []
_dropped = 0
_ids = itertools.count()   # next() is atomic: ids stay unique across threads
_local = threading.local()


def enable(on: bool = True) -> None:
    """Record every span (``True``), or only while a profiler records."""
    global _enabled
    _enabled = bool(on)


def _rank() -> int:
    return (dist.get_rank() if dist.is_available() and dist.is_initialized()
            else 0)


def _thread_state():
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
        _local.thread = threading.get_native_id()
    return st


def _anchor(t) -> None:
    """One ``cudaStreamQuery`` between two clock stamps (the stamps alone
    where CUDA is not in use)."""
    stream = (torch.cuda.current_stream() if torch.cuda.is_initialized()
              else None)
    t0 = time.time_ns()
    if stream is not None:
        stream.query()
    t1 = time.time_ns()
    if len(_anchors) < CAPACITY:
        _anchors.append((t, _rank(), _local.thread, t0, t1))


class _Off:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "t", "attrs", "id", "parent", "t0", "range")

    def __init__(self, name, t, attrs):
        self.name, self.t, self.attrs = name, t, attrs

    def __enter__(self):
        stack = _thread_state()
        parent = stack[-1] if stack else None
        profiled = _profiler._is_profiler_enabled
        self.t0 = time.time_ns()
        if self.t is None:
            self.t = parent.t if parent is not None else None
        elif profiled and (parent is None or parent.t != self.t):
            _anchor(self.t)
        self.id = next(_ids)
        self.parent = parent.id if parent is not None else None
        self.range = None
        if profiled:
            self.range = torch.profiler.record_function(f"diral.{self.name}")
            self.range.__enter__()
        stack.append(self)
        return self

    def __exit__(self, *exc):
        global _dropped
        if self.range is not None:
            self.range.__exit__(*exc)
        t1 = time.time_ns()
        _local.stack.pop()
        if len(_records) < CAPACITY:
            _records.append((self.id, self.name, self.parent, self.t,
                             _rank(), _local.thread, self.t0, t1,
                             self.attrs))
        else:
            _dropped += 1
        return False


def span(name: str, t=None, **attrs):
    """A span of ``name``, recorded while tracing is on (see the module's
    docstring); ``t`` opens a unit (a slot or train event).  A span has
    to close under the profiler it opened under: a range that ends under
    another profiler makes torch write into freed memory."""
    if _enabled or _profiler._is_profiler_enabled:
        return _Span(name, t, attrs)
    return _OFF


def once(name: str, **attrs):
    """A span of the run's set-up: recorded whether tracing is on or
    off."""
    return _Span(name, None, attrs)


def records() -> list[dict]:
    """The recorded spans in the order they closed."""
    return [dict(zip(FIELDS, r)) for r in _records]


def anchors() -> list[dict]:
    """The clock anchors: ``t0_ns`` / ``t1_ns`` stamp either side of one
    ``cudaStreamQuery`` call."""
    return [dict(zip(ANCHOR_FIELDS, a)) for a in _anchors]


def dropped() -> int:
    """Records not kept since the buffer filled."""
    return _dropped


def reset() -> None:
    """Empty the buffer (records, anchors and the dropped count)."""
    global _dropped
    _records.clear()
    _anchors.clear()
    _dropped = 0


def gather() -> list[dict]:
    """Every rank's ``{"records", "anchors"}``, by rank, over the default
    process group (this process's alone without one).  Collective: every
    rank calls it."""
    mine = {"records": records(), "anchors": anchors()}
    if not (dist.is_available() and dist.is_initialized()):
        return [mine]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, mine)
    return out
