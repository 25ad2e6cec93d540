"""The program's own spans (``diral_tpu_torch.utils.spans``) joined to
the device-only profile of a traced run.

The program supplies raw records alone: each span's name, parent, slot
``t``, rank, thread and two stamps on the Unix clock, and its clock
anchors, two such stamps either side of one ``cudaStreamQuery`` call,
made at each slot's outermost span while a profiler records.  The
device-only profile records that call as a CUDA runtime row.  This file
is the yardstick: it finds the anchor rows, places the records on the
profile's timeline, and gives each idle gap of the device (the
complement of ``Trace.busy`` inside the window) to what held the device
idle (``Joined.owners``).

Owners: a gap ends when an operation starts; the profile links that
operation to the runtime row that launched it by correlation id.  Where
the launch had not returned when the gap began, the device waited on
the host, and the gap goes to the innermost span that the thread which
opened ``loop.slot`` had open at the launch (autograd's thread launches
while the loop's thread waits in ``learner.step``).  Where the launch
had returned before the gap began, the operation was queued and the
device idle all the same (a dependency, the device's own bubble; with a
full launch queue the host is slots ahead): the gap is ``QUEUED``, in
no layer.  A gap with no launch row (the window's last, which no
operation ends) or launched while no span was open is ``UNSPANNED``.

Placement: the offset from the Unix clock to the profile's is the one
under which the most anchor rows lie between the stamps of an anchor
(see ``offset_ns``); the rows of other profiles' anchors and a slow
first call do not move it.  A profile without anchor rows
(a run on the CPU, a program without spans) places nothing, and every
reader here returns None: no CPU run reads a program-span metric.

Layers: a span's layer is its name's first part, ``runner.*`` counting
as ``loop``; a ``parallel.*`` span counts in the layer of the nearest
enclosing span of another layer (the sampler's all-reduce is the
learner's, the log read's all-gather the loop's)."""

from __future__ import annotations

import bisect
import collections
import importlib
import re
import statistics

ANCHOR_ROW = "cudaStreamQuery"
LAUNCH_ROW = re.compile(r"^(cudaLaunchKernel|cuLaunchKernel)")
# a CUDA runtime or driver call's row (a launch, a copy, a set)
RUNTIME_ROW = re.compile(r"^cu[A-Z]|^cuda")
UNSPANNED = "unspanned"
QUEUED = "queued"
# how far outside its anchor's stamps a row may lie (the profile's clock
# conversion and rounding)
TOLERANCE_US = 20.0


def program():
    """The program's span module, or None where the program has none."""
    try:
        return importlib.import_module("diral_tpu_torch.utils.spans")
    except ImportError:
        return None


def _rows(trace, pattern) -> list:
    return [e for e in trace.cpu if pattern(e.name)]


def _ns(us) -> int:
    return round(us * 1000)


def offset_ns(rows: list, anchors: list):
    """(offset in ns, spread in us, the anchors matched) that maps the
    anchors' stamps onto ``rows`` (profile events, their times in us),
    or None.  A row matches an anchor when it lies between the anchor's
    stamps, give or take ``TOLERANCE_US``; the offset is the one that
    matches the most rows, each anchor matching one row at most (tried: a
    row's middle minus an anchor's, for each of the first rows and every
    anchor), refined to the middle of what every match allows."""
    if not rows or not anchors:
        return None
    tol = round(TOLERANCE_US * 1000)
    spans_ = sorted((a["t0_ns"], a["t1_ns"], i)
                    for i, a in enumerate(anchors))
    starts = [a for a, _, _ in spans_]
    mids = [(_ns(r.time_range.start) + _ns(r.time_range.end)) // 2
            for r in rows]

    def matches(off):
        out, used = [], set()
        for r in rows:
            a_, b_ = _ns(r.time_range.start) - off, _ns(r.time_range.end) - off
            k = bisect.bisect_right(starts, a_ + tol) - 1
            if (k >= 0 and k not in used and spans_[k][0] - tol <= a_
                    and b_ <= spans_[k][1] + tol):
                used.add(k)
                out.append((r, spans_[k]))
        return out
    best = []
    for m in mids[:3]:
        for a, b, _ in spans_:
            got = matches(m - (a + b) // 2)
            if len(got) > len(best):
                best = got
    if len(best) < max(2, len(rows) // 2):
        return None
    offs = sorted((_ns(r.time_range.start) + _ns(r.time_range.end)) // 2
                  - (a + b) // 2 for r, (a, b, _) in best)
    off = offs[len(offs) // 2]
    lo = max(_ns(r.time_range.end) - b for r, (a, b, _) in best)
    hi = min(_ns(r.time_range.start) - a for r, (a, b, _) in best)
    if lo <= hi:
        off = (lo + hi) // 2
    return off, (offs[-1] - offs[0]) / 1e3, [anchors[i]
                                             for _, (_, _, i) in best]


class Joined:
    """This rank's records inside the device-only profile's window, each
    with ``a_us`` / ``b_us`` on the profile's timeline."""

    def __init__(self, trace, records, anchors):
        rows = _rows(trace, lambda n: n == ANCHOR_ROW)
        threads = collections.Counter(r.thread for r in rows)
        self.row_thread = threads.most_common(1)[0][0] if rows else None
        self.rows = sorted((r for r in rows if r.thread == self.row_thread),
                           key=lambda r: r.time_range.start)
        found = offset_ns(self.rows, anchors)
        self.ok = found is not None
        if not self.ok:
            return
        self.offset, self.spread_us, self.anchors = found
        self.trace = trace
        self.records = []
        for r in records:
            a = (r["t0_ns"] + self.offset) / 1e3
            b = (r["t1_ns"] + self.offset) / 1e3
            if b > trace.t0 and a < trace.t1:
                self.records.append(dict(r, a_us=a, b_us=b))
        self.by_id = {r["id"]: r for r in self.records}
        slots = [r for r in self.records if r["name"] == "loop.slot"]
        loops = collections.Counter(r["thread"] for r in slots)
        self.thread = loops.most_common(1)[0][0] if loops else None
        self.slots = sorted((r["a_us"], r["b_us"]) for r in slots)
        self.events = sum(1 for r in self.records
                          if r["name"] == "learner.event")

    def layer(self, rec) -> str:
        while rec["name"].startswith("parallel.") and rec["parent"] in \
                self.by_id:
            rec = self.by_id[rec["parent"]]
        first = rec["name"].split(".")[0]
        return "loop" if first == "runner" else first

    def gaps(self) -> list:
        """The device's idle intervals inside the window, in us."""
        out, edge = [], self.trace.t0
        for a, b in list(self.trace.busy) + [[self.trace.t1, self.trace.t1]]:
            if a > edge:
                out.append((edge, a))
            edge = max(edge, b)
        return out

    def innermost(self, points: list) -> list:
        """For each time in ``points`` (sorted), the innermost record of
        the loop's thread open then, or None."""
        recs = sorted((r for r in self.records if r["thread"] == self.thread),
                      key=lambda r: (r["a_us"], -r["b_us"]))
        out, stack, i = [], [], 0
        for p in points:
            while i < len(recs) and recs[i]["a_us"] <= p:
                while stack and stack[-1]["b_us"] < recs[i]["a_us"]:
                    stack.pop()
                stack.append(recs[i])
                i += 1
            while stack and stack[-1]["b_us"] < p:
                stack.pop()
            out.append(stack[-1] if stack else None)
        return out

    def owners(self) -> list:
        """Each idle gap with its owner (see the module's docstring): a
        record, ``QUEUED``, or None (unspanned, or no launch row); and
        whether the operation ending it was linked to a launch row."""
        launches = {r.id: r for r in self.trace.cpu
                    if RUNTIME_ROW.match(r.name) and getattr(r, "id", 0)}
        opens = {}      # a busy interval's start: the operation there
        for e in sorted(self.trace.device,
                        key=lambda e: (e.time_range.start, e.id)):
            opens.setdefault(max(e.time_range.start, self.trace.t0), e)
        gaps, rows = self.gaps(), []
        for a, b in gaps:
            op = opens.get(b)
            rows.append(launches.get(op.id) if op is not None else None)
        asked = sorted((r.time_range.start, i) for i, r in enumerate(rows)
                       if r is not None and r.time_range.end > gaps[i][0])
        spans_ = dict(zip((i for _, i in asked),
                          self.innermost([p for p, _ in asked])))
        out = []
        for i, (gap, row) in enumerate(zip(gaps, rows)):
            owner = QUEUED if row is not None and i not in spans_ \
                else spans_.get(i)
            out.append((gap, owner, row is not None))
        return out

    def idle_by(self, key) -> dict:
        """Idle seconds by ``key(record)`` of each gap's owner, and
        ``QUEUED`` and ``UNSPANNED``."""
        by = collections.Counter()
        for (a, b), owner, _ in self.owners():
            name = (UNSPANNED if owner is None else owner
                    if owner == QUEUED else key(owner))
            by[name] += (b - a) / 1e6
        return dict(by)

    def in_slots(self, us: float) -> bool:
        i = bisect.bisect_right(self.slots, (us, float("inf"))) - 1
        return i >= 0 and self.slots[i][0] <= us <= self.slots[i][1]


def joined(ctx):
    """``ctx``'s records placed on its device-only profile (a ``Joined``),
    or None where nothing can be placed."""
    if not hasattr(ctx, "_program_spans"):
        mod, found = program(), None
        if mod is not None and getattr(ctx, "trace", None) is not None:
            found = Joined(ctx.trace, mod.records(), mod.anchors())
            found = found if found.ok and found.slots else None
        ctx._program_spans = found
    return ctx._program_spans


def idle_ms(ctx, layer: str):
    """Idle device ms under ``layer``'s spans, a slot (a train event for
    the learner) of the profile's window."""
    j = joined(ctx)
    if j is None:
        return None
    units = j.events if layer == "learner" else len(j.slots)
    if units == 0:
        return None
    return 1e3 * j.idle_by(j.layer).get(layer, 0.0) / units


def launches_per_slot(ctx):
    """Kernel-launch runtime rows (any thread) that start inside the
    program's ``loop.slot`` spans, over those slots."""
    j = joined(ctx)
    if j is None:
        return None
    rows = _rows(ctx.trace, LAUNCH_ROW.match)
    return sum(1 for r in rows if j.in_slots(r.time_range.start)) / len(
        j.slots)


def setup_s(ctx, name: str, less: str | None = None):
    """Seconds of this rank's last ``name`` span (a set-up phase), less
    those of the ``less`` spans inside it."""
    j, mod = joined(ctx), program()
    if j is None:
        return None
    recs = mod.records()
    by_id = {r["id"]: r for r in recs}
    mine = [r for r in recs if r["name"] == name]
    if not mine:
        return None

    def inside(r):
        while r["parent"] in by_id:
            r = by_id[r["parent"]]
            if r["id"] == mine[-1]["id"]:
                return True
        return False
    ns = mine[-1]["t1_ns"] - mine[-1]["t0_ns"] - sum(
        r["t1_ns"] - r["t0_ns"] for r in recs
        if r["name"] == less and inside(r))
    return ns / 1e9


def gathered(ctx):
    """Every rank's records and anchors (``spans.gather()``), or None
    where the program has no spans.  Collective where it has them: every
    rank's readers call it in the same order."""
    if not hasattr(ctx, "_program_gathered"):
        mod = program()
        ctx._program_gathered = None if mod is None else mod.gather()
    return ctx._program_gathered


def issue_skew_ms(ctx):
    """The mean, over this rank's train events in the profile's window, of
    the latest rank's ``parallel.all_reduce`` start minus the earliest's
    (the ranks share one host clock)."""
    everyone = gathered(ctx)
    j = joined(ctx)
    if everyone is None or len(everyone) < 2 or j is None:
        return None
    events = {r["t"] for r in j.records if r["name"] == "learner.event"}
    starts = collections.defaultdict(dict)
    for rank, got in enumerate(everyone):
        for r in got["records"]:
            if r["name"] == "parallel.all_reduce" and r["t"] in events:
                starts[r["t"]].setdefault(rank, r["t0_ns"])
    skews = [max(s.values()) - min(s.values()) for s in starts.values()
             if len(s) == len(everyone)]
    return statistics.fmean(skews) / 1e6 if skews else None


def alignment(ctx):
    """How well the records join the profile: the share of the loop
    thread's launch rows that lie inside a program span; the anchors'
    stamps' distance apart (us: median, widest, and the share under
    ``TOLERANCE_US``); the pairing's spread (us); the share of idle gaps
    whose ending operation was linked to its launch row; the idle
    seconds by layer, ``QUEUED`` and ``UNSPANNED``; and the profile's
    idle seconds."""
    j = joined(ctx)
    if j is None:
        return None
    starts = sorted(r.time_range.start for r in _rows(
        ctx.trace, LAUNCH_ROW.match) if r.thread == j.row_thread)
    owners = j.innermost(starts)
    inside_share = (sum(1 for o in owners if o is not None) / len(starts)
                    if starts else None)
    idle = j.idle_by(j.layer)
    widths = [(a["t1_ns"] - a["t0_ns"]) / 1e3 for a in j.anchors]
    owners = j.owners()
    return {"launch_rows_inside": inside_share,
            "launch_rows": len(starts),
            "anchor_width_us_median": statistics.median(widths),
            "anchor_width_us_max": max(widths),
            "anchors_under_tolerance": sum(
                w < TOLERANCE_US for w in widths) / len(widths),
            "spread_us": j.spread_us,
            "gaps_linked": (sum(1 for *_, linked in owners if linked)
                            / len(owners) if owners else None),
            "idle_s_by_layer": idle,
            "idle_s": sum(b - a for a, b in j.gaps()) / 1e6,
            "slots": len(j.slots), "events": j.events}
