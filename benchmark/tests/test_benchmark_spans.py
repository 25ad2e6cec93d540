"""The join of the program's spans to the device-only profile
(harness/spans.py) and the readers built on it, on synthetic records and
busy intervals: each idle gap goes to the innermost span of the loop's
thread open when the host launched the operation that ends the gap, or
to the queue where that launch came before the gap; the clock anchor's
offset is found and applied; launch rows count inside the slots; the
issue skew reads the ranks' gathered records; where nothing can be
placed every reader returns None."""

from types import SimpleNamespace

import pytest

from benchmark.harness import spans as join
from benchmark.harness import spec

U0 = 1_790_000_000_000_000_000     # the Unix ns at the profile's time 0
SHIFT = 370_123                    # the anchors' clock against the trace's
LOOP, OTHER = 4242, 4343           # the program's thread ids
ROW_THREAD, BWD_THREAD = 7, 9      # the profile's


def ns(us):
    return U0 + round(us * 1000) + SHIFT


def event(name, a, b, thread=ROW_THREAD, id=0):
    return SimpleNamespace(name=name, thread=thread, id=id,
                           time_range=SimpleNamespace(start=a, end=b))


def record(i, name, a, b, parent=None, t=None, thread=LOOP, rank=0,
           **attrs):
    return {"id": i, "name": name, "parent": parent, "t": t, "rank": rank,
            "thread": thread, "t0_ns": ns(a), "t1_ns": ns(b),
            "attrs": attrs}


RECORDS = [
    record(0, "setup.carry", -3e6, -0.5e6),
    record(10, "setup.warmup", -2.9e6, -1e6, 0),
    # the kernels' build inside the carry, and one before it
    record(11, "setup.kernels", -2.8e6, -1.8e6, 10),
    record(12, "setup.kernels", -5e6, -4e6),
    record(1, "loop.slot", 10, 500, t=1),
    record(2, "nets.act", 20, 100, 1, 1),
    record(3, "env.step", 120, 200, 1, 1),
    record(4, "learner.event", 300, 480, 1, 1),
    record(5, "learner.sample", 310, 400, 4, 1),
    record(6, "parallel.all_reduce", 320, 390, 5, 1, op="all_reduce",
           bytes=64),
    record(7, "loop.slot", 520, 990, t=2),
    record(8, "loop.shape", 600, 700, 7, 2),
    # autograd's thread: no gap goes to it
    record(9, "learner.step", 540, 560, thread=OTHER),
]
ANCHORS = [{"t": t, "rank": 0, "thread": LOOP,
            "t0_ns": ns(a), "t1_ns": ns(b)}
           for t, a, b in ((-9, -4e5, -3.99e5), (-8, -3e5, -2.99e5),
                           (1, 10.0, 13.0), (2, 520.0, 522.5))]
BUSY = [[8, 30], [50, 110], [150, 350], [380, 505], [515, 540], [560, 600],
        [650, 800], [820, 1000]]
# the operation that opens each busy interval, and one inside the third
DEVICE = [event(f"k{i}", a, b, id=101 + i) for i, (a, b) in enumerate(BUSY)]
DEVICE.append(event("k_inside", 200, 260, id=120))
ROWS = [event("cudaStreamQuery", 10.5, 12.5),
        event("cudaStreamQuery", 520.5, 522.0),
        event("cudaLaunchKernel", 5, 6, id=101),
        event("cudaLaunchKernel", 25, 26),
        event("cudaLaunchKernel", 40, 41, id=102),
        event("cudaLaunchKernel", 140, 141, id=103),
        event("cudaLaunchKernel", 365, 366, BWD_THREAD, id=104),
        event("cudaLaunchKernel", 510, 511, id=105),
        event("cudaLaunchKernel", 530, 531, id=120),
        event("cuLaunchKernelEx", 545, 546, id=106),
        event("cudaLaunchKernel", 620, 621, id=107),
        # launched long before its gap: the queue was full
        event("cuLaunchKernelEx", 700, 701, id=108),
        event("cudaMalloc", 600, 640)]
# idle us, by the launch of the operation that ends each gap: unspanned
# 8 (launched before slot 1) + 10 (between the slots) + 10 (the window's
# end, which no operation ends); nets 20, env 40, learner 30 (launched on
# autograd's thread while the loop's sat in the all-reduce), loop 20
# (slot 2's own) + 50 (shaping); queued 20
IDLE_US = {"nets": 20, "env": 40, "learner": 30, "loop": 70,
           "unspanned": 28, "queued": 20}
T1 = 1010.0


def ctx_of(rows=ROWS, records=RECORDS, anchors=ANCHORS, everyone=None):
    program = SimpleNamespace(records=lambda: list(records),
                              anchors=lambda: list(anchors),
                              gather=lambda: everyone or [
                                  {"records": records, "anchors": anchors}])
    trace = SimpleNamespace(cpu=list(rows), busy=BUSY, device=DEVICE,
                            t0=0.0, t1=T1)
    return SimpleNamespace(trace=trace, traced_slots=2), program


@pytest.fixture
def ctx(monkeypatch):
    c, program = ctx_of()
    monkeypatch.setattr(join, "program", lambda: program)
    return c


def read(name, ctx_):
    return spec.reader(name)(ctx_)


def test_each_gap_goes_to_the_innermost_span(ctx):
    j = join.joined(ctx)
    assert j.offset == -U0 - SHIFT and j.spread_us == 0
    assert [a["t"] for a in j.anchors] == [1, 2]
    assert {r["name"] for r in j.records} >= {"loop.slot", "nets.act"}
    assert "setup.carry" not in {r["name"] for r in j.records}
    idle = {k: round(v * 1e6, 6) for k, v in j.idle_by(j.layer).items()}
    assert idle == IDLE_US
    assert read("nets_idle_ms_per_slot", ctx) == pytest.approx(0.010)
    assert read("env_idle_ms_per_slot", ctx) == pytest.approx(0.020)
    assert read("loop_idle_ms_per_slot", ctx) == pytest.approx(0.035)
    assert read("learner_idle_ms_per_event", ctx) == pytest.approx(0.030)
    by_name = j.idle_by(lambda r: r["name"])
    assert by_name["loop.slot"] == pytest.approx(20e-6)
    assert by_name["loop.shape"] == pytest.approx(50e-6)
    assert by_name["parallel.all_reduce"] == pytest.approx(30e-6)


def test_a_full_queue_credits_no_layer(monkeypatch):
    """Every operation launched before the gap it ends, as when the
    host runs slots ahead of the device: all the idle is queued."""
    early = [event(r.name, r.time_range.start - 1000,
                   r.time_range.end - 1000, r.thread, r.id)
             if r.id else r for r in ROWS]
    c, program = ctx_of(early)
    monkeypatch.setattr(join, "program", lambda: program)
    idle = join.joined(c).idle_by(lambda r: r["name"])
    assert set(idle) == {"queued", "unspanned"}
    assert idle["queued"] == pytest.approx(198e-6)
    assert idle["unspanned"] == pytest.approx(10e-6)
    for name in ("nets_idle_ms_per_slot", "env_idle_ms_per_slot",
                 "loop_idle_ms_per_slot", "learner_idle_ms_per_event"):
        assert read(name, c) == 0.0, name


def test_launches_inside_the_slots(ctx):
    # 25, 40, 140, 530, 545, 620, 700 on the loop's thread and 365 on
    # the backward thread; 5 and 510 fall outside the slots
    assert read("launches_per_slot", ctx) == pytest.approx(8 / 2)


def test_alignment_figures(ctx):
    out = join.alignment(ctx)
    assert out["launch_rows_inside"] == pytest.approx(7 / 9)
    assert out["launch_rows"] == 9
    assert out["anchor_width_us_median"] == pytest.approx(2.75)
    assert out["anchor_width_us_max"] == pytest.approx(3.0)
    assert out["anchors_under_tolerance"] == 1.0
    assert out["gaps_linked"] == pytest.approx(8 / 9)
    assert out["idle_s"] == pytest.approx(208e-6)
    assert sum(out["idle_s_by_layer"].values()) == pytest.approx(208e-6)
    assert (out["slots"], out["events"]) == (2, 1)


def test_setup_spans_read_on_the_local_rank(ctx):
    # 2.5 s less the 1.0 s build inside it
    assert read("setup_carry_s", ctx) == pytest.approx(1.5)
    assert read("setup_mesh_s", ctx) is None


def test_an_anchor_offset_is_applied(monkeypatch):
    """The same layout with the trace's own clock 2.5 ms later: the rows
    and busy intervals move, the program's stamps do not."""
    move = 2500.0
    def moved(events):
        return [event(r.name, r.time_range.start + move,
                      r.time_range.end + move, r.thread, r.id)
                for r in events]
    c, program = ctx_of(moved(ROWS))
    c.trace.busy = [[a + move, b + move] for a, b in BUSY]
    c.trace.device = moved(DEVICE)
    c.trace.t0, c.trace.t1 = move, T1 + move
    monkeypatch.setattr(join, "program", lambda: program)
    j = join.joined(c)
    assert j.offset == -U0 - SHIFT + round(move * 1000)
    idle = {k: round(v * 1e6, 6) for k, v in j.idle_by(j.layer).items()}
    assert idle == IDLE_US


def test_skew_reads_every_rank(monkeypatch):
    late = 1.5      # ms: rank 1 issues slot 1's all-reduce this late
    rank1 = [dict(r, rank=1) for r in RECORDS]
    for r in rank1:
        if r["name"] == "parallel.all_reduce":
            r["t0_ns"] += round(late * 1e6)
    # a train event outside the profile's window is not read
    far = record(20, "parallel.all_reduce", 5e6, 5.1e6, t=9)
    everyone = [{"records": RECORDS + [far], "anchors": ANCHORS},
                {"records": rank1 + [dict(far, t0_ns=far["t0_ns"] + 10**9)],
                 "anchors": ANCHORS}]
    c, program = ctx_of(everyone=everyone)
    calls = []

    def gather():
        calls.append(1)
        return everyone
    program.gather = gather
    monkeypatch.setattr(join, "program", lambda: program)
    assert read("allreduce_issue_skew_ms", c) == pytest.approx(late)
    assert read("allreduce_issue_skew_ms", c) == pytest.approx(late)
    assert calls == [1]      # gathered once a run


@pytest.mark.parametrize("case", ["no_program", "no_rows", "cpu_profile",
                                  "mismatch"])
def test_nothing_placed_reads_none(monkeypatch, case):
    rows = [r for r in ROWS if r.name != "cudaStreamQuery"] \
        if case == "no_rows" else ROWS
    anchors = ANCHORS
    if case == "mismatch":
        # the pairing's offsets spread by far more than the anchors' width
        anchors = [dict(a, t0_ns=a["t0_ns"] + i * 10**6,
                        t1_ns=a["t1_ns"] + i * 10**6)
                   for i, a in enumerate(ANCHORS)]
    c, program = ctx_of(rows, anchors=anchors)
    if case == "cpu_profile":
        c.trace.cpu = [r for r in c.trace.cpu
                       if not r.name.startswith("cuda")
                       and not r.name.startswith("cuLaunch")]
    monkeypatch.setattr(join, "program",
                        lambda: None if case == "no_program" else program)
    for name in ("nets_idle_ms_per_slot", "env_idle_ms_per_slot",
                 "learner_idle_ms_per_event", "loop_idle_ms_per_slot",
                 "launches_per_slot", "setup_carry_s", "setup_mesh_s",
                 "allreduce_issue_skew_ms"):
        assert read(name, c) is None, name


def test_program_module_found():
    assert join.program() is not None
    assert callable(join.program().gather)
