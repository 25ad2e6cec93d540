"""The FLOP and byte counts of the readers, against hand values for the
cells' shapes, and the arithmetic of mfu_pct and the rooflines."""

from types import SimpleNamespace

import pytest

from benchmark.harness import spec

SCALE = {"B": 1024, "B_global": 1024, "N": 100, "C": 50, "D": 100,
         "Dp": 112, "T": 6, "H1": 256, "H2": 256, "batch": 256,
         "n_batch": 2, "interval": 25}
DYNAMIC = dict(SCALE, B=2048, B_global=2048, N=20, C=15, D=35, Dp=48,
               batch=512)
PEAKS = {"bf16_flops": 989e12, "hbm_bytes": 3.35e12}


def _mod(name):
    import importlib.util
    import os
    path = os.path.join(spec.BENCH_DIR, "metrics", f"{name}.py")
    s = importlib.util.spec_from_file_location(f"m_{name}", path)
    m = importlib.util.module_from_spec(s)
    s.loader.exec_module(m)
    return m


def test_per_window_flops():
    m = _mod("mfu_pct")
    # 6 * 356 * 1024 * 2 + 256 * 256 * 2 + 256 * 50 * 2
    assert m.per_window(6, 100, 256, 256, 50) == 4_531_200
    assert m.per_window(6, 35, 256, 256, 15) == 3_714_560


@pytest.mark.parametrize("shapes,act_gf,event_gf", [
    (SCALE, 464.00, 1160.0), (DYNAMIC, 152.15, 380.37)])
def test_flops_per_slot(shapes, act_gf, event_gf):
    m = _mod("mfu_pct")
    f = m.per_window(6, shapes["D"], 256, 256, shapes["C"])
    act = shapes["B_global"] * shapes["N"] * f
    event = 2 * 5 * shapes["batch"] * shapes["N"] * f
    assert act / 1e9 == pytest.approx(act_gf, rel=1e-4)
    assert event / 1e9 == pytest.approx(event_gf, rel=1e-4)
    assert m.flops_per_slot(shapes) == pytest.approx(act + event / 25)


@pytest.mark.parametrize("after_trace", [None, (1320, 8.0)])
def test_mfu_arithmetic(after_trace):
    """165 slots a second, over the whole window or, where there are
    chunks after the profiles, over those alone."""
    m = _mod("mfu_pct")
    ctx = SimpleNamespace(peaks=PEAKS, slots=1650 if after_trace is None
                          else 1700, wall_s=10.0, after_trace=after_trace,
                          shapes=SCALE)
    want = 100 * (464.0e9 + 46.4e9) * 165.0 / 989e12
    assert m.read(ctx) == pytest.approx(want, rel=1e-3)
    assert m.read(SimpleNamespace(peaks=None, slots=1, wall_s=1,
                                  after_trace=None, shapes=SCALE)) is None


def test_lstm_fwd_counts_and_share():
    m = _mod("lstm_fwd_roofline")
    R = 102_400
    assert m.ops(R, 6, 100, 256) == 102_400 * 6 * 356 * 1024 * 2
    assert m.bytes_moved(R, 6, 100, 112, 256) == 4 * (
        R * 6 * 112 + 356 * 1024 + 1024 + R * 256)
    bound = m.ops(R, 6, 100, 256) / 989e12      # operations bind
    trace = SimpleNamespace(range_device_s=lambda n: (4 * bound * 2, 2))
    ctx = SimpleNamespace(ranges=trace, peaks=PEAKS, shapes=SCALE)
    assert m.read(ctx) == pytest.approx(25.0)


def test_lstm_bwd_counts_and_share():
    m = _mod("lstm_bwd_roofline")
    R = 25_600
    assert m.ops(R, 6, 100, 256) == 6 * R * 356 * 1024 * 2 \
        + 6 * R * 256 * 1024 * 2
    bound = m.ops(R, 6, 100, 256) / 989e12
    trace = SimpleNamespace(backward_lstm_s=lambda: (10 * bound, 2))
    ctx = SimpleNamespace(ranges=trace, peaks=PEAKS, shapes=SCALE)
    assert m.read(ctx) == pytest.approx(20.0)


def test_readers_find_nothing_return_none():
    empty = SimpleNamespace(trace=None, ranges=None, peaks=PEAKS,
                            shapes=SCALE,
                            spans={}, slots=0, events=0, wall_s=1.0,
                            after_trace=None)
    for name in ("act_ms_per_slot", "env_ms_per_slot", "train_event_ms",
                 "lstm_fwd_roofline", "lstm_bwd_roofline",
                 "device_idle_pct", "mfu_pct"):
        assert _mod(name).read(empty) is None


def test_idle_share():
    m = _mod("device_idle_pct")
    ctx = SimpleNamespace(trace=SimpleNamespace(busy_s=0.9, window_s=1.2))
    assert m.read(ctx) == pytest.approx(25.0)
