"""The port's own spans (diral_tpu_torch/utils/spans.py): off, a span
records nothing and enters no profiler range; on, spans nest with their
parents and the unit's ``t``; set-up spans record either way; under a CPU
``torch.profiler`` tracing turns on by itself and each record lies on
the profiler's clock; a slot loop traced gives the bits of one not
traced; ``train --profile DIR``'s trace shows ``diral.loop.slot``; the
mesh's collective spans carry their op and bytes over gloo."""

import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from diral_tpu_torch.config import load_config
from diral_tpu_torch.train import cli, runner
from diral_tpu_torch.train.loop import Draws, make_train_functions
from diral_tpu_torch.utils import spans

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
TOY = os.path.join(ROOT, "configs", "toy_4ue_3r.yaml")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the slot loops run thousands of small ops,
    which the suite's parallel workers would otherwise oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _clean():
    spans.enable(False)
    spans.reset()
    yield
    spans.enable(False)
    spans.reset()


def test_off_records_nothing_and_makes_no_range(monkeypatch):
    made = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: made.append(a))

    def no_clock():
        raise AssertionError("an off span read the clock")
    monkeypatch.setattr(spans, "time", SimpleNamespace(time_ns=no_clock))
    first = spans.span("loop.slot", t=3)
    with first:
        with spans.span("nets.act", rows=8) as inner:
            assert inner is first
    assert spans.records() == [] and spans.anchors() == []
    assert made == []


def test_on_nests_records_with_parents_and_t():
    spans.enable(True)
    with spans.span("loop.slot", t=5):
        with spans.span("nets.act"):
            pass
        with spans.span("learner.event"):
            with spans.span("learner.step", k=0):
                pass
    with spans.span("loop.slot", t=6):
        pass
    recs = {(r["name"], r["t"]): r for r in spans.records()}
    slot = recs[("loop.slot", 5)]
    assert slot["parent"] is None
    assert recs[("nets.act", 5)]["parent"] == slot["id"]
    event = recs[("learner.event", 5)]
    step = recs[("learner.step", 5)]
    assert event["parent"] == slot["id"] and step["parent"] == event["id"]
    assert step["attrs"] == {"k": 0}
    assert slot["t0_ns"] <= event["t0_ns"] <= step["t0_ns"] \
        <= step["t1_ns"] <= event["t1_ns"] <= slot["t1_ns"]
    assert recs[("loop.slot", 6)]["t0_ns"] >= slot["t1_ns"]
    assert {r["rank"] for r in recs.values()} == {0}
    assert len({r["thread"] for r in recs.values()}) == 1
    # no profiler: no clock anchor
    assert spans.anchors() == []
    assert [r["name"] for r in spans.records()][-1] == "loop.slot"
    spans.reset()
    assert spans.records() == [] and spans.dropped() == 0


def _toy():
    """configs/toy_4ue_3r.yaml at two envs, batch 16 and 32-wide layers,
    every slot on the policy: train events at every episode's last slot
    from slot 49 on."""
    cfg = load_config(TOY)
    net = dataclasses.replace(cfg.agent.network, layers=(32, 32))
    return dataclasses.replace(
        cfg, explore=0, save_positions=False,
        engine=dataclasses.replace(cfg.engine, num_envs=2),
        agent=dataclasses.replace(cfg.agent, batch_size=16, network=net))


def test_setup_spans_record_with_tracing_off():
    with spans.once("setup.carry"):
        with spans.span("nets.act"):
            pass
    assert [r["name"] for r in spans.records()] == ["setup.carry"]
    spans.reset()
    fns = make_train_functions(_toy(), torch.float32, "cpu")
    fns.init_carry(Draws(torch.Generator().manual_seed(0)))
    recs = {r["name"]: r for r in spans.records()}
    assert set(recs) == {"setup.functions", "setup.carry", "setup.warmup",
                         "setup.pretrain"}
    carry = recs["setup.carry"]
    assert recs["setup.warmup"]["parent"] == carry["id"]
    assert recs["setup.pretrain"]["parent"] == carry["id"]
    assert recs["setup.functions"]["parent"] is None
    assert carry["t1_ns"] - carry["t0_ns"] >= (
        recs["setup.pretrain"]["t1_ns"] - recs["setup.pretrain"]["t0_ns"])


def test_auto_on_under_a_cpu_profiler_on_its_clock():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for t in (40, 41):
            with spans.span("loop.slot", t=t):
                with spans.span("nets.act"):
                    torch.ones(64).sum()
                time.sleep(0.002)
    with spans.span("loop.slot", t=42):
        pass
    recs = spans.records()
    assert [r["t"] for r in recs if r["name"] == "loop.slot"] == [40, 41]
    assert [a["t"] for a in spans.anchors()] == [40, 41]
    for a in spans.anchors():
        assert a["t0_ns"] <= a["t1_ns"]
    start = prof.profiler.kineto_results.trace_start_ns()
    events = [e for e in prof.events() if e.name.startswith("diral.")]
    assert sorted(e.name for e in events) == sorted(
        "diral." + r["name"] for r in recs)
    for name in ("loop.slot", "nets.act"):
        mine = sorted(r["t0_ns"] for r in recs if r["name"] == name)
        theirs = sorted(start + round(e.time_range.start * 1e3)
                        for e in events if e.name == "diral." + name)
        for m, e in zip(mine, theirs):
            assert abs(e - m) < 2_000_000, (name, e - m)


def _run_slots(trace: bool):
    spans.enable(trace)
    cfg = _toy()
    fns = make_train_functions(cfg, torch.float32, "cpu")
    draws = Draws(torch.Generator().manual_seed(3))
    carry = fns.init_carry(draws)
    logs = {}
    chunks = list(runner.run_chunks(fns, carry, draws, 50, 100, 25,
                                    torch.float32))
    logs = {k: np.concatenate([c[2][k] for c in chunks])
            for k in ("actions", "sum_reward", "loss")}
    return chunks[-1][0], logs


def test_slot_loop_traced_gives_the_bits_of_one_not_traced():
    base_carry, base = _run_slots(False)
    assert spans.records() and all(r["name"].startswith("setup.")
                                   for r in spans.records())
    spans.reset()
    carry, logs = _run_slots(True)
    for k in ("actions", "sum_reward", "loss"):
        assert (logs[k] == base[k]).all(), k
    assert (logs["loss"] != 0).sum() == 2   # train events at 74, 99
    assert torch.equal(carry.replay.buf, base_carry.replay.buf)
    for p, q in zip(carry.learner.params.parameters(),
                    base_carry.learner.params.parameters()):
        assert torch.equal(p, q)
    names = {r["name"] for r in spans.records()}
    assert names >= {"runner.log_read", "loop.slot",
                     "nets.act", "loop.select", "env.step", "env.state",
                     "loop.shape", "loop.replay_add", "loop.history",
                     "learner.event", "learner.sample", "learner.step"}
    slots = [r for r in spans.records() if r["name"] == "loop.slot"]
    assert [r["t"] for r in slots] == list(range(50, 100))
    steps = [r for r in spans.records() if r["name"] == "learner.step"]
    assert {r["t"] for r in steps} == {74, 99}


def test_train_profile_trace_holds_the_slot_span(tmp_path):
    cli.main(["train", TOY, "--device", "cpu", "--slots", "30",
              "--num-envs", "1", "--workdir", str(tmp_path / "w"),
              "--profile", str(tmp_path / "p")])
    trace = json.load(open(tmp_path / "p" / "trace.json"))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert {"diral.loop.slot", "diral.nets.act", "diral.env.step",
            "diral.runner.log_read"} <= names


WORKER = r"""
import json, sys, torch
from diral_tpu_torch.parallel import distributed, mesh as pmesh
from diral_tpu_torch.utils import spans
rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
torch.set_num_threads(1)
distributed.initialize(f"127.0.0.1:{port}", 2, rank, device="cpu")
mesh = pmesh.make_mesh(2)
pmesh.COLLECTIVES = []
spans.enable(True)
x = torch.ones((3, 4), dtype=torch.float32) * (rank + 1)
with spans.span("loop.slot", t=7):
    with spans.span("learner.sample"):
        y = pmesh.all_reduce_sum(x, mesh)
    z = pmesh.all_gather(x[:1], mesh, 0)
everyone = spans.gather()
distributed.shutdown()
json.dump({"sum": y.tolist(), "gathered": z.tolist(),
           "collectives": pmesh.COLLECTIVES, "everyone": everyone},
          open(out, "w"))
"""


def test_collective_spans_carry_op_and_bytes(tmp_path):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    outs = [tmp_path / f"rank{r}.json" for r in range(2)]
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r),
                               str(port), str(outs[r])], cwd=ROOT, env=env)
             for r in range(2)]
    assert [p.wait(timeout=120) for p in procs] == [0, 0]
    got = [json.load(open(o)) for o in outs]
    for rank, g in enumerate(got):
        assert g["sum"] == [[3.0] * 4] * 3
        assert g["collectives"] == [
            {"op": "all_reduce", "axis": "data", "numel": 12, "bytes": 48},
            {"op": "all_gather", "axis": "data", "numel": 4, "bytes": 16}]
        everyone = g["everyone"]
        assert len(everyone) == 2
        for r, mine in enumerate(everyone):
            recs = {x["name"]: x for x in mine["records"]}
            assert recs["setup.process_group"]["rank"] == r
            assert recs["setup.process_group"]["attrs"] == {"world": 2}
            reduce_, gather_ = (recs["parallel.all_reduce"],
                                recs["parallel.all_gather"])
            assert reduce_["attrs"] == {"op": "all_reduce", "bytes": 48}
            assert gather_["attrs"] == {"op": "all_gather", "bytes": 16}
            assert reduce_["parent"] == recs["learner.sample"]["id"]
            assert gather_["parent"] == recs["loop.slot"]["id"]
            assert reduce_["t"] == gather_["t"] == 7 and reduce_["rank"] == r


def test_back_to_back_profilers_inside_one_chunk():
    """Two profilers, one after the other, inside one 50-slot chunk: each
    holds its slots' ranges and no other, and the profiles are freed
    cleanly."""
    import gc
    cfg = _toy()
    fns = make_train_functions(cfg, torch.float32, "cpu")
    draws = Draws(torch.Generator().manual_seed(5))
    carry = fns.init_carry(draws)
    step, profs = fns.slot_step, []

    def profiled_step(carry_, s, draws_):
        if s in (60, 70):
            profs.append(profile(activities=[ProfilerActivity.CPU]))
            profs[-1].start()
        out = step(carry_, s, draws_)
        if s in (69, 79):
            profs[-1].stop()
        return out
    fns.slot_step = profiled_step
    for _ in runner.run_chunks(fns, carry, draws, 50, 100, 50,
                               torch.float32):
        pass
    for p in profs:
        names = [e.name for e in p.events()]
        assert names.count("diral.loop.slot") == 10
        assert "diral.runner.log_read" not in names
    assert [r["t"] for r in spans.records() if r["name"] == "loop.slot"] \
        == list(range(60, 80))
    del profs, p
    gc.collect()
