"""chip_mesh.py, the several-card check of the port's data mesh,
rehearsed on the CPU over gloo at cut widths, so that the script cannot
rot between card runs.

* ``run_phases`` as ``main`` calls it for two cards, gloo processes
  standing for the cards, on a cut toy (8 envs, 50 slots, nets 16/16,
  train events at t = 24 and 49): (a) the ``train`` verb under data=2 and
  data=1,model=2 bit-equal to one process; (b) one data-group all-reduce
  of ``sampler_collective_bytes`` a train event in the slot loop and
  nothing else there; (c) -- with the four-card script's meshes -- a
  checkpoint saved under data=4 (four processes) at slot 32 resumed
  under data=2,model=2, data=2 and one process, each continuation
  bit-equal to the uncut one-process run, and the cut file equal to the
  one-process file of slot 32; (d) the dry run (slots 49 and 50 over
  data=1,model=2); (f) the width phase at 4 envs a rank over three
  short spans.  (e), ``bench_scaling`` in a process of its own, is left
  out: tests/test_torch_parallel.py runs the sweep at two ranks.
* The row-invariance probe of the acting forward, the kernel-name rows
  of the slot breakdown, the NCCL transport line and the backend check.
* chip_mesh.py raises without two CUDA cards and prints no result.
"""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch
import yaml

import chip_mesh

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The rehearsal's ranks are processes of their own (one thread each);
    this process only compares their files."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tiny_yaml(tmp_path):
    raw = yaml.safe_load(open(os.path.join(ROOT, "configs",
                                           "toy_4ue_3r.yaml")))
    raw.update(time_slots=50, memory_size=64, explore=0, greedy=10_000,
               training=True, train_after_episode=True, save_positions=False,
               save_freq=10_000, save_model=False)
    raw["RLAgent"].update(batch_size=8, n_batch=1, target_update=25)
    raw["RLAgent"]["network"]["layers"] = {1: 16, 2: 16}
    raw["Engine"] = {"num_envs": 8, "seed": 1}
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def test_every_phase_rehearsed_on_gloo_ranks(tmp_path):
    ctx = chip_mesh.Ctx(str(tmp_path), extra=("--device", "cpu"),
                        backend="gloo", cuda=False, timeout=240,
                        env={"OMP_NUM_THREADS": "1"}, concurrent=True)
    widths = dict(chip_mesh.WIDTHS, yaml=_tiny_yaml(tmp_path), envs=8,
                  slots=50, cut=32, invariance_rows=160, invariance_large=None,
                  width_envs=4, width_slots=36, window=(26, 29, 32, 35),
                  profile=(35, 36), cut_mesh=("data=4", 4),
                  resumes=[("data=2,model=2", 4), ("data=2", 2), (None, 1)])
    phases = chip_mesh.run_phases(ctx, 2, widths, only="abcdf")
    assert sorted(phases) == ["a", "b", "c", "d", "f"]
    assert all(p["ok"] for p in phases.values()), phases
    a, b, c, d, f = (phases[k] for k in "abcdf")
    everything = {"rewards": True, "actions": True, "losses": True,
                  "checkpoint": True}
    for mesh in ("data=2", "data=1,model=2"):
        assert a[mesh]["equal"] == everything, mesh
    inv = a["row_invariance"]
    assert inv["rows"] == 160 and sorted(inv["plain"]) == [2, 4]
    assert inv["blocked"] == {4: 0.0, 2: 0.0}
    # the slot loop's collectives: one all-reduce a train event (t = 24
    # and 49 in a whole run, t = 49 after the cut at 32)
    assert b["data=2"]["train_events"] == 2
    assert b["data=2 resumes data=4"]["train_events"] == 1
    assert all(r["slot_all_reduces"] == 2 for r in b["data=2"]["ranks"])
    assert "data=1,model=2" not in b     # a data group of one: none
    assert c["cut"]["file_equal_one_card"]
    for mesh in ("data=2,model=2", "data=2", "one card"):
        assert c[f"{mesh} resumes data=4"]["equal"] == everything, mesh
    assert d["logs_equal"] == {49: True, 50: True}
    assert d["learner_equal_per_rank"] == [True] * 2
    assert f["width data=2"]["envs"] == 8
    assert len(f["width data=2"]["slots_per_s_spans"]) == 3
    assert len(f["efficiency_spans"]) == 3
    assert f["weak_scaling_efficiency"] > 0
    assert f["all_reduce_alone"]["ok"] and len(f["all_reduce_alone"]["ms"]) == 2


def test_slot_rows_and_nccl_line():
    assert chip_mesh.slot_category(
        "void lstm_bwd_partial_kernel<float>(float const*, int)") == "K3"
    assert chip_mesh.slot_category("channel_phase_merge_kernel") == "K5"
    assert chip_mesh.slot_category(
        "ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgs)") == \
        "nccl"
    assert chip_mesh.slot_category(
        "void at::native::vectorized_elementwise_kernel<4>") == "elementwise"
    text = ("h:1:2 [0] NCCL INFO Bootstrap: Using eth0\n"
            "h:1:2 [0] NCCL INFO NVLS multicast support is available on "
            "dev 0 (NVLS_NCHANNELS 16)\n"
            "h:1:2 [0] NCCL INFO Channel 00/0 : 0[0] -> 1[1] via "
            "P2P/CUMEM\n")
    assert chip_mesh.nccl_transport(text) == \
        "Channel 00/0 : 0[0] -> 1[1] via P2P/CUMEM; NVLS offered"
    assert chip_mesh.nccl_transport("no nccl here") is None


def test_backend_check_wants_a_card_each():
    ctx = chip_mesh.Ctx("/nonexistent")
    line = "backend: nccl (2 rank(s), one card per rank); rank {} on cuda:{}"
    assert chip_mesh.backend_ok(ctx, {"backends": [line.format(0, 0),
                                                   line.format(1, 1)]})
    assert not chip_mesh.backend_ok(ctx, {"backends": [line.format(0, 0),
                                                       line.format(1, 0)]})
    assert not chip_mesh.backend_ok(ctx, {"backends": [
        "backend: gloo (2 rank(s), ranks share a card; collectives staged "
        "through host memory); rank 0 on cuda:0", line.format(1, 1)]})
    assert not chip_mesh.backend_ok(ctx, {"backends": [None]})
    assert chip_mesh.resume_meshes(["data=4", "data=2,model=2", "one"]) == \
        [("data=4", 4), ("data=2,model=2", 4), (None, 1)]
    assert chip_mesh.resume_meshes(None) is None


def test_refuses_without_two_cards(tmp_path):
    alone = tmp_path / "chip_mesh.py"
    alone.write_text(open(os.path.join(ROOT, "chip_mesh.py")).read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, str(script)], cwd=cwd, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True)
             for cwd, script in ((ROOT, os.path.join(ROOT, "chip_mesh.py")),
                                 (tmp_path, alone))]
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode != 0
        assert "needs at least two CUDA cards" in err
        assert '"ok"' not in out


# ---------------------------------------------------------------------------
# Repairs found on the cards
# ---------------------------------------------------------------------------


def test_save_gather_holds_one_step_of_receive_buffers(monkeypatch):
    """``gather_to_primary`` on rank 0 holds at most ``SAVE_CHUNK_BYTES``
    of receive buffers at any moment: on four H100s a save added two steps
    (512 MiB) to rank 0's card, because each step's list of pieces was made
    while the last step's was still alive.  Allocations are watched
    through ``torch.empty`` / ``torch.empty_like`` with the group's gather
    stood in for (rank r's piece: the step's slice plus r)."""
    import weakref

    from diral_tpu_torch.parallel import mesh as pmesh

    live, peak = {}, [0]

    def watched(fn):
        def make(*a, **kw):
            t = fn(*a, **kw)
            key = id(t)
            live[key] = t.numel() * t.element_size()
            weakref.finalize(t, live.pop, key, None)
            peak[0] = max(peak[0], sum(live.values()))
            return t
        return make

    def gather(y, parts, dst, group):
        for r, p in enumerate(parts):
            p.copy_(y + r)

    D, chunk = 4, 4 * 16 * 4         # 16 float32 elements a rank a step
    monkeypatch.setattr(pmesh, "SAVE_CHUNK_BYTES", chunk)
    monkeypatch.setattr(pmesh.dist, "gather", gather)
    monkeypatch.setattr(torch, "empty", watched(torch.empty))
    monkeypatch.setattr(torch, "empty_like", watched(torch.empty_like))
    mesh = pmesh.Mesh(D, 1, 0, "gloo")
    x = torch.arange(100, dtype=torch.float32).reshape(25, 4)  # 7 steps
    out = torch.zeros(D * 25, 4)
    pmesh.gather_to_primary(x, mesh, out)
    assert 0 < peak[0] <= chunk
    for r in range(D):
        torch.testing.assert_close(out[25 * r:25 * (r + 1)], x + r,
                                   rtol=0, atol=0)


@pytest.mark.parametrize("n", [1, 7, 8, 9, 30])
def test_dense_rows_gives_each_row_its_bits_whatever_the_count(n):
    """``qnets.dense_rows`` (the acting forward's dense layers): each
    row's result is the same whatever the row count -- the property the
    card's cuBLAS does not give one product (chip_mesh.py's
    ``row_invariance``: on an H100 the 100v/50r Q head at 1600 rows and
    at a data=4 rank's 400 differ) -- within rounding of ``dense``, and
    ``dense`` itself at exactly ``rows`` rows."""
    from diral_tpu_torch.models import qnets

    g = torch.Generator().manual_seed(n)
    params = {"w": torch.randn(12, 5, generator=g),
              "b": torch.randn(5, generator=g)}
    x = torch.randn(n, 12, generator=g)
    whole = qnets.dense_rows(params, x, 8)
    assert whole.shape == (n, 5)
    torch.testing.assert_close(whole, qnets.dense(params, x))
    if n == 8:
        assert torch.equal(whole, qnets.dense(params, x))
    for m in range(1, n + 1):
        assert torch.equal(qnets.dense_rows(params, x[:m], 8), whole[:m])
        assert torch.equal(qnets.dense_rows(params, x[n - m:], 8),
                           whole[n - m:])


@pytest.mark.parametrize("data", [1, 2, 4])
def test_acting_forward_pads_a_shard_to_the_one_card_products(monkeypatch,
                                                              data):
    """``TrainFunctions.qvalues`` makes its dense products of the rows one
    process would hold (``min(qnets.ACT_ROWS, num_envs * N)``): without a
    mesh that is one plain product a layer, the parent's bits; a data
    rank pads its shard to it, so that its Q values are the one-process
    run's rows bit for bit."""
    from diral_tpu_torch.config import toy_4ue_3r
    from diral_tpu_torch.models import qnets
    from diral_tpu_torch.parallel import mesh as pmesh
    from diral_tpu_torch.train.loop import Draws, make_train_functions

    cfg = toy_4ue_3r(save_positions=False)
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(
        cfg.engine, num_envs=8))
    one = make_train_functions(cfg, torch.float32, "cpu")
    learner = one.init_carry(Draws(torch.Generator().manual_seed(0))).learner
    g = torch.Generator().manual_seed(1)
    history = torch.rand(8, one.N, one.T * one.Dp, generator=g)
    whole = one.qvalues(learner, history)
    x = history.reshape(8 * one.N, -1)
    assert torch.equal(whole, qnets.drqn_apply(
        learner.params, x, cfg.agent).reshape(whole.shape))
    seen = []
    dense_rows = qnets.dense_rows
    monkeypatch.setattr(qnets, "dense_rows", lambda p, x, rows: (
        seen.append((x.shape[0], rows)) or dense_rows(p, x, rows)))
    for rank in range(data):
        fns = make_train_functions(cfg, torch.float32, "cpu",
                                   mesh=pmesh.Mesh(data, 1, rank, "gloo"))
        start, count = fns.mesh.env_slice(8)
        got = fns.qvalues(learner, history[start:start + count])
        assert torch.equal(got, whole[start:start + count]), rank
    assert set(seen) == {(8 * one.N // data, 8 * one.N)}
