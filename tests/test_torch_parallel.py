"""The port's parallel layer (diral_tpu_torch/parallel, the mesh paths of
train/loop.py, runner.py, checkpoint.py and cli.py, bench.bench_scaling
and scripts/width_report.py) against diral_tpu/parallel and the
one-process run, on the CPU over gloo at tests/test_sharding.py's tiny
sizes.  Multi-process runs are subprocesses (``--device cpu``, one
intra-op thread each).

* (a) ``mesh_from_spec``'s errors and the rank layout against JAX's
  ``make_mesh`` device array (conftest's 8 fake CPU devices).
* (b) The backend rule from the ranks on each host; the carry's env axis
  (``env_axis``, the one map that sharding, checkpoint save and restore
  read) against the leaves JAX's ``carry_shardings`` puts on "data", and
  ``shard_carry``'s slices of exactly those.
* (c) ``ShardedDraws`` are slices of the unsharded draws.
* (d) The masked gather plus its sum is the unsharded gather; in a data=2
  run each train event issues exactly one data-group all-reduce of
  ``sampler_collective_bytes``' bytes and no other collective;
  ``sampler_collective_bytes`` equals JAX's for every config; a data=2
  checkpoint save streams every shard in pieces no larger than its step
  (``SAVE_CHUNK_BYTES`` over the group) and writes the one-process file.
* (e) ``train --mesh`` data=2, data=4 and data=2,model=2 (2, 4 and 4
  processes), cut at slot 32 and resumed: rewards, actions and the
  checkpoint files (learner, Adam, ring, env, generator) bit-equal to
  the one-process run's.
* (f) float64, data=2, JAX's draws replayed: actions and sum rewards
  bit-equal to JAX's unsharded ``slot_step`` over 50 slots (train events
  at t = 24 and 49), losses and parameters within the one-device port's
  own tolerance to JAX (1e-10 / 1e-9: optax and torch order Adam's
  arithmetic differently), and bit-equal to the one-process port run.
* (g) ``bench_scaling`` at n = 1, 2 and ``width_report --no-run``, with
  the JAX sources' keys and log line (read with ``ast``).
"""

import ast
import contextlib
import dataclasses
import io
import json
import os
import re
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from diral_tpu import config as jconfig
from diral_tpu.parallel import mesh as jmesh
from diral_tpu.train import loop as jloop
from diral_tpu_torch import config as tconfig
from diral_tpu_torch.convert import train_carry_from_numpy
from diral_tpu_torch.parallel import distributed
from diral_tpu_torch.parallel import mesh as pmesh
from diral_tpu_torch.train import loop as tloop
from diral_tpu_torch.train import runner

from test_torch_train_slice import JaxChainDraws, carry_dict

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
WORKER = os.path.join(ROOT, "tests", "torch_parallel_worker.py")
ENV = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
SLOTS = 50   # train events at t = 24 and 49 (dryrun_multichip's t = 49)
SAVE_CHUNK = 4096   # bytes a save step moves over the whole data group


def tiny_cfg(mod, num_envs=8, xla=False):
    """tests/test_sharding.py's tiny_cfg in either package; ``xla`` routes
    JAX's env and LSTM through their plain XLA paths (float64 parity)."""
    cfg = mod.toy_4ue_3r(time_slots=64, memory_size=64, explore=0,
                         greedy=10_000, training=True,
                         train_after_episode=True, save_positions=False)
    net = dataclasses.replace(cfg.agent.network, layers=(16, 16))
    env = cfg.env
    if xla:
        net = dataclasses.replace(net, lstm_impl="xla")
        env = dataclasses.replace(env, step_impl="xla", state=dataclasses.
                                  replace(env.state, hist_impl="xla"))
    return dataclasses.replace(
        cfg, env=env,
        agent=dataclasses.replace(cfg.agent, batch_size=8, n_batch=1,
                                  target_update=25, network=net),
        engine=dataclasses.replace(cfg.engine, num_envs=num_envs))


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(argv_of_rank, world):
    return [subprocess.Popen(argv_of_rank(r), cwd=ROOT, env=ENV,
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True) for r in range(world)]


def finish(procs):
    outs = [p.communicate(timeout=240)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


# ---------------------------------------------------------------------------
# (a) mesh construction
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,mp", [(8, 1), (8, 2), (4, 2), (2, 1)])
def test_rank_layout_is_jax_device_layout(n, mp):
    jm = jmesh.make_mesh(n, model_parallel=mp)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    np.testing.assert_array_equal(pmesh.rank_layout(n, mp), ids)
    shape = dict(jm.shape)
    assert (n // mp, mp) == (shape["data"], shape.get("model", 1))
    for r in range(n):
        m = pmesh.Mesh(n // mp, mp, rank=r)
        assert ids.reshape(-1, mp)[m.data_index, m.model_index] == r


def test_mesh_from_spec_validation(tmp_path):
    with pytest.raises(ValueError, match="unknown mesh axis"):
        pmesh.mesh_from_spec("pipeline=2")
    with pytest.raises(ValueError, match="unknown mesh axis"):
        jmesh.mesh_from_spec("pipeline=2")
    with pytest.raises(ValueError, match=r"needs 2 devices; only 1 visible "
                       r".*--coordinator/--num-processes/--process-id"):
        pmesh.mesh_from_spec("data=2")
    one = pmesh.mesh_from_spec("data=1")
    assert (one.data, one.model, one.distributed) == (1, 1, False)
    # JAX's wording for an env count the data axis does not divide
    for train, mesh in ((runner.train_experiment, pmesh.Mesh(4)),
                        (None, "data=4")):
        with pytest.raises(ValueError, match="divisible"):
            if train is None:
                from diral_tpu.train.runner import train_experiment

                train_experiment(tiny_cfg(jconfig, 6), mesh=mesh)
            else:
                train(tiny_cfg(tconfig, 6), str(tmp_path), mesh=mesh,
                      device="cpu", verbose=False)


def test_one_rank_group_runs_its_collectives():
    """A coordinator forms the group even for one process: the mesh is
    distributed and its group runs a collective through the backend when
    asked to explicitly; the mesh's own collectives skip a group of one
    and note nothing."""
    with contextlib.redirect_stdout(io.StringIO()) as out:
        dev = distributed.initialize(f"127.0.0.1:{free_port()}", 1, 0,
                                     "cpu")
    try:
        assert dev == torch.device("cpu")
        assert "backend: gloo (1 rank(s), CPU tensors); rank 0 on cpu" in \
            out.getvalue()
        assert distributed.is_primary()
        with pytest.raises(ValueError, match="needs 2 devices"):
            pmesh.mesh_from_spec("data=2")
        mesh = pmesh.mesh_from_spec("data=1")
        assert mesh.distributed and mesh.backend == "gloo"
        x = torch.arange(6.0)
        y = x.clone()
        torch.distributed.all_reduce(y, group=mesh.data_group)
        assert torch.equal(y, x)
        pmesh.COLLECTIVES = []
        try:
            assert pmesh.all_reduce_sum(x, mesh) is x
            assert pmesh.all_gather(x, mesh) is x
            assert pmesh.COLLECTIVES == []
        finally:
            pmesh.COLLECTIVES = None
    finally:
        distributed.shutdown()
    assert distributed.runtime() is None


def test_initialize_without_coordinator():
    assert distributed.initialize(None, None, None, "cpu") == \
        torch.device("cpu")
    assert distributed.runtime() is None
    with pytest.raises(ValueError, match="needs --coordinator"):
        distributed.initialize(None, 2, 0, "cpu")
    with pytest.raises(ValueError, match="outside"):
        distributed.initialize("127.0.0.1:1", 2, 2, "cpu")
    assert distributed.choose_backend("cpu", [("h", 0)] * 4) == "gloo"


# ranks[r] = (host, cards) as rank r reports it
@pytest.mark.parametrize("ranks,backend,local", [
    ([("a", 1)], "nccl", [0]),
    ([("a", 1)] * 2, "gloo", [0, 1]),                  # two ranks, one card
    ([("a", 8)] * 8, "nccl", list(range(8))),
    # 2 hosts x 4 cards: 8 ranks, each with a card of its own
    ([("a", 4)] * 4 + [("b", 4)] * 4, "nccl", [0, 1, 2, 3] * 2),
    ([("a", 4), ("b", 4)] * 4, "nccl", [0, 0, 1, 1, 2, 2, 3, 3]),
    ([("a", 4)] * 5 + [("b", 4)] * 3, "gloo", [0, 1, 2, 3, 4, 0, 1, 2]),
])
def test_backend_from_ranks_per_host(ranks, backend, local):
    assert distributed.choose_backend("cuda", ranks) == backend
    assert [distributed.local_index(ranks, r)
            for r in range(len(ranks))] == local
    assert distributed.choose_backend("cpu", ranks) == "gloo"


# ---------------------------------------------------------------------------
# (b) the learner's column rule
# ---------------------------------------------------------------------------


def test_carry_shardings_match_jax():
    """The port's env axis is JAX's: ``env_axis`` names exactly the carry
    leaves ``carry_shardings`` puts on "data" (but the ring's pointer and
    fill, one host int each in the port, shared by every env), and
    ``shard_carry`` gives each rank its slice of exactly those while the
    learner (column-sharded in JAX) and the schedules stay whole."""
    jc, tc = tiny_cfg(jconfig), tiny_cfg(tconfig)
    init_fn, _, _ = jloop.make_train_functions(jc, jnp.float32)
    jcarry = jax.eval_shape(init_fn, jax.random.PRNGKey(0))
    jspec = jmesh.carry_shardings(jcarry, jmesh.make_mesh(8, 2))
    on_data = {jax.tree_util.keystr(p)[1:]
               for p, s in jax.tree_util.tree_flatten_with_path(jspec)[0]
               if s.spec[:1] == ("data",)}
    fns = tloop.make_train_functions(tc, torch.float32, "cpu")
    carry = fns.init_carry(tloop.Draws(torch.Generator().manual_seed(0)))
    env = pmesh.env_axis(carry)
    assert set(env) == on_data - {"replay.ptr", "replay.count"}
    assert isinstance(carry.replay.ptr, int)
    for r in range(8):
        mesh = pmesh.Mesh(4, 2, rank=r)
        start, count = mesh.env_slice(8)
        assert (start, count) == (r // 2 * 2, 2)
        part = pmesh.shard_carry(carry, mesh)
        for k, x in pmesh.env_axis(part).items():
            assert torch.equal(x, env[k][start:start + count]), k
        assert part.learner is carry.learner
        assert (part.replay.ptr, part.replay.count, part.eps_state,
                part.beta) == (carry.replay.ptr, carry.replay.count,
                               carry.eps_state, carry.beta)


# ---------------------------------------------------------------------------
# (c) sharded draws
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("start,count", [(0, 4), (4, 4), (2, 2), (6, 2)])
def test_sharded_draws_are_slices(start, count):
    cfg = tiny_cfg(tconfig)
    env, acfg = cfg.env, cfg.agent
    B, N, C = 8, env.num_users, env.num_channels

    def pair():
        return (tloop.Draws(torch.Generator().manual_seed(7)),
                tloop.ShardedDraws(tloop.Draws(torch.Generator().manual_seed(
                    7)), B, start, count))

    whole, part = pair()
    a, b = whole.reset(env, B, torch.float64), part.reset(env, count,
                                                          torch.float64)
    for f in dataclasses.fields(a):
        assert torch.equal(getattr(a, f.name)[start:start + count],
                           getattr(b, f.name)), f.name
    sl = slice(start, start + count)
    calls = [
        lambda d, n: d.warmup_actions(env, n),
        lambda d, n: d.pretrain_actions(3, env, n),
        lambda d, n: d.explore_actions(5, n, N, C),
        lambda d, n: d.eps_greedy(5, n, N, C),
        lambda d, n: d.boltzman(5, n, N, C),
        lambda d, n: d.gumbel(5, n, N, C, torch.float32),
        lambda d, n: d.velocity_kicks(24, n, N),
    ]
    for call in calls:
        x, y = call(whole, B), call(part, count)
        for u, v in zip(*(z if isinstance(z, tuple) else (z,)
                          for z in (x, y))):
            assert torch.equal(u[sl], v)
    # replicated: the parameter draw and the global sampler scores
    pa = whole.params(env.state_space, C, acfg, torch.float32)
    pb = part.params(env.state_space, C, acfg, torch.float32)
    for u, v in zip(pa.parameters(), pb.parameters()):
        assert torch.equal(u, v)
    assert torch.equal(whole.sampler_scores(24, 2, B * 64),
                       part.sampler_scores(24, 2, B * 64))


# ---------------------------------------------------------------------------
# (d) the cross-env sampler and its collective
# ---------------------------------------------------------------------------


def test_masked_gather_plus_sum_is_the_unsharded_gather(monkeypatch):
    cfg = tiny_cfg(tconfig)
    fns = tloop.make_train_functions(cfg, torch.float32, "cpu")
    draws = tloop.Draws(torch.Generator().manual_seed(3))
    carry = fns.init_carry(draws)
    for t in range(30):
        carry, _ = fns.slot_core(carry, t, draws)
    rp, step = carry.replay, fns.window
    scores = torch.rand((2, 8 * rp.capacity),
                        generator=torch.Generator().manual_seed(9))
    want = tloop._gather_flat_windows(rp, scores, 8, step)
    rows = tloop.sample_window_rows_many(rp, scores, 8, step, True)
    # each data rank's partial batch, its all-reduce stood in for by the sum
    monkeypatch.setattr(pmesh, "all_reduce_sum", lambda x, mesh: x)
    for D in (2, 4, 8):
        parts = []
        for r in range(D):
            mesh = pmesh.Mesh(D, 1, rank=r, backend="gloo")
            lo, n = mesh.env_slice(8)
            shard = dataclasses.replace(rp, buf=rp.buf[lo:lo + n])
            parts.append(tloop._gather_flat_windows(shard, scores, 8, step,
                                                    mesh))
        assert all(p.shape == want.shape for p in parts)
        assert torch.equal(sum(parts), want)
        # every window comes from one shard: the others hold zeros
        owners = torch.stack([p.abs().flatten(1).sum(1) > 0 for p in parts])
        assert (owners.sum(0) <= 1).all()
        sums = iter([sum(parts)])
        monkeypatch.setattr(pmesh, "all_reduce_sum",
                            lambda x, mesh: next(sums))
        got = tloop.sample_window_rows_many(
            dataclasses.replace(rp, buf=rp.buf[:8 // D]), scores, 8, step,
            True, pmesh.Mesh(D, 1, rank=0, backend="gloo"))
        monkeypatch.setattr(pmesh, "all_reduce_sum", lambda x, mesh: x)
        for k in rows:
            assert torch.equal(got[k], rows[k]), k


# torch_*.yaml are the port's own copies of a published config, which the
# JAX package's loader refuses (tests/test_torch_dynamic_kernels_config.py)
@pytest.mark.parametrize("name", sorted(
    f for f in os.listdir(os.path.join(ROOT, "configs"))
    if f.endswith(".yaml") and not f.startswith("torch_")))
def test_sampler_collective_bytes_equal_jax(name):
    path = os.path.join(ROOT, "configs", name)
    for dtype_bytes in (4, 2):
        assert tloop.sampler_collective_bytes(
            tconfig.load_config(path), dtype_bytes) == \
            jloop.sampler_collective_bytes(jconfig.load_config(path),
                                           dtype_bytes)


@pytest.fixture(scope="module")
def jax_run():
    """JAX's unsharded float64 run of the tiny config: its init carry, key
    and per-slot logs."""
    jcfg = tiny_cfg(jconfig, xla=True)
    init_fn, slot_step, _ = jloop.make_train_functions(jcfg, jnp.float64)
    carry0 = jax.jit(init_fn)(jax.random.PRNGKey(3))
    step = jax.jit(slot_step)
    carry, logs = carry0, []
    for t in range(SLOTS):
        carry, lg = step(carry, jnp.asarray(t, jnp.int32))
        logs.append(jax.tree.map(np.asarray, lg))
    return jcfg, carry_dict(carry0), carry0.key, carry, logs


@pytest.fixture(scope="module")
def worker_runs(jax_run, tmp_path_factory):
    """One data=2 launch, two jobs: (d) float32 from seeded draws and (f)
    float64 from JAX's init carry with JAX's draws replayed."""
    jcfg, d0, key, _, _ = jax_run
    tmp = tmp_path_factory.mktemp("parallel_worker")
    tcfg = tiny_cfg(tconfig, xla=True)
    chain = JaxChainDraws(key, jcfg, 3, SLOTS)
    B, N, C = 8, jcfg.env.num_users, jcfg.env.num_channels
    table = {"eps_draw": {}, "eps_rand": {}, "kicks": {}, "scores": {}}
    for t in range(SLOTS):
        table["eps_draw"][t], table["eps_rand"][t] = chain.eps_greedy(
            t, B, N, C)
        table["kicks"][t] = chain.velocity_kicks(t, B, N)
        if t % tcfg.episode_interval == tcfg.episode_interval - 1:
            table["scores"][t] = chain.sampler_scores(
                t, tcfg.agent.n_batch, B * tcfg.memory_size)
    carry = train_carry_from_numpy(d0, tcfg)
    jobs = [dict(cfg=tiny_cfg(tconfig), dtype=torch.float32, slots=SLOTS,
                 seed=5, out=str(tmp / "f32.pt"), save_dir=str(tmp / "ck"),
                 save_chunk=SAVE_CHUNK),
            dict(cfg=tcfg, dtype=torch.float64, slots=SLOTS, carry=carry,
                 draws=table, out=str(tmp / "f64.pt"))]
    spec = str(tmp / "spec.pt")
    torch.save({"world": 2, "mesh": "data=2", "jobs": jobs}, spec)
    port = str(free_port())
    finish(launch(lambda r: [sys.executable, WORKER, spec, str(r), port], 2))
    outs = [torch.load(j["out"], weights_only=False) for j in jobs]
    # the one-process port runs of the same jobs
    refs = []
    for j in jobs:
        fns = tloop.make_train_functions(j["cfg"], j["dtype"], "cpu")
        if "carry" in j:
            from torch_parallel_worker import TableDraws

            c, d = train_carry_from_numpy(d0, tcfg), TableDraws(table)
        else:
            d = tloop.Draws(torch.Generator().manual_seed(j["seed"]))
            c = fns.init_carry(d)
        logs = []
        for t in range(SLOTS):
            c, lg = fns.slot_step(c, t, d)
            logs.append(lg)
        refs.append((c, logs))
    return outs, refs


def _equal_to_one_process(out, ref):
    carry, logs = ref
    assert torch.equal(out["sum_reward"],
                       torch.stack([lg["sum_reward"] for lg in logs]))
    assert torch.equal(out["actions"],
                       torch.stack([lg["actions"] for lg in logs]))
    assert out["loss"] == [None if lg["loss"] is None else lg["loss"].item()
                           for lg in logs]
    for k, v in carry.learner.params.state_dict().items():
        assert torch.equal(out["params"][k], v), k
    for k, v in carry.learner.target_params.state_dict().items():
        assert torch.equal(out["target_params"][k], v), k
    opt = carry.learner.opt.state_dict()["state"]
    for i, st in opt.items():
        for k in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(out["opt"]["state"][i][k], st[k]), (i, k)


def test_data_mesh_one_all_reduce_per_train_event(worker_runs):
    out, ref = worker_runs[0][0], worker_runs[1][0]
    _equal_to_one_process(out, ref)
    cfg = tiny_cfg(tconfig)
    coll = tloop.sampler_collective_bytes(cfg)
    # one shard's ring: 4 envs x (S + pad) slots x N * Dp lanes
    replay_elems = (4 * (cfg.memory_size + cfg.agent.step_size)
                    * cfg.env.num_users * tloop.padded_dim(
                        cfg.env.state_space))
    events = [t for t, lg in enumerate(out["loss"]) if lg is not None]
    assert events == [24, 49]
    for t, cs in enumerate(out["collectives"]):
        if t in events:
            assert cs == [{"op": "all_reduce", "axis": "data",
                           "numel": coll["gathered_elems"],
                           "bytes": coll["bytes_per_event"]}], (t, cs)
            assert cs[0]["numel"] < replay_elems
        else:
            assert cs == [], (t, cs)


def test_data_mesh_save_streams_the_one_process_file(worker_runs,
                                                    tmp_path):
    """A data=2 save moves every shard to rank 0 in pieces of at most
    SAVE_CHUNK / 2 bytes a rank -- rank 0's card never holds more than one
    step -- and writes the one-process run's file, nothing else."""
    from diral_tpu_torch.train import checkpoint as ckpt

    out, carry = worker_runs[0][0], worker_runs[1][0][0]

    ckpt.save(str(tmp_path), SLOTS, carry)
    saves = out["save_collectives"]
    assert saves and all(c["op"] == "gather" and c["axis"] == "data"
                         and 2 * c["bytes"] <= SAVE_CHUNK for c in saves)
    # the ring alone takes several steps
    assert len(saves) > len(pmesh.env_axis(carry)) + 1
    sent = sum(c["numel"] for c in saves)
    assert 2 * sent == sum(x.numel() for x in pmesh.env_axis(carry).values())
    mesh_dir = out["save_dir"]
    assert os.listdir(mesh_dir) == [f"ckpt_{SLOTS}.pt"]
    _same(torch.load(os.path.join(mesh_dir, f"ckpt_{SLOTS}.pt"),
                     weights_only=True),
          torch.load(tmp_path / f"ckpt_{SLOTS}.pt", weights_only=True))


def test_data_mesh_float64_with_jax_draws(jax_run, worker_runs):
    _, _, _, jcarry, jlogs = jax_run
    out, ref = worker_runs[0][1], worker_runs[1][1]
    _equal_to_one_process(out, ref)
    for t in range(SLOTS):
        np.testing.assert_array_equal(out["actions"][t].numpy(),
                                      jlogs[t]["actions"], err_msg=str(t))
        np.testing.assert_array_equal(out["sum_reward"][t].numpy(),
                                      jlogs[t]["sum_reward"], err_msg=str(t))
        loss = 0.0 if out["loss"][t] is None else out["loss"][t]
        assert abs(loss - float(jlogs[t]["loss"])) <= 1e-10, t
    assert [t for t, x in enumerate(out["loss"]) if x is not None] == [24, 49]
    for g, leaves in jcarry.learner.params.items():
        for k, v in leaves.items():
            assert np.abs(out["params"][f"{g}.{k}"].numpy()
                          - np.asarray(v)).max() <= 1e-9, (g, k)


# ---------------------------------------------------------------------------
# (e) the train verb over 2 and 4 processes, cut and resumed
# ---------------------------------------------------------------------------


def _tiny_yaml(tmp_path):
    raw = yaml.safe_load(open(os.path.join(ROOT, "configs",
                                           "toy_4ue_3r.yaml")))
    raw.update(time_slots=64, memory_size=64, explore=0, greedy=10_000,
               training=True, train_after_episode=True, save_positions=False,
               save_freq=32, save_model=False)
    raw["RLAgent"].update(batch_size=8, n_batch=1, target_update=25)
    raw["RLAgent"]["network"]["layers"] = {1: 16, 2: 16}
    raw["Engine"] = {"num_envs": 8, "seed": 1}
    path = tmp_path / "tiny.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def _same(a, b, path=""):
    if isinstance(a, dict):
        assert a.keys() == b.keys(), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (u, v) in enumerate(zip(a, b)):
            _same(u, v, f"{path}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        # torch.equal: the all-reduce may turn a -0.0 into +0.0
        assert torch.equal(a, b), path
    else:
        assert a == b, path


MESHES = (("data=2", 2), ("data=4", 4), ("data=2,model=2", 4))


def test_train_verb_mesh_cut_and_resumed(tmp_path):
    cfg = _tiny_yaml(tmp_path)

    def train(wd, slots, mesh=None, world=1):
        argv = [sys.executable, "-m", "diral_tpu_torch", "train", cfg,
                "--device", "cpu", "--workdir", str(wd), "--resume",
                "--slots", str(slots)]
        if mesh is None:
            return launch(lambda r: argv, 1)
        port = str(free_port())
        return launch(lambda r: argv + [
            "--mesh", mesh, "--coordinator", f"127.0.0.1:{port}",
            "--num-processes", str(world), "--process-id", str(r)], world)

    # at most five processes at once: the suite's other workers time
    # things on the host
    ref = tmp_path / "one"
    first = [finish(train(ref, 64) + train(tmp_path / "data=2", 32,
                                           *MESHES[0]))]
    first += [finish(train(tmp_path / m, 32, m, w)) for m, w in MESHES[1:]]
    assert "backend: gloo (4 rank(s), CPU tensors); rank 3 on cpu" in \
        first[1][3]
    outs = [finish(train(tmp_path / m, 64, m, w)) for m, w in MESHES]
    for (m, w), o in zip(MESHES, outs):
        assert "resumed from slot 32" in o[0], (m, o[0])
        # only process 0 prints the episode lines and writes files
        assert "Time step 63" in o[0] and all("Time step" not in x
                                              for x in o[1:])
    res = os.path.join("save_results", "test", "toy_4ue_3r")
    ck = os.path.join("save_model", "test", "toy_4ue_3r")
    for m, _ in MESHES:
        for f in ("rewards_sim0.npy", "actions_sim0.npy"):
            a, b = np.load(ref / res / f), np.load(tmp_path / m / res / f)
            assert a.shape[0] == 64
            np.testing.assert_array_equal(a, b, err_msg=f"{m} {f}")
        assert sorted(os.listdir(tmp_path / m / ck)) == ["ckpt_32.pt",
                                                         "ckpt_64.pt"]
        for name in ("ckpt_32.pt", "ckpt_64.pt"):
            want = torch.load(ref / ck / name, weights_only=True)
            got = torch.load(tmp_path / m / ck / name, weights_only=True)
            _same(got, want, f"{m} {name}")


# ---------------------------------------------------------------------------
# (g) bench_scaling and width_report
# ---------------------------------------------------------------------------


def _source_keys(path):
    """Every string key of a dict literal or a ``x["key"]`` store in a
    source file."""
    keys = set()
    for node in ast.walk(ast.parse(open(os.path.join(ROOT, path)).read())):
        if isinstance(node, ast.Dict):
            keys |= {k.value for k in node.keys
                     if isinstance(k, ast.Constant)}
        if (isinstance(node, ast.Assign)
                and isinstance(node.targets[0], ast.Subscript)
                and isinstance(node.targets[0].slice, ast.Constant)):
            keys.add(node.targets[0].slice.value)
    return keys


def _log_template(path, func, start):
    """The constant pieces of the f-string in ``func``'s log call that
    starts with ``start``."""
    tree = ast.parse(open(os.path.join(ROOT, path)).read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == func)
    for node in ast.walk(fn):
        if (isinstance(node, ast.JoinedStr) and isinstance(
                node.values[0], ast.Constant)
                and node.values[0].value.startswith(start)):
            return [v.value for v in node.values
                    if isinstance(v, ast.Constant)]
    raise AssertionError(f"no {start!r} log line in {path}:{func}")


JAX_WIDTH_KEYS = _source_keys("scripts/width_report.py")
# the v5e ICI projection becomes the H100 NVLink spec projection
WIDTH_RENAMED = {"collective_ms_per_event_at_ici":
                 "collective_ms_per_event_at_nvlink_spec"}


def test_width_report_keys_and_arithmetic(capsys):
    from diral_tpu_torch.scripts import width_report

    assert {"hbm_model", "largest_pow2_B", "measured_run",
            "agent_steps_per_sec"} <= JAX_WIDTH_KEYS
    mine = _source_keys("diral_tpu_torch/scripts/width_report.py")
    assert {WIDTH_RENAMED.get(k, k) for k in JAX_WIDTH_KEYS} <= mine
    out = width_report.main(["--no-run", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(line) == out
    m = out["hbm_model"]["float32"]
    pe = m["per_env_bytes"]
    assert pe["replay"] == (1024 + 6) * 100 * 112 * 4
    assert pe["history"] == 100 * 6 * 112 * 4
    assert out["gather_copy_factor"] == 1.0
    assert m["largest_B_one_chip"] == int(80e9 * 0.85 // pe["total"])
    assert m["largest_pow2_B"] == 1024 and m["chips_for_8192_envs"] == 8
    assert out["hbm_model"]["bfloat16_storage"]["largest_pow2_B"] == 2048
    path = os.path.join(ROOT, "configs", "scale_100v_50r.yaml")
    assert out["sampler_collective"] == jloop.sampler_collective_bytes(
        jconfig.load_config(path))
    assert out["sampler_collective"]["bytes_per_event"] == \
        2 * 256 * 7 * 100 * 112 * 4
    assert "measured_run" not in out
    got = set()

    def walk(d):
        for k, v in d.items():
            got.add(k)
            if isinstance(v, dict):
                walk(v)
    walk(out)
    run_keys = {"num_envs", "slots", "dtype", "compile_plus_first_s",
                "slots_per_sec", "env_slots_per_sec", "agent_steps_per_sec",
                "measured_run"}
    assert {WIDTH_RENAMED.get(k, k) for k in JAX_WIDTH_KEYS} - run_keys \
        <= got


def test_bench_scaling_two_ranks(capfd, monkeypatch):
    from diral_tpu_torch import bench

    monkeypatch.setenv("OMP_NUM_THREADS", "1")   # read by the spawned ranks
    rates = bench.bench_scaling(per_device_envs=4, chunk=8, devices=2,
                                device="cpu")
    assert sorted(rates) == [1, 2]
    assert all(np.isfinite(r) and r > 0 for r in rates.values())
    err = capfd.readouterr().err
    tmpl = _log_template("bench.py", "bench_scaling", "scaling n=")
    assert tmpl == _log_template("diral_tpu_torch/bench.py",
                                 "bench_scaling", "scaling n=")
    lines = re.findall(r"(\S+)".join(map(re.escape, tmpl)), err)
    assert [ln[0] for ln in lines] == ["1", "2"], err
    assert lines[0][2] == "100%"
