"""The port's measurement entry points (diral_tpu_torch/bench.py and
diral_tpu_torch/scripts/{bench_event,kernel_ceiling}.py)
against the root bench.py and scripts/*.py of the JAX package.

Exact: the analytic model FLOPs, the env step's traffic floor in bytes,
the median, and the headline rollout body (float64 on the CPU: the same
start states and actions give the same reward and state-vector sums bit
for bit).  The timed sections run on the CPU at tiny sizes: finite
positive rates and the JAX scripts' JSON keys, read from their sources.
Kernel parity needs the card: on the CPU it raises."""

import ast
import dataclasses
import json
import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

import bench as jbench  # noqa: E402  the JAX package's root bench.py
from diral_tpu import config as jconfig  # noqa: E402
from diral_tpu.envs import v2v_env as jenv  # noqa: E402
from diral_tpu_torch import bench as tbench  # noqa: E402
from diral_tpu_torch import config as tconfig  # noqa: E402
from diral_tpu_torch.envs import v2v_env as tenv  # noqa: E402
from diral_tpu_torch.scripts import bench_event, kernel_ceiling  # noqa: E402

SCALE_YAML = os.path.join(ROOT, "configs", "scale_100v_50r.yaml")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the timed sections run thousands of small ops,
    which the suite's parallel workers would otherwise oversubscribe."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _dict_keys(path, name):
    """Keys of the dict literal assigned to ``name`` (or returned, for
    name None) in a source file, plus ``name["key"] = ...`` stores."""
    tree = ast.parse(open(os.path.join(ROOT, path)).read())
    keys = []
    for node in ast.walk(tree):
        if name is None and isinstance(node, ast.Return) and isinstance(
                node.value, ast.Dict):
            keys += [k.value for k in node.value.keys]
        if name is None or not isinstance(node, ast.Assign):
            continue
        tgt = node.targets[0]
        if (isinstance(tgt, ast.Name) and tgt.id == name
                and isinstance(node.value, ast.Dict)):
            keys += [k.value for k in node.value.keys]
        if (isinstance(tgt, ast.Subscript) and isinstance(tgt.value, ast.Name)
                and tgt.value.id == name
                and isinstance(tgt.slice, ast.Constant)):
            keys.append(tgt.slice.value)
    return keys


JAX_BENCH_KEYS = _dict_keys("bench.py", "out")
JAX_EVENT_KEYS = _dict_keys("scripts/bench_event.py", "result")
JAX_CEILING_KEYS = _dict_keys("scripts/kernel_ceiling.py", None)


def _bench_cfgs(num_envs, compute_dtype):
    """bench.py's training config in both packages."""
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.toy_4ue_3r(save_positions=False, explore=0,
                             memory_size=1024)
        out.append(dataclasses.replace(
            cfg, engine=dataclasses.replace(cfg.engine, num_envs=num_envs),
            agent=dataclasses.replace(
                cfg.agent, network=dataclasses.replace(
                    cfg.agent.network, compute_dtype=compute_dtype))))
    return out


def _cut_train_config(num_envs, compute_dtype="float32",
                      _config=tbench.train_bench_config):
    """bench.py's training config cut: batch 16, 32-wide layers, one
    pretrain length (30 pretrain slots)."""
    cfg = dataclasses.replace(_config(num_envs, compute_dtype),
                              pretrain_length=1)
    return dataclasses.replace(cfg, agent=dataclasses.replace(
        cfg.agent, batch_size=16, network=dataclasses.replace(
            cfg.agent.network, layers=(32, 32))))


def test_jax_key_lists_read():
    assert JAX_BENCH_KEYS[:4] == ["metric", "value", "unit", "vs_baseline"]
    assert "train_slots_per_sec_bf16" in JAX_BENCH_KEYS
    assert len(JAX_EVENT_KEYS) == 17 and "pieces_sum_ms" in JAX_EVENT_KEYS
    assert len(JAX_CEILING_KEYS) == 14 and "fwd_flops_g" in JAX_CEILING_KEYS


@pytest.mark.parametrize("which", ["toy", "toy-bf16", "scale"])
def test_model_flops_equal_jax(which):
    if which == "scale":
        jc, tc = jconfig.load_config(SCALE_YAML), tconfig.load_config(
            SCALE_YAML)
    else:
        jc, tc = _bench_cfgs(256, "bfloat16" if which == "toy-bf16"
                             else "float32")
    assert tbench._train_loop_model_flops(tc) == \
        jbench._train_loop_model_flops(jc)


@pytest.mark.parametrize("xs", [[3.0], [5.0, 1.0], [2.0, 9.0, 4.0],
                                [7.5, 1.25, 3.0, 2.0], [4, 1, 3, 2, 8, 6]])
def test_median_equals_jax(xs):
    assert tbench._median(xs) == jbench._median(xs)


def _jax_floor_bytes(jcfg, num_envs, step):
    """bench.py's byte count (report_env_hbm_bound): the state's leaves
    and jax.eval_shape's outputs of a vmapped step and obtain_state."""
    state = jax.vmap(lambda k: jenv.reset(jcfg, k, jnp.float32))(
        jax.random.split(jax.random.PRNGKey(0), num_envs))
    a_sh = jax.ShapeDtypeStruct((num_envs, jcfg.num_users), jnp.int32)
    _, obs_s, rew_s = jax.eval_shape(
        lambda s, a: jax.vmap(lambda si, ai: step(jcfg, si, ai, 0))(s, a),
        state, a_sh)
    sv_s = jax.eval_shape(
        lambda s, o, a, r_: jax.vmap(
            lambda si, oi, ai, ri: jenv.obtain_state(jcfg, si, oi, ai, ri)
        )(s, o, a, r_), state, obs_s, a_sh, rew_s)

    def sz(leaf):
        return int(np.prod(leaf.shape)) * jnp.dtype(leaf.dtype).itemsize

    return (2 * sum(sz(x) for x in jax.tree.leaves(state))
            + sum(sz(x) for x in (obs_s, sv_s, rew_s)))


@pytest.mark.parametrize("which,num_envs", [("toy", 8), ("scale", 4)])
def test_floor_bytes_equal_jax(which, num_envs):
    if which == "toy":
        jc, tc = jconfig.toy_4ue_3r().env, tconfig.toy_4ue_3r().env
        jstep, tstep = jenv.step_collision, tenv.step_collision
    else:
        jc = jconfig.load_config(SCALE_YAML).env
        tc = tconfig.load_config(SCALE_YAML).env
        jstep, tstep = jenv.step_channel, tenv.step_channel
    gen = torch.Generator().manual_seed(0)
    state = tenv.reset(tc, num_envs, gen, torch.float32, "cpu")
    acts = tenv.sample_actions(tc, gen, num_envs)
    outputs = tbench._one_step_outputs(tc, state, acts, tstep)
    assert tbench.floor_bytes(state, outputs) == _jax_floor_bytes(
        jc, num_envs, jstep)


def test_headline_rollout_equals_jax_float64():
    """8 toy envs x 5 steps from the same injected start states and the
    same actions: bench.py's rollout body (vmapped step_collision +
    obtain_state, per-step sums, then the sum over steps) and the port's
    ``rollout`` give the same reward and state-vector sums, bit for bit."""
    B, steps, t0 = 8, 5, 3
    jc, tc = jconfig.toy_4ue_3r().env, tconfig.toy_4ue_3r().env
    rng = np.random.RandomState(11)
    n, c = tc.num_users, tc.num_channels
    # integer x, y = 0 (reset's draws; see tests/test_torch_env.py)
    topo = (rng.randint(0, tc.highway_length, (B, n)).astype(np.float64),
            np.zeros((B, n)), rng.uniform(1.1, 2.7, (B, n)), np.ones((B, n)))
    acts = rng.randint(0, c, (steps, B, n)).astype(np.int32)

    js = jax.vmap(lambda x, y, v, d: jenv.reset_from(
        jc, x, y, v, d, jnp.float64))(*(jnp.asarray(a) for a in topo))

    @jax.jit
    def jax_rollout(state, actions):
        def body(s, xs):
            i, ai = xs
            s, obs, rew = jax.vmap(
                lambda si, a: jenv.step_collision(jc, si, a, t0 + i))(s, ai)
            sv = jax.vmap(lambda si, oi, a, ri: jenv.obtain_state(
                jc, si, oi, a, ri))(s, obs, ai, rew)
            return s, (rew.sum(), sv.sum())
        _, (rews, svs) = jax.lax.scan(body, state,
                                      (jnp.arange(steps), actions))
        return rews.sum(), svs.sum()

    j_r, j_sv = (float(v) for v in jax_rollout(js, jnp.asarray(acts)))

    ts = tenv.reset_from(tc, *topo, dtype=torch.float64)
    _, t_r, t_sv = tbench.rollout(
        tc, ts, lambda i: torch.from_numpy(acts[i]), t0, steps)
    assert t_r.dtype == torch.float64
    assert float(t_r) == j_r
    assert float(t_sv) == j_sv
    assert j_sv != 0.0


def test_bench_line_keys_equal_jax():
    head = dict(value=2.5e6, value_min=2.4e6, spread=1.04,
                device_init_s=0.31, compile_s=9.7, dispatch_latency_ms=0.02)
    out = tbench.bench_line(head, 1.0e5, 150.0, 140.0)
    assert list(out) == JAX_BENCH_KEYS
    assert out["vs_baseline"] == 2.5
    assert list(tbench.bench_line(head)) == JAX_BENCH_KEYS[:9]


def test_headline_on_cpu():
    head = tbench.headline(num_envs=4, chunk=2, device="cpu")
    out = tbench.bench_line(head)
    assert tbench.finite_positive(out["value"], out["value_min"])
    assert out["spread"] >= 1.0


def test_scale_on_cpu():
    assert tbench.finite_positive(
        tbench.bench_scale(num_envs=2, chunk=2, device="cpu"))


def test_train_loop_on_cpu(capsys, monkeypatch):
    """bench.py's training config cut (batch 16, 32-wide layers): 25 slots
    from slot 116 hold the train event of slot 124."""
    monkeypatch.setattr(tbench, "train_bench_config", _cut_train_config)
    rate = tbench.bench_train_loop(num_envs=1, chunk=25, device="cpu")
    assert tbench.finite_positive(rate)
    err = capsys.readouterr().err
    assert err.count("1 train events") == 4      # first + 3 timed chunks
    assert err.count("0 train events") == 4      # the training-off split
    assert "train event" in err and "no peak for this card (cpu)" in err


def test_kernel_parity_raises_on_cpu():
    with pytest.raises(RuntimeError, match="CUDA device"):
        tbench.bench_kernel_parity(device="cpu")


def test_peaks_only_for_h100_sxm():
    assert tbench.has_peaks("NVIDIA H100 80GB HBM3, 700.00 W")
    for name in ("NVIDIA H100 PCIe, 350.00 W", "NVIDIA H100 NVL, 400.00 W",
                 "NVIDIA A100-SXM4-80GB, 400.00 W", "cpu"):
        assert not tbench.has_peaks(name)


def test_save_capture_keeps_best(tmp_path, monkeypatch):
    path = str(tmp_path / "cap.json")
    monkeypatch.setattr(tbench, "RESULTS", path)
    head = dict(value=2.0e6, value_min=1.9e6, spread=1.05, device_init_s=0.3,
                compile_s=9.0, dispatch_latency_ms=0.02)
    tbench.save_capture(tbench.bench_line(head, 1e5, 150.0), "card A")
    tbench.save_capture(tbench.bench_line(dict(head, value=1.5e6), 2e5),
                        "card B")
    got = json.load(open(path))
    assert set(got) == {"capture", "best_ever", "captured_unix", "card"}
    assert got["capture"]["value"] == 1.5e6 and got["card"] == "card B"
    assert got["best_ever"] == {"value": 2.0e6,
                                "scale_env_steps_per_sec": 2e5,
                                "train_slots_per_sec": 150.0}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bench_event_pieces_on_cpu(dtype, monkeypatch):
    monkeypatch.setattr(bench_event, "train_bench_config", _cut_train_config)
    res = bench_event.measure(dtype, reps=2, envs=2, warm_slots=5,
                              timeit_n=1, device="cpu")
    assert res["dtype"] == dtype
    assert list(res) == JAX_EVENT_KEYS
    assert res["shape"] == {"rows": 64, "T": 6, "H": 32, "Dp": 32,
                            "n_batch": 2}
    ms = [v for k, v in res.items() if k.endswith("_ms")]
    assert len(ms) == 11 and all(math.isfinite(v) for v in ms)
    assert res["event_ms"] > 0 and res["grad_fused_ms"] > 0


def test_bench_event_timing_is_a_difference(monkeypatch):
    """(T(2R) - T(R)) / R cancels a constant cost and a drift that falls
    on both lengths alike: the runs of R and 2R alternate."""
    clock = {"now": 0.0, "runs": 0}

    def piece():
        clock["now"] += 0.004

    lengths = []

    def fake_run(fn, reps, dev):
        lengths.append(reps)
        clock["runs"] += 1
        start = clock["now"]
        for _ in range(reps):
            fn()
        # a constant per run, and the host slowing down run by run
        return clock["now"] - start + 0.5 + 0.01 * ((clock["runs"] - 1) // 2)

    monkeypatch.setattr(bench_event, "timed_run", fake_run)
    per = bench_event.timeit_diff(piece, 8, 3, torch.device("cpu"))
    assert lengths == [8, 16] * 4
    assert per == pytest.approx(0.004)


def test_kernel_ceiling_on_cpu(monkeypatch):
    assert kernel_ceiling.SHAPES == {
        "toy": dict(rows=2048, T=6, H=256, D=23),
        "scale": dict(rows=25600, T=6, H=256, D=100)}
    sizes = {"toy": dict(rows=16, T=6, H=32, D=23),
             "scale": dict(rows=24, T=6, H=32, D=100)}
    monkeypatch.setattr(kernel_ceiling, "SHAPES", sizes)
    out = kernel_ceiling.measure(["toy", "scale"], reps=2, timeit_n=1,
                                 device="cpu")
    for name, row in out.items():
        assert list(row) == JAX_CEILING_KEYS, name
        assert row["rows"] == sizes[name]["rows"]
        assert all(math.isfinite(row[k]) for k in
                   ("fwd_ms", "dual_ms", "triple_ms", "fwdbwd_ms"))


def test_chip_smoke_key_lists_equal_jax():
    """chip_smoke.py's phase (h) holds the port's JSON lines against its
    own copy of the JAX scripts' keys (it imports nothing of JAX)."""
    import chip_smoke

    assert chip_smoke.JAX_BENCH_KEYS == JAX_BENCH_KEYS
    assert chip_smoke.JAX_EVENT_KEYS == JAX_EVENT_KEYS
    assert chip_smoke.JAX_CEILING_KEYS == JAX_CEILING_KEYS
    assert (chip_smoke.BF16_PEAK, chip_smoke.F32_PEAK,
            chip_smoke.HBM_BYTES_PER_S) == (989e12, 67e12, 3.35e12)
