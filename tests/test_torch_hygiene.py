"""Package rules of the PyTorch port.

* Import hygiene: importing diral_tpu_torch and every submodule loads no
  JAX-family module and no module of diral_tpu; chip_smoke.py and
  chip_ab.py import neither.
* Device default: entry points run on CUDA unless asked for the CPU, and
  raise without a GPU; a kernel wrapper given a non-CPU tensor it cannot
  launch on raises and never runs its plain version.
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys

import pytest
import torch

from diral_tpu_torch.config import load_config
from diral_tpu_torch.interop import serve
from diral_tpu_torch.ops import _build
from diral_tpu_torch.ops import channel_phase as K5
from diral_tpu_torch.ops import lanes_hist as K7
from diral_tpu_torch.ops import lstm_window as K1
from diral_tpu_torch.ops import piggy_hist as K6
from diral_tpu_torch.train import (checkpoint, evaluate, loop, ppo_loop,
                                   ps_loop, runner)

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax")


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in FORBIDDEN or top == "diral_tpu"


def test_package_imports_no_jax():
    code = (
        "import pkgutil, importlib, sys, json\n"
        "import diral_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages("
        "diral_tpu_torch.__path__, 'diral_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "print(json.dumps({'modules': names, 'loaded': sorted(sys.modules)}))\n")
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "diral_tpu_torch.envs.v2v_env" in res["modules"]
    assert "diral_tpu_torch.train.cli" in res["modules"]
    for name in ("agents.drqn", "agents.replay", "agents.policies",
                 "train.loop", "train.runner", "train.metrics", "convert",
                 "agents.ppo", "agents.dqn", "agents.ps_drqn",
                 "models.actor_critic", "train.ppo_loop", "train.ps_loop",
                 "ops.lanes_hist", "train.checkpoint", "train.sweep",
                 "train.profiling", "scripts.full_run",
                 "scripts.seed_campaign", "interop.transport",
                 "interop.bridge", "interop.gateway_env", "interop.serve",
                 "interop.wire", "scripts.serve_campaign", "bench",
                 "scripts.bench_event", "scripts.kernel_ceiling",
                 "utils.spans", "scripts.episode_campaign",
                 "scripts.ppo_campaign", "scripts.ps_campaign",
                 "scripts.episode_rate", "utils.plotting",
                 "scripts.ref_sweep", "scripts.render_results"):
        assert f"diral_tpu_torch.{name}" in res["modules"], name
    bad = [m for m in res["loaded"] if _forbidden(m)]
    assert not bad, bad
    # the card's machine has no matplotlib: plotting imports it only when
    # it draws
    assert not [m for m in res["loaded"] if m.split(".")[0] == "matplotlib"]


@pytest.mark.parametrize("path", [
    "chip_smoke.py", "chip_ab.py", "chip_mesh.py",
    *sorted(os.path.relpath(os.path.join(d, f), ROOT)
            for d, _, fs in os.walk(os.path.join(ROOT, "diral_tpu_torch"))
            for f in fs if f.endswith(".py"))])
def test_sources_import_no_jax(path):
    tree = ast.parse(open(os.path.join(ROOT, path)).read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert not [n for n in names if _forbidden(n)], names


def test_sim_builds_under_build_dir():
    """The port's simulator builds from the port's own sources into the
    ignored build/ directory, never into a package's source tree."""
    from diral_tpu_torch.interop import gateway_env

    binary = gateway_env.sim_binary()
    build = os.path.join(ROOT, "build")
    assert os.path.commonpath([str(binary), build]) == build
    for pkg in ("diral_tpu", "diral_tpu_torch"):
        assert not str(binary).startswith(os.path.join(ROOT, pkg) + os.sep)
    assert str(gateway_env.CPP_DIR) == os.path.join(
        ROOT, "diral_tpu_torch", "interop", "cpp")
    ignored = subprocess.run(["git", "check-ignore", "-q", str(binary)],
                             cwd=ROOT)
    assert ignored.returncode == 0


def test_chip_smoke_refuses_without_cuda(tmp_path):
    """Without a CUDA device the chip check exits non-zero and prints no
    result; alone in an empty directory it fails too."""
    for cwd, script in ((ROOT, os.path.join(ROOT, "chip_smoke.py")),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd == tmp_path:
            script.write_text(open(os.path.join(ROOT, "chip_smoke.py")).read())
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        out = subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_entry_points_default_to_cuda():
    cfg = load_config(os.path.join(ROOT, "configs", "toy_4ue_3r.yaml"))
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.evaluate_drqn(cfg, None, 0, steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        evaluate.evaluate_sps(cfg, 0, steps=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        runner.train_experiment(cfg, "unused")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.make_train_functions(cfg)
    ppo_cfg = load_config(os.path.join(ROOT, "configs", "ppo_congested.yaml"))
    ps_cfg = load_config(os.path.join(ROOT, "configs",
                                      "congested_6v_5r.yaml"))
    for call in (lambda: ppo_loop.make_ppo_functions(ppo_cfg),
                 lambda: ppo_loop.run_ppo(ppo_cfg, num_episodes=1),
                 lambda: ps_loop.make_ps_functions(ps_cfg, "ps-dqn"),
                 lambda: ps_loop.run_ps(ps_cfg, "ps-drqn", num_episodes=1),
                 lambda: evaluate.evaluate_ppo(ppo_cfg, None, 0, steps=1),
                 lambda: evaluate.evaluate_ps(ps_cfg, None, 0, steps=1),
                 lambda: evaluate.compare_ppo_vs_sps(ppo_cfg, None, 0,
                                                     steps=1),
                 lambda: evaluate.compare_ps_vs_sps(ps_cfg, None, 0, steps=1,
                                                    algo="ps-drqn"),
                 lambda: serve.serve_sps(None, 1),
                 lambda: serve.serve_and_learn(None, None, 1),
                 lambda: serve.serve_and_learn_dqn(None, None, 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    for argv in (["eval", "configs/toy_4ue_3r.yaml", "--steps", "1"],
                 ["train-ppo", "configs/ppo_congested.yaml", "--episodes",
                  "1"],
                 ["train-ps", "configs/congested_6v_5r.yaml", "--algo",
                  "ps-dqn", "--episodes", "1"],
                 ["serve", "--mode", "sps", "--rounds", "1"],
                 ["bench"]):
        out = subprocess.run([sys.executable, "-m", "diral_tpu_torch", *argv],
                             cwd=ROOT, capture_output=True, text=True,
                             timeout=120)
        assert out.returncode != 0 and "no CUDA device" in out.stderr, argv
    for script in ("ppo_campaign", "ps_campaign"):
        out = subprocess.run(
            [sys.executable, "-m", f"diral_tpu_torch.scripts.{script}",
             "--seeds", "1", "--episodes", "1", "--out",
             os.path.join("build", "tests", "refused.json")],
            cwd=ROOT, capture_output=True, text=True, timeout=120)
        assert out.returncode != 0 and "no CUDA device" in out.stderr, script
    for argv in (["episode_rate", "ps-dqn:1:1"],
                 ["ref_sweep", os.path.join("build", "tests", "refused_sweep"),
                  "--slots", "1"]):
        out = subprocess.run(
            [sys.executable, "-m", f"diral_tpu_torch.scripts.{argv[0]}",
             *argv[1:]], cwd=ROOT, capture_output=True, text=True,
            timeout=120)
        assert out.returncode != 0 and "no CUDA device" in out.stderr, argv
    with pytest.raises(RuntimeError, match="no CUDA device"):
        loop.run_experiment(cfg, num_slots=1)


def test_cli_on_cpu_and_checkpoint_refused(tmp_path):
    """compare-sps on the CPU; eval of a checkpoint (no longer refused:
    train/checkpoint.py) loads its learner."""
    out = subprocess.run(
        [sys.executable, "-m", "diral_tpu_torch", "compare-sps",
         "configs/toy_4ue_3r.yaml", "--steps", "3", "--num-envs", "2",
         "--device", "cpu"], cwd=ROOT, capture_output=True, text=True,
        timeout=120, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(res) == {"drqn", "sps", "prr_improvement"}
    assert 0.0 <= res["drqn"]["mean_prr"] <= 1.0
    cfg = load_config(os.path.join(ROOT, "configs", "toy_4ue_3r.yaml"))
    cfg = dataclasses.replace(cfg, engine=dataclasses.replace(cfg.engine,
                                                              num_envs=1))
    gen = torch.Generator().manual_seed(0)
    carry = loop.make_train_functions(cfg, device="cpu").init_carry(
        loop.Draws(gen))
    checkpoint.save(str(tmp_path), 0, carry, gen)
    out = subprocess.run(
        [sys.executable, "-m", "diral_tpu_torch", "eval",
         "configs/toy_4ue_3r.yaml", "--device", "cpu", "--steps", "3",
         "--checkpoint", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "loaded checkpoint at slot 0" in out.stdout
    assert "mean_prr" in json.loads(out.stdout.strip().splitlines()[-1])


def _refuse(*_a, **_k):
    raise AssertionError("the plain version ran for a non-CPU tensor")


def _refuse_plain(monkeypatch):
    monkeypatch.setattr(K5, "channel_phase_plain", _refuse)
    monkeypatch.setattr(K6, "piggy_histogram_plain", _refuse)
    monkeypatch.setattr(K7, "lanes_histogram_plain", _refuse)
    for name in ("lstm_last_flat_plain", "lstm_last_flat_dual_plain",
                 "lstm_last_flat_triple_plain", "lstm_window_bwd_plain"):
        monkeypatch.setattr(K1, name, _refuse)


def test_wrappers_never_fall_back(monkeypatch):
    """Tensors that are not on the CPU go to the kernel path, which raises
    here; the plain versions are never reached."""
    _refuse_plain(monkeypatch)
    meta = dict(device="meta")
    b, n = 2, 8
    with pytest.raises(ValueError, match="device"):
        K5.channel_phase(*(torch.empty(b, n, **meta) for _ in range(2)),
                         torch.empty(b, n, dtype=torch.int32, **meta),
                         *(torch.empty(b, n, n, **meta) for _ in range(5)),
                         0, 3, 250.0, 2, True)
    with pytest.raises(ValueError, match="device"):
        K6.piggy_histogram(*(torch.empty(b, n, n, **meta) for _ in range(2)),
                           *(torch.empty(b, n, **meta) for _ in range(2)),
                           torch.empty(b, n, n, dtype=torch.int32, **meta),
                           500.0, 20)
    with pytest.raises(ValueError, match="device"):
        K7.lanes_histogram(torch.empty(b, 36, **meta),
                           torch.empty(b, 36, dtype=torch.bool, **meta), 6,
                           20, -500.0, 500.0)
    with pytest.raises(ValueError, match="device"):
        K1.lstm_last_flat(torch.empty(4, 6 * 32, **meta),
                          torch.empty(23 + 128, 512, **meta),
                          torch.empty(512, **meta), 6)
    w, b = torch.empty(23 + 128, 512, **meta), torch.empty(512, **meta)
    with pytest.raises(ValueError, match="device"):
        K1.lstm_last_flat_triple(torch.empty(4, 7 * 32, **meta), w, b, w, b,
                                 6)
    with pytest.raises(ValueError, match="device"):
        K1.lstm_last_flat_dual(torch.empty(4, 6 * 32, **meta), w, b, w, b, 6)
    with pytest.raises(ValueError, match="device"):
        K1.lstm_window_bwd(torch.empty(4, 6 * 32, **meta), w, b,
                           torch.empty(4, 128, **meta), 6)
    assert (K5.channel_phase.launches == K6.piggy_histogram.launches
            == K7.lanes_histogram.launches == 0)
    assert (K1.lstm_last_flat_triple.launches == K1.lstm_window_bwd.launches
            == K1.lstm_last_flat_dual.launches == 0)


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device, so a wrapper takes its
    kernel branch on a machine without a GPU."""

    @property
    def device(self):
        return torch.device("cuda")


def _cuda(*shape, dtype=torch.float32):
    return torch.zeros(*shape, dtype=dtype).as_subclass(_FakeCuda)


@pytest.mark.parametrize("kernel", ["K1", "K2", "K3", "K4", "K5", "K6",
                                    "K7"])
def test_cuda_tensor_without_library_raises(monkeypatch, tmp_path, kernel):
    """A CUDA tensor handed to a wrapper where the kernel library cannot be
    built raises (naming nvcc) and never runs the plain version."""
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    _refuse_plain(monkeypatch)
    b, n, i32 = 2, 8, torch.int32
    w, bias = _cuda(23 + 128, 512), _cuda(512)
    wrapper, call = {
        "K1": (K1.lstm_last_flat, lambda: K1.lstm_last_flat(
            _cuda(4, 6 * 32), _cuda(23 + 128, 512), _cuda(512), 6)),
        "K2": (K1.lstm_last_flat_triple, lambda: K1.lstm_last_flat_triple(
            _cuda(4, 7 * 32), w, bias, w, bias, 6)),
        "K3": (K1.lstm_window_bwd, lambda: K1.lstm_window_bwd(
            _cuda(4, 6 * 32), w, bias, _cuda(4, 128), 6)),
        "K4": (K1.lstm_last_flat_dual, lambda: K1.lstm_last_flat_dual(
            _cuda(4, 6 * 32), w, bias, w, bias, 6)),
        "K5": (K5.channel_phase, lambda: K5.channel_phase(
            _cuda(b, n), _cuda(b, n), _cuda(b, n, dtype=i32),
            _cuda(b, n, n), _cuda(b, n, n), *(_cuda(b, n, n, dtype=i32)
                                              for _ in range(3)),
            0, 3, 250.0, 2, True)),
        "K6": (K6.piggy_histogram, lambda: K6.piggy_histogram(
            _cuda(b, n, n), _cuda(b, n, n), _cuda(b, n), _cuda(b, n),
            _cuda(b, n, n, dtype=i32), 500.0, 20)),
        "K7": (K7.lanes_histogram, lambda: K7.lanes_histogram(
            _cuda(b, 36), _cuda(b, 36, dtype=torch.bool), 6, 20, -500.0,
            500.0)),
    }[kernel]
    before = wrapper.launches
    with pytest.raises(RuntimeError, match="nvcc"):
        call()
    assert wrapper.launches == before


def test_build_needs_nvcc(monkeypatch, tmp_path):
    """Without the CUDA toolkit a kernel library cannot be had: the build
    raises, naming nvcc."""
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LIBS", {})
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.library("lstm_window")
    assert sorted(_build.sources()) == ["channel_phase", "lanes_hist",
                                        "lstm_window", "piggy_hist"]
