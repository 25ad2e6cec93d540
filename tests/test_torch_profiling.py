"""The port's training profiler (diral_tpu_torch/train/profiling.py, the
``profile`` verb and ``train --profile DIR``) on the CPU: the summary has
the JAX profiler's keys (read from diral_tpu/train/profiling.py's own
return statements), the CPU gives a valid rate with empty device tables,
the Chrome traces are written, and kernel names fall in their categories.
"""

import ast
import json
import os
from types import SimpleNamespace

import pytest
import torch

from diral_tpu_torch.train import cli, profiling
from test_torch_checkpoint import _cut_yaml

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))


def _jax_summary_keys():
    """The keys of every dict diral_tpu's ``profile_training`` returns."""
    tree = ast.parse(open(os.path.join(ROOT, "diral_tpu", "train",
                                       "profiling.py")).read())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef)
              and n.name == "profile_training")
    keys = [frozenset(k.value for k in r.value.keys)
            for r in ast.walk(fn) if isinstance(r, ast.Return)
            and isinstance(r.value, ast.Dict)]
    assert len(keys) == 2 and len(set(keys)) == 1
    return set(keys[0])


def test_profile_verb_on_cpu(tmp_path, capsys):
    cfg = _cut_yaml(tmp_path)
    trace_dir = tmp_path / "trace"
    capsys.readouterr()
    cli.main(["profile", cfg, "--device", "cpu", "--num-envs", "2",
              "--slots", "10", "--top", "5", "--trace-dir", str(trace_dir)])
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(res) == _jax_summary_keys()
    assert res["config"] == cfg and res["envs"] == 2
    assert res["dtype"] == "float32" and res["slots_per_sec"] > 0
    # no device time on the CPU, as JAX's CPU backend has no device plane
    assert res["categories"] == {} and res["top_ops"] == []
    assert json.load(open(trace_dir / "trace.json"))["traceEvents"]


def test_train_profile_writes_a_trace(tmp_path, capsys):
    cfg = _cut_yaml(tmp_path)
    out_dir = tmp_path / "prof"
    cli.main(["train", cfg, "--device", "cpu", "--slots", "12",
              "--workdir", str(tmp_path / "w"), "--profile", str(out_dir)])
    assert f"profiler trace written to {out_dir}" in capsys.readouterr().out
    events = json.load(open(out_dir / "trace.json"))["traceEvents"]
    assert any(e.get("name", "").startswith("aten::") for e in events)


@pytest.mark.parametrize("name, category", [
    ("void lstm_triple_tc_kernel<float, 2>(float const*, int)",
     "csrc kernel"),
    ("lstm_bwd_rows_tc_kernel<__nv_bfloat16, 32>", "csrc kernel"),
    ("lstm_bwd_partial_kernel<float>", "csrc kernel"),
    ("channel_phase_accept_kernel(float const*, float const*)",
     "csrc kernel"),
    ("channel_phase_merge_kernel", "csrc kernel"),
    ("piggy_hist_kernel(float const*, float const*, int)", "csrc kernel"),
    ("lanes_hist_kernel", "csrc kernel"),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x32",
     "matmul"),
    ("void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm>", "matmul"),
    ("Memcpy HtoD (Pageable -> Device)", "memcpy/memset"),
    ("Memset (Device)", "memcpy/memset"),
    ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel", "sort"),
    ("void at::native::(anonymous namespace)::distribution_elementwise_"
     "grid_stride_kernel<float, 4>", "rng"),
    ("void at::native::reduce_kernel<128, 4, ReduceOp<float>>", "reduce"),
    ("void at::native::vectorized_elementwise_kernel<4, AddFunctor>",
     "elementwise"),
    ("void at::native::index_elementwise_kernel<128, 4>", "elementwise"),
    ("ampere_sgemm_128x64_tn", "matmul"),
    ("some_unknown_kernel", "other"),
])
def test_kernel_categories(name, category):
    assert profiling.categorize(name) == category


def test_device_kernels_sum_by_name():
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(key, us, count, dtype):
        return SimpleNamespace(key=key, self_device_time_total=us,
                               count=count, device_type=dtype)

    prof = SimpleNamespace(key_averages=lambda: [
        ev("lstm_triple_tc_kernel", 2000.0, 4, cuda),
        ev("aten::mm", 500.0, 4, cpu),
        ev("piggy_hist_kernel", 2.5, 100, cuda)])
    ms, n = profiling.device_kernels(prof)
    assert ms == {"lstm_triple_tc_kernel": 2.0, "piggy_hist_kernel": 0.0025}
    assert n == {"lstm_triple_tc_kernel": 4, "piggy_hist_kernel": 100}


def test_profile_needs_the_card_without_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this checks the behaviour without a GPU")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        profiling.profile_training(_cut_yaml(tmp_path))
