"""Nothing that the benchmark imports, nor any file under benchmark/,
brings in JAX or the JAX package (top-level names compared whole)."""

import ast
import os
import subprocess
import sys

from benchmark.harness import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "diral_tpu"}


def test_sources_import_nothing_forbidden():
    for d, _, files in os.walk(spec.BENCH_DIR):
        for f in files:
            if not f.endswith(".py"):
                continue
            tree = ast.parse(open(os.path.join(d, f)).read())
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.module:
                    names = [node.module]
                for n in names:
                    assert n.split(".")[0] not in FORBIDDEN, (f, n)


def test_loaded_modules_hold_nothing_forbidden():
    code = (
        "import sys\n"
        "sys.argv = ['x']\n"
        "from benchmark.harness import cell, spec\n"
        "import benchmark.tools.readings\n"
        "import benchmark.run as run\n"
        "for m in spec.load()['per_layer']:\n"
        "    spec.reader(m['name'])\n"
        "for w in spec.load()['workloads']:\n"
        "    spec.cell(w['name'])\n"
        "print(','.join(run.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=spec.ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_forbidden_names_compared_whole():
    sys.path.insert(0, spec.BENCH_DIR)
    import run
    added = ["diral_tpu_torch_like", "diral_tpu.sub"]
    try:
        sys.modules[added[0]] = sys
        assert "diral_tpu" not in run.forbidden_modules()
        sys.modules[added[1]] = sys
        assert "diral_tpu" in run.forbidden_modules()
    finally:
        for name in added:
            sys.modules.pop(name, None)
