"""RESULTS_TORCH.md against the artifacts it is rendered from
(diral_tpu_torch/scripts/render_results.py).

* ``--check`` passes on the committed tree and fails on a copy with one
  number of a port artifact changed.
* Each table's JAX column reads the JAX package's artifact: a number
  changed there changes the table, and the table shows it.
* The formulas are the JAX script's: its ``_campaign_table`` and
  ``_ppo_seeds_table`` statistics on the same rows.
"""

import importlib.util
import json
import os
import shutil

import pytest

from diral_tpu_torch.scripts import render_results as rr

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))

# table -> (a JAX artifact it reads, the path of one ΔPRR in it, how the
# table prints that number)
JAX_SOURCES = {
    "toy-seeds": ("toy_full_s1.json", ["compare_vs_sps", "prr_improvement"],
                  "{:+.1%}"),
    "scale-seeds": ("scale_seeds5.json", ["rows", 2, "prr_improvement"],
                    "{:+.1%}"),
    "serve-seeds": ("serve_compare_seeds3.json",
                    ["rows", 1, "prr_improvement"], "points"),
    "ppo-seeds": ("ppo_seeds.json",
                  ["runs", 3, "compare_vs_sps", "prr_improvement"], "{:+.1%}"),
    "ps-campaign": ("ps_campaign.json",
                    ["runs", 6, "compare_vs_sps", "prr_improvement"],
                    "{:+.1%}"),
    "ref-sweep": ("ref_sweep.json", [4, "prr_improvement"], "{:+.1%}"),
    "congested-seeds": ("congested_seeds5.json",
                        ["rows", 1, "prr_improvement"], "{:+.1%}"),
}


@pytest.fixture
def tree(tmp_path):
    """A copy of the results and RESULTS_TORCH.md."""
    shutil.copytree(os.path.join(ROOT, "results"), tmp_path / "results")
    shutil.copy(os.path.join(ROOT, rr.RESULTS_MD), tmp_path / rr.RESULTS_MD)
    return tmp_path


def _edit(root, name, path, value):
    p = root / "results" / name
    data = json.loads(p.read_text())
    node = data
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = value
    p.write_text(json.dumps(data))


def _table(text, name):
    begin = text.index(f"<!-- begin:table-{name} -->")
    return text[begin:text.index(f"<!-- end:table-{name} -->")]


def test_check_passes_on_the_committed_tree(capsys):
    assert rr.main(["--check"]) == 0
    assert "match" in capsys.readouterr().out


def test_check_fails_on_a_changed_port_number(tree, capsys):
    assert rr.main(["--check", "--root", str(tree)]) == 0
    _edit(tree, "torch_toy_seeds3.json", ["rows", 1, "prr_improvement"],
          0.2)
    assert rr.main(["--check", "--root", str(tree)]) == 1
    assert "stale" in capsys.readouterr().err
    # the rewrite then brings it back in line, and shows the number
    assert rr.main(["--root", str(tree)]) == 0
    assert rr.main(["--check", "--root", str(tree)]) == 0
    assert "| +20.0% |" in _table((tree / rr.RESULTS_MD).read_text(),
                                  "toy-seeds")


@pytest.mark.parametrize("table", sorted(JAX_SOURCES))
def test_jax_column_reads_the_jax_artifact(tree, table):
    tables = rr.Tables(str(tree)).registry()
    if table not in tables:
        pytest.skip(f"no port artifact for {table} in this tree")
    name, path, fmt = JAX_SOURCES[table]
    value = 0.4321
    _edit(tree, name, path, value)
    assert rr.main(["--check", "--root", str(tree)]) == 1
    rr.main(["--root", str(tree)])
    shown = f"{100 * value:+.1f}" if fmt == "points" else fmt.format(value)
    assert shown in _table((tree / rr.RESULTS_MD).read_text(), table)


def _load_jax_renderer():
    spec = importlib.util.spec_from_file_location(
        "jax_render_results", os.path.join(ROOT, "scripts",
                                           "render_results.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_formulas_are_the_jax_scripts(tree):
    """The port's campaign and PPO tables, against the JAX script's own
    ``_campaign_table`` and ``_ppo_seeds_table`` run on the port's
    artifacts: the same per-seed cells and the same mean ± std."""
    jax = _load_jax_renderer()
    tables = rr.Tables(str(tree))
    jax._load = tables.load
    mine = tables.registry()
    theirs = jax._campaign_table("torch_scale_seeds5.json").splitlines()
    port = mine["scale-seeds"]().splitlines()
    seeds = theirs[2:-1]
    assert len(seeds) == 5
    for a, b in zip(seeds, port[2:]):
        assert b.startswith(a)
    assert theirs[-1].split("**")[3] == port[2 + len(seeds)].split("**")[3]

    # _ppo_seeds_table reads ppo_seeds.json: give it the port's runs
    (tree / "results" / "ppo_seeds.json").write_text(
        json.dumps(tables.load("torch_ppo_seeds5.json")))
    jax_line = jax._ppo_seeds_table().splitlines()[-1]
    port_line = next(line for line in mine["ppo-seeds"]().splitlines()
                     if line.startswith("| **port"))
    assert jax_line.split("**")[3] == port_line.split("**")[3]
