"""RESULTS_TORCH.md against the artifacts it is rendered from
(diral_tpu_torch/scripts/render_results.py).

* ``--check`` passes on the committed tree and fails on a copy with one
  number of a port artifact changed.
* Each table's JAX column reads the JAX package's artifact: a number
  changed there changes the table, and the table shows it.
* The formulas are the JAX script's: its ``_campaign_table`` and
  ``_ppo_seeds_table`` statistics on the same rows.
* The dynamic band, the toy at n = 8 with its collapse classes and the
  three single runs render from stand-in port artifacts beside the JAX
  artifacts of the same runs.
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
    "dynamic-seeds": ("dynamic_seeds5.json", ["rows", 3, "prr_improvement"],
                      "{:+.1%}"),
    "single-runs": ("toy_mlp_250k.json", ["compare_vs_sps",
                                          "prr_improvement"], "{:+.1%}"),
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


NEW_TABLES = ("dynamic-seeds", "dynamic-deciles", "toy-seeds-8", "single-runs")
LAUNCHES = {"K1": 0, "K2": 0, "K3": 0, "K4": 0, "K5": 0, "K6": 0, "K7": 0}


def _stand_ins(root):
    """Port artifacts for the new tables, made from committed ones: the
    dynamic rows are JAX's with ΔPRR + 0.01; toy seeds 3-7 are the port's
    seeds 0-2 and two more, seed 4 a full and seed 6 a partial collapse;
    the single runs are JAX's full runs with the port's launch counts."""
    res = root / "results"

    def load(name):
        return json.loads((res / name).read_text())

    dyn = load("dynamic_seeds5.json")
    for r in dyn["rows"]:
        r["prr_improvement"] = round(r["prr_improvement"] + 0.01, 4)
    (res / "torch_dynamic_seeds5.json").write_text(json.dumps(dyn))
    base = load("torch_toy_seeds3.json")["rows"]
    rows = []
    for seed in range(3, 8):
        r = dict(base[seed % 3], seed=seed)
        if seed == 4:
            r.update(final_decile_sum_reward=-16.0, drqn_prr=1.0)
        if seed == 6:
            r.update(final_decile_sum_reward=-8.5)
        rows.append(r)
    (res / "torch_toy_seeds3to7.json").write_text(json.dumps(
        {"seeds": list(range(3, 8)), "rows": rows}))
    for port, jax in (("torch_scale_bf16_100k.json",
                       "scale_full_100k_bf16.json"),
                      ("torch_toy_mlp_window_250k.json",
                       "toy_mlp_250k.json"),
                      ("torch_toy_bf16_250k.json", "toy_full_250k.json")):
        run = load(jax)
        lstm = 0 if "mlp" in port else 1000
        run["launches"] = {"train": dict(LAUNCHES, K1=lstm),
                           "eval": dict(LAUNCHES)}
        (res / port).write_text(json.dumps(run))
    md = root / rr.RESULTS_MD
    text = md.read_text()
    for name in NEW_TABLES:
        if f"<!-- begin:table-{name} -->" not in text:
            text += (f"\n<!-- begin:table-{name} -->\n"
                     f"<!-- end:table-{name} -->\n")
    md.write_text(text)


def test_new_tables_render(tree):
    _stand_ins(tree)
    assert set(NEW_TABLES) <= set(rr.Tables(str(tree)).registry())
    assert rr.main(["--root", str(tree)]) == 0
    text = (tree / rr.RESULTS_MD).read_text()
    dyn = _table(text, "dynamic-seeds")
    assert "| 0 | +1.42 | 0.748 | 0.523 | +43.9% | 1572 | +42.9% |" in dyn
    assert "0/5 below SPS" in dyn
    deciles = _table(text, "dynamic-deciles")
    assert deciles.count("| port |") == deciles.count("| JAX |") == 5
    assert "| 0 | JAX | -0.44 | -1.57 |" in deciles
    toy = _table(text, "toy-seeds-8")
    assert toy.count("| full |") == 2      # port seed 4, JAX sweep seed 6
    assert ("- collapses: port 1 full and 1 partial of 8; JAX's sweep 1 "
            "full and 2 partial of 8") in toy
    assert "SPS PRR 0.6437 in every row: **met**" in toy
    assert "(n=8, population std)" in toy and "(n=3)" in toy
    single = _table(text, "single-runs")
    mlp = next(line for line in single.splitlines()
               if line.startswith("| toy_4ue_3r_mlp"))
    assert "| 0 |" in mlp and mlp.endswith("| -16.00 | 0.474 | -26.2% |")
    bf16 = next(line for line in single.splitlines()
                if line.startswith("| toy_4ue_3r, bfloat16"))
    # JAX's bf16 toy has no artifact: RESULTS.md's deciles 1-8 and eval
    assert bf16.endswith("| -4.85 → -1.01 | -- | 0.684 | +6.8% |")
    assert rr.main(["--check", "--root", str(tree)]) == 0


def test_collapse_classes():
    assert rr.collapse(-16.0, 0.6) == rr.collapse(-1.0, 1.0) == "full"
    assert rr.collapse(-8.4, 0.65) == "partial"
    assert rr.collapse(-7.9, 0.7) == "none"
