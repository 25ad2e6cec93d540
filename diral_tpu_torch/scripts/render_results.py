"""Regenerate RESULTS_TORCH.md's tables from the port's results/torch_*.json
artifacts (scripts/render_results.py's method, for the port's own bands).

Every table sits between ``<!-- begin:table-NAME -->`` / ``<!-- end:table-
NAME -->`` markers and is rewritten from its artifacts, so the published
numbers cannot drift from the measured ones.  Each row puts the port's
number beside the JAX package's from the JAX artifact of the same band
(same seed, config or algorithm), and where the port's artifact carries a
``checks`` block, verdict lines under the table state it.  The row
formats and statistics are the JAX script's (its ``_campaign_table``,
``_serve_seeds_table``, ``_ppo_seeds_table``, ``_ps_campaign_table``,
``_ref_sweep_table``); the JAX package's numbers come from its committed
artifacts, never from a run of it.  The toy at n = 8 and the single runs
have no JAX table to follow: their verdict lines (the collapse classes,
SPS PRR, learning) are computed here, and JAX's bf16 toy, which left no
artifact, is RESULTS.md:79-95's numbers (``JAX_TOY_BF16``).

    python -m diral_tpu_torch.scripts.render_results [--check] [--root DIR]

``--check`` rewrites nothing and exits 1 if any table would change.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
RESULTS_MD = "RESULTS_TORCH.md"


def _pct(x) -> str:
    return f"{x:+.1%}"


def _points(r) -> str:
    return f"{100 * r['prr_improvement']:+.1f}" if r else "--"


def _campaign_stats(imp) -> tuple[float, float]:
    """Mean and std (ddof 1) of a campaign's ΔPRRs, rounded as
    scripts/seed_campaign.py:98-110 writes them."""
    n = len(imp)
    mean = sum(imp) / n
    std = ((sum((x - mean) ** 2 for x in imp) / (n - 1)) ** 0.5
           if n > 1 else 0.0)
    return round(mean, 4), round(std, 4)


def _pop_stats(imp) -> tuple[float, float]:
    """Mean and population std, as scripts/render_results.py:198-200."""
    n = len(imp)
    mean = sum(imp) / n
    return mean, (sum((x - mean) ** 2 for x in imp) / n) ** 0.5


def _band(label: str, b: dict) -> str:
    return (f"{label}: port {b['port_mean']:.4f} ± {b['port_std']:.4f} "
            f"(n={b['port_n']}), JAX {b['jax_mean']:.4f} ± "
            f"{b['jax_std']:.4f} (n={b['jax_n']}); |Δmean| "
            f"{b['abs_diff']:.4f} {'<=' if b['inside'] else '>'} "
            f"{b['limit']:.4f}: **{'inside' if b['inside'] else 'outside'}**")


def _met(flag) -> str:
    return {True: "**met**", False: "**missed**", None: "not comparable"}[
        flag]


class Tables:
    """The tables, read from ``<root>/results``."""

    def __init__(self, root: str):
        self.root = root

    def load(self, name: str):
        with open(os.path.join(self.root, "results", name)) as f:
            return json.load(f)

    def exists(self, name: str) -> bool:
        return os.path.exists(os.path.join(self.root, "results", name))

    def registry(self) -> dict:
        """{table name: renderer}; a band's table is registered once its
        port artifact exists."""
        tables = {
            "toy-seeds": self.toy_seeds,
            "scale-seeds": lambda: self.campaign("torch_scale_seeds5.json",
                                                 "scale_seeds5.json"),
            "serve-seeds": self.serve_seeds,
            "ppo-seeds": self.ppo_seeds,
            "ps-campaign": self.ps_campaign,
        }
        if self.exists("torch_ref_sweep.json"):
            tables["ref-sweep"] = self.ref_sweep
        if self.exists("torch_congested_seeds5.json"):
            tables["congested-seeds"] = lambda: self.campaign(
                "torch_congested_seeds5.json", "congested_seeds5.json")
        if self.exists("torch_dynamic_seeds5.json"):
            tables["dynamic-seeds"] = lambda: self.campaign(
                "torch_dynamic_seeds5.json", "dynamic_seeds5.json")
            tables["dynamic-deciles"] = self.dynamic_deciles
        if self.exists("torch_toy_seeds3to7.json"):
            tables["toy-seeds-8"] = self.toy_seeds_8
        if any(self.exists(port) for port, _, _ in SINGLE_RUNS):
            tables["single-runs"] = self.single_runs
        return tables

    # -- DRQN campaigns: the JAX script's _campaign_table ------------------

    @staticmethod
    def _campaign(rows, jax_rows, checks=None) -> str:
        jax = {r["seed"]: r for r in jax_rows}
        out = ["| seed | final decile sum_r | DRQN PRR | SPS PRR | ΔPRR "
               "| slots/s | JAX ΔPRR |",
               "|---|---|---|---|---|---|---|"]
        for r in rows:
            j = jax.get(r["seed"])
            out.append(
                f"| {r['seed']} | {r['final_decile_sum_reward']:+.2f} "
                f"| {r['drqn_prr']:.3f} | {r['sps_prr']:.3f} "
                f"| {_pct(r['prr_improvement'])} | {r['slots_per_sec']:.0f} "
                f"| {_pct(j['prr_improvement']) if j else '--'} |")
        for who, rs in (("port", rows), ("JAX", jax_rows)):
            imp = [r["prr_improvement"] for r in rs]
            mean, std = _campaign_stats(imp)
            below = sum(x <= 0 for x in imp)
            out.append(
                f"| **{who}: mean ± std (n={len(rs)})** | | | | "
                f"**{_pct(mean)} ± {std:.1%}** (min {_pct(min(imp))}, max "
                f"{_pct(max(imp))}; {below}/{len(rs)} below SPS) | | |")
        if checks:
            out.append("")
            out.append("- " + _band("ΔPRR", checks["prr_improvement"]))
            out.append("- " + _band("SPS PRR", checks["sps_prr"]))
            out.append(f"- below SPS: port {checks['n_below_sps']}, JAX "
                       f"{checks['jax_n_below_sps']}")
        return "\n".join(out)

    def toy_seeds(self) -> str:
        """The port's toy seeds beside JAX's three toy full runs."""
        jax_rows = []
        for seed, name in enumerate(("toy_full_250k.json", "toy_full_s1.json",
                                     "toy_full_s2.json")):
            j = self.load(name)
            comp = j["compare_vs_sps"]
            jax_rows.append({
                "seed": seed,
                "final_decile_sum_reward": j["reward_curve_deciles"][-1],
                "drqn_prr": comp["drqn"]["mean_prr"],
                "sps_prr": comp["sps"]["mean_prr"],
                "prr_improvement": comp["prr_improvement"],
                "slots_per_sec": j["slots_per_sec"]})
        return self._campaign(self.load("torch_toy_seeds3.json")["rows"],
                              jax_rows)

    def campaign(self, port: str, jax: str) -> str:
        d = self.load(port)
        return self._campaign(d["rows"], self.load(jax)["rows"],
                              d.get("checks"))

    def dynamic_deciles(self) -> str:
        """Each seed's learning-curve deciles, the port's above JAX's."""
        jax = {r["seed"]: r for r in self.load("dynamic_seeds5.json")["rows"]}
        out = ["| seed | run | " + " | ".join(f"d{i}" for i in range(1, 11))
               + " |", "|---|---|" + "---|" * 10]
        for r in self.load("torch_dynamic_seeds5.json")["rows"]:
            for who, row in (("port", r), ("JAX", jax.get(r["seed"]))):
                if row:
                    out.append(f"| {r['seed']} | {who} | " + " | ".join(
                        f"{x:+.2f}" for x in row["reward_curve_deciles"])
                        + " |")
        return "\n".join(out)

    # -- the toy at n = 8, with the collapse counts ------------------------

    def toy_seeds_8(self) -> str:
        """The port's eight toy seeds (torch_toy_seeds3.json and
        torch_toy_seeds3to7.json), each classed by collapse, beside JAX's
        8-seed sweep's final reward and class (its ΔPRR is another
        protocol: ``train-sweep`` evaluates on the config's envs, SPS PRR
        0.609); the port's ΔPRR against JAX's three standalone toy runs."""
        rows = (self.load("torch_toy_seeds3.json")["rows"]
                + self.load("torch_toy_seeds3to7.json")["rows"])
        sweep = {r["seed"]: r for r in self.load("seed_sweep_8.json")["rows"]}
        out = ["| seed | final decile sum_r | DRQN PRR | SPS PRR | ΔPRR "
               "| collapse | slots/s | JAX sweep final sum_r | JAX sweep "
               "collapse |", "|---|---|---|---|---|---|---|---|---|"]
        for r in rows:
            j = sweep.get(r["seed"])
            jcls = (collapse(j["final_mean_sum_reward"], j["drqn_prr"])
                    if j else "--")
            out.append(
                f"| {r['seed']} | {r['final_decile_sum_reward']:+.2f} "
                f"| {r['drqn_prr']:.3f} | {r['sps_prr']:.4f} "
                f"| {_pct(r['prr_improvement'])} "
                f"| {collapse(r['final_decile_sum_reward'], r['drqn_prr'])} "
                f"| {r['slots_per_sec']:.0f} "
                + (f"| {j['final_mean_sum_reward']:+.2f} | {jcls} |" if j
                   else "| -- | -- |"))
        port = [collapse(r["final_decile_sum_reward"], r["drqn_prr"])
                for r in rows]
        jax = [collapse(r["final_mean_sum_reward"], r["drqn_prr"])
               for r in sweep.values()]
        toy = [self.load(n)["compare_vs_sps"]["prr_improvement"]
               for n in JAX_TOY_RUNS]
        imp = [r["prr_improvement"] for r in rows]
        sps = sorted({r["sps_prr"] for r in rows})
        learned = [r["final_decile_sum_reward"] > r["reward_curve_deciles"][0]
                   for r in rows]
        (pm, ps), (jm, js) = _pop_stats(imp), _pop_stats(toy)
        out += [
            "",
            f"- collapses: port {port.count('full')} full and "
            f"{port.count('partial')} partial of {len(rows)}; JAX's sweep "
            f"{jax.count('full')} full and {jax.count('partial')} partial "
            f"of {len(jax)} (full: final decile <= {FULL_COLLAPSE} or eval "
            f"PRR 1.000; partial: final decile <= {PARTIAL_COLLAPSE})",
            f"- ΔPRR: port {_pct(pm)} ± {ps:.1%} (n={len(imp)}, population "
            f"std), JAX's standalone toy runs {_pct(jm)} ± {js:.1%} "
            f"(n={len(toy)})",
            f"- SPS PRR {TOY_SPS_PRR} in every row: "
            f"{_met(sps == [TOY_SPS_PRR])} ({sps})",
            f"- final decile above the first: {sum(learned)}/{len(learned)} "
            f"{_met(all(learned))}"]
        return "\n".join(out)

    # -- the single runs: toy and 100v/50r in bfloat16, the MLP toy --------

    def single_runs(self) -> str:
        out = ["| run | deciles 1 → 8 | final decile | DRQN PRR | SPS PRR "
               "| ΔPRR | slots/s | K1-K4 launches (train) "
               "| JAX deciles 1 → 8 | JAX final decile | JAX DRQN PRR "
               "| JAX ΔPRR |",
               "|---|---|---|---|---|---|---|---|---|---|---|---|"]
        for port, jax, label in SINGLE_RUNS:
            if not self.exists(port):
                continue
            r, j = self.load(port), self._jax_run(jax)
            c, d = r["compare_vs_sps"], r["reward_curve_deciles"]
            lstm = sum(r["launches"]["train"][k]
                       for k in ("K1", "K2", "K3", "K4"))
            jd = j["reward_curve_deciles"]
            jfinal = f"{jd[-1]:+.2f}" if len(jd) == 10 else "--"
            out.append(
                f"| {label} | {d[0]:+.2f} → {d[7]:+.2f} | {d[-1]:+.2f} "
                f"| {c['drqn']['mean_prr']:.3f} | {c['sps']['mean_prr']:.3f} "
                f"| {_pct(c['prr_improvement'])} | {r['slots_per_sec']:.0f} "
                f"| {lstm} | {jd[0]:+.2f} → {jd[7]:+.2f} | {jfinal} "
                f"| {j['compare_vs_sps']['drqn']['mean_prr']:.3f} "
                f"| {_pct(j['compare_vs_sps']['prr_improvement'])} |")
        return "\n".join(out)

    def _jax_run(self, jax):
        """A JAX full run: its artifact, or (the bf16 toy, which has
        none) RESULTS.md's numbers."""
        return self.load(jax) if isinstance(jax, str) else jax

    # -- online serving: _serve_seeds_table ------------------------------

    def serve_seeds(self) -> str:
        d = self.load("torch_serve_compare_seeds6.json")
        jd = self.load("serve_compare_seeds3.json")
        jax = {r["seed"]: r for r in jd["rows"]}
        out = ["| seed | DRQN tail PRR | SPS tail PRR | Δ (points) "
               "| JAX Δ (points) |",
               "|---|---|---|---|---|"]
        for r in d["rows"]:
            out.append(
                f"| {r['seed']} | {r['drqn']['mean_prr_tail']:.3f} "
                f"| {r['sps']['mean_prr_tail']:.3f} | {_points(r)} "
                f"| {_points(jax.get(r['seed']))} |")
        for who, a in (("port", d), ("JAX", jd)):
            out.append(
                f"| **{who}: mean ± std (n={len(a['rows'])})** | | | "
                f"**{100 * a['prr_improvement_mean']:+.1f} ± "
                f"{100 * a['prr_improvement_std']:.1f}** "
                f"({a['n_below_sps']}/{len(a['rows'])} below SPS) | |")
        return "\n".join(out)

    # -- PPO: _ppo_seeds_table -------------------------------------------

    def ppo_seeds(self) -> str:
        d = self.load("torch_ppo_seeds5.json")
        jax_runs = self.load("ppo_seeds.json")["runs"]
        jax = {r["seed"]: r["compare_vs_sps"] for r in jax_runs}
        out = ["| seed | sum_r first/last 100 ep | PPO PRR | SPS PRR | ΔPRR "
               "| slots/s | JAX ΔPRR |",
               "|---|---|---|---|---|---|---|"]
        for r in d["runs"]:
            comp = r["compare_vs_sps"]
            j = jax.get(r["seed"])
            out.append(
                f"| {r['seed']} | {r['sum_r_first100']:+.2f} → "
                f"{r['sum_r_last100']:+.2f} | {comp['ppo']['mean_prr']:.3f} "
                f"| {comp['sps']['mean_prr']:.3f} "
                f"| {_pct(comp['prr_improvement'])} "
                f"| {r['slots_per_sec']:.0f} "
                f"| {_pct(j['prr_improvement']) if j else '--'} |")
        for who, runs in (("port", d["runs"]), ("JAX", jax_runs)):
            deltas = [r["compare_vs_sps"]["prr_improvement"] for r in runs]
            mean, std = _pop_stats(deltas)
            below = sum(1 for x in deltas if x < 0)
            out.append(
                f"| **{who}: mean ± std (n={len(deltas)})** | | | | "
                f"**{_pct(mean)} ± {std:.1%}** ({below}/{len(deltas)} below "
                f"SPS) | | |")
        c = d.get("checks")
        if c:
            rising = c["sum_r_rising"]
            out += ["", "- " + _band("ΔPRR", c["prr_improvement"]),
                    "- " + _band("SPS PRR", c["sps_prr"]),
                    f"- below SPS: port {c['n_below_sps']}, JAX "
                    f"{c['jax_n_below_sps']}",
                    f"- sum_r rising first → last 100 episodes: "
                    f"{sum(rising)}/{len(rising)}"]
        return "\n".join(out)

    # -- PS-DQN / PS-DRQN: _ps_campaign_table ------------------------------

    def ps_campaign(self) -> str:
        d = self.load("torch_ps_campaign.json")
        jax = {(r["algo"], r["seed"]): r["compare_vs_sps"]
               for r in self.load("ps_campaign.json")["runs"]}
        out = ["| algo | seed | final decile sum_r | PRR | SPS PRR | ΔPRR "
               "| slots/s | JAX ΔPRR |",
               "|---|---|---|---|---|---|---|---|"]
        for r in d["runs"]:
            comp = r["compare_vs_sps"]
            own = comp[r["algo"].replace("-", "_")]
            j = jax.get((r["algo"], r["seed"]))
            out.append(
                f"| {r['algo']} | {r['seed']} "
                f"| {r['final_decile_sum_r']:+.2f} | {own['mean_prr']:.3f} "
                f"| {comp['sps']['mean_prr']:.3f} "
                f"| {_pct(comp['prr_improvement'])} "
                f"| {r['slots_per_sec']:.0f} "
                f"| {_pct(j['prr_improvement']) if j else '--'} |")
        checks = d.get("checks") or {}
        if checks:
            out.append("")
        for algo, c in checks.items():
            out += [f"- {algo}: " + _band("ΔPRR", c["prr_improvement"]),
                    f"- {algo}: " + _band("SPS PRR", c["sps_prr"]),
                    f"- {algo}: above SPS port {c['n_positive']}, JAX "
                    f"{c['jax_n_positive']}; collapses port "
                    f"{c['n_collapse']}, JAX {c['jax_n_collapse']} "
                    f"(reported, not held)"]
        return "\n".join(out)

    # -- the reference suite: _ref_sweep_table -----------------------------

    def ref_sweep(self) -> str:
        d = self.load("torch_ref_sweep.json")
        jax = {r["config"]: r for r in self.load("ref_sweep.json")}
        out = ["| config | γ | bins | final sum_r | DRQN PRR | SPS PRR "
               "| ΔPRR | slots/s | JAX DRQN PRR | JAX ΔPRR |",
               "|---|---|---|---|---|---|---|---|---|---|"]

        def star(r):
            return "*" if r["drqn_prr"] >= 0.999 else ""
        for r in d["rows"]:
            name = r["config"].replace("r2_", "").replace("_mg_o_index", "")
            j = jax.get(r["config"])
            out.append(
                f"| {name} | {r['gamma']} | {r['num_bins']} "
                f"| {r['final_mean_sum_reward']:+.2f} "
                f"| {r['drqn_prr']:.3f}{star(r)} | {r['sps_prr']:.3f} "
                f"| {_pct(r['prr_improvement'])}{star(r)} "
                f"| {r['slots_per_sec']:.0f} "
                + (f"| {j['drqn_prr']:.3f}{star(j)} "
                   f"| {_pct(j['prr_improvement'])}{star(j)} |" if j else
                   "| -- | -- |"))
        c = d.get("checks")
        if c:
            det = c["determinism"]
            out += ["", f"- SPS PRRs equal: {_met(c['sps_equal']['met'])} "
                        f"({sorted(set(c['sps_equal']['values']))})",
                    f"- b20_dis_07 equal to the toy seed 0 run in "
                    f"{', '.join(det.get('fields', ()))}: "
                    f"{_met(det['met'])}"]
            if "band" in c:
                b = c["band"]
                worst = max((h["abs_diff"] for h in b["rows"].values()),
                            default=0.0)
                out.append(
                    f"- band, {len(b['rows'])} rows whose JAX evaluation "
                    f"did not collapse: largest |ΔPRR_port - ΔPRR_jax| "
                    f"{worst:.4f} against {b['limit']:.4f} (3 sqrt(s_jax^2 + "
                    f"s_port^2), s_jax {b['s_jax']:.5f}, s_port "
                    f"{b['s_port']:.5f}): {_met(b['met'])}")
            learned = c["learning"]["rows"]
            out.append(f"- final sum_r above the first decile: "
                       f"{sum(learned.values())}/{len(learned)} "
                       f"{_met(c['learning']['met'])}")
        return "\n".join(out)


# the toy's collapse classes (RESULTS.md:161-168): a full collapse ends on
# the all-same-channel equilibrium (sum reward -16, or an eval PRR of 1.000
# from a fixed assignment); a partial one halfway there
FULL_COLLAPSE, PARTIAL_COLLAPSE = -15.0, -8.0
TOY_SPS_PRR = 0.6437   # the port's toy SPS PRR (500 steps x 16 envs, seeded 1)
JAX_TOY_RUNS = ("toy_full_250k.json", "toy_full_s1.json", "toy_full_s2.json")


def collapse(final: float, prr: float) -> str:
    if final <= FULL_COLLAPSE or prr >= 0.9995:
        return "full"
    return "partial" if final <= PARTIAL_COLLAPSE else "none"


# JAX's bf16 flagship has no artifact: RESULTS.md:79-95 gives its deciles
# 1-8 (-4.85 to -1.01) and its eval (PRR 0.684 against SPS's 0.640,
# +6.8%); the last two deciles collapsed, their values unpublished
JAX_TOY_BF16 = {"reward_curve_deciles": [-4.85] + [float("nan")] * 6
                + [-1.01],
                "compare_vs_sps": {"drqn": {"mean_prr": 0.684},
                                   "sps": {"mean_prr": 0.640},
                                   "prr_improvement": 0.068}}
# (the port's artifact, the JAX artifact or numbers, the row label)
SINGLE_RUNS = (
    ("torch_toy_bf16_250k.json", JAX_TOY_BF16, "toy_4ue_3r, bfloat16"),
    ("torch_scale_bf16_100k.json", "scale_full_100k_bf16.json",
     "scale_100v_50r, bfloat16"),
    ("torch_toy_mlp_window_250k.json", "toy_mlp_250k.json",
     "toy_4ue_3r_mlp"),
)

_BLOCK = re.compile(
    r"(<!-- begin:table-([a-z0-9-]+) -->)\n.*?(<!-- end:table-\2 -->)",
    re.DOTALL,
)


def render(text: str, tables, where: str) -> str:
    """``text`` with every marked table rewritten (render_results.py:
    235-256): a marker without a table, or a table without markers,
    raises."""
    seen = set()

    def sub(m):
        name = m.group(2)
        if name not in tables:
            raise KeyError(f"{where} references unknown table {name!r}")
        seen.add(name)
        return m.group(1) + "\n" + tables[name]() + "\n" + m.group(3)

    out = _BLOCK.sub(sub, text)
    missing = set(tables) - seen
    if missing:
        raise KeyError(f"{where} is missing markers for: {sorted(missing)}")
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m diral_tpu_torch.scripts.render_results",
        description="Rewrite RESULTS_TORCH.md's tables from results/.")
    p.add_argument("--check", action="store_true",
                   help="rewrite nothing; exit 1 if a table would change")
    p.add_argument("--root", default=ROOT,
                   help="the checkout holding RESULTS_TORCH.md and results/")
    args = p.parse_args(argv)
    path = os.path.join(args.root, RESULTS_MD)
    with open(path) as f:
        text = f.read()
    new = render(text, Tables(args.root).registry(), RESULTS_MD)
    if args.check:
        if new != text:
            print(f"{RESULTS_MD} tables are stale; run python -m "
                  f"diral_tpu_torch.scripts.render_results", file=sys.stderr)
            return 1
        print(f"{RESULTS_MD} tables match results/*.json")
    elif new != text:
        with open(path, "w") as f:
            f.write(new)
        print(f"{RESULTS_MD} tables regenerated")
    else:
        print(f"{RESULTS_MD} tables already current")
    return 0


if __name__ == "__main__":
    sys.exit(main())
