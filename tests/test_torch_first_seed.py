"""``seed_campaign --first-seed K`` on the CPU, at a cut toy schedule
(tests/test_torch_campaign.py's, shorter): seeds K..K+S-1 give the rows
those seeds have in a campaign from seed 0, and the artifact's ``seeds``
lists them."""

import os

import pytest
import torch
import yaml

from diral_tpu_torch.scripts import seed_campaign

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
EVAL = ["--eval-steps", "10", "--eval-envs", "2", "--device", "cpu"]


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small ops only; beside the suite's other workers torch's intra-op
    threads would only contend for the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cut_yaml(tmp_path_factory):
    raw = yaml.safe_load(open(os.path.join(ROOT, "configs",
                                           "toy_4ue_3r.yaml")))
    raw.update(time_slots=60, episode_interval=5, memory_size=64,
               pretrain_length=1, explore=10, greedy=40, training_stop=50)
    raw["RLAgent"].update(batch_size=8)
    raw["RLAgent"]["network"]["layers"] = {1: 16, 2: 16}
    path = tmp_path_factory.mktemp("cfg") / "cut.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def _run(cut_yaml, root, *extra):
    return seed_campaign.main([cut_yaml, str(root / "out.json"),
                               "--workdir", str(root / "wd"), *EVAL, *extra])


def _results_of(rows):
    return [{k: v for k, v in r.items() if k not in seed_campaign.RUN_FIELDS}
            for r in rows]


def test_first_seed_rows_equal_the_full_campaign(cut_yaml, tmp_path):
    full = _run(cut_yaml, tmp_path / "all", "--seeds", "3")
    part = _run(cut_yaml, tmp_path / "part", "--seeds", "2",
                "--first-seed", "1")
    assert full["seeds"] == 3                 # JAX's count from seed 0
    assert part["seeds"] == [1, 2]
    assert [r["seed"] for r in part["rows"]] == [1, 2]
    assert _results_of(part["rows"]) == _results_of(full["rows"][1:])
    assert sorted(os.listdir(tmp_path / "part" / "wd")) == ["seed1", "seed2"]
    # the statistics are the listed seeds' own
    stats = seed_campaign.campaign_stats(full["rows"][1:])
    assert {k: part[k] for k in stats} == stats
