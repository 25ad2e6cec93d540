"""configs/torch_dynamic_20v_15r_kernels.yaml, the dynamic config with the
channel step (K5) and the positional histogram (K6) forced onto their
kernels at N = 20, below the auto gate:

* it is the published configs/dynamic_20v_15r.yaml but for those two
  knobs, loads in the port (``step_impl`` under ``EnvironmentTest`` is the
  port's addition to the schema) and is refused by the JAX package's
  loader, which names the key;
* on the CPU in float32 the forced channel step (K5's plain version)
  equals the env's own channel walk bit for bit over 40 slots, and the
  forced histogram (K6's plain version, a product with the reciprocal of
  the neighbour count, as JAX's Pallas kernel) sits within one float32
  ULP of the env's own division.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from diral_tpu.config import load_config as jload
from diral_tpu_torch.config import load_config as tload
from diral_tpu_torch.envs import v2v_env as E

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
COPY = os.path.join(ROOT, "configs", "torch_dynamic_20v_15r_kernels.yaml")
PUBLISHED = os.path.join(ROOT, "configs", "dynamic_20v_15r.yaml")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_copy_is_the_published_config_with_both_kernels_forced():
    copy, published = tload(COPY), tload(PUBLISHED)
    assert copy.env.step_impl == copy.env.state.hist_impl == "pallas"
    assert published.env.step_impl == published.env.state.hist_impl == \
        "auto"
    back = dataclasses.replace(copy, env=dataclasses.replace(
        copy.env, step_impl="auto", state=dataclasses.replace(
            copy.env.state, hist_impl="auto")))
    assert back == published
    with pytest.raises(KeyError, match="step_impl"):
        jload(COPY)


def test_forced_paths_on_the_cpu():
    auto, forced = tload(PUBLISHED).env, tload(COPY).env
    gen = torch.Generator().manual_seed(0)
    a = E.reset(auto, 4, gen, torch.float32, "cpu")
    b = a
    ulps = []
    for t in range(40):
        act = torch.randint(0, auto.num_channels, (4, auto.num_users),
                            generator=gen).to(torch.int32)
        a, oa, ra = E.step_channel(auto, a, act, t)
        b, ob, rb = E.step_channel(forced, b, act, t)
        for f in dataclasses.fields(a):
            assert torch.equal(getattr(a, f.name), getattr(b, f.name)), f
        assert torch.equal(oa, ob) and torch.equal(ra, rb), t
        ha = E.positional_dist_piggy_type2(auto, a)
        hb = E.positional_dist_piggy_type2(forced, b)
        gap = (hb - ha).abs()
        assert (gap <= torch.finfo(torch.float32).eps * ha.abs()).all(), t
        ulps.append(int((gap > 0).sum()))
    assert sum(ulps) > 0     # the two roundings do meet
