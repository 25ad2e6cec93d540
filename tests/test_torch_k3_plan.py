"""K3's reduction plan (ops/lstm_window._reduce_plan), which cuts the T*B
rows of the dW/db reduction into the chunks of the split-K partial pass.

* Over a grid of shapes -- the toy (2048 rows, D = 23), 100v/50r (25,600,
  D = 100) and PPO (96 and 2400, D = 25, H = 128) shapes, and B in {1, 97,
  2047, 25600} x H in {128, 256, 512, 1024} -- the chunks cover [0, T*B)
  exactly once, never cross a step, hold at least min(64, B) rows, keep
  the float32 partials at or under 256 MB, and give a grid of at least 264
  blocks wherever 64-row chunks allow it.  The plan is a function of the
  shape alone: the same for the same shape, whatever card is visible.
* A float32 emulation of the plan -- per chunk A^T @ bf16(dgates) and the
  unrounded column sums, then the S partials summed in order of s, as the
  combine pass does -- built from the plain version's own per-step terms
  is within 1e-3 of the plain dW and db (only the order of sums differs)
  and bit-equal across two evaluations.
"""

import numpy as np
import pytest
import torch

from diral_tpu_torch.ops import lstm_window as K

T = 6
SHAPES = ([(2048, 23, 256), (25600, 100, 256), (96, 25, 128),
           (2400, 25, 128)]
          + [(B, D, H) for B in (1, 97, 2047, 25600)
             for H in (128, 256, 512, 1024) for D in (23, 100)])


def _tiles(Dp, H):
    return -(-(Dp + H) // 128) * (4 * H // 128)


@pytest.mark.parametrize("B,D,H", SHAPES)
def test_reduce_plan_covers_rows_within_limits(B, D, H):
    Dp = K.padded_dim(D)
    plan = K._reduce_plan(B, T, Dp, H)
    chunks = plan.chunks(B)
    assert plan.splits == len(chunks) == T * plan.per_step
    covered = np.zeros(T * B, np.int64)
    for t, r0, r1 in chunks:
        assert 0 <= t < T and 0 <= r0 < r1 <= B   # inside one step
        assert r1 - r0 >= min(64, B)
        covered[t * B + r0:t * B + r1] += 1
    assert (covered == 1).all()
    split_bytes = (Dp + H + 1) * 4 * H * 4   # float32 partials of a split
    assert plan.splits * split_bytes <= 256 << 20
    if T * (B // 64) * _tiles(Dp, H) >= 264:
        assert plan.splits * _tiles(Dp, H) >= 264
    # chunks of ~2048 rows at most, unless the scratch cap forbids it
    if (plan.splits + T) * split_bytes <= 256 << 20:
        assert max(r1 - r0 for _, r0, r1 in chunks) <= 2048


def test_reduce_plan_is_a_function_of_the_shape(monkeypatch):
    first = [K._reduce_plan(B, T, K.padded_dim(D), H) for B, D, H in SHAPES]

    def no_card(*_a, **_k):
        raise AssertionError("the plan asked about the card")

    for name in ("device_count", "get_device_properties", "is_available",
                 "current_device"):
        monkeypatch.setattr(torch.cuda, name, no_card)
    again = [K._reduce_plan(B, T, K.padded_dim(D), H) for B, D, H in SHAPES]
    assert first == again


def test_reduce_plan_refuses_partials_over_the_cap():
    # H = 1024 and a wide window: one chunk per step already needs more
    # than 256 MB of partials
    with pytest.raises(ValueError, match="partials"):
        K._reduce_plan(64, 16, K.padded_dim(1000), 1024)


def _inputs(B, D, H, seed):
    rng = np.random.RandomState(seed)
    lim = np.sqrt(6.0 / (D + 5 * H))
    w = rng.uniform(-lim, lim, (D + H, 4 * H)).astype(np.float32)
    b = rng.normal(0, 0.1, 4 * H).astype(np.float32)
    x2 = K.flatten_window(torch.from_numpy(
        rng.normal(size=(B, T, D)).astype(np.float32))).contiguous()
    g = rng.normal(size=(B, H)).astype(np.float32)
    return x2, torch.from_numpy(w), torch.from_numpy(b), torch.from_numpy(g)


def _emulate(plan, B, terms):
    """dW [Dp+H, 4H] and db of the split-K plan: partials per chunk, then
    summed in order of s (float32 throughout)."""
    by_t = {T - 1 - i: term for i, term in enumerate(terms)}
    parts = []
    for t, r0, r1 in plan.chunks(B):
        x_t, h_t, dg = by_t[t]
        a = torch.cat([x_t, h_t], dim=1)[r0:r1]
        parts.append((a.T @ K._bf(dg[r0:r1]), dg[r0:r1].sum(dim=0)))
    dw, db = parts[0]
    dw, db = dw.clone(), db.clone()
    for pw, pb in parts[1:]:
        dw += pw
        db += pb
    return dw, db


@pytest.mark.parametrize("B,D,H", [(97, 23, 128), (2047, 23, 256),
                                   (2400, 25, 128)])
def test_plan_emulation_matches_plain(B, D, H):
    x2, w, b, g = _inputs(B, D, H, 3)
    Dp = K.padded_dim(D)
    plan = K._reduce_plan(B, T, Dp, H)
    _, terms = K._bwd_plain_terms(x2, w, b, g, T, need_dx=False)
    _, pdw, pdb = K.lstm_window_bwd_plain(x2, w, b, g, T, need_dx=False)
    dw, db = _emulate(plan, B, terms)
    dw = torch.cat([dw[:D], dw[Dp:]], dim=0)
    for got, want in ((dw[:D], pdw[:D]), (dw[D:], pdw[D:]), (db, pdb)):
        assert float((got - want).abs().max()) <= 1e-3 * float(
            want.abs().max())
    dw2, db2 = _emulate(plan, B, terms)
    assert torch.equal(torch.cat([dw2[:D], dw2[Dp:]], dim=0), dw)
    assert torch.equal(db2, db)
