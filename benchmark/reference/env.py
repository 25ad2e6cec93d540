"""Plain float32 reference of the V2V environment, for the configurations
the benchmark runs: the channel step (``my_step_ch``) with reward designs
2-4, the collision step of the warmup slot (``my_step``), mobility with
per-episode velocity kicks, and the state vector of a one-hot previous
action and the type-2 piggybacked position histogram.

A frozen copy of the canonical plain path of the PyTorch port
(envs/v2v_env.py and ops/channel_phase.py, distance.py, histogram.py as
they stood when the benchmark was written), cut to those configurations.
It imports nothing of the program; ``check_supported`` refuses a
configuration it does not cover.  The histogram is ``np.histogram``'s:
membership against the exact ``np.linspace`` edges.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
import torch

NO_TX_DIST = 100000.0
STALENESS_CUTOFF = 20


def check_supported(cfg) -> None:
    """Raise unless ``cfg`` (the program's ExperimentConfig, read as plain
    data) is one this reference covers."""
    env, st = cfg.env, cfg.env.state
    bad = [name for name, on in (
        ("piggybacking", st.piggybacking),
        ("add_channel_obs", st.add_channel_obs),
        ("add_reward", st.add_reward), ("add_index", st.add_index),
        ("add_velocity", st.add_velocity), ("add_position", st.add_position),
        ("add_positional_dist", st.add_positional_dist),
        ("enable_fingerprint", env.enable_fingerprint),
        ("proportional_fair", env.proportional_fair),
        ("congestion_test", env.congestion_test),
        ("load_positions", env.load_positions),
        ("enable_design_topology", env.enable_design_topology),
        ("ia_averaging", cfg.ia_averaging),
        ("ia_penalty_enable", cfg.ia_penalty_enable),
        ("hysteretic", cfg.agent.hysteretic),
        ("use_dueling", cfg.agent.network.use_dueling),
    ) if on]
    if not (st.add_action and st.action_index == "binary"):
        bad.append("action_index != binary")
    if not (st.add_positional_dist_piggy and st.add_positional_dist_type == 2):
        bad.append("positional histogram != type 2")
    if not (cfg.enable_channel and env.reward_design in (2, 3, 4)):
        bad.append("channel step with reward design 2-4")
    if not (cfg.agent.network.use_lstm_input and cfg.agent.network.use_double
            and cfg.train_after_episode and cfg.agent.policy == "eps_greedy"):
        bad.append("DRQN, Double-DQN, eps-greedy, per-episode training")
    if len(cfg.agent.network.layers) != 2:
        bad.append("two layers")
    if bad:
        raise ValueError(f"the reference does not cover: {', '.join(bad)}")


def state_dim(cfg) -> int:
    return cfg.env.num_channels + cfg.env.state.num_bins


def padded_dim(d: int) -> int:
    return (d + 2 + 15) // 16 * 16


def sqrt(x):
    """Correctly rounded square root (torch's CPU kernel is one ULP off on
    some inputs; NumPy's and CUDA's are exact)."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.detach().numpy()))
    return torch.sqrt(x)


@dataclass
class Env:
    pos_x: torch.Tensor         # [B, N]
    pos_y: torch.Tensor
    vel: torch.Tensor
    direction: torch.Tensor
    table_x: torch.Tensor       # [B, N, N]
    table_y: torch.Tensor
    table_seq: torch.Tensor     # int32
    table_age: torch.Tensor     # int32
    last_arrival: torch.Tensor  # int32 [tx, rx], -1 = never

    def replace(self, **kw) -> "Env":
        return dataclasses.replace(self, **kw)

    def rows(self, idx) -> "Env":
        return Env(**{f.name: getattr(self, f.name)[idx]
                      for f in dataclasses.fields(self)})


def blank(num_users: int, pos_x, pos_y, vel, direction) -> Env:
    b, n = pos_x.shape
    dev, dt = pos_x.device, pos_x.dtype
    i32 = torch.int32
    return Env(pos_x=pos_x.clone(), pos_y=pos_y.clone(), vel=vel.clone(),
               direction=direction.clone(),
               table_x=torch.zeros((b, n, n), dtype=dt, device=dev),
               table_y=torch.zeros((b, n, n), dtype=dt, device=dev),
               table_seq=torch.zeros((b, n, n), dtype=i32, device=dev),
               table_age=torch.zeros((b, n, n), dtype=i32, device=dev),
               last_arrival=torch.full((b, n, n), -1, dtype=i32, device=dev))


def _eye(n, device):
    return torch.eye(n, dtype=torch.bool, device=device)


def distances(pos_x, pos_y):
    dx = pos_x[..., :, None] - pos_x[..., None, :]
    dy = pos_y[..., :, None] - pos_y[..., None, :]
    return sqrt(dx * dx + dy * dy)


def periodic_update(s: Env) -> Env:
    """Every vehicle refreshes its own table entry; the others age."""
    eye = _eye(s.table_x.shape[-1], s.table_x.device)
    return s.replace(
        table_x=torch.where(eye, s.pos_x[:, :, None], s.table_x),
        table_y=torch.where(eye, s.pos_y[:, :, None], s.table_y),
        table_seq=s.table_seq + eye.to(s.table_seq.dtype),
        table_age=torch.where(eye, torch.zeros_like(s.table_age),
                              s.table_age + 1))


def closest_tx(D, txm, comm_range):
    """Per receiver, the nearest in-range transmitter (first on ties)."""
    no_tx = torch.full((), NO_TX_DIST, dtype=D.dtype, device=D.device)
    cand = torch.where(txm[:, None, :] & (D < comm_range), D, no_tx)
    dist = cand.amin(dim=-1)
    return dist, cand.argmin(dim=-1), dist < NO_TX_DIST


def merge_rows(s: Env, rx_mask, tx_ids) -> Env:
    """Receivers in ``rx_mask`` take row ``tx_ids`` of the live tables
    where its sequence number is strictly newer."""
    n = s.table_seq.shape[-1]
    idx = tx_ids[:, :, None].expand(-1, -1, n)
    src_seq = torch.gather(s.table_seq, 1, idx)
    newer = (src_seq > s.table_seq) & rx_mask[:, :, None]
    return s.replace(
        table_x=torch.where(newer, torch.gather(s.table_x, 1, idx),
                            s.table_x),
        table_y=torch.where(newer, torch.gather(s.table_y, 1, idx),
                            s.table_y),
        table_seq=torch.where(newer, src_seq, s.table_seq),
        table_age=torch.where(newer, torch.zeros_like(s.table_age),
                              s.table_age))


def _mod(x, m: float):
    r = torch.fmod(x, m)
    return torch.where((r != 0) & ((r < 0) != (m < 0)), r + m, r)


def advance(cfg, s: Env) -> Env:
    if not cfg.env.mobility:
        return s
    L = float(cfg.env.highway_length)
    return s.replace(pos_x=_mod(s.pos_x + s.direction * s.vel + L, L))


def kick(cfg, s: Env, kicks) -> Env:
    """Velocity kicks: +0.55 on 1, -0.55 on 2, clamped to [1.1, 2.77]."""
    if not cfg.env.mobility_vary:
        return s
    v = s.vel
    new = torch.where(kicks == 1, torch.clamp(v + 0.55, max=2.77), v)
    new = torch.where(kicks == 2, torch.clamp(v - 0.55, min=1.1), new)
    return s.replace(vel=new)


def _collision_reward(design, comm_range, D, txm, tot, dtype):
    tot_f = tot.to(dtype)
    pair = txm[:, :, None] & txm[:, None, :]
    sum_d = torch.where(pair, D, torch.zeros((), dtype=dtype,
                                             device=D.device)).sum((1, 2)) / 2
    m = sum_d / (tot * (tot - 1) // 2).to(dtype)
    w = (m > comm_range).to(dtype)
    if design == 1:
        return -(1.0 - w / tot_f)
    if design == 2:
        return torch.where(tot == 2, 2.0 * w - tot_f, -tot_f)
    if design == 3:
        return -torch.exp(1.0 - 1.0 / tot_f)
    if design == 4:
        return 1.0 / tot_f
    if design == 5:
        return torch.where((tot == 2) & (w == 1.0), torch.zeros_like(w),
                           -torch.ones_like(w))
    raise ValueError(f"reward design {design}")


def step_collision(cfg, s: Env, actions, t) -> tuple[Env, torch.Tensor]:
    """The warmup slot's collision step: rewards shared among colliders,
    merges from the closest transmitter, then mobility -> (env, rewards)."""
    c = cfg.env.num_channels
    R = cfg.env.communication_range
    s = periodic_update(s)
    b, n = s.pos_x.shape
    dtype, dev = s.pos_x.dtype, s.pos_x.device
    D = distances(s.pos_x, s.pos_y)
    one = torch.ones((), dtype=dtype, device=dev)
    la = s.last_arrival
    rews = torch.zeros((b, n), dtype=dtype, device=dev)
    for ch in range(c):
        txm = actions == ch
        tot = txm.sum(dim=1)
        invoked = ~txm & (tot > 0)[:, None]
        r_ch = _collision_reward(cfg.env.reward_design, R, D, txm, tot,
                                 dtype)
        _, cid, has = closest_tx(D, txm, R)
        rews = torch.where(txm, torch.where(tot > 1, r_ch, one)[:, None],
                           rews)
        oor = txm[:, :, None] & invoked[:, None, :] & (D >= R)
        la = torch.where(oor, torch.full_like(la, -1), la)
        s = merge_rows(s, invoked & has, cid)
    s = s.replace(last_arrival=la)
    return advance(cfg, s), rews


def step_channel(cfg, s: Env, actions, t) -> tuple[Env, torch.Tensor]:
    """The PRR channel step: a transmitter's reward is the share of its
    in-range receivers whose nearest transmitter it is; receivers merge
    the tables of the transmitter they decode -> (env, rewards)."""
    c = cfg.env.num_channels
    R = float(cfg.env.communication_range)
    design = cfg.env.reward_design
    s = periodic_update(s)
    b, n = s.pos_x.shape
    dtype, dev = s.pos_x.dtype, s.pos_x.device
    D = distances(s.pos_x, s.pos_y)
    ids = torch.arange(n, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)
    r_solo = torch.full((), math.e if design == 4 else 1.0, dtype=dtype,
                        device=dev)
    la = s.last_arrival
    rews = torch.zeros((b, n), dtype=dtype, device=dev)
    for ch in range(c):
        txm = actions == ch
        tot = txm.sum(dim=1)
        invoked = ~txm & (tot > 0)[:, None]
        _, cid, has = closest_tx(D, txm, R)
        aud = txm[:, :, None] & (~txm)[:, None, :] & (D < R)
        in_range = aud.sum(dim=2)
        mine = cid[:, None, :] == ids[None, :, None]
        received = (aud & has[:, None, :] & mine).sum(dim=2)
        prr = torch.where(in_range > 0,
                          received.to(dtype) / in_range.to(dtype), one)
        if design == 3:
            r_coll = 1.0 - torch.exp(1.0 - prr)
        elif design == 4:
            r_coll = -torch.exp(1.0 - prr)
        else:
            r_coll = -(1.0 - prr)
        rews = torch.where(txm, torch.where((tot > 1)[:, None], r_coll,
                                            r_solo), rews)
        oor = txm[:, :, None] & invoked[:, None, :] & (D >= R)
        la = torch.where(oor, torch.full_like(la, -1), la)
        accepted = invoked & has
        la = torch.where(accepted[:, None, :] & mine,
                         torch.full_like(la, int(t)), la)
        s = merge_rows(s, accepted, cid)
    s = s.replace(last_arrival=la)
    return advance(cfg, s), rews


def piggy_histogram(cfg, s: Env):
    """Count histogram of the fresh in-range neighbours' signed distances
    over [-bin_range, bin_range], divided by their number. [B, N, bins]."""
    bins, rng = cfg.env.state.num_bins, float(cfg.env.bin_range)
    dx = s.table_x - s.pos_x[:, :, None]
    dy = s.table_y - s.pos_y[:, :, None]
    d = sqrt(dx * dx + dy * dy)
    one = torch.ones((), dtype=d.dtype, device=d.device)
    signed = d * torch.where(dx > 0.0, one, -one)
    valid = ((s.table_age < STALENESS_CUTOFF) & ~_eye(d.shape[-1], d.device)
             & (d < rng))
    np_dt = np.float32 if d.dtype == torch.float32 else np.float64
    edges = torch.as_tensor(np.linspace(-rng, rng, bins + 1, dtype=np_dt),
                            device=d.device)
    v = signed[..., None]
    last = torch.arange(bins, device=d.device) == bins - 1
    below = torch.where(last, v <= edges[1:], v < edges[1:])
    member = (v >= edges[:-1]) & below & valid[..., None]
    hist = member.to(d.dtype).sum(dim=-2)
    cnt = valid.sum(dim=-1).to(d.dtype)
    safe = torch.where(cnt > 0, cnt, torch.ones_like(cnt))
    return torch.where(cnt[..., None] > 0, hist / safe[..., None],
                       torch.zeros_like(hist))


def obtain_state(cfg, s: Env, actions):
    """[B, N, C + bins]: the one-hot action, then the histogram."""
    c = cfg.env.num_channels
    onehot = (actions.long()[..., None]
              == torch.arange(c, device=actions.device)).to(s.pos_x.dtype)
    return torch.cat([onehot, piggy_histogram(cfg, s)], dim=-1)
