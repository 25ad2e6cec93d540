"""Evaluation: PRR / collision metrics and the DIRAL-vs-SPS comparison
(diral_tpu/train/evaluate.py; the reference's headline claim is +20% PRR
over SPS in the congested scenario, README.md:5).

This is the serving path of the port: every vehicle runs the shared
LSTM Q-net on its own history window and takes the greedy channel, slot
after slot, for B envs at once.

Metrics:

* ``prr_per_user`` -- the my_step_ch PRR definition (test_env.py:384-404);
* reference-style collision count ``num_channels - sum_reward``
  (main_test.py:178), plus a direct count of colliding users.

Entry points run on the CUDA device unless ``device="cpu"`` is passed; a
missing GPU raises (device.resolve_device).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from diral_tpu_torch.agents import policies as pol
from diral_tpu_torch.agents.sps import sps_init, sps_step, toy_rssi
from diral_tpu_torch.config import EnvConfig, ExperimentConfig
from diral_tpu_torch.device import resolve_device
from diral_tpu_torch.envs import v2v_env as E
from diral_tpu_torch.models import qnets
from diral_tpu_torch.ops.distance import pairwise_distances


def prr_per_user(cfg: EnvConfig, state: E.EnvState, actions):
    """[B, N] packet-reception ratio of each transmitter this slot.

    Receiver r decodes transmitter u iff u is the nearest in-range
    transmitter on u's channel (test_env.py:398-399); u's audience is
    every in-range vehicle not transmitting on u's channel
    (test_env.py:392-397).  All channels at once: the nearest transmitter
    of each (channel, receiver) is gathered back per transmitter."""
    n, c = cfg.num_users, cfg.num_channels
    R = cfg.communication_range
    D = pairwise_distances(state.pos_x, state.pos_y)
    actions = actions.long()
    eye = torch.eye(n, dtype=torch.bool, device=D.device)
    same_ch = actions[:, :, None] == actions[:, None, :]          # [B, tx, rx]
    audience = ~eye & ~same_ch & (D < R)
    in_range = audience.sum(dim=2).to(D.dtype)

    inf = torch.full((), torch.inf, dtype=D.dtype, device=D.device)
    dist_tr = torch.where(~eye & (D < R), D, inf)                 # [B, tx, rx]
    on_ch = F.one_hot(actions, c).bool().transpose(1, 2)          # [B, C, tx]
    m = torch.where(on_ch[..., None], dist_tr[:, None], inf)      # [B, C, tx, rx]
    near_tx = m.argmin(dim=2)                                     # [B, C, rx]
    has = torch.isfinite(m.amin(dim=2))
    own = actions[:, :, None].expand(-1, -1, n)                   # [B, tx, rx]
    near_own = torch.gather(near_tx, 1, own)
    has_own = torch.gather(has, 1, own)
    ids = torch.arange(n, device=D.device)
    credit = (near_own == ids[None, :, None]) & has_own
    received = (credit & audience).sum(dim=2).to(D.dtype)
    return torch.where(in_range > 0,
                       received / torch.clamp(in_range, min=1),
                       torch.ones_like(in_range))


def _rollout_metrics(cfg: ExperimentConfig, act_fn, carry_init, steps: int):
    """Greedy-rollout metric collector over one batch of envs.

    carry_init = (env_state, history [B, T, N, D], actor_carry,
    generator); act_fn(actor_carry, env_state, history, generator, t) ->
    (actions [B, N], actor_carry')  (evaluate.py:58-100)."""
    env_cfg = cfg.env
    c = env_cfg.num_channels
    step_env = E.step_channel if cfg.enable_channel else E.step_collision
    env_state, history, actor, gen = carry_init
    logs = []
    for t in range(steps):
        actions, actor = act_fn(actor, env_state, history, gen, t)
        prr = prr_per_user(env_cfg, env_state, actions)  # vs current positions
        env_state, obs, rew = step_env(env_cfg, env_state, actions, t)
        sv = E.obtain_state(env_cfg, env_state, obs, actions, rew)
        history = torch.cat([history[:, 1:], sv[:, None].to(history.dtype)],
                            dim=1)
        sum_r = rew.sum(dim=1)
        counts = F.one_hot(actions.long(), c).sum(dim=1)          # [B, C]
        colliding = torch.gather(counts > 1, 1, actions.long()).sum(dim=1)
        logs.append(torch.stack([prr.mean(), sum_r.mean(),
                                 (c - sum_r).mean(),
                                 colliding.to(sum_r.dtype).mean()]))
    means = torch.stack(logs).mean(dim=0).tolist()
    return dict(zip(("mean_prr", "mean_sum_reward", "mean_collisions_ref",
                     "mean_colliding_users"), means))


def _start(cfg: ExperimentConfig, generator, dtype, device):
    env_cfg = cfg.env
    B, N = cfg.engine.num_envs, env_cfg.num_users
    T, D = cfg.agent.step_size, env_cfg.state_space
    env_state = E.reset(env_cfg, B, generator, dtype, device)
    history = torch.zeros((B, T, N, D), dtype=dtype, device=device)
    return env_state, history


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def drqn_act_fn(cfg: ExperimentConfig, params):
    """The greedy DRQN actor (evaluate.py:115-118): one Q-forward for all
    B*N agents over their [T, D] history windows."""
    acfg = cfg.agent

    def act(actor, env_state, history, gen, t):
        B, T, N, D = history.shape
        x = history.transpose(1, 2).reshape(B * N, T, D)
        q = qnets.drqn_apply(params, x, acfg).reshape(B, N, -1)
        return pol.greedy_action(q), actor

    return act


@torch.inference_mode()
def evaluate_drqn(cfg: ExperimentConfig, params, seed: int, steps: int = 500,
                  dtype=torch.float32, device=None):
    """Greedy rollout of a DRQN (load_model + greedy eval mode,
    main_test.py:62-65,129-136).  ``params``: a qnets.DRQN on ``device``."""
    dev = resolve_device(device)
    gen = _generator(seed, dev)
    env_state, history = _start(cfg, gen, dtype, dev)
    return _rollout_metrics(cfg, drqn_act_fn(cfg, params),
                            (env_state, history, (), gen), steps)


@torch.inference_mode()
def evaluate_sps(cfg: ExperimentConfig, seed: int, steps: int = 500,
                 rssi_threshold: float = -110.0, dtype=torch.float32,
                 device=None):
    """SPS baseline rollout on the same env family, sensing last slot's
    transmissions through the free-space proxy."""
    dev = resolve_device(device)
    env_cfg = cfg.env
    gen = _generator(seed, dev)
    env_state, history = _start(cfg, gen, dtype, dev)
    sps0 = sps_init(gen, cfg.engine.num_envs, env_cfg.num_users,
                    env_cfg.num_channels, dev)

    def act(actor, env_state, history, g, t):
        sps_state, last = actor
        rssi = toy_rssi(env_cfg, env_state.pos_x, env_state.pos_y, last)
        actions, sps_state = sps_step(g, sps_state, rssi, rssi_threshold)
        return actions, (sps_state, actions)

    return _rollout_metrics(cfg, act, (env_state, history,
                                       (sps0, sps0.prev_action), gen), steps)


def compare_drqn_vs_sps(cfg: ExperimentConfig, params, seed: int,
                        steps: int = 500, dtype=torch.float32, device=None):
    """The paper's comparison: PRR of the DRQN policy vs the SPS baseline
    on the same scenario family (two seeds derived from ``seed``)."""
    dev = resolve_device(device)
    s1, s2 = torch.randint(0, 2 ** 62, (2,),
                           generator=_generator(seed, "cpu")).tolist()
    drqn_m = evaluate_drqn(cfg, params, s1, steps, dtype, dev)
    sps_m = evaluate_sps(cfg, s2, steps, dtype=dtype, device=dev)
    return {
        "drqn": drqn_m,
        "sps": sps_m,
        "prr_improvement": drqn_m["mean_prr"] / max(sps_m["mean_prr"], 1e-9)
        - 1.0,
    }
