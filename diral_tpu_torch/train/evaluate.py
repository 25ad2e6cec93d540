"""Evaluation: PRR / collision metrics and the DIRAL-vs-SPS comparison
(diral_tpu/train/evaluate.py; the reference's headline claim is +20% PRR
over SPS in the congested scenario, README.md:5).

This is the serving path of the port: every vehicle runs the shared
policy (the DRQN LSTM Q-net on its own history window, the PPO actor at
its mode, or a PS-DQN / PS-DRQN Q-net on its current state) and takes
the greedy channel, slot after slot, for B envs at once.

Metrics:

* ``prr_per_user`` -- the my_step_ch PRR definition (test_env.py:384-404);
* reference-style collision count ``num_channels - sum_reward``
  (main_test.py:178), plus a direct count of colliding users.

Entry points run on the CUDA device unless ``device="cpu"`` is passed; a
missing GPU raises (device.resolve_device).
"""

from __future__ import annotations

import torch

from diral_tpu_torch.agents import policies as pol
from diral_tpu_torch.agents.sps import sps_init, sps_step, toy_rssi
from diral_tpu_torch.config import EnvConfig, ExperimentConfig
from diral_tpu_torch.device import resolve_device
from diral_tpu_torch.envs import v2v_env as E
from diral_tpu_torch.models import actor_critic as ac
from diral_tpu_torch.models import qnets
from diral_tpu_torch.ops.distance import pairwise_distances
from diral_tpu_torch.train.ps_loop import canonical_algo


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
    on_ch = E.one_hot_actions(actions, c).bool().transpose(1, 2)  # [B, C, tx]
    m = torch.where(on_ch[..., None], dist_tr[:, None], inf)  # [B, C, tx, rx]
    near_tx = m.argmin(dim=2)                                     # [B, C, rx]
    has = torch.isfinite(m.amin(dim=2))
    # an id outside [0, C) is on no channel and decodes nowhere
    on_any = ((actions >= 0) & (actions < c))[:, :, None]         # [B, tx, 1]
    own = actions.clamp(0, c - 1)[:, :, None].expand(-1, -1, n)   # [B, tx, rx]
    near_own = torch.gather(near_tx, 1, own)
    has_own = torch.gather(has, 1, own) & on_any
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
        # JAX's bincount drops ids >= C and its gather clamps them to C-1
        counts = E.one_hot_actions(actions, c).sum(dim=1)        # [B, C]
        colliding = torch.gather(counts > 1, 1,
                                 actions.long().clamp(0, c - 1)).sum(dim=1)
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
    B*N agents over their [T, D] history windows.  The feedforward flavor
    (``use_lstm_input: False``) maps each of the T steps to C Q-values, so
    the argmax runs over T * C ids; an id >= C is no transmission in the
    env and in the metrics (``one_hot_actions``), as in the JAX package."""
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


def ppo_act_fn(cfg: ExperimentConfig, params):
    """The greedy PPO actor (evaluate.py:143-149): the policy logits of all
    B*N agents, over their [T, D] history windows (LSTM encoder) or their
    current state (feed-forward), and the argmax."""
    acfg = cfg.agent
    use_lstm = acfg.network.use_lstm_input

    def act(actor, env_state, history, gen, t):
        B, T, N, D = history.shape
        if use_lstm:
            x = history.transpose(1, 2).reshape(B * N, T, D)
        else:
            x = history[:, -1].reshape(B * N, D)
        logits = ac.ppo_policy_logits(params, x, acfg)
        return torch.argmax(logits, dim=-1).reshape(B, N), actor

    return act


def ps_act_fn(cfg: ExperimentConfig, params, algo: str, dtype, device):
    """(act, actor0): the greedy PS-DQN / PS-DRQN actor (evaluate.py:
    174-184) on the current state of all B*N agents, and its first carry
    -- zeros of the GRU hidden for PS-DRQN, nothing for PS-DQN."""
    acfg = cfg.agent
    recurrent = canonical_algo(algo) == "ps-drqn"
    M = cfg.engine.num_envs * cfg.env.num_users

    def act(actor, env_state, history, gen, t):
        B, _, N, D = history.shape
        obs = history[:, -1].reshape(B * N, D)
        if recurrent:
            q, actor = qnets.ps_drqn_apply_step(params, obs, actor, acfg)
        else:
            q = qnets.ps_dqn_apply(params, obs, acfg)
        return torch.argmax(q, dim=1).reshape(B, N), actor

    actor0 = (torch.zeros((M, qnets.ps_drqn_hidden_size(params)),
                          dtype=dtype, device=device) if recurrent else ())
    return act, actor0


@torch.inference_mode()
def evaluate_ppo(cfg: ExperimentConfig, params, seed: int, steps: int = 500,
                 dtype=torch.float32, device=None):
    """Greedy (argmax-logit) rollout of a PS-PPO actor (evaluate.py:
    124-152): the stochastic policy at its mode, the DRQN comparisons'
    greedy band (main_test.py:129-136).  ``params``: the actor-critic
    (models/actor_critic.ppo_init) on ``device``."""
    dev = resolve_device(device)
    gen = _generator(seed, dev)
    env_state, history = _start(cfg, gen, dtype, dev)
    return _rollout_metrics(cfg, ppo_act_fn(cfg, params),
                            (env_state, history, (), gen), steps)


@torch.inference_mode()
def evaluate_ps(cfg: ExperimentConfig, params, seed: int, steps: int = 500,
                algo: str = "ps-dqn", dtype=torch.float32, device=None):
    """Greedy rollout of a PS-DQN / PS-DRQN Q-net (evaluate.py:155-186).
    PS agents act on the CURRENT state (ps_dqn.py:200-235); PS-DRQN carries
    the per-agent GRU hidden across slots from zeros (ps_drqn.py:195-231).
    An unknown ``algo`` raises ValueError."""
    dev = resolve_device(device)
    act, actor0 = ps_act_fn(cfg, params, algo, dtype, dev)
    gen = _generator(seed, dev)
    env_state, history = _start(cfg, gen, dtype, dev)
    return _rollout_metrics(cfg, act, (env_state, history, actor0, gen),
                            steps)


def _versus_sps(cfg, label, evaluate_policy, seed, steps, dtype, device):
    """{label: policy metrics, "sps": SPS metrics, "prr_improvement"}, the
    two rollouts seeded from ``seed``."""
    dev = resolve_device(device)
    s1, s2 = torch.randint(0, 2 ** 62, (2,),
                           generator=_generator(seed, "cpu")).tolist()
    mine = evaluate_policy(s1, dev)
    sps_m = evaluate_sps(cfg, s2, steps, dtype=dtype, device=dev)
    return {label: mine, "sps": sps_m,
            "prr_improvement": mine["mean_prr"] / max(sps_m["mean_prr"], 1e-9)
            - 1.0}


def compare_drqn_vs_sps(cfg: ExperimentConfig, params, seed: int,
                        steps: int = 500, dtype=torch.float32, device=None):
    """The paper's comparison: PRR of the DRQN policy vs the SPS baseline
    on the same scenario family (two seeds derived from ``seed``)."""
    return _versus_sps(cfg, "drqn", lambda s, dev: evaluate_drqn(
        cfg, params, s, steps, dtype, dev), seed, steps, dtype, device)


def compare_ppo_vs_sps(cfg: ExperimentConfig, params, seed: int,
                       steps: int = 500, dtype=torch.float32, device=None):
    """PRR-vs-SPS for a PPO actor (evaluate.py:233-244)."""
    return _versus_sps(cfg, "ppo", lambda s, dev: evaluate_ppo(
        cfg, params, s, steps, dtype, dev), seed, steps, dtype, device)


def compare_ps_vs_sps(cfg: ExperimentConfig, params, seed: int,
                      steps: int = 500, algo: str = "ps-dqn",
                      dtype=torch.float32, device=None):
    """PRR-vs-SPS for a PS-DQN / PS-DRQN Q-net (evaluate.py:247-257)."""
    return _versus_sps(cfg, algo.replace("-", "_"), lambda s, dev:
                       evaluate_ps(cfg, params, s, steps, algo, dtype, dev),
                       seed, steps, dtype, device)
