"""Serve-and-learn over the external-simulator gateway
(diral_tpu/interop/serve.py).

This is the reference's *intended* RealNeS training mode -- per-agent
event-driven scheduling requests with sequence numbers and delayed rewards,
answered online by a learning agent -- which the reference could never run
(main_test.py:291-293 hard-disables it).  Here it runs against the port's
copy of the in-repo C++ toy-RealNeS:

* each scheduling request carries the requester's neighbor table; the
  gateway env turns it into the positional-distribution state and a
  PRR-mapped reward (gateway_env.get_observation_syn_dist);
* actions come from the PS-DRQN learner with per-agent carried GRU hidden
  state (agents/ps_drqn.infer_actions);
* (state, action, reward) tuples are SN-aligned per agent, like the
  reference ``EpisodesBuffer`` (utils/memory.py:65-117: a slot is only
  consumed once state+action+reward for its SN are all present);
* every ``train_every`` completed rounds the accumulated per-agent episodes
  flush into the ``EpisodeReplay`` and the learner takes ``n_batches``
  gradient steps.

The serving loop is host-driven by construction: the simulator dictates
event order over the socket, and the sockets, the simulator and the
gateway's histograms are host work.  The learner, the hidden states, the
replay and SPS's state live on the run's device (CUDA unless the caller
asks for the CPU); each request moves its one observation to the device
and its action back.  Every random number comes from a ``ServeDraws``
object (default: one ``torch.Generator`` on the run's device, seeded
with ``seed``), the seam a test injects other draws through.

Each stats dict keeps the JAX package's keys and adds ``timing``: the
requests served, the loop's seconds, and the host seconds spent waiting
on the simulator (receiving, parsing and answering a request), in
inference (the draws, the transfers and the forward) and in training
(flushes and train calls).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from diral_tpu_torch.agents import dqn, ps_drqn
from diral_tpu_torch.agents import sps
from diral_tpu_torch.agents.replay import TransitionReplay
from diral_tpu_torch.config import AgentConfig, toy_4ue_3r
from diral_tpu_torch.device import resolve_device
from diral_tpu_torch.interop.gateway_env import (GatewayEnv,
                                                 distance_based_rewards)
from diral_tpu_torch.train.ps_loop import PSDraws


def tuned_agent() -> AgentConfig:
    """The JAX ``serve`` verb's default agent, tuned on the 8-user /
    6-channel world: the toy agent with batch 16, unroll 8, target sync
    every 32 steps and a (64, 64) trunk, no LSTM input, no dueling head."""
    acfg = toy_4ue_3r().agent
    return dataclasses.replace(
        acfg, batch_size=16, unroll_step=8, target_update=32,
        network=dataclasses.replace(acfg.network, use_lstm_input=False,
                                    use_dueling=False, layers=(64, 64)))


class ServeDraws(PSDraws):
    """``PSDraws`` (parameters, eps-greedy draws, replay draws; its
    ``ep`` argument is the round here, ``i`` the request within it) plus
    SPS's initial state and per-request draws."""

    def sps_init(self, num_users: int, num_channels: int) -> sps.SPSState:
        """[1, num_users] SPS state."""
        return sps.sps_init(self.gen, 1, num_users, num_channels, self.device)

    def sps_step(self, rnd: int, i: int):
        """(counter_draw, keep_u, pick_u), each [1], for request i of
        round rnd."""
        counter = torch.randint(5, 17, (1,), generator=self.gen,
                                device=self.device)  # U{5,16}, v2x_sps.py:92
        keep = torch.rand(1, generator=self.gen, device=self.device)
        pick = torch.rand(1, generator=self.gen, device=self.device)
        return counter, keep, pick


def _draws(draws, seed: int, device) -> ServeDraws:
    if draws is not None:
        return draws
    return ServeDraws(torch.Generator(device=device).manual_seed(int(seed)))


class _Timer:
    """Host seconds by phase of the serving loop."""

    def __init__(self):
        self.start = time.perf_counter()
        self.wait = self.infer = self.train = 0.0
        self.requests = 0

    def stats(self) -> dict:
        return {"requests": self.requests,
                "seconds": time.perf_counter() - self.start,
                "wait_s": self.wait, "infer_s": self.infer,
                "train_s": self.train}


class SNAlignedEpisodes:
    """Per-agent SN-slot episode assembly (EpisodesBufferEntry semantics,
    utils/memory.py:14-62): state+action and the (delayed) reward arrive at
    different times, each lands set-once in its SN slot, and a slot is only
    training-ready when both halves are present (the SN reconciliation that
    alleviates delayed rewards, memory.py:38-62 + ps_drqn.py:282-288).
    Numpy, as in the JAX package; ``flush`` hands complete slots to the
    replay on its device."""

    def __init__(self, num_agents: int, capacity: int, state_dim: int):
        self.capacity = capacity
        self.states = np.zeros((num_agents, capacity, state_dim), np.float32)
        self.actions = np.zeros((num_agents, capacity), np.int32)
        self.rewards = np.zeros((num_agents, capacity), np.float32)
        self.has_sa = np.zeros((num_agents, capacity), bool)
        self.has_r = np.zeros((num_agents, capacity), bool)
        # flush windows an armed (has_sa-only) slot has survived: a reward
        # lost forever must not leave its slot armed, or the recycled SN
        # (sn % capacity collision) would pair the STALE state/action with
        # the new SN's reward -- the aliasing this class exists to prevent
        self.sa_age = np.zeros((num_agents, capacity), np.int8)

    def record_obs_act(self, agent: int, sn: int, state, action):
        slot = sn % self.capacity
        if not self.has_sa[agent, slot]:
            self.states[agent, slot] = state
            self.actions[agent, slot] = action
            self.has_sa[agent, slot] = True
            self.sa_age[agent, slot] = 0

    def record_reward(self, agent: int, sn: int, reward):
        slot = sn % self.capacity
        if not self.has_r[agent, slot]:
            self.rewards[agent, slot] = reward
            self.has_r[agent, slot] = True

    def flush(self, replay, sink=None):
        """Move complete (state+action+reward) slots into the replay and
        release them (the `is not -1` triple filter, ps_drqn.py:282-288).

        Slots still awaiting their delayed reward (has_sa without has_r —
        typically the window's last SN, whose reward rides the NEXT
        request) are kept armed, so the late reward completes the pair it
        belongs to instead of landing in a recycled slot and pairing with
        a state/action from ``capacity`` SNs later.

        ``sink(replay, states, actions, rewards) -> replay`` overrides the
        default PS-DRQN ``EpisodeReplay.add_episode`` ingestion (the PS-DQN
        serving loop passes a TransitionReplay sink)."""
        for a in range(self.states.shape[0]):
            complete = self.has_sa[a] & self.has_r[a]
            length = int(complete.sum())
            if length and sink is not None:
                idx = np.where(complete)[0]
                replay = sink(replay, self.states[a, idx],
                              self.actions[a, idx], self.rewards[a, idx])
            elif length:
                idx = np.where(complete)[0]
                L = replay.states.shape[1]
                take = idx[:L]
                s = np.zeros((L, self.states.shape[2]), np.float32)
                act = np.zeros((L,), np.int32)
                rew = np.zeros((L,), np.float32)
                s[: len(take)] = self.states[a, take]
                act[: len(take)] = self.actions[a, take]
                rew[: len(take)] = self.rewards[a, take]
                dev = replay.states.device
                replay.add_episode(
                    torch.from_numpy(s).to(dev), torch.from_numpy(act).to(dev),
                    torch.from_numpy(rew).to(dev), terminated=False,
                    length=min(length, L))
            self.has_sa[a, complete] = False
            self.has_r[a, complete] = False
            # orphan rewards (reward without state/action, e.g. the obs was
            # dropped) must not pair with a future state/action
            self.has_r[a, self.has_r[a] & ~self.has_sa[a]] = False
            # age slots still awaiting their delayed reward; one full flush
            # window is the legitimate delay (the last SN's reward rides the
            # next request), beyond that the reward is lost -- disarm so the
            # stale state/action cannot pair with a recycled SN's reward
            armed = self.has_sa[a] & ~self.has_r[a]
            self.sa_age[a, armed] += 1
            self.has_sa[a, armed & (self.sa_age[a] > 1)] = False
        return replay


def _eps(eps: float, eps_final: float | None, rnd: int, rounds: int) -> float:
    """JAX's linear exploration schedule, in Python floats."""
    if eps_final is None:
        return eps
    return eps + (eps_final - eps) * (rnd / max(1, rounds - 1))


def _prr_stats(prr_log, rounds: int) -> dict:
    prrs = [p for p in prr_log if p is not None]
    tail = prrs[-max(1, len(prrs) // 4):] if prrs else []
    return {"rounds": rounds,
            "mean_prr": float(np.mean(prrs)) if prrs else float("nan"),
            "mean_prr_tail": float(np.mean(tail)) if tail else float("nan")}


def serve_and_learn(env: GatewayEnv, cfg: AgentConfig, rounds: int,
                    train_every: int = 25, n_batches: int = 2,
                    eps: float = 0.2, eps_final: float | None = None,
                    seed: int = 0, mode: str = "dist", device=None,
                    draws: ServeDraws | None = None):
    """Serve ``rounds`` full scheduling rounds, learning online.

    ``mode`` selects the reference observation path:

    * ``"dist"`` -- piggybacked neighbor tables turned into positional
      histograms, PRR-mapped rewards (get_observation_syn_dist,
      realness_env.py:360-396);
    * ``"syn"`` -- per-channel RSSI states with the >0.9 reward threshold
      (get_observation_syn, realness_env.py:333-358); the simulator must be
      started in the matching request mode.

    With ``env.distance_based_reward`` (dist mode only), rewards come from
    the reported actions + x-positions through ``distance_based_rewards``
    (realness_env.py:120-191) instead of the request-carried PRR.

    ``eps_final`` enables a linear exploration decay across the run.
    Returns (learner, stats dict).  stats["mean_prr_tail"] is the raw PRR
    over the last quarter of the run -- the comparison metric vs SPS."""
    if mode not in ("dist", "syn"):
        raise ValueError(f"mode must be 'dist' or 'syn', got {mode!r}")
    dev = resolve_device(device)
    draws = _draws(draws, seed, dev)
    env.initialize_env()
    n = env.get_total_users()
    a_dim = env.get_action_space()
    # dist mode always serves a state_bins-wide positional histogram
    # (gateway_env.py: neighbor_dist_type1/2), regardless of the DRQN-path
    # state_space bookkeeping; syn mode serves the simulator-advertised
    # per-channel observation -- size the learner to what is served
    d = env.state_bins if mode == "dist" else env.obs_size

    learner = ps_drqn.init_learner(
        draws.params("ps-drqn", d, a_dim, cfg, torch.float32), cfg)
    hidden = ps_drqn.init_hidden(cfg, n, device=dev)
    replay = ps_drqn.EpisodeReplay.create(capacity=n, max_len=train_every,
                                          state_dim=d, device=dev)
    episodes = SNAlignedEpisodes(n, capacity=train_every, state_dim=d)

    rewards_log, prr_log, losses = [], [], []
    round_acts = np.zeros(n, np.int64)
    round_pos = np.zeros(n, np.float64)
    trained_rounds = 0
    timer = _Timer()
    for rnd in range(rounds):
        cur_eps = _eps(eps, eps_final, rnd, rounds)
        for i in range(n):
            t0 = time.perf_counter()
            if mode == "dist":
                user_id, sn, state, reward, pos_x = \
                    env.get_observation_syn_dist()
            else:
                user_id, sn, state, reward = env.get_observation_syn()
            t1 = time.perf_counter()
            agent = user_id - 1 if env.bridge.disable_one_user else user_id
            draw, rand = draws.eps_greedy(rnd, i, 1, a_dim)
            obs = torch.as_tensor(np.asarray(state, np.float32)).to(dev)
            acts, h_new = ps_drqn.infer_actions(
                learner, obs[None], hidden[agent:agent + 1], cur_eps, draw,
                rand, cfg)
            hidden[agent] = h_new[0]
            action = int(acts[0])
            t2 = time.perf_counter()
            env.apply_action(action)
            timer.wait += (t1 - t0) + (time.perf_counter() - t2)
            timer.infer += t2 - t1
            timer.requests += 1
            env.set_last_action(user_id, action)
            episodes.record_obs_act(agent, sn, state, action)
            round_acts[agent] = action
            if mode == "dist":
                round_pos[agent] = pos_x
            prr_log.append(env.last_prr if sn > 0 else None)
            # the reward in this request is the delayed reward for SN-1
            if sn > 0 and not env.distance_based_reward:
                episodes.record_reward(agent, sn - 1, reward)
                rewards_log.append(reward)

        if env.distance_based_reward and mode == "dist":
            # rewards derived locally from this round's reported actions
            # and positions (realness_env.py:120-152): no SN-1 delay
            rews = distance_based_rewards(round_acts, round_pos, a_dim)
            for agent, r in rews.items():
                episodes.record_reward(agent, rnd, r)
                rewards_log.append(r)

        if (rnd + 1) % train_every == 0:
            t0 = time.perf_counter()
            replay = episodes.flush(replay)
            if replay.count > 0:
                windows = [draws.windows(rnd, j, replay, cfg.batch_size)
                           for j in range(n_batches)]
                losses.append(float(ps_drqn.train(learner, replay, windows,
                                                  cfg)))
                trained_rounds += 1
            timer.train += time.perf_counter() - t0

    prr = _prr_stats(prr_log, rounds)
    return learner, {
        "rounds": rounds,
        "mean_reward": float(np.mean(rewards_log)) if rewards_log else 0.0,
        "mean_prr": prr["mean_prr"],
        "mean_prr_tail": prr["mean_prr_tail"],
        "train_calls": trained_rounds,
        "losses": losses,
        "timing": timer.stats(),
    }


def serve_and_learn_dqn(env: GatewayEnv, cfg: AgentConfig, rounds: int,
                        train_every: int = 25, n_batches: int = 2,
                        eps: float = 0.2, eps_final: float | None = None,
                        seed: int = 0, capacity: int = 4096, device=None,
                        draws: ServeDraws | None = None):
    """PS-DQN served online over the RSSI path -- the end-to-end driver the
    reference's feedforward PS agent never had (algorithms/ps_dqn.py is
    unrunnable there: its TFBaseModel base class is absent).

    The simulator (``syn`` request mode) sends per-channel RSSI states; the
    agent answers eps-greedy grants (agents/dqn.infer_actions), SN-aligns
    the delayed rewards, flushes complete transitions into the flat
    TransitionReplay with the mask/terminal convention (dqn.add_episode,
    ps_dqn.py:258-294), and trains every ``train_every`` rounds.
    Returns (learner, stats dict)."""
    dev = resolve_device(device)
    draws = _draws(draws, seed, dev)
    env.initialize_env()
    n = env.get_total_users()
    a_dim = env.get_action_space()
    d = env.obs_size

    learner = dqn.init_learner(
        draws.params("ps-dqn", d, a_dim, cfg, torch.float32), cfg)
    replay = TransitionReplay.create(capacity, d, device=dev)
    episodes = SNAlignedEpisodes(n, capacity=train_every, state_dim=d)

    def sink(rep, s, a, r):
        dqn.add_episode(rep, torch.from_numpy(s).to(dev),
                        torch.from_numpy(a).to(dev),
                        torch.from_numpy(r).to(dev), terminated=False)
        return rep

    rewards_log, prr_log, losses = [], [], []
    trained = 0
    timer = _Timer()
    for rnd in range(rounds):
        cur_eps = _eps(eps, eps_final, rnd, rounds)
        for i in range(n):
            t0 = time.perf_counter()
            user_id, sn, state, reward = env.get_observation_syn()
            t1 = time.perf_counter()
            agent = user_id - 1 if env.bridge.disable_one_user else user_id
            draw, rand = draws.eps_greedy(rnd, i, 1, a_dim)
            obs = torch.as_tensor(np.asarray(state, np.float32)).to(dev)
            act = int(dqn.infer_actions(learner, obs[None], cur_eps, draw,
                                        rand, cfg)[0])
            t2 = time.perf_counter()
            env.apply_action(act)
            timer.wait += (t1 - t0) + (time.perf_counter() - t2)
            timer.infer += t2 - t1
            timer.requests += 1
            env.set_last_action(user_id, act)
            episodes.record_obs_act(agent, sn, state, act)
            prr_log.append(env.last_prr if sn > 0 else None)
            if sn > 0:
                episodes.record_reward(agent, sn - 1, reward)
                rewards_log.append(reward)

        if (rnd + 1) % train_every == 0:
            t0 = time.perf_counter()
            replay = episodes.flush(replay, sink=sink)
            if replay.count > cfg.batch_size:
                idx = [draws.replay_indices(rnd, j, replay, cfg.batch_size)
                       for j in range(n_batches)]
                losses.append(float(dqn.train(learner, replay, idx, cfg)))
                trained += 1
            timer.train += time.perf_counter() - t0

    prr = _prr_stats(prr_log, rounds)
    return learner, {
        "rounds": rounds,
        "mean_reward": float(np.mean(rewards_log)) if rewards_log else 0.0,
        "mean_prr": prr["mean_prr"],
        "mean_prr_tail": prr["mean_prr_tail"],
        "train_calls": trained,
        "losses": losses,
        "timing": timer.stats(),
    }


def serve_sps(env: GatewayEnv, rounds: int, rssi_threshold: float = -110.0,
              seed: int = 0, device=None, draws: ServeDraws | None = None):
    """Serve SPS online over the wire protocol: the simulator (started in
    ``sps`` request mode) sends per-UE RSSI selection windows as
    SPS_SchedulingRequestSyn (realness_bridge.py:193-208), the SPS baseline
    (agents/sps.py <- v2x_sps.py semantics) answers each with a grant.
    Returns a stats dict with the raw PRR telemetry -- the reference's
    online DIRAL-vs-SPS comparison counterpart."""
    dev = resolve_device(device)
    draws = _draws(draws, seed, dev)
    env.initialize_env()
    n = env.get_total_users()
    c = env.get_action_space()
    state = draws.sps_init(n, c)

    prr_log = []
    timer = _Timer()
    for rnd in range(rounds):
        for i in range(n):
            t0 = time.perf_counter()
            user_id, sn, rssi, prr = env.get_observation_syn_sps()
            t1 = time.perf_counter()
            agent = user_id - 1 if env.bridge.disable_one_user else user_id
            sub = sps.SPSState(prev_action=state.prev_action[:, agent],
                               counter=state.counter[:, agent])
            window = torch.as_tensor(np.asarray(rssi, np.float32)).to(dev)
            acts, new = sps.sps_step_pure(sub, window[None], rssi_threshold,
                                          *draws.sps_step(rnd, i))
            state.prev_action[:, agent] = new.prev_action
            state.counter[:, agent] = new.counter
            act = int(acts[0])
            t2 = time.perf_counter()
            env.apply_action(act)
            timer.wait += (t1 - t0) + (time.perf_counter() - t2)
            timer.infer += t2 - t1
            timer.requests += 1
            if sn > 0:
                prr_log.append(prr)

    return {**_prr_stats(prr_log, rounds), "timing": timer.stats()}


def compare_sps_over_gateway(cfg: AgentConfig, sim_users: int = 8,
                             sim_channels: int = 6, rounds: int = 400,
                             train_every: int = 25, n_batches: int = 2,
                             eps: float = 0.3, eps_final: float = 0.02,
                             seed: int = 0, rssi_threshold: float = -110.0,
                             transport: str = "framed", device=None):
    """Online DIRAL-vs-SPS over the wire protocol: two simulator runs with
    the same world seed, one served by the learning PS-DRQN (dist mode),
    one by SPS (sps mode); compared on tail raw PRR.  This reproduces the
    reference's intended RealNeS comparison (realness_bridge.py:193-208 +
    the paper's +20% PRR claim) inside the repo."""
    def make_env(mode):
        return GatewayEnv(port=0, sim_start=True, sim_users=sim_users,
                          sim_channels=sim_channels, sim_rounds=rounds + 5,
                          sim_seed=seed, sim_mode=mode, state_design=2,
                          pos_dist=2, reward_design=2,
                          sim_transport=transport)

    env = make_env("dist")
    try:
        _, drqn_stats = serve_and_learn(env, cfg, rounds,
                                        train_every=train_every,
                                        n_batches=n_batches, eps=eps,
                                        eps_final=eps_final, seed=seed,
                                        device=device)
    finally:
        env.close()

    env = make_env("sps")
    try:
        sps_stats = serve_sps(env, rounds, rssi_threshold=rssi_threshold,
                              seed=seed, device=device)
    finally:
        env.close()

    drqn_stats.pop("losses", None)
    return {
        "drqn": drqn_stats,
        "sps": sps_stats,
        "prr_improvement":
            drqn_stats["mean_prr_tail"] - sps_stats["mean_prr_tail"],
    }
