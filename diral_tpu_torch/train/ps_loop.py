"""In-process training loops for PS-DQN and PS-DRQN on the batched env
(diral_tpu/train/ps_loop.py).

Per episode of L = ``episode_interval`` slots: the eps schedule advances
once (eps decays per episode, policies.py:45-63), every agent of every
env acts eps-greedily on its current state (PS-DRQN through the GRU with
its hidden carried across slots AND episodes: the reference never resets
it, ps_drqn.py:168-193), then the episode is ingested and trained on:

* PS-DQN: each agent's episode streams into the flat transition ring
  with the mask/terminal convention, agent-major (ps_dqn.py:258-294);
  then ``n_batches = training_freq * A * L // batch_size`` gradient
  steps (ps_dqn.py:315).
* PS-DRQN: one episode per agent into the episode ring (capacity = the
  number of agents); ``n_batches = training_freq * A * L // (batch_size
  * (unroll_step - skip_error))`` window batches (ps_drqn.py:333,345).

Both skip the train call when n_batches is 0 (ps_dqn.py:315-316,
ps_drqn.py:333-335).  Raw env rewards, one shared learner, agents
flattened to one axis (A = B*N).  Under ``hist_impl="lanes"`` every
``obtain_state`` runs K7 on a CUDA device.

What differs from the JAX package: PS-DRQN rejects ``unroll_step <=
skip_error`` (ps_loop.py:87 divides by zero there, or trains never); the
eps schedule and the replays' pointers live on the host; every random
draw comes from a ``PSDraws`` object (a test replays JAX's key chain
through its own).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from diral_tpu_torch.agents import dqn, ps_drqn
from diral_tpu_torch.agents import policies as pol
from diral_tpu_torch.agents.replay import TransitionReplay
from diral_tpu_torch.config import AgentConfig, ExperimentConfig
from diral_tpu_torch.device import resolve_device
from diral_tpu_torch.envs import v2v_env as E
from diral_tpu_torch.models import qnets
from diral_tpu_torch.train import checkpoint as ckpt

ALGOS = ("ps-dqn", "ps-drqn")


def canonical_algo(algo: str) -> str:
    algo = algo.lower().replace("_", "-")
    if algo not in ALGOS:
        raise ValueError(f"unknown PS algorithm {algo!r}")
    return algo


def n_batches(cfg: ExperimentConfig, algo: str) -> int:
    """Gradient steps per episode (ps_loop.py:86-90): the A*L added
    transitions over batch_size (PS-DQN) or over the window span
    batch_size * (unroll_step - skip_error) (PS-DRQN)."""
    acfg = cfg.agent
    added = acfg.training_freq * cfg.engine.num_envs * cfg.env.num_users \
        * cfg.episode_interval
    if canonical_algo(algo) == "ps-drqn":
        span = acfg.unroll_step - acfg.network.skip_error
        if span <= 0:
            raise ValueError(
                f"PS-DRQN needs unroll_step > skip_error (got unroll_step="
                f"{acfg.unroll_step}, skip_error={acfg.network.skip_error}): "
                "a window batch spans unroll_step - skip_error steps")
        return added // (acfg.batch_size * span)
    return added // acfg.batch_size


class PSDraws:
    """Every random number a PS run consumes, one method per use; this
    default draws from one ``torch.Generator`` on the run's device."""

    def __init__(self, generator: torch.Generator):
        self.gen = generator

    @property
    def device(self):
        return self.gen.device

    def reset(self, env_cfg, num_envs: int, dtype) -> E.EnvState:
        return E.reset(env_cfg, num_envs, self.gen, dtype, self.device)

    def init_actions(self, env_cfg, num_envs: int):
        return E.sample_actions(env_cfg, self.gen, num_envs, self.device)

    def params(self, algo: str, state_dim: int, num_actions: int,
               acfg: AgentConfig, dtype):
        init = qnets.ps_drqn_init if algo == "ps-drqn" else qnets.ps_dqn_init
        return init(self.gen, state_dim, num_actions, acfg, dtype,
                    self.device)

    def eps_greedy(self, ep: int, i: int, rows: int, num_actions: int):
        """(uniforms [rows], random actions [rows]) of slot i."""
        u = torch.rand(rows, generator=self.gen, device=self.device)
        return u, pol.random_action(self.gen, (rows,), num_actions,
                                    self.device)

    def replay_indices(self, ep: int, j: int, replay: TransitionReplay,
                       batch: int):
        return replay.sample_indices(self.gen, batch)

    def windows(self, ep: int, j: int, replay: ps_drqn.EpisodeReplay,
                batch: int):
        g = pol.gumbel_noise(self.gen, (batch, replay.capacity),
                             torch.float32, self.device)
        u = torch.rand(batch, generator=self.gen, device=self.device)
        return replay.window_draws(g, u)


@dataclass
class PSCarry:
    env_state: E.EnvState
    state: torch.Tensor            # [B, N, D]
    hidden: torch.Tensor | None    # [A, H] (PS-DRQN) or None
    learner: object
    replay: object
    eps_state: pol.EpsGreedyState

    def replace(self, **changes) -> "PSCarry":
        return dataclasses.replace(self, **changes)


class PSFunctions:
    """``make_ps_functions``' result: ``init_carry(draws)``, ``rollout``
    and ``learn`` (an ``episode`` is one of each) and ``run``."""

    def __init__(self, cfg: ExperimentConfig, algo: str,
                 dtype=torch.float32, device=None):
        self.algo = canonical_algo(algo)
        self.recurrent = self.algo == "ps-drqn"
        self.n_batches = n_batches(cfg, self.algo)
        self.cfg, self.dtype = cfg, dtype
        self.device = resolve_device(device)
        env = cfg.env
        self.B = cfg.engine.num_envs
        self.N, self.C, self.D = env.num_users, env.num_channels, env.state_space
        self.A = self.B * self.N
        self.L = cfg.episode_interval
        self.step_env = E.step_channel if cfg.enable_channel else E.step_collision

    @torch.no_grad()
    def init_carry(self, draws: PSDraws, learner=None) -> PSCarry:
        """One random step for the first state vectors, a fresh learner
        (or ``learner``), an empty replay (ps_loop.py:92-112)."""
        env, acfg = self.cfg.env, self.cfg.agent
        env_state = draws.reset(env, self.B, self.dtype)
        a0 = draws.init_actions(env, self.B)
        env_state, obs, rew = self.step_env(env, env_state, a0, 0)
        state = E.obtain_state(env, env_state, obs, a0, rew)
        lib = ps_drqn if self.recurrent else dqn
        if learner is None:
            learner = lib.init_learner(
                draws.params(self.algo, self.D, self.C, acfg, self.dtype),
                acfg)
        if self.recurrent:
            hidden = ps_drqn.init_hidden(acfg, self.A, self.dtype,
                                         self.device)
            replay = ps_drqn.EpisodeReplay.create(self.A, self.L, self.D,
                                                  self.dtype, self.device)
        else:
            hidden = None
            replay = TransitionReplay.create(self.cfg.memory_size, self.D,
                                             self.dtype, self.device)
        return PSCarry(env_state=env_state, state=state, hidden=hidden,
                       learner=learner, replay=replay,
                       eps_state=pol.eps_greedy_init(acfg.eps_init))

    @torch.no_grad()
    def rollout(self, carry: PSCarry, ep: int, draws: PSDraws):
        """The eps update and the L slots of episode ``ep``
        (ps_loop.py:115-138).  Returns (carry with the new env state,
        state, hidden and eps; traj {"states" [L, B, N, D], "actions"
        [L, B, N], "rewards" [L, B, N]})."""
        env, acfg = self.cfg.env, self.cfg.agent
        eps_state = pol.eps_greedy_update(carry.eps_state, ep, acfg.eps_decay,
                                          acfg.eps_min)
        eps = eps_state.eps
        env_state, state, hidden = carry.env_state, carry.state, carry.hidden
        traj = {"states": [], "actions": [], "rewards": []}
        for i in range(self.L):
            t = ep * self.L + i
            obs_flat = state.reshape(self.A, self.D)
            draw, rand = draws.eps_greedy(ep, i, self.A, self.C)
            if self.recurrent:
                acts, hidden = ps_drqn.infer_actions(
                    carry.learner, obs_flat, hidden, eps, draw, rand, acfg)
            else:
                acts = dqn.infer_actions(carry.learner, obs_flat, eps, draw,
                                         rand, acfg)
            actions = acts.reshape(self.B, self.N)
            env_state, obs, rewards = self.step_env(env, env_state, actions, t)
            nxt = E.obtain_state(env, env_state, obs, actions, rewards)
            for k, v in (("states", state), ("actions", actions),
                         ("rewards", rewards)):
                traj[k].append(v)
            state = nxt
        carry = carry.replace(env_state=env_state, state=state, hidden=hidden,
                              eps_state=eps_state)
        return carry, {k: torch.stack(v) for k, v in traj.items()}

    def learn(self, carry: PSCarry, traj, ep: int, draws: PSDraws):
        """Ingest the episode agent-major and train (ps_loop.py:140-166).
        Returns the mean loss (0-dim tensor; 0 without a train call)."""
        acfg = self.cfg.agent
        A, L, D = self.A, self.L, self.D
        # [L, B, N, ...] -> agent-major [A, L, ...]
        ep_states = traj["states"].permute(1, 2, 0, 3).reshape(A, L, D)
        ep_actions = traj["actions"].permute(1, 2, 0).reshape(A, L)
        ep_rewards = traj["rewards"].to(self.dtype).permute(1, 2, 0) \
            .reshape(A, L)
        never_done = torch.zeros(A, dtype=torch.bool, device=self.device)
        replay, learner = carry.replay, carry.learner
        if self.recurrent:
            replay.add_episodes_batch(
                ep_states, ep_actions, ep_rewards, never_done,
                torch.full((A,), L, dtype=torch.int32, device=self.device))
        else:
            dqn.add_episodes_batch(replay, ep_states, ep_actions, ep_rewards,
                                   never_done)
        if self.n_batches == 0:
            return torch.zeros((), dtype=self.dtype, device=self.device)
        if self.recurrent:
            windows = [draws.windows(ep, j, replay, acfg.batch_size)
                       for j in range(self.n_batches)]
            return ps_drqn.train(learner, replay, windows, acfg)
        idx = [draws.replay_indices(ep, j, replay, acfg.batch_size)
               for j in range(self.n_batches)]
        return dqn.train(learner, replay, idx, acfg)

    def episode(self, carry: PSCarry, ep: int, draws: PSDraws):
        """-> (carry', logs {mean_sum_reward, loss: 0-dim tensors; eps:
        float32})."""
        carry, traj = self.rollout(carry, ep, draws)
        loss = self.learn(carry, traj, ep, draws)
        logs = {"mean_sum_reward": traj["rewards"].sum(dim=2).mean(),
                "loss": loss, "eps": carry.eps_state.eps}
        return carry, logs

    def run(self, draws: PSDraws, num_episodes: int, learner=None,
            start=None, after_episode=None):
        """init_carry and episodes 0 .. ``num_episodes`` - 1.  Returns
        (carry, logs {key: numpy array [num_episodes]}).

        ``start`` (a ``checkpoint.EpisodeStart``, from
        ``checkpoint.restore_ps`` with ``draws``' generator) resumes a cut
        run at its episode without ``init_carry`` (whose draws the cut run
        took already); ``after_episode(e, carry, logs)`` is called with e
        episodes done, ``logs()`` giving the logs so far."""
        if start is None:
            carry, e0, prior = self.init_carry(draws, learner), 0, {}
        else:
            carry, e0, prior = start.carry, start.episode, start.logs
        logs = []

        def so_far():
            return ckpt.episode_logs(prior, logs)
        for ep in range(e0, num_episodes):
            carry, log = self.episode(carry, ep, draws)
            logs.append(log)
            if after_episode is not None:
                after_episode(ep + 1, carry, so_far)
        return carry, so_far()


def make_ps_functions(cfg: ExperimentConfig, algo: str, dtype=torch.float32,
                      device=None) -> PSFunctions:
    """Build the PS loop for ``algo`` ("ps-dqn" | "ps-drqn") on ``device``
    (default CUDA; raises without a GPU unless ``device="cpu"``)."""
    return PSFunctions(cfg, algo, dtype, device)


def run_ps(cfg: ExperimentConfig, algo: str, seed: int = 0,
           num_episodes: int | None = None, dtype=torch.float32,
           device=None, draws: PSDraws | None = None):
    """Train for ``num_episodes`` (default max(1, time_slots //
    episode_interval)) episodes.  Returns (carry, logs)."""
    fns = make_ps_functions(cfg, algo, dtype, device)
    if draws is None:
        draws = PSDraws(torch.Generator(device=fns.device).manual_seed(
            int(seed)))
    if num_episodes is None:
        num_episodes = max(1, cfg.time_slots // cfg.episode_interval)
    return fns.run(draws, num_episodes)
