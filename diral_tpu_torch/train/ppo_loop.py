"""On-policy PPO training loop (diral_tpu/train/ppo_loop.py): batched
episode rollout -> advantages -> one PPO update per episode.

Each episode is ``episode_interval`` env slots collecting (window,
action, reward) for every agent of every env, then one PPO update on the
flattened [slots * envs * agents] batch.  The LSTM variant evaluates each
slot's policy and value on the trailing ``step_size`` history window, as
the reference feeds [batch, step, state] sequences
(ps_ppo.py:31-44,118-128).  One shared actor-critic, agents batched.

Kernels on a CUDA device: the actor forward of every slot, the values and
the three forwards of every update epoch are K1 (the encoders, H % 128 ==
0); the update's two backwards are K3; under ``hist_impl="lanes"`` every
``obtain_state`` runs K7.

What differs from the JAX package, by design:

* The per-slot critic values (ppo_loop.py:80, a ``vmap`` over the slots)
  are ONE forward over all L*B*N rows: the rows are independent.
* All random draws come from a ``PPODraws`` object; its default draws
  from a ``torch.Generator``, and a test hands in its own to replay the
  JAX package's key chain.  Actions are the Gumbel-max rule
  ``jax.random.categorical`` uses, on the draws' Gumbel noise.
* The actor, the env and the values run without autograd; the learner
  is updated in place.
"""

from __future__ import annotations

import torch

from diral_tpu_torch.agents import policies as pol
from diral_tpu_torch.agents import ppo
from diral_tpu_torch.config import ExperimentConfig
from diral_tpu_torch.device import resolve_device
from diral_tpu_torch.envs import v2v_env as E
from diral_tpu_torch.models import actor_critic as ac
from diral_tpu_torch.train import checkpoint as ckpt


class PPODraws:
    """Every random number a PPO run consumes, one method per use; this
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

    def params(self, state_dim: int, num_actions: int, acfg, dtype):
        return ac.ppo_init(self.gen, state_dim, num_actions, acfg, dtype,
                           self.device)

    def gumbel(self, ep: int, i: int, rows: int, num_actions: int, dtype):
        """Gumbel noise [rows, A] for slot ``i`` of episode ``ep``."""
        return pol.gumbel_noise(self.gen, (rows, num_actions), dtype,
                                self.device)


class PPOFunctions:
    """``make_ppo_functions``' result: ``init_state(draws)``,
    ``init_learner(draws)``, ``rollout`` and ``learn`` (an ``episode`` is
    one of each) and ``run``."""

    def __init__(self, cfg: ExperimentConfig, dtype=torch.float32,
                 adv_mode: str = "gae", lam: float = 0.95, device=None):
        if adv_mode not in ("gae", "returns"):
            raise ValueError(f"bad adv_mode {adv_mode!r}")
        self.cfg, self.dtype = cfg, dtype
        self.adv_mode, self.lam = adv_mode, lam
        self.device = resolve_device(device)
        env = cfg.env
        self.B = cfg.engine.num_envs
        self.N, self.C, self.D = env.num_users, env.num_channels, env.state_space
        self.T = cfg.agent.step_size
        self.L = cfg.episode_interval
        self.use_lstm = cfg.agent.network.use_lstm_input
        self.step_env = E.step_channel if cfg.enable_channel else E.step_collision

    def policy_input(self, history):
        """history [B, N, T, D] (agent-major) -> the model input: windows
        [B*N, T, D] or the last states [B*N, D]."""
        B, N, T, D = self.B, self.N, self.T, self.D
        if self.use_lstm:
            return history.reshape(B * N, T, D)
        return history[:, :, -1].reshape(B * N, D)

    @torch.no_grad()
    def init_state(self, draws: PPODraws):
        """(env_state, history [B, N, T, D]): one random step, its state
        vectors in the history's last step (ppo_loop.py:50-59)."""
        env = self.cfg.env
        env_state = draws.reset(env, self.B, self.dtype)
        a0 = draws.init_actions(env, self.B)
        env_state, obs, rew = self.step_env(env, env_state, a0, 0)
        s0 = E.obtain_state(env, env_state, obs, a0, rew)
        history = torch.zeros((self.B, self.N, self.T, self.D),
                              dtype=self.dtype, device=self.device)
        history[:, :, -1] = s0
        return env_state, history

    def init_learner(self, draws: PPODraws) -> ppo.PPOLearner:
        return ppo.init_learner(draws.params(self.D, self.C, self.cfg.agent,
                                             self.dtype))

    @torch.no_grad()
    def rollout(self, env_state, history, learner, ep: int,
                draws: PPODraws):
        """The L slots of episode ``ep`` (ppo_loop.py:62-76).  Returns
        (env_state, history, traj) with traj {"x" [L, M, ...], "actions"
        [L, M], "rew" [L, M], "sum_r" [L]}, M = B*N."""
        env, acfg = self.cfg.env, self.cfg.agent
        M = self.B * self.N
        traj = {"x": [], "actions": [], "rew": [], "sum_r": []}
        for i in range(self.L):
            t = ep * self.L + i
            x = self.policy_input(history)
            acts = ppo.choose_actions(learner, x,
                                      draws.gumbel(ep, i, M, self.C, x.dtype),
                                      acfg)
            actions = acts.reshape(self.B, self.N)
            env_state, obs, rew = self.step_env(env, env_state, actions, t)
            sv = E.obtain_state(env, env_state, obs, actions, rew)
            history = torch.cat([history[:, :, 1:], sv[:, :, None]], dim=2)
            for k, v in (("x", x), ("actions", acts), ("rew", rew.reshape(-1)),
                         ("sum_r", rew.sum())):
                traj[k].append(v)
        return env_state, history, {k: torch.stack(v)
                                    for k, v in traj.items()}

    def learn(self, learner: ppo.PPOLearner, traj, history):
        """Values (one forward over all L*M rows), the bootstrap from the
        post-episode history, advantages and one PPO update
        (ppo_loop.py:78-96).  Returns the update's metrics."""
        acfg = self.cfg.agent
        L, M = traj["rew"].shape
        x = traj["x"]
        states = x.reshape((L * M,) + x.shape[2:])
        vals = ppo.values(learner, states, acfg).reshape(L, M)
        last_v = ppo.values(learner, self.policy_input(history), acfg)
        if self.adv_mode == "gae":
            advs, rets = ppo.gae(traj["rew"], vals, last_v, acfg.gamma,
                                 self.lam)
        else:
            rets = ppo.discounted_returns(traj["rew"], last_v, acfg.gamma)
            advs = rets - vals
        batch = {"states": states, "actions": traj["actions"].reshape(-1),
                 "advantages": advs.reshape(-1), "returns": rets.reshape(-1)}
        _, metrics = ppo.update(learner, batch, acfg)
        return metrics

    def episode(self, carry, ep: int, draws: PPODraws):
        """carry = (env_state, history, learner) -> (carry', logs) with
        0-dim tensor logs {mean_sum_reward, loss, actor_loss, critic_loss,
        entropy}."""
        env_state, history, learner = carry
        env_state, history, traj = self.rollout(env_state, history, learner,
                                                ep, draws)
        metrics = self.learn(learner, traj, history)
        logs = {"mean_sum_reward": traj["sum_r"].mean() / self.B, **metrics}
        return (env_state, history, learner), logs

    def run(self, draws: PPODraws, num_episodes: int, learner=None,
            start=None, after_episode=None):
        """init_state, a fresh learner (or ``learner``) and episodes 0 ..
        ``num_episodes`` - 1.  Returns (learner, logs {key: numpy array
        [num_episodes]}).

        ``start`` (a ``checkpoint.EpisodeStart``, from
        ``checkpoint.restore_ppo`` with ``draws``' generator) resumes a
        cut run: its carry, at its episode, after its logs, without
        ``init_state`` (whose draws the cut run took already), so the
        resumed run equals the uncut one.  ``after_episode(e, carry,
        logs)`` is called with e episodes done; ``logs()`` gives the logs
        so far."""
        if start is None:
            env_state, history = self.init_state(draws)
            if learner is None:
                learner = self.init_learner(draws)
            carry, e0, prior = (env_state, history, learner), 0, {}
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
        return carry[2], so_far()


def make_ppo_functions(cfg: ExperimentConfig, dtype=torch.float32,
                       adv_mode: str = "gae", lam: float = 0.95,
                       device=None) -> PPOFunctions:
    """Build the PPO functions for ``cfg`` on ``device`` (default CUDA;
    raises without a GPU unless ``device="cpu"``)."""
    return PPOFunctions(cfg, dtype, adv_mode, lam, device)


def run_ppo(cfg: ExperimentConfig, seed: int = 0,
            num_episodes: int | None = None, dtype=torch.float32,
            device=None, draws: PPODraws | None = None, **kw):
    """Train PPO for ``num_episodes`` (default time_slots //
    episode_interval) episodes; draws from a generator seeded ``seed``
    on ``device`` unless ``draws`` is given.  Returns (learner, logs)."""
    fns = make_ppo_functions(cfg, dtype, device=device, **kw)
    if draws is None:
        draws = PPODraws(torch.Generator(device=fns.device).manual_seed(
            int(seed)))
    n = num_episodes or cfg.time_slots // cfg.episode_interval
    return fns.run(draws, n)
