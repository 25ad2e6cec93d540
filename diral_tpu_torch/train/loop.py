"""The actor-learner training loop (diral_tpu/train/loop.py; reference
main_test.py:14-265 ``marl_test``).

Every slot: one Q-forward for all B*N agents (K1), action selection, the
env step, reward shaping, the replay insert and the history push; every
``episode_interval`` slots (or every slot, per the config) the Double-DQN
train event (K2 forward, K3 backward).  Driver semantics (each as in the
JAX package, which cites the reference):

* warmup step + pretrain phase of ``pretrain_length*step_size*5`` slots
  with the design-step env flavour (or the channel step), storing the
  *stale* warmup rewards in every pretrain transition (main_test.py:89-114);
* slot-indexed action modes: random < ``explore`` <= policy < ``greedy``
  <= greedy (main_test.py:127-136); epsilon decays only in the middle
  band, once per episode advance;
* reward shaping per user in the reference's order: ia-averaging sign
  penalty, ia repeat penalty, global-reward averaging (main_test.py:153-206);
* velocity kicks at episode end (main_test.py:226-233);
* the train gate (main_test.py:222-236).

What differs from the JAX package, by design:

* The gate, the mode band, the epsilon and beta schedules and the replay's
  write pointer follow from the slot index alone, so they live on the
  host and no slot waits on the device.  A train event the gate refuses
  is skipped, not run and thrown away as the JAX ``episode_step`` does.
* There is one grain, the slot: the JAX package's episode grain is a
  compile unit (one ``scan`` per episode), which eager PyTorch has no use
  for; ``episode_interval`` ``slot_step`` calls are the same episode.
* The actor and the env run under ``torch.no_grad()``; only the learner
  step records a graph.
* All random draws of a run come from one ``Draws`` object.  Its default
  draws from a ``torch.Generator``; a test hands in its own to replay the
  JAX package's key chain.
* The sampler selects window starts with one stable ``torch.sort`` prefix
  (JAX's ``top_k`` order, lowest index first on ties); the TPU-only
  two-stage bottom-k and ``gather_impl="scan"`` have no counterpart.

Under a mesh (parallel/mesh.py) each rank holds a slice of the env axis.
Its draws are ``ShardedDraws``: every env-axis draw is made at the global
B and sliced, so every rank consumes the one-device run's random stream
(Philox offsets do not partition the way threefry keys do).  The sampler
is JAX's (diral_tpu/train/loop.py:106-131): global scores give the same
(env, start) picks on every rank, each rank gathers the windows it owns
into a zeroed batch, and ONE all-reduce over the data group completes
it; every rank then takes the same train step.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from diral_tpu_torch.agents import drqn
from diral_tpu_torch.agents import policies as pol
from diral_tpu_torch.agents.replay import FusedWindowReplay
from diral_tpu_torch.config import ExperimentConfig
from diral_tpu_torch.device import resolve_device
from diral_tpu_torch.envs import v2v_env as E
from diral_tpu_torch.models import qnets
from diral_tpu_torch.ops.lstm_window import padded_dim
from diral_tpu_torch.parallel import mesh as pmesh
from diral_tpu_torch.utils import spans


# ---------------------------------------------------------------------------
# Random draws
# ---------------------------------------------------------------------------


class Draws:
    """Every random number a training run consumes, one method per use.

    ``t`` is the slot index (``i`` the pretrain slot); shapes are the
    batched [B, N] (actions) and [n_batch, B*S] (sampler scores).  This
    default draws from one ``torch.Generator`` on the run's device."""

    def __init__(self, generator: torch.Generator):
        self.gen = generator

    @property
    def device(self):
        return self.gen.device

    def reset(self, env_cfg, num_envs: int, dtype) -> E.EnvState:
        return E.reset(env_cfg, num_envs, self.gen, dtype, self.device)

    def params(self, state_dim: int, num_actions: int, acfg,
               dtype) -> qnets.DRQN:
        return qnets.drqn_init(self.gen, state_dim, num_actions, acfg, dtype,
                               self.device)

    def _uniform(self, shape, dtype=torch.float32):
        return torch.rand(shape, generator=self.gen, dtype=dtype,
                          device=self.device)

    def _actions(self, B: int, N: int, C: int):
        return pol.random_action(self.gen, (B, N), C, self.device)

    def warmup_actions(self, env_cfg, B: int):
        return E.sample_actions(env_cfg, self.gen, B, self.device)

    def pretrain_actions(self, i: int, env_cfg, B: int):
        return E.sample_actions(env_cfg, self.gen, B, self.device)

    def explore_actions(self, t: int, B: int, N: int, C: int):
        return self._actions(B, N, C)

    def eps_greedy(self, t: int, B: int, N: int, C: int):
        """(uniform draws [B, N], random actions [B, N])."""
        return self._uniform((B, N)), self._actions(B, N, C)

    def boltzman(self, t: int, B: int, N: int, C: int):
        return self._uniform((B, N)), self._actions(B, N, C)

    def gumbel(self, t: int, B: int, N: int, C: int, dtype):
        return pol.gumbel_noise(self.gen, (B, N, C), dtype, self.device)

    def velocity_kicks(self, t: int, B: int, N: int):
        return E.velocity_kicks(self.gen, (B, N), self.device)

    def sampler_scores(self, t: int, n: int, BS: int):
        return self._uniform((n, BS))


class ShardedDraws(Draws):
    """``inner``'s draws for the env shard [start, start + count) of
    ``num_envs``: each draw along the env axis is made at ``num_envs``
    and sliced; the parameter draw and the sampler scores (global) pass
    through.  The B a caller passes is the shard's and is not used."""

    def __init__(self, inner: Draws, num_envs: int, start: int, count: int):
        self.inner, self.num_envs = inner, num_envs
        self.start, self.count = start, count

    @property
    def device(self):
        return self.inner.device

    def _cut(self, x):
        return x[self.start:self.start + self.count]

    def reset(self, env_cfg, num_envs: int, dtype) -> E.EnvState:
        s = self.inner.reset(env_cfg, self.num_envs, dtype)
        return E.EnvState(**{f.name: self._cut(getattr(s, f.name))
                             for f in dataclasses.fields(s)})

    def params(self, state_dim, num_actions, acfg, dtype):
        return self.inner.params(state_dim, num_actions, acfg, dtype)

    def warmup_actions(self, env_cfg, B: int):
        return self._cut(self.inner.warmup_actions(env_cfg, self.num_envs))

    def pretrain_actions(self, i: int, env_cfg, B: int):
        return self._cut(self.inner.pretrain_actions(i, env_cfg,
                                                     self.num_envs))

    def explore_actions(self, t: int, B: int, N: int, C: int):
        return self._cut(self.inner.explore_actions(t, self.num_envs, N, C))

    def eps_greedy(self, t: int, B: int, N: int, C: int):
        return tuple(map(self._cut, self.inner.eps_greedy(
            t, self.num_envs, N, C)))

    def boltzman(self, t: int, B: int, N: int, C: int):
        return tuple(map(self._cut, self.inner.boltzman(
            t, self.num_envs, N, C)))

    def gumbel(self, t: int, B: int, N: int, C: int, dtype):
        return self._cut(self.inner.gumbel(t, self.num_envs, N, C, dtype))

    def velocity_kicks(self, t: int, B: int, N: int):
        return self._cut(self.inner.velocity_kicks(t, self.num_envs, N))

    def sampler_scores(self, t: int, n: int, BS: int):
        return self.inner.sampler_scores(t, n, BS)


# ---------------------------------------------------------------------------
# Sampler
# ---------------------------------------------------------------------------


def sampler_collective_bytes(cfg: ExperimentConfig, dtype_bytes: int = 4):
    """Per-train-event collective volume of the cross-env window sample
    under a data-sharded mesh (diral_tpu/train/loop.py's, the same keys
    and numbers): ONE all-reduce of the gathered batch, ``n_batch *
    batch_size`` windows -- it scales with the batch, not the replay --
    which also serves as the gradient sync.  A ring all-reduce moves ~2x
    the payload per device, once per ``episode_interval`` slots."""
    acfg, env = cfg.agent, cfg.env
    step = acfg.step_size if acfg.network.use_lstm_input else 1
    gathered_elems = (acfg.n_batch * acfg.batch_size * (step + 1)
                      * env.num_users * padded_dim(env.state_space))
    payload = gathered_elems * dtype_bytes
    return {
        "gathered_elems": int(gathered_elems),
        "bytes_per_event": int(payload),
        "ring_bytes_per_device_per_event": int(2 * payload),
        "bytes_per_slot": payload / cfg.episode_interval,
    }


def is_train_event(cfg: ExperimentConfig, t: int) -> bool:
    """Whether slot ``t`` trains under the ``train_after_episode`` cadence:
    the last slot of an episode, once the replay can fill a batch."""
    I = cfg.episode_interval
    return t % I == I - 1 and t > cfg.agent.batch_size + 10


def train_events(cfg: ExperimentConfig, start: int, end: int) -> int:
    """The train events among slots [start, end) (``is_train_event``)."""
    return sum(is_train_event(cfg, t) for t in range(start, end))


def _gather_flat_windows(replay: FusedWindowReplay, scores, batch: int,
                         step: int, mesh=None):
    """``n`` independent uniform window draws across the env axis: flatten
    the (env, start) space, keep the ``batch`` lowest of each draw's
    scores [n, B*S] over the valid starts (a uniform sample without
    replacement; the reference's sampler, memory.py:177-194, with one
    env).  Returns whole windows [n*batch, step+1, N*Dp]: the mirror pad
    makes every window a contiguous slice of its env's ring.

    Under a ``mesh`` the ring holds this rank's env shard and ``scores``
    span the global B: the windows of other shards stay zero here and
    the data group's all-reduce fills them in."""
    S = replay.capacity
    B = scores.shape[1] // S
    if replay.pad < step:
        raise ValueError(f"replay mirror pad {replay.pad} < sample window "
                         f"{step}; create the replay with pad=step")
    valid = replay.count - step   # lockstep: every env holds the same count
    col = torch.arange(B * S, device=scores.device) % S
    masked = torch.where(col < valid, scores,
                         torch.full((), torch.inf, dtype=scores.dtype,
                                    device=scores.device))
    flat = torch.sort(masked, dim=1, stable=True).indices[:, :batch]
    flat = flat.reshape(-1)
    env_idx, start = flat // S, flat % S
    oldest = (replay.ptr - replay.count) % S
    base = (oldest + start) % S   # in [0, S): the mirror pad absorbs +step
    slots = base[:, None] + torch.arange(step + 1, device=base.device)
    if mesh is None or mesh.data == 1:
        return replay.buf[env_idx[:, None], slots]
    lo, count = mesh.env_slice(B)
    own = (env_idx >= lo) & (env_idx < lo + count)
    local = torch.where(own, env_idx - lo, 0)
    fw = replay.buf[local[:, None], slots]
    fw = torch.where(own[:, None, None], fw, torch.zeros((), dtype=fw.dtype,
                                                         device=fw.device))
    return pmesh.all_reduce_sum(fw, mesh)


def sample_window_rows_many(replay: FusedWindowReplay, scores, batch: int,
                            step: int, windows_only: bool = False,
                            mesh=None):
    """Window samples repacked to user-major Q-net rows (loop.py:242-310).

    ``scores`` [n, B*S] are the draws' uniform scores.  Returns per-draw
    stacks: states / next_states [n, N*batch, step*Dp] (flat padded
    windows; row r is user r // batch, the reference repack order,
    drl_drqn.py:294-377), rewards [n, N*batch, step], actions
    [n, N*batch, step] int64.  With ``windows_only`` the states /
    next_states pair is replaced by ONE ``windows`` array
    [n, N*batch, (step+1)*Dp], whose first step*Dp lanes are the states
    row and whose lanes from Dp on are the next_states row.  ``mesh``:
    see ``_gather_flat_windows``."""
    n = scores.shape[0]
    N, D = replay.num_users, replay.state_dim
    Dp = padded_dim(D)
    if replay.user_stride != Dp:
        raise ValueError(f"replay stride {replay.user_stride} != Dp {Dp}")
    W = step + 1
    fw = _gather_flat_windows(replay, scores, batch, step, mesh)
    # [n, batch, W, N, Dp] -> [n, N, batch, W, Dp]: user-major rows
    win = fw.reshape(n, batch, W, N, Dp).permute(0, 3, 1, 2, 4)
    out = {
        "rewards": win[:, :, :, :step, D].reshape(n, N * batch, step),
        "actions": win[:, :, :, :step, D + 1].reshape(n, N * batch,
                                                      step).long(),
    }
    if windows_only:
        out["windows"] = win.reshape(n, N * batch, W * Dp)
    else:
        out["states"] = win[:, :, :, :step].reshape(n, N * batch, step * Dp)
        out["next_states"] = win[:, :, :, 1:].reshape(n, N * batch,
                                                      step * Dp)
    return out


# ---------------------------------------------------------------------------
# Carry and slot functions
# ---------------------------------------------------------------------------


@dataclass
class TrainCarry:
    env_state: E.EnvState
    # flat agent-major history in the Q-net's window layout: [B, N, T*Dp],
    # step t's D features at lane offset t*Dp
    history: torch.Tensor
    state: torch.Tensor              # [B, N, D]
    replay: FusedWindowReplay        # [B, S+pad, N*Dp]
    learner: drqn.DRQNLearner        # shared across envs
    eps_state: pol.EpsGreedyState
    beta: np.float32                 # Boltzmann anneal state
    sum_ia_prev: torch.Tensor        # [B]
    ia_counter: torch.Tensor         # [B, N] int32
    prev_actions: torch.Tensor       # [B, N] int32

    def replace(self, **changes) -> "TrainCarry":
        return dataclasses.replace(self, **changes)


class TrainFunctions:
    """``make_train_functions``' result: ``init_carry(draws)``,
    ``slot_core`` / ``slot_step`` (each ``(carry, t, draws) -> (carry,
    logs)``), ``train_gate(t, replay)`` and ``train_call``.  The carry is
    updated in place where that saves memory (replay ring, learner).
    Under a ``mesh`` the carry is this rank's shard and the draws are
    ``sharded(draws)``."""

    def __init__(self, cfg: ExperimentConfig, dtype=torch.float32,
                 device=None, trace=None, mesh=None):
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        self.mesh = mesh
        env, acfg = cfg.env, cfg.agent
        # B is this rank's env shard; B_global the run's env count
        self.B_global = cfg.engine.num_envs
        self.B = (self.B_global if mesh is None
                  else mesh.env_slice(self.B_global)[1])
        self.N, self.C, self.D = (env.num_users, env.num_channels,
                                  env.state_space)
        self.T = acfg.step_size
        self.Dp = padded_dim(self.D)
        self.window = self.T if acfg.network.use_lstm_input else 1
        self.step_env = E.step_channel if cfg.enable_channel else E.step_collision
        self.pretrain_env = (self.step_env if cfg.enable_channel
                             else E.step_design)
        self.trace = (None if trace is None else
                      torch.as_tensor(np.asarray(trace), dtype=dtype,
                                      device=self.device))
        # softmax temperature anneal over total episodes (drl_drqn.py:99)
        self.softmax_schedule = pol.softmax_temperature_schedule(
            acfg.temperature, max(cfg.time_slots // cfg.episode_interval, 1))
        # bfloat16 compute stores the replay ring and the history window
        # in bf16 (loop.py:367-378); env state and carry stay ``dtype``
        self.store_dtype = (torch.bfloat16
                            if (acfg.network.compute_dtype == "bfloat16"
                                and dtype == torch.float32) else dtype)
        self.explore_until = 0 if cfg.load_model else cfg.explore
        self.greedy_after = 0 if cfg.load_model else cfg.greedy

    def sharded(self, draws: Draws) -> Draws:
        """``draws`` cut to this rank's env shard (as they are without a
        mesh that shards envs)."""
        if self.mesh is None or self.mesh.data == 1:
            return draws
        start, count = self.mesh.env_slice(self.B_global)
        return ShardedDraws(draws, self.B_global, start, count)

    # -- pieces ------------------------------------------------------------

    def qvalues(self, learner: drqn.DRQNLearner, history):
        """history [B, N, T*Dp] -> Q [B, N, A]: one forward for all agents
        of all envs.  Its dense layers are products of the rows one card
        would hold (at most ``qnets.ACT_ROWS``), so that a mesh rank's
        rows get the bits one card gives them; a run without a mesh and
        with at most that many rows keeps one product a layer."""
        B, N, T, Dp, D = self.B, self.N, self.T, self.Dp, self.D
        if self.cfg.agent.network.use_lstm_input:
            x = history.reshape(B * N, T * Dp)
        else:
            x = history[..., (T - 1) * Dp:(T - 1) * Dp + D].reshape(B * N, D)
        rows = min(qnets.ACT_ROWS, self.B_global * N)
        return qnets.drqn_apply(learner.params, x, self.cfg.agent,
                                rows).reshape(B, N, -1)

    def history_push(self, history, nxt):
        """Drop the oldest Dp lanes, append the new state padded to Dp."""
        tail = F.pad(nxt.to(history.dtype), (0, self.Dp - self.D))
        return torch.cat([history[..., self.Dp:], tail], dim=-1)

    def train_gate(self, t: int, replay: FusedWindowReplay) -> bool:
        cfg = self.cfg
        if not cfg.training:
            return False
        if cfg.train_after_episode:
            return is_train_event(cfg, t)
        # per-slot cadence gated on buffer fill (loop.py:634-640)
        enough = ((replay.count - self.window) * self.B_global
                  >= cfg.agent.batch_size)
        return t < cfg.training_stop and enough

    def train_call(self, learner, replay, t: int, draws: Draws):
        acfg = self.cfg.agent
        with spans.span("learner.sample"):
            scores = draws.sampler_scores(t, acfg.n_batch,
                                          self.B_global * replay.capacity)
            rows = sample_window_rows_many(
                replay, scores, acfg.batch_size, self.window,
                windows_only=acfg.network.use_lstm_input, mesh=self.mesh)
        return drqn.train(learner, rows, t, acfg)

    # -- init --------------------------------------------------------------

    @torch.no_grad()
    def init_carry(self, draws: Draws, learner=None) -> TrainCarry:
        """Warmup collision step (its rewards are the stale ones every
        pretrain transition stores), then the pretrain slots
        (main_test.py:89-114).  ``learner`` defaults to a fresh one from
        ``draws.params``."""
        cfg, env, acfg = self.cfg, self.cfg.env, self.cfg.agent
        B, N, C, D = self.B, self.N, self.C, self.D
        with spans.once("setup.carry"):
            with spans.once("setup.warmup"):
                env_state = draws.reset(env, B, self.dtype)
                a0 = draws.warmup_actions(env, B)
                # warmup and pretrain never replay the recorded trace: the
                # reference arms it after the pretrain loop
                # (main_test.py:118)
                env_state, obs0, rews0 = E.step_collision(env, env_state,
                                                          a0, 0)
                eps0 = float(acfg.eps_init)
                state = E.obtain_state(env, env_state, obs0, a0, rews0, 0,
                                       eps0)
            replay = FusedWindowReplay.create(
                B, cfg.memory_size, N, D, self.store_dtype, num_actions=C,
                pad=self.window, device=self.device)
            history = torch.zeros((B, N, self.T * self.Dp),
                                  dtype=self.store_dtype, device=self.device)
            with spans.once("setup.pretrain"):
                for i in range(cfg.pretrain_length * cfg.step_size * 5):
                    acts = draws.pretrain_actions(i, env, B)
                    env_state, obs, _ = self.pretrain_env(env, env_state,
                                                          acts, 0)
                    nxt = E.obtain_state(env, env_state, obs, acts, rews0,
                                         0, eps0)
                    replay.add_lockstep(state, acts, rews0)
                    history = self.history_push(history, nxt)
                    state = nxt
            if learner is None:
                learner = drqn.init_learner(
                    draws.params(D, C, acfg, self.dtype), acfg)
            return TrainCarry(
                env_state=env_state, history=history, state=state,
                replay=replay, learner=learner,
                eps_state=pol.eps_greedy_init(acfg.eps_init),
                beta=np.float32(acfg.beta),
                sum_ia_prev=torch.zeros(B, dtype=self.dtype,
                                        device=self.device),
                ia_counter=torch.zeros((B, N), dtype=torch.int32,
                                       device=self.device),
                prev_actions=torch.full((B, N), -1, dtype=torch.int32,
                                        device=self.device))

    # -- one slot ----------------------------------------------------------

    def _select(self, q, t: int, episode: int, eps_state, beta, draws):
        acfg = self.cfg.agent
        B, N, C = self.B, self.N, self.C
        if t < self.explore_until:
            return draws.explore_actions(t, B, N, C)
        if t >= self.greedy_after:
            return pol.greedy_action(q)
        if acfg.policy == "softmax":
            temp = pol.softmax_temperature(self.softmax_schedule, episode,
                                           acfg.temperature)
            return pol.softmax_action_pure(
                q, temp, draws.gumbel(t, B, N, C, q.dtype))
        if acfg.policy == "boltzman":
            draw, rand = draws.boltzman(t, B, N, C)
            return pol.boltzman_action_pure(
                q, pol.BoltzmanState(beta=beta), t, draw, rand,
                explore_start=acfg.explore_start,
                explore_stop=acfg.explore_stop, decay_rate=acfg.decay_rate,
                alpha=acfg.alpha)
        if acfg.policy == "eps_greedy":
            draw, rand = draws.eps_greedy(t, B, N, C)
            return pol.eps_greedy_action_pure(q, eps_state.eps, draw, rand)
        return pol.greedy_action(q)

    @torch.no_grad()
    def slot_core(self, carry: TrainCarry, t: int, draws: Draws):
        """One slot without the train event: inference, action selection,
        env step, shaping, replay and history update (loop.py:512-625)."""
        cfg, env, acfg = self.cfg, self.cfg.env, self.cfg.agent
        episode = t // cfg.episode_interval
        pos_pre = carry.env_state.pos_x   # logged before the step

        eps_state = carry.eps_state
        if self.explore_until <= t < self.greedy_after:
            eps_state = pol.eps_greedy_update(eps_state, episode,
                                              acfg.eps_decay, acfg.eps_min)
        beta = pol.boltzman_update(pol.BoltzmanState(beta=carry.beta),
                                   t).beta
        with spans.span("nets.act"):
            q = self.qvalues(carry.learner, carry.history)
        with spans.span("loop.select"):
            actions = self._select(q, t, episode, eps_state, beta,
                                   draws).to(torch.int32)

        with spans.span("env.step"):
            env_state, obs, rewards = self.step_env(
                env, carry.env_state, actions, t, trace=self.trace)
        with spans.span("env.state"):
            next_state = E.obtain_state(env, env_state, obs, actions,
                                        rewards, episode,
                                        float(eps_state.eps))

        with spans.span("loop.shape"):
            sum_r, shaped, sum_ia_prev, ia_counter = self._shape(
                carry, env_state, actions, rewards, t)
        with spans.span("loop.replay_add"):
            carry.replay.add_lockstep(carry.state, actions, shaped)
        with spans.span("loop.history"):
            history = self.history_push(carry.history, next_state)

        # per-episode velocity kicks at episode end (main_test.py:226-233)
        if (env.mobility_vary
                and t % cfg.episode_interval == cfg.episode_interval - 1):
            with spans.span("env.kicks"):
                env_state = E.update_velocity(
                    env, env_state, draws.velocity_kicks(t, self.B, self.N))

        carry = carry.replace(
            env_state=env_state, history=history, state=next_state,
            eps_state=eps_state, beta=beta, sum_ia_prev=sum_ia_prev,
            ia_counter=ia_counter, prev_actions=actions)
        logs = {"sum_reward": sum_r, "actions": actions,
                "eps": float(eps_state.eps),
                "pos_x": pos_pre if cfg.save_positions else None}
        return carry, logs

    def _shape(self, carry: TrainCarry, env_state, actions, rewards, t: int):
        """Reward shaping per user in the reference's order
        (main_test.py:153-206): (per-env reward sum, shaped rewards, the
        ia sums and repeat counters to carry)."""
        cfg = self.cfg
        # on the CPU cumsum adds the users in index order, as XLA's CPU
        # reduce does (torch.sum pairs them, one ULP off for PRR
        # fractions); that order holds for CPU parity with JAX only, as
        # CUDA's cumsum is a parallel scan
        sum_r = torch.cumsum(rewards, dim=1)[:, -1]
        shaped = rewards
        sum_ia_prev = carry.sum_ia_prev
        if cfg.ia_averaging:
            ia_sum = E.ia_penalty(E.information_age(env_state, t)).to(
                self.dtype)
            delta = torch.where(ia_sum > sum_ia_prev, -1.0,
                                torch.where(ia_sum < sum_ia_prev, 1.0, 0.0))
            shaped = shaped + delta[:, None].to(self.dtype)
            sum_ia_prev = ia_sum
        ia_counter = carry.ia_counter
        if cfg.ia_penalty_enable:
            repeat = (shaped < 1) & (actions == carry.prev_actions)
            ia_counter = torch.where(repeat, ia_counter + 1,
                                     torch.zeros_like(ia_counter))
            shaped = torch.where(
                ia_counter > cfg.ia_penalty_threshold,
                torch.tensor(cfg.ia_penalty_value, dtype=self.dtype,
                             device=shaped.device), shaped)
        if cfg.global_reward_avg:
            # a product with the reciprocal, as XLA rewrites x / N; the
            # quotient is one ULP away for N = 6 or 20
            shaped = shaped + (sum_r * (1.0 / self.N))[:, None]
        return sum_r, shaped, sum_ia_prev, ia_counter

    def slot_step(self, carry: TrainCarry, t: int, draws: Draws):
        """One slot with its train event when the gate opens; logs carry
        ``loss`` (a 0-dim tensor, or None on a slot without training)."""
        with spans.span("loop.slot", t=t):
            carry, logs = self.slot_core(carry, t, draws)
            loss = None
            if self.train_gate(t, carry.replay):
                with spans.span("learner.event"):
                    loss = self.train_call(carry.learner, carry.replay, t,
                                           draws)
        return carry, dict(logs, loss=loss)


def make_train_functions(cfg: ExperimentConfig, dtype=torch.float32,
                         device=None, trace=None,
                         mesh=None) -> TrainFunctions:
    """Build the training functions for ``cfg`` on ``device`` (default
    CUDA; raises without a GPU unless ``device="cpu"``).  ``trace``:
    optional [T_rec, N] recorded x positions replayed into the env (the
    reference's load_positions fixture, main_test.py:118).  ``mesh``: a
    parallel/mesh.py ``Mesh`` this process is a rank of."""
    with spans.once("setup.functions"):
        return TrainFunctions(cfg, dtype, device, trace, mesh)


def run_experiment(cfg: ExperimentConfig, seed: int | None = None,
                   num_slots: int | None = None, dtype=torch.float32,
                   device=None):
    """Build the loop and run it (loop.py:709-714): the warmup and
    pretrain, then ``num_slots`` slots (default ``time_slots``), all drawn
    from one generator seeded ``seed`` (default ``cfg.engine.seed``).
    Returns (carry, logs): the runner's host arrays (sum_reward [T, B],
    actions [T, B, N], loss [T], eps [T], pos_x with save_positions)."""
    from diral_tpu_torch.train import runner

    fns = make_train_functions(cfg, dtype, device)
    draws = Draws(torch.Generator(device=fns.device).manual_seed(
        int(cfg.engine.seed if seed is None else seed)))
    carry = fns.init_carry(draws)
    n = cfg.time_slots if num_slots is None else num_slots
    logs = {}
    for carry, _, logs in runner.run_chunks(fns, carry, draws, 0, n, n,
                                            dtype):
        pass
    return carry, logs
