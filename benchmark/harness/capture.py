"""The set-up of a training cell, and what the check records of it.

Set-up builds the program's training functions and carry from the
benchmark's inputs (``inputs``), then drives the same object through
whole episodes from ``start_slot`` (``setup_episodes``) with the runner's
own ``run_chunks``: every train event of those episodes goes through
``train_call``.  Meanwhile it records, for the check: the random draws
handed to the program for the sampled envs, the program's actions, the
sampler's scores, each gradient step's gradients and weights (optimizer
hooks), and, at the end, the sampled envs' ring rows and env state and
the ring windows that the reference's own sampler picks.  The window
then continues the same carry with the program's plain ``Draws`` on the
same generator.

Under a data mesh every rank runs this on its env shard with the same
global draws; what a rank holds of the sampled envs and of the picked
windows is summed over the ranks with the benchmark's own collective
(never the program's), and each rank's gradients, weights and losses are
gathered, so the check judges every rank."""

from __future__ import annotations

import dataclasses
import time

import torch
import torch.distributed as dist

from benchmark.harness import inputs
from benchmark.reference import sampler as ref_sampler
from benchmark.reference.check import STEPS_CHECKED
from diral_tpu_torch.agents import drqn
from diral_tpu_torch.envs import v2v_env as E
from diral_tpu_torch.models import qnets
from diral_tpu_torch.train import runner
from diral_tpu_torch.train.loop import Draws, make_train_functions


@dataclasses.dataclass
class Capture:
    seed: int
    envs: torch.Tensor                 # sampled env ids [E]
    start_slot: int
    slots: int                         # set-up slots after the pretrain
    store_dtype: torch.dtype
    warmup: torch.Tensor = None        # [E, N]
    pretrain: list = dataclasses.field(default_factory=list)
    eps: dict = dataclasses.field(default_factory=dict)      # t -> (u, r)
    kicks: dict = dataclasses.field(default_factory=dict)    # t -> [E, N]
    scores: dict = dataclasses.field(default_factory=dict)   # t -> [n, BS]
    ring_meta: dict = dataclasses.field(default_factory=dict)  # t -> (ptr, count)
    actions: torch.Tensor = None       # [slots, E, N]
    losses: dict = dataclasses.field(default_factory=dict)   # t -> float
    grads1: dict = None                # leaf -> first gradient
    params: list = dataclasses.field(default_factory=list)   # after steps
    ranks: list = None                 # per rank: (losses, grads1, params)
    ring: torch.Tensor = None          # [E, rows, N*Dp]
    env: dict = None                   # field -> [E, ...]
    windows: dict = dataclasses.field(default_factory=dict)  # t -> [n, b, W, N*Dp]
    seconds: float = 0.0               # spent on recording, left out of set-up

    def to_host(self) -> None:
        def host(x):
            return x.cpu() if isinstance(x, torch.Tensor) else x
        self.warmup = host(self.warmup)
        self.pretrain = [host(a) for a in self.pretrain]
        self.eps = {t: tuple(map(host, v)) for t, v in self.eps.items()}
        self.kicks = {t: host(v) for t, v in self.kicks.items()}
        self.scores = {t: host(v) for t, v in self.scores.items()}
        self.grads1 = {k: host(v) for k, v in self.grads1.items()}
        self.params = [{k: host(v) for k, v in p.items()}
                       for p in self.params]


def _summed(x, mesh):
    """``x`` summed over the ranks (a rank holds zeros where it owns
    nothing); ``x`` itself without a mesh."""
    if mesh is None or mesh.data == 1:
        return x
    dist.all_reduce(x)
    return x


def _per_rank(cap: Capture, mesh) -> list:
    """Every rank's (losses, first gradients, weights after each step)."""
    mine = (cap.losses, cap.grads1, cap.params)
    if mesh is None or mesh.data == 1:
        return [mine]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, (
        mine[0], {k: v.cpu() for k, v in mine[1].items()},
        [{k: v.cpu() for k, v in p.items()} for p in mine[2]]))
    return out


def _set_up_draws(gen, topo, idx_dev, cap: Capture):
    """The program's ``Draws`` on ``gen`` with the benchmark's topology as
    its reset, recording the sampled envs' draws on the device."""

    class SetupDraws(Draws):
        def reset(self, env_cfg, num_envs, dtype):
            return E.reset_from(env_cfg, *topo, dtype, self.device)

        def warmup_actions(self, env_cfg, B):
            a = super().warmup_actions(env_cfg, B)
            cap.warmup = a[idx_dev]
            return a

        def pretrain_actions(self, i, env_cfg, B):
            a = super().pretrain_actions(i, env_cfg, B)
            cap.pretrain.append(a[idx_dev])
            return a

        def explore_actions(self, t, B, N, C):
            a = super().explore_actions(t, B, N, C)
            cap.eps[t] = (torch.zeros_like(a[idx_dev], dtype=torch.float32),
                          a[idx_dev])
            return a

        def eps_greedy(self, t, B, N, C):
            u, r = super().eps_greedy(t, B, N, C)
            cap.eps[t] = (u[idx_dev], r[idx_dev])
            return u, r

        def velocity_kicks(self, t, B, N):
            k = super().velocity_kicks(t, B, N)
            cap.kicks[t] = k[idx_dev]
            return k

        def sampler_scores(self, t, n, BS):
            s = super().sampler_scores(t, n, BS)
            cap.scores[t] = s.clone()
            return s

    return SetupDraws(gen)


def program_config(cfg_file_cfg, traffic: dict, overrides: dict | None):
    """The configuration as the cell runs it: the config file's, with the
    traffic's env count and nothing written to disk; ``overrides`` (tests
    and the readings tool) replace top-level, agent, network or engine
    fields by name."""
    cfg = dataclasses.replace(
        cfg_file_cfg, save_results=False, save_model=False,
        save_positions=False,
        engine=dataclasses.replace(cfg_file_cfg.engine,
                                   num_envs=int(traffic["num_envs"])))
    for key, value in (overrides or {}).items():
        group, _, leaf = key.rpartition(".")
        if group == "":
            cfg = dataclasses.replace(cfg, **{leaf: value})
        elif group == "agent":
            cfg = dataclasses.replace(
                cfg, agent=dataclasses.replace(cfg.agent, **{leaf: value}))
        elif group == "network":
            cfg = dataclasses.replace(cfg, agent=dataclasses.replace(
                cfg.agent, network=dataclasses.replace(
                    cfg.agent.network, **{leaf: value})))
        elif group == "engine":
            cfg = dataclasses.replace(
                cfg, engine=dataclasses.replace(cfg.engine, **{leaf: value}))
        else:
            raise KeyError(f"bad override {key!r}")
    return cfg


def learner_from(weights: dict, acfg):
    """The program's learner around a copy of the benchmark's weights."""
    tree = {}
    for leaf, value in weights.items():
        group, name = leaf.split(".")
        tree.setdefault(group, {})[name] = value.clone()
    return drqn.init_learner(qnets.DRQN(tree, acfg), acfg)


def setup_episodes(cfg) -> int:
    """Whole episodes of the set-up: a train event an episode, each of
    ``n_batch`` gradient steps, enough for the check's steps and the next
    one's loss, and at least two events."""
    return max(2, -(-(STEPS_CHECKED + 1) // cfg.agent.n_batch))


def set_up(cfg, seed: int, device, start_slot: int,
           chunk: int | None = None, mesh=None):
    """Build and drive the program through its set-up (on this rank's env
    shard under ``mesh``).  Returns (fns, carry, draws for the window,
    next slot, Capture)."""
    I = cfg.episode_interval
    if start_slot % I:
        raise ValueError(f"start_slot {start_slot} is not an episode start")
    fns = make_train_functions(cfg, torch.float32, device, mesh=mesh)
    idx = inputs.check_envs(fns.B_global, seed)
    idx_dev = idx.to(device)
    cap = Capture(seed=seed, envs=idx, start_slot=start_slot,
                  slots=setup_episodes(cfg) * I, store_dtype=fns.store_dtype)
    topo = inputs.topology(cfg, seed, device)
    gen = inputs.draws_generator(seed, device)
    draws = fns.sharded(_set_up_draws(gen, topo, idx_dev, cap))
    learner = learner_from(inputs.weights(cfg, seed, device), cfg.agent)
    carry = fns.init_carry(draws, learner=learner)
    named = dict(learner.params.named_parameters())

    # gradient steps: the first one's gradients, the weights after each
    def pre(opt, args, kwargs):
        if cap.grads1 is None:
            cap.grads1 = {n: p.grad.detach().clone()
                          for n, p in named.items()}

    def post(opt, args, kwargs):
        if len(cap.params) < STEPS_CHECKED:
            cap.params.append({n: p.detach().clone()
                               for n, p in named.items()})

    hooks = [learner.opt.register_step_pre_hook(pre),
             learner.opt.register_step_post_hook(post)]
    train_call = fns.train_call

    def recorded_train_call(learner_, replay, t, draws_):
        cap.ring_meta[t] = (replay.ptr, replay.count)
        return train_call(learner_, replay, t, draws_)

    fns.train_call = recorded_train_call
    end = start_slot + cap.slots
    actions = []
    for carry, after, logs in runner.run_chunks(
            fns, carry, draws, start_slot, end, chunk or cap.slots,
            torch.float32):
        actions.append(torch.as_tensor(logs["actions"])[:, idx])
        for k, loss in enumerate(logs["loss"]):
            t = after - len(logs["loss"]) + k
            if t in cap.ring_meta:
                cap.losses[t] = float(loss)
    del fns.train_call
    for h in hooks:
        h.remove()
    cap.actions = torch.cat(actions)
    if len(cap.params) < STEPS_CHECKED or len(cap.ring_meta) < 2:
        raise RuntimeError("the set-up ran too few train events for the "
                           "check")

    # the sampled envs' ring and state, and the windows the reference's
    # sampler picks at each event: the ring has not wrapped yet, so each
    # event's windows still lie where they were
    started = time.perf_counter()
    replay = carry.replay
    if replay.count != replay.ptr:
        raise RuntimeError("the set-up's ring wrapped; shorten the set-up")
    lo, count_here = (0, fns.B) if mesh is None else mesh.env_slice(
        fns.B_global)
    own = (idx_dev >= lo) & (idx_dev < lo + count_here)
    local = torch.where(own, idx_dev - lo, 0)

    def held(x):
        """The sampled envs' rows of the env-axis tensor ``x``."""
        mask = own.reshape((-1,) + (1,) * (x.dim() - 1))
        return _summed(torch.where(mask, x[local], torch.zeros_like(
            x[local])), mesh).cpu()

    cap.ring = held(replay.buf[:, :replay.count])
    cap.env = {f.name: held(getattr(carry.env_state, f.name))
               for f in dataclasses.fields(carry.env_state)}
    step = fns.window
    for t, (ptr, count) in cap.ring_meta.items():
        env_ids, slots = ref_sampler.pick(
            cap.scores[t], replay.capacity, ptr, count, step,
            cfg.agent.batch_size)
        mine = (env_ids >= lo) & (env_ids < lo + count_here)
        w = replay.buf[torch.where(mine, env_ids - lo, 0)[:, :, None],
                       slots]
        cap.windows[t] = _summed(torch.where(
            mine[:, :, None, None], w, torch.zeros_like(w)), mesh).cpu()
    cap.to_host()
    cap.ranks = _per_rank(cap, mesh)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    cap.seconds = time.perf_counter() - started
    return fns, carry, fns.sharded(Draws(gen)), end, cap
