"""DRQN training, the loop that ``python -m diral_tpu_torch train`` runs:
the benchmark's algorithm module for configurations whose
``RLAgent.algorithm`` is ``DRQN``.

The harness's core (``harness/cell.py``) knows no agent.  ``spec.cell``
loads ``benchmark/algorithms/<algorithm>.py`` by path, the configuration's
``RLAgent.algorithm`` in lower case, and the core drives the program
through it.  A module gives:

* ``TRAFFIC_KEYS``: the keys its traffic files may hold beyond the
  core's (``why``, ``mesh``, ``num_envs``);
* ``LIMITS``: the names of its check numbers, in the result's order; a
  cell's ``checks/<cell>.json`` names exactly these;
* ``supported(cfg)``: raises on what its reference does not cover;
* ``weights(cfg, seed, device)``: the seeded inputs that both the program
  and the reference get (the core's ``inputs`` makes the rest);
* ``set_up(cfg, traffic, seed, device, mesh)``: builds the program's own
  object through its normal entry point, drives it through the set-up,
  and returns a session;
* ``check(capture, cfg, device)``: the numbers of ``LIMITS``, from the
  session's ``capture``;
* ``CONTROL``, ``faults(mesh)`` and ``planted(fault)``: the overrides of
  the lower-precision control, the faults that ``tools/readings.py``
  plants, and the context that plants one.

A session gives the core, in the program's own grain (slots here):
``capture`` (its ``seconds``, spent on recording, are left out of
set-up), ``shapes`` (the readers' ``ctx.shapes``), ``start`` (the
window's first slot), ``envs`` (env-slots a slot, over every rank),
``layers`` (the names of the layer spans), ``profiles`` (the two
profiled ranges of slots, each [first, end)), ``episode_end(s)``,
``steps(before, after)`` (the window's steps, each ending on a sync:
calls ``before(s)`` and ``after(s)`` around each slot and yields the slot
after the step), ``events(lo, hi)`` (train events in [lo, hi)),
``wrap_layers(spans)`` (the layer spans of a traced run; returns the
undo) and ``close()`` (frees the program's state before the check).

DRQN's set-up builds the program's training functions and carry from
the benchmark's inputs, then drives the same object through whole
episodes from the traffic's ``start_slot`` (``setup_episodes``) with the
runner's own ``run_chunks``: every train event of those episodes goes
through ``train_call``.  Meanwhile it records, for the check: the random
draws handed to the program for the sampled envs, the program's actions,
the sampler's scores, each gradient step's gradients and weights
(optimizer hooks), and, at the end, the sampled envs' ring rows and env
state and the ring windows that the reference's own sampler picks.  The
window then continues the same carry with the program's plain ``Draws``
on the same generator, in chunks of the traffic's ``chunk_slots``.

Under a data mesh every rank runs this on its env shard with the same
global draws; what a rank holds of the sampled envs and of the picked
windows is summed over the ranks with the benchmark's own collective
(never the program's), and each rank's gradients, weights and losses are
gathered, so the check judges every rank."""

from __future__ import annotations

import contextlib
import dataclasses
import time

import torch
import torch.distributed as dist

from benchmark.harness import inputs
from benchmark.reference import check as ref_check
from benchmark.reference import drqn as ref_drqn
from benchmark.reference import env as ref_env
from benchmark.reference import sampler as ref_sampler
from benchmark.reference.check import STEPS_CHECKED
from diral_tpu_torch.agents import drqn
from diral_tpu_torch.envs import v2v_env as E
from diral_tpu_torch.models import qnets
from diral_tpu_torch.parallel import mesh as pmesh
from diral_tpu_torch.train import runner
from diral_tpu_torch.train.loop import Draws, make_train_functions

TRAFFIC_KEYS = ("chunk_slots", "start_slot")
LIMITS = ref_check.NUMBERS
# the lower-precision control: the program's own bf16 path
CONTROL = {"network.compute_dtype": "bfloat16"}
FAR = 10 ** 12   # the window's nominal end: it stops on time, not on slots


def supported(cfg) -> None:
    ref_env.check_supported(cfg)


def weights(cfg, seed: int, device) -> dict:
    """The Q-net's initial weights by leaf name (reference.drqn.LEAVES)."""
    layers = cfg.agent.network.layers
    return ref_drqn.make_weights(inputs.generator(seed, 2, device),
                                 ref_env.state_dim(cfg), cfg.env.num_channels,
                                 layers[0], layers[1], device)


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


def drive_set_up(cfg, seed: int, device, start_slot: int,
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
    learner = learner_from(weights(cfg, seed, device), cfg.agent)
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


def shapes(cfg, fns) -> dict:
    acfg = cfg.agent
    return {"B": fns.B, "B_global": fns.B_global, "N": fns.N, "C": fns.C,
            "D": fns.D, "Dp": fns.Dp, "T": fns.T,
            "H1": acfg.network.layers[0], "H2": acfg.network.layers[1],
            "batch": acfg.batch_size, "n_batch": acfg.n_batch,
            "interval": cfg.episode_interval}


def _wrap_layers(fns, spans):
    """Instance and module attributes that time the layer calls (the
    acting forward, the env step with the state assembly, the train
    event, and a ``bench.lstm_fwd`` range around the LSTM inside the
    acting forward); returns the undo."""
    qvalues, step_env, train_call = fns.qvalues, fns.step_env, fns.train_call
    obtain_state, lstm_last = E.obtain_state, getattr(qnets, "_lstm_last",
                                                      None)

    def timed_qvalues(*a, **k):
        spans.begin("act")
        out = qvalues(*a, **k)
        spans.end("act")
        return out

    def timed_step_env(*a, **k):
        spans.begin("env")
        return step_env(*a, **k)

    def timed_obtain_state(*a, **k):
        out = obtain_state(*a, **k)
        if "env" in spans.open:
            spans.end("env")
        return out

    def timed_train_call(*a, **k):
        spans.begin("train")
        out = train_call(*a, **k)
        spans.end("train")
        return out

    def ranged_lstm(*a, **k):
        with torch.profiler.record_function("bench.lstm_fwd"):
            return lstm_last(*a, **k)

    fns.qvalues, fns.step_env = timed_qvalues, timed_step_env
    fns.train_call = timed_train_call
    E.obtain_state = timed_obtain_state
    if lstm_last is not None:
        qnets._lstm_last = ranged_lstm

    def undo():
        del fns.qvalues, fns.train_call
        fns.step_env = step_env
        E.obtain_state = obtain_state
        if lstm_last is not None:
            qnets._lstm_last = lstm_last
    return undo


class Session:
    """The program after its set-up, as the core's window drives it: the
    runner's chunks from the set-up's carry; the profiles take two
    episodes each from the window's second episode."""

    layers = ("act", "env", "train")

    def __init__(self, cfg, fns, carry, draws, start: int, chunk: int,
                 cap: Capture):
        self.fns, self.carry, self.draws = fns, carry, draws
        self.capture = cap
        self.start, self.chunk = start, chunk
        self.interval = I = cfg.episode_interval
        self.shapes = shapes(cfg, fns)
        self.envs = fns.B_global
        traced = 2 * I
        self.profiles = ((start + I, start + I + traced),
                         (start + I + traced, start + I + 2 * traced))

    def episode_end(self, s: int) -> bool:
        return s % self.interval == self.interval - 1

    def steps(self, before, after):
        fns = self.fns
        slot_step = fns.slot_step

        def window_slot_step(carry_, s, draws_):
            before(s)
            out = slot_step(carry_, s, draws_)
            after(s)
            return out

        fns.slot_step = window_slot_step
        try:
            for self.carry, t, _ in runner.run_chunks(
                    fns, self.carry, self.draws, self.start, FAR, self.chunk,
                    torch.float32):
                yield t
        finally:
            del fns.slot_step

    def events(self, lo: int, hi: int) -> int:
        return sum(1 for s in range(lo, hi)
                   if self.fns.train_gate(s, self.carry.replay))

    def wrap_layers(self, spans):
        return _wrap_layers(self.fns, spans)

    def close(self) -> None:
        self.fns = self.carry = self.draws = None


def set_up(cfg, traffic: dict, seed: int, device, mesh=None) -> Session:
    fns, carry, draws, t, cap = drive_set_up(
        cfg, seed, device, int(traffic["start_slot"]), mesh=mesh)
    return Session(cfg, fns, carry, draws, t, int(traffic["chunk_slots"]),
                   cap)


def check(capture: Capture, cfg, device) -> dict:
    return ref_check.run(capture, cfg, device,
                         weights(cfg, capture.seed, device))


def faults(mesh) -> tuple:
    """The faults that the readings plant: ``half_batch`` (the loss's
    mean over half of each batch), ``reward`` (the env step's reward of
    each env's first vehicle moved by 0.5 where it is produced), and on a
    data mesh ``exchange`` (the window batch's all-reduce between the
    cards left out).  ``planted`` also takes ``unchanged`` (a gradient
    step that leaves the weights unchanged), which reads 1 in
    ``update_gap`` by that number's definition and needs no reading."""
    return ("half_batch", "reward") + (("exchange",) if mesh else ())


@contextlib.contextmanager
def planted(fault: str | None):
    """The program with ``fault`` planted for the duration."""
    if fault is None:
        yield
        return
    if fault == "half_batch":
        orig = drqn._td_loss

        def half(q, actions, targets, cfg):
            n = q.shape[0] // 2
            return orig(q[:n], actions[:n], targets[:n], cfg)
        drqn._td_loss = half
        try:
            yield
        finally:
            drqn._td_loss = orig
    elif fault == "reward":
        orig = E.step_channel

        def altered(cfg, state, actions, t, trace=None):
            state, obs, rews = orig(cfg, state, actions, t, trace)
            rews = rews.clone()
            rews[:, 0] += 0.5
            return state, obs, rews
        E.step_channel = altered
        try:
            yield
        finally:
            E.step_channel = orig
    elif fault == "exchange":
        orig = pmesh.all_reduce_sum
        pmesh.all_reduce_sum = lambda x, mesh: x
        try:
            yield
        finally:
            pmesh.all_reduce_sum = orig
    elif fault == "unchanged":
        orig = torch.optim.Adam.step

        def no_step(self, closure=None):
            return None
        torch.optim.Adam.step = no_step
        try:
            yield
        finally:
            torch.optim.Adam.step = orig
    else:
        raise ValueError(f"unknown fault {fault!r}")
