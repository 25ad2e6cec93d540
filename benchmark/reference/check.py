"""The comparison that decides ``correct`` for a DRQN training cell.

The reference makes the benchmark's topology again from the seed, gets
the Q-net's initial weights as the DRQN module made them from the seed
(never the program's), and takes the random draws that were handed to
the program (``algorithms/drqn.py``).  It follows the sampled
envs through the warmup, the pretrain and every set-up slot on its own
env state, with the program's actions, judging each action against its
own Q-values; it packs its own ring rows; and it follows the learner
through the first gradient steps on the ring windows that its own
sampler picks (the ring's other envs are the program's: the reference
follows the learner step by step from the program's ring, whose rows it
checks on the sampled envs).  Numbers, each against its limit:

* ``act_gap``: over the sampled envs' set-up slots, the widest gap by
  which a greedy action's reference Q lies below the reference's best,
  as a share of that agent's Q range; an exploring action that is not
  the drawn one counts 1.
* ``env_gap``: the share of the sampled envs' ring rows (state, shaped
  reward, action) that differ from the reference's by more than 1e-5,
  or of the sampled envs whose env state at the set-up's end differs,
  whichever is larger.
* ``loss_gap``: the largest relative gap of a loss that the program's
  ``train_call`` returned (each event's last gradient step), on any rank
  of a mesh.
* ``grad_gap``: the worst leaf's gap between the norms of the first
  gradient, over the larger of that leaf's and the median leaf's
  reference norm.
* ``update_gap``: the same for the weights' change after three steps,
  over the leaves whose first reference gradient is at least a
  thousandth of the median leaf's.  Both over every rank of a mesh.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness import inputs
from benchmark.reference import drqn as ref_drqn
from benchmark.reference import env as ref_env

ROW_TOL = 1e-5
STEPS_CHECKED = 3   # gradient steps followed; the next one's loss is read
NUMBERS = ("act_gap", "env_gap", "loss_gap", "grad_gap", "update_gap")


def _pack(state, actions, rewards, Dp: int):
    """[E, N, D] state, [E, N] action and reward -> ring rows [E, N*Dp]."""
    E, N, D = state.shape
    row = torch.zeros((E, N, Dp), dtype=torch.float32, device=state.device)
    row[..., :D] = state
    row[..., D] = rewards
    row[..., D + 1] = actions.to(torch.float32)
    return row.reshape(E, N * Dp)


def _norm_gap(prog: dict, ref: dict, keep=None) -> float:
    """Worst leaf |‖prog‖ - ‖ref‖| over max(‖ref‖, median leaf ‖ref‖)."""
    names = [k for k in ref if keep is None or k in keep]
    rn = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in names}
    pn = {k: float(torch.linalg.vector_norm(prog[k].double())) for k in names}
    med = float(np.median(list(rn.values())))
    return max(abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in names)


class _Eps:
    """The eps-greedy schedule: decays once per episode advance inside
    [explore, greedy), from ``eps_init``, in float32."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.eps = np.float32(cfg.agent.eps_init)
        self.episode = 0

    def at(self, t: int):
        cfg = self.cfg
        explore = 0 if cfg.load_model else cfg.explore
        greedy = 0 if cfg.load_model else cfg.greedy
        if t < explore:
            return "explore", None
        if t >= greedy:
            return "greedy", None
        ep = t // cfg.episode_interval
        if ep > self.episode:
            self.eps = np.float32(max(self.eps * np.float32(cfg.agent.eps_decay),
                                      np.float32(cfg.agent.eps_min)))
            self.episode = ep
        return "eps", self.eps


def run(cap, cfg, device, weights: dict) -> dict:
    """The numbers of ``NUMBERS`` for one run's capture, from the Q-net's
    initial ``weights`` by leaf name."""
    ref_env.check_supported(cfg)
    ref_drqn.disable_tf32()
    f32 = torch.float32
    env, acfg = cfg.env, cfg.agent
    N, C = env.num_users, env.num_channels
    D = ref_env.state_dim(cfg)
    Dp = ref_env.padded_dim(D)
    T = acfg.step_size
    I = cfg.episode_interval
    idx = cap.envs
    E = idx.shape[0]

    def dev(x):
        return x.to(device)

    topo = [x[idx.to(x.device)].to(device)
            for x in inputs.topology(cfg, cap.seed, device)]
    s = ref_env.blank(N, *topo)
    bf16 = ref_drqn.lstm_precision(cfg, device)
    learner = ref_drqn.Learner(weights, acfg.learning_rate, acfg.gamma, T,
                               acfg.target_update, bf16)

    # warmup and pretrain (random actions, stale warmup rewards)
    a0 = dev(cap.warmup)
    s, rews0 = ref_env.step_collision(cfg, s, a0, 0)
    state = ref_env.obtain_state(cfg, s, a0)
    history = torch.zeros((E, N, T * Dp), dtype=f32, device=device)
    rows = []

    def push(history, nxt):
        tail = torch.zeros((E, N, Dp), dtype=f32, device=device)
        tail[..., :D] = nxt
        return torch.cat([history[..., Dp:], tail], dim=-1)

    for acts in cap.pretrain:
        acts = dev(acts)
        s, _ = ref_env.step_channel(cfg, s, acts, 0)
        nxt = ref_env.obtain_state(cfg, s, acts)
        rows.append(_pack(state, acts, rews0, Dp))
        history = push(history, nxt)
        state = nxt

    # the set-up slots, with the program's actions, judged
    eps = _Eps(cfg)
    act_gap = 0.0
    losses = {}
    step = 0
    grads1 = None
    after3 = None
    events = sorted(cap.ring_meta)
    for k in range(cap.slots):
        t = cap.start_slot + k
        mode, e = eps.at(t)
        acts = dev(cap.actions[k]).long()
        q = ref_drqn.qvalues(learner.p, history.reshape(E * N, T * Dp),
                             T, bf16).reshape(E, N, C)
        best = q.max(dim=-1).values
        spread = (best - q.min(dim=-1).values).clamp_min(1e-30)
        gap = (best - torch.gather(q, 2, acts[..., None])[..., 0]) / spread
        if mode != "greedy":
            u, r = (dev(x) for x in cap.eps[t])
            explored = u <= e if mode == "eps" else torch.ones_like(
                u, dtype=torch.bool)
            gap = torch.where(explored, (acts != r.long()).to(f32), gap)
        act_gap = max(act_gap, float(gap.max()))

        s, rews = ref_env.step_channel(cfg, s, acts, t)
        nxt = ref_env.obtain_state(cfg, s, acts)
        shaped = rews
        if cfg.global_reward_avg:
            shaped = rews + (rews.sum(dim=1) / N)[:, None]
        rows.append(_pack(state, acts, shaped, Dp))
        history = push(history, nxt)
        state = nxt
        if env.mobility_vary and t % I == I - 1:
            s = ref_env.kick(cfg, s, dev(cap.kicks[t]))

        if t in cap.ring_meta:
            win = dev(cap.windows[t])
            w, a, r = ref_drqn.windows_to_rows(win, N, D, Dp, T)
            for b in range(acfg.n_batch):
                step += 1
                if step <= STEPS_CHECKED:
                    loss, g = learner.loss_and_grads(w[b], a[b], r[b])
                    if step == 1:
                        grads1 = g
                    learner.adam(g)
                    if step == STEPS_CHECKED:
                        after3 = {k_: v.clone() for k_, v in learner.p.items()}
                    losses[step] = float(loss)
                elif step == STEPS_CHECKED + 1:
                    losses[step] = float(learner.loss(w[b], a[b], r[b]))
            learner.end_event(t)

    # every rank's returned losses (each event's last step's), first
    # gradients and weights after three steps
    gn = {k: float(torch.linalg.vector_norm(v.double()))
          for k, v in grads1.items()}
    med = float(np.median(list(gn.values())))
    keep = {k for k, v in gn.items() if v >= 1e-3 * med}
    p0 = {k: v.cpu() for k, v in weights.items()}
    ref_g = {k: v.cpu() for k, v in grads1.items()}
    ref_d = {k: after3[k].cpu() - p0[k] for k in p0}
    loss_gap = grad_gap = update_gap = 0.0
    for rank_losses, rank_g, rank_params in cap.ranks:
        for j, t in enumerate(events):
            ref_loss = losses.get((j + 1) * acfg.n_batch)
            if ref_loss is not None:
                loss_gap = max(loss_gap, abs(rank_losses[t] - ref_loss)
                               / max(abs(ref_loss), 1e-30))
        grad_gap = max(grad_gap, _norm_gap(rank_g, ref_g))
        update_gap = max(update_gap, _norm_gap(
            {k: rank_params[-1][k] - p0[k] for k in p0}, ref_d, keep))

    # ring rows and env state of the sampled envs
    ref_rows = torch.stack(rows, dim=1).cpu()          # [E, rows, N*Dp]
    prog_rows = cap.ring.to(f32)
    n_rows = min(ref_rows.shape[1], prog_rows.shape[1])
    diff = (prog_rows[:, :n_rows] - ref_rows[:, :n_rows]).reshape(
        E, n_rows, N, Dp)[..., :D + 2].abs()
    rows_off = (diff > ROW_TOL).any(dim=-1)
    share = float(rows_off.to(f32).mean())
    if prog_rows.shape[1] != ref_rows.shape[1]:
        share = 1.0
    env_off = torch.zeros(E, dtype=torch.bool)
    for name in ("pos_x", "pos_y", "vel", "table_x", "table_y", "table_seq",
                 "table_age", "last_arrival"):
        a = cap.env[name]
        b = getattr(s, name).cpu().to(a.dtype)
        env_off |= (a != b).reshape(E, -1).any(dim=1)
    env_gap = max(share, float(env_off.to(f32).mean()))
    return {"act_gap": act_gap, "env_gap": env_gap, "loss_gap": loss_gap,
            "grad_gap": grad_gap, "update_gap": update_gap}
