"""Batched V2V resource-selection environment in PyTorch
(diral_tpu/envs/v2v_env.py; reference envs/test_env.py,
envs/network.py, envs/vehicle.py).

``EnvState`` is a dataclass of [B, ...] tensors with the env axis written
out where the JAX package vmaps; every step flavour is a function
``(cfg, state, actions, t) -> (state', obs, rew)``.  Semantics are the
JAX package's, which are the NumPy oracle's: in float64 on the CPU the
two agree bit for bit (tests/test_torch_env.py).

Vectorisation map (reference construct -> here): the per-channel
collision scan -> one-hot actions and per-channel masked reductions;
``find_closest_tx`` -> first-occurrence argmin over [B, N, N] distances;
neighbour-table dicts -> [B, N, N] tables with seq-gated merges;
``np.histogram`` -> ops/histogram.py membership against the exact edges.
Channels are walked in order because a merge on one channel feeds the
next through the live tables (vehicle.py:61).

Kernels (on a CUDA device, under the JAX package's gates):
``step_channel``'s channel walk -> ops/channel_phase.py (K5), the type-2
positional distribution -> ops/piggy_hist.py (K6), or, under
``hist_impl="lanes"`` at N*N <= 128 in float32, its count histogram ->
ops/lanes_hist.py (K7).  ``state_generator`` is the DQN-era [N, 2C+1]
state, which no training path calls; ``reset_fixed_4ue`` the reference's
4-vehicle fixture; ``get_step_fn`` the step flavour main_test.py picks.

Random functions (``update_velocity``) take their draws as tensors; the
draws themselves come from the caller's generator (``sample_actions``,
``velocity_kicks``).

Known deviations are the JAX package's (v2v_env.py:32-44): piggybacking
observations are served in the repaired fixed width, and ``state_type 1``
with no in-range transmitter skips the merge.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from diral_tpu_torch.config import EnvConfig
from diral_tpu_torch.ops.channel_phase import (channel_phase,
                                               channel_phase_plain,
                                               closest_tx, merge_rows)
from diral_tpu_torch.ops.distance import pairwise_distances, signed_dx, sqrt
from diral_tpu_torch.ops.histogram import (masked_count_histogram,
                                           masked_weighted_histogram)
from diral_tpu_torch.ops.lanes_hist import MAX_ROW_PAIRS, lanes_histogram
from diral_tpu_torch.ops.piggy_hist import piggy_histogram

STALENESS_CUTOFF = 20
IA_HORIZON = 100
PF_THRESHOLD = 10
PF_PENALTY = -10.0


@dataclass
class EnvState:
    """World state of B env instances (reference Vehicle/Network graph:
    vehicle.py:9-33, network.py:38-42, test_env.py:77-92).  Row i of a
    table is vehicle i's knowledge of vehicle j."""

    pos_x: torch.Tensor         # [B, N] float
    pos_y: torch.Tensor         # [B, N] float
    vel: torch.Tensor           # [B, N] float
    direction: torch.Tensor     # [B, N] float, +1 right / -1 left
    table_x: torch.Tensor       # [B, N, N] float
    table_y: torch.Tensor       # [B, N, N] float
    table_seq: torch.Tensor     # [B, N, N] int32
    table_age: torch.Tensor     # [B, N, N] int32
    last_arrival: torch.Tensor  # [B, N, N] int32, (tx, rx), -1 = never
    prev_obs: torch.Tensor      # [B, N, C] float
    pf_counter: torch.Tensor    # [B, N] int32

    def replace(self, **changes) -> "EnvState":
        return dataclasses.replace(self, **changes)


# ---------------------------------------------------------------------------
# Construction
# ---------------------------------------------------------------------------


def _blank_state(cfg: EnvConfig, pos_x, pos_y, vel, direction, dtype,
                 device) -> EnvState:
    n, c = cfg.num_users, cfg.num_channels

    def ten(v):
        return torch.as_tensor(v, dtype=dtype, device=device).clone()

    pos_x = ten(pos_x)
    b = pos_x.shape[0]
    i32 = torch.int32
    return EnvState(
        pos_x=pos_x, pos_y=ten(pos_y), vel=ten(vel), direction=ten(direction),
        table_x=torch.zeros((b, n, n), dtype=dtype, device=device),
        table_y=torch.zeros((b, n, n), dtype=dtype, device=device),
        table_seq=torch.zeros((b, n, n), dtype=i32, device=device),
        table_age=torch.zeros((b, n, n), dtype=i32, device=device),
        last_arrival=torch.full((b, n, n), -1, dtype=i32, device=device),
        prev_obs=torch.zeros((b, n, c), dtype=dtype, device=device),
        pf_counter=torch.zeros((b, n), dtype=i32, device=device),
    )


def reset(cfg: EnvConfig, num_envs: int, generator: torch.Generator,
          dtype=torch.float32, device=None) -> EnvState:
    """Topology init with the reference's distributions and gating
    (network.py:92-119): integer x in [0, L), integer y in [0, H//2) (0
    when H < 2), speed U(1.1, 2.7) (1.7 under mobility_vary), all moving
    right; randomised only when mobility or the design topology is on.
    Draws come from ``generator`` (on ``device``)."""
    n, b = cfg.num_users, num_envs
    shape = (b, n)
    if cfg.enable_design_topology:
        xs = torch.tensor([0, 195, 390, 585, 780, 975][:n], dtype=dtype)
        ys = torch.tensor([1, 1, 2, 2, 2, 2][:n], dtype=dtype)
        one = torch.ones(shape, dtype=dtype)
        return _blank_state(cfg, xs.expand(shape), ys.expand(shape), one,
                            one, dtype, device)
    if not cfg.mobility:
        z = torch.zeros(shape, dtype=dtype)
        return _blank_state(cfg, z, z, z, torch.ones(shape, dtype=dtype),
                            dtype, device)

    def randint(high):
        return torch.randint(0, high, shape, generator=generator,
                             device=device).to(dtype)

    pos_x = randint(cfg.highway_length)
    half_h = cfg.highway_height // 2
    pos_y = randint(half_h) if half_h >= 1 else torch.zeros(
        shape, dtype=dtype, device=device)
    if cfg.mobility_vary:
        vel = torch.full(shape, 1.7, dtype=dtype, device=device)
    else:
        vel = torch.empty(shape, dtype=dtype, device=device).uniform_(
            1.1, 2.7, generator=generator)
    return _blank_state(cfg, pos_x, pos_y, vel,
                        torch.ones(shape, dtype=dtype), dtype, device)


def reset_from(cfg: EnvConfig, pos_x, pos_y, vel, direction,
               dtype=torch.float32, device=None) -> EnvState:
    """Inject exact topologies ([B, N] each; oracle-parity entry point)."""
    return _blank_state(cfg, pos_x, pos_y, vel, direction, dtype, device)


def reset_fixed_4ue(cfg: EnvConfig, num_envs: int = 1, dtype=torch.float32,
                    device=None) -> EnvState:
    """The deterministic 4-vehicle fixture (network.py:81-90), in every
    one of ``num_envs`` envs."""
    def rows(v):
        return torch.tensor([v] * num_envs, dtype=dtype)
    return _blank_state(cfg, rows([3.0, 5.0, 3.0, 5.0]),
                        rows([1.0, 1.0, 2.0, 2.0]),
                        rows([0.5, 1.0, 1.25, 1.5]),
                        rows([1.0, 1.0, 1.0, 1.0]), dtype, device)


def sample_actions(cfg: EnvConfig, generator: torch.Generator,
                   num_envs: int, device=None):
    """Uniform random action per user (test_env.py:116-122). [B, N]."""
    return torch.randint(0, cfg.num_channels, (num_envs, cfg.num_users),
                         generator=generator, device=device)


# ---------------------------------------------------------------------------
# Internal building blocks
# ---------------------------------------------------------------------------


def one_hot_actions(actions, c: int):
    """[..., C] int64 one-hot rows of channel ids.  An id outside [0, C)
    gives a zero row, i.e. no transmission, as ``jax.nn.one_hot`` does in
    the JAX env: the feedforward DRQN's greedy eval takes its argmax over
    T * C ids (evaluate.py:115-118)."""
    return (actions.long()[..., None]
            == torch.arange(c, device=actions.device)).long()


def _eye(n, device):
    return torch.eye(n, dtype=torch.bool, device=device)


def _periodic_update(state: EnvState) -> EnvState:
    """All vehicles refresh their own table entry and age the rest
    (network.py:587-593 -> vehicle.py:56-70)."""
    eye = _eye(state.table_x.shape[-1], state.table_x.device)
    return state.replace(
        table_x=torch.where(eye, state.pos_x[:, :, None], state.table_x),
        table_y=torch.where(eye, state.pos_y[:, :, None], state.table_y),
        table_seq=state.table_seq + eye.to(state.table_seq.dtype),
        table_age=torch.where(eye, torch.zeros_like(state.table_age),
                              state.table_age + 1),
    )


def _merge_tables(state: EnvState, rx_mask, tx_ids) -> EnvState:
    """Receivers in ``rx_mask`` merge tx_ids' live table rows where the
    source sequence number is strictly newer (vehicle.py:35-47)."""
    tx, ty, ts, ta = merge_rows(state.table_x, state.table_y,
                                state.table_seq, state.table_age,
                                rx_mask, tx_ids)
    return state.replace(table_x=tx, table_y=ty, table_seq=ts, table_age=ta)


def _norm_distance(pos_x, D):
    """Distance between the (first) min-x and max-x vehicles
    (network.py:225-246). [B]."""
    bidx = torch.arange(D.shape[0], device=D.device)
    return D[bidx, pos_x.argmin(dim=1), pos_x.argmax(dim=1)]


def _collision_reward(cfg: EnvConfig, D, norm_d, tx_mask, tot, dtype):
    """Shared reward for >=2 colliders on one channel (test_env.py:170-197
    designs 1-5; weight semantics network.py:273-300). [B]."""
    tot_f = tot.to(dtype)
    pair = tx_mask[:, :, None] & tx_mask[:, None, :]
    sum_d = torch.where(pair, D, torch.zeros((), dtype=dtype,
                                             device=D.device)).sum((1, 2)) / 2
    npairs = (tot * (tot - 1) // 2).to(dtype)
    m = sum_d / npairs  # nan/inf when <2 colliders; always masked downstream
    if cfg.congestion_test:
        w = (m == norm_d).to(dtype)
    else:
        w = (m > cfg.communication_range).to(dtype)
    design = cfg.reward_design
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
    raise ValueError(f"reward_design {design} undefined")


def _mod(x, m: float):
    """``jnp.mod`` for floats: truncated remainder moved to m's sign."""
    r = torch.fmod(x, m)
    return torch.where((r != 0) & ((r < 0) != (m < 0)), r + m, r)


def _advance_mobility(cfg: EnvConfig, state: EnvState, t,
                      trace=None) -> EnvState:
    """Modular x-advance, or recorded-trace replay: ``trace`` [T_rec, N']
    x positions, row t % T_rec for every env (network.py:189-206)."""
    if not cfg.mobility:
        return state
    if trace is not None:
        row = trace[t % trace.shape[0]][: cfg.num_users].to(state.pos_x)
        return state.replace(pos_x=row.expand_as(state.pos_x).contiguous())
    L = float(cfg.highway_length)
    return state.replace(
        pos_x=_mod(state.pos_x + state.direction * state.vel + L, L))


def velocity_kicks(generator: torch.Generator, shape, device=None):
    """Draws for ``update_velocity``: ints uniform in {1, 2, 3}."""
    return torch.randint(1, 4, shape, generator=generator, device=device)


def update_velocity(cfg: EnvConfig, state: EnvState, kicks) -> EnvState:
    """Per-episode velocity kicks: +-0.55 where ``kicks`` is 1 / 2 (each of
    {1, 2, 3} with prob 1/3), clamped to [1.1, 2.77] (network.py:208-223);
    active only under mobility_vary (test_env.py:498-504)."""
    if not cfg.mobility_vary:
        return state
    vel = state.vel
    new = torch.where(kicks == 1, torch.clamp(vel + 0.55, max=2.77), vel)
    new = torch.where(kicks == 2, torch.clamp(vel - 0.55, min=1.1), new)
    return state.replace(vel=new)


# ---------------------------------------------------------------------------
# Step flavours
# ---------------------------------------------------------------------------


def step_collision(cfg: EnvConfig, state: EnvState, actions, t, trace=None):
    """``my_step`` semantics (test_env.py:124-266): per-channel collision
    rewards shared among colliders, half-duplex observations, piggyback
    merges from the closest transmitter, then mobility.  ``actions``:
    [B, N] ints.  With ``piggybacking`` the obs is the repaired fixed
    width [B, N, C*C] (v2v_env.py:344-365)."""
    st = cfg.state
    n, c = cfg.num_users, cfg.num_channels
    dtype, dev = state.pos_x.dtype, state.pos_x.device
    b = state.pos_x.shape[0]
    acts = one_hot_actions(actions, c)            # [B, N, C]
    piggy = st.piggybacking
    zero = torch.zeros((), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)

    if st.add_positional_dist_piggy:
        state = _periodic_update(state)
    prev_obs_in = state.prev_obs.to(dtype)  # pre-step snapshot

    D = pairwise_distances(state.pos_x, state.pos_y)
    norm_d = _norm_distance(state.pos_x, D)
    tx_counts = acts.sum(dim=1)                  # [B, C]
    R = cfg.communication_range

    la, pf = state.last_arrival, state.pf_counter
    rews = torch.zeros((b, n), dtype=dtype, device=dev)
    obs = torch.zeros((b, n, c), dtype=dtype, device=dev)
    blocks = torch.zeros((b, n, c, c), dtype=dtype, device=dev) if piggy else None
    for ch in range(c):
        txm = acts[:, :, ch] == 1
        tot = tx_counts[:, ch]
        invoked = ~txm & (tot > 0)[:, None]

        rewards_ch = _collision_reward(cfg, D, norm_d, txm, tot, dtype)
        cd, cid, has = closest_tx(D, txm, R)

        rx_obs = torch.where(invoked, one if st.type == 1 else cd, zero)
        obs[:, :, ch] = torch.where(txm, zero, rx_obs)

        r_tx = torch.where(tot > 1, rewards_ch, one)
        rews = torch.where(txm, r_tx[:, None], rews)
        if cfg.proportional_fair:
            coll = txm & (tot > 1)[:, None]
            rews = torch.where(coll & (pf > PF_THRESHOLD),
                               torch.full_like(rews, PF_PENALTY), rews)
            pf = torch.where(coll, pf + 1,
                             torch.where(txm & (tot == 1)[:, None],
                                         torch.zeros_like(pf), pf))

        # find_closest_tx side effect: out-of-range (tx, rx) pairs reset to
        # -1 for every receiver that scanned (network.py:394)
        oor = txm[:, :, None] & invoked[:, None, :] & (D >= R)
        la = torch.where(oor, torch.full_like(la, -1), la)

        if st.add_positional_dist_piggy:
            state = _merge_tables(state, invoked & has, cid)
        if piggy and st.type == 2:
            payload = torch.gather(prev_obs_in, 1,
                                   cid[:, :, None].expand(-1, -1, c))
            blocks[:, :, ch] = torch.where((invoked & has)[:, :, None],
                                           payload, zero)

    state = state.replace(last_arrival=la, pf_counter=pf)
    if piggy:
        base = obs if st.type == 2 else torch.zeros_like(obs)
        # compact [B, N, C, C] -> [B, N, C-1, C]: drop each user's own block
        k = torch.arange(c - 1, device=dev)[None, None, :]
        src = k + (k >= actions.long()[:, :, None]).long()     # [B, N, C-1]
        picked = torch.gather(blocks, 2, src[..., None].expand(-1, -1, -1, c))
        obs_out = torch.cat([base, picked.reshape(b, n, (c - 1) * c)], dim=2)
        state = state.replace(prev_obs=obs.to(state.prev_obs.dtype))
    else:
        obs_out = obs
    state = _advance_mobility(cfg, state, t, trace)
    return state, obs_out, rews


def step_design(cfg: EnvConfig, state: EnvState, actions, t, trace=None):
    """``my_step_design`` semantics (test_env.py:269-349): rewards scoped to
    the transmitters within 2x communication range of each collider."""
    st = cfg.state
    n, c = cfg.num_users, cfg.num_channels
    dtype, dev = state.pos_x.dtype, state.pos_x.device
    b = state.pos_x.shape[0]
    acts = one_hot_actions(actions, c)
    zero = torch.zeros((), dtype=dtype, device=dev)
    one = torch.ones((), dtype=dtype, device=dev)

    if st.add_positional_dist_piggy:
        state = _periodic_update(state)

    D = pairwise_distances(state.pos_x, state.pos_y)
    two_r = 2 * cfg.communication_range
    R = cfg.communication_range
    not_eye = ~_eye(n, dev)
    la = state.last_arrival
    rews = torch.zeros((b, n), dtype=dtype, device=dev)
    obs = torch.zeros((b, n, c), dtype=dtype, device=dev)
    for ch in range(c):
        txm = acts[:, :, ch] == 1
        tot = txm.sum(dim=1)
        invoked = ~txm & (tot > 0)[:, None]

        # comm_range_tx per transmitter u: itself + other transmitters
        # within 2R (test_env.py:327-334)
        near = txm[:, None, :] & (D < two_r) & not_eye       # [B, u, v]
        cnt = 1 + near.sum(dim=2)
        pair_d = torch.where(near, D, zero).sum(dim=2)
        w2 = (pair_d > two_r).to(dtype)
        cnt_f = cnt.to(dtype)
        r_coll = torch.where(cnt == 1, one,
                             torch.where(cnt == 2,
                                         torch.where(w2 == 1.0, zero, -cnt_f),
                                         -cnt_f))
        r_tx = torch.where((tot == 1)[:, None], one, r_coll)
        rews = torch.where(txm, r_tx, rews)
        obs[:, :, ch] = torch.where(txm, zero, torch.where(invoked, one, zero))

        _, cid, has = closest_tx(D, txm, R)
        oor = txm[:, :, None] & invoked[:, None, :] & (D >= R)
        la = torch.where(oor, torch.full_like(la, -1), la)
        if st.add_positional_dist_piggy:
            state = _merge_tables(state, invoked & has, cid)
    state = state.replace(last_arrival=la)
    state = _advance_mobility(cfg, state, t, trace)
    return state, obs, rews


def step_channel(cfg: EnvConfig, state: EnvState, actions, t, trace=None):
    """``my_step_ch`` semantics (test_env.py:351-443): PRR-style reward --
    the fraction of in-range receivers whose nearest transmitter is you --
    through reward designs 2/3/4, plus packet-arrival bookkeeping.  The
    channel walk is ops/channel_phase.py: the K5 kernel when
    ``_kernel_step_wanted``, else its canonical plain loop."""
    st = cfg.state
    if st.add_positional_dist_piggy:
        state = _periodic_update(state)
    args = (cfg.num_channels, float(cfg.communication_range),
            cfg.reward_design, st.add_positional_dist_piggy)
    if _kernel_step_wanted(cfg, state.pos_x):
        i32 = torch.int32
        tx, ty, ts, ta, la, rews, obs = channel_phase(
            state.pos_x.contiguous(), state.pos_y.contiguous(),
            actions.to(i32).contiguous(), state.table_x.contiguous(),
            state.table_y.contiguous(), state.table_seq.contiguous(),
            state.table_age.contiguous(), state.last_arrival.contiguous(),
            t, *args)
    else:
        tx, ty, ts, ta, la, rews, obs = channel_phase_plain(
            state.pos_x, state.pos_y, actions, state.table_x, state.table_y,
            state.table_seq, state.table_age, state.last_arrival, t, *args)
    state = state.replace(table_x=tx, table_y=ty, table_seq=ts, table_age=ta,
                          last_arrival=la)
    state = _advance_mobility(cfg, state, t, trace)
    return state, obs, rews


# ---------------------------------------------------------------------------
# Kernel gates (v2v_env.py:622-655, "on the TPU" read as "on a CUDA device")
# ---------------------------------------------------------------------------


def get_step_fn(cfg: EnvConfig, enable_channel: bool = False,
                design: bool = False):
    """The step flavour main_test.py:143-147 picks."""
    if enable_channel:
        return step_channel
    if design:
        return step_design
    return step_collision


def _kernel_wanted(knob: str, impl: str, cfg: EnvConfig,
                   like: torch.Tensor) -> bool:
    """"xla" -> the canonical plain path; "pallas" -> the kernel wrapper
    (float32 only); "auto" -> the kernel for N >= 32 float32 envs on a
    CUDA device."""
    if impl == "xla":
        return False
    if impl == "pallas":
        if like.dtype != torch.float32:
            raise ValueError(f"{knob}='pallas' is float32-only; use 'xla' "
                             "for float64 parity work")
        return True
    if impl != "auto":
        raise ValueError(f"bad {knob} {impl!r}")
    return (cfg.num_users >= 32 and like.dtype == torch.float32
            and like.device.type == "cuda")


def _kernel_hist_wanted(cfg: EnvConfig, like: torch.Tensor) -> bool:
    """The K6 gate; "lanes" never takes K6 (v2v_env.py:624)."""
    if cfg.state.hist_impl == "lanes":
        return False
    return _kernel_wanted("hist_impl", cfg.state.hist_impl, cfg, like)


def _lanes_hist_wanted(cfg: EnvConfig, like: torch.Tensor) -> bool:
    """The K7 gate (v2v_env.py:692-694, 733): "lanes" at N*N <= 128 in
    float32 -- on any device, as JAX forces the kernel there; the port's
    env is batched, so JAX's custom_vmap rule is a direct call.  Other
    "lanes" cases take the canonical op."""
    return (cfg.state.hist_impl == "lanes"
            and cfg.num_users ** 2 <= MAX_ROW_PAIRS
            and like.dtype == torch.float32)


def _kernel_step_wanted(cfg: EnvConfig, like: torch.Tensor) -> bool:
    return _kernel_wanted("step_impl", cfg.step_impl, cfg, like)


# ---------------------------------------------------------------------------
# Observation / state assembly
# ---------------------------------------------------------------------------


def _piggy_geometry(state: EnvState):
    """Signed distances from each vehicle's table entries to its own
    current position (network.py:538-558); age gate < 20."""
    dx = state.table_x - state.pos_x[:, :, None]
    dy = state.table_y - state.pos_y[:, :, None]
    d = sqrt(dx * dx + dy * dy)
    one = torch.ones((), dtype=d.dtype, device=d.device)
    sign = torch.where(dx > 0.0, one, -one)
    fresh = ((state.table_age < STALENESS_CUTOFF)
             & ~_eye(d.shape[-1], d.device))
    return d, sign, fresh


def positional_dist_exact(cfg: EnvConfig, state: EnvState):
    """Sorted signed true distances / max distance, per user
    (network.py:409-430). [B, N, N-1]."""
    n = cfg.num_users
    D = pairwise_distances(state.pos_x, state.pos_y)
    signed = D * signed_dx(state.pos_x)
    eye = _eye(n, D.device)
    big = torch.full((), torch.finfo(D.dtype).max, dtype=D.dtype,
                     device=D.device)
    sorted_signed = torch.sort(torch.where(eye, big, signed), dim=-1).values
    max_d = torch.where(eye, -big, D).amax(dim=-1)
    return sorted_signed[..., : n - 1] / max_d[..., None]


def positional_dist_piggy_type1(cfg: EnvConfig, state: EnvState):
    """Inf-norm-normalised weighted histogram over [-1, 1]
    (network.py:432-471). [B, N, num_bins]."""
    bins = cfg.state.num_bins
    d, sign, fresh = _piggy_geometry(state)
    signed = d * sign
    zero = torch.zeros((), dtype=d.dtype, device=d.device)
    inf_norm = torch.where(fresh, signed.abs(), zero).amax(dim=-1)
    normed = signed / torch.where(inf_norm > 0, inf_norm,
                                  torch.ones_like(inf_norm))[..., None]
    hist = masked_weighted_histogram(normed, normed, fresh, -1.0, 1.0, bins)
    return torch.where(fresh.any(dim=-1, keepdim=True), hist, zero)


def positional_dist_piggy_type2(cfg: EnvConfig, state: EnvState):
    """Count histogram over +-bin_range divided by the visible-neighbour
    count (network.py:473-513). [B, N, num_bins].  The K6 kernel serves it
    when ``_kernel_hist_wanted``, the K7 count histogram when
    ``_lanes_hist_wanted``; else the canonical bit-exact op.  K7 and the
    canonical op give the same counts bit for bit."""
    bins, rng = cfg.state.num_bins, float(cfg.bin_range)
    if _kernel_hist_wanted(cfg, state.pos_x):
        return piggy_histogram(
            state.table_x.contiguous(), state.table_y.contiguous(),
            state.pos_x.contiguous(), state.pos_y.contiguous(),
            state.table_age.contiguous(), rng, bins)
    d, sign, fresh = _piggy_geometry(state)
    valid = fresh & (d < rng)
    if _lanes_hist_wanted(cfg, state.pos_x):
        b, n = state.pos_x.shape
        hist, cnt = lanes_histogram((d * sign).reshape(b, n * n).contiguous(),
                                    valid.reshape(b, n * n).contiguous(),
                                    n, bins, -rng, rng)
    else:
        hist = masked_count_histogram(d * sign, valid, -rng, rng, bins)
        cnt = valid.sum(dim=-1).to(hist.dtype)
    safe = torch.where(cnt > 0, cnt, torch.ones_like(cnt))
    return torch.where(cnt[..., None] > 0, hist / safe[..., None],
                       torch.zeros_like(hist))


def obtain_state(cfg: EnvConfig, state: EnvState, obs, actions, rewards,
                 episode=0, epsilon=1.0):
    """Per-user state-vector assembly in the reference's field order
    (test_env.py:527-583). [B, N, state_space]."""
    st = cfg.state
    n = cfg.num_users
    dtype, dev = state.pos_x.dtype, state.pos_x.device
    b = state.pos_x.shape[0]
    parts = []
    if st.add_action:
        if st.action_index == "binary":
            parts.append(one_hot_actions(actions, cfg.num_channels).to(dtype))
        elif st.action_index == "real":
            parts.append(actions.to(dtype)[..., None])
        else:
            raise ValueError("bad action_index")
    if st.add_channel_obs:
        ob = obs.to(dtype)
        if st.piggybacking:
            # the piggy obs rides the channel-obs slot at the sizing's full
            # C + C*(C-1) width; flavours without a piggy path emit [N, C]
            # rows, zero-padded to that width (v2v_env.py:758-767)
            want = cfg.num_channels * cfg.num_channels
            if ob.shape[-1] < want:
                ob = F.pad(ob, (0, want - ob.shape[-1]))
        parts.append(ob)
    if st.add_positional_dist:
        parts.append(positional_dist_exact(cfg, state))
    if st.add_positional_dist_piggy:
        if st.add_positional_dist_type == 1:
            parts.append(positional_dist_piggy_type1(cfg, state))
        elif st.add_positional_dist_type == 2:
            parts.append(positional_dist_piggy_type2(cfg, state))
        else:
            raise ValueError("bad add_positional_dist_type")
    if st.add_reward:
        parts.append(rewards.to(dtype)[..., None])
    if st.add_index:
        idx = torch.arange(n, dtype=dtype, device=dev) + 1
        parts.append(idx[None, :, None].expand(b, n, 1))
    if st.add_position:
        parts.append(torch.stack([state.pos_x / cfg.highway_length,
                                  state.pos_y / cfg.highway_height], dim=-1))
    if st.add_velocity:
        parts.append(state.vel[..., None])
    if cfg.enable_fingerprint:
        parts.append(torch.stack(
            [torch.full((b, n), float(episode), dtype=dtype, device=dev),
             torch.full((b, n), float(epsilon), dtype=dtype, device=dev)],
            dim=-1))
    return torch.cat(parts, dim=-1)


# ---------------------------------------------------------------------------
# Information age
# ---------------------------------------------------------------------------


def state_generator(cfg: EnvConfig, actions, obs):
    """DQN-era state assembly (test_env.py:507-525): per user, one-hot
    action ++ the LAST user's full channel-observation row (the
    reference's ``obs[-1]`` "channel_alloc") ++ the user's own
    first-channel observation truncated to int (the ACK).  actions [B, N],
    obs [B, N, C] -> [B, N, 2C+1]."""
    n, c = cfg.num_users, cfg.num_channels
    onehot = one_hot_actions(actions, c).to(obs.dtype)
    channel_alloc = obs[:, -1:, :].expand(-1, n, -1)
    ack = torch.trunc(obs[:, :, :1])
    return torch.cat([onehot, channel_alloc, ack], dim=2)


def information_age(state: EnvState, t: int):
    """Histogram of packet ages over in-coverage (tx, rx) pairs
    (network.py:560-574). [B, IA_HORIZON] int32."""
    la = state.last_arrival
    b, n = la.shape[0], la.shape[-1]
    valid = (la != -1) & ~_eye(n, la.device)
    ia = t - la
    contributes = valid & (ia < IA_HORIZON) & (ia >= 0)
    idx = torch.where(contributes, ia, IA_HORIZON).long().reshape(b, -1)
    hist = torch.zeros((b, IA_HORIZON + 1), dtype=torch.int64,
                       device=la.device)
    hist.scatter_add_(1, idx, torch.ones_like(idx))
    return hist[:, :IA_HORIZON].to(torch.int32)


def ia_penalty(ia_hist):
    """Weighted information-age sum (reference utils/misc.py:1-12), float32.
    [..., IA] -> [...]."""
    w = torch.arange(1, ia_hist.shape[-1] + 1, dtype=torch.float32,
                     device=ia_hist.device)
    return (ia_hist * w).sum(dim=-1)
