"""Experience replays (diral_tpu/agents/replay.py): the DRQN training
loop's ``FusedWindowReplay`` (reference utils/memory.py:162-194
``Memory``) and the PS-DQN ``TransitionReplay`` (memory.py:127-145,
ps_dqn.py:326-334), below.

One ring of whole env slots per env, every env advancing in lockstep.  A
slot is ONE flat row of N*Dp lanes, Dp = ops/lstm_window.padded_dim(D):
user n's channels at lane offset n*Dp -- [0:D) state, D reward, D+1 the
action's exact float image, [D+2:Dp) zero.  The per-user stride is the
LSTM kernels' per-step stride, so a sampled window is a Q-net input row
after a slice and a reshape.  ``next_states`` are the ``states`` rows
shifted one slot (in an unbroken add chain the state stored at slot k+1
IS slot k's next_state), so one buffer serves all four sample arrays.

The mirror pad duplicates the first ``pad`` ring slots past the ring's
end (buf[:, S+s] == buf[:, s] for s < pad), so any (pad+1)-slot window
is a contiguous slice.

The write pointer and the fill count follow from the number of adds
alone, so they are host integers: no slot reads the device to find them.
The buffer is updated in place (the JAX package returns a new ring).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from diral_tpu_torch.ops.lstm_window import padded_dim

# Channel ids ride the buffer's float dtype (channel D+1): the id range must
# be exactly representable in its mantissa (replay.py:287-300).
_MANTISSA_MAX = {torch.float64: 2 ** 53, torch.float32: 2 ** 24,
                 torch.bfloat16: 2 ** 8, torch.float16: 2 ** 11}


def max_exact_action(dtype) -> int:
    return _MANTISSA_MAX.get(dtype, 2 ** 24)


@dataclass
class FusedWindowReplay:
    buf: torch.Tensor   # [B, S+pad, N*Dp]
    ptr: int            # next write position
    count: int          # filled slots (<= capacity)
    pad: int
    num_users: int
    dim: int            # state dim D (the lane stride is padded)

    @property
    def capacity(self) -> int:
        return self.buf.shape[1] - self.pad

    @property
    def state_dim(self) -> int:
        return self.dim

    @property
    def user_stride(self) -> int:
        return self.buf.shape[-1] // self.num_users

    @classmethod
    def create(cls, num_envs: int, capacity: int, num_users: int,
               state_dim: int, dtype=torch.float32,
               num_actions: int | None = None, pad: int = 0,
               device=None) -> "FusedWindowReplay":
        """``num_actions`` (the channel count) enables the exactness guard;
        ``pad`` is the mirror-pad width -- the sample window length."""
        if num_actions is not None and num_actions > max_exact_action(dtype):
            raise ValueError(
                f"FusedWindowReplay({dtype}) cannot store action ids up to "
                f"{num_actions - 1} exactly (mantissa limit "
                f"{max_exact_action(dtype)}); use a wider dtype")
        if pad >= capacity:
            raise ValueError(f"mirror pad {pad} must be < capacity {capacity}")
        buf = torch.zeros((num_envs, capacity + pad,
                           num_users * padded_dim(state_dim)), dtype=dtype,
                          device=device)
        return cls(buf=buf, ptr=0, count=0, pad=pad, num_users=num_users,
                   dim=state_dim)

    def add_lockstep(self, state, action, reward) -> None:
        """Append one slot of every env: state [B, N, D], action and reward
        [B, N].  There is no next_state argument -- the next add's state
        IS this slot's next_state.  A write to ring slot i < pad also
        lands at i + S."""
        dt = self.buf.dtype
        row = torch.cat([state.to(dt), reward.to(dt)[..., None],
                         action.to(dt)[..., None]], dim=-1)
        row = F.pad(row, (0, self.user_stride - self.dim - 2))
        row = row.reshape(row.shape[0], -1)                 # [B, N*Dp]
        i = self.ptr
        self.buf[:, i] = row
        if i < self.pad:
            self.buf[:, i + self.capacity] = row
        self.ptr = (i + 1) % self.capacity
        self.count = min(self.count + 1, self.capacity)


@dataclass
class TransitionReplay:
    """PS-DQN flat transition ring with mask/terminal channels.  ``head``
    and ``count`` follow from the number of rows put, so they are host
    integers; the buffers are updated in place."""

    states: torch.Tensor     # [S, D]
    actions: torch.Tensor    # [S] int32
    rewards: torch.Tensor    # [S]
    terminals: torch.Tensor  # [S] bool
    masks: torch.Tensor      # [S] float (0 = padding, ps_dqn.py:155)
    head: int = 0
    count: int = 0

    @property
    def capacity(self) -> int:
        return self.states.shape[0]

    @classmethod
    def create(cls, capacity: int, state_dim: int, dtype=torch.float32,
               device=None) -> "TransitionReplay":
        def z(*shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=device)
        return cls(states=z(capacity, state_dim),
                   actions=z(capacity, dt=torch.int32), rewards=z(capacity),
                   terminals=z(capacity, dt=torch.bool), masks=z(capacity))

    def put(self, states, actions, rewards, terminals, masks) -> None:
        """Append n transitions with wraparound: row i lands at (head + i)
        % capacity, and head advances by n (the reference's wrapping put
        sets ``head = split``, memory.py:144, a bug the JAX package fixes
        too).  When n > capacity several rows share a slot; the last one
        wins, i.e. only the last ``capacity`` rows are written (JAX's
        scatter leaves that winner unspecified)."""
        n, cap = states.shape[0], self.capacity
        keep = min(n, cap)
        idx = (self.head + n - keep
               + torch.arange(keep, device=self.states.device)) % cap
        for buf, val in ((self.states, states), (self.actions, actions),
                         (self.rewards, rewards), (self.terminals, terminals),
                         (self.masks, masks)):
            buf[idx] = val[n - keep:].to(buf.dtype)
        self.head = (self.head + n) % cap
        self.count = min(self.count + n, cap)

    def sample_indices(self, generator: torch.Generator, batch: int):
        """Uniform indices in [0, max(count - 1, 1)) (ps_dqn.py:326-334:
        index ~ choice(len - 1))."""
        return torch.randint(0, max(self.count - 1, 1), (batch,),
                             generator=generator, device=self.states.device)

    def sample(self, idx) -> dict:
        """The transitions at ``idx`` with their successors (idx + 1) %
        capacity."""
        return {"states": self.states[idx], "actions": self.actions[idx],
                "rewards": self.rewards[idx], "terminals": self.terminals[idx],
                "masks": self.masks[idx],
                "next_states": self.states[(idx + 1) % self.capacity]}
