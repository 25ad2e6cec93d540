"""Plain float32 reference of the DRQN Q-net and its learner step.

Q-net: a BasicLSTMCell (gate order i, g, f, o; forget bias +1) over the
T-step window, its last hidden state -> dense + relu + layer norm ->
linear head.  With ``bf16`` the LSTM's products take their operands
rounded to bfloat16 and sum in float32, and its backward rounds the
gate cotangents to bfloat16 before the weight products and sums the
bias gradient unrounded: the precision class that the configuration
states on a CUDA device (``lstm_impl: auto`` serves the LSTM there with
the port's kernels, whose documented numerics these are, as the JAX
package's are the TPU's default matmul precision); elsewhere ``auto``
is the float32 LSTM (``lstm_precision``).  Every other product is
float32, with TF32 off (``disable_tf32``).

Learner step: Double-DQN targets (online argmax, target gather, never
differentiated), the squared TD error of the last window step, Adam
(torch's defaults) written out, and the target copy every
``target_update`` slots.  Frozen copies of the port's plain versions
(ops/lstm_window.py, models/qnets.py, agents/drqn.py); nothing of the
program is imported.
"""

from __future__ import annotations

import math

import torch

BETA1, BETA2, ADAM_EPS = 0.9, 0.999, 1e-8
LN_EPS = 1e-6
LEAVES = ("lstm.w", "lstm.b", "fc2.w", "fc2.b", "ln2.scale", "ln2.bias",
          "head.w", "head.b")


def disable_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def make_weights(generator: torch.Generator, D: int, C: int, H1: int,
                 H2: int, device) -> dict[str, torch.Tensor]:
    """The net's initial weights from ``generator``: Glorot-uniform
    matrices (three draws), zero biases, unit layer-norm scale."""
    f32 = torch.float32

    def glorot(rows, cols):
        lim = math.sqrt(6.0 / (rows + cols))
        w = torch.empty((rows, cols), dtype=f32, device=device)
        return w.uniform_(-lim, lim, generator=generator)

    def zeros(n):
        return torch.zeros(n, dtype=f32, device=device)

    return {"lstm.w": glorot(D + H1, 4 * H1), "lstm.b": zeros(4 * H1),
            "fc2.w": glorot(H1, H2), "fc2.b": zeros(H2),
            "ln2.scale": torch.ones(H2, dtype=f32, device=device),
            "ln2.bias": zeros(H2),
            "head.w": glorot(H2, C), "head.b": zeros(C)}


def lstm_precision(cfg, device) -> bool:
    """Whether the configuration's LSTM runs in the bf16-product class on
    ``device``: ``lstm_impl`` "pallas", or "auto" on a CUDA device."""
    impl = cfg.agent.network.lstm_impl
    return impl == "pallas" or (impl == "auto"
                                and torch.device(device).type == "cuda")


def _round(bf16: bool):
    if not bf16:
        return lambda t: t
    return lambda t: t.to(torch.bfloat16).to(torch.float32)


def _split(w, D: int, Dp: int, rnd):
    H = w.shape[1] // 4
    wx = torch.zeros((Dp, 4 * H), dtype=torch.float32, device=w.device)
    wx[:D] = rnd(w[:D])
    return wx, rnd(w[D:])


def _gates(c, gates, H: int):
    i, g, f, o = gates.split(H, dim=-1)
    si, tg = torch.sigmoid(i), torch.tanh(g)
    sf, so = torch.sigmoid(f + 1.0), torch.sigmoid(o)
    c = c * sf + si * tg
    return c, torch.tanh(c) * so, (si, tg, sf, so)


def lstm_last(x2, w, b, T: int, bf16: bool):
    """Last hidden state [R, H] of the LSTM over the flat window
    [R, T*Dp] (step t's features at lanes [t*Dp, t*Dp + D))."""
    H = w.shape[1] // 4
    D = w.shape[0] - H
    Dp = x2.shape[1] // T
    rnd = _round(bf16)
    wx, wh = _split(w, D, Dp, rnd)
    h = torch.zeros((x2.shape[0], H), dtype=torch.float32, device=x2.device)
    c = torch.zeros_like(h)
    for t in range(T):
        g = rnd(x2[:, t * Dp:(t + 1) * Dp]) @ wx + rnd(h) @ wh + b
        c, h, _ = _gates(c, g, H)
    return h


def lstm_backward(x2, w, b, g, T: int, bf16: bool):
    """(dw, db) of ``lstm_last`` for the cotangent ``g`` [R, H]: the
    forward recomputed, the sweep back (with ``bf16``, gate cotangents
    rounded in the dh and dW products), db summed unrounded."""
    H = w.shape[1] // 4
    D = w.shape[0] - H
    Dp = x2.shape[1] // T
    rnd = _round(bf16)
    wx, wh = _split(w, D, Dp, rnd)
    xs = [rnd(x2[:, t * Dp:(t + 1) * Dp]) for t in range(T)]
    h = torch.zeros((x2.shape[0], H), dtype=torch.float32, device=x2.device)
    c = torch.zeros_like(h)
    h_prev, cs, acts = [], [c], []
    for t in range(T):
        h_prev.append(rnd(h))
        c, h, act = _gates(c, xs[t] @ wx + h_prev[t] @ wh + b, H)
        cs.append(c)
        acts.append(act)
    dh, dc = g, torch.zeros_like(g)
    dwx = torch.zeros_like(wx)
    dwh = torch.zeros_like(wh)
    db = torch.zeros_like(b)
    for t in reversed(range(T)):
        si, tg, sf, so = acts[t]
        tc = torch.tanh(cs[t + 1])
        dao = dh * tc * so * (1.0 - so)
        dct = dc + dh * so * (1.0 - tc * tc)
        daf = dct * cs[t] * sf * (1.0 - sf)
        dai = dct * tg * si * (1.0 - si)
        dag = dct * si * (1.0 - tg * tg)
        dgates = torch.cat([dai, dag, daf, dao], dim=1)
        dc = dct * sf
        dgb = rnd(dgates)
        dh = dgb @ wh.T
        dwx += xs[t].T @ dgb
        dwh += h_prev[t].T @ dgb
        db += dgates.sum(dim=0)
    return torch.cat([dwx[:D], dwh], dim=0), db


class _Lstm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x2, w, b, T, bf16):
        ctx.save_for_backward(x2, w, b)
        ctx.T, ctx.bf16 = T, bf16
        return lstm_last(x2, w, b, T, bf16)

    @staticmethod
    def backward(ctx, g):
        x2, w, b = ctx.saved_tensors
        dw, db = lstm_backward(x2, w, b, g, ctx.T, ctx.bf16)
        return None, dw, db, None, None


def head(p, h):
    """dense + relu + layer norm -> the linear head. [R, H1] -> [R, C]."""
    z = torch.relu(h @ p["fc2.w"] + p["fc2.b"])
    mean = z.mean(dim=-1, keepdim=True)
    var = torch.square(z - mean).mean(dim=-1, keepdim=True)
    z = (z - mean) * torch.rsqrt(var + LN_EPS) * p["ln2.scale"] + p["ln2.bias"]
    return z @ p["head.w"] + p["head.b"]


def qvalues(p, x2, T: int, bf16: bool, block: int = 65536):
    """Q [R, C] of flat windows [R, T*Dp], in blocks of rows."""
    return torch.cat([head(p, lstm_last(x2[i:i + block], p["lstm.w"],
                                        p["lstm.b"], T, bf16))
                      for i in range(0, x2.shape[0], block)])


def windows_to_rows(win, N: int, D: int, Dp: int, step: int):
    """Gathered ring windows [n, batch, step+1, N*Dp] -> per draw the
    user-major rows: (windows [n, N*batch, (step+1)*Dp], actions and
    rewards [n, N*batch] of the last step)."""
    n, batch, W = win.shape[:3]
    x = win.reshape(n, batch, W, N, Dp).permute(0, 3, 1, 2, 4)
    rows = x.reshape(n, N * batch, W * Dp).to(torch.float32)
    last = x[:, :, :, step - 1]                     # [n, N, batch, Dp]
    rewards = last[..., D].reshape(n, N * batch).to(torch.float32)
    actions = last[..., D + 1].reshape(n, N * batch).long()
    return rows, actions, rewards


def td_loss(p, target, rows, actions, rewards, T: int, gamma: float,
            bf16: bool):
    """Squared TD error of the Double-DQN target over combined windows
    [R, (T+1)*Dp]; differentiable in ``p`` (a dict of leaf tensors)."""
    Dp = rows.shape[1] // (T + 1)
    h_s = _Lstm.apply(rows[:, :T * Dp], p["lstm.w"], p["lstm.b"], T, bf16)
    q_s = head(p, h_s)
    with torch.no_grad():
        nxt = rows[:, Dp:]
        q_na = head(p, lstm_last(nxt, p["lstm.w"], p["lstm.b"], T, bf16))
        q_nb = head(target, lstm_last(nxt, target["lstm.w"],
                                      target["lstm.b"], T, bf16))
        act = torch.argmax(q_na, dim=1)
        y = rewards + gamma * torch.gather(q_nb, 1, act[:, None])[:, 0]
    chosen = torch.gather(q_s, 1, actions[:, None])[:, 0]
    return torch.square(chosen - y).mean()


class Learner:
    """The reference learner: online and target weights, Adam's moments."""

    def __init__(self, weights: dict, lr: float, gamma: float, T: int,
                 target_update: int, bf16: bool):
        self.p = {k: v.clone() for k, v in weights.items()}
        self.target = {k: v.clone() for k, v in weights.items()}
        self.m = {k: torch.zeros_like(v) for k, v in weights.items()}
        self.v = {k: torch.zeros_like(v) for k, v in weights.items()}
        self.lr, self.gamma, self.T, self.bf16 = lr, gamma, T, bf16
        self.target_update = target_update
        self.steps = 0

    def loss_and_grads(self, rows, actions, rewards):
        p = {k: v.detach().requires_grad_(True) for k, v in self.p.items()}
        loss = td_loss(p, self.target, rows, actions, rewards, self.T,
                       self.gamma, self.bf16)
        grads = torch.autograd.grad(loss, [p[k] for k in LEAVES])
        return loss.detach(), dict(zip(LEAVES, grads))

    def loss(self, rows, actions, rewards):
        with torch.no_grad():
            p = {k: v.detach() for k, v in self.p.items()}
            # the loss alone: the online forward needs no graph
            return td_loss(p, self.target, rows, actions, rewards, self.T,
                           self.gamma, self.bf16)

    def adam(self, grads) -> None:
        self.steps += 1
        bc1 = 1.0 - BETA1 ** self.steps
        bc2 = 1.0 - BETA2 ** self.steps
        with torch.no_grad():
            for k, g in grads.items():
                self.m[k] = BETA1 * self.m[k] + (1.0 - BETA1) * g
                self.v[k] = BETA2 * self.v[k] + (1.0 - BETA2) * g * g
                step = (self.m[k] / bc1) / (torch.sqrt(self.v[k] / bc2)
                                            + ADAM_EPS)
                self.p[k] = self.p[k] - self.lr * step

    def end_event(self, t: int) -> None:
        if (t + 1) % self.target_update == 0:
            self.target = {k: v.clone() for k, v in self.p.items()}
