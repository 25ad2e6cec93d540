"""Q-value networks (diral_tpu/models/qnets.py):

* ``drqn`` (reference algorithms/drl_drqn.py:109-155):
  BasicLSTMCell(layers[0]) over the history window, last-step output ->
  dense(layers[1]) + relu + layer_norm (-> dense(layers[2]) + relu +
  layer_norm) -> linear head.  The MLP branch (``use_lstm_input=False``)
  replaces the LSTM with dense + relu + layer_norm.
* ``ps_dqn`` (ps_dqn.py:158-198): 1-2 dense layers (relu or linear), a
  linear head or dueling value/advantage heads with
  ``q = v + a - mean(a)``.
* ``ps_drqn`` (ps_drqn.py:119-166): 1-2 dense relu layers -> GRU ->
  linear head; its dueling heads read the pre-RNN features and subtract
  the SUM of the advantages -- both reference quirks, kept as the JAX
  package keeps them.

Parameters live in an ``nn.Module`` (``ParamTree``) whose names follow
the JAX tree (``lstm.w``, ``lstm.b``, ``fc2.w``, ``ln2.scale``, ...) and
keep JAX's [in, out] weight layout, so a JAX parameter tree maps onto it
name for name (convert.py).  The functions take the nested-dict view
(``tree()``), as the JAX ones take the pytree.
"""

from __future__ import annotations

import functools
import math

import torch
from torch import nn

from diral_tpu_torch.config import AgentConfig
from diral_tpu_torch.models.recurrent import (gru_cell, gru_init, gru_scan,
                                              lstm_init, lstm_scan)
from diral_tpu_torch.ops import lstm_window

_MATMUL_GROUPS = ("lstm", "fc1", "fc2", "fc3", "head")


def dense_init(generator, in_dim, out_dim, dtype=torch.float32, device=None,
               scheme="glorot"):
    """Glorot-uniform weights and zero bias (the JAX package's default),
    or with ``scheme="reference"`` the reference's tf.random_uniform
    U[0,1) weights and 0.1 bias (drl_drqn.py:124-147)."""
    w = torch.empty((in_dim, out_dim), dtype=dtype, device=device)
    if scheme == "reference":
        w.uniform_(0.0, 1.0, generator=generator)
        return {"w": w, "b": torch.full((out_dim,), 0.1, dtype=dtype,
                                        device=device)}
    lim = math.sqrt(6.0 / (in_dim + out_dim))
    w.uniform_(-lim, lim, generator=generator)
    return {"w": w, "b": torch.zeros(out_dim, dtype=dtype, device=device)}


def layer_norm_init(dim, dtype=torch.float32, device=None):
    return {"scale": torch.ones(dim, dtype=dtype, device=device),
            "bias": torch.zeros(dim, dtype=dtype, device=device)}


def dense(params, x):
    return x @ params["w"] + params["b"]


# the most rows of one product in the acting forward (``rows`` of
# ``drqn_apply``): cuBLAS picks its algorithm, split-K among them, from the
# row count, so a row's bits would depend on how many envs a mesh rank
# holds; products of one fixed shape give every row the same bits on one
# card and on any mesh (chip_mesh.py's row_invariance)
ACT_ROWS = 8192


def dense_rows(params, x, rows: int):
    """``dense`` of a 2-D ``x`` as products of exactly ``rows`` rows, the
    last one padded with zero rows, so that each row's result does not
    depend on x's row count; one plain ``dense`` when x has ``rows``
    rows.  Forward only (the products write into one output)."""
    n = x.shape[0]
    if n == rows:
        return dense(params, x)
    w = params["w"]
    out = torch.empty((n, w.shape[1]), dtype=torch.result_type(x, w),
                      device=x.device)
    full = n - n % rows
    for a in range(0, full, rows):
        torch.matmul(x[a:a + rows], w, out=out[a:a + rows])
    if full < n:
        tail = x.new_zeros((rows, x.shape[1]))
        tail[:n - full] = x[full:]
        out[full:] = (tail @ w)[:n - full]
    return out + params["b"]


def layer_norm(params, x, eps=1e-6):
    mean = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mean).mean(dim=-1, keepdim=True)
    y = (x - mean) * torch.rsqrt(var + eps)
    return y * params["scale"] + params["bias"]


class ParamTree(nn.Module):
    """Parameter container: one submodule per JAX group, one parameter per
    leaf (state_dict keys ``lstm.w``, ``fc2.b``, ``ln2.scale``, ...)."""

    def __init__(self, tree: dict):
        super().__init__()
        for group, leaves in tree.items():
            sub = nn.Module()
            for name, value in leaves.items():
                sub.register_parameter(
                    name, nn.Parameter(torch.as_tensor(value)))
            self.add_module(group, sub)

    def tree(self) -> dict:
        return {g: dict(m.named_parameters(recurse=False))
                for g, m in self.named_children()}


class DRQN(ParamTree):
    """The DRQN net's parameters; calling it applies ``drqn_apply``."""

    def __init__(self, tree: dict, cfg: AgentConfig):
        super().__init__(tree)
        self.cfg = cfg

    def forward(self, x):
        return drqn_apply(self, x, self.cfg)


def drqn_init(generator: torch.Generator, state_dim: int, action_dim: int,
              cfg: AgentConfig, dtype=torch.float32, device=None) -> DRQN:
    layers = cfg.network.layers
    if cfg.network.use_lstm_input:
        tree = {"lstm": lstm_init(generator, state_dim, layers[0], dtype,
                                  device)}
    else:
        tree = {"fc1": dense_init(generator, state_dim, layers[0], dtype,
                                  device),
                "ln1": layer_norm_init(layers[0], dtype, device)}
    tree["fc2"] = dense_init(generator, layers[0], layers[1], dtype, device)
    tree["ln2"] = layer_norm_init(layers[1], dtype, device)
    if len(layers) == 3:
        tree["fc3"] = dense_init(generator, layers[1], layers[2], dtype,
                                 device)
        tree["ln3"] = layer_norm_init(layers[2], dtype, device)
    tree["head"] = dense_init(generator, layers[-1], action_dim, dtype,
                              device)
    return DRQN(tree, cfg)


def _lstm_last(lstm_params, x, impl: str, step: int):
    """Last-step LSTM hidden over the history window -> [B, H].

    ``x`` is [B, T, D] or the flat padded window [B, T*Dp].  ``impl``:
    "auto" launches the K1 kernel on a CUDA device when dtype/shape allow
    (ops/lstm_window.supported), else the canonical ``lstm_scan``;
    "pallas" forces the kernel wrapper (raising where it cannot serve);
    "xla" forces ``lstm_scan`` (qnets.py:70-108)."""
    hidden = lstm_params["w"].shape[1] // 4
    d = lstm_params["w"].shape[0] - hidden
    flat = x.dim() == 2
    if impl == "xla":
        use_kernel = False
    else:
        ok = lstm_window.supported(x.dtype, hidden)
        if impl == "pallas":
            if not ok:
                raise ValueError(
                    f"network.lstm_impl='pallas' unsupported for "
                    f"dtype={x.dtype}, hidden={hidden}")
            use_kernel = True
        elif impl == "auto":
            use_kernel = ok and x.device.type == "cuda"
        else:
            raise ValueError(f"bad lstm_impl {impl!r}")
    if use_kernel:
        if flat:
            return lstm_window.lstm_last_flat(x, lstm_params["w"],
                                              lstm_params["b"], step)
        return lstm_window.lstm_last(x, lstm_params["w"], lstm_params["b"])
    if flat:
        x = lstm_window.unflatten_window(x, step, d)
    _, hs = lstm_scan(lstm_params, x)
    return hs[:, -1, :]


def _maybe_bf16(params, x, cfg: AgentConfig):
    bf16 = cfg.network.compute_dtype == "bfloat16"
    if bf16:
        def cast(leaves):
            return {k: v.to(torch.bfloat16) if v.dtype == torch.float32 else v
                    for k, v in leaves.items()}
        params = {k: cast(v) if k in _MATMUL_GROUPS else v
                  for k, v in params.items()}
        x = x.to(torch.bfloat16)
    return params, x, bf16


def _norm(ln, hh, bf16: bool):
    # layer_norm statistics in f32 even under bf16 compute
    if bf16:
        return layer_norm(ln, hh.to(torch.float32)).to(torch.bfloat16)
    return layer_norm(ln, hh)


def _head_stack(params, h, cfg: AgentConfig, bf16: bool, lin=dense):
    """The post-feature dense/LN/head tail of the DRQN net; ``lin`` is
    the dense layer."""
    h = _norm(params["ln2"], torch.relu(lin(params["fc2"], h)), bf16)
    if "fc3" in params:
        h = _norm(params["ln3"], torch.relu(lin(params["fc3"], h)), bf16)
    out = lin(params["head"], h)
    return out.to(torch.float32) if bf16 else out


def _tree(params):
    return params.tree() if isinstance(params, ParamTree) else params


def drqn_apply(params, x, cfg: AgentConfig, rows: int | None = None):
    """x: [B, T, D] or flat [B, T*Dp] window (LSTM path) or [B, D] (MLP
    path) -> Q [B, A].  ``params``: a DRQN module or its ``tree()``.
    ``rows``: the dense layers as ``dense_rows`` products of that many
    rows (forward only), else one product each."""
    params, x, bf16 = _maybe_bf16(_tree(params), x, cfg)
    lin = dense if rows is None else functools.partial(dense_rows,
                                                       rows=rows)
    if cfg.network.use_lstm_input:
        h = _lstm_last(params["lstm"], x, cfg.network.lstm_impl,
                       cfg.step_size)
    else:
        h = _norm(params["ln1"], torch.relu(lin(params["fc1"], x)), bf16)
    return _head_stack(params, h, cfg, bf16, lin)


def _kernel_gate(cfg: AgentConfig, x, hidden: int) -> bool:
    """The fused multi-net kernels' gate (qnets.py:217-225, 249-259): "auto"
    on a CUDA device or "pallas" anywhere, when the compute dtype and the
    hidden width are supported."""
    impl = cfg.network.lstm_impl
    dtype = (torch.bfloat16 if cfg.network.compute_dtype == "bfloat16"
             else x.dtype)
    return (impl in ("auto", "pallas")
            and lstm_window.supported(dtype, hidden)
            and (impl == "pallas" or x.device.type == "cuda"))


def drqn_apply_triple(params, target_params, x2c, cfg: AgentConfig):
    """(Q_s, Q_na, Q_nb) from ONE combined flat (T+1)-step window
    [B, (T+1)*Dp] (the next_states window is the states window shifted one
    step):

      Q_s  -- online net on states (steps 0..T-1), differentiable;
      Q_na -- online net on next_states (steps 1..T), no gradient;
      Q_nb -- target net on next_states, no gradient.

    Kernel path: K2 (ops/lstm_window.lstm_last_flat_triple), bit-identical
    to the separate K1 and K4 forwards.  Otherwise lane slices +
    drqn_apply / drqn_apply_dual.  Q_na and Q_nb are computed without a
    graph on both paths: the Double-DQN target is never differentiated
    (drl_drqn.py:267-292)."""
    if not cfg.network.use_lstm_input or x2c.dim() != 2:
        raise ValueError("drqn_apply_triple needs the LSTM net and a flat "
                         "combined window")
    params, target_params = _tree(params), _tree(target_params)
    T = cfg.step_size
    Dp = x2c.shape[1] // (T + 1)
    hidden = params["lstm"]["w"].shape[1] // 4
    # the combined window must ride the kernel's padded per-step stride; a
    # wrong T or layout would otherwise slice misaligned lanes silently on
    # the plain path (qnets.py:211-216)
    want = lstm_window.padded_dim(params["lstm"]["w"].shape[0] - hidden)
    if Dp != want or x2c.shape[1] != (T + 1) * Dp:
        raise ValueError(f"combined window {tuple(x2c.shape)} does not ride "
                         f"the stride Dp={want} over T+1={T + 1} steps")
    if not _kernel_gate(cfg, x2c, hidden):
        q_s = drqn_apply(params, x2c[:, :T * Dp], cfg)
        with torch.no_grad():
            q_na, q_nb = drqn_apply_dual(params, target_params, x2c[:, Dp:],
                                         cfg)
        return q_s, q_na, q_nb
    pa, xc, bf16 = _maybe_bf16(params, x2c, cfg)
    pb, _, _ = _maybe_bf16(target_params, x2c, cfg)
    h_s, h_na, h_nb = lstm_window.lstm_last_flat_triple(
        xc, pa["lstm"]["w"], pa["lstm"]["b"], pb["lstm"]["w"],
        pb["lstm"]["b"], T)
    q_s = _head_stack(pa, h_s, cfg, bf16)
    with torch.no_grad():
        return (q_s, _head_stack(pa, h_na, cfg, bf16),
                _head_stack(pb, h_nb, cfg, bf16))


def drqn_apply_dual(params_a, params_b, x, cfg: AgentConfig):
    """(Q under params_a, Q under params_b) for the SAME input -- the
    Double-DQN target's online + target forwards on next_states
    (drl_drqn.py:267-292).  On the kernel path the two recurrences run in
    one K4 launch (forward only, no gradient); otherwise two
    ``drqn_apply`` calls."""
    params_a, params_b = _tree(params_a), _tree(params_b)
    use_dual = (cfg.network.use_lstm_input and x.dim() == 2
                and _kernel_gate(cfg, x,
                                 params_a["lstm"]["w"].shape[1] // 4))
    if not use_dual:
        return drqn_apply(params_a, x, cfg), drqn_apply(params_b, x, cfg)
    pa, xa, bf16 = _maybe_bf16(params_a, x, cfg)
    pb, _, _ = _maybe_bf16(params_b, x, cfg)
    ha, hb = lstm_window.lstm_last_flat_dual(
        xa, pa["lstm"]["w"], pa["lstm"]["b"], pb["lstm"]["w"],
        pb["lstm"]["b"], cfg.step_size)
    return _head_stack(pa, ha, cfg, bf16), _head_stack(pb, hb, cfg, bf16)


# ---------------------------------------------------------------------------
# PS-DQN feedforward net (optional dueling)
# ---------------------------------------------------------------------------


def _feature_layers(generator, state_dim, layers, dtype, device):
    tree = {"fc1": dense_init(generator, state_dim, layers[0], dtype, device)}
    if len(layers) >= 2:
        tree["fc2"] = dense_init(generator, layers[0], layers[1], dtype,
                                 device)
    return tree, layers[min(len(layers), 2) - 1]


def _heads(tree, generator, feat, action_dim, cfg, dtype, device):
    if cfg.network.use_dueling:
        tree["value"] = dense_init(generator, feat, 1, dtype, device)
        # the advantage head has no bias (ps_dqn.py:191-192)
        tree["advantage"] = {"w": dense_init(generator, feat, action_dim,
                                             dtype, device)["w"]}
    else:
        tree["head"] = dense_init(generator, feat, action_dim, dtype, device)
    return tree


def ps_dqn_init(generator: torch.Generator, state_dim: int, action_dim: int,
                cfg: AgentConfig, dtype=torch.float32,
                device=None) -> ParamTree:
    tree, feat = _feature_layers(generator, state_dim, cfg.network.layers,
                                 dtype, device)
    return ParamTree(_heads(tree, generator, feat, action_dim, cfg, dtype,
                            device))


def ps_dqn_apply(params, x, cfg: AgentConfig):
    """x [B, D] -> Q [B, A]; dueling subtracts the MEAN advantage."""
    params = _tree(params)
    act = ((lambda v: v) if cfg.network.activation == "Linear"
           else torch.relu)
    h = act(dense(params["fc1"], x))
    if "fc2" in params:
        h = act(dense(params["fc2"], h))
    if cfg.network.use_dueling:
        a = h @ params["advantage"]["w"]
        return dense(params["value"], h) + a - a.mean(dim=-1, keepdim=True)
    return dense(params["head"], h)


# ---------------------------------------------------------------------------
# PS-DRQN net (dense -> GRU -> head), with carried hidden state
# ---------------------------------------------------------------------------


def ps_drqn_init(generator: torch.Generator, state_dim: int,
                 action_dim: int, cfg: AgentConfig, dtype=torch.float32,
                 device=None) -> ParamTree:
    tree, feat = _feature_layers(generator, state_dim, cfg.network.layers,
                                 dtype, device)
    tree["gru"] = gru_init(generator, feat, feat, dtype, device)
    return ParamTree(_heads(tree, generator, feat, action_dim, cfg, dtype,
                            device))


def _ps_drqn_features(params, x):
    h = torch.relu(dense(params["fc1"], x))
    if "fc2" in params:
        h = torch.relu(dense(params["fc2"], h))
    return h


def ps_drqn_hidden_size(params) -> int:
    return _tree(params)["gru"]["wc"].shape[1]


def _ps_drqn_q(params, feats, h, cfg: AgentConfig):
    """The head: dueling reads the pre-RNN features and subtracts the SUM
    of the advantages (ps_drqn.py:155-160); else a linear head on h."""
    if cfg.network.use_dueling:
        a = feats @ params["advantage"]["w"]
        return dense(params["value"], feats) + a - a.sum(dim=-1, keepdim=True)
    return dense(params["head"], h)


def ps_drqn_apply_seq(params, x, cfg: AgentConfig, h0=None):
    """x [B, T, D] -> (Q [B*T, A], final hidden [B, H]): the reference's
    flatten-then-reshape unroll (ps_drqn.py:146-162)."""
    params = _tree(params)
    feats = _ps_drqn_features(params, x)
    h_n, hs = gru_scan(params["gru"], feats, h0)
    q = _ps_drqn_q(params, feats.reshape(-1, feats.shape[-1]),
                   hs.reshape(-1, hs.shape[-1]), cfg)
    return q, h_n


def ps_drqn_apply_step(params, x, h, cfg: AgentConfig):
    """One inference step with carried per-agent hidden state
    (ps_drqn.py:195-231). x [B, D], h [B, H] -> (Q [B, A], new h)."""
    params = _tree(params)
    feats = _ps_drqn_features(params, x)
    new_h, _ = gru_cell(params["gru"], h, feats)
    return _ps_drqn_q(params, feats, new_h, cfg), new_h
