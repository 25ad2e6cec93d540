"""PPO actor-critic networks (diral_tpu/models/actor_critic.py; reference
algorithms/ps_ppo.py:27-62,130-138).

Feedforward: one dense + relu trunk per head, softmax policy over
actions, scalar value.  LSTM variant: separate LSTM encoders for actor
and critic (the reference keeps them unshared, ps_ppo.py:27-44), each
followed by dense + relu and its head.

The encoder follows ``lstm_impl`` as the DRQN net does: the K1 kernel
(ops/lstm_window.lstm_last, differentiable through K3) on a CUDA device
when the dtype and width allow, or anywhere under "pallas"; the canonical
``lstm_scan`` otherwise (the float64 parity path).
"""

from __future__ import annotations

import torch

from diral_tpu_torch.config import AgentConfig
from diral_tpu_torch.models.qnets import ParamTree, _tree, dense, dense_init
from diral_tpu_torch.models.recurrent import lstm_init, lstm_scan
from diral_tpu_torch.ops import lstm_window


def ppo_init(generator: torch.Generator, state_dim: int, action_dim: int,
             cfg: AgentConfig, dtype=torch.float32, device=None) -> ParamTree:
    hidden = cfg.network.layers[0]
    use_lstm = cfg.network.use_lstm_input
    trunk_in = hidden if use_lstm else state_dim
    tree = {
        "actor_fc": dense_init(generator, trunk_in, hidden, dtype, device),
        "actor_head": dense_init(generator, hidden, action_dim, dtype, device),
        "critic_fc": dense_init(generator, trunk_in, hidden, dtype, device),
        "critic_head": dense_init(generator, hidden, 1, dtype, device),
    }
    if use_lstm:
        tree["actor_lstm"] = lstm_init(generator, state_dim, hidden, dtype,
                                       device)
        tree["critic_lstm"] = lstm_init(generator, state_dim, hidden, dtype,
                                        device)
    return ParamTree(tree)


def _encode(params, x, prefix: str, use_lstm: bool, impl: str = "auto"):
    """x [B, T, D] -> the last LSTM hidden [B, H] (or x itself without
    the LSTM)."""
    if not use_lstm:
        return x
    p = params[f"{prefix}_lstm"]
    hidden = p["w"].shape[1] // 4
    if (impl != "xla" and lstm_window.supported(x.dtype, hidden)
            and (impl == "pallas" or x.device.type == "cuda")):
        return lstm_window.lstm_last(x, p["w"], p["b"])
    _, hs = lstm_scan(p, x)
    return hs[:, -1, :]


def ppo_policy_logits(params, x, cfg: AgentConfig):
    """x: [B, T, D] (LSTM) or [B, D] -> action logits [B, A]."""
    params = _tree(params)
    h = _encode(params, x, "actor", cfg.network.use_lstm_input,
                cfg.network.lstm_impl)
    return dense(params["actor_head"], torch.relu(dense(params["actor_fc"],
                                                        h)))


def ppo_value(params, x, cfg: AgentConfig):
    """-> V [B]."""
    params = _tree(params)
    h = _encode(params, x, "critic", cfg.network.use_lstm_input,
                cfg.network.lstm_impl)
    h = torch.relu(dense(params["critic_fc"], h))
    return dense(params["critic_head"], h)[..., 0]
