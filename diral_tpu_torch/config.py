"""Typed configuration system, compatible with the reference's YAML experiment files.

The reference scatters ``kwargs.setdefault`` defaulting across every consumer
(main_test.py:16-41, envs/test_env.py:12-47, algorithms/drl_drqn.py:32-53).
Here the whole experiment is a tree of frozen dataclasses with the same
defaults, a strict YAML loader that understands the reference's three-section
schema (run control / EnvironmentTest+State / RLAgent+network), and shims for
the reference's known quirks (e.g. ``pretrain_length: batch_size`` is a string
that the reference never parses -- main_test.py's default wins, main_test.py:21).

New-framework-only knobs (vectorization width, mesh shape, seeds) live in the
optional ``Engine`` section, absent from reference YAMLs, defaulted here.

This is the PyTorch port's own copy of ``diral_tpu/config.py`` (the port
imports nothing of the JAX package); keep the two schemas in step.  The
implementation knobs read the same way on a CUDA device as on the TPU:
``lstm_impl`` / ``step_impl`` / ``hist_impl`` "pallas" selects the port's
hand-written CUDA kernel, "xla" the canonical plain PyTorch path, "auto"
the kernel on a CUDA device under the JAX package's gates.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any

import yaml


# ---------------------------------------------------------------------------
# Leaf sections
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class StateConfig:
    """Feature toggles for state-vector assembly.

    Mirrors the nested ``State:`` block (reference envs/test_env.py:26-41).
    """

    type: int = 2                       # 1: binary channel obs, 2: distance obs
    add_action: bool = True             # one-hot / scalar previous action
    add_reward: bool = False
    add_index: bool = False             # agent id (1-based) appended
    add_velocity: bool = False
    action_index: str = "binary"        # "binary" (one-hot) | "real" (scalar)
    piggybacking: bool = False          # piggybacked channel observations
    add_position: bool = False          # normalized (x, y)
    add_positional_dist: bool = False   # exact sorted signed-distance vector
    add_positional_dist_piggy: bool = True  # binned histogram from neighbor tables
    add_positional_dist_type: int = 2   # 1: inf-norm weighted hist, 2: count hist
    add_channel_obs: bool = False
    num_bins: int = 20                  # histogram bins for the piggy pos-dist
    # new-framework knob (not in reference YAMLs): implementation of the
    # type-2 positional distribution. "xla" = canonical bit-exact op,
    # "pallas" = fused TPU kernel (ops/pallas_kernels.py, 1 ULP at bin
    # edges), "auto" = pallas on TPU/float32 when num_users >= 32 (where
    # the [N, N, bins] one-hot expansion dominates the step)
    hist_impl: str = "auto"


@dataclass(frozen=True)
class EnvConfig:
    """Environment parameters (reference envs/test_env.py:12-47, envs/network.py:15-51)."""

    num_users: int = 3
    num_channels: int = 3
    congestion_test: bool = False       # toy-example reward weighting (network.py:284-290)
    mobility: bool = False
    mobility_vary: bool = False         # per-episode velocity randomization
    enable_design_topology: bool = False
    highway_length: int = 200
    highway_height: int = 2
    enable_fingerprint: bool = False
    reward_design: int = 1              # designs 1..5, test_env.py:170-197
    communication_range: float = 1.0
    proportional_fair: bool = False
    load_positions: bool = False        # replay recorded mobility traces
    load_file_pos: str = " "
    bin_range: float = 500.0            # observation range of the piggy histogram
    topology: str = "Circle"
    radius: float = 100.0
    # new-framework knob (not in reference YAMLs): implementation of the
    # step_channel per-channel phase. "xla" = canonical lax.scan,
    # "pallas" = fused VMEM-resident kernel (ops/pallas_step.py), "auto" =
    # pallas on TPU/float32 when num_users >= 32 (where the XLA scan is
    # HBM-bound on the [B, N, N] table round-trips)
    step_impl: str = "auto"
    state: StateConfig = field(default_factory=StateConfig)

    @property
    def action_space(self) -> int:
        return self.num_channels

    @property
    def state_space(self) -> int:
        """State-vector width; mirrors test_env.py:49-92 sizing exactly."""
        s = self.state
        n = 0
        if s.add_action:
            if s.action_index == "binary":
                n += self.num_channels
            elif s.action_index == "real":
                n += 1
            else:
                raise ValueError(f"unknown action_index {s.action_index!r}")
        if s.add_channel_obs:
            n += self.num_channels
        if s.add_reward:
            n += 1
        if s.add_index:
            n += 1
        if s.add_velocity:
            n += 1
        if s.add_position:
            n += 2
        if s.add_positional_dist:
            n += self.num_users - 1
        if s.piggybacking:
            n += self.num_channels * (self.num_channels - 1)
        if self.enable_fingerprint:
            n += 2
        if s.add_positional_dist_piggy:
            n += s.num_bins
        return n


@dataclass(frozen=True)
class NetworkConfig:
    """Q-network architecture (nested ``network:`` block, drl_drqn.py:49-53)."""

    use_lstm_input: bool = True
    use_dueling: bool = False
    use_double: bool = True
    skip_error: int = 0
    layers: tuple[int, ...] = (256, 256)
    activation: str = "relu"
    use_conv: bool = False
    # "bfloat16" casts activations/weights for the matmuls (f32 master
    # params, f32 accumulation) -- the TPU MXU's native fast path.
    compute_dtype: str = "float32"
    # LSTM lowering: "auto" uses the fused Pallas window kernel
    # (ops/pallas_lstm.py) on TPU when shapes/dtype allow, else the XLA
    # lstm_scan; "pallas" / "xla" force one path (pallas interprets on CPU).
    lstm_impl: str = "auto"
    # cuDNN_support / num_gpu are accepted from reference YAML and ignored:
    # device placement is the mesh's concern here.


@dataclass(frozen=True)
class AgentConfig:
    """RL-agent hyperparameters (``RLAgent`` block, drl_drqn.py:32-53)."""

    algorithm: str = "DRQN"
    policy: str = "eps_greedy"          # eps_greedy | softmax | boltzman | greedy
    batch_size: int = 64
    n_batch: int = 2                    # gradient steps per train() call
    target_update: int = 10             # slots between target-network syncs
    learning_rate: float = 1e-4
    gamma: float = 0.99
    step_size: int = 5                  # LSTM history window
    unroll_step: int = 8                # truncated-BPTT window (ps_drqn.py:34)
    training_freq: int = 1
    memory_size: int = 1024             # ps_dqn-style ring size
    hysteretic: bool = False
    eps_init: float = 1.0
    eps_decay: float = 0.9999
    eps_min: float = 0.001              # floor, policies.py:62-63
    explore_start: float = 4.0
    explore_stop: float = 4.0
    decay_rate: float = 4.0
    alpha: float = 1.0
    beta: float = 1.0
    temperature: float = 0.001
    # PPO-specific (reference algorithms/ps_ppo.py:11-18)
    a_lr: float = 1e-4
    c_lr: float = 1e-4
    update_step: int = 2
    eps_clip: float = 0.2
    entropy_coef: float = 0.1
    network: NetworkConfig = field(default_factory=NetworkConfig)


@dataclass(frozen=True)
class EngineConfig:
    """New-framework knobs: vectorization, sharding, numerics. Not in reference YAMLs."""

    num_envs: int = 1                   # parallel env instances (vmapped)
    seed: int = 0
    dtype: str = "float32"              # env/compute dtype; tests use float64
    mesh_axes: tuple[str, ...] = ("data",)
    mesh_shape: tuple[int, ...] = (-1,)  # -1: all available devices
    donate: bool = True
    # Replay window-gather lowering: "gather" (one batched gather; XLA
    # copies the whole loop-carried ring for its operand), "scan"
    # (sequential single-window dynamic slices; alias in place), or
    # "auto" (scan once the ring is large enough that the copy dominates
    # -- the 100v/50r configs; see loop._gather_flat_windows).
    gather_impl: str = "auto"


@dataclass(frozen=True)
class ExperimentConfig:
    """Top-level run control (main_test.py:16-41) plus the sections above."""

    experiment_name: str = ""
    realness: bool = False
    time_slots: int = 10000
    simulations: int = 3
    memory_size: int = 1200             # DRQN window-replay deque size
    pretrain_length: int = 6
    step_size: int = 5
    save_freq: int = 1000
    save_results: bool = True
    save_model: bool = False
    load_model: bool = False
    load_slot: int = 4999
    training: bool = False
    episode_interval: int = 25
    explore: int = 2000                 # random-action slots
    greedy: int = 20000                 # greedy-only after this slot
    training_stop: int = 20000
    train_after_episode: bool = False
    global_reward_avg: bool = False
    save_positions: bool = False
    enable_channel: bool = False        # use the PRR-style my_step_ch
    ia_penalty_enable: bool = False
    ia_penalty_threshold: int = 5
    ia_penalty_value: float = -10.0
    ia_averaging: bool = False
    env: EnvConfig = field(default_factory=EnvConfig)
    env_real: dict = field(default_factory=dict)  # EnvironmentReal passthrough
    agent: AgentConfig = field(default_factory=AgentConfig)
    engine: EngineConfig = field(default_factory=EngineConfig)


# ---------------------------------------------------------------------------
# YAML loading
# ---------------------------------------------------------------------------

# Reference-YAML keys that exist but are consumed by nothing (or by dead code);
# accepted and dropped, recorded for transparency.
_IGNORED_TOP = {"attempt_prob", "plot_interval", "action_skip_enable"}
_IGNORED_AGENT = {"pretrain_length", "hidden_size", "noise"}
_IGNORED_NETWORK = {"cuDNN_support", "num_gpu"}

_ENV_KEY_MAP = {  # EnvironmentTest YAML key -> EnvConfig field
    "congestion_test": "congestion_test",
    "load_positions": "load_positions",
    "load_file_pos": "load_file_pos",
    "num_channels": "num_channels",
    "num_users": "num_users",
    "mobility": "mobility",
    "mobility_vary": "mobility_vary",
    "highway_length": "highway_length",
    "enable_fingerprint": "enable_fingerprint",
    "reward_design": "reward_design",
    "communication_range": "communication_range",
    "bin_range": "bin_range",
    "topology": "topology",
    "radius": "radius",
    "enable_design_topology": "enable_design_topology",
    "proportional_fair": "proportional_fair",
    # the port's one addition to the schema: the channel step's
    # implementation knob, so that a YAML can force K5 below the auto
    # gate's N >= 32 (configs/torch_dynamic_20v_15r_kernels.yaml; the
    # histogram's knob, State's ``hist_impl``, is in the schema already)
    "step_impl": "step_impl",
}


def _build(cls, data: dict[str, Any], ignored: set[str], where: str):
    fields = {f.name for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in data.items():
        if key in ignored:
            continue
        if key not in fields:
            raise KeyError(f"unknown key {key!r} in {where}")
        kwargs[key] = value
    return cls(**kwargs)


def from_dict(raw: dict[str, Any]) -> ExperimentConfig:
    """Build an ExperimentConfig from a reference-schema dict."""
    raw = dict(raw)

    # --- EnvironmentTest + nested State --------------------------------
    env_raw = dict(raw.pop("EnvironmentTest", {}))
    state_raw = dict(env_raw.pop("State", {}))
    state = _build(StateConfig, state_raw, set(), "EnvironmentTest.State")
    env_kwargs: dict[str, Any] = {}
    for key, value in env_raw.items():
        if key not in _ENV_KEY_MAP:
            raise KeyError(f"unknown key {key!r} in EnvironmentTest")
        env_kwargs[_ENV_KEY_MAP[key]] = value
    env = dataclasses.replace(EnvConfig(**env_kwargs), state=state)

    env_real = dict(raw.pop("EnvironmentReal", {}))

    # --- RLAgent + nested network --------------------------------------
    agent_raw = dict(raw.pop("RLAgent", {}))
    net_raw = dict(agent_raw.pop("network", {}))
    if "layers" in net_raw:
        layers = net_raw["layers"]
        if isinstance(layers, dict):
            # Reference writes layers as {1: 256, 2: 256} (config yaml:98-100).
            layers = tuple(v for _, v in sorted(layers.items()))
        net_raw["layers"] = tuple(layers)
    network = _build(NetworkConfig, net_raw, _IGNORED_NETWORK, "RLAgent.network")
    # Reference-compat shim: "pretrain_length: batch_size" is an unparsed
    # string in the reference config; main_test.py's default wins.
    agent = _build(AgentConfig, agent_raw, _IGNORED_AGENT, "RLAgent")
    agent = dataclasses.replace(agent, network=network)

    # --- Engine (new-framework only) -----------------------------------
    engine_raw = dict(raw.pop("Engine", {}))
    for key in ("mesh_axes", "mesh_shape"):
        if key in engine_raw:
            engine_raw[key] = tuple(engine_raw[key])
    engine = _build(EngineConfig, engine_raw, set(), "Engine")

    # --- Top level ------------------------------------------------------
    top = _build(
        ExperimentConfig,
        {k: v for k, v in raw.items() if k not in _IGNORED_TOP},
        set(),
        "top level",
    )
    return dataclasses.replace(
        top, env=env, env_real=env_real, agent=agent, engine=engine
    )


def load_config(path: str) -> ExperimentConfig:
    """Load a reference-format (or extended) YAML experiment file."""
    with open(path) as f:
        raw = yaml.safe_load(f)
    if not isinstance(raw, dict):
        raise ValueError(f"{path}: expected a mapping at top level")
    return from_dict(raw)


def toy_4ue_3r(**overrides) -> ExperimentConfig:
    """The 4ue_3r_toy flagship config (reference configs/4ue_3r_toy/..dis_07.yaml),
    expressed natively. ``overrides`` replace top-level fields."""
    cfg = ExperimentConfig(
        experiment_name="toy_4ue_3r",
        time_slots=250002,
        simulations=1,
        episode_interval=25,
        memory_size=1024,
        step_size=6,
        save_freq=50000,
        training=True,
        explore=2000,
        greedy=200000,
        training_stop=230000,
        train_after_episode=True,
        global_reward_avg=True,
        save_positions=True,
        enable_channel=False,
        env=EnvConfig(
            congestion_test=True,
            num_channels=3,
            num_users=4,
            mobility=True,
            highway_length=100,
            reward_design=2,
            communication_range=250,
            state=StateConfig(
                type=2,
                add_action=True,
                action_index="binary",
                add_positional_dist_piggy=True,
                add_positional_dist_type=2,
                num_bins=20,
            ),
        ),
        agent=AgentConfig(
            algorithm="DRQN",
            policy="eps_greedy",
            batch_size=512,
            n_batch=2,
            target_update=200,
            learning_rate=1e-4,
            eps_init=0.99,
            eps_decay=0.9992,
            explore_start=0.99,
            explore_stop=0.001,
            decay_rate=0.001,
            gamma=0.7,
            step_size=6,
            alpha=0.0,
            beta=1.0,
            temperature=0.05,
            network=NetworkConfig(
                use_lstm_input=True,
                use_dueling=False,
                use_double=True,
                skip_error=0,
                layers=(256, 256),
            ),
        ),
    )
    return dataclasses.replace(cfg, **overrides) if overrides else cfg
