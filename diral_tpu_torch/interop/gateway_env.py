"""External-simulator environment adapter -- the ``RealnessEnv`` equivalent
(reference envs/realness_env.py), driving the bridge instead of stepping the
in-process world.

The event model is the reference's: the simulator issues one
sequence-numbered scheduling request per agent decision; the adapter turns
each request's piggybacked neighbor table into the positional-distribution
state (realness_env.py:52-118), maps the reported PRR through the reward
designs (realness_env.py:377-394), and answers with a grant carrying the
action.  Simulator process control launches the in-repo C++ toy-RealNeS
instead of the reference's absent ``start_debug.sh`` B4G scripts
(realness_env.py:224-252).

Copied from diral_tpu/interop/gateway_env.py (numpy, no torch).  What
differs: the simulator is the port's copy (``cpp/``, built with g++
alone against the ``wire.h`` codec) and builds at first use into
``build/diral_tpu_torch/`` at the repository root, named by its sources'
hash, never into the source tree; a ``zmq`` session hands the simulator
the libzmq that ``transport.libzmq_path`` found (the system's, else the
copy in pyzmq's wheel), and refuses to start where there is none, instead
of waiting out the bridge's timeout."""

from __future__ import annotations

import hashlib
import math
import os
import subprocess
from pathlib import Path

import numpy as np

from diral_tpu_torch.interop.bridge import RealNeSBridge
from diral_tpu_torch.interop.transport import libzmq_error, libzmq_path

CPP_DIR = Path(__file__).resolve().parent / "cpp"
BUILD_DIR = CPP_DIR.parents[2] / "build" / "diral_tpu_torch"
STALENESS_CUTOFF = 20


def sim_binary() -> Path:
    """Where the simulator built from the current sources lives."""
    h = hashlib.sha256()
    for name in ("Makefile", "realnes_sim.cc", "wire.h"):
        h.update((CPP_DIR / name).read_bytes())
    return BUILD_DIR / f"realnes_sim-{h.hexdigest()[:16]}"


def build_simulator(force: bool = False) -> str:
    """Build the C++ stand-in if needed; returns the binary path.  The
    build writes a name of its own and renames it into place, so two
    processes that build at once both end with a whole binary."""
    target = sim_binary()
    if force or not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        try:
            res = subprocess.run(
                ["make", "-s", "-C", str(CPP_DIR), f"OUT={tmp}"],
                capture_output=True, text=True)
            if res.returncode != 0:
                raise RuntimeError("building the simulator failed:\n"
                                   + res.stdout + res.stderr)
            os.replace(tmp, target)
        finally:
            tmp.unlink(missing_ok=True)
    return str(target)


def _signed_dists(tx_id: int, table: dict) -> list[float]:
    """Signed distances to fresh neighbors (realness_env.py:60-74,193-207).
    Bit-exactness note: the squares go through ``**2`` (libm pow) with the
    reference's operand order (tx - rx), because libm pow(x, 2.0) can be
    1 ULP away from x*x -- measured in this image -- and the golden tests
    (tests/test_realness_parity.py) assert exact equality."""
    dists = []
    for rx_id in range(len(table)):
        if rx_id == tx_id or table[rx_id]["last_updated"] > STALENESS_CUTOFF:
            continue
        x1, y1 = table[rx_id]["xpos"], table[rx_id]["ypos"]
        x2, y2 = table[tx_id]["xpos"], table[tx_id]["ypos"]
        d = math.sqrt((x2 - x1) ** 2 + (y2 - y1) ** 2)
        dists.append(d if x1 - x2 > 0.0 else -d)
    return dists


def neighbor_dist_type1(tx_id: int, table: dict, bins: int) -> np.ndarray:
    """Inf-norm-normalized weighted histogram over [-1, 1] from a received
    neighbor table (realness_env.py:52-85)."""
    dists = _signed_dists(tx_id, table)
    if not dists:
        return np.zeros(bins, dtype=int)
    edges = np.linspace(-1, 1, bins + 1)
    norm = np.linalg.norm(dists, np.inf)
    if norm == 0.0:
        # every fresh neighbor sits exactly at the requester's position
        # (e.g. the phantom (0, 0) rows of a fresh table): the reference
        # divides 0/0 and serves NaN to the net (realness_env.py:75-80);
        # here the direction-free case is the zero histogram, same as the
        # no-neighbor case above (documented in PARITY.md deviations)
        return np.zeros(bins, dtype=int)
    normed = np.array(sorted(dists)) / norm
    return np.histogram(normed, edges, weights=normed)[0]


def neighbor_dist_type2(tx_id: int, table: dict, bins: int,
                        state_range: float) -> np.ndarray:
    """Count histogram over +-state_range / neighbor count
    (realness_env.py:87-118)."""
    dists = _signed_dists(tx_id, table)
    if not dists:
        return np.zeros(bins, dtype=int)
    counts = np.histogram(sorted(dists), bins, range=(-state_range, state_range))[0]
    return counts / float(len(dists))


def prr_to_reward(prr: float, design: int) -> float:
    """PRR -> reward mapping (realness_env.py:377-394)."""
    if design == 4:
        return math.exp(prr) if prr > 0.95 else -math.exp(1.0 - prr)
    if design == 3:
        return 1.0 if prr > 0.95 else -math.exp(1.0 - prr)
    if design == 2:
        return 1.0 if prr > 0.95 else -(1.0 - prr)
    return prr


def syn_reward(reward: float) -> float:
    """RSSI-path reward thresholding (realness_env.py:352-357): a delivery
    ratio above 0.9 rounds to +1, anything below maps to -exp(1 - r)."""
    return 1.0 if reward > 0.9 else -math.exp(1.0 - reward)


def distance_based_rewards(acts, pos, action_size: int) -> dict[int, float]:
    """Per-user reward from reported actions + x-positions
    (realness_env.py:120-191): sole transmitter on a resource earns +1; two
    co-channel transmitters earn ``2*exp(d/dmax-like weight) - 2`` scaled by
    how far apart they are relative to the widest user span (far pairs are
    spatially reused, near pairs collide); three or more earn -count.

    Returns a dict keyed by user id.  NOTE the reference returns
    ``rews.values()`` -- a dict-values view whose iteration order is
    RESOURCE-grouped (users sharing a channel appear consecutively), not
    user-ordered (realness_env.py:146-152); callers needing per-user order
    must index the dict, which is what this returns."""
    rews: dict[int, float] = {}
    for res in range(action_size):
        transmitters = [u for u in range(len(acts)) if acts[u] == res]
        if not transmitters:
            continue
        if len(transmitters) == 1:
            reward = 1.0
        elif len(transmitters) == 2:
            # weight = exp(dist)/exp(span) (realness_env.py:154-191), with
            # the reference's sqrt((a-b)**2) spelling for bit-exactness;
            # beyond span ~700 (where the reference's exp overflows) the
            # mathematically identical exp(dist - span) takes over
            d = math.sqrt(
                (pos[transmitters[1]] - pos[transmitters[0]]) ** 2)
            span = math.sqrt((max(pos) - min(pos)) ** 2)
            if span < 700.0:
                reward = 2.0 * (math.exp(d) / math.exp(span)) - 2.0
            else:
                reward = 2.0 * math.exp(d - span) - 2.0
        else:
            reward = -float(len(transmitters))
        for u in transmitters:
            rews[u] = reward
    return rews


class GatewayEnv:
    """Reference ``RealnessEnv`` public surface over the framed-TCP bridge."""

    def __init__(self, env_name: str = "gateway", **kwargs):
        self.env_name = env_name
        self.port = kwargs.setdefault("port", 5555)
        self.start_sim = kwargs.setdefault("sim_start", False)
        self.sim_seed = kwargs.setdefault("sim_seed", 0)
        self.reward_design = kwargs.setdefault("reward_design", 4)
        self.distance_based_reward = kwargs.setdefault(
            "distance_based_reward", False)
        self.state_design = kwargs.setdefault("state_design", 1)
        self.pos_dist = kwargs.setdefault("pos_dist", 2)
        self.state_range = kwargs.setdefault("state_range", 250)
        self.state_bins = kwargs.setdefault("state_bins", 10)
        self.add_reward = kwargs.setdefault("add_reward", False)
        self.add_index = kwargs.setdefault("add_index", False)
        self.sim_users = kwargs.setdefault("sim_users", 4)
        self.sim_channels = kwargs.setdefault("sim_channels", 3)
        self.sim_rounds = kwargs.setdefault("sim_rounds", 1000)
        self.sim_reward_port = kwargs.setdefault("sim_reward_port", 0)
        # request flavor the simulator emits: dist | syn | sps (see
        # cpp/realnes_sim.cc mode table)
        self.sim_mode = kwargs.setdefault("sim_mode", "dist")
        # wire transport: framed (length-prefixed TCP) or zmq (real libzmq,
        # the reference's transport) -- both sides must agree
        self.sim_transport = kwargs.setdefault("sim_transport", "framed")

        self.bridge = RealNeSBridge(
            self.port,
            reward_port=self.sim_reward_port or None,
            reward_host="127.0.0.1",
            transport=self.sim_transport,
        )
        if self.port == 0:
            self.port = self.bridge.port
        self.sim_process: subprocess.Popen | None = None
        if self.start_sim:
            self.start_realnes()

        self.action_size = None
        self.state_space = None
        self.state_type = None
        self.obs_size = None
        self.rssi_norm = -97  # lowest detected RSSI (realness_env.py:34)
        self.last_actions: dict[int, int] = {}
        self.first_transmissions: dict[int, bool] = {}

    # -- simulator process control (realness_env.py:224-252) ------------

    def start_realnes(self):
        zmq_lib = None
        if self.sim_transport == "zmq":
            why = libzmq_error()
            if why is not None:
                raise RuntimeError(
                    "transport 'zmq': the simulator loads libzmq at run time "
                    f"and cannot here ({why}); use 'framed'")
            zmq_lib = libzmq_path()
        binary = build_simulator()
        argv = [binary, "127.0.0.1", str(self.port), str(self.sim_users),
                str(self.sim_channels), str(self.sim_rounds),
                str(self.sim_seed)]
        nondefault_tail = self.sim_transport != "framed"
        if self.sim_reward_port or self.sim_mode != "dist" or nondefault_tail:
            argv.append(str(self.sim_reward_port))
        if self.sim_mode != "dist" or nondefault_tail:
            argv.append(self.sim_mode)
        if nondefault_tail:
            argv.append(self.sim_transport)
        if zmq_lib is not None:
            argv.append(zmq_lib)
        self.sim_process = subprocess.Popen(
            argv, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )

    def stop_realnes(self):
        if self.sim_process is not None:
            self.sim_process.terminate()
            self.sim_process.wait(timeout=10)
            self.sim_process = None

    def restart_simulation(self):
        """Kill + rebind + respawn (realness_env.py:236-252)."""
        self.stop_realnes()
        self.bridge.restart_sockets()
        self.start_realnes()

    # -- handshake / sizing (realness_env.py:273-301) --------------------

    def initialize_env(self):
        self.bridge.initialize_env()
        self.action_size = self.bridge.get_action_space()
        self.obs_size = self.bridge.get_observation_space()
        self.state_type = self.bridge.get_state_type()
        if self.state_design == 1:
            self.state_space = self.action_size + self.obs_size
        elif self.state_design == 2:
            self.state_space = self.action_size + self.state_bins
        if self.state_type == 7:
            self.state_space = self.action_size + self.state_bins
        if self.add_reward:
            self.state_space += 1
        if self.add_index:
            self.state_space += 1
        for user in range(self.bridge.get_total_users() + 1):
            self.last_actions[user] = 1  # realness_env.py:296-299
            self.first_transmissions[user] = True

    # -- observation paths ----------------------------------------------

    def get_observation(self):
        """Plain (non-synchronized) state path (realness_env.py:330-331):
        the raw per-request observation, no reward attached."""
        return self.bridge.get_observation()

    def get_observation_syn(self):
        """RSSI/traffic request -> (user_id, sn, state, reward)
        (realness_env.py:333-358).

        State types 2/5/6 carry per-channel RSSI in dB: normalized as
        ``(s - rssi_norm) / rssi_norm`` with rssi_norm = -97 (the noise
        floor maps near 0, hot channels go negative).  State type 1 carries
        detected traffic: the UE's own last-transmit channel is zeroed
        (half duplex).  The reward thresholds through ``syn_reward``."""
        user_id, sn, state, reward = self.bridge.get_observation_syn()
        self.last_prr = reward  # raw delivery ratio before thresholding
        state = np.asarray(state, np.float64)
        if self.state_type in (2, 5, 6):
            state = (state - self.rssi_norm) / self.rssi_norm
        elif self.state_type == 1:
            state[self.last_actions[user_id]] = 0
        return user_id, sn, state, syn_reward(reward)

    def get_observation_syn_sps(self):
        """SPS selection window -> (user_id, sn, rssi window, raw reward)
        (realness_bridge.py:195-208; the reference applies no mapping on
        this path -- SPS consumes raw RSSI, the reward is telemetry)."""
        return self.bridge.get_observation_syn_sps()

    def set_last_action(self, user: int, action: int):
        """realness_env.py:209-216."""
        self.last_actions[user] = action

    def get_observation_syn_dist(self):
        """Neighbor-table request -> (user_id, sn, state, reward, pos_x)
        (realness_env.py:360-396)."""
        user_id, sn, table, prr = self.bridge.get_observation_syn_dist()
        tx = user_id - 1 if self.bridge.disable_one_user else user_id
        pos_x = table[tx]["xpos"]
        self.last_prr = prr  # raw PRR telemetry for eval/comparison loops
        if self.pos_dist == 1:
            state = neighbor_dist_type1(tx, table, self.state_bins)
        elif self.pos_dist == 2:
            state = neighbor_dist_type2(tx, table, self.state_bins,
                                        self.state_range)
        else:
            raise ValueError("pos_dist must be 1 or 2")
        return user_id, sn, state, prr_to_reward(prr, self.reward_design), pos_x

    def apply_action(self, action: int):
        self.bridge.send_action(action)

    def receive_rewards(self):
        """SN-keyed delayed rewards (realness_env.py:303-315)."""
        rewards = self.bridge.receive_rewards().all_rewards
        rews: dict[int, dict[int, float]] = {}
        values = []
        for r in rewards:
            rews.setdefault(r.user_id, {})[r.SN] = r.reward
            values.append(r.reward)
        return rews, values

    # -- surface getters -------------------------------------------------

    def get_action_space(self):
        return self.action_size

    def get_state_space(self):
        return self.state_space

    def get_total_users(self):
        return self.bridge.get_total_users()

    def get_state_type(self):
        return self.state_type

    def get_add_reward_flag(self):
        return self.add_reward

    def get_add_index_flag(self):
        return self.add_index

    def obtain_state(self, obs, acts, rewards):
        """DRQN state assembly (realness_env.py:413-434): one-hot action +
        channel obs (+ reward, + index)."""
        out = []
        for u in range(len(obs)):
            vec = np.zeros(self.action_size)
            vec[int(acts[u])] = 1.0
            vec = np.append(vec, obs[u])
            if self.add_reward:
                vec = np.append(vec, rewards[u])
            if self.add_index:
                vec = np.append(vec, u + 1)
            out.append(vec)
        return out

    def close(self):
        self.stop_realnes()
        self.bridge.close()
