"""Agent-side simulator bridge, API-compatible with the reference
``RealNeSZmqBridge`` (reference envs/realness_bridge.py:10-240).

Serves scheduling requests from the external simulator on a bound reply
socket (one request per agent decision, sequence-numbered), answers each
with a grant carrying the chosen action in ``time_stamp``
(realness_bridge.py:124-136), and pulls delayed rewards from the reward
collector on a second request socket (realness_bridge.py:210-223)."""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from diral_tpu_torch.interop import wire as pb
from diral_tpu_torch.interop.transport import make_rep_socket, make_req_socket

REWARD_COLLECTOR_PORT = 5557  # realness_bridge.py:68


class RealNeSBridge:
    def __init__(self, port: int = 5555, reward_port: int | None = None,
                 reward_host: str = "localhost", timeout: float | None = 30.0,
                 disable_one_user: bool = True, transport: str = "framed"):
        self.port = int(port)
        self.timeout = timeout
        self.reward_host = reward_host
        self.reward_port = reward_port  # None: connect lazily on first use
        # transport flavor: "framed" (length-prefixed TCP) or "zmq" (real
        # libzmq REP/REQ, the reference's wire) -- see interop/transport.py
        self.transport = transport
        self.socket = make_rep_socket(self.port, kind=transport,
                                      timeout=timeout)
        if self.port == 0:
            self.port = self.socket.port
        self.socket_rewards = None
        # Reference quirk: one user is disabled on the simulator side, so the
        # agent-visible population is total_users - 1 (realness_bridge.py:88).
        self.disable_one_user = disable_one_user
        self._total_users = None
        self._action_space = None
        self._observation_space = None
        self._state_space_type = None

    # -- lifecycle ------------------------------------------------------

    def initialize_env(self):
        """Receive the simulator's init handshake and ack it
        (realness_bridge.py:78-97)."""
        msg = pb.MA_SimInitMsg.FromString(self.socket.recv())
        self._total_users = msg.total_users - (1 if self.disable_one_user else 0)
        self._state_space_type = msg.state_space_type
        self._action_space = msg.action_space
        self._observation_space = msg.state_space
        ack = pb.MA_SimInitAck(done=False, stopSimReq=False)
        self.socket.send(ack.SerializeToString())

    def restart_sockets(self):
        """realness_bridge.py:99-110."""
        self.socket.close()
        if self.socket_rewards is not None:
            self.socket_rewards.close()
            self.socket_rewards = None
        self.socket = make_rep_socket(self.port, kind=self.transport,
                                      timeout=self.timeout)

    def restart_env(self):
        """Answer the next scheduling request with a stop grant
        (realness_bridge.py:228-240)."""
        self.socket.recv()
        grant = pb.MA_SchedulingGrant(time_stamp=-1, stop_simulation=True)
        self.socket.send(grant.SerializeToString())

    # -- getters (realness_bridge.py:112-122) ---------------------------

    def get_total_users(self):
        return self._total_users

    def get_action_space(self):
        return self._action_space

    def get_observation_space(self):
        return self._observation_space

    def get_state_type(self):
        return self._state_space_type

    # -- request/grant cycle -------------------------------------------

    def send_action(self, action: int) -> bool:
        grant = pb.MA_SchedulingGrant(time_stamp=int(action),
                                      stop_simulation=False)
        self.socket.send(grant.SerializeToString())
        return True

    def get_observation(self):
        msg = pb.MA_SchedulingRequest.FromString(self.socket.recv())
        return msg.user_id, msg.SN, np.array(msg.state)

    def get_observation_syn(self):
        msg = pb.MA_SchedulingRequestSyn.FromString(self.socket.recv())
        return msg.user_id, msg.SN, np.array(msg.state), msg.reward

    def get_observation_syn_dist(self):
        """Neighbor-table flavored request (realness_bridge.py:168-191);
        returns the table as the reference's nested-dict layout."""
        msg = pb.MA_SchedulingRequestSynDist.FromString(self.socket.recv())
        pos_of_neighbors = defaultdict(dict)
        for i, e in enumerate(msg.neighbor):
            pos_of_neighbors[i]["xpos"] = e.pos_x
            pos_of_neighbors[i]["ypos"] = e.pos_y
            pos_of_neighbors[i]["seq_number"] = e.seq_num
            pos_of_neighbors[i]["last_updated"] = e.last_update
        return msg.user_id, msg.SN, pos_of_neighbors, msg.reward

    def get_observation_syn_sps(self):
        msg = pb.SPS_SchedulingRequestSyn.FromString(self.socket.recv())
        return msg.user_id, msg.SN, np.array(msg.state), msg.reward

    # -- delayed rewards ------------------------------------------------

    def receive_rewards(self):
        """Poll the reward collector (realness_bridge.py:210-223)."""
        if self.socket_rewards is None:
            self.socket_rewards = make_req_socket(
                self.reward_host, self.reward_port or REWARD_COLLECTOR_PORT,
                kind=self.transport, timeout=self.timeout,
            )
        self.socket_rewards.send(b"Send my rewards")
        return pb.MA_RewardSentAll.FromString(self.socket_rewards.recv())

    def close(self):
        self.socket.close()
        if self.socket_rewards is not None:
            self.socket_rewards.close()
