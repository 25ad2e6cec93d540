"""The port's interop layer (diral_tpu_torch/interop) against the JAX
package's (diral_tpu/interop).

* The wire codec (interop/wire.py): for each of the 11 messages of
  ma_messages.proto, over hypothesis-generated values, the codec's bytes
  equal protobuf's ``SerializeToString`` and each side parses the other's
  bytes to the same fields; packed repeated scalars and unknown fields
  parse as protobuf parses them.
* The simulators: the port's realnes_sim (built with g++ alone against
  cpp/wire.h) sends the same request bytes, and its reward collector the
  same reply bytes, as the JAX package's (built with protoc and
  libprotobuf) on the same seed and actions, in all three request modes;
  the port's bridge serves the JAX sim and JAX's bridge the port's sim.
* The gateway's numpy functions bit-equal to JAX's on seeded inputs.
* Counterparts of tests/test_interop.py and tests/test_transport_seam.py
  run on the port.

The JAX sim is built once per version of its sources into build/tests/
(the JAX package's own build writes into its source tree; these tests
leave that alone).
"""

import hashlib
import os
import shutil
import socket
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from diral_tpu.interop import gateway_env as jgw
from diral_tpu.interop import ma_messages_pb2 as pb
from diral_tpu_torch.interop import gateway_env as tgw
from diral_tpu_torch.interop import wire
from diral_tpu_torch.interop.bridge import RealNeSBridge
from diral_tpu_torch.interop.transport import (RepSocket, ReqSocket,
                                               libzmq_error, make_rep_socket)

ROOT = Path(__file__).resolve().parents[1]
JAX_INTEROP = ROOT / "diral_tpu" / "interop"
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")
needs_jax_sim = pytest.mark.skipif(
    shutil.which("g++") is None or shutil.which("protoc") is None,
    reason="the JAX package's simulator needs g++, protoc and libprotobuf")


def jax_sim_binary() -> str:
    """The JAX package's realnes_sim, built from its sources with protoc +
    libprotobuf into build/tests/ (a temporary name renamed into place, so
    test workers that build at once do not clash)."""
    src = JAX_INTEROP / "cpp" / "realnes_sim.cc"
    proto = JAX_INTEROP / "ma_messages.proto"
    digest = hashlib.sha256(src.read_bytes() + proto.read_bytes()).hexdigest()
    out_dir = ROOT / "build" / "tests"
    target = out_dir / f"jax_realnes_sim-{digest[:16]}"
    if target.exists():
        return str(target)
    work = out_dir / f"jax_sim.{os.getpid()}.tmp"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    try:
        shutil.copy(src, work / "realnes_sim.cc")
        subprocess.run(["protoc", f"--proto_path={JAX_INTEROP}",
                        f"--cpp_out={work}", "ma_messages.proto"], check=True)
        subprocess.run(["g++", "-O2", "-std=c++17", f"-I{work}",
                        str(work / "realnes_sim.cc"),
                        str(work / "ma_messages.pb.cc"), "-o",
                        str(work / "realnes_sim"), "-lprotobuf", "-lpthread",
                        "-ldl"], check=True)
        os.replace(work / "realnes_sim", target)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return str(target)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# -- the codec vs protobuf ---------------------------------------------------

_SCALAR = {
    wire.INT32: st.integers(-(1 << 31), (1 << 31) - 1),
    wire.BOOL: st.booleans(),
    wire.FLOAT: st.floats(width=32, allow_nan=False),
    wire.DOUBLE: st.floats(allow_nan=False),
}


def _values(cls):
    """A strategy of {field: value} for ``cls``: required fields always,
    optional ones sometimes, repeated ones 0-4 long."""
    fields = {}
    for _, name, kind, label, sub in cls.FIELDS:
        one = _values(sub) if kind == wire.MESSAGE else _SCALAR[kind]
        if label == wire.REPEATED:
            fields[name] = st.lists(one, max_size=4)
        elif label == wire.OPTIONAL:
            fields[name] = st.one_of(st.none(), one)
        else:
            fields[name] = one
    return st.fixed_dictionaries(fields)


def _to_wire(cls, values):
    kw = {}
    for _, name, kind, label, sub in cls.FIELDS:
        v = values[name]
        if kind == wire.MESSAGE:
            v = [_to_wire(sub, x) for x in v]
        kw[name] = v
    return cls(**kw)


def _to_pb(cls, values):
    msg = getattr(pb, cls.__name__)()
    for _, name, kind, label, sub in cls.FIELDS:
        v = values[name]
        if kind == wire.MESSAGE:
            for x in v:
                getattr(msg, name).append(_to_pb(sub, x))
        elif label == wire.REPEATED:
            getattr(msg, name).extend(v)
        elif v is not None:
            setattr(msg, name, v)
    return msg


def _pb_fields(msg, cls):
    """A protobuf message's set fields in the codec's terms."""
    out = {}
    for _, name, kind, label, sub in cls.FIELDS:
        if label == wire.REPEATED:
            v = list(getattr(msg, name))
            out[name] = [_pb_fields(x, sub) for x in v] \
                if kind == wire.MESSAGE else v
        elif msg.HasField(name):
            out[name] = getattr(msg, name)
    return out


def _wire_fields(msg):
    return {k: ([_wire_fields(x) for x in v]
                if v and isinstance(v[0], wire.Message) else v)
            if isinstance(v, list) else v
            for k, v in msg._values.items()}


def test_codec_covers_the_schema():
    """The codec's 11 classes are the proto's messages, field for field
    (name, number, type, label, nested type) against protobuf's
    descriptor."""
    from google.protobuf.descriptor import FieldDescriptor as FD

    kinds = {FD.TYPE_INT32: wire.INT32, FD.TYPE_BOOL: wire.BOOL,
             FD.TYPE_FLOAT: wire.FLOAT, FD.TYPE_DOUBLE: wire.DOUBLE,
             FD.TYPE_MESSAGE: wire.MESSAGE}
    assert sorted(c.__name__ for c in wire.MESSAGES) == \
        sorted(pb.DESCRIPTOR.message_types_by_name)
    for cls in wire.MESSAGES:
        desc = pb.DESCRIPTOR.message_types_by_name[cls.__name__]
        want = []
        for f in desc.fields:
            label = (wire.REPEATED if f.label == FD.LABEL_REPEATED else
                     wire.REQUIRED if f.label == FD.LABEL_REQUIRED else
                     wire.OPTIONAL)
            sub = f.message_type.name if f.message_type else None
            want.append((f.number, f.name, kinds[f.type], label, sub))
        got = [(n, name, k, lab, s.__name__ if s else None)
               for n, name, k, lab, s in cls.FIELDS]
        assert sorted(got) == sorted(want), cls.__name__


@pytest.mark.parametrize("cls", wire.MESSAGES, ids=lambda c: c.__name__)
def test_codec_bytes_equal_protobuf(cls):
    @settings(max_examples=60, deadline=None, database=None,
              suppress_health_check=[HealthCheck.too_slow])
    @given(_values(cls))
    def check(values):
        ours, theirs = _to_wire(cls, values), _to_pb(cls, values)
        data = ours.SerializeToString()
        assert data == theirs.SerializeToString()
        assert cls.FromString(data) == ours
        back = getattr(pb, cls.__name__).FromString(data)
        assert _pb_fields(back, cls) == _wire_fields(ours)

    check()


def test_codec_parses_packed_and_unknown_fields():
    """Packed repeated scalars and fields the schema does not know parse
    as protobuf parses them; a missing required field fails both ways."""
    packed_ints = b"".join(wire._varint(v) for v in (3, -7, 1 << 30))
    packed_dbl = np.array([-117.0, 2.5], "<f8").tobytes()
    data = (b"\x08\x05" + b"\x12" + wire._varint(len(packed_ints))
            + packed_ints + b"\x18\x02" + b"\x25" + np.float32(0.5).tobytes()
            + b"\x78\x09" + b"\x7a\x02hi")          # fields 15 (varint, bytes)
    ours = wire.MA_SchedulingRequestSyn.FromString(data)
    theirs = pb.MA_SchedulingRequestSyn.FromString(data)
    assert _wire_fields(ours) == _pb_fields(theirs,
                                            wire.MA_SchedulingRequestSyn)
    assert ours.state == [3, -7, 1 << 30]
    data = (b"\x08\x01\x12" + wire._varint(len(packed_dbl)) + packed_dbl
            + b"\x18\x00\x25" + np.float32(1.0).tobytes())
    assert wire.SPS_SchedulingRequestSyn.FromString(data).state == \
        list(pb.SPS_SchedulingRequestSyn.FromString(data).state)
    with pytest.raises(wire.EncodeError):
        wire.MA_SchedulingGrant(stop_simulation=True).SerializeToString()
    with pytest.raises(wire.DecodeError):
        wire.MA_SchedulingGrant.FromString(b"\x10\x01")
    with pytest.raises(wire.DecodeError):
        wire.MA_RewardSent.FromString(b"\x08")


# -- counterparts of tests/test_interop.py -----------------------------------

def test_proto_roundtrip_wire_numbers():
    """Field numbers match the reference descriptor, so a real RealNeS
    peer interoperates (envs/ma_messages_pb2.py serialized_pb)."""
    req = wire.MA_SchedulingRequestSynDist(
        user_id=3, SN=17, reward=0.5,
        neighbor=[wire.MA_NeighborTableEntry(pos_x=1.0, pos_y=2.0, seq_num=5,
                                             last_update=0)])
    data = req.SerializeToString()
    back = wire.MA_SchedulingRequestSynDist.FromString(data)
    assert back.user_id == 3 and back.SN == 17
    assert back.neighbor[0].seq_num == 5
    # wire tags: field 1 varint (0x08), field 2 length-delimited (0x12)
    assert data[0] == 0x08 and data[2] == 0x12
    grant = wire.MA_SchedulingGrant(time_stamp=2, stop_simulation=False)
    assert wire.MA_SchedulingGrant.FromString(
        grant.SerializeToString()).time_stamp == 2


def test_prr_reward_mapping():
    assert tgw.prr_to_reward(1.0, 2) == 1.0
    np.testing.assert_allclose(tgw.prr_to_reward(0.5, 2), -0.5)
    np.testing.assert_allclose(tgw.prr_to_reward(0.5, 3), -np.exp(0.5))
    np.testing.assert_allclose(tgw.prr_to_reward(0.96, 4), np.exp(0.96))


@needs_gxx
def test_gateway_end_to_end():
    """Launch the port's C++ simulator, serve 3 full rounds of scheduling
    requests with random actions, check the event stream and state
    assembly."""
    rounds, n_users, n_ch = 3, 4, 3
    env = tgw.GatewayEnv(
        port=0, sim_start=True, sim_users=n_users, sim_channels=n_ch,
        sim_rounds=rounds, sim_seed=7, state_design=2, pos_dist=2,
        state_bins=10, state_range=250, reward_design=2)
    try:
        env.initialize_env()
        assert env.get_total_users() == n_users  # sim advertises n+1
        assert env.get_action_space() == n_ch
        assert env.get_state_space() == n_ch + 10
        rng = np.random.RandomState(0)
        seen, rewards_seen = [], []
        for r in range(rounds):
            for _ in range(n_users):
                user_id, sn, state, reward, pos_x = \
                    env.get_observation_syn_dist()
                assert sn == r
                assert state.shape == (10,)
                seen.append((sn, user_id))
                rewards_seen.append(reward)
                env.apply_action(int(rng.randint(0, n_ch)))
        assert len(seen) == rounds * n_users
        assert all(-1.0 <= rw <= 1.0 for rw in rewards_seen)
        env.sim_process.wait(timeout=10)
        assert env.sim_process.returncode == 0
        env.sim_process = None
    finally:
        env.close()


@needs_gxx
def test_gateway_stop_simulation():
    """A stop grant terminates the simulator mid-run (restart_env path,
    realness_bridge.py:228-240)."""
    env = tgw.GatewayEnv(port=0, sim_start=True, sim_users=3, sim_channels=3,
                         sim_rounds=1000, state_design=2, state_bins=10)
    try:
        env.initialize_env()
        env.get_observation_syn_dist()
        env.apply_action(0)
        env.bridge.restart_env()
        env.sim_process.wait(timeout=10)
        assert env.sim_process.returncode == 0
        env.sim_process = None
    finally:
        env.close()


@needs_gxx
def test_reward_collector():
    env = tgw.GatewayEnv(port=0, sim_start=True, sim_users=3, sim_channels=3,
                         sim_rounds=50, sim_reward_port=free_port(),
                         state_design=2, state_bins=10)
    try:
        env.initialize_env()
        for _ in range(3):
            env.get_observation_syn_dist()
            env.apply_action(0)
        rews, values = env.receive_rewards()
        assert len(values) == 3
        assert sorted(rews) == [0, 1, 2]
        env.bridge.socket_rewards.close()
        env.bridge.socket_rewards = None
        env.bridge.restart_env()
        env.sim_process.wait(timeout=10)
        env.sim_process = None
    finally:
        env.close()


@needs_gxx
def test_concurrent_builds_leave_one_whole_binary(tmp_path):
    """Two processes that build the simulator at once (as two test
    workers may) both end with the same whole binary, and leave no
    temporary file behind."""
    code = ("import sys; from pathlib import Path; "
            "from diral_tpu_torch.interop import gateway_env as g; "
            "g.BUILD_DIR = Path(sys.argv[1]); "
            "print(g.build_simulator(force=True))")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)],
                              cwd=ROOT, stdout=subprocess.PIPE, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120)[0].strip() for p in procs]
    assert [p.returncode for p in procs] == [0, 0]
    assert outs[0] == outs[1]
    assert sorted(os.listdir(tmp_path)) == [os.path.basename(outs[0])]
    usage = subprocess.run([outs[0]], capture_output=True, text=True)
    assert usage.returncode == 2 and "usage: realnes_sim" in usage.stderr


def test_neighbor_dist_matches_env_histogram():
    table = {
        0: {"xpos": 0.0, "ypos": 0.0, "seq_number": 1, "last_updated": 0},
        1: {"xpos": 30.0, "ypos": 0.0, "seq_number": 1, "last_updated": 0},
        2: {"xpos": -50.0, "ypos": 0.0, "seq_number": 1, "last_updated": 25},
        3: {"xpos": 10.0, "ypos": 0.0, "seq_number": 1, "last_updated": 3},
    }
    h = tgw.neighbor_dist_type2(0, table, bins=10, state_range=250)
    assert h.sum() == 1.0
    assert h[5] == 1.0  # bins of width 50 over [-250, 250]: (0, 50]


# -- counterparts of tests/test_transport_seam.py ----------------------------

def test_unknown_transport_raises():
    with pytest.raises(ValueError, match="unknown transport"):
        make_rep_socket(0, kind="carrier-pigeon")


def test_zmq_without_pyzmq_or_libzmq_raises(monkeypatch):
    """``zmq`` never falls back to ``framed``: without pyzmq the socket
    refuses to open, and without a loadable libzmq the simulator is not
    started."""
    monkeypatch.setitem(sys.modules, "zmq", None)
    with pytest.raises(RuntimeError, match="needs pyzmq"):
        make_rep_socket(0, kind="zmq")
    monkeypatch.undo()
    monkeypatch.setattr(tgw, "libzmq_error", lambda: "libzmq.so.5: missing")
    env = tgw.GatewayEnv(port=0, sim_users=3, sim_channels=3)
    try:
        env.sim_transport = "zmq"
        with pytest.raises(RuntimeError, match="cannot here"):
            env.start_realnes()
        assert env.sim_process is None
    finally:
        env.close()


def test_zmq_bridge_against_real_pyzmq_peer():
    """Bridge(transport='zmq') serves a genuine zmq.REQ peer: init
    handshake, request/grant cycle and the reward collector."""
    zmq = pytest.importorskip("zmq")
    ctx = zmq.Context.instance()
    collector = ctx.socket(zmq.REP)
    collector.setsockopt(zmq.LINGER, 0)
    reward_port = collector.bind_to_random_port("tcp://127.0.0.1")

    def serve_rewards():
        collector.recv()
        all_r = pb.MA_RewardSentAll()
        for u in range(3):
            r = all_r.all_rewards.add()
            r.user_id, r.SN, r.reward = u, 0, 0.25 * u
        collector.send(all_r.SerializeToString())

    bridge = RealNeSBridge(port=0, reward_port=reward_port,
                           reward_host="127.0.0.1", timeout=10.0,
                           transport="zmq")
    sim = ctx.socket(zmq.REQ)
    sim.setsockopt(zmq.LINGER, 0)
    sim.connect(f"tcp://127.0.0.1:{bridge.port}")
    try:
        init = pb.MA_SimInitMsg(total_users=4, action_space=3,
                                state_space=3, state_space_type=2)
        sim.send(init.SerializeToString())
        bridge.initialize_env()
        ack = pb.MA_SimInitAck.FromString(sim.recv())
        assert not ack.done and ack.HasField("done")
        assert bridge.get_total_users() == 3
        req = pb.MA_SchedulingRequestSyn(user_id=1, SN=5, reward=0.5)
        req.state.extend([1, 2, -3])
        sim.send(req.SerializeToString())
        uid, sn, state, reward = bridge.get_observation_syn()
        assert (uid, sn, reward) == (1, 5, 0.5)
        np.testing.assert_array_equal(state, [1, 2, -3])
        bridge.send_action(2)
        grant = pb.MA_SchedulingGrant.FromString(sim.recv())
        assert grant.time_stamp == 2 and not grant.stop_simulation
        t = threading.Thread(target=serve_rewards)
        t.start()
        rewards = bridge.receive_rewards()
        t.join(timeout=10)
        assert not t.is_alive()
        assert [r.reward for r in rewards.all_rewards] == [0.0, 0.25, 0.5]
    finally:
        sim.close()
        collector.close()
        bridge.close()


def _run_session(env_cls, transport="framed", rounds=3, seed=11, mode="dist",
                 binary=None, monkeypatch=None):
    """One short gateway session against a C++ sim; deterministic given
    (seed, action stream).  Returns the event stream."""
    n_users, n_ch = 4, 3
    if binary is not None:
        module = tgw if env_cls is tgw.GatewayEnv else jgw
        monkeypatch.setattr(module, "build_simulator", lambda: binary)
    env = env_cls(port=0, sim_start=True, sim_users=n_users,
                  sim_channels=n_ch, sim_rounds=rounds, sim_seed=seed,
                  state_design=2, pos_dist=2, state_bins=10, state_range=250,
                  reward_design=2, sim_transport=transport, sim_mode=mode)
    get = {"dist": env.get_observation_syn_dist,
           "syn": env.get_observation_syn,
           "sps": env.get_observation_syn_sps}[mode]
    events = []
    try:
        env.initialize_env()
        rng = np.random.RandomState(99)
        for _ in range(rounds * n_users):
            obs = get()
            events.append((obs[0], obs[1], tuple(np.asarray(obs[2])),
                           obs[3]))
            env.apply_action(int(rng.randint(0, n_ch)))
        env.sim_process.wait(timeout=10)
        assert env.sim_process.returncode == 0
        env.sim_process = None
    finally:
        env.close()
        if monkeypatch is not None:
            monkeypatch.undo()
    return events


@needs_gxx
@pytest.mark.skipif(libzmq_error() is not None,
                    reason="the simulator cannot load libzmq.so.5 here")
def test_cpp_sim_over_zmq_matches_framed():
    """The port's simulator over its dlopen-libzmq transport: the same
    seed and actions give the same event stream as over framed TCP."""
    pytest.importorskip("zmq")
    framed = _run_session(tgw.GatewayEnv, "framed")
    over_zmq = _run_session(tgw.GatewayEnv, "zmq")
    assert framed == over_zmq
    assert len(framed) == 12


# -- the port's simulator and bridge vs the JAX package's --------------------

def _scripted_agent(binary, mode, seed=5, users=4, channels=3, rounds=6):
    """Drive ``binary`` with a raw reply socket: ack the init, answer each
    request with a grant from a fixed action stream, poll the reward
    collector twice (and hang up well before the run ends: the simulator
    wakes its collector's accept() to stop it).  Returns every byte string
    the simulator sent."""
    rep = RepSocket(0, host="127.0.0.1", timeout=30.0)
    reward_port = free_port()
    proc = subprocess.Popen(
        [binary, "127.0.0.1", str(rep.port), str(users), str(channels),
         str(rounds), str(seed), str(reward_port), mode],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    sent = []
    try:
        sent.append(rep.recv())
        rep.send(pb.MA_SimInitAck(done=False,
                                  stopSimReq=False).SerializeToString())
        rng = np.random.RandomState(3)
        collector = ReqSocket("127.0.0.1", reward_port, timeout=30.0)
        for k in range(rounds * users):
            sent.append(rep.recv())
            rep.send(pb.MA_SchedulingGrant(
                time_stamp=int(rng.randint(0, channels)),
                stop_simulation=False).SerializeToString())
            if k in (users * 2, users * 4 + 1):
                collector.send(b"Send my rewards")
                sent.append(collector.recv())
            if k == users * 4 + 1:
                collector.close()
        assert proc.wait(timeout=10) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        rep.close()
    return sent


@needs_jax_sim
@pytest.mark.parametrize("mode", ["dist", "syn", "sps"])
def test_port_sim_sends_jax_sims_bytes(mode):
    """Same seed, same actions: the port's simulator (wire.h, no protobuf)
    sends byte for byte what the JAX package's (protoc + libprotobuf)
    sends -- the init message, every request, the reward collector's
    replies."""
    ours = _scripted_agent(tgw.build_simulator(), mode)
    theirs = _scripted_agent(jax_sim_binary(), mode)
    assert len(ours) == 1 + 6 * 4 + 2
    assert ours == theirs
    cls = {"dist": wire.MA_SchedulingRequestSynDist,
           "syn": wire.MA_SchedulingRequestSyn,
           "sps": wire.SPS_SchedulingRequestSyn}[mode]
    assert cls.FromString(ours[-3]).SN == 5


@needs_jax_sim
@pytest.mark.parametrize("mode", ["dist", "sps"])
def test_bridges_serve_each_others_sims(mode, monkeypatch):
    """The port's bridge + gateway serve the JAX sim, and JAX's serve the
    port's sim: all four pairings see one event stream."""
    jbin, tbin = jax_sim_binary(), tgw.build_simulator()
    streams = {
        (b, s): _run_session(env, mode=mode, binary=binary, rounds=4,
                             monkeypatch=monkeypatch)
        for b, env in (("port", tgw.GatewayEnv), ("jax", jgw.GatewayEnv))
        for s, binary in (("port", tbin), ("jax", jbin))}
    ref = streams[("jax", "jax")]
    assert len(ref) == 16
    for key, events in streams.items():
        assert events == ref, key


# -- the gateway's numpy functions, bit-equal to JAX's ------------------------

def _random_table(rng, n):
    """A neighbor table with fresh, stale (last_updated > 20) and phantom
    (never heard of: position (0, 0)) entries."""
    table = {}
    for j in range(n):
        kind = rng.randint(4)
        x = 0.0 if kind == 3 else float(np.float32(rng.uniform(-300, 400)))
        table[j] = {"xpos": x, "ypos": 0.0 if kind != 2 else
                    float(np.float32(rng.uniform(-5, 5))),
                    "seq_number": int(rng.randint(0, 50)),
                    "last_updated": int(rng.choice([0, 3, 20, 21, 60]))}
    return table


@pytest.mark.parametrize("seed", range(4))
def test_neighbor_dists_bit_equal_jax(seed):
    rng = np.random.RandomState(seed)
    for _ in range(25):
        n = int(rng.randint(1, 12))
        table = _random_table(rng, n)
        tx = int(rng.randint(n))
        bins = int(rng.choice([5, 10, 12, 20]))
        a, b = (tgw.neighbor_dist_type1(tx, table, bins),
                jgw.neighbor_dist_type1(tx, table, bins))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
        rng_ = float(rng.choice([100.0, 250.0, 500.0]))
        a, b = (tgw.neighbor_dist_type2(tx, table, bins, rng_),
                jgw.neighbor_dist_type2(tx, table, bins, rng_))
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_reward_mappings_bit_equal_jax():
    rng = np.random.RandomState(0)
    prrs = [0.0, 0.9, 0.95, 1.0, *rng.uniform(0, 1, 200).tolist(),
            *np.float32(rng.uniform(0.85, 1.0, 50)).astype(float).tolist()]
    for design in (1, 2, 3, 4, 5):
        for p in prrs:
            assert tgw.prr_to_reward(p, design) == jgw.prr_to_reward(p, design)
    for p in prrs:
        assert tgw.syn_reward(p) == jgw.syn_reward(p)
    for _ in range(200):
        n = int(rng.randint(1, 8))
        c = int(rng.randint(1, 5))
        acts = rng.randint(0, c, n)
        scale = float(rng.choice([10.0, 100.0, 900.0]))
        pos = rng.uniform(0, scale, n)
        assert tgw.distance_based_rewards(acts, pos, c) == \
            jgw.distance_based_rewards(acts, pos, c)
