"""The simulator's zmq transport through pyzmq's bundled libzmq
(diral_tpu_torch/interop/transport.py ``libzmq_path``, gateway_env,
cpp/realnes_sim.cc).

A machine may have pyzmq, with its own libzmq inside the wheel, and no
system library.  This one has both, so each test narrows the candidate
list to force the path under test: the bundled file alone serves a
session equal to framed TCP's, the simulator maps that file and no other
libzmq, and a missing library refuses at once instead of waiting out the
bridge's timeout.
"""

import os
import shutil
import socket
import subprocess
import time

import numpy as np
import pytest

from diral_tpu_torch.interop import gateway_env as tgw
from diral_tpu_torch.interop import transport
from diral_tpu_torch.interop.transport import RepSocket

zmq = pytest.importorskip("zmq")
needs_gxx = pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")


def _bundled():
    libs = [p for p in transport.libzmq_candidates()
            if os.path.isabs(p) and "pyzmq" in p]
    if not libs:
        pytest.skip("this pyzmq bundles no libzmq")
    return libs[0]


def _session(transport_kind, seen_maps=None, rounds=3, seed=11):
    """One short gateway session (the interop tests' ``_run_session``);
    with ``seen_maps``, the simulator's mapped libzmq files are added to
    it once the handshake is done."""
    n_users, n_ch = 4, 3
    env = tgw.GatewayEnv(port=0, sim_start=True, sim_users=n_users,
                         sim_channels=n_ch, sim_rounds=rounds, sim_seed=seed,
                         state_design=2, pos_dist=2, state_bins=10,
                         state_range=250, reward_design=2,
                         sim_transport=transport_kind)
    events = []
    try:
        env.initialize_env()
        if seen_maps is not None:
            with open(f"/proc/{env.sim_process.pid}/maps") as f:
                seen_maps.update(line.split()[-1] for line in f
                                 if "libzmq" in line)
        rng = np.random.RandomState(99)
        for _ in range(rounds * n_users):
            obs = env.get_observation_syn_dist()
            events.append((obs[0], obs[1], tuple(np.asarray(obs[2])),
                           obs[3]))
            env.apply_action(int(rng.randint(0, n_ch)))
        env.sim_process.wait(timeout=10)
        assert env.sim_process.returncode == 0
        env.sim_process = None
    finally:
        env.close()
    return events


def test_candidates_end_with_the_bundled_library():
    names = transport.libzmq_candidates()
    assert names[:2] == ["libzmq.so.5", "libzmq.so"]
    bundled = _bundled()
    assert os.path.basename(os.path.dirname(bundled)) == "pyzmq.libs"
    assert os.path.basename(bundled).startswith("libzmq")


@needs_gxx
def test_bundled_libzmq_serves_like_framed(monkeypatch):
    """The bundled file alone: ``libzmq_path`` returns it, the simulator
    is handed it and maps it (and no other libzmq), and the session's
    stream equals framed's."""
    bundled = _bundled()
    monkeypatch.setattr(transport, "libzmq_candidates", lambda: [bundled])
    assert transport.libzmq_path() == bundled
    assert transport.libzmq_error() is None
    binary = str(tgw.build_simulator())
    argvs = []
    real_popen = tgw.subprocess.Popen

    def spy(argv, *a, **k):
        if str(argv[0]) == binary:
            argvs.append([str(x) for x in argv])
        return real_popen(argv, *a, **k)
    monkeypatch.setattr(tgw.subprocess, "Popen", spy)
    maps = set()
    over_zmq = _session("zmq", maps)
    framed = _session("framed")
    assert over_zmq == framed and len(framed) == 12
    assert argvs[0][-2:] == ["zmq", bundled]
    assert len(argvs) == 2 and argvs[1][-1] == "11"  # framed: no tail
    assert maps and {os.path.realpath(m) for m in maps} == {
        os.path.realpath(bundled)}


def test_missing_libzmq_refuses_at_once(monkeypatch):
    """No loadable candidate: the session refuses before the simulator
    starts, naming what it tried -- well inside the bridge's 30 s."""
    missing = "/nonexistent/libzmq-missing.so.5"
    monkeypatch.setattr(transport, "libzmq_candidates", lambda: [missing])
    assert transport.libzmq_path() is None
    assert missing in transport.libzmq_error()
    env = tgw.GatewayEnv(port=0, sim_users=3, sim_channels=3)
    try:
        env.sim_transport = "zmq"
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError, match="libzmq-missing"):
            env.start_realnes()
        assert time.perf_counter() - t0 < 5.0
        assert env.sim_process is None
    finally:
        env.close()


@needs_gxx
def test_simulator_given_a_missing_path_exits_at_once():
    """The simulator handed a library it cannot load exits 1 at once,
    naming it, with its reward collector joined (no abort)."""
    binary = tgw.build_simulator()
    rep = RepSocket(0, host="127.0.0.1", timeout=30.0)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        reward_port = s.getsockname()[1]
    try:
        t0 = time.perf_counter()
        out = subprocess.run(
            [str(binary), "127.0.0.1", str(rep.port), "4", "3", "2", "1",
             str(reward_port), "dist", "zmq",
             "/nonexistent/libzmq-missing.so.5"],
            capture_output=True, text=True, timeout=20)
        assert time.perf_counter() - t0 < 5.0
    finally:
        rep.close()
    assert out.returncode == 1
    assert "/nonexistent/libzmq-missing.so.5" in out.stderr
