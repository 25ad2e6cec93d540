"""REQ/REP-pattern transports behind one seam (diral_tpu/interop/transport.py,
copied).

Two interchangeable flavors of the socket roles the reference uses (REP
bind for scheduling, realness_bridge.py:26-43; REQ connect for reward
collection, realness_bridge.py:66-68):

* ``framed`` -- plain TCP with 4-byte big-endian length framing, strict
  recv/send (REP) and send/recv (REQ) alternation enforced like ZMQ would
  (``RepSocket`` / ``ReqSocket``);
* ``zmq`` -- real libzmq REP/REQ sockets via pyzmq, byte-compatible with
  the reference's ``zmq.Context().socket(zmq.REP)`` peer
  (``ZmqRepSocket`` / ``ZmqReqSocket``).

Construct through ``make_rep_socket`` / ``make_req_socket`` so callers
(bridge, gateway) stay flavor-agnostic; both flavors expose the same
``port`` / ``recv()`` / ``send()`` / ``close()`` surface.
"""

from __future__ import annotations

import glob
import os
import socket
import struct
import time

TRANSPORTS = ("framed", "zmq")


def make_rep_socket(port: int, *, kind: str = "framed",
                    host: str = "0.0.0.0", timeout: float | None = None):
    """Bind-side reply socket of the requested flavor."""
    if kind == "framed":
        return RepSocket(port, host=host, timeout=timeout)
    if kind == "zmq":
        return ZmqRepSocket(port, host=host, timeout=timeout)
    raise ValueError(f"unknown transport {kind!r} (supported: {TRANSPORTS})")


def make_req_socket(host: str, port: int, *, kind: str = "framed",
                    timeout: float | None = None):
    """Connect-side request socket of the requested flavor."""
    if kind == "framed":
        return ReqSocket(host, port, timeout=timeout)
    if kind == "zmq":
        return ZmqReqSocket(host, port, timeout=timeout)
    raise ValueError(f"unknown transport {kind!r} (supported: {TRANSPORTS})")

_HDR = struct.Struct(">I")


def _send_frame(conn: socket.socket, payload: bytes) -> None:
    conn.sendall(_HDR.pack(len(payload)) + payload)


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def _recv_frame(conn: socket.socket) -> bytes:
    (n,) = _HDR.unpack(_recv_exact(conn, _HDR.size))
    return _recv_exact(conn, n)


class RepSocket:
    """Bind-side reply socket: recv() then send(), strictly alternating."""

    def __init__(self, port: int, host: str = "0.0.0.0", timeout: float | None = None):
        self.port = port
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, port))
        if port == 0:
            self.port = self._listener.getsockname()[1]
        self._listener.listen(1)
        if timeout is not None:
            self._listener.settimeout(timeout)
        self._conn: socket.socket | None = None
        self._timeout = timeout
        self._awaiting_send = False

    def _ensure_conn(self):
        if self._conn is None:
            self._conn, _ = self._listener.accept()
            if self._timeout is not None:
                self._conn.settimeout(self._timeout)

    def recv(self) -> bytes:
        assert not self._awaiting_send, "REP: must send() before next recv()"
        self._ensure_conn()
        try:
            data = _recv_frame(self._conn)
        except ConnectionError:
            # peer went away; await a fresh connection (ZMQ REP behavior)
            self._conn.close()
            self._conn = None
            self._ensure_conn()
            data = _recv_frame(self._conn)
        self._awaiting_send = True
        return data

    def send(self, payload: bytes) -> None:
        assert self._awaiting_send, "REP: must recv() before send()"
        _send_frame(self._conn, payload)
        self._awaiting_send = False

    def close(self):
        if self._conn is not None:
            self._conn.close()
            self._conn = None
        self._listener.close()


class ReqSocket:
    """Connect-side request socket: send() then recv(), strictly alternating."""

    def __init__(self, host: str, port: int, timeout: float | None = None,
                 retries: int = 50, retry_delay: float = 0.1):
        last = None
        for _ in range(retries):
            try:
                self._conn = socket.create_connection((host, port), timeout=timeout)
                break
            except OSError as e:
                last = e
                time.sleep(retry_delay)
        else:
            raise ConnectionError(f"cannot connect to {host}:{port}: {last}")
        self._awaiting_recv = False

    def send(self, payload: bytes) -> None:
        assert not self._awaiting_recv, "REQ: must recv() before next send()"
        _send_frame(self._conn, payload)
        self._awaiting_recv = True

    def recv(self) -> bytes:
        assert self._awaiting_recv, "REQ: must send() before recv()"
        data = _recv_frame(self._conn)
        self._awaiting_recv = False
        return data

    def close(self):
        self._conn.close()


# ---------------------------------------------------------------------------
# Real libzmq flavor (pyzmq) -- the reference's actual transport
# (realness_bridge.py:25-43 zmq.REP bind, :66-68 zmq.REQ connect)
# ---------------------------------------------------------------------------


def _zmq():
    # deferred: the framed flavor must not require libzmq
    try:
        import zmq
    except ImportError as e:
        raise RuntimeError(
            "transport 'zmq' needs pyzmq, which is not installed; use the "
            "'framed' transport") from e
    return zmq


def libzmq_candidates() -> list[str]:
    """The libraries the C++ simulator's zmq transport may load, in the
    order they are tried: the system's ``libzmq.so.5`` and ``libzmq.so``,
    then the copy pyzmq's wheel bundles beside itself
    (``site-packages/pyzmq.libs/libzmq-<hash>.so*``, whose RPATH
    ``$ORIGIN`` finds its sibling libsodium).  A machine with pyzmq and no
    system libzmq serves over zmq through the bundled copy."""
    names = ["libzmq.so.5", "libzmq.so"]
    try:
        import zmq
    except ImportError:
        return names
    site = os.path.dirname(os.path.dirname(os.path.abspath(zmq.__file__)))
    return names + sorted(glob.glob(os.path.join(site, "pyzmq.libs",
                                                 "libzmq*.so*")))


def _probe_libzmq() -> tuple[str | None, list[str]]:
    import ctypes

    errors = []
    for name in libzmq_candidates():
        try:
            ctypes.CDLL(name)
            return name, errors
        except OSError as e:
            errors.append(f"{name}: {e}")
    return None, errors


def libzmq_path() -> str | None:
    """The first of ``libzmq_candidates()`` that loads, or None; the
    simulator is handed this name and loads nothing else."""
    return _probe_libzmq()[0]


def libzmq_error() -> str | None:
    """Why ``libzmq_path()`` found no library (every candidate tried,
    with its loader error), or None when it found one."""
    path, errors = _probe_libzmq()
    if path is not None:
        return None
    return "no loadable libzmq; tried " + "; ".join(errors)


class ZmqRepSocket:
    """Bind-side zmq.REP socket; same surface as RepSocket."""

    def __init__(self, port: int, host: str = "0.0.0.0",
                 timeout: float | None = None):
        zmq = _zmq()
        self._ctx = zmq.Context.instance()
        self._sock = self._ctx.socket(zmq.REP)
        self._sock.setsockopt(zmq.LINGER, 0)
        if timeout is not None:
            ms = int(timeout * 1000)
            self._sock.setsockopt(zmq.RCVTIMEO, ms)
            self._sock.setsockopt(zmq.SNDTIMEO, ms)
        if port == 0:
            self.port = self._sock.bind_to_random_port(f"tcp://{host}")
        else:
            # retry EADDRINUSE: zmq_close releases the TCP listener
            # asynchronously on the io thread, so an immediate rebind of
            # the same port (restart_sockets) can race the reaper
            last = None
            for _ in range(50):
                try:
                    self._sock.bind(f"tcp://{host}:{port}")  # realness_bridge.py:43
                    break
                except zmq.ZMQError as e:
                    last = e
                    time.sleep(0.1)
            else:
                raise last
            self.port = port

    def recv(self) -> bytes:
        return self._sock.recv()

    def send(self, payload: bytes) -> None:
        self._sock.send(payload)

    def close(self):
        self._sock.close()


class ZmqReqSocket:
    """Connect-side zmq.REQ socket; same surface as ReqSocket."""

    def __init__(self, host: str, port: int, timeout: float | None = None):
        zmq = _zmq()
        self._ctx = zmq.Context.instance()
        self._sock = self._ctx.socket(zmq.REQ)
        self._sock.setsockopt(zmq.LINGER, 0)
        if timeout is not None:
            ms = int(timeout * 1000)
            self._sock.setsockopt(zmq.RCVTIMEO, ms)
            self._sock.setsockopt(zmq.SNDTIMEO, ms)
        self._sock.connect(f"tcp://{host}:{port}")  # realness_bridge.py:66-68

    def send(self, payload: bytes) -> None:
        self._sock.send(payload)

    def recv(self) -> bytes:
        return self._sock.recv()

    def close(self):
        self._sock.close()
