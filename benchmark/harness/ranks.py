"""One process per card: a cell on several cards runs its rank 0 in the
process that was started, which starts the other ranks as copies of
itself with ``--rank`` and ``--port`` and waits for each to end."""

from __future__ import annotations

import socket
import subprocess
import sys


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(script: str, argv: list, world: int, port: int) -> list:
    """Ranks 1..world-1 of ``script argv``; their standard output is
    dropped (rank 0 prints the result), their errors pass through."""
    return [subprocess.Popen([sys.executable, script, *argv, "--rank",
                              str(r), "--port", str(port)],
                             stdout=subprocess.DEVNULL)
            for r in range(1, world)]


def join(procs: list, timeout: float = 300.0) -> list:
    """Each rank's exit code, after waiting for it; a rank still running
    after ``timeout`` is ended and reads as failed."""
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=timeout))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            codes.append(-9)
    return codes


def stop(procs: list) -> None:
    """End every rank still running, and wait for each."""
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()
