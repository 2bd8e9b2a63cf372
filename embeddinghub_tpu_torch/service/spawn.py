"""The port's server and composer as subprocesses, for crash tests and
smoke runs.

    server = ServerProcess(data_dir, device="cuda")   # returns once it listens
    client = EmbeddingHubClient(host="127.0.0.1", port=server.port)
    ...
    server.kill()               # SIGKILL: a crash, nothing is flushed
    server = ServerProcess(data_dir, device="cuda", port=server.port)
    ...
    launches = server.stop()    # SIGTERM: the kernel launches it reported

    composer = ComposerProcess(data_dir, device="cuda", defs="defs.py")
    ...                         # composer.store_port, .serving_port,
    launches = composer.stop()  # .metadata_port, .http_port

Every wait on the subprocess is bounded; one that runs out kills it and
raises.  A thread drains its output, so a full pipe never blocks it.
"""

from __future__ import annotations

import json
import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

# The directory that holds the package: the subprocess imports it from here.
_ROOT = Path(__file__).resolve().parents[2]
# The line the server and the composer print as they stop on SIGTERM or
# SIGINT (server.py, main.py).
LAUNCHES_TAG = "kernel launches: "
# The line the composer prints once every service is up (main.py).
COMPOSER_UP = "embeddinghub-tpu up"


def free_ports(n: int) -> list[int]:
    """``n`` distinct ports free on 127.0.0.1 (each held until all are
    chosen, so none is handed out twice)."""
    socks = [socket.socket() for _ in range(n)]
    try:
        for s in socks:
            s.bind(("127.0.0.1", 0))
        return [s.getsockname()[1] for s in socks]
    finally:
        for s in socks:
            s.close()


def free_port() -> int:
    return free_ports(1)[0]


class _Spawned:
    """``python -m <module> <args>`` that counts as started once a line of
    its output holds ``ready``."""

    def __init__(self, module: str, args: list[str], ready: str, *,
                 env: dict | None, start_timeout: float, wait_timeout: float):
        self.wait_timeout = wait_timeout
        self.output: list[str] = []
        env = dict(os.environ, **(env or {}))
        env["PYTHONPATH"] = str(_ROOT) + os.pathsep + env.get("PYTHONPATH", "")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", module, *args],
            cwd=_ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        self._lines: queue.Queue = queue.Queue()
        self._drain = threading.Thread(target=self._read, daemon=True)
        self._drain.start()
        deadline = time.monotonic() + start_timeout
        while time.monotonic() < deadline:
            try:
                line = self._lines.get(timeout=max(0.0, deadline - time.monotonic()))
            except queue.Empty:
                break
            if line is None:
                break
            if ready in line:
                return
        self.kill()
        raise RuntimeError(f"{module} did not start within "
                           f"{start_timeout:.0f} s:\n" + "".join(self.output[-40:]))

    def _read(self) -> None:
        for raw in iter(self.proc.stdout.readline, b""):
            line = raw.decode(errors="replace")
            self.output.append(line)
            self._lines.put(line)
        self._lines.put(None)

    def kill(self) -> None:
        """SIGKILL, unless it has exited; waits for the exit."""
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait(timeout=self.wait_timeout)

    def stop(self) -> dict:
        """SIGTERM and wait: the process stops its services, prints the
        launches of each kernel in its process, and exits 0.  Returns
        those counts."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            code = self.proc.wait(timeout=self.wait_timeout)
        except subprocess.TimeoutExpired:
            self.kill()
            raise RuntimeError(f"process did not stop within {self.wait_timeout:.0f} s "
                               "of SIGTERM") from None
        self._drain.join(timeout=self.wait_timeout)
        tail = "".join(self.output[-40:])
        if code != 0:
            raise RuntimeError(f"process exited with {code} on SIGTERM:\n{tail}")
        for line in reversed(self.output):
            if line.startswith(LAUNCHES_TAG):
                return json.loads(line[len(LAUNCHES_TAG):])
        raise RuntimeError(f"process stopped without reporting its kernel launches:\n{tail}")


class ServerProcess(_Spawned):
    """``python -m embeddinghub_tpu_torch.service.server`` on a data
    directory, on 127.0.0.1 at ``port`` (a free one by default)."""

    def __init__(self, data_dir, *, device: str, port: int | None = None,
                 env: dict | None = None, start_timeout: float = 120.0,
                 wait_timeout: float = 30.0):
        self.port = port or free_port()
        super().__init__(
            "embeddinghub_tpu_torch.service.server",
            [f"127.0.0.1:{self.port}", str(data_dir), "--device", device],
            "listening", env=env, start_timeout=start_timeout,
            wait_timeout=wait_timeout)


class ComposerProcess(_Spawned):
    """``python -m embeddinghub_tpu_torch.main``: the store, serving and
    metadata gRPC servers and the dashboard, each on a free port, with the
    store server's data directory ``data_dir`` on ``device``; ``defs`` is
    the definitions file it applies, ``metadata_db`` the sqlite file of its
    metadata (in memory without one)."""

    def __init__(self, data_dir, *, device: str, defs=None, metadata_db=None,
                 env: dict | None = None, start_timeout: float = 120.0,
                 wait_timeout: float = 30.0):
        self.store_port, self.serving_port, self.metadata_port, self.http_port = (
            free_ports(4))
        args = ["--store-port", str(self.store_port),
                "--serving-port", str(self.serving_port),
                "--metadata-port", str(self.metadata_port),
                "--http-port", str(self.http_port),
                "--data-dir", str(data_dir), "--device", device]
        if defs is not None:
            args += ["--defs", str(defs)]
        if metadata_db is not None:
            args += ["--metadata-db", str(metadata_db)]
        super().__init__("embeddinghub_tpu_torch.main", args, COMPOSER_UP, env=env,
                         start_timeout=start_timeout, wait_timeout=wait_timeout)
