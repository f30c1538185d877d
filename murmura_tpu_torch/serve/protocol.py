# Copy of murmura_tpu/serve/protocol.py.
"""The serve daemon's wire protocol: JSON-line requests over a local
unix-domain socket.

Deliberately minimal — one request, one JSON object per line, one JSON
response, close.  The daemon is a single-host experiment multiplexer,
not a network service: the socket exists so ``submit``, ``metrics``,
``top`` and scripts can hand work to a long-lived process without sharing
a Python heap.  Requests:

- ``{"op": "submit", "config": {...}}`` -> ``{"ok": true, "id": ...,
  "bucket": ...}``
- ``{"op": "status", "id": ...}`` -> the submission's ledger record
- ``{"op": "list"}`` -> every submission's summary row + cumulative
  daemon counters
- ``{"op": "ping"}`` -> liveness, uptime, package/schema versions,
  cumulative counters, bucket census
- ``{"op": "metrics"}`` -> the daemon's OpenMetrics scrape
  (telemetry/metrics.py; ``text`` carries the exposition; read-only, so a
  polling loop cannot perturb tenants)
- ``{"op": "shutdown"}`` -> graceful stop after the current generation

Client sends ride :func:`durability.dispatch.run_with_retry` with the
socket-layer transient classification (``classify_error``): a daemon
mid-restart (connection refused / reset / stale socket file) is a
transient to retry into, not a fatal error — exactly the crash-surviving
story the daemon exists for.
"""

import json
import os
import socket
import time
from typing import Any, Dict, Optional

from murmura_tpu_torch.durability.dispatch import (
    RetryPolicy,
    classify_error,
    run_with_retry,
)

# One request/response per connection; a well-formed line is tiny, so a
# hard cap keeps a garbage client from ballooning the daemon's memory.
MAX_LINE_BYTES = 4 * 1024 * 1024


def _read_line(sock: socket.socket) -> bytes:
    chunks = []
    total = 0
    while True:
        chunk = sock.recv(65536)
        if not chunk:
            break
        chunks.append(chunk)
        total += len(chunk)
        if total > MAX_LINE_BYTES:
            raise ValueError(
                f"request exceeds {MAX_LINE_BYTES} bytes — not a protocol "
                "line"
            )
        if chunk.endswith(b"\n"):
            break
    return b"".join(chunks)


def send_request(
    socket_path: str,
    request: Dict[str, Any],
    *,
    timeout: float = 30.0,
    retries: int = 5,
    base_delay_s: float = 0.2,
    sleep=time.sleep,
) -> Dict[str, Any]:
    """Send one request; returns the decoded response dict.

    Socket-layer failures (refused/reset/broken pipe/timeout — a daemon
    that is restarting after a SIGKILL) are classified transient by
    ``classify_error`` and retried with backoff; anything else raises
    through immediately."""
    policy = RetryPolicy(
        max_retries=retries, base_delay_s=base_delay_s, max_delay_s=2.0,
    )

    def attempt(_try_idx: int) -> Dict[str, Any]:
        with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as sock:
            sock.settimeout(timeout)
            try:
                sock.connect(str(socket_path))
            except FileNotFoundError as e:
                # A unix-socket path that does not exist yet means the
                # daemon has not bound (starting, or restarting after a
                # kill) — semantically "connection refused", which is
                # transient; a bare ENOENT would classify fatal.
                raise ConnectionRefusedError(
                    f"no daemon socket at {socket_path} (not bound yet?)"
                ) from e
            sock.sendall(
                json.dumps(request).encode("utf-8") + b"\n"
            )
            payload = _read_line(sock)
        if not payload:
            # The daemon died between accept and reply: transient.
            raise ConnectionResetError(
                f"daemon at {socket_path} closed the connection without "
                "replying"
            )
        return json.loads(payload.decode("utf-8"))

    return run_with_retry(
        attempt, policy=policy, classify=classify_error, sleep=sleep,
    )


class ServerSocket:
    """The daemon's listening unix socket, with stale-file recovery.

    A SIGKILL'd daemon leaves its socket file behind; the restarted
    daemon must reclaim the address.  Binding retries through
    ``run_with_retry`` with ``EADDRINUSE`` classified transient
    (durability/dispatch.py), unlinking the stale file between
    attempts — a LIVE daemon on the same path still wins (its bind
    holds the address after the unlink race is lost at connect time).
    """

    def __init__(self, path: str, *, backlog: int = 16):
        self.path = str(path)
        self._sock: Optional[socket.socket] = None
        policy = RetryPolicy(
            max_retries=3, base_delay_s=0.05, max_delay_s=0.5,
        )

        def attempt(try_idx: int) -> socket.socket:
            if try_idx > 0 and os.path.exists(self.path):
                # Stale socket file from a killed daemon: reclaim it.
                try:
                    os.unlink(self.path)
                except OSError:
                    pass
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            try:
                sock.bind(self.path)
            except OSError:
                sock.close()
                raise
            sock.listen(backlog)
            return sock

        self._sock = run_with_retry(
            attempt, policy=policy, classify=classify_error,
        )

    def accept(self, timeout: Optional[float] = None):
        assert self._sock is not None
        self._sock.settimeout(timeout)
        return self._sock.accept()

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None
        try:
            os.unlink(self.path)
        except OSError:
            pass


def serve_connection(conn: socket.socket, handler) -> None:
    """Read one request line, dispatch to ``handler(dict) -> dict``,
    reply, close.  A malformed request gets an error response instead of
    killing the listener."""
    try:
        with conn:
            conn.settimeout(30.0)
            payload = _read_line(conn)
            if not payload:
                return
            try:
                request = json.loads(payload.decode("utf-8"))
                response = handler(request)
            except Exception as e:  # noqa: BLE001 — reply, don't die
                response = {
                    "ok": False,
                    "error": f"{type(e).__name__}: {e}",
                }
            conn.sendall(json.dumps(response).encode("utf-8") + b"\n")
    except OSError:
        # The client vanished mid-reply — its problem, not the daemon's.
        pass
