"""The router's model of one serving replica, in three layers.

A copy of ``dasmtl/serve/replica.py`` (``TransportError`` :47, the
``ReplicaHandle`` state machine :56-155, ``HttpTransport`` :157-279,
``SupervisedProcess`` / ``ReplicaProcess`` :281-400) whose children are
``python -m dasmtl_torch.serve`` processes.  Names, states, payload keys
and the backoff schedule are JAX's, so either package's router drives
either package's replicas.

**The replica contract** is what one ``python -m dasmtl_torch.serve``
process already speaks: structured ``shed`` (backpressure, retryable
elsewhere), ``closed`` (draining: leave rotation until ``/readyz``
recovers), ``nonfinite`` (a per-request property, final), ``GET /readyz``
(503 while warming buckets or draining) and a Prometheus ``/metrics``
exposition.  A plain replica IS a conforming replica; nothing was added
to it for the router.

- :class:`ReplicaHandle` is the contract as a **pure state machine**: how
  the router's view of one replica moves on probe results, request
  outcomes and connection failures (eviction, then re-probes on an
  exponential backoff), plus cordon / uncordon for rollouts.  No I/O, no
  clock, no threads: every method takes ``now``, so the placement and
  eviction policy is testable on a fake clock.

- :class:`HttpTransport` is the one place router-side I/O lives: kept-alive
  connections (per thread and address; the stdlib front end speaks
  HTTP/1.1 with Content-Length, so reuse works), every failure normalized
  to :class:`TransportError`.  An in-process fake replaces it in the
  fake-clock tests.

- :class:`ReplicaProcess` is a real ``python -m dasmtl_torch.serve`` child:
  spawned with ``--port 0 --port_file`` (the supervisor learns the
  ephemeral port from the file: no output scraping, no port races),
  SIGTERM to drain, SIGKILL for failure injection.
"""

from __future__ import annotations

import http.client
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
from typing import Optional, Sequence


class TransportError(RuntimeError):
    """Any transport-level failure talking to a replica (refused /
    reset / timeout / torn body).  The router treats every one the same
    way: immediate eviction + re-probe with backoff."""


# -- the replica contract as a pure state machine -----------------------------


class ReplicaHandle:
    """Router-side state for one replica.  Health state is ``probing``
    (out of rotation, being re-checked on a backoff schedule) or
    ``ready``; ``cordoned`` is an orthogonal administrative bit (rollout
    takes a healthy replica out of rotation without calling it sick).
    ``outstanding`` is the live least-outstanding-requests placement key.
    """

    def __init__(self, name: str, address: str, *,
                 probe_interval_s: float = 1.0,
                 backoff_max_s: float = 30.0):
        self.name = name
        self.address = address
        self.probe_interval_s = float(probe_interval_s)
        self.backoff_max_s = float(backoff_max_s)
        self.state = "probing"
        self.cordoned = False
        self.outstanding = 0
        self.failures = 0  # consecutive probe/transport failures
        self._next_probe = float("-inf")  # probe immediately on start
        # Last readiness payload highlights (what /healthz reported).
        self.generation: Optional[int] = None
        self.source: Optional[str] = None
        self.last_error: Optional[str] = None
        # Counters the router aggregates into its own metrics.
        self.sent = 0
        self.evictions = 0

    # -- rotation ------------------------------------------------------------
    @property
    def in_rotation(self) -> bool:
        return self.state == "ready" and not self.cordoned

    def cordon(self) -> None:
        self.cordoned = True

    def uncordon(self) -> None:
        self.cordoned = False

    # -- request lifecycle ---------------------------------------------------
    def on_send(self) -> None:
        self.outstanding += 1
        self.sent += 1

    def on_done(self) -> None:
        self.outstanding = max(0, self.outstanding - 1)

    def evict(self, now: float, reason: str) -> None:
        """Connection failure or a ``closed`` answer: out of rotation NOW,
        next probe after an exponential backoff (capped) — a flapping
        replica gets probed ever less often instead of hammered."""
        self.state = "probing"
        self.failures += 1
        self.evictions += 1
        self.last_error = reason
        self._next_probe = now + self._backoff()

    def _backoff(self) -> float:
        return min(self.probe_interval_s * (2.0 ** (self.failures - 1)),
                   self.backoff_max_s)

    # -- probing -------------------------------------------------------------
    def next_probe_at(self) -> float:
        """When this replica is next due a ``/readyz`` probe: ready
        replicas re-check each ``probe_interval_s`` (to catch a silent
        drain), probing ones follow their backoff schedule."""
        return self._next_probe

    def on_probe_ok(self, now: float, payload: dict) -> None:
        """A probe that got an HTTP answer — ``payload`` is the
        /readyz (== /healthz) body; its ``ready`` bit decides rotation.
        An un-ready answer is a clean 'not yet' (warming/draining):
        re-probe at the plain interval, no backoff escalation."""
        self.failures = 0
        self.last_error = None
        self.generation = payload.get("generation", self.generation)
        self.source = payload.get("source", self.source)
        self.state = "ready" if payload.get("ready") else "probing"
        self._next_probe = now + self.probe_interval_s

    def on_probe_fail(self, now: float, reason: str) -> None:
        """No HTTP answer at all: connection-level failure, backoff."""
        self.state = "probing"
        self.failures += 1
        self.last_error = reason
        self._next_probe = now + self._backoff()

    def snapshot(self) -> dict:
        return {"name": self.name, "address": self.address,
                "state": self.state, "cordoned": self.cordoned,
                "in_rotation": self.in_rotation,
                "outstanding": self.outstanding,
                "failures": self.failures, "sent": self.sent,
                "evictions": self.evictions,
                "generation": self.generation, "source": self.source,
                "last_error": self.last_error}


# -- HTTP transport -----------------------------------------------------------


class HttpTransport:
    """Keep-alive HTTP client for replica traffic: one pooled connection
    per (thread, address) — the forwarding hot path never pays TCP
    setup per request — with every failure mode collapsed into
    :class:`TransportError` (and the broken connection dropped, so the
    next attempt reconnects cleanly)."""

    def __init__(self, timeout_s: float = 30.0):
        self.timeout_s = float(timeout_s)
        self._local = threading.local()

    def _conn(self, address: str, timeout_s: float
              ) -> http.client.HTTPConnection:
        pool = getattr(self._local, "pool", None)
        if pool is None:
            pool = self._local.pool = {}
        conn = pool.get(address)
        if conn is None:
            host, _, port = address.rpartition(":")
            conn = http.client.HTTPConnection(host, int(port),
                                              timeout=timeout_s)
            pool[address] = conn
        else:
            conn.timeout = timeout_s
        return conn

    def _drop(self, address: str) -> None:
        pool = getattr(self._local, "pool", None)
        conn = pool.pop(address, None) if pool else None
        if conn is not None:
            conn.close()

    def request(self, address: str, method: str, path: str,
                body: Optional[bytes] = None,
                timeout_s: Optional[float] = None,
                headers: Optional[dict] = None) -> tuple:
        """``(status, raw bytes)`` or :class:`TransportError`.  A 4xx/5xx
        with a body is an ANSWER (the replica contract speaks through
        status+JSON), not a transport failure.  ``headers`` ride on top
        of the Content-Type default (the router's ``X-Dasmtl-Trace``)."""
        timeout_s = self.timeout_s if timeout_s is None else timeout_s
        conn = self._conn(address, timeout_s)
        send_headers = ({"Content-Type": "application/json"}
                        if body is not None else {})
        if headers:
            send_headers.update(headers)
        try:
            conn.request(method, path, body=body, headers=send_headers)
            resp = conn.getresponse()
            return resp.status, resp.read()
        except Exception as exc:  # noqa: BLE001 — normalize every failure
            self._drop(address)
            raise TransportError(
                f"{method} {address}{path}: "
                f"{type(exc).__name__}: {exc}") from None

    def request_json(self, address: str, method: str, path: str,
                     obj=None, timeout_s: Optional[float] = None) -> tuple:
        body = (json.dumps(obj).encode() if obj is not None else None)
        status, raw = self.request(address, method, path, body, timeout_s)
        try:
            return status, (json.loads(raw) if raw else {})
        except json.JSONDecodeError as exc:
            raise TransportError(
                f"{method} {address}{path}: non-JSON body: {exc}") \
                from None

    # -- the calls the router makes ------------------------------------------
    def infer(self, address: str, body: bytes,
              timeout_s: Optional[float] = None,
              headers: Optional[dict] = None) -> tuple:
        """``(status, raw response bytes)``.  Raw on purpose: the router's
        hot path forwards a success verbatim (status code 200 already
        says "ok") — parsing + re-serializing every answer on a host the
        replicas share would tax the very compute being routed to.
        ``headers`` carries the trace header on every hop, retries
        included — header-only, so the zero-parse path stays zero-parse."""
        return self.request(address, "POST", "/infer", body, timeout_s,
                            headers)

    def infer_json(self, address: str, body: bytes,
                   timeout_s: Optional[float] = None) -> tuple:
        """``(status, payload dict)`` — for clients (selftest/bench) that
        want the parsed answer; the router itself uses :meth:`infer`."""
        status, raw = self.infer(address, body, timeout_s)
        try:
            return status, (json.loads(raw) if raw else {})
        except json.JSONDecodeError as exc:
            raise TransportError(
                f"POST {address}/infer: non-JSON body: {exc}") from None

    def probe(self, address: str,
              timeout_s: Optional[float] = None) -> dict:
        """The /readyz body regardless of status (200 and 503 both carry
        the healthz payload; ``ready`` inside is the truth)."""
        _status, payload = self.request_json(address, "GET", "/readyz",
                                             timeout_s=timeout_s or 5.0)
        return payload

    def swap(self, address: str, version=None,
             timeout_s: Optional[float] = None) -> tuple:
        return self.request_json(address, "POST", "/swap",
                                 {"version": version},
                                 timeout_s=timeout_s)

    def swap_status(self, address: str) -> dict:
        return self.request_json(address, "GET", "/swap",
                                 timeout_s=5.0)[1]

    def stats(self, address: str) -> dict:
        return self.request_json(address, "GET", "/stats",
                                 timeout_s=10.0)[1]

    def metrics_text(self, address: str) -> str:
        status, raw = self.request(address, "GET", "/metrics",
                                   timeout_s=10.0)
        if status != 200:
            raise TransportError(f"GET {address}/metrics: HTTP {status}")
        return raw.decode("utf-8")


# -- real supervised processes ------------------------------------------------


class SupervisedProcess:
    """One real ``python -m <module>`` child on an ephemeral port — the
    reusable supervisor contract every fleet tier's children speak.

    The child binds its HTTP front end BEFORE warmup and writes the bound
    port to ``--port_file``; the supervisor polls that file, so startup
    needs no fixed ports and no output scraping.  Liveness (`/healthz`)
    is up as soon as the file exists — readiness comes later, when the
    child finishes compiling its buckets, and that is the prober's
    business (:class:`ReplicaHandle`), not the supervisor's.  SIGTERM
    drains, SIGKILL is the failure-injection path (the selftests'
    mid-load kill is a REAL kill).  :class:`ReplicaProcess` pins the serve
    tier's entry point; the stream fleet's workers (ROADMAP.md queue 1
    item 1) are to reuse the same contract.  :meth:`close` removes the
    scratch directory holding the port file and the child's log.
    """

    #: ``python -m`` target; subclasses pin their tier's entry point.
    module = "dasmtl_torch.serve"
    #: Log file basename inside the supervisor's scratch dir.
    log_name = "child.log"

    def __init__(self, args: Sequence[str], *, name: str = "child",
                 host: str = "127.0.0.1",
                 startup_timeout_s: float = 180.0,
                 env: Optional[dict] = None,
                 log_path: Optional[str] = None):
        self.name = name
        self.host = host
        self._dir = tempfile.mkdtemp(prefix=f"dasmtl-torch-{name}-")
        port_file = os.path.join(self._dir, "port")
        self.log_path = log_path or os.path.join(self._dir, self.log_name)
        self._log = open(self.log_path, "wb")
        cmd = [sys.executable, "-m", self.module, *args,
               "--host", host, "--port", "0", "--port_file", port_file]
        self.proc = subprocess.Popen(cmd, stdout=self._log,
                                     stderr=subprocess.STDOUT,
                                     env=env)
        deadline = time.monotonic() + startup_timeout_s
        self.port: Optional[int] = None
        while time.monotonic() < deadline:
            if self.proc.poll() is not None:
                raise RuntimeError(
                    f"{name} exited rc={self.proc.returncode} "
                    f"before binding — log: {self.log_path}\n"
                    f"{self.log_tail()}")
            try:
                with open(port_file, "r", encoding="utf-8") as f:
                    text = f.read().strip()
                if text:
                    self.port = int(text)
                    break
            except FileNotFoundError:
                pass
            time.sleep(0.05)
        if self.port is None:
            self.proc.kill()
            raise RuntimeError(f"{name} never bound a port "
                               f"within {startup_timeout_s}s — log: "
                               f"{self.log_path}\n{self.log_tail()}")

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"

    @property
    def alive(self) -> bool:
        return self.proc.poll() is None

    def kill(self) -> None:
        """SIGKILL — the failure-injection path (no drain, no goodbye).
        Even reaping a SIGKILLed child gets a deadline: a pathological
        wait here must surface, not wedge the router."""
        if self.alive:
            os.kill(self.proc.pid, signal.SIGKILL)
        self.proc.wait(timeout=30.0)

    def terminate(self, timeout_s: float = 60.0) -> int:
        """SIGTERM (graceful drain) and wait; returns the exit code."""
        if self.alive:
            self.proc.terminate()
        try:
            return self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            # A SIGKILLed child reaps promptly; the deadline is for the
            # pathological case — surface it, don't wedge.
            return self.proc.wait(timeout=30.0)

    def log_tail(self, max_bytes: int = 4096) -> str:
        try:
            self._log.flush()
            with open(self.log_path, "rb") as f:
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size - max_bytes))
                return f.read().decode("utf-8", "replace")
        except OSError:
            return "<log unreadable>"

    def close(self) -> None:
        self.terminate()
        self._log.close()
        shutil.rmtree(self._dir, ignore_errors=True)

    def __enter__(self) -> "SupervisedProcess":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class ReplicaProcess(SupervisedProcess):
    """A real serving replica: ``python -m dasmtl_torch.serve`` under the
    supervisor contract."""

    module = "dasmtl_torch.serve"
    log_name = "serve.log"

    def __init__(self, serve_args: Sequence[str], *,
                 name: str = "replica", **kw):
        super().__init__(serve_args, name=name, **kw)
