"""SIGTERM drain for the server — own copy of ``ServerState`` and
``ServingDrain`` from ``paddle_operator_tpu/infer/resilience.py``, for
the batch-mode server (the JAX class with ``batcher=None``).  The
ring's half of the drain (finish resident lanes within a budget, cancel
stragglers, flight recorder dumps) comes with the continuous-ring
slice.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Callable, Optional

from paddle_operator_tpu_torch.ft.preemption import EXIT_PREEMPTED


class ServerState:
    """Shared readiness flags between the HTTP handler threads and the
    drain machinery (plain attrs; writes are single-word stores under
    the GIL)."""

    def __init__(self) -> None:
        self.draining = False
        # seconds the 503 Retry-After advertises while draining — long
        # enough for the replacement pod to come up behind the Service
        self.retry_after_s = 5


class ServingDrain:
    """The serving half of the ft/preemption.py drain contract.

    First SIGTERM (via a PreemptionWatcher this object chains onto):
    stop admissions (every new request gets 503 + ``Retry-After``),
    shut the HTTP server down, give in-flight handler threads a bounded
    beat to finish writing, exit ``EXIT_PREEMPTED`` so the reconciler
    restarts the pod without burning ``maxRestarts``.  Second SIGTERM:
    exit ``EXIT_PREEMPTED`` now.

    ``exit_fn`` is injectable for tests (production: ``os._exit`` —
    serve_forever holds the main thread, a SystemExit from a drain
    thread would be swallowed)."""

    def __init__(self, server, state: ServerState, *,
                 handler_grace_s: float = 2.0,
                 exit_fn: Optional[Callable[[int], None]] = None) -> None:
        self.server = server
        self.state = state
        self.handler_grace_s = handler_grace_s
        self._exit = exit_fn or (lambda code: os._exit(code))
        self._signals = 0
        self._prev = None
        self._started = threading.Event()
        self.done = threading.Event()     # drain ran to completion

    def install(self, watcher, sig: int = signal.SIGTERM) -> None:
        """Chain onto an installed PreemptionWatcher: its on_drain
        callback starts the drain, and our own handler in FRONT of it
        counts repeat signals for the immediate-exit escalation.  Must
        run on the main thread, before ``serve_forever``."""
        watcher.on_drain(lambda reason: self.start_async(reason))
        self._prev = signal.signal(sig, self._handler)

    def _handler(self, signum, frame) -> None:
        self._signals += 1
        if self._signals >= 2:
            self.hard_exit()
            return
        prev = self._prev
        if callable(prev):
            prev(signum, frame)       # the watcher's handler -> trigger

    def start_async(self, reason: str = "signal") -> None:
        """Run the drain on its own thread — the signal handler must
        return immediately."""
        if self._started.is_set():
            return
        threading.Thread(target=self.run, args=(reason,), daemon=True,
                         name="serving-drain").start()

    def run(self, reason: str = "manual") -> None:
        """The drain sequence, callable directly from tests."""
        if self._started.is_set():
            return
        self._started.set()
        self.state.draining = True
        try:
            try:
                self.server.shutdown()
            except Exception:
                pass
            # shutdown() only stops the accept loop: give handler
            # threads still writing their responses a bounded beat
            # before the exit below kills the process mid-write
            threads = getattr(self.server, "_threads", None)
            deadline = time.monotonic() + self.handler_grace_s
            if threads is None:
                time.sleep(min(0.2, self.handler_grace_s))
            else:
                while (any(t.is_alive() for t in list(threads))
                       and time.monotonic() < deadline):
                    time.sleep(0.05)
        finally:
            self.done.set()
            # inside the finally ON PURPOSE: a drain that raised must
            # still exit as preempted, not linger serving only 503s
            self._exit(EXIT_PREEMPTED)

    def hard_exit(self) -> None:
        """Second-signal semantics: immediate exit."""
        self.state.draining = True
        self.done.set()
        self._exit(EXIT_PREEMPTED)
