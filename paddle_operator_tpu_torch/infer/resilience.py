"""Serving-path fault tolerance — own copy of
``paddle_operator_tpu/infer/resilience.py`` (nothing here touches the
device):

- the typed failure surface: :class:`ShuttingDown` /
  :class:`RetriableError` (503 + ``Retry-After``: the request was fine,
  the server was not), :class:`DeadlineExceeded`,
  :class:`LaneQuarantined`, :class:`LaneMigrated`;
- :class:`RingResilience` — the knobs (watchdog thresholds, restart
  budget, backoff), env-constructable for serve.py;
- :class:`RollingQuantile` and :class:`DispatchWatchdog` — a monitor
  thread that times every blocking device interaction of the ring
  against N x rolling-p95 and fires a stall callback when one wedges;
- :class:`RestartBudget` — exponential backoff with a restart-density
  cap; when spent, the ring stops self-healing and ``/healthz`` flips;
- :class:`ServerState` and :class:`ServingDrain` — SIGTERM -> stop
  admissions (503) -> finish resident lanes within a budget (the ring
  half, with a batcher) -> flush partials -> exit ``EXIT_PREEMPTED``.

``RingResilience(nan_check=True)`` (``SERVE_NAN_CHECK``) turns on the
NaN-lane check: every ring dispatch also returns each lane's isfinite
verdict, and the scheduler fails a non-finite lane's request alone with
:class:`LaneQuarantined`.
"""

from __future__ import annotations

import os
import signal
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional

from paddle_operator_tpu_torch.ft.preemption import EXIT_PREEMPTED


# ---------------------------------------------------------------------------
# Failure surface
# ---------------------------------------------------------------------------


class ShuttingDown(RuntimeError):
    """The server is draining (SIGTERM) or closed: the request was
    never started and is safe to retry elsewhere.  serve.py maps it to
    503 + ``Retry-After``."""


class RetriableError(RuntimeError):
    """The ring failed underneath this request (dispatch fault, stall,
    self-healing rebuild) — nothing was wrong with the request; retry
    it.  serve.py maps it to 503 + ``Retry-After``."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline expired before generation finished.  The
    request still RESOLVES (with the tokens produced so far — the
    504-style partial); this type only appears when a caller asks why
    the stream stopped short."""


class LaneQuarantined(RetriableError):
    """This lane's logits went non-finite (NaN/inf) — its request is
    failed and the lane retired WITHOUT touching the other lanes."""


class LaneMigrated(RetriableError):
    """This lane migrated to a peer replica (fleet-level KV:
    drain-by-migration or the parked-lane shed).  The peer resumes the
    stream from the spilled bytes; the client's retry — same idempotent
    ``request_id`` — lands on the adopter (the router's migration table
    pins the id there before this error is raised) and collects the
    FULL result.  serve.py maps it to 503 + ``Retry-After`` like every
    retriable."""


# ---------------------------------------------------------------------------
# Config
# ---------------------------------------------------------------------------


@dataclass
class RingResilience:
    """Fault-tolerance knobs for one ContinuousBatcher.

    Passing an instance turns self-healing ON: ring-level dispatch
    failures fail the in-flight requests retriably and rebuild the ring
    (fresh cache/pool, queued work re-admitted) behind exponential
    backoff, up to ``max_restarts`` per ``restart_window_s``;
    exhausting the budget flips the batcher unhealthy (``/healthz``).
    Without one the batcher dies on the first ring error."""

    # stall threshold: max(stall_floor_s, stall_factor * rolling-p95 of
    # recent dispatch/consume waits)
    watchdog: bool = True
    stall_factor: float = 8.0
    stall_floor_s: float = 60.0
    # a stall that ALSO exceeds hard_stall_factor x the threshold is a
    # wedged device: healthz flips and the pod gets replaced
    hard_stall_factor: float = 4.0
    poll_s: float = 0.05
    max_restarts: int = 3
    restart_window_s: float = 300.0
    backoff_base_s: float = 0.25
    backoff_max_s: float = 10.0
    # per-dispatch isfinite fold: a non-finite lane is quarantined, its
    # request failed, the ring untouched (not on speculative rings)
    nan_check: bool = False

    @classmethod
    def from_env(cls, env=None) -> "RingResilience":
        """serve.py construction: SERVE_WATCHDOG(_FACTOR/_FLOOR_S),
        SERVE_MAX_RESTARTS, SERVE_RESTART_WINDOW_S, SERVE_NAN_CHECK."""
        env = os.environ if env is None else env
        return cls(
            watchdog=env.get("SERVE_WATCHDOG", "1") == "1",
            stall_factor=float(env.get("SERVE_WATCHDOG_FACTOR", "8")),
            stall_floor_s=float(env.get("SERVE_WATCHDOG_FLOOR_S", "60")),
            max_restarts=int(env.get("SERVE_MAX_RESTARTS", "3")),
            restart_window_s=float(env.get("SERVE_RESTART_WINDOW_S",
                                           "300")),
            nan_check=env.get("SERVE_NAN_CHECK", "0") == "1",
        )


# ---------------------------------------------------------------------------
# Rolling quantile + watchdog
# ---------------------------------------------------------------------------


class RollingQuantile:
    """Nearest-rank quantile over the last ``window`` samples — the
    rolling p95 the stall threshold scales from."""

    def __init__(self, q: float = 0.95, window: int = 64) -> None:
        self.q = q
        self.window = window
        self._xs: List[float] = []
        self._lock = threading.Lock()

    def add(self, x: float) -> None:
        with self._lock:
            self._xs.append(float(x))
            if len(self._xs) > self.window:
                del self._xs[0]

    def value(self) -> Optional[float]:
        with self._lock:
            if not self._xs:
                return None
            xs = sorted(self._xs)
        return xs[min(len(xs) - 1, int(round(self.q * (len(xs) - 1))))]


class DispatchWatchdog:
    """Times every blocking device interaction of one ring against
    ``max(floor, factor * rolling-p95)``.

    The ring thread brackets each region (``begin()``/``end()``); a
    daemon monitor thread polls the in-flight region and fires
    ``on_stall(elapsed)`` ONCE when it crosses the threshold — while
    the ring thread is still stuck, so clients get their retriable 503s
    at once.  A region that also crosses ``hard_stall_factor x
    threshold`` fires ``on_hard_stall``."""

    def __init__(self, cfg: RingResilience,
                 on_stall: Callable[[float], None],
                 on_hard_stall: Optional[Callable[[float], None]] = None
                 ) -> None:
        self.cfg = cfg
        self._on_stall = on_stall
        self._on_hard = on_hard_stall
        self._p95 = RollingQuantile(0.95)
        self._lock = threading.Lock()
        self._start: Optional[float] = None
        # a region covering N fused ring iterations (SERVE_MEGASTEP)
        # legitimately takes ~N x a 1-step one: samples are normalized
        # to per-iteration time at end() and the threshold multiplies
        # back by the in-flight region's scale
        self._scale = 1.0
        self._gen = 0                 # region id, so a stall fires once
        self._stalled_gen = -1
        self._hard_gen = -1
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._monitor, daemon=True,
                                        name="dispatch-watchdog")
        self._thread.start()

    def begin(self, scale: float = 1.0) -> None:
        """``scale``: how many fused ring iterations this region covers
        (SERVE_MEGASTEP; 1 for ordinary dispatches)."""
        with self._lock:
            self._gen += 1
            self._start = time.monotonic()
            self._scale = max(1.0, float(scale))

    def end(self) -> None:
        with self._lock:
            if self._start is None:
                return
            dur = time.monotonic() - self._start
            # a region already DECLARED stalled must not feed the p95
            if self._gen != self._stalled_gen:
                self._p95.add(dur / self._scale)   # per-iteration time
            self._start = None

    def threshold(self) -> float:
        """Stall threshold for the IN-FLIGHT region: the factor term
        scales with its fused iteration count; the floor stays
        absolute."""
        with self._lock:
            scale = self._scale
        p95 = self._p95.value()
        if p95 is None:
            return self.cfg.stall_floor_s
        return max(self.cfg.stall_floor_s,
                   scale * self.cfg.stall_factor * p95)

    def _monitor(self) -> None:
        while not self._stop.wait(self.cfg.poll_s):
            with self._lock:
                start, gen = self._start, self._gen
                stalled, hard = self._stalled_gen, self._hard_gen
            if start is None:
                continue
            elapsed = time.monotonic() - start
            thr = self.threshold()
            if elapsed > thr and gen != stalled:
                with self._lock:
                    self._stalled_gen = gen
                try:
                    self._on_stall(elapsed)
                except Exception:
                    pass
            if (self._on_hard is not None
                    and elapsed > thr * self.cfg.hard_stall_factor
                    and gen != hard):
                with self._lock:
                    self._hard_gen = gen
                try:
                    self._on_hard(elapsed)
                except Exception:
                    pass

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=5)


class RestartBudget:
    """Exponential backoff with a restart-density cap.

    ``spend()`` returns the backoff seconds to sleep before the rebuild
    (0.25s, 0.5s, 1s, ... capped) — callers check :attr:`exhausted`
    FIRST.  A quiet ``restart_window_s`` since the last restart refills
    the budget.  ``clock`` is injectable for tests."""

    def __init__(self, cfg: RingResilience, clock=time.monotonic) -> None:
        self.cfg = cfg
        self.used = 0
        self._clock = clock
        self._last: Optional[float] = None

    def _refill(self) -> None:
        if (self._last is not None and self.used
                and self._clock() - self._last
                >= self.cfg.restart_window_s):
            self.used = 0

    @property
    def exhausted(self) -> bool:
        self._refill()
        return self.used >= self.cfg.max_restarts

    def spend(self) -> float:
        self._refill()
        backoff = min(self.cfg.backoff_max_s,
                      self.cfg.backoff_base_s * (2 ** self.used))
        self.used += 1
        self._last = self._clock()
        return backoff


# ---------------------------------------------------------------------------
# SIGTERM drain for the server
# ---------------------------------------------------------------------------


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
    let the ring's resident lanes finish within ``budget_s`` and cancel
    stragglers at the budget (their callers receive the tokens produced
    so far — ``batcher.drain``; a batch-mode server has no ring), shut
    the HTTP server down, give in-flight handler threads a bounded beat
    to finish writing, exit ``EXIT_PREEMPTED`` so the reconciler
    restarts the pod without burning ``maxRestarts``.  Second SIGTERM:
    abort the ring best-effort and exit ``EXIT_PREEMPTED`` now.

    ``exit_fn`` is injectable for tests (production: ``os._exit`` —
    serve_forever holds the main thread, a SystemExit from a drain
    thread would be swallowed)."""

    def __init__(self, server, state: ServerState, *,
                 batcher=None, budget_s: float = 30.0,
                 handler_grace_s: float = 2.0,
                 exit_fn: Optional[Callable[[int], None]] = None) -> None:
        self.server = server
        self.state = state
        self.batcher = batcher
        self.budget_s = budget_s
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
        fr = getattr(self.batcher, "flightrec", None)
        if fr is not None:
            fr.record("sigterm", reason=str(reason))
            fr.dump_file("sigterm")
        try:
            if self.batcher is not None:
                self.batcher.drain(self.budget_s)
                if fr is not None:
                    # re-dump with the drain's own events appended
                    fr.dump_file("sigterm")
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
        """Second-signal semantics: immediate exit, partials flushed
        best-effort."""
        self.state.draining = True
        if self.batcher is not None:
            try:
                self.batcher.abort(ShuttingDown(
                    "server killed (second SIGTERM)"))
            except Exception:
                pass
            fr = getattr(self.batcher, "flightrec", None)
            if fr is not None:
                fr.dump_file("second_sigterm")
        self.done.set()
        self._exit(EXIT_PREEMPTED)
