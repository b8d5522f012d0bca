"""Own copy of the always-on serving observability of
``paddle_operator_tpu/utils/tracing.py``: the header helper the
handler uses, the latency histograms the continuous ring records into
(:class:`Histogram`, :func:`hist_quantile`, :class:`ServeHistograms`)
and the :class:`FlightRecorder`.  Per-request span capture (the
``Tracer``, ``SERVE_TRACE=1``) and trace propagation are not ported
yet (ROADMAP.md Queue A)."""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple


def safe_header_value(value, cap: int = 128) -> str:
    """A client-supplied string (request_id) made safe to ECHO in a
    response header: printable ASCII only (CR/LF would split the
    response; non-latin-1 raises inside send_header AFTER the status
    line, truncating an otherwise-good reply), bounded length."""
    return "".join(c if " " <= c <= "~" else "_"
                   for c in str(value))[:cap]


# ---------------------------------------------------------------------------
# Latency histograms
# ---------------------------------------------------------------------------

# power-of-two millisecond bounds: 1 ms .. ~65 s
BUCKETS_MS: Tuple[float, ...] = tuple(
    float(2 ** i) for i in range(17))        # 1, 2, 4, ... 65536

# the serving histogram families — family key -> metric name
HIST_FAMILIES: Dict[str, str] = {
    "ttft": "tpujob_serve_ttft_ms",
    "itl": "tpujob_serve_itl_ms",
    "e2e": "tpujob_serve_e2e_ms",
    "queueWait": "tpujob_serve_queue_wait_ms",
}

# the rolling window the autoscaler's p95 reads over
HIST_WINDOW_S = 60.0


class Histogram:
    """Prometheus-style cumulative histogram with fixed bounds, plus a
    ROLLING-WINDOW view for control decisions.

    The cumulative counts are what ``/metrics`` exposes; :meth:`p95`
    reads a two-epoch rotating window (the last ``window_s``..
    2x``window_s`` of samples), so the p95 reflects now, not boot."""

    def __init__(self, name: str,
                 buckets: Sequence[float] = BUCKETS_MS,
                 window_s: float = HIST_WINDOW_S,
                 clock=time.monotonic) -> None:
        self.name = name
        self.bounds = tuple(float(b) for b in buckets)
        self._clock = clock
        self.window_s = float(window_s)
        n = len(self.bounds) + 1          # trailing +Inf bucket
        self._lock = threading.Lock()
        self.counts = [0] * n
        self.sum = 0.0
        self.count = 0
        self._cur = [0] * n
        self._prev = [0] * n
        self._epoch = self._clock()

    def _bucket_of(self, v: float) -> int:
        for i, b in enumerate(self.bounds):
            if v <= b:
                return i
        return len(self.bounds)

    def _rotate_locked(self, now: float) -> None:
        gap = now - self._epoch
        if gap >= 2 * self.window_s:
            # a long quiet gap clears BOTH epochs: a long-resolved burst
            # must not read as "the last 1-2 windows"
            self._prev = [0] * len(self.counts)
            self._cur = [0] * len(self.counts)
            self._epoch = now
        elif gap >= self.window_s:
            # one stale epoch survives as _prev so the window never
            # reads empty right after a rotation
            self._prev = self._cur
            self._cur = [0] * len(self.counts)
            self._epoch = now

    def observe(self, v_ms: float) -> None:
        v = float(v_ms)
        i = self._bucket_of(v)
        now = self._clock()
        with self._lock:
            self._rotate_locked(now)
            self.counts[i] += 1
            self._cur[i] += 1
            self.sum += v
            self.count += 1

    def window_counts(self) -> List[int]:
        """Per-bucket counts over the last 1-2 windows."""
        now = self._clock()
        with self._lock:
            self._rotate_locked(now)
            return [a + b for a, b in zip(self._cur, self._prev)]

    def p95(self) -> Optional[float]:
        return hist_quantile(self.bounds, self.window_counts(), 0.95)

    def snapshot(self) -> Dict[str, Any]:
        """The ``status.serving.latencyHist`` entry: cumulative counts
        for exposition, windowed counts for folding/quantiles."""
        window = self.window_counts()
        with self._lock:
            return {"buckets": list(self.bounds),
                    "counts": list(self.counts),
                    "sum": round(self.sum, 3),
                    "count": self.count,
                    "window": window}


def hist_quantile(bounds: Sequence[float], counts: Sequence[int],
                  q: float) -> Optional[float]:
    """Prometheus ``histogram_quantile``-style estimate from
    PER-BUCKET (non-cumulative) counts: find the bucket the q-rank
    lands in, interpolate linearly inside it.  None with no samples.
    The +Inf bucket reports its lower bound (the standard clamp)."""
    total = sum(counts)
    if total <= 0:
        return None
    rank = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        cum += c
        if cum >= rank:
            if i >= len(bounds):            # +Inf bucket
                return float(bounds[-1])
            hi = float(bounds[i])
            lo = float(bounds[i - 1]) if i else 0.0
            frac = (rank - (cum - c)) / c if c else 1.0
            return lo + (hi - lo) * frac
    return float(bounds[-1])


class ServeHistograms:
    """The serving ring's histogram set (one per
    :data:`HIST_FAMILIES`).  Always on — observing is a few host float
    ops at points the scheduler already timestamps."""

    def __init__(self, clock=time.monotonic) -> None:
        self.ttft = Histogram(HIST_FAMILIES["ttft"], clock=clock)
        self.itl = Histogram(HIST_FAMILIES["itl"], clock=clock)
        self.e2e = Histogram(HIST_FAMILIES["e2e"], clock=clock)
        self.queue_wait = Histogram(HIST_FAMILIES["queueWait"],
                                    clock=clock)

    def families(self) -> Dict[str, Histogram]:
        return {"ttft": self.ttft, "itl": self.itl, "e2e": self.e2e,
                "queueWait": self.queue_wait}

    def snapshot(self) -> Dict[str, Any]:
        return {k: h.snapshot() for k, h in self.families().items()}


# ---------------------------------------------------------------------------
# Flight recorder
# ---------------------------------------------------------------------------

FLIGHTREC_DIR_ENV = "TPUJOB_FLIGHTREC_DIR"


class FlightRecorder:
    """Bounded ring of structured events per pod.

    ``record(kind, **detail)`` is cheap host bookkeeping at event rates
    of admissions and rebuilds — never in a per-token path.
    ``dump_file`` writes the whole ring as JSON to
    ``$TPUJOB_FLIGHTREC_DIR/tpujob_flightrec_<pod|pid>.json`` (the
    temp dir when unset) — fired on a watchdog rebuild and on SIGTERM,
    so the last moments before a crash or drain survive the pod."""

    def __init__(self, capacity: int = 512, pod: str = "") -> None:
        self.pod = pod or str(os.getpid())
        self._ring: "deque[Dict[str, Any]]" = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self.dumps = 0
        self.last_dump_path: Optional[str] = None

    def record(self, kind: str, **detail) -> None:
        ev = {"t": round(time.time(), 3), "kind": str(kind)}
        if detail:
            ev.update({k: v for k, v in detail.items()
                       if v is not None})
        with self._lock:
            self._ring.append(ev)

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def dump(self, reason: str) -> Dict[str, Any]:
        return {"pod": self.pod, "reason": str(reason),
                "t": round(time.time(), 3), "events": self.events()}

    def default_path(self) -> str:
        d = os.environ.get(FLIGHTREC_DIR_ENV) or tempfile.gettempdir()
        safe = "".join(c if c.isalnum() or c in "-_." else "_"
                       for c in self.pod)
        return os.path.join(d, f"tpujob_flightrec_{safe}.json")

    def dump_file(self, reason: str,
                  path: Optional[str] = None) -> Optional[str]:
        """Write the dump; returns the path (None on I/O failure — a
        full disk must never take the serving path down with it)."""
        path = path or self.default_path()
        try:
            tmp = f"{path}.tmp"
            with open(tmp, "w") as f:
                json.dump(self.dump(reason), f)
            os.replace(tmp, path)
        except OSError:
            return None
        self.dumps += 1
        self.last_dump_path = path
        return path
