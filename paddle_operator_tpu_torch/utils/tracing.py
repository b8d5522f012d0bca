"""Own copy of ``paddle_operator_tpu/utils/tracing.py``: request
spans, latency histograms and the flight recorder of the serving ring
(stdlib only; nothing here touches the device).

- **Request spans** — each request carries a trace context (the
  ``X-Tpujob-Trace`` header: ``<trace_id>`` or
  ``<trace_id>-<parent_span_id>``) and, on a ring with ``SERVE_TRACE=1``,
  accumulates monotonic-clock phase spans (:class:`RequestTrace`) at the
  scheduler's existing host points: submit, admission, prefill slices,
  the consume of each dispatch, spill and restore.  Completed span sets
  ride response metadata, so the fleet router stitches one cross-pod
  timeline a request (:class:`TraceStore`, ``/debug/tracez``).  Spans
  are host timestamps only: tracing adds no device synchronization, and
  traced token streams equal untraced ones.  The header, the span dicts
  and the export lines are byte-compatible with the JAX package's.
- **Histograms** — fixed log-bucket histograms (:class:`Histogram`,
  :class:`ServeHistograms`) of TTFT, inter-token latency, e2e and queue
  wait; they fold across replicas by addition
  (:func:`fold_latency_hists`, :func:`hist_p95`).
- **Flight recorder** — a bounded ring of structured events per pod
  (:class:`FlightRecorder`) dumped on a watchdog rebuild, an injected
  chaos fault and SIGTERM, and served at ``/debug/flightrec``.
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

# the cross-pod trace context header: "<trace_id>" (the client/router
# minted a trace but no parent span) or "<trace_id>-<parent_span_id>"
TRACE_HEADER = "X-Tpujob-Trace"

# env knob serve.py reads: SERVE_TRACE=1 turns span capture on for a
# replica (histograms and the flight recorder are always on — they are
# metrics, like the gauges)
TRACE_ENV = "SERVE_TRACE"


def trace_enabled(env=None) -> bool:
    env = os.environ if env is None else env
    return env.get(TRACE_ENV, "0") == "1"


def safe_header_value(value, cap: int = 128) -> str:
    """A client-supplied string (request_id) made safe to ECHO in a
    response header: printable ASCII only (CR/LF would split the
    response; non-latin-1 raises inside send_header AFTER the status
    line, truncating an otherwise-good reply), bounded length."""
    return "".join(c if " " <= c <= "~" else "_"
                   for c in str(value))[:cap]


def new_id() -> str:
    """16-hex span/trace id (crypto-strength uniqueness is not the
    point; cross-process collision resistance is)."""
    return os.urandom(8).hex()


def format_trace_header(trace_id: str,
                        parent: Optional[str] = None) -> str:
    return f"{trace_id}-{parent}" if parent else str(trace_id)


def parse_trace_header(value: Optional[str]
                       ) -> Optional[Tuple[str, Optional[str]]]:
    """``(trace_id, parent_span_id | None)`` — or None for an absent /
    unusable header (tracing silently off for that request; a
    malformed header must never 400 a generate)."""
    if not value:
        return None
    value = value.strip()
    if not value:
        return None
    tid, sep, parent = value.partition("-")
    if not tid:
        return None
    return tid, (parent or None)


# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------


def make_span(name: str, parent: Optional[str], t0_ms: float,
              dur_ms: float, *, span_id: Optional[str] = None,
              pod: str = "", **attrs) -> Dict[str, Any]:
    """One wire-format span.  ``t0_ms`` is WALL-clock epoch ms (the
    only clock that means anything across pods; durations are measured
    on the monotonic clock and only anchored to wall time once)."""
    span = {"id": span_id or new_id(), "parent": parent, "name": name,
            "t0": round(float(t0_ms), 3), "dur": round(float(dur_ms), 3)}
    if pod:
        span["pod"] = pod
    if attrs:
        span["attrs"] = attrs
    return span


def span_roots(spans: Sequence[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Spans whose parent is absent from the set (None, or an id the
    set does not contain — the stitched timeline's roots).  A COMPLETE
    stitched tree has exactly one."""
    ids = {s.get("id") for s in spans}
    return [s for s in spans
            if s.get("parent") is None or s.get("parent") not in ids]


class RequestTrace:
    """Per-request span accumulator (host bookkeeping only).

    A root ``request`` span opens at construction; phases land through
    :meth:`add` with MONOTONIC timestamps (wall anchoring happens once,
    here).  The span list is bounded — a 10k-token generation must not
    grow an unbounded decode-dispatch list; overflow increments
    ``dropped`` and the root carries the count.  ``add`` is
    thread-safe: the remote-prefill client and migration workers stamp
    spans off the ring thread."""

    MAX_SPANS = 128

    __slots__ = ("trace_id", "pod", "root_id", "spans", "dropped",
                 "_anchor_mono", "_anchor_wall", "_t0_mono", "_lock",
                 "_closed")

    def __init__(self, trace_id: Optional[str] = None,
                 parent: Optional[str] = None, pod: str = "",
                 request_id: Optional[str] = None) -> None:
        self.trace_id = trace_id or new_id()
        self.pod = pod
        self.root_id = new_id()
        self._anchor_mono = time.monotonic()
        self._anchor_wall = time.time()
        self._t0_mono = self._anchor_mono
        self._lock = threading.Lock()
        self._closed = False
        self.dropped = 0
        root = make_span("request", parent, self._wall_ms(
            self._anchor_mono), 0.0, span_id=self.root_id, pod=pod)
        if request_id is not None:
            root["attrs"] = {"requestId": request_id}
        self.spans: List[Dict[str, Any]] = [root]

    def _wall_ms(self, t_mono: float) -> float:
        return (self._anchor_wall + (t_mono - self._anchor_mono)) * 1e3

    def add(self, name: str, t0_mono: float,
            t1_mono: Optional[float] = None,
            parent: Optional[str] = None, **attrs) -> None:
        """Record one phase span [t0, t1) (monotonic seconds); parent
        defaults to the request root.  Attr names colliding with
        make_span's own fields are dropped rather than crashing the
        capture thread (a span is telemetry, never a fault)."""
        for reserved in ("pod", "span_id"):
            attrs.pop(reserved, None)
        t1 = time.monotonic() if t1_mono is None else t1_mono
        with self._lock:
            if len(self.spans) >= self.MAX_SPANS:
                self.dropped += 1
                return
            self.spans.append(make_span(
                name, parent or self.root_id, self._wall_ms(t0_mono),
                (t1 - t0_mono) * 1e3, pod=self.pod, **attrs))

    def annotate(self, **attrs: Any) -> None:
        """Merge attrs into the ROOT span (workload-shape stamps:
        ``promptLen``/``maxNew``/``prio`` at scheduler submit) so an
        exported span tree alone reconstructs the request the fleet
        served — the replay harness (router/replay.py) rebuilds
        open-loop schedules from exactly these attrs.  None values are
        skipped; telemetry never raises."""
        clean = {k: v for k, v in attrs.items() if v is not None}
        if not clean:
            return
        with self._lock:
            self.spans[0].setdefault("attrs", {}).update(clean)

    def seed(self, spans: Sequence[Dict[str, Any]]) -> None:
        """Graft a PRIOR pod's completed spans (lane migration: the
        origin's spans travel in the envelope meta so the adopter's
        set still stitches into one tree)."""
        with self._lock:
            room = self.MAX_SPANS - len(self.spans)
            take = list(spans)[:max(0, room)]
            self.dropped += len(spans) - len(take)
            self.spans.extend(take)

    def finish(self, error: Optional[str] = None) -> None:
        """Close the root span (idempotent — a request resolves
        exactly once, but error paths can race the loop's sweep)."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
            root = self.spans[0]
            root["dur"] = round(
                (time.monotonic() - self._t0_mono) * 1e3, 3)
            if error or self.dropped:
                attrs = root.setdefault("attrs", {})
                if error:
                    attrs["error"] = str(error)[:200]
                if self.dropped:
                    attrs["droppedSpans"] = self.dropped

    def to_wire(self) -> Dict[str, Any]:
        """The response-metadata form the router stitches."""
        with self._lock:
            return {"traceId": self.trace_id, "pod": self.pod,
                    "rootId": self.root_id,
                    "spans": [dict(s) for s in self.spans]}


class Tracer:
    """Span-capture switchboard for one serving process: ``None`` on a
    batcher means tracing is OFF and every capture site is one
    attribute check (the zero-cost contract)."""

    def __init__(self, pod: str = "") -> None:
        self.pod = pod

    def begin(self, ctx: Optional[Tuple[str, Optional[str]]] = None,
              request_id: Optional[str] = None) -> RequestTrace:
        tid, parent = ctx if ctx is not None else (None, None)
        return RequestTrace(trace_id=tid, parent=parent, pod=self.pod,
                            request_id=request_id)


# ---------------------------------------------------------------------------
# Histograms
# ---------------------------------------------------------------------------

# Fixed log2 bucket bounds in MILLISECONDS, 1ms..~65s.  FIXED on
# purpose: bucket counts from different replicas fold by plain
# addition only while every exporter agrees on the bounds, and the
# serving latencies of interest (TTFT, ITL, e2e, queue wait) all live
# inside this range.  docs/observability.md is the catalog of record.
BUCKETS_MS: Tuple[float, ...] = tuple(
    float(2 ** i) for i in range(17))        # 1, 2, 4, ... 65536

# the serving histogram families — family key -> metric name
HIST_FAMILIES: Dict[str, str] = {
    "ttft": "tpujob_serve_ttft_ms",
    "itl": "tpujob_serve_itl_ms",
    "e2e": "tpujob_serve_e2e_ms",
    "queueWait": "tpujob_serve_queue_wait_ms",
}

# the rolling window the autoscaler's p95 reads over: long enough to
# smooth a scrape tick, short enough that a resolved burst stops
# breaching the SLO within ~two windows
HIST_WINDOW_S = 60.0


class Histogram:
    """Prometheus-style cumulative histogram with fixed bounds, plus a
    ROLLING-WINDOW view for control decisions.

    The cumulative counts are what ``/metrics`` exposes (standard
    ``_bucket``/``_sum``/``_count`` exposition; monotone, rate()-able).
    A cumulative histogram's quantile is sticky — one slow boot hour
    would pin the p95 forever — so :meth:`p95` reads a two-epoch
    rotating window (last ``window_s``..2x``window_s`` of samples)
    instead: the SLO autoscaler reacts to NOW, not to boot."""

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
            # rotation is driven by observe/snapshot calls, so a long
            # quiet gap (idle replica, paused controller polling) must
            # clear BOTH epochs — otherwise the first poll after the
            # gap would report a long-resolved burst as "the last 1-2
            # windows" and spuriously re-trigger the autoscaler's p95
            # floor
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


def fold_latency_hists(blocks: Sequence[Dict[str, Any]]
                       ) -> Dict[str, Any]:
    """Fold per-replica ``latencyHist`` snapshot blocks into one fleet
    block by per-bucket addition.  Entries whose bucket bounds differ
    from the majority are DROPPED (a mid-rollout mixed fleet must not
    mis-add counts into the wrong bounds)."""
    out: Dict[str, Any] = {}
    for fam in HIST_FAMILIES:
        entries = [b.get(fam) for b in blocks
                   if isinstance(b.get(fam), dict)
                   and b[fam].get("buckets")]
        if not entries:
            continue
        bounds = entries[0]["buckets"]
        entries = [e for e in entries if e["buckets"] == bounds]
        n = len(bounds) + 1

        def fold(key: str) -> List[int]:
            acc = [0] * n
            for e in entries:
                vals = e.get(key)
                if not vals and key == "window":
                    # windowless snapshot (e.g. freshly parsed from
                    # exposition): its cumulative counts ARE its best
                    # window estimate
                    vals = e.get("counts")
                for i in range(min(n, len(vals or []))):
                    acc[i] += int(vals[i])
            return acc

        out[fam] = {"buckets": list(bounds),
                    "counts": fold("counts"),
                    "sum": round(sum(float(e.get("sum", 0.0))
                                     for e in entries), 3),
                    "count": sum(int(e.get("count", 0))
                                 for e in entries),
                    "window": fold("window")}
    return out


def hist_p95(entry: Optional[Dict[str, Any]]) -> Optional[float]:
    """Windowed p95 of one snapshot/folded histogram entry (the
    number the SLO autoscaler compares against the CRD target)."""
    if not isinstance(entry, dict):
        return None
    counts = entry.get("window") or entry.get("counts") or []
    return hist_quantile(entry.get("buckets") or BUCKETS_MS, counts,
                         0.95)


# ---------------------------------------------------------------------------
# Flight recorder
# ---------------------------------------------------------------------------

FLIGHTREC_DIR_ENV = "TPUJOB_FLIGHTREC_DIR"


class FlightRecorder:
    """Bounded ring of structured events per pod.

    ``record(kind, **detail)`` is cheap host bookkeeping (deque append
    under a lock) at event rates of admissions/preemptions — never in
    a per-token path.  ``dump_file`` writes the whole ring as JSON
    (reason-stamped, newest last) to
    ``$TPUJOB_FLIGHTREC_DIR/tpujob_flightrec_<pod|pid>.json`` — fired
    on watchdog restart, chaos injection and SIGTERM so the last
    moments before a crash/drain survive the pod."""

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


# ---------------------------------------------------------------------------
# Router-side timeline store
# ---------------------------------------------------------------------------


class TraceStore:
    """Bounded LRU of stitched cross-pod timelines, keyed by trace id
    (the router's ``/debug/tracez`` backing store).

    The router creates ONE parentless ``request`` root span per trace
    (:meth:`root`) and parents every proxy attempt under it — so a
    retried request (replica died, lane migrated) stitches into the
    SAME tree instead of spawning a second root.  Replica span sets
    (ridden back on response metadata) land via :meth:`add`."""

    def __init__(self, cap: int = 256) -> None:
        self.cap = int(cap)
        self._lock = threading.Lock()
        self._timelines: "OrderedDict[str, Dict[str, Any]]" = \
            OrderedDict()

    def root(self, trace_id: str, parent: Optional[str] = None,
             request_id: Optional[str] = None) -> Dict[str, Any]:
        """Get-or-create the timeline for ``trace_id``; returns its
        root span (callers parent attempt spans on its id)."""
        with self._lock:
            tl = self._timelines.get(trace_id)
            if tl is None:
                root = make_span("request", parent, time.time() * 1e3,
                                 0.0)
                if request_id is not None:
                    root["attrs"] = {"requestId": request_id}
                tl = {"traceId": trace_id, "requestId": request_id,
                      "spans": [root]}
                self._timelines[trace_id] = tl
                while len(self._timelines) > self.cap:
                    self._timelines.popitem(last=False)
            self._timelines.move_to_end(trace_id)
            return tl["spans"][0]

    MAX_TIMELINE_SPANS = 512

    def add(self, trace_id: str,
            spans: Sequence[Dict[str, Any]]) -> None:
        with self._lock:
            tl = self._timelines.get(trace_id)
            if tl is None:
                return
            room = self.MAX_TIMELINE_SPANS - len(tl["spans"])
            tl["spans"].extend(list(spans)[:max(0, room)])
            # keep the root's duration covering the whole exchange
            root = tl["spans"][0]
            root["dur"] = round(time.time() * 1e3 - root["t0"], 3)
            self._timelines.move_to_end(trace_id)

    def get(self, trace_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            tl = self._timelines.get(trace_id)
            return json.loads(json.dumps(tl)) if tl else None

    def timelines(self) -> List[Dict[str, Any]]:
        with self._lock:
            return json.loads(json.dumps(list(
                self._timelines.values())))


# ---------------------------------------------------------------------------
# Machine-readable export: span trees + histogram snapshots
# as JSONL, the replay harness's recorded-trace input format
# ---------------------------------------------------------------------------

# one export line per record; "kind" discriminates
EXPORT_KIND_TIMELINE = "timeline"
EXPORT_KIND_HIST = "hist"


def export_jsonl(timelines: Sequence[Dict[str, Any]],
                 hists: Optional[Dict[str, Any]] = None,
                 pod: str = "") -> str:
    """Serialize stitched timelines (and optionally a
    :meth:`ServeHistograms.snapshot` / :func:`fold_latency_hists`
    block) as JSONL — one self-describing JSON object per line, so a
    replay consumer streams records without loading the whole export,
    and exports CONCATENATE across pods/scrapes by plain file append
    (the property JSON arrays lack, and the reason the format is
    JSONL at all).  Each line carries ``kind``:
    ``timeline`` (one stitched trace: traceId + spans) or ``hist``
    (one histogram snapshot block, ``families`` keyed like
    :data:`HIST_FAMILIES` — the calibration input for the virtual-time
    fleet model)."""
    lines: List[str] = []
    for tl in timelines:
        rec = {"kind": EXPORT_KIND_TIMELINE}
        rec.update(tl)
        lines.append(json.dumps(rec, sort_keys=True))
    if hists:
        rec = {"kind": EXPORT_KIND_HIST, "families": hists}
        if pod:
            rec["pod"] = pod
        lines.append(json.dumps(rec, sort_keys=True))
    return "\n".join(lines) + ("\n" if lines else "")


def parse_jsonl_export(text: str) -> Dict[str, Any]:
    """Parse an :func:`export_jsonl` stream (possibly several exports
    concatenated) back into ``{"timelines": [...], "hists": [...]}``.
    Unknown kinds and malformed lines are SKIPPED, not fatal — a
    replay must tolerate an export truncated by the pod dying
    mid-write, which is precisely when its trace matters most."""
    timelines: List[Dict[str, Any]] = []
    hists: List[Dict[str, Any]] = []
    for line in text.splitlines():
        line = line.strip()
        if not line:
            continue
        try:
            rec = json.loads(line)
        except ValueError:
            continue
        if not isinstance(rec, dict):
            continue
        kind = rec.get("kind")
        if kind == EXPORT_KIND_TIMELINE and rec.get("spans"):
            timelines.append(rec)
        elif kind == EXPORT_KIND_HIST and rec.get("families"):
            hists.append(rec)
    return {"timelines": timelines, "hists": hists}


def read_flightrec_dump(path: str) -> Dict[str, Any]:
    """Read a :meth:`FlightRecorder.dump_file` JSON dump back as a
    dict (``{"pod", "reason", "t", "events"}``) — the OTHER recorded
    workload source replay accepts: ``admit`` events carry arrival
    wall-time, request id and priority, enough to rebuild an open-loop
    arrival schedule when span capture was off.  Raises OSError /
    ValueError on an unreadable or non-dump file — a replay fed a
    wrong path should fail loudly, unlike the in-band telemetry
    paths."""
    with open(path) as f:
        d = json.load(f)
    if not isinstance(d, dict) or "events" not in d:
        raise ValueError(f"{path}: not a flight-recorder dump "
                         "(no 'events' key)")
    return d
