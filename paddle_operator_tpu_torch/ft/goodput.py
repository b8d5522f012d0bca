"""Goodput accounting: how much of the wallclock actually trained.

Own copy of ``paddle_operator_tpu/ft/goodput.py`` (which imports no
JAX), unchanged.

On preemptible capacity the interesting number is not step time but the
fraction of elapsed time that produced retained progress.  The breakdown
used here (the Google "goodput" formulation):

    goodput_ratio = productive_seconds / wallclock_seconds

with badput buckets:

    init       process start → first step (compile, mesh bring-up)
    restore    checkpoint restore on a restarted/rescaled gang
    lost_work  steps that ran before a kill but were after the last
               durable checkpoint — re-done after resume
    other      everything unattributed (data stalls between phases,
               teardown, eval)

The tracker is workload-side (ticked by train/trainer.fit); its snapshot
is published into ``TPUJob.status.goodput`` and surfaced two ways by the
control plane: per-job ``tpujob_goodput_*`` gauges on the manager's
``/metrics`` endpoint (controller/manager.py) and a ``Goodput`` job-status
condition (controller/reconciler.py).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Any, Dict, Optional


class GoodputTracker:
    """Wallclock ledger: productive step time vs attributed badput.

    Usage::

        tracker = GoodputTracker()
        with tracker.phase("init"):
            state = create_state(...)
        with tracker.phase("restore"):
            state, resumed = resume_or_init(...)
        fit(..., goodput=tracker)          # ticks per completed step
        tracker.record_lost_steps(lost, step_time)   # after a resume
    """

    def __init__(self, clock=time.perf_counter) -> None:
        self._clock = clock
        self._start = clock()
        self._productive = 0.0
        self._steps = 0
        self._badput: Dict[str, float] = {
            "init": 0.0, "restore": 0.0, "lost_work": 0.0,
        }
        self._last: Optional[float] = None
        self._lock = threading.Lock()

    # -- recording ---------------------------------------------------------

    @contextlib.contextmanager
    def phase(self, name: str):
        """Attribute the enclosed wallclock to badput bucket ``name``.
        Also disarms the step clock: a tick after the phase must not
        accrue the phase's interval (already badput) into productive
        time — that would double-count it and inflate the ratio."""
        t0 = self._clock()
        try:
            yield self
        finally:
            with self._lock:
                self._badput[name] = (self._badput.get(name, 0.0)
                                      + self._clock() - t0)
                self._last = None

    def tick(self) -> None:
        """Mark a completed training step.  The first tick only arms the
        clock (time before it belongs to init/restore); each later tick
        adds the inter-tick interval to productive time."""
        now = self._clock()
        with self._lock:
            if self._last is not None:
                self._productive += now - self._last
                self._steps += 1
            self._last = now

    def pause(self) -> None:
        """Disarm the step clock (e.g. around eval): the gap until the
        next tick is not counted productive."""
        with self._lock:
            self._last = None

    def record_lost_work(self, seconds: float) -> None:
        """Attribute re-done work: wallclock of the steps a predecessor
        process ran past its last durable checkpoint."""
        with self._lock:
            self._badput["lost_work"] += max(0.0, seconds)

    def record_lost_steps(self, steps: int, step_time: float) -> None:
        self.record_lost_work(steps * step_time)

    # -- reading -----------------------------------------------------------

    @property
    def wallclock_seconds(self) -> float:
        return self._clock() - self._start

    @property
    def productive_seconds(self) -> float:
        with self._lock:
            return self._productive

    @property
    def steps(self) -> int:
        with self._lock:
            return self._steps

    def badput(self) -> Dict[str, float]:
        """Badput breakdown, including the residual ``other`` bucket (so
        the buckets + productive always sum to wallclock)."""
        wall = self.wallclock_seconds
        with self._lock:
            out = dict(self._badput)
            attributed = self._productive + sum(out.values())
        out["other"] = max(0.0, wall - attributed)
        return out

    @property
    def goodput_ratio(self) -> float:
        wall = self.wallclock_seconds
        return self.productive_seconds / wall if wall > 0 else 0.0

    # -- export ------------------------------------------------------------

    def to_status(self) -> Dict[str, Any]:
        """The ``TPUJob.status.goodput`` block (camelCase, rounded — this
        rides the CRD through the apiserver)."""
        return {
            "ratio": round(self.goodput_ratio, 4),
            "productiveSeconds": round(self.productive_seconds, 3),
            "wallclockSeconds": round(self.wallclock_seconds, 3),
            "steps": self.steps,
            "badput": {k: round(v, 3) for k, v in self.badput().items()},
        }


def goodput_gauges(status_goodput: Dict[str, Any],
                   job: str) -> Dict[str, float]:
    """Prometheus gauge lines for one job's published goodput block —
    shared by the manager's metrics export so names can't drift from the
    docs.  ``job`` is ``namespace/name``."""
    lbl = f'{{job="{job}"}}'
    out = {
        f"tpujob_goodput_ratio{lbl}": float(status_goodput.get("ratio", 0.0)),
        f"tpujob_goodput_productive_seconds{lbl}":
            float(status_goodput.get("productiveSeconds", 0.0)),
        f"tpujob_goodput_wallclock_seconds{lbl}":
            float(status_goodput.get("wallclockSeconds", 0.0)),
    }
    for kind, secs in (status_goodput.get("badput") or {}).items():
        out[f'tpujob_badput_seconds{{job="{job}",kind="{kind}"}}'] = \
            float(secs)
    return out


def goodput_condition(status_goodput: Dict[str, Any], now: str) -> Dict[str, Any]:
    """The ``Goodput`` job-status condition derived from a published
    goodput block (set by the reconciler's status sync)."""
    ratio = float(status_goodput.get("ratio", 0.0))
    return {
        "type": "Goodput",
        "status": "True" if ratio >= 0.5 else "False",
        "reason": "Measured",
        "message": f"goodput {ratio:.2%} of wallclock",
        "lastTransitionTime": now,
    }
