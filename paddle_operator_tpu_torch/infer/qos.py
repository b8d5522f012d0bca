"""Priority classes and preemption budgets for the serving ring — own
copy of the jax-free half of ``paddle_operator_tpu/infer/qos.py``:
:class:`QoSConfig`, :class:`MultiClassQueue` and
:class:`PreemptionBudget`.

``submit(priority=)`` / HTTP ``X-Request-Priority`` order admission in
class-then-FIFO order (class 0 is the most urgent), each class with its
OWN bounded queue, so a flood in one class sheds its own overflow and
never backpressures a more urgent one.  On the paged ring a waiting
request of a strictly more urgent class preempts a resident lane
(SERVE_PREEMPT, on by default): the lane spills to host and resumes
later, bit-identically (infer/scheduler.py), within the budgets below.

Not ported yet (ROADMAP.md Queue A): the LoRA ``AdapterRegistry``.  The
defaults are the JAX package's ``controller/policy.py``
``DEFAULT_POLICY`` values, copied as constants.
"""

from __future__ import annotations

import os
import queue as _queue
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, List, Optional

MAX_PRIORITIES = 8

# controller/policy.py DEFAULT_POLICY of the JAX package
DEFAULT_PRIORITIES = 2
DEFAULT_PREEMPT_BUDGET = 16
DEFAULT_PREEMPT_WINDOW_S = 10.0
DEFAULT_MAX_PREEMPTS_PER_REQUEST = 2


@dataclass
class QoSConfig:
    """Knobs for the multi-class scheduler (env surface in
    infer/serve.py: ``SERVE_PRIORITIES`` / ``SERVE_PREEMPT*``).

    - ``priorities``: number of classes (class 0 most urgent).  1 turns
      the queue into a single FIFO.
    - ``default_priority``: class for unannotated requests; ``None``
      resolves to the LEAST urgent class — priorities are opt-in
      boosts, so unannotated traffic keeps FIFO behavior exactly.
    - ``preempt``: allow lane spill for waiting more-urgent work
      (paged rings only — the spill rides the block pool).
    - ``max_preempts_per_request``: one victim is never bounced more
      than this many times (starvation guard).
    - ``preempt_budget`` / ``preempt_window_s``: at most ``budget``
      preemptions per rolling window (anti-thrash: a pathological
      priority mix degrades to FIFO, never to spill churn).
    """

    priorities: int = DEFAULT_PRIORITIES
    default_priority: Optional[int] = None
    preempt: bool = True
    max_preempts_per_request: int = DEFAULT_MAX_PREEMPTS_PER_REQUEST
    preempt_budget: int = DEFAULT_PREEMPT_BUDGET
    preempt_window_s: float = DEFAULT_PREEMPT_WINDOW_S

    def __post_init__(self) -> None:
        if not 1 <= self.priorities <= MAX_PRIORITIES:
            raise ValueError(f"priorities must be in [1, {MAX_PRIORITIES}]"
                             f" (got {self.priorities})")
        if self.default_priority is None:
            self.default_priority = self.priorities - 1
        if not 0 <= self.default_priority < self.priorities:
            raise ValueError(
                f"default_priority {self.default_priority} outside "
                f"[0, {self.priorities})")

    @classmethod
    def from_env(cls, env=None) -> "QoSConfig":
        env = os.environ if env is None else env
        return cls(
            priorities=int(env.get("SERVE_PRIORITIES",
                                   str(DEFAULT_PRIORITIES))),
            preempt=env.get("SERVE_PREEMPT", "1") == "1",
            max_preempts_per_request=int(env.get(
                "SERVE_PREEMPT_MAX_PER_REQ",
                str(DEFAULT_MAX_PREEMPTS_PER_REQUEST))),
            preempt_budget=int(env.get("SERVE_PREEMPT_BUDGET",
                                       str(DEFAULT_PREEMPT_BUDGET))),
            preempt_window_s=float(env.get(
                "SERVE_PREEMPT_WINDOW_S", str(DEFAULT_PREEMPT_WINDOW_S))),
        )


class MultiClassQueue:
    """Thread-safe per-class bounded FIFO with class-order pops.

    The API mirrors the slice of ``queue.Queue`` the scheduler uses
    (``put``/``get_nowait``/``qsize``/``empty``/``full``) with a class
    argument where it matters.  The bound is PER CLASS; ``maxsize`` 0
    = unbounded, like queue.Queue."""

    def __init__(self, n_classes: int, maxsize: int = 0) -> None:
        if n_classes < 1:
            raise ValueError("n_classes must be >= 1")
        self.n_classes = n_classes
        self.maxsize = int(maxsize)
        self._qs: List[deque] = [deque() for _ in range(n_classes)]
        self._lock = threading.Lock()
        # wakes blocked put(timeout=) callers the moment ANY class drains
        self._not_full = threading.Condition(self._lock)

    def _check_class(self, prio: int) -> int:
        prio = int(prio)
        if not 0 <= prio < self.n_classes:
            raise ValueError(f"priority {prio} outside "
                             f"[0, {self.n_classes})")
        return prio

    def put_nowait(self, item: Any, prio: int) -> None:
        prio = self._check_class(prio)
        with self._lock:
            if self.maxsize and len(self._qs[prio]) >= self.maxsize:
                raise _queue.Full
            self._qs[prio].append(item)

    def put(self, item: Any, prio: int,
            timeout: Optional[float] = None) -> None:
        """Blocking put: wait up to ``timeout`` for class ``prio`` to
        have room, then raise queue.Full."""
        prio = self._check_class(prio)
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        with self._not_full:
            while self.maxsize and len(self._qs[prio]) >= self.maxsize:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise _queue.Full
                self._not_full.wait(remaining)
            self._qs[prio].append(item)

    def get_nowait(self) -> Any:
        """Pop the oldest item of the MOST urgent non-empty class."""
        with self._lock:
            for q in self._qs:
                if q:
                    item = q.popleft()
                    self._not_full.notify_all()
                    return item
        raise _queue.Empty

    def peek_class(self) -> Optional[int]:
        """Most urgent non-empty class (None when empty)."""
        with self._lock:
            for c, q in enumerate(self._qs):
                if q:
                    return c
        return None

    def full(self, prio: int) -> bool:
        prio = self._check_class(prio)
        if not self.maxsize:
            return False
        with self._lock:
            return len(self._qs[prio]) >= self.maxsize

    def qsize(self) -> int:
        with self._lock:
            return sum(len(q) for q in self._qs)

    def qsize_by_class(self) -> List[int]:
        with self._lock:
            return [len(q) for q in self._qs]

    def empty(self) -> bool:
        return self.qsize() == 0

    def items(self) -> List[Any]:
        """Snapshot of every queued item (all classes)."""
        with self._lock:
            return [item for q in self._qs for item in q]



class PreemptionBudget:
    """Rolling-window preemption counter (the anti-thrash budget): at
    most ``budget`` spends per ``window_s``.  When the mix is so
    adversarial that the budget pins, the ring degrades to in-order
    admission — each spill and restore moves a lane's blocks across
    the host link."""

    def __init__(self, budget: int, window_s: float,
                 clock=time.monotonic) -> None:
        self.budget = int(budget)
        self.window_s = float(window_s)
        self._clock = clock
        self._spends: deque = deque()

    def _trim(self) -> None:
        now = self._clock()
        while self._spends and now - self._spends[0] >= self.window_s:
            self._spends.popleft()

    def ok(self) -> bool:
        self._trim()
        return len(self._spends) < self.budget

    def spend(self) -> None:
        self._trim()
        self._spends.append(self._clock())
