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
The defaults are the JAX package's ``controller/policy.py``
``DEFAULT_POLICY`` values, copied as constants.

Many-adapter (LoRA) serving: :class:`AdapterRegistry` holds up to
``capacity`` low-rank deltas for ``wq``/``wk``/``wv`` in fixed-shape
device stacks (slot 0 the all-zero base adapter), and :func:`lora_qkv`
is the one delta rule every projection site of the ring applies, so a
batch whose lanes use different adapters is still one dispatch (one
CUDA graph replay on the card).
"""

from __future__ import annotations

import contextlib
import hashlib
import os
import queue as _queue
import re
import threading
import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

MAX_PRIORITIES = 8

# adapter names become Prometheus label values and routing keys — keep
# them to a charset that needs no escaping anywhere downstream
_ADAPTER_NAME_RE = re.compile(r"^[A-Za-z0-9_.\-]{1,64}$")

# controller/policy.py DEFAULT_POLICY of the JAX package
DEFAULT_PRIORITIES = 2
DEFAULT_PREEMPT_BUDGET = 16
DEFAULT_PREEMPT_WINDOW_S = 10.0
DEFAULT_MAX_PREEMPTS_PER_REQUEST = 2


class AdapterInUse(ValueError):
    """Raised by :meth:`AdapterRegistry.evict`/:meth:`~AdapterRegistry.
    load` when the target adapter still serves resident, parked or
    queued lanes — a typed signal, so the HTTP surface answers 409
    exactly."""


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


# ---------------------------------------------------------------------------
# Many-adapter (LoRA) serving
# ---------------------------------------------------------------------------

# the projections the low-rank deltas target: the attention inputs
# (classic LoRA).  wo is not in the set, as in the JAX package.
LORA_PROJS = ("wq", "wk", "wv")


def _proj_dims(cfg) -> Dict[str, Tuple[int, int]]:
    return {
        "wq": (cfg.dim, cfg.n_heads * cfg.head_dim),
        "wk": (cfg.dim, cfg.n_kv_heads * cfg.head_dim),
        "wv": (cfg.dim, cfg.n_kv_heads * cfg.head_dim),
    }


def stable_name_seed(name: str) -> int:
    """Deterministic cross-process seed for a bare adapter name: a
    digest, because ``hash(str)`` is salted per process, and two fleet
    replicas booting ``SERVE_ADAPTERS=x`` must synthesize the SAME smoke
    adapter for the router to treat them as interchangeable holders."""
    return int.from_bytes(
        hashlib.blake2b(name.encode(), digest_size=4).digest(),
        "little") & 0x7FFFFFFF


def make_random_adapter(cfg, rank: int, seed: int,
                        scale: float = 0.5) -> Dict[str, Any]:
    """A deterministic random LoRA delta (smoke mode): per projection
    ``A [L, dim, r]`` / ``B [L, r, out]`` f32 numpy arrays from numpy's
    generator, so they are the JAX package's arrays for the same seed,
    bit for bit.  ``scale`` is large enough that distinct adapters give
    distinct token streams on a tiny model."""
    rng = np.random.default_rng(seed)
    out = {}
    for proj, (din, dout) in _proj_dims(cfg).items():
        a = rng.standard_normal((cfg.n_layers, din, rank)).astype(
            np.float32) * (scale / np.sqrt(din))
        b = rng.standard_normal((cfg.n_layers, rank, dout)).astype(
            np.float32) * (scale / np.sqrt(rank))
        out[proj] = {"a": a, "b": b}
    return out


def load_adapter_file(cfg, path: str, rank: int) -> Dict[str, Any]:
    """A LoRA delta from an ``.npz`` with keys ``{proj}_a`` [L, dim, r]
    and ``{proj}_b`` [L, r, out] for each projection of
    :data:`LORA_PROJS`.  A file rank SMALLER than the registry's
    zero-pads (exact: padded rank columns contribute 0); a larger one
    raises."""
    data = np.load(path)
    out = {}
    for proj, (din, dout) in _proj_dims(cfg).items():
        a = np.asarray(data[f"{proj}_a"], np.float32)
        b = np.asarray(data[f"{proj}_b"], np.float32)
        if a.shape[0] != cfg.n_layers or a.shape[1] != din \
                or b.shape[2] != dout or a.shape[2] != b.shape[1]:
            raise ValueError(
                f"{path}: {proj} shapes {a.shape}/{b.shape} do not fit "
                f"[L={cfg.n_layers}, {din}, r]/[L, r, {dout}]")
        r = a.shape[2]
        if r > rank:
            raise ValueError(f"{path}: {proj} rank {r} exceeds the "
                             f"registry rank {rank}")
        if r < rank:
            a = np.pad(a, ((0, 0), (0, 0), (0, rank - r)))
            b = np.pad(b, ((0, 0), (0, rank - r), (0, 0)))
        out[proj] = {"a": a, "b": b}
    return out


class AdapterRegistry:
    """Fixed-capacity pool of LoRA adapters served off one base model.

    Device layout: per projection, stacked ``a [L, capacity+1, dim, r]``
    and ``b [L, capacity+1, r, out]`` f32 tensors on ``device`` whose
    slot 0 is the all-zero BASE adapter.  They are allocated once, here,
    before any CUDA graph is captured: a load or an evict writes its one
    slot IN PLACE and never reallocates, so the ring's captured graphs
    keep reading the stacks at the addresses they hold.

    ``ns_of(idx)`` is the radix-cache namespace: a fresh token minted at
    every load, so a prefix cached under one adapter is never hit by a
    DIFFERENT adapter later loaded into the same slot (the KV bytes
    differ: wk/wv carry the delta)."""

    def __init__(self, cfg, capacity: int = 8, rank: int = 8, *,
                 device="cuda") -> None:
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if rank < 1:
            raise ValueError("rank must be >= 1")
        self.cfg = cfg
        self.capacity = int(capacity)
        self.rank = int(rank)
        self.device = torch.device(device)
        self._lock = threading.Lock()
        self._by_name: Dict[str, int] = {}
        self._by_idx: Dict[int, str] = {}
        self._ns: Dict[int, int] = {}           # idx -> load generation
        self._gen = 0
        self._dev: Dict[str, Dict[str, torch.Tensor]] = {}
        for proj, (din, dout) in _proj_dims(cfg).items():
            self._dev[proj] = {
                "a": torch.zeros((cfg.n_layers, self.capacity + 1, din,
                                  self.rank), dtype=torch.float32,
                                 device=self.device),
                "b": torch.zeros((cfg.n_layers, self.capacity + 1,
                                  self.rank, dout), dtype=torch.float32,
                                 device=self.device),
            }
        # the stacks' own device ("cuda" resolved to its index)
        self.device = self._dev["wq"]["a"].device
        # slot writes go on their own stream, so a load never queues
        # behind the ring's dispatches (nor they behind it)
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)

    def __len__(self) -> int:
        return len(self._by_name)

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._by_name)

    def resolve(self, name: str) -> int:
        with self._lock:
            idx = self._by_name.get(name)
        if idx is None:
            raise ValueError(f"unknown adapter {name!r} (loaded: "
                             f"{sorted(self._by_name) or 'none'})")
        return idx

    def resolve_ns(self, name: str) -> Tuple[int, int]:
        """``name`` -> ``(slot, namespace)`` under ONE lock acquisition:
        a concurrent evict between a resolve() and an ns_of() would
        otherwise surface as a KeyError instead of the ValueError every
        other adapter failure maps to."""
        with self._lock:
            idx = self._by_name.get(name)
            if idx is None:
                raise ValueError(
                    f"unknown adapter {name!r} (loaded: "
                    f"{sorted(self._by_name) or 'none'})")
            return idx, self._ns[idx]

    def ns_of(self, idx: int) -> int:
        """Radix-cache namespace token of adapter slot ``idx`` (0 for
        the base model: namespace 0 is the unsalted chain, so
        adapterless serving keys as it always did).  KeyError for a slot
        with nothing loaded."""
        if idx == 0:
            return 0
        with self._lock:
            return self._ns[idx]

    def arrays(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The stacked device tensors every adapter-aware program reads
        (fixed addresses for the registry's lifetime)."""
        return self._dev

    def nbytes(self) -> int:
        """Device bytes of the six stacks."""
        return sum(t.numel() * t.element_size()
                   for ab in self._dev.values() for t in ab.values())

    def _write_slot(self, idx: int, staged) -> None:
        """Write slot ``idx`` of every stack (``staged``: proj -> (a, b)
        CPU tensors, or None for zeros) and wait until the device holds
        it.  On the card the copies run on the registry's own stream and
        the caller's thread waits for that stream alone: when this
        returns, a dispatch queued afterwards reads the new slot."""
        ctx = (torch.cuda.stream(self._stream) if self._stream is not None
               else contextlib.nullcontext())
        with ctx:
            for proj in LORA_PROJS:
                for key in ("a", "b"):
                    dst = self._dev[proj][key][:, idx]
                    if staged is None:
                        dst.zero_()
                    else:
                        src = staged[proj][0 if key == "a" else 1]
                        if self._stream is not None:
                            src = src.pin_memory()
                        dst.copy_(src, non_blocking=True)
        if self._stream is not None:
            self._stream.synchronize()

    def load(self, name: str, deltas: Optional[Dict[str, Any]] = None,
             *, seed: Optional[int] = None, in_use=frozenset()) -> int:
        """Install (or replace) adapter ``name``; returns its slot.
        ``deltas``: :func:`load_adapter_file`-shaped; with ``deltas=None``
        a deterministic random adapter is made from ``seed`` (default:
        :func:`stable_name_seed` of the name).  Raises when the pool is
        full (evict first: the capacity is the stacks' fixed shape) and
        :class:`AdapterInUse` when replacing an adapter in ``in_use``.

        Every projection is validated before the first device write, so
        a bad file never leaves a slot half overwritten.  The write runs
        on the HTTP thread while the ring thread may be replaying a
        graph that reads the stacks; it is complete on the device
        (:meth:`_write_slot` waits for it) BEFORE the name is published,
        so no request can resolve the slot earlier.  No replay in flight
        reads the slot for a live lane either: a fresh slot belongs to
        no lane, and a replaced one is refused while any resident,
        parked or queued lane uses it (``in_use``).  A lane that is not
        live may read a half-written slot, and its tokens are
        discarded."""
        if not _ADAPTER_NAME_RE.match(name or ""):
            raise ValueError(
                f"adapter name {name!r} must match [A-Za-z0-9_.-]{{1,64}}"
                " (it becomes a Prometheus label value and routing key)")
        if deltas is None:
            deltas = make_random_adapter(
                self.cfg, self.rank, seed if seed is not None
                else stable_name_seed(name))
        with self._lock:
            idx = self._by_name.get(name)
            if idx is not None and idx in in_use:
                # replacing a live adapter would mix old-delta KV with
                # new-delta decode math mid-stream for its lanes
                raise AdapterInUse(
                    f"adapter {name!r} is serving resident lanes; drain "
                    "them before replacing it")
            if idx is None:
                used = set(self._by_idx)
                idx = next((i for i in range(1, self.capacity + 1)
                            if i not in used), None)
                if idx is None:
                    raise ValueError(
                        f"adapter pool full ({self.capacity}); evict one "
                        "before loading another")
            staged = {}
            for proj in LORA_PROJS:
                a = torch.as_tensor(np.asarray(deltas[proj]["a"],
                                               np.float32))
                b = torch.as_tensor(np.asarray(deltas[proj]["b"],
                                               np.float32))
                want_a = tuple(self._dev[proj]["a"].shape[2:])
                want_b = tuple(self._dev[proj]["b"].shape[2:])
                if a.ndim != 3 or b.ndim != 3:
                    raise ValueError(
                        f"adapter {name!r} {proj} shapes "
                        f"{tuple(a.shape)}/{tuple(b.shape)} do not fit "
                        f"[L, *{want_a}]/[L, *{want_b}]")
                if a.shape[2] != self.rank:
                    raise ValueError(
                        f"adapter {name!r} rank {a.shape[2]} != registry "
                        f"rank {self.rank}")
                if (a.shape[0], tuple(a.shape[1:])) != (self.cfg.n_layers,
                                                        want_a) \
                        or (b.shape[0], tuple(b.shape[1:])) != (
                            self.cfg.n_layers, want_b):
                    raise ValueError(
                        f"adapter {name!r} {proj} shapes "
                        f"{tuple(a.shape)}/{tuple(b.shape)} do not fit "
                        f"[L, *{want_a}]/[L, *{want_b}]")
                staged[proj] = (a, b)
            # under the lock: a submit resolves the name only once the
            # slot is written and its new namespace minted
            self._write_slot(idx, staged)
            self._by_name[name] = idx
            self._by_idx[idx] = name
            self._gen += 1
            self._ns[idx] = self._gen
            return idx

    def evict(self, name: str, in_use=frozenset()) -> None:
        """Remove adapter ``name``: its slot zeroes (in place) and
        becomes loadable.  ``in_use``: adapter slots with resident,
        parked or queued lanes — evicting one of those would serve a
        live request garbage deltas, so it raises
        :class:`AdapterInUse`."""
        with self._lock:
            idx = self._by_name.get(name)
            if idx is None:
                raise ValueError(f"unknown adapter {name!r}")
            if idx in in_use:
                raise AdapterInUse(
                    f"adapter {name!r} is serving resident lanes; drain "
                    "them before evicting")
            del self._by_name[name]
            self._ns.pop(idx, None)
            self._write_slot(idx, None)
            del self._by_idx[idx]

    @classmethod
    def from_env(cls, cfg, environ=None,
                 device="cuda") -> Optional["AdapterRegistry"]:
        """From ``SERVE_ADAPTERS`` (a comma list of ``name``,
        ``name:path.npz`` or ``name:seed:<int>`` entries;
        ``SERVE_ADAPTER_RANK`` / ``SERVE_MAX_ADAPTERS`` size the pool,
        default 8 and 8).  Unset or empty: None, and the ring stays the
        adapterless one."""
        environ = os.environ if environ is None else environ
        raw = environ.get("SERVE_ADAPTERS", "").strip()
        if not raw:
            return None
        rank = int(environ.get("SERVE_ADAPTER_RANK", "8"))
        cap = int(environ.get("SERVE_MAX_ADAPTERS", "8"))
        reg = cls(cfg, capacity=cap, rank=rank, device=device)
        for entry in raw.split(","):
            entry = entry.strip()
            if not entry:
                continue
            name, _, src = entry.partition(":")
            if not src:
                reg.load(name)
            elif src.startswith("seed:"):
                reg.load(name, seed=int(src[len("seed:"):]))
            else:
                reg.load(name, load_adapter_file(cfg, src, rank))
        return reg


def lora_qkv(h: torch.Tensor, adp_l, aid: torch.Tensor, q: torch.Tensor,
             k: torch.Tensor, v: torch.Tensor, dtype, cols=None):
    """THE adapter-delta rule, applied at every q/k/v projection site
    (decode._qkv, executor._qkv_ring, speculative._proj_qkv, and through
    them every admission insert, prefill slice and resident tick), so
    prefill KV and decode KV are never computed under different adapter
    math.

    ``h`` [B, T, dim] is the post-norm activation the base projections
    consumed, ``q``/``k``/``v`` [B, T, out] their outputs (before the
    head reshape and RoPE); ``adp_l`` is ONE layer's stacks
    (``{proj: {"a": [cap+1, dim, r], "b": [cap+1, r, out]}}``) and
    ``aid`` [B] int32 each lane's adapter slot: each lane's (A, B) is
    gathered, ``(h·A)·B`` computed in f32 and cast to ``dtype`` at the
    add.  Slot 0 is all zero, so an aid-0 lane adds an exact zero and
    its stream is the adapterless ring's, bit for bit.

    ``cols`` (a rank of a tensor-parallel serving mesh: ``{proj:
    slice}``, the rank's columns of wq, wk and wv): the stacks stay whole
    on every rank, and each rank's delta fills its own columns — the
    whole delta's, so they equal one card's bit for bit."""
    hf = h.float()
    idx = aid.long()
    out = []
    for proj, base in zip(LORA_PROJS, (q, k, v)):
        a = adp_l[proj]["a"].index_select(0, idx)       # [B, dim, r]
        b = adp_l[proj]["b"].index_select(0, idx)       # [B, r, out]
        delta = torch.bmm(torch.bmm(hf, a), b)
        if cols is not None:
            delta = delta[..., cols[proj]]
        out.append(base + delta.to(dtype))
    return tuple(out)


def layer_lora(lora, li: int):
    """``lora`` = ``(stacks, aid)`` (the registry's :meth:`AdapterRegistry.
    arrays` and per-lane ids) -> layer ``li``'s ``(adp_l, aid)`` for
    :func:`lora_qkv` (views, no copy); None stays None."""
    if lora is None:
        return None
    stacks, aid = lora
    return ({proj: {"a": ab["a"][li], "b": ab["b"][li]}
             for proj, ab in stacks.items()}, aid)
