"""Host half of the serving ring: the continuous-batching scheduler —
the port of ``paddle_operator_tpu/infer/scheduler.py``
``ContinuousBatcher``, with inline and chunked prefill.

:class:`ContinuousBatcher` keeps the JAX class's name, constructor
surface and behavior for the configuration the port carries:
submit-time validation and a bounded per-class queue, admission in
class-then-FIFO order into free lanes (paged: radix prefix hits admit
through the suffix-only insert, with copy-on-write), a depth-2
dispatch/consume pipeline over :class:`~paddle_operator_tpu_torch.
infer.executor.RingExecutor`, eviction on eos/budget/cancel/deadline,
drain/abort/close, the dispatch watchdog with self-healing rebuilds
(``RingExecutor.reset_state``), and preemptive lane spill on the paged
ring: when every lane is busy and strictly more urgent work waits, the
least urgent lane spills to host (``RingExecutor.spill_lane``), parks,
and later resumes bit-identically in any free lane
(``RingExecutor.restore_lane``), within the budgets of
:class:`~paddle_operator_tpu_torch.infer.qos.QoSConfig`.
``serving_status()`` returns the JAX ring's key set.

``prefill_mode="inline"`` (the default) prefills an admission's whole
prompt in one insert.  ``prefill_mode="chunked"`` (SERVE_PREFILL)
prefills it in ``prefill_chunk``-token slices (SERVE_PREFILL_CHUNK),
exactly one per ring iteration, oldest admission first, between the
decode dispatches: an intermediate slice appends KV only, the final one
samples the first token and activates the lane.  A lane mid-prefill is
left out of every dispatch — not active, its table rows pointed at the
trash block — and is never a preemption victim, so resident lanes wait
at most one slice for a long prompt.

The ring runs on its own thread, under ``torch.inference_mode`` (which
is thread-local, so the thread enters it itself).  Device work is
queued on the current stream and never read back inside a dispatch:
the one sync per dispatch is the consume's wait for its tokens
(``DispatchResult.host``).  ``megastep=N`` (SERVE_MEGASTEP) fuses N
chunks into one dispatch, with eos, token budget and the deadline-tick
step budget carried on the device; admissions, evictions and deadlines
then act at megastep boundaries.  On the card every dispatch is a CUDA
graph replay; the graphs are captured at prewarm (or, without it,
before the first admission) and again after a self-healing rebuild,
always while the ring is empty.

The paged ring runs over the bf16 pool or the int8 pool
(``kv_quant="int8"``), optionally with the host spill tier
(``host_cache_blocks``: evicted prefix blocks demote to host memory and
promote back on a hit, the batched promote queued at the head of each
admission) and, below it, the durable prefix store
(:meth:`ContinuousBatcher.attach_kv_store`: tier overflow persists, and
the submit thread probes the store for a prompt's missing chain, whose
payloads the ring imports into the tier before admission).

``spec_k`` > 0 with ``draft_params``/``draft_cfg`` (SERVE_SPEC_K) makes
every dispatch a speculative round (or N of them, fused) on any of the
three rings: a dispatch commits 1..K+1 tokens a lane, which the consume
walks as it walks a chunk, and each request counts its drafts offered
and accepted (``accept_rate``, ``/statusz`` ``acceptRate``).

``adapters`` (an infer/qos.py ``AdapterRegistry``) serves many LoRA
adapters off the one base model: ``submit(adapter=name)`` resolves the
adapter's slot and radix namespace, the admission re-validates that
namespace (an adapter evicted or replaced while its request queued is
refused) and writes the lane's slot into the executor's per-lane buffer,
and lanes of different adapters decode in the same dispatch.  A prefix
cached under one adapter load is never hit by another, nor by the base
model.  Not ported yet, and refused when asked for (ROADMAP.md Queue A):
disaggregated prefill, span tracing, the NaN-lane check, live weight
swap and fleet-level KV.
"""

from __future__ import annotations

import os
import queue
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from paddle_operator_tpu_torch.infer import executor as X
from paddle_operator_tpu_torch.infer import qos as QOS
from paddle_operator_tpu_torch.infer import quant as Q
from paddle_operator_tpu_torch.infer.resilience import (
    DispatchWatchdog,
    RestartBudget,
    RetriableError,
    RingResilience,
    ShuttingDown,
)
from paddle_operator_tpu_torch.models.llama import LlamaConfig
from paddle_operator_tpu_torch.utils import tracing as TR

PREFILL_MODES = ("inline", "chunked", "disagg")


def _fold_seed(seed: int) -> int:
    """Fold an out-of-int32-range seed to [0, 2**31) via the splitmix64
    finalizer — distinct wide seeds stay distinct with overwhelming
    probability."""
    x = seed & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & 0xFFFFFFFFFFFFFFFF
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & 0xFFFFFFFFFFFFFFFF
    x ^= x >> 31
    return x & 0x7FFFFFFF


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the torch package yet (ROADMAP.md "
        "Queue A)")


class QueueFull(RuntimeError):
    """submit() backpressure signal: the bounded request queue stayed
    full past the put timeout (serve.py maps it to 503)."""


class _Request:
    __slots__ = ("prompt", "max_new", "temperature", "seed", "eos",
                 "done", "out", "error", "_stream", "_cancel",
                 "dev_prompt", "bucket", "deadline", "deadline_exceeded",
                 "priority", "request_id", "t_submit", "t_first",
                 "t_last_tok", "preempts", "accepted", "drafted",
                 "adapter", "adapter_idx", "ns")

    def __init__(self, prompt, max_new, temperature, seed, eos,
                 wants_stream=False, deadline=None):
        self.prompt = prompt
        self.max_new = max_new
        self.temperature = temperature
        self.seed = seed
        self.eos = eos
        self.done = threading.Event()
        self.out: Optional[List[int]] = None
        self.error: Optional[Exception] = None
        self._cancel = False
        # absolute time.monotonic() deadline (or None): the ring retires
        # the lane when it passes — the request RESOLVES with the tokens
        # produced so far and this flag set (the 504-style partial)
        self.deadline: Optional[float] = deadline
        self.deadline_exceeded = False
        self.priority = 0
        # the request's adapter: its name, registry slot and radix
        # namespace (0 and 0 for the base model)
        self.adapter: Optional[str] = None
        self.adapter_idx = 0
        self.ns = 0
        # times this request's lane was spilled for more urgent work
        # (the per-request anti-thrash cap)
        self.preempts = 0
        self.request_id: Optional[str] = None
        self.t_submit = time.monotonic()
        self.t_first: Optional[float] = None
        self.t_last_tok: Optional[float] = None
        # the prompt, shipped to the device on the SUBMIT thread, so the
        # ring thread never pays the host->device copy
        self.dev_prompt: Optional[torch.Tensor] = None
        self.bucket: int = 0
        # speculative telemetry (spec_k > 0 rings): drafts offered and
        # accepted for THIS request — serve.py returns the rate
        self.accepted = 0
        self.drafted = 0
        self._stream: Optional["queue.Queue"] = (
            queue.Queue() if wants_stream else None)

    @property
    def accept_rate(self) -> Optional[float]:
        """Accepted drafts / offered drafts for this request, or None
        when the ring is not speculative (or no round has consumed
        yet)."""
        if not self.drafted:
            return None
        return round(self.accepted / self.drafted, 4)

    def result(self, timeout: Optional[float] = None) -> List[int]:
        if not self.done.wait(timeout):
            raise TimeoutError("generation did not finish in time")
        if self.error is not None:
            raise self.error
        return self.out

    def cancel(self) -> None:
        """Stop decoding this request: the ring evicts its lane at the
        next chunk boundary (or drops it from the queue if not yet
        admitted) and ``result()`` returns the tokens produced so far."""
        self._cancel = True

    def stream(self, timeout: Optional[float] = None):
        """Yield generated tokens as the ring emits them (chunk-sized
        bursts).  Raises the request's error at the point of failure;
        ``timeout`` bounds the wait for EACH burst."""
        if self._stream is None:
            raise RuntimeError("request was not submitted with "
                               "stream=True")
        while True:
            try:
                item = self._stream.get(timeout=timeout)
            except queue.Empty:
                raise TimeoutError("no tokens within timeout") from None
            if item is None:
                if self.error is not None:
                    raise self.error
                return
            yield item


class _PrefillState:
    """Host bookkeeping for one mid-flight CHUNKED prefill: the slice
    frontier plus (contiguous only) the staging K/V the slices append
    into."""

    __slots__ = ("req", "start", "seq", "lane_k", "lane_v")

    def __init__(self, req, start, seq, lane_k=None, lane_v=None):
        self.req = req
        self.start = start          # next absolute row (a radix hit's end)
        self.seq = seq              # admission order — oldest advances
        self.lane_k = lane_k
        self.lane_v = lane_v


class _ParkedLane:
    """Host bookkeeping for one PREEMPTED lane: the byte-exact spill
    (``RingExecutor.spill_lane``) plus the host mirrors a restore
    re-attaches — the request itself stays unresolved, invisible to the
    client except as latency."""

    __slots__ = ("req", "spill", "out", "left", "pos", "seq")

    def __init__(self, req, spill, out, left, pos, seq):
        self.req = req
        self.spill = spill
        self.out = out          # tokens emitted before the spill
        self.left = left        # remaining token budget
        self.pos = pos          # fill position at the spill boundary
        self.seq = seq          # park order — FIFO within a class


class ContinuousBatcher:
    """Slot scheduler over the resident chunk step.

    ``submit()`` is thread-safe and returns a handle whose ``result()``
    blocks until the sequence finishes; the decode loop runs on a
    background thread, admitting queued requests into free lanes at
    chunk boundaries and evicting lanes on eos / budget.  ``stats``
    counts admissions, evictions, decoded chunks, prefill calls and
    tokens, CoW copies and the high-water mark of active lanes.

    ``paged=True`` swaps the per-lane contiguous KV region for the
    block pool + radix prefix cache (infer/paged.py); greedy token
    streams equal the contiguous ring's (``paged=False``, the parity
    oracle).  ``kv_quant="int8"`` (paged only) stores the pool as int8
    codes + per-block scales.  Arguments for features not ported yet
    raise NotImplementedError when set to anything but their default."""

    SUFFIX_PREFILL_MAX_ROWS = X.RingExecutor.SUFFIX_PREFILL_MAX_ROWS

    def __init__(self, params: Any, cfg: LlamaConfig, *, slots: int = 8,
                 max_len: Optional[int] = None, chunk_tokens: int = 8,
                 prefill_buckets=(), top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 pipeline_depth: int = 2, mesh=None,
                 draft_params: Any = None,
                 draft_cfg: Optional[LlamaConfig] = None,
                 spec_k: int = 0,
                 max_queue: int = 0,
                 queue_timeout: float = 5.0,
                 paged: bool = False,
                 block_size: int = 256,
                 num_blocks: Optional[int] = None,
                 prefix_cache: bool = True,
                 prefill_mode: str = "inline",
                 prefill_chunk: int = 64,
                 prewarm: bool = False,
                 kv_quant: str = "none",
                 host_cache_blocks: int = 0,
                 resilience: Optional[RingResilience] = None,
                 qos: Optional[QOS.QoSConfig] = None,
                 adapters=None,
                 megastep: int = 1,
                 trace: Optional[bool] = None,
                 generation: int = 0) -> None:
        if prefill_mode not in PREFILL_MODES:
            raise ValueError(f"prefill_mode {prefill_mode!r} not in "
                             f"{PREFILL_MODES}")
        for bad, what in (
                (mesh is not None, "tensor-parallel serving (mesh)"),
                (prefill_mode == "disagg",
                 f"prefill_mode={prefill_mode!r}"),
                (bool(trace), "span tracing (trace=True)"),
                (resilience is not None and resilience.nan_check,
                 "the NaN-lane check (nan_check)")):
            if bad:
                raise _unported(what)
        # SERVE_MEGASTEP: fuse N ring iterations into ONE dispatch, with
        # eos / token budget / deadline-tick step budget carried on the
        # device; admission and eviction happen at megastep boundaries.
        # N=1 (default) dispatches the chunk step alone.
        self.megastep = int(megastep)
        if self.megastep < 1:
            raise ValueError(f"megastep must be >= 1 (got {megastep})")
        # rolling per-iteration wall estimate (EMA over consumed
        # dispatches): the deadline-tick budget converts a request's
        # remaining seconds into fused iterations with it (0: none yet)
        self._step_s_est = 0.0
        self.cfg = cfg
        self.slots = slots
        self.max_len = max_len or cfg.max_seq_len
        self.chunk = chunk_tokens
        self.prefill_mode = prefill_mode
        self.resilience = resilience
        self._budget = (RestartBudget(resilience)
                        if resilience is not None else None)
        self.healthy = True
        self._draining = False
        self._rebuilding = False
        # ring-level fault observed (by the loop thread or the watchdog
        # monitor) and not yet healed; the loop rebuilds at the next top
        self._fault: Optional[Exception] = None
        self._watchdog: Optional[DispatchWatchdog] = None
        if resilience is not None and resilience.watchdog:
            self._watchdog = DispatchWatchdog(
                resilience, self._on_stall, self._on_hard_stall)
        # max dispatched-but-unconsumed chunks (2: one chunk decoding
        # while the host consumes the previous one)
        self.pipeline_depth = max(1, pipeline_depth)
        self.qos = qos if qos is not None else QOS.QoSConfig()
        # the LoRA adapter registry (None: base model only)
        self.adapters = adapters

        pod = os.environ.get("TPUJOB_REPLICA_ID", "")
        self.tracer = None
        self.hist = TR.ServeHistograms()
        self.flightrec = TR.FlightRecorder(pod=pod)

        self.executor = X.RingExecutor(
            params, cfg, slots=slots, max_len=self.max_len,
            chunk_tokens=chunk_tokens, prefill_buckets=prefill_buckets,
            top_k=top_k, top_p=top_p, paged=paged, block_size=block_size,
            num_blocks=num_blocks, prefix_cache=prefix_cache,
            kv_quant=kv_quant, megastep=self.megastep,
            host_cache_blocks=host_cache_blocks,
            prefill_chunk=prefill_chunk, draft_params=draft_params,
            draft_cfg=draft_cfg, spec_k=spec_k, adapters=adapters)
        self.device = self.executor.device
        self.spec_k = self.executor.spec_k
        self.draft_cfg = self.executor.draft_cfg
        self.generation = int(generation)
        self.paged = self.executor.paged
        self._top_k, self._top_p = top_k, top_p

        self.lane: List[Optional[_Request]] = [None] * slots
        self._lane_out: List[List[int]] = [[] for _ in range(slots)]
        self._lane_left = [0] * slots
        # host mirror of each lane's device fill position — set by
        # admission, advanced at consume, ZEROED on eviction (paged: the
        # on-demand block mapping tracks the true frontier with it)
        self._lane_pos = [0] * slots
        # per-lane (pinned host tensor, event) of the admission-sampled
        # first token, materialized at the next chunk consume
        self._lane_first: List[Optional[tuple]] = [None] * slots
        # chunked prefill in flight: lanes reserved but not yet
        # decode-active (slot -> _PrefillState), and the admission
        # counter that orders their slices
        self._prefilling: Dict[int, _PrefillState] = {}
        self._admit_seq = 0

        # bounded admission queue, bounded PER CLASS (infer/qos.py)
        self.max_queue = int(max_queue)
        self._queue_timeout = queue_timeout
        self._pending = QOS.MultiClassQueue(
            self.qos.priorities, maxsize=self.max_queue)
        # preemption-spilled lanes awaiting re-admission, and the rolling
        # anti-thrash budget bounding how often residents may spill
        self._parked: List[_ParkedLane] = []
        self._preempt_budget = QOS.PreemptionBudget(
            self.qos.preempt_budget, self.qos.preempt_window_s)
        self._park_seq = 0
        # durable prefix store (attach_kv_store): None = no store
        self.kv_store = None
        # store payloads fetched on a submit thread, awaiting import into
        # the tier by the ring loop (the only consumer)
        self._host_imports: "queue.Queue[tuple]" = queue.Queue()
        # chains already asked of the fleet — the peer leg's dedupe
        # (fleet-level KV, ROADMAP.md Queue A); the store probe
        # stays outside it
        self._peer_fetch_seen: "OrderedDict[Any, bool]" = OrderedDict()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self.stats = {"admitted": 0, "evicted": 0, "chunks": 0,
                      "max_active": 0, "rejected_queue_full": 0,
                      # chunked_prefill_tokens: the share of prefill
                      # tokens that arrived in interleaved slices
                      "prefill_calls": 0, "prefill_tokens": 0,
                      "chunked_prefill_tokens": 0,
                      "cow_copies": 0, "deadline_exceeded": 0,
                      # speculative rounds: drafts offered and accepted
                      "spec_accepted": 0, "spec_drafted": 0,
                      "watchdog_restarts": 0,
                      # lanes spilled for more urgent work, and spilled
                      # lanes resumed (tpujob_serve_lane_preemptions_total)
                      "preempted_lanes": 0, "restored_lanes": 0,
                      # durable store: submit-thread probes and the ones
                      # that returned blocks
                      "kv_store_probes": 0, "kv_store_hits": 0,
                      # blocks uploaded back from the host tier —
                      # cumulative across rebuilds (the pool's own stats
                      # reset with the allocator)
                      "promoted_blocks": 0}
        self._tokens_emitted = 0
        self._t_start = time.monotonic()
        # prewarm (serve.py default, SERVE_PREWARM=0 opts out): build
        # the kernel library and capture the ring's CUDA graphs
        # off-thread; the ring admits nothing before it is done
        self.prewarmed = threading.Event()
        self.prewarm_error: Optional[Exception] = None
        if prewarm:
            threading.Thread(target=self._prewarm, daemon=True,
                             name="kernel-prewarm").start()
        else:
            self.prewarmed.set()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="decode-ring")
        self._thread.start()

    # -- executor state forwarding (the JAX class's attribute surface) -----

    @property
    def params(self):
        return self.executor.params

    @property
    def draft_params(self):
        return self.executor.draft_params

    @property
    def buckets(self):
        return self.executor.buckets

    @property
    def block_size(self):
        return self.executor.block_size

    @property
    def cache(self):
        return self.executor.cache

    @property
    def pool(self):
        return self.executor.pool

    @property
    def kv_quant(self):
        return self.executor.kv_quant

    @property
    def _step(self):
        return self.executor.step

    @_step.setter
    def _step(self, fn):
        self.executor.step = fn

    def _prewarm(self) -> None:
        try:
            self.executor.prewarm()
        except Exception as e:
            # a prewarm failure must never take the server down here:
            # the ring captures (and raises, as a ring fault) itself
            # before its first admission
            self.prewarm_error = e
        finally:
            self.prewarmed.set()

    # -- public ------------------------------------------------------------

    def submit(self, prompt, *, max_new_tokens: int,
               temperature: float = 0.0, seed: int = 0,
               eos_token: Optional[int] = None,
               stream: bool = False,
               request_id: Optional[str] = None,
               deadline_s: Optional[float] = None,
               priority: Optional[int] = None,
               adapter: Optional[str] = None) -> _Request:
        """Queue one generation request; returns a handle whose
        ``result()``/``stream()`` deliver the tokens.

        ``deadline_s``: relative budget in seconds for the WHOLE
        generation; past it the lane retires at the next chunk boundary
        and the request resolves with the tokens so far and
        ``deadline_exceeded`` set (queued expiry: prompt only).
        ``request_id`` is woven into every validation error; validation
        runs BEFORE the tokenize copy and device transfer.  ``seed``:
        [0, 2**31) is used as-is, anything else is hash-folded."""
        rid = f" [request {request_id}]" if request_id is not None else ""
        n = len(prompt)
        if not n:
            raise ValueError(f"empty prompt{rid}")
        if max_new_tokens < 1:
            raise ValueError(f"max_new_tokens must be >= 1{rid}")
        if deadline_s is not None and deadline_s <= 0:
            raise ValueError(f"deadline_s must be > 0{rid}")
        prio = (self.qos.default_priority if priority is None
                else int(priority))
        if not 0 <= prio < self.qos.priorities:
            raise ValueError(
                f"priority {prio} outside [0, {self.qos.priorities}) — "
                f"this ring serves {self.qos.priorities} class(es){rid}")
        adapter_idx = adapter_ns = 0
        if adapter is not None:
            if self.spec_k:
                raise ValueError(
                    f"adapters are not supported on speculative rings "
                    f"(the draft proposes base-only){rid}")
            if self.adapters is None:
                raise ValueError(
                    f"no adapter registry on this ring (SERVE_ADAPTERS "
                    f"unset) for adapter {adapter!r}{rid}")
            adapter_idx, adapter_ns = \
                self.adapters.resolve_ns(adapter)      # ValueError
        if self._draining:
            raise ShuttingDown("server draining; retry another replica")
        if self._stop.is_set() or not self._thread.is_alive():
            raise ShuttingDown("batcher closed")
        if n > self.buckets[-1]:
            raise ValueError(
                f"prompt length {n} exceeds the largest prefill "
                f"bucket ({self.buckets[-1]}){rid}")
        if self.spec_k:
            # a verify round starting at the last in-budget position
            # (prompt + max_new - 2) writes rows through pos + spec_k,
            # so spec_k - 1 positions of headroom must exist past
            # prompt + max_new
            if n + max_new_tokens + self.spec_k - 1 > self.max_len:
                raise ValueError(
                    f"prompt ({n}) + max_new_tokens "
                    f"({max_new_tokens}) + speculative headroom "
                    f"({self.spec_k - 1}) exceeds max_len "
                    f"({self.max_len}){rid}")
        else:
            # the FIRST token is sampled from the prefill logits, so
            # only max_new-1 tokens ride chunk steps; the worst-case
            # cache position is prompt + ceil((max_new-1)/chunk)*chunk
            budget = -(-(max_new_tokens - 1) // self.chunk) * self.chunk
            if n + budget > self.max_len:
                raise ValueError(
                    f"prompt ({n}) + chunk-rounded budget "
                    f"({budget}) exceeds max_len ({self.max_len}){rid}")
        # validation passed: NOW pay the tokenize copy
        prompt = list(map(int, prompt))
        if min(prompt) < 0 or max(prompt) >= self.cfg.vocab_size:
            # an out-of-range id would be a device-side assert on the
            # card (the JAX gather clamps instead)
            raise ValueError(f"token ids must lie in [0, "
                             f"{self.cfg.vocab_size}){rid}")
        seed = int(seed)
        if not 0 <= seed < 0x80000000:
            seed = _fold_seed(seed)
        if self.max_queue and self._pending.full(prio):
            # shed BEFORE the host->device prompt transfer below
            deadline = time.monotonic() + self._queue_timeout
            while self._pending.full(prio):
                if self._stop.is_set() or self._draining:
                    raise ShuttingDown("batcher shutting down")
                if time.monotonic() >= deadline:
                    self.stats["rejected_queue_full"] += 1
                    raise QueueFull(
                        f"request queue full (max_queue={self.max_queue},"
                        f" priority {prio},"
                        f" waited {self._queue_timeout}s)")
                time.sleep(0.005)
        req = _Request(prompt, max_new_tokens, temperature, seed,
                       eos_token, wants_stream=stream,
                       deadline=(time.monotonic() + deadline_s
                                 if deadline_s is not None else None))
        req.priority = prio
        req.adapter = adapter
        req.adapter_idx = adapter_idx
        req.ns = adapter_ns if adapter_idx else 0
        req.request_id = request_id
        # a cold prefix may be warm in the durable store: fetch its
        # blocks now, on the caller's thread, so this request's
        # admission host-hits them.  Base namespace only: an adapter's
        # namespace is minted per load, so its chains never match a
        # stored one
        if (self.kv_store is not None and req.ns == 0
                and self.pool is not None and self.pool.host is not None):
            try:
                self._maybe_store_fetch(prompt)
            except Exception:
                pass    # a fetch is an optimization, never a failure
        req.bucket = self._bucket_for(len(prompt))
        req.dev_prompt = X.to_device(np.asarray([prompt], np.int32),
                                     self.device)
        deadline = time.monotonic() + self._queue_timeout
        while True:
            if self._stop.is_set() or self._draining:
                raise ShuttingDown("batcher shutting down")
            try:
                self._pending.put(req, prio, timeout=0.05)
                break
            except queue.Full:
                if time.monotonic() >= deadline:
                    self.stats["rejected_queue_full"] += 1
                    raise QueueFull(
                        f"request queue full (max_queue={self.max_queue},"
                        f" priority {prio},"
                        f" waited {self._queue_timeout}s)") from None
        if self._stop.is_set() and not req.done.is_set():
            # loop died between the liveness check above and the put
            self._finish(req, ShuttingDown("batcher closed"))
            return req
        self._wake.set()
        return req

    def _kv_store_usage(self) -> Tuple[int, int]:
        """``(blocks, bytes)`` resident in the durable store — (0, 0)
        with the store off or on a listing error (telemetry never fails
        a scrape)."""
        if self.kv_store is None:
            return 0, 0
        try:
            return self.kv_store.usage()
        except OSError:
            return 0, 0

    def draft_quant_mode(self) -> str:
        """Weight-quant mode of the DRAFT params ("none" on
        non-speculative rings) — SERVE_DRAFT_QUANT's visibility."""
        dp = self.executor.draft_params
        return Q.weight_quant_mode(dp) if dp is not None else "none"

    def prefill_queue_depth(self) -> int:
        """Requests admitted to a lane but still PREFILLING (chunked
        slices mid-flight) — the ``tpujob_serve_prefill_queue_depth``
        gauge."""
        return len(self._prefilling)

    def serving_status(self) -> Dict[str, Any]:
        """The ``TPUJob.status.serving`` block, with the JAX ring's key
        set: features this ring does not carry report their zero
        (what ``utils/observability.py serving_gauges`` renders)."""
        elapsed = max(1e-9, time.monotonic() - self._t_start)
        pool = self.pool
        kv_store_blocks, kv_store_bytes = self._kv_store_usage()
        store = self.kv_store
        pf_tok = self.stats["prefill_tokens"]
        drafted = self.stats["spec_drafted"]
        return {
            "tokensPerSec": round(self._tokens_emitted / elapsed, 2),
            "acceptRate": (round(self.stats["spec_accepted"] / drafted, 4)
                           if drafted else 0.0),
            "queueDepth": self._pending.qsize(),
            "tokensTotal": self._tokens_emitted,
            "activeLanes": sum(r is not None for r in self.lane),
            "lanePos": [int(p) for p in self._lane_pos],
            "prefixHitRate": pool.hit_rate() if pool is not None else 0.0,
            "kvBlocksFree": pool.blocks_free() if pool is not None else 0,
            "kvBlocksHwm": (pool.stats["blocks_hwm"]
                            if pool is not None else 0),
            "hostCacheBlocks": (pool.host_blocks()
                                if pool is not None else 0),
            "hostHitRate": (pool.host_hit_rate()
                            if pool is not None else 0.0),
            "promotedBlocks": self.stats["promoted_blocks"],
            "prefillMode": self.prefill_mode,
            "prefillQueueDepth": self.prefill_queue_depth(),
            "prefillLanes": 0,
            "prefillBatchOccupancy": 0.0,
            "prefillHolWaitMs": 0.0,
            "handoffFrames": 0,
            "overlappedFrames": 0,
            "kvQuantMode": self.kv_quant,
            "kvPoolBytes": self.executor.pool_bytes(),
            "weightQuantMode": Q.weight_quant_mode(self.executor.params),
            "draftQuantMode": self.draft_quant_mode(),
            "paramBytes": self.executor.param_bytes(),
            "chunkedPrefillTokenShare": (
                round(self.stats["chunked_prefill_tokens"] / pf_tok, 4)
                if pf_tok else 0.0),
            "priorityQueueDepth": self._pending.qsize_by_class(),
            "preemptedLanes": self.stats["preempted_lanes"],
            "parkedLanes": len(self._parked),
            "laneMigrations": 0,
            "adoptedLanes": 0,
            "peerPrefixFetches": 0,
            "remotePrefills": 0,
            "hostCacheEvictions": (pool.host_evictions()
                                   if pool is not None else 0),
            "kvStoreBlocks": kv_store_blocks,
            "kvStoreBytes": kv_store_bytes,
            "kvStoreHitRate": store.hit_rate() if store is not None else 0.0,
            "kvStoreEvictions": (store.evictions()
                                 if store is not None else 0),
            "activeAdapters": (len(self.adapters)
                               if self.adapters is not None else 0),
            "adapterNames": (self.adapters.names()
                             if self.adapters is not None else []),
            "megastepN": self.megastep,
            "dispatchesPerToken": (
                round(self.stats["chunks"] / self._tokens_emitted, 4)
                if self._tokens_emitted else 0.0),
            "latencyHist": self.hist.snapshot(),
            "ttftP95Ms": round(self.hist.ttft.p95() or 0.0, 3),
            "draining": self._draining,
            "healthy": self.healthy,
            "deadlineExceeded": self.stats["deadline_exceeded"],
            "watchdogRestarts": self.stats["watchdog_restarts"],
            "quarantinedLanes": 0,
            "weightGeneration": int(self.generation),
            "servingTp": 1,
            "weightSwaps": 0,
            # the round's draft depth, on speculative rings only (the
            # JAX status has no such key; its fingerprint does)
            **({"specK": self.spec_k} if self.spec_k else {}),
        }

    @property
    def accepting(self) -> bool:
        """Readiness (/readyz): the ring takes new admissions — not
        draining, not mid-rebuild, loop alive, budget unspent."""
        return (self.healthy and not self._draining
                and not self._rebuilding and not self._stop.is_set()
                and self._thread.is_alive())

    def drain(self, budget_s: float = 30.0) -> None:
        """SIGTERM drain: stop admissions (queued and new requests fail
        with :class:`ShuttingDown`), let the RESIDENT lanes — and the
        PARKED ones, which resume as lanes free — finish within
        ``budget_s``, cancel stragglers at the budget (their callers
        receive the tokens produced so far; paged blocks return to the
        pool), then close."""
        self.flightrec.record(
            "drain_start", residents=sum(r is not None for r in self.lane),
            parked=len(self._parked), queued=self._pending.qsize())
        self._draining = True
        self._wake.set()
        deadline = time.monotonic() + budget_s
        while time.monotonic() < deadline and self._thread.is_alive():
            if all(r is None for r in self.lane) \
                    and self._pending.empty() and not self._parked:
                break
            time.sleep(0.02)
        for req in list(self.lane):
            if req is not None:
                req.cancel()            # partial flush at chunk boundary
        for pk in list(self._parked):
            pk.req.cancel()             # parked partials flush too
        grace = time.monotonic() + max(5.0, budget_s)
        while ((any(r is not None for r in self.lane) or self._parked)
               and self._thread.is_alive()
               and time.monotonic() < grace):
            time.sleep(0.02)
        self.flightrec.record(
            "drain_done", stragglers=sum(r is not None for r in self.lane))
        self.close()

    def abort(self, error: Optional[Exception] = None) -> None:
        """Second-SIGTERM semantics: immediate teardown.  Resident and
        parked requests RESOLVE with their partial tokens; queued ones
        fail with ShuttingDown."""
        self.flightrec.record("abort", error=(str(error)[:200] if error
                                              else None))
        self._draining = True
        self._stop.set()
        self._wake.set()
        for i, req in enumerate(self.lane):
            if req is not None and not req.done.is_set():
                req.out = req.prompt + self._lane_out[i]
                self._finish(req)
        for pk in list(self._parked):       # parked partials resolve too
            if not pk.req.done.is_set():
                pk.req.out = pk.req.prompt + pk.out
                self._finish(pk.req)
        self._parked.clear()
        self._shed_queue(error or ShuttingDown("server killed"))

    def close(self) -> None:
        self._stop.set()
        self._wake.set()
        self._thread.join(timeout=30)
        if self._watchdog is not None:
            self._watchdog.close()
        if not self._thread.is_alive():
            # the ring thread is gone: its host tier's memory goes back
            self.executor.close_host_tier()
        # late blocked submitters can land requests after the loop's own
        # drain pass — sweep again so none hangs at result()
        self._shed_queue(ShuttingDown("batcher closed"))

    # -- fault handling ----------------------------------------------------

    def _shed_queue(self, error: Exception) -> None:
        while True:
            try:
                req = self._pending.get_nowait()
            except queue.Empty:
                return
            self._finish(req, error)

    def _on_stall(self, elapsed: float) -> None:
        """Watchdog monitor callback: a dispatch/consume wait crossed
        the stall threshold.  Fail the resident requests NOW — their
        clients get retriable 503s while the ring thread is still
        stuck — and flag the rebuild the loop runs once it unwedges."""
        err = RetriableError(
            f"ring dispatch stalled {elapsed:.1f}s (watchdog threshold "
            f"{self._watchdog.threshold():.1f}s); ring rebuilding — retry")
        for req in list(self.lane):
            if req is not None and not req.done.is_set():
                self._finish(req, err)
        self._fault = err

    def _on_hard_stall(self, elapsed: float) -> None:
        """The stall outlived hard_stall_factor x threshold: flip
        /healthz so the orchestrator replaces the pod."""
        self.healthy = False

    def _heal(self, err: Exception) -> bool:
        """Self-heal after a ring-level fault (a raising dispatch — a
        CUDA error included — or a watchdog stall): fail whatever is
        still resident or parked with a retriable error, rebuild every piece of
        device state from scratch (RingExecutor.reset_state), back off
        exponentially.  Returns False — and flips ``healthy`` — when
        the restart budget is exhausted (the loop then dies and
        /healthz goes unhealthy)."""
        wrapped = (err if isinstance(err, RetriableError)
                   else RetriableError(
                       f"ring dispatch failed ({err}); rebuilt — retry"))
        healing = self._budget is not None and not self._budget.exhausted
        if healing:
            self._rebuilding = True
            self.stats["watchdog_restarts"] += 1
        else:
            self.healthy = False
        self.flightrec.record("watchdog_rebuild", error=str(err)[:200],
                              healing=healing,
                              residents=sum(r is not None
                                            for r in self.lane))
        self.flightrec.dump_file("watchdog_rebuild")
        for req in list(self.lane):
            if req is not None and not req.done.is_set():
                self._finish(req, wrapped)
        # parked lanes fail with the residents: their spills are host
        # bytes, but their clients get the same retriable signal
        for pk in self._parked:
            if not pk.req.done.is_set():
                self._finish(pk.req, wrapped)
        self._parked.clear()
        self.lane = [None] * self.slots
        self._lane_out = [[] for _ in range(self.slots)]
        self._lane_left = [0] * self.slots
        self._lane_pos = [0] * self.slots
        self._lane_first = [None] * self.slots
        self._prefilling.clear()
        if not healing:
            return False
        backoff = self._budget.spend()
        self.executor.reset_state()
        # the rebuilt pool is fresh (no store): re-attach the durable
        # store — surviving a rebuild is its point, and the rebuilt
        # radix re-fills from it through the store probe
        if (self.kv_store is not None and self.pool is not None
                and self.pool.host is not None):
            self.pool.attach_store(self.kv_store)
        self._peer_fetch_seen.clear()
        self._stop.wait(backoff)
        self._rebuilding = False
        return True

    def _expire_deadlines(self) -> None:
        now = time.monotonic()
        for i, req in enumerate(self.lane):
            if (req is not None and req.deadline is not None
                    and now >= req.deadline and not req.done.is_set()):
                req.deadline_exceeded = True
                self.stats["deadline_exceeded"] += 1
                self.flightrec.record("deadline_expired", lane=i,
                                      rid=req.request_id)
                self._evict(i)        # resolves with the partial tokens
        # an expired parked lane resolves with the tokens it had at the
        # spill boundary (the partial a resident gets), without waiting
        # for a lane
        for pk in list(self._parked):
            req = pk.req
            if (req.deadline is not None and now >= req.deadline
                    and not req.done.is_set()):
                req.deadline_exceeded = True
                self.stats["deadline_exceeded"] += 1
                self._release_parked(pk)

    # -- admission ---------------------------------------------------------

    def _bucket_for(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        raise ValueError(f"no bucket fits prompt length {n}")

    def _dispatch_cow(self, slot: int, cow, hit_len: int) -> None:
        """The admission's host-tier PROMOTIONS, then its copy-on-write
        block copies (codes and scales on the int8 pool), queued before
        the insert that reads them.  A host-resident hit reserved its
        device block inside ``pool.admit``: the batched upload must be
        on the stream before a CoW that may copy a promoted block and
        before the insert.  int8 only: when the hit lands MID-BLOCK, the
        lane's write-frontier block already holds quantized prefix rows
        (its CoW'd copy), so the lane's staging tail is seeded with them
        dequantized (paged.make_tail_init) — the suffix forward reads
        [block_start, hit_len) from the tail, and the block's requantize
        on completion needs them there."""
        ex = self.executor
        promotes = self.pool.take_promotions()
        if promotes:
            ex.dispatch_promotions(promotes)
            self.stats["promoted_blocks"] += len(promotes)
        for src, dst in cow:
            ex._copy_block(ex.cache, src, dst)
        self.stats["cow_copies"] = self.pool.stats["cow_copies"]
        if ex._tail_init is not None and hit_len % self.block_size:
            blk = int(self.pool.table[slot][hit_len // self.block_size])
            ex._tail_init(ex.cache, slot, blk)

    def _activate(self, slot: int, req: _Request, first) -> None:
        """A lane's prefill is queued: wire up the decode-side
        bookkeeping so the next chunk dispatch includes it.  The first
        token's host copy is queued now, behind the insert, and read at
        the next consume.  A speculative ring prefills the lane's draft
        here too, behind the target's insert."""
        n = len(req.prompt)
        if self.spec_k:
            self.executor.draft_prefill(slot, req.dev_prompt, n)
        self._lane_out[slot] = []
        self._lane_first[slot] = X._to_host_async(first.reshape(1))
        self._lane_left[slot] = req.max_new
        self._lane_pos[slot] = n
        if req.max_new == 1:
            # degenerate budget: read it now and free the lane
            self._materialize_first(slot, req)
            self._evict(slot)

    def _admit(self, slot: int, req: _Request) -> None:
        """Admission: reserve the lane, then route by prefill mode.
        ``inline`` is ONE insert (cold, or the suffix insert on a prefix
        hit) that prefills, writes the lane's KV, samples the first
        token and sets every piece of lane state on the device;
        ``chunked`` maps blocks (paged) or allocates the staging lane
        (contiguous) and lets the loop interleave the slices."""
        ex = self.executor
        n = len(req.prompt)
        now = time.monotonic()
        self.hist.queue_wait.observe((now - req.t_submit) * 1e3)
        self.flightrec.record("admit", rid=req.request_id, slot=slot,
                              prio=req.priority, mode=self.prefill_mode)
        # reserve the lane FIRST: the admin surface's in-use snapshot
        # (serve.py) reads lanes, parked lanes and the queue from another
        # thread, and a request popped from the queue but not yet in a
        # lane would slip through its evict guard
        self.lane[slot] = req
        if req.adapter_idx and self.adapters is not None:
            # re-validate: the adapter may have been evicted (and its
            # slot reloaded with another tenant's deltas) while this
            # request queued — the load generation captured at submit
            # is the identity check (the admission's exception path
            # releases the lane)
            try:
                live_ns = self.adapters.ns_of(req.adapter_idx)
            except KeyError:
                live_ns = -1
            if live_ns != req.ns:
                raise ValueError(
                    f"adapter {req.adapter!r} was evicted/replaced "
                    "while this request was queued; resubmit")
        # the lane's adapter slot: every dispatch from here on gathers
        # this lane's LoRA pair (a no-op without adapters)
        ex.set_aid(slot, req.adapter_idx)
        # reset the lane's host mirrors NOW, not at activation: a lane
        # evicted MID-PREFILL (cancel, deadline) resolves through
        # ``req.prompt + _lane_out[slot]``, and the previous occupant's
        # tokens must never leak into it
        self._lane_out[slot] = []
        self._lane_first[slot] = None
        if self.prefill_mode == "chunked":
            self._admit_chunked(slot, req)
            self.stats["admitted"] += 1
            return
        if self.paged:
            first = self._admit_paged(slot, req)
        else:
            first = ex.inserts[req.bucket](
                ex.params, ex.cache, ex.tok, ex.temp, ex.seeds,
                req.dev_prompt, n, slot, float(req.temperature), req.seed,
                lora=ex.lora_insert_tail(slot))
            self.stats["prefill_calls"] += 1
            self.stats["prefill_tokens"] += n
        self.stats["admitted"] += 1
        self._activate(slot, req, first)

    def _admit_paged(self, slot: int, req: _Request):
        """Inline paged admission: map blocks (radix hits read-only,
        CoW'd where the suffix will write, fresh for the rest), then
        ONE insert — the cold prefill cold, the suffix-only insert on a
        prefix hit.  A full prefix hit runs a ONE-token forward and no
        forward over cached blocks (the prefill counters pin it)."""
        ex = self.executor
        n = len(req.prompt)
        hit_len, cow = self.pool.admit(          # NoFreeBlocks -> req fails
            slot, req.prompt, max_suffix=self.SUFFIX_PREFILL_MAX_ROWS,
            ns=req.ns)
        self._dispatch_cow(slot, cow, hit_len)
        tbl_row = self._table_row(slot)
        if hit_len:
            first = self._suffix_admit(slot, req, tbl_row, hit_len)
        else:
            first = ex.inserts[req.bucket](
                ex.params, ex.cache, tbl_row, ex.tok, ex.temp, ex.seeds,
                req.dev_prompt, n, slot, float(req.temperature), req.seed,
                lora=ex.lora_insert_tail(slot))
            self.stats["prefill_calls"] += 1
            self.stats["prefill_tokens"] += n
        # register this lane's full prompt blocks for later admissions
        # (their content is written before any later work on the stream;
        # an adapter lane publishes under its namespace, so reuse stays
        # within one adapter load)
        self.pool.publish(slot, req.prompt, ns=req.ns)
        return first

    def _suffix_admit(self, slot: int, req: _Request, tbl_row, hit_len):
        """Prefix-hit admission: one suffix-only insert over the
        uncached tail."""
        ex = self.executor
        suffix = req.prompt[hit_len:]
        sb = ex.suffix_bucket(len(suffix))
        ins = ex.suffix_insert(sb)
        padded = np.zeros((1, sb), np.int32)
        padded[0, :len(suffix)] = suffix
        first = ins(ex.params, ex.cache, tbl_row, ex.tok, ex.temp,
                    ex.seeds, X.to_device(padded, self.device),
                    len(suffix), hit_len, slot, float(req.temperature),
                    req.seed, lora=ex.lora_insert_tail(slot))
        self.stats["prefill_calls"] += 1
        self.stats["prefill_tokens"] += len(suffix)
        return first

    def _table_row(self, slot: int) -> torch.Tensor:
        return X.to_device(self.pool.table[slot], self.device, torch.int32)

    def _admit_chunked(self, slot: int, req: _Request) -> None:
        """Chunked admission: reserve the lane and (paged) map its
        blocks now — radix hits, their copy-on-write and, for a hit
        ending mid-block on the int8 pool, the one seeding of the
        lane's staging tail (:meth:`_dispatch_cow`) — or (contiguous)
        allocate its staging lane.  The loop then advances ONE slice per
        ring iteration (:meth:`_advance_prefill`), so resident decode
        lanes never wait more than one slice."""
        ex = self.executor
        hit_len = 0
        lane_k = lane_v = None
        if self.paged:
            hit_len, cow = self.pool.admit(
                slot, req.prompt, max_suffix=self.SUFFIX_PREFILL_MAX_ROWS,
                ns=req.ns)
            self._dispatch_cow(slot, cow, hit_len)
        else:
            lane_k, lane_v = ex.make_staging(req.bucket)
        self._admit_seq += 1
        self._prefilling[slot] = _PrefillState(
            req, hit_len, self._admit_seq, lane_k, lane_v)

    def _advance_prefill(self, slot: int) -> None:
        """Dispatch the NEXT chunked-prefill slice for lane ``slot``: an
        intermediate slice appends KV only (no logits, no lane state);
        the final slice, padded to the slice width, runs the final
        insert (first-token sample and lane activation) and publishes
        the prompt's blocks to the radix cache.  Device work is queued
        in stream order behind the dispatches in flight; nothing is read
        back."""
        ex = self.executor
        st = self._prefilling[slot]
        req = st.req
        n = len(req.prompt)
        sb = ex.prefill_chunk
        remaining = n - st.start
        toks = np.zeros((1, sb), np.int32)
        if remaining > sb:
            # intermediate slice: KV only, no logits, no lane state
            toks[0, :] = req.prompt[st.start:st.start + sb]
            dev_toks = X.to_device(toks, self.device)
            if self.paged:
                args = (ex.params, ex.cache, self._table_row(slot),
                        dev_toks, st.start, st.start + sb)
                if ex.quant:    # int8 slices address the lane's tail
                    args += (slot,)
                ex.chunk_prog(None)(*args, lora=ex.lora_insert_tail(slot))
            else:
                ex.chunk_prog(ex.staging_len(req.bucket))(
                    ex.params, st.lane_k, st.lane_v, dev_toks, st.start,
                    lora=ex.lora_insert_tail(slot))
            st.start += sb
            self.stats["prefill_calls"] += 1
            self.stats["prefill_tokens"] += sb
            self.stats["chunked_prefill_tokens"] += sb
            return
        # final slice
        toks[0, :remaining] = req.prompt[st.start:]
        dev_toks = X.to_device(toks, self.device)
        if self.paged:
            first = ex.final_insert(None)(
                ex.params, ex.cache, self._table_row(slot), ex.tok, ex.temp,
                ex.seeds, dev_toks, remaining, st.start, slot,
                float(req.temperature), req.seed,
                lora=ex.lora_insert_tail(slot))
        else:
            first = ex.final_insert(ex.staging_len(req.bucket))(
                ex.params, ex.cache, st.lane_k, st.lane_v, ex.tok, ex.temp,
                ex.seeds, dev_toks, remaining, st.start, n, slot,
                float(req.temperature), req.seed,
                lora=ex.lora_insert_tail(slot))
        self.stats["prefill_calls"] += 1
        self.stats["prefill_tokens"] += remaining
        self.stats["chunked_prefill_tokens"] += remaining
        del self._prefilling[slot]
        if self.paged:
            self.pool.publish(slot, req.prompt, ns=req.ns)
        self._activate(slot, req, first)

    def _materialize_first(self, i: int, req: _Request) -> None:
        """Bring the admission-sampled first token to the host (its copy
        was queued right behind the insert) and run it through the same
        budget/eos/stream bookkeeping as chunk tokens."""
        fd = self._lane_first[i]
        if fd is None:
            return
        self._lane_first[i] = None
        (host,), ev = fd
        if ev is not None:
            ev.synchronize()
        t = int(host[0])
        now = time.monotonic()
        if req.t_first is None:
            req.t_first = now
            self.hist.ttft.observe((now - req.t_submit) * 1e3)
        req.t_last_tok = now
        self._lane_out[i].append(t)
        self._tokens_emitted += 1
        if req._stream is not None:
            req._stream.put(t)
        self._lane_left[i] -= 1
        if req.eos is not None and t == req.eos:
            self._lane_left[i] = 0

    def _finish(self, req: _Request,
                error: Optional[Exception] = None) -> None:
        # a request that already RESOLVED keeps its outcome
        if error is not None and req.error is None \
                and not req.done.is_set():
            req.error = error
        if not req.done.is_set() and req.error is None:
            # e2e latency: successful resolutions only (deadline
            # partials included)
            self.hist.e2e.observe((time.monotonic() - req.t_submit) * 1e3)
        # done BEFORE the stream sentinel: a stream() consumer that sees
        # the close must find result() already resolvable
        req.done.set()
        if req._stream is not None:
            req._stream.put(None)

    def _evict(self, slot: int) -> None:
        """Host bookkeeping, plus the lane's adapter slot zeroed in place
        (hygiene, queued without a wait): the lane's other stale device
        state is harmless (inactive lanes' tokens are ignored, their
        position zeroes, and the next admission overwrites all lane
        state)."""
        req = self.lane[slot]
        self.lane[slot] = None
        self._lane_pos[slot] = 0        # retired lanes report no pos
        self.executor.set_aid(slot, 0)
        # a lane evicted MID-PREFILL (cancel, deadline, a failed slice)
        # drops its slice state
        self._prefilling.pop(slot, None)
        if self.pool is not None:
            # published prompt blocks become reclaimable cache, private
            # ones rejoin the free list; the zeroed table row routes
            # this lane's writes in later dispatches to the trash block
            self.pool.retire(slot)
        self.stats["evicted"] += 1
        if req is not None and not req.done.is_set():
            # error-path evictions can race ahead of the first consume
            self._materialize_first(slot, req)
            req.out = req.prompt + self._lane_out[slot]
            self._finish(req)
        else:
            self._lane_first[slot] = None

    # -- preemptive lane spill ---------------------------------------------

    def _best_parked(self) -> Optional[_ParkedLane]:
        """The parked lane that should resume next: most urgent class
        first, then park order (FIFO within a class)."""
        if not self._parked:
            return None
        return min(self._parked, key=lambda p: (p.req.priority, p.seq))

    def _release_parked(self, pk: _ParkedLane) -> None:
        """Drop a parked lane; an unresolved request resolves with the
        tokens it had at the spill boundary."""
        self._parked.remove(pk)
        if not pk.req.done.is_set():
            pk.req.out = pk.req.prompt + pk.out
            self._finish(pk.req)

    def _waiting_class(self) -> Optional[int]:
        """Most urgent class with WAITING work (queued head or parked
        head) — the demand side of the preemption decision."""
        cq = self._pending.peek_class()
        pk = self._best_parked()
        cp = pk.req.priority if pk is not None else None
        if cq is None:
            return cp
        return cq if cp is None else min(cq, cp)

    def _pending_prefill_slots(self) -> set:
        """Lanes reserved but not yet decode-active: the lanes still
        mid-prefill (chunked), which are never preemption victims and
        never step in a dispatch."""
        return set(self._prefilling)

    def _preempt_victim(self) -> Optional[int]:
        """The lane to spill for waiting more-urgent work, or None when
        preemption should not fire: it needs the paged pool (the spill
        rides it; the contiguous ring never preempts), a fully busy
        ring, a STRICTLY less urgent resident than the waiting head,
        budget headroom, and a victim not already bounced
        ``max_preempts_per_request`` times.  The least urgent class goes
        first; among equals the SHORTEST lane (the smallest spill)."""
        if (self.pool is None or not self.qos.preempt or self._draining
                or any(r is None for r in self.lane)):
            return None
        demand = self._waiting_class()
        if demand is None or not self._preempt_budget.ok():
            return None
        prefill_pending = self._pending_prefill_slots()
        best, best_key = None, None
        for i, r in enumerate(self.lane):
            if (r is None or i in prefill_pending or r.done.is_set()
                    or r.priority <= demand
                    or r.preempts >= self.qos.max_preempts_per_request):
                continue
            key = (r.priority, -self._lane_pos[i])
            if best_key is None or key > best_key:
                best, best_key = i, key
        return best

    def _preempt(self, slot: int) -> None:
        """Spill resident lane ``slot`` to host and free its lane and
        blocks for more urgent work.  The caller has QUIESCED the
        dispatch pipeline, so the device state and the host mirrors
        agree at a chunk (or megastep) boundary: the spill captures
        exactly the consumed stream and the restore resumes it
        bit-identically.  The request stays UNRESOLVED: its client sees
        added latency, never an error or a truncated stream."""
        req = self.lane[slot]
        self._materialize_first(slot, req)
        if self._lane_left[slot] <= 0 or req.done.is_set():
            self._evict(slot)       # finished at the boundary anyway
            return
        spill = self.executor.spill_lane(slot)
        self.flightrec.record("preempt", rid=req.request_id, slot=slot,
                              prio=req.priority)
        self._park_seq += 1
        self._parked.append(_ParkedLane(
            req, spill, self._lane_out[slot], self._lane_left[slot],
            self._lane_pos[slot], self._park_seq))
        self.lane[slot] = None
        self._lane_out[slot] = []
        self._lane_pos[slot] = 0
        self._lane_first[slot] = None
        self.executor.set_aid(slot, 0)  # the spill carries it
        self.pool.retire(slot)      # blocks free for the preemptor
        req.preempts += 1
        self._preempt_budget.spend()
        self.stats["preempted_lanes"] += 1

    def _try_restore(self, pk: _ParkedLane) -> bool:
        """Re-admit parked lane ``pk`` into a free slot: fresh blocks,
        the spilled bytes uploaded, the host mirrors re-attached.
        Returns False (the lane stays parked) when the pool cannot map
        its blocks now — the next loop pass retries as blocks free."""
        req = pk.req
        if req._cancel or req.done.is_set():
            self._release_parked(pk)
            return True
        slot = self.lane.index(None)
        try:
            self.executor.restore_lane(slot, pk.spill)
        except self.executor._pg.NoFreeBlocks:
            self.pool.retire(slot)  # roll back ensure's partial mapping
            return False
        self._parked.remove(pk)
        self.lane[slot] = req
        self._lane_out[slot] = pk.out
        self._lane_left[slot] = pk.left
        self._lane_pos[slot] = pk.pos
        self._lane_first[slot] = None
        self.stats["restored_lanes"] += 1
        return True

    # -- durable prefix store ---------------------------------------------

    def _fingerprint(self) -> Dict[str, Any]:
        """The ring geometry a stored block must match byte-layout-wise —
        the JAX ring's dict for the same configuration, key for key (no
        backend field: a block either package writes serves the other).
        tp is absent (payloads are whole host blocks); the generation
        is present (KV of one generation never serves another's
        weights)."""
        ex = self.executor
        return {"layers": int(self.cfg.n_layers),
                "kvHeads": int(self.cfg.n_kv_heads),
                "headDim": int(self.cfg.head_dim),
                "blockSize": int(ex.block_size),
                "quant": ex.kv_quant,
                "specK": int(ex.spec_k),
                "generation": int(self.generation)}

    def attach_kv_store(self, store) -> None:
        """Wire the durable prefix store (infer/kvstore.KVBlockStore)
        into both halves: the POOL's spill path (tier overflow persists,
        its radix nodes surviving store-resident) and the SUBMIT probe.
        Requires the paged pool with the host tier."""
        if self.pool is None or self.pool.host is None:
            raise ValueError(
                "KV store requires paged attention with the host cache "
                "tier (host_cache_blocks > 0)")
        self.pool.attach_store(store)
        self.kv_store = store

    def _maybe_store_fetch(self, prompt) -> None:
        """Submit-thread store probe: when the prompt's full-block chain
        is not covered locally (an entry counts only if SERVABLE — device
        or host resident; a store-resident node is exactly what the
        probe re-fills), read the missing blocks from the store (a
        bounded disk read, on the caller's thread) and queue them for
        import ahead of the request, so its admission host-hits them."""
        from paddle_operator_tpu_torch.utils.radixkey import chain_key

        pool = self.pool
        bs = pool.bs
        tokens = [int(t) for t in prompt]
        n_full = len(tokens) // bs
        if n_full == 0:
            return
        keys: List[Any] = []
        key = None
        for j in range(n_full):
            key = chain_key(key, tuple(tokens[j * bs:(j + 1) * bs]))
            keys.append(key)
        # a racy read against the ring thread's radix: a surprise is
        # caught by submit, and the fetch simply skipped
        covered = 0
        for k in keys:
            e = pool.entries.get(k)
            if e is None or not pool._servable(e):
                break
            covered += 1
        if covered >= n_full:
            return
        tail = keys[-1]
        if tail in self._peer_fetch_seen:
            self._peer_fetch_seen.move_to_end(tail)
        else:
            self._peer_fetch_seen[tail] = True
            while len(self._peer_fetch_seen) > 1024:
                self._peer_fetch_seen.popitem(last=False)
        self.stats["kv_store_probes"] += 1
        chunks, idx, payloads, _fp = self.kv_store.fetch(
            tokens, bs, ns=0, skip=covered)
        if not idx:
            return
        self.stats["kv_store_hits"] += 1
        self._host_imports.put((chunks, idx, payloads, 0))
        self._wake.set()

    def _import_fetched(self) -> None:
        """Land the store payloads fetched so far in the host tier and
        the radix (ring thread: the queue's only consumer).  Called
        before each admission: a request's fetch is queued before the
        request, so its blocks are in the tier when it admits — and not
        earlier, where the demotes of the admissions before it could
        push them out again."""
        while not self._host_imports.empty():
            chunks, idx, payloads, ns = self._host_imports.get_nowait()
            if self.pool is not None:
                try:
                    self.pool.import_host_blocks(chunks, idx, payloads,
                                                 ns=ns)
                except Exception:
                    pass    # an import is an optimization, never a fault

    # -- the loop ----------------------------------------------------------

    def _loop(self) -> None:
        try:
            with torch.inference_mode():
                self._loop_body()
        except Exception as e:       # unrecoverable failure: fail loudly
            # flip dead-state BEFORE unblocking any client
            self.healthy = False
            self._stop.set()
            for req in self.lane:
                if req is not None:
                    self._finish(req, e)
            self.lane = [None] * self.slots
        # fail whatever is still queued, resident or parked
        for i, req in enumerate(self.lane):
            if req is not None:
                self._finish(req, ShuttingDown("batcher closed"))
                self.lane[i] = None
        for pk in self._parked:
            self._finish(pk.req, ShuttingDown("batcher closed"))
        self._parked.clear()
        self._shed_queue(ShuttingDown("batcher closed"))

    def _consume(self, chunk_reqs, toks: np.ndarray,
                 counts: Optional[np.ndarray] = None,
                 spec_raw: Optional[np.ndarray] = None) -> None:
        """Apply one finished chunk's tokens ([chunk, slots] on host).
        ``chunk_reqs`` pins each lane to the REQUEST the chunk was
        dispatched for: under pipelining a lane may have been evicted
        (and re-admitted) since dispatch — such tokens are dropped.

        ``counts`` (a fused megastep boundary): per-lane count of VALID
        rows in ``toks`` — lane i takes ``toks[:counts[i], i]``, which
        is also its device position advance (full chunks while live, 0
        once dead); None means every row is valid.  The budget/eos walk
        below is shared, so an eos inside a fused iteration truncates
        exactly like one inside a chunk.

        ``spec_raw`` (speculative rings): each lane's DEVICE commit count
        for the round — its position advance, even where the eos/budget
        walk stops earlier (the lane is then evicted and its position
        zeroed regardless), and the acceptance telemetry; 0 marks a
        fused round the lane sat out, which feeds no stat."""
        now = time.monotonic()
        for i, req in chunk_reqs:
            if req is None or self.lane[i] is not req \
                    or req.done.is_set():
                continue
            self._materialize_first(i, req)
            n = toks.shape[0] if counts is None else int(counts[i])
            if spec_raw is not None:
                n_raw = int(spec_raw[i])
                if n_raw == 0:
                    continue    # a fused round the (dead) lane sat out
                self._lane_pos[i] += n_raw
                self.stats["spec_drafted"] += self.spec_k
                self.stats["spec_accepted"] += n_raw - 1
                req.drafted += self.spec_k
                req.accepted += n_raw - 1
            else:
                self._lane_pos[i] += n
            emitted = 0
            for t in toks[:n, i]:
                if self._lane_left[i] <= 0:
                    break
                self._lane_out[i].append(int(t))
                self._tokens_emitted += 1
                emitted += 1
                if req._stream is not None:
                    req._stream.put(int(t))
                self._lane_left[i] -= 1
                if req.eos is not None and int(t) == req.eos:
                    self._lane_left[i] = 0
            if emitted:
                # chunk-granular inter-token latency
                if req.t_last_tok is not None and now > req.t_last_tok:
                    self.hist.itl.observe(
                        (now - req.t_last_tok) * 1e3 / emitted)
                req.t_last_tok = now
            if self._lane_left[i] <= 0:
                self._evict(i)

    def _consume_oldest(self, pending: List[tuple]) -> None:
        """Pop + apply the oldest in-flight dispatch (one chunk, or one
        megastep's N fused boundaries).  The blocking wait for its
        tokens sits under the watchdog, scaled by the fused iteration
        count (a legal N-step wait is ~N x a 1-step one): a wedged
        dispatch surfaces HERE, and the monitor fails the waiting
        clients while this thread is still stuck."""
        chunk_reqs, res, t0 = pending.pop(0)
        wd = self._watchdog
        if wd is not None:
            wd.begin(scale=res.n_steps)
        try:
            toks, counts = res.host()
            raw = res.raw_host()
        finally:
            if wd is not None:
                wd.end()
        # per-iteration wall estimate for the deadline-tick budget:
        # dispatch -> consume covers the pipeline wait too, so the EMA
        # overestimates — a lane freezes a little early and resumes in
        # the next dispatch, never late
        per = (time.monotonic() - t0) / res.n_steps
        self._step_s_est = (per if not self._step_s_est
                            else 0.8 * self._step_s_est + 0.2 * per)
        if self._fault is not None:
            return              # stall-failed chunks must not apply
        if counts is None:
            self._consume(chunk_reqs, toks)
            return
        # fused megastep: apply the N boundaries in order — each is one
        # 1-step consume with the eos/budget walk the device precomputed
        # (counts); a lane evicted at boundary r drops out of rounds
        # r+1.. through the chunk_reqs identity guard
        for r in range(res.n_steps):
            self._consume(chunk_reqs, toks[r], counts=counts[r],
                          spec_raw=None if raw is None else raw[r])

    def _loop_body(self) -> None:
        # Up to ``pipeline_depth`` chunks in flight: the host consumes
        # chunk N's tokens (queue pushes, evict bookkeeping, the
        # device->host wait) WHILE the card decodes chunk N+1.
        pending: List[tuple] = []   # [(chunk_reqs, DispatchResult, t0)]
        while not self.prewarmed.wait(0.1):     # it may be capturing
            if self._stop.is_set():
                return
        while not self._stop.is_set():
            ex = self.executor
            if self._fault is not None:
                err, self._fault = self._fault, None
                pending.clear()
                if not self._heal(err):
                    raise err
                continue
            if ex.needs_capture and not pending \
                    and all(r is None for r in self.lane):
                # on the card, before the first admission and after a
                # rebuild: capture the resident programs while the ring
                # is empty (a failure is a ring fault like a dispatch's)
                try:
                    ex.capture_graphs()
                except Exception as e:
                    self._fault = e
                    continue
            if self._draining:
                self._shed_queue(ShuttingDown(
                    "server draining; retry another replica"))
            self._expire_deadlines()
            # cancelled lanes leave at the chunk boundary
            for i, r in enumerate(self.lane):
                if r is not None and r._cancel:
                    self._evict(i)
            # parked lanes honor cancel too, without waiting for a lane
            for pk in list(self._parked):
                if pk.req._cancel or pk.req.done.is_set():
                    self._release_parked(pk)
            # admit into free lanes: parked (preempted) lanes resume
            # ahead of queued work of the same class — they were admitted
            # first and already hold tokens — and queued work pops in
            # class-then-FIFO order.  Restores run even while draining:
            # a parked lane is admitted work the drain promises to finish
            while any(r is None for r in self.lane):
                pk = self._best_parked()
                cq = (None if self._draining
                      else self._pending.peek_class())
                if pk is not None and (cq is None
                                       or pk.req.priority <= cq):
                    try:
                        restored = self._try_restore(pk)
                    except Exception as e:      # a device fault: heal
                        self._fault = e
                        break
                    if not restored:
                        break       # free blocks tight: retry next pass
                    continue
                if cq is None:
                    break
                try:
                    req = self._pending.get_nowait()
                except queue.Empty:
                    break
                if req._cancel:                 # cancelled while queued
                    req.out = list(req.prompt)
                    self._finish(req)
                    continue
                if (req.deadline is not None
                        and time.monotonic() >= req.deadline):
                    # expired while queued: prompt-only 504 partial
                    req.deadline_exceeded = True
                    self.stats["deadline_exceeded"] += 1
                    req.out = list(req.prompt)
                    self._finish(req)
                    continue
                # the store payloads a submit thread fetched for this
                # request were queued before the request itself: they
                # land in the tier now, right before the admission that
                # host-hits them
                self._import_fetched()
                slot = self.lane.index(None)
                try:
                    self._admit(slot, req)
                except Exception as e:          # bad request: fail it only
                    self._finish(req, e)
                    self.lane[slot] = None
                    ex.set_aid(slot, 0)
                    self._lane_pos[slot] = 0
                    self._lane_first[slot] = None
                    self._prefilling.pop(slot, None)
                    if self.pool is not None:
                        # admission may have mapped blocks before the
                        # insert failed — unmap them
                        self.pool.retire(slot)
            # preemptive lane spill: more urgent work waits and every
            # lane is busy — quiesce the pipeline (THE boundary: device
            # state and host mirrors agree), re-pick the victim (a
            # consumed chunk may have evicted it, or freed a lane), spill
            # it, and run admission again with the freed lane and blocks
            if self._preempt_victim() is not None:
                while pending:
                    try:
                        self._consume_oldest(pending)
                    except Exception as e:
                        self._fault = e
                        break
                if self._fault is None:
                    victim = self._preempt_victim()
                    if victim is not None:
                        try:
                            self._preempt(victim)
                        except Exception as e:  # a device fault: heal
                            self._fault = e
                continue

            # chunked prefill: advance exactly ONE slice per iteration
            # (oldest admission first) — the interleave that bounds how
            # long resident decode lanes ever wait
            if self._prefilling:
                slot = min(self._prefilling,
                           key=lambda s: self._prefilling[s].seq)
                req = self._prefilling[slot].req
                wd = self._watchdog
                if wd is not None:
                    wd.begin()
                try:
                    self._advance_prefill(slot)
                except Exception as e:          # fail THIS request only
                    self._finish(req, e)
                    self._evict(slot)
                finally:
                    if wd is not None:
                        wd.end()

            prefill_pending = self._pending_prefill_slots()
            active_idx = [i for i, r in enumerate(self.lane)
                          if r is not None and i not in prefill_pending]
            if not active_idx:
                if pending:
                    try:
                        self._consume_oldest(pending)
                    except Exception as e:
                        self._fault = e
                    continue            # eviction may have freed lanes
                if prefill_pending:
                    # no decode work, but prefill in flight: spin the
                    # loop (the slices run back to back)
                    self._wake.wait(timeout=0.002)
                    self._wake.clear()
                    continue
                self._wake.wait(timeout=0.1)
                self._wake.clear()
                continue
            self.stats["max_active"] = max(self.stats["max_active"],
                                           len(active_idx))
            n_mega = self.megastep
            tbl_np = None
            if self.paged:
                # on-demand block mapping: grow each active lane's table
                # to cover this dispatch PLUS every chunk already in
                # flight for it (the host pos mirror lags dispatched-
                # but-unconsumed work; a fused megastep advances up to
                # n_steps chunks, capped by the lane's own remaining
                # token budget; a speculative round advances a
                # data-dependent 1..K+1, so the bound is the worst case).
                # An undersized pool can run dry mid-generation: only
                # the lane that cannot grow fails (its request resolves
                # with the error), and the rest of the ring keeps
                # serving.
                advance = self.spec_k + 1 if self.spec_k else self.chunk
                for i in list(active_idx):
                    inflight = sum(entry.n_steps
                                   for chunk_reqs, entry, _ in pending
                                   for j, r in chunk_reqs
                                   if j == i and r is self.lane[i])
                    left_i = max(1, self._lane_left[i])
                    my_steps = (min(n_mega, left_i) if self.spec_k
                                else min(n_mega, -(-left_i // self.chunk)))
                    try:
                        self.pool.ensure(
                            i, self._lane_pos[i]
                            + (inflight + my_steps) * advance)
                    except ex._pg.NoFreeBlocks as e:
                        r = self.lane[i]
                        if r is not None and r.error is None:
                            r.error = e
                        self._evict(i)
                        active_idx.remove(i)
                if not active_idx:
                    continue        # every lane starved: retry the loop
                tbl_np = self.pool.table
                if prefill_pending:
                    # lanes mid-prefill hold REAL mapped blocks, but the
                    # chunk step writes every lane's (ignored) token at
                    # its zeroed position — point their rows at the
                    # trash block so an inactive write never touches a
                    # block a slice is filling (the plan's upload copies
                    # this snapshot into the graphs' static table)
                    tbl_np = tbl_np.copy()
                    tbl_np[sorted(prefill_pending)] = ex._pg.TRASH_BLOCK
            # fill the plan: which lanes step, the table snapshot, the
            # fused iteration count and — N>1 — the per-lane continuation
            # budgets the device carries across boundaries (eos id,
            # remaining tokens, and the deadline-tick step budget)
            eos_v = left_v = steps_v = None
            if n_mega > 1:
                eos_v = np.full((self.slots,), -1, np.int32)
                left_v = np.zeros((self.slots,), np.int32)
                steps_v = np.full((self.slots,), n_mega, np.int32)
                now = time.monotonic()
                for i in active_idx:
                    r = self.lane[i]
                    if r.eos is not None:
                        eos_v[i] = int(r.eos)
                    # the device budget EXCLUDES the admission-sampled
                    # first token while it is unmaterialized — the host
                    # consumes it out of the same max_new
                    left_v[i] = max(
                        0, self._lane_left[i]
                        - (1 if self._lane_first[i] is not None else 0))
                    if (self.paged and r.deadline is not None
                            and self._step_s_est > 0):
                        # deadline-tick budget: stop the lane at the
                        # boundary nearest its deadline instead of
                        # free-running the whole megastep past it.
                        # Paged only: a step-frozen lane resumes through
                        # the trash redirect the contiguous ring lacks.
                        remaining = r.deadline - now
                        steps_v[i] = max(1, min(
                            n_mega, int(remaining / self._step_s_est)))
            plan = X.ExecPlan(n_mega,
                              [r is not None and i not in prefill_pending
                               for i, r in enumerate(self.lane)],
                              table=tbl_np, eos=eos_v, left=left_v,
                              steps=steps_v)
            wd = self._watchdog
            if wd is not None:
                wd.begin(scale=n_mega)
            t0 = time.monotonic()
            try:
                res = ex.replay(plan)
            except Exception as e:
                self._fault = e
                continue
            finally:
                if wd is not None:
                    wd.end()
            self.stats["chunks"] += 1
            pending.append(([(i, self.lane[i]) for i in active_idx], res,
                            t0))
            if len(pending) >= self.pipeline_depth:
                try:
                    self._consume_oldest(pending)
                except Exception as e:
                    self._fault = e
