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

``prefill_mode="disagg"`` (implies the paged ring) moves cold prompts
off the ring: a radix prefix hit still admits inline through the suffix
insert, but a cold prompt maps fresh (reserved) blocks and ships to the
prefill engine (``executor.PrefillExecutor``: its own thread, stream
and pool; SERVE_PREFILL_LANES, _STREAM, _PREFIX_BLOCKS) or to the
prefill pool's pods (``prefill_client``: infer/prefill_serve.py
``RemotePrefillClient``).  The lane waits out of every dispatch, as a
chunked lane does; the loop lands each result — streamed frames as they
arrive — by block copy (remote: the promote scatter) and attaches the
lane with one small in-place write of its state.

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
model.

Ring operations: ``trace=True`` (SERVE_TRACE) gives each request a span
tree (utils/tracing.py ``RequestTrace``: queue wait, admission, prefill
slices, the disaggregated prefill, its frames and attach, TTFT, one
span a consumed dispatch, spill, restore) from host
timestamps taken where the loop already stands, so tracing adds no
device synchronization and traced streams equal untraced ones;
``RingResilience(nan_check=True)`` (SERVE_NAN_CHECK) makes every
dispatch return each lane's isfinite verdict, and a non-finite lane
fails its request alone with :class:`LaneQuarantined` while its private
blocks are scrubbed; :meth:`ContinuousBatcher.swap_weights` (``/v1/swap``)
flips the served weights of a paged ring at a quiesced boundary — the
residents park through the preemption spill, the executor swaps and
captures its graphs again, and the parked lanes resume.

Fleet-level KV (paged rings; serve.py ``wire_fleet_kv_from_env`` wires
it): with ``migrate_out`` set, a drain parks every resident decode lane
at a boundary with nothing in flight and offers each spill to a peer as
a lane envelope (utils/fleetkv.py) on a side thread; an adopted lane's
request resolves here with :class:`LaneMigrated` (503, the client's
retry collects the result on the adopter), a refused one resumes
locally.  ``migrate_parked_s`` offers preemption-parked lanes that
waited that long.  :meth:`ContinuousBatcher.adopt` takes a peer's lane
(the ``/v1/kv/restore`` handler's thread: validation only, nothing on
the device) and the loop restores it through the preemption restore.
With ``peer_fetch`` set, the submit thread asks the fleet for a cold
prompt's demoted blocks (peer, then the durable store) and the loop
imports them into the host tier before the admission.

``mesh`` (a ``parallel/mesh.py`` ``make_serving_mesh`` mesh of tp > 1,
one process a card): the batcher is rank 0's, the leader of
``infer/tp.py`` — its executor (a ``LeaderExecutor``) sends every call
it is given to the other ranks, which run :func:`follow_ring` on the
same arguments and replay them; ``params`` is each rank's cut of the
model.  Refused on such a ring, by name (ROADMAP.md Queue A item 8.5b):
the live swap and its tp resize, speculative decoding, the host tier
and the durable store, fleet-level KV, disaggregated prefill and MoE
presets.
"""

from __future__ import annotations

import inspect
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
    LaneMigrated,
    LaneQuarantined,
    RestartBudget,
    RetriableError,
    RingResilience,
    ShuttingDown,
)
from paddle_operator_tpu_torch.models.llama import LlamaConfig
from paddle_operator_tpu_torch.parallel.mesh import mesh_tp
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


# the batcher arguments a tensor-parallel ring refuses, each with the
# knob that asks for it (ROADMAP.md Queue A item 8.5b)
_TP_REFUSED = (
    ("spec_k", "SERVE_SPEC_K (speculative decoding)"),
    ("host_cache_blocks", "SERVE_HOST_CACHE_MB / SERVE_HOST_CACHE_BLOCKS "
                          "(the host tier)"),
)


def _refuse_on_tp(tp: int, args: Dict[str, Any]) -> None:
    """Refuse, by the knob that asks for it, what a tensor-parallel ring
    does not serve."""
    for name, knob in _TP_REFUSED:
        if args.get(name):
            raise _unported(f"{knob} on a tensor-parallel ring "
                            f"(SERVE_TP={tp}; item 8.5b)")
    if args.get("prefill_mode") == "disagg":
        raise _unported(f"SERVE_PREFILL=disagg on a tensor-parallel ring "
                        f"(SERVE_TP={tp}; item 8.5b)")
    if args["cfg"].n_experts > 0:
        raise _unported(f"an MoE preset on a tensor-parallel ring "
                        f"(SERVE_TP={tp}; item 8.5b)")


def _ring_executor(params, cfg: LlamaConfig,
                   a: Dict[str, Any]) -> "X.RingExecutor":
    """The ring's executor from the batcher's arguments ``a`` (every
    parameter of :class:`ContinuousBatcher`, defaults included): what
    the leader of a tensor-parallel ring builds and what each follower
    (:func:`follow_ring`) builds from the same arguments."""
    res = a["resilience"]
    return X.RingExecutor(
        params, cfg, slots=a["slots"],
        max_len=a["max_len"] or cfg.max_seq_len,
        chunk_tokens=a["chunk_tokens"],
        prefill_buckets=a["prefill_buckets"], top_k=a["top_k"],
        top_p=a["top_p"],
        paged=a["paged"] or a["prefill_mode"] == "disagg",
        block_size=a["block_size"], num_blocks=a["num_blocks"],
        prefix_cache=a["prefix_cache"], kv_quant=a["kv_quant"],
        megastep=int(a["megastep"]),
        host_cache_blocks=a["host_cache_blocks"],
        prefill_chunk=a["prefill_chunk"], draft_params=a["draft_params"],
        draft_cfg=a["draft_cfg"], spec_k=a["spec_k"],
        adapters=a["adapters"],
        check_finite=bool(res and res.nan_check),
        prefill_mode=a["prefill_mode"], prefill_client=a["prefill_client"],
        prefill_lanes=a["prefill_lanes"],
        prefill_stream=a["prefill_stream"],
        prefill_prefix_blocks=a["prefill_prefix_blocks"], mesh=a["mesh"])


def follow_ring(params: Any, cfg: LlamaConfig, **kw) -> int:
    """A follower rank (rank > 0) of a tensor-parallel ring: build the
    executor the leader's ``ContinuousBatcher(params, cfg, **kw)`` builds
    (``kw`` the same arguments, ``mesh`` included; ``params`` this
    rank's cut; ``adapters`` this rank's registry) and replay the
    leader's calls on it (``infer/tp.py`` ``follow``) until the leader
    closes the ring; returns 0."""
    from paddle_operator_tpu_torch.infer import tp as TPR

    bound = inspect.signature(ContinuousBatcher.__init__).bind(
        None, params, cfg, **kw)
    bound.apply_defaults()
    a = dict(bound.arguments)
    _refuse_on_tp(mesh_tp(a["mesh"]), a)
    ex = _ring_executor(params, cfg, a)
    return TPR.follow(ex, TPR.channel_for(a["mesh"]), a["adapters"])


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
                 "adapter", "adapter_idx", "ns", "trace", "t_prefill0",
                 "migrate_state")

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
        # the client's idempotent id (the migration's retrieval key) and
        # the request's migration state: None (never offered),
        # "inflight" (its envelope on the wire), "done" or "failed" (a
        # peer refused: never offered again, it resumes here)
        self.request_id: Optional[str] = None
        self.migrate_state: Optional[str] = None
        # the request's span tree (SERVE_TRACE rings; None: untraced)
        self.trace: Optional[TR.RequestTrace] = None
        self.t_submit = time.monotonic()
        self.t_first: Optional[float] = None
        self.t_last_tok: Optional[float] = None
        # a disaggregated prefill's submit to the engine (its span)
        self.t_prefill0: Optional[float] = None
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

    __slots__ = ("req", "spill", "out", "left", "pos", "seq",
                 "generation", "migrating", "t_parked")

    def __init__(self, req, spill, out, left, pos, seq, generation=0):
        self.req = req
        self.spill = spill
        self.out = out          # tokens emitted before the spill
        self.left = left        # remaining token budget
        self.pos = pos          # fill position at the spill boundary
        self.seq = seq          # park order — FIFO within a class
        # the weight generation its KV was computed under: a lane parked
        # across a live swap is never offered to the fleet
        self.generation = generation
        # its envelope is on the wire to a peer: not restorable here
        # (and deadline / cancel wait) until the outcome lands
        self.migrating = False
        self.t_parked = time.monotonic()


class _SwapRequest:
    """One posted live weight swap, handed from the caller's thread to
    the ring loop: the new models (already loaded, quantized and on the
    card — the expensive work happened off the ring thread), the
    generation to set (None: bump by one) and the completion event the
    caller blocks on.  ``error`` is set instead of ``result`` when the
    swap aborted: the ring then still serves the old generation."""

    __slots__ = ("params", "draft_params", "generation", "done", "error",
                 "result")

    def __init__(self, params, draft_params, generation):
        self.params = params
        self.draft_params = draft_params
        self.generation = generation
        self.done = threading.Event()
        self.error: Optional[Exception] = None
        self.result: Optional[Dict[str, Any]] = None


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
                 prefill_client: Any = None,
                 prefill_lanes: int = 1,
                 prefill_stream: bool = False,
                 prefill_prefix_blocks: int = 0,
                 trace: Optional[bool] = None,
                 generation: int = 0) -> None:
        args = dict(locals())
        if prefill_mode not in PREFILL_MODES:
            raise ValueError(f"prefill_mode {prefill_mode!r} not in "
                             f"{PREFILL_MODES}")
        self.tp = mesh_tp(mesh)
        if self.tp > 1:
            _refuse_on_tp(self.tp, args)
        if prefill_mode == "disagg":
            # the disaggregated handoff is block-granular by design: the
            # paged pool IS the transfer unit
            paged = True
        # SERVE_NAN_CHECK: every dispatch also returns each lane's
        # isfinite verdict, and a non-finite lane fails alone
        self._check_finite = bool(resilience and resilience.nan_check)
        if self._check_finite and spec_k:
            raise ValueError("nan_check is not supported on speculative "
                             "rings (the spec round has no per-lane "
                             "finite fold); disable one of them")
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

        # span capture (SERVE_TRACE=1) is opt-in: off, requests carry
        # trace=None and every capture site is one attribute check; the
        # histograms and the flight recorder are always on
        pod = os.environ.get("TPUJOB_REPLICA_ID", "")
        if trace is None:
            trace = TR.trace_enabled()
        self.tracer: Optional[TR.Tracer] = (
            TR.Tracer(pod=pod) if trace else None)
        self.hist = TR.ServeHistograms()
        self.flightrec = TR.FlightRecorder(pod=pod)

        self.executor = _ring_executor(params, cfg, args)
        if self.tp > 1:
            # the leader of a tensor-parallel ring: every executor call
            # and adapter load/evict reaches the followers first
            from paddle_operator_tpu_torch.infer import tp as TPR

            channel = TPR.channel_for(mesh)
            self.executor = TPR.LeaderExecutor(self.executor, channel)
            if adapters is not None:
                self.adapters = TPR.LeaderAdapters(adapters, channel)
        self.device = self.executor.device
        self.spec_k = self.executor.spec_k
        self.draft_cfg = self.executor.draft_cfg
        # live weight swap: the generation of the served weights
        # (SERVE_GENERATION seeds it; a swap bumps or sets it), the
        # single pending swap the loop takes at a quiesced boundary, and
        # the last swap's timings
        self.generation = int(generation)
        self._swap_req: Optional[_SwapRequest] = None
        self._swap_lock = threading.Lock()
        self.last_swap: Dict[str, Any] = {}
        self.paged = self.executor.paged
        self._top_k, self._top_p = top_k, top_p
        if self.executor.prefill_remote:
            # every POST carries THIS ring's handoff fingerprint: the pod
            # refuses a mismatch with 409 and the client re-validates the
            # returned envelope before the ring touches its bytes.  On the
            # card the client pins the payload on its worker thread, so
            # the landing's upload leaves from pinned memory
            client = self.executor.prefill_exec
            client.fingerprint = self.handoff_fingerprint()
            client.pin = self.device.type == "cuda"

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
        # a disaggregated prompt away on the prefill engine or pod (slot
        # -> request): reserved, not decode-active, like a chunked lane;
        # and the upload stamps of its streamed frames landed BEFORE the
        # terminal item (a stamp earlier than the engine's done stamp
        # provably overlapped prefill compute)
        self._disagg_waiting: Dict[int, _Request] = {}
        self._handoff_frame_t: Dict[int, List[float]] = {}
        # test hook: a callable invoked before each handoff drain
        self.handoff_gate = None

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
        # chains already asked of the fleet — the peer leg's dedupe;
        # the store probe stays outside it
        self._peer_fetch_seen: "OrderedDict[Any, bool]" = OrderedDict()
        # fleet-level KV (serve.wire_fleet_kv_from_env):
        # ``migrate_out(meta, spill) -> bool`` offers a parked lane to a
        # peer (a FleetKVClient behind it), ``peer_fetch(tokens, ns)``
        # asks the fleet for a prompt's demoted blocks; a drain migrates
        # its residents when ``_migrate_on_drain``, and parked lanes
        # older than ``migrate_parked_s`` are offered out
        self.migrate_out = None
        self.peer_fetch = None
        self._migrate_on_drain = False
        self.migrate_parked_s: Optional[float] = None
        # lanes adopted from peers (HTTP thread -> loop) and migration
        # outcomes (worker thread -> loop)
        self._adopt_q: "queue.Queue[_ParkedLane]" = queue.Queue()
        self._migr_done: "queue.Queue[tuple]" = queue.Queue()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self.stats = {"admitted": 0, "evicted": 0, "chunks": 0,
                      "max_active": 0, "rejected_queue_full": 0,
                      # chunked_prefill_tokens: the share of prefill
                      # tokens that arrived in interleaved slices;
                      # disagg_prefills: handoffs attached (remote ones
                      # also count remote_prefills), handoff_frames the
                      # streamed frames landed, overlapped_frames those
                      # landed before their prompt's prefill finished
                      "prefill_calls": 0, "prefill_tokens": 0,
                      "chunked_prefill_tokens": 0, "disagg_prefills": 0,
                      "remote_prefills": 0, "handoff_frames": 0,
                      "overlapped_frames": 0,
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
                      "promoted_blocks": 0,
                      # lanes failed by the NaN-lane check, and live
                      # weight swaps completed
                      "quarantined_lanes": 0, "weight_swaps": 0,
                      # lanes migrated out to a peer, lanes adopted in,
                      # and prefix chains fetched from a peer's tier
                      "lane_migrations": 0, "adopted_lanes": 0,
                      "peer_prefix_fetches": 0}
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
               adapter: Optional[str] = None,
               trace_ctx: Optional[tuple] = None) -> _Request:
        """Queue one generation request; returns a handle whose
        ``result()``/``stream()`` deliver the tokens.

        ``trace_ctx``: ``(trace_id, parent_span_id | None)`` from the
        ``X-Tpujob-Trace`` header — on a tracing ring the request's
        spans hang under that context and ``handle.trace`` rides the
        response, so the router stitches one timeline; a tracing ring
        without one mints a trace id; ignored when tracing is off.

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
        if self.tracer is not None:
            req.trace = self.tracer.begin(ctx=trace_ctx,
                                          request_id=request_id)
            # workload-shape stamps on the root span: an exported span
            # tree alone reconstructs the request served
            req.trace.annotate(promptLen=len(prompt),
                               maxNew=int(max_new_tokens), prio=prio,
                               adapter=adapter)
        req.priority = prio
        req.adapter = adapter
        req.adapter_idx = adapter_idx
        req.ns = adapter_ns if adapter_idx else 0
        req.request_id = request_id
        # a cold prefix may be warm on a peer or in the durable store:
        # fetch its blocks now, on the caller's thread (peer first, then
        # the store), so this request's admission host-hits them.  Base
        # namespace only: an adapter's namespace is minted per load, so
        # its chains never match another replica's or a stored one
        if ((self.peer_fetch is not None or self.kv_store is not None)
                and req.ns == 0 and self.pool is not None
                and self.pool.host is not None):
            try:
                self._maybe_peer_fetch(prompt)
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

    def weight_quant_mode(self) -> str:
        """Weight-quant mode of the served (target) params."""
        return Q.weight_quant_mode(self.executor.params)

    def draft_quant_mode(self) -> str:
        """Weight-quant mode of the DRAFT params ("none" on
        non-speculative rings) — SERVE_DRAFT_QUANT's visibility."""
        dp = self.executor.draft_params
        return Q.weight_quant_mode(dp) if dp is not None else "none"

    def prefill_queue_depth(self) -> int:
        """Requests admitted to a lane but still PREFILLING: chunked
        slices mid-flight plus disaggregated jobs queued or running on
        the prefill engine or pod, or awaiting their handoff — the
        ``tpujob_serve_prefill_queue_depth`` gauge."""
        return len(self._prefilling) + len(self._disagg_waiting)

    def _prefill_engine_stat(self, name: str, default):
        """A LOCAL prefill engine's telemetry (lanes, batch occupancy,
        head-of-line wait) — the default on rings without one (inline,
        chunked, remote: the pods export their own)."""
        pe = self.executor.prefill_exec
        if pe is None or self.executor.prefill_remote:
            return default
        if name == "lanes":
            return pe.lanes
        return getattr(pe, name)()

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
            "prefillLanes": self._prefill_engine_stat("lanes", 0),
            "prefillBatchOccupancy": self._prefill_engine_stat(
                "batch_occupancy", 0.0),
            "prefillHolWaitMs": self._prefill_engine_stat(
                "hol_wait_ms_p95", 0.0),
            "handoffFrames": self.stats["handoff_frames"],
            "overlappedFrames": self.stats["overlapped_frames"],
            "kvQuantMode": self.kv_quant,
            "kvPoolBytes": self.executor.pool_bytes(),
            "weightQuantMode": self.weight_quant_mode(),
            "draftQuantMode": self.draft_quant_mode(),
            "paramBytes": self.executor.param_bytes(),
            "chunkedPrefillTokenShare": (
                round(self.stats["chunked_prefill_tokens"] / pf_tok, 4)
                if pf_tok else 0.0),
            "priorityQueueDepth": self._pending.qsize_by_class(),
            "preemptedLanes": self.stats["preempted_lanes"],
            "parkedLanes": len(self._parked),
            "laneMigrations": self.stats["lane_migrations"],
            "adoptedLanes": self.stats["adopted_lanes"],
            "peerPrefixFetches": self.stats["peer_prefix_fetches"],
            "remotePrefills": self.stats["remote_prefills"],
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
            "quarantinedLanes": self.stats["quarantined_lanes"],
            "weightGeneration": int(self.generation),
            "servingTp": self.serving_tp(),
            "weightSwaps": self.stats["weight_swaps"],
            # the round's draft depth, on speculative rings only (the
            # JAX status has no such key; its fingerprint does)
            **({"specK": self.spec_k} if self.spec_k else {}),
        }

    @property
    def accepting(self) -> bool:
        """Readiness (/readyz): the ring takes new admissions — not
        draining, not mid-rebuild, not mid-swap, loop alive, budget
        unspent.  Mid-swap is a readiness event, not an availability
        one: the router routes new traffic elsewhere while requests
        already here queue through the flip."""
        return (self.healthy and not self._draining
                and not self._rebuilding and self._swap_req is None
                and not self._stop.is_set() and self._thread.is_alive())

    # -- live weight swap --------------------------------------------------

    def serving_tp(self) -> int:
        """The tensor-parallel degree served: the mesh's tp (1 without a
        mesh)."""
        return self.tp

    def swap_weights(self, params: Any, *, draft_params: Any = None,
                     mesh: Any = None, tp: int = 1,
                     generation: Optional[int] = None,
                     timeout: Optional[float] = 120.0) -> Dict[str, Any]:
        """Live weight swap: flip the served model (and, on a speculative
        ring, the draft, which must come with it) without restarting the
        process or dropping a request.

        Call from any thread (serve.py's ``/v1/swap`` handler) with the
        new models already on the ring's card: the load, the
        quantization and the upload happened on the caller's thread.
        The ring loop, at the next boundary with no lane mid-prefill,
        consumes every dispatch in flight, parks every resident lane
        through the preemption spill, swaps the executor's models,
        rebuilds its state (a fresh pool and radix: KV of the old
        generation never serves the new one) and captures its graphs
        again, then restores the parked lanes.  All-or-nothing: a failure
        at any step (and a self-healing rebuild racing the swap) puts
        the old models back and raises here, and the generation does not
        move.  ``generation=None`` bumps it by one; a value sets it.
        ``mesh`` / ``tp`` other than None / 1 (a tensor-parallel resize)
        are refused, and so is any swap on a tensor-parallel ring.
        Returns the post-swap summary."""
        if mesh is not None or int(tp) != self.tp:
            raise _unported(f"a tensor-parallel resize to tp={tp} (mesh) "
                            "(ROADMAP.md Queue A item 8.5b)")
        if self.tp > 1:
            raise _unported(f"a live weight swap on a tensor-parallel "
                            f"ring (SERVE_TP={self.tp}; ROADMAP.md Queue "
                            "A item 8.5b)")
        if self.pool is None:
            raise ValueError(
                "live weight swap requires the paged ring "
                "(SERVE_PAGED=1): resident lanes park through the "
                "block-granular spill")
        if not self.accepting and self._swap_req is None:
            raise ShuttingDown(
                "ring is draining/rebuilding/stopped; not swapping")
        if self.device.type == "cuda" and any(
                m is not None and Q.weight_quant_mode(m) != "none"
                for m in (params, draft_params)):
            # a flip to quantized weights: build the int8-weight kernels
            # here, on the caller's thread, not on the ring's
            from paddle_operator_tpu_torch.ops import _build

            _build.load("quant_matmul")
        sw = _SwapRequest(params, draft_params, generation)
        with self._swap_lock:
            if self._swap_req is not None:
                raise ValueError("a weight swap is already in flight")
            self._swap_req = sw
        self._wake.set()
        if not sw.done.wait(timeout):
            # the ring never reached a boundary (a wedged dispatch): the
            # watchdog fails the residents; un-post so the replica does
            # not stay unready
            with self._swap_lock:
                if self._swap_req is sw:
                    self._swap_req = None
            raise RetriableError(
                f"weight swap timed out after {timeout}s awaiting a "
                "quiesced boundary; the ring still serves generation "
                f"{self.generation} — retry")
        if sw.error is not None:
            raise sw.error
        return sw.result or {}

    def _park_residents_for_swap(self) -> int:
        """Park every resident decode lane at the boundary (the caller
        consumed every dispatch in flight, so device state and host
        mirrors agree), through the preemption spill."""
        parked = 0
        for i, r in enumerate(self.lane):
            if r is None or r.done.is_set() or r._cancel:
                continue
            self._preempt(i)
            parked += 1
        return parked

    def _do_swap(self) -> None:
        """Run the posted swap at the quiesced boundary (ring loop only,
        nothing in flight): park, swap the models, rebuild the state,
        capture the graphs, restore the parked lanes.  The old models
        stay referenced until the new graphs are captured.  On a failure
        the old models come back (the loop captures their graphs again)
        and the parked lanes restore onto them."""
        with self._swap_lock:
            sw, self._swap_req = self._swap_req, None
        if sw is None:
            return
        ex = self.executor
        t0 = time.monotonic()
        self.flightrec.record(
            "swap_begin", generation=sw.generation,
            residents=sum(r is not None for r in self.lane))
        try:
            parked = self._park_residents_for_swap()
            t_park = time.monotonic()
            old = ex.swap_weights(sw.params, sw.draft_params)
            try:
                ex.reset_state()
                t_flip = time.monotonic()
                ex.capture_graphs()
            except Exception:
                ex.swap_weights(*old)
                ex.reset_state()
                raise
            t_cap = time.monotonic()
            del old     # the last references: the new graphs exist
        except Exception as e:
            self.flightrec.record("swap_failed", error=str(e)[:200])
            sw.error = e
            sw.done.set()
            return
        self.generation = (int(sw.generation)
                           if sw.generation is not None
                           else self.generation + 1)
        # the rebuilt pool is fresh: re-attach the durable store under a
        # fingerprint carrying the new generation, so the old
        # generation's stored blocks are refused, never promoted
        if (self.kv_store is not None and self.pool is not None
                and self.pool.host is not None):
            self.pool.attach_store(self.kv_store)
            if getattr(self.kv_store, "fingerprint", None) is not None:
                self.kv_store.fingerprint = self._fingerprint()
        # the prefill pods must serve the same generation: re-stamp the
        # client's fingerprint, so a pod still on the old one 409s
        if self.executor.prefill_remote:
            self.executor.prefill_exec.fingerprint = \
                self.handoff_fingerprint()
        self._peer_fetch_seen.clear()
        # the parked lanes resume now, on the new graphs (a lane whose
        # envelope is on the wire waits for its outcome)
        try:
            while any(r is None for r in self.lane):
                pk = self._best_parked()
                if pk is None or not self._try_restore(pk):
                    break       # the rest resume as blocks free
        except Exception as e:  # a device fault: the loop heals
            self._fault = e
        t_end = time.monotonic()
        self.stats["weight_swaps"] += 1
        self.last_swap = {"park_s": t_park - t0,
                          "flip_s": t_flip - t_park,
                          "capture_s": t_cap - t_flip,
                          "restore_s": t_end - t_cap,
                          "total_s": t_end - t0, "parked": parked}
        self.flightrec.record(
            "swap_done", generation=self.generation, parked=parked,
            ms=round((t_end - t0) * 1e3, 1))
        sw.result = {"generation": self.generation,
                     "servingTp": self.serving_tp(),
                     "parkedLanes": parked,
                     "weightQuantMode": self.weight_quant_mode(),
                     "swapMs": round((t_end - t0) * 1e3, 1)}
        sw.done.set()
        self._wake.set()

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
        if self.executor.prefill_exec is not None:
            self.executor.prefill_exec.close()
        if not self._thread.is_alive():
            # the ring thread is gone: its host tier's memory goes back,
            # and a tensor-parallel ring's followers stop replaying
            self.executor.close_host_tier()
            self.executor.stop_followers()
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
        spills = [pk.spill for pk in self._parked]
        self._parked.clear()
        self.lane = [None] * self.slots
        self._lane_out = [[] for _ in range(self.slots)]
        self._lane_left = [0] * self.slots
        self._lane_pos = [0] * self.slots
        self._lane_first = [None] * self.slots
        self._prefilling.clear()
        # a disaggregated result for a healed-away request is dropped
        # (and its engine lane released) by the handoff drain
        self._disagg_waiting.clear()
        self._handoff_frame_t.clear()
        # a rebuild aborts a pending live swap: the rebuilt ring serves
        # the old generation, and the swap's caller must retry
        with self._swap_lock:
            sw, self._swap_req = self._swap_req, None
        if sw is not None:
            sw.error = RetriableError(
                "ring rebuilt mid-swap; the old generation was "
                "restored — retry the swap")
            sw.done.set()
        if not healing:
            return False
        backoff = self._budget.spend()
        # the ring goes on: a tensor-parallel ring's followers drop their
        # halves of the spills too (at close they end with their loops)
        for spill in spills:
            self.executor.drop_spill(spill)
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
        # for a lane.  A lane whose envelope is on the wire waits for the
        # outcome: expiring it while a peer adopts would resolve a
        # partial here AND decode the whole stream there (the deadline
        # travels in the envelope, and the adopter enforces it)
        for pk in list(self._parked):
            req = pk.req
            if pk.migrating:
                continue
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

    def _activate(self, slot: int, req: _Request, first,
                  draft: bool = True) -> None:
        """A lane's prefill is queued: wire up the decode-side
        bookkeeping so the next chunk dispatch includes it.  The first
        token's host copy is queued now, behind the insert, and read at
        the next consume.  A speculative ring prefills the lane's draft
        here too, behind the target's insert (``draft=False``: the
        disaggregated attach did)."""
        n = len(req.prompt)
        if self.spec_k and draft:
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
        if req.trace is not None:
            req.trace.add("queue_wait", req.t_submit, now,
                          prio=req.priority)
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
        if self.prefill_mode == "disagg":
            self._admit_disagg(slot, req)
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
        t_slice0 = time.monotonic()
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
            if req.trace is not None:
                req.trace.add("prefill_slice", t_slice0,
                              start=st.start - sb, tokens=sb)
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
        if req.trace is not None:
            req.trace.add("prefill_slice", t_slice0, start=st.start,
                          tokens=remaining, final=True)
        del self._prefilling[slot]
        if self.paged:
            self.pool.publish(slot, req.prompt, ns=req.ns)
        self._activate(slot, req, first)

    # -- disaggregated prefill: the decode side ------------------------------

    def _admit_disagg(self, slot: int, req: _Request) -> None:
        """Disaggregated admission: a radix prefix HIT admits inline
        through the suffix insert (the cached blocks live in the decode
        pool; the suffix forward is already cheap).  A COLD prompt maps
        fresh decode-pool blocks now (reserved, so the handoff can never
        fail on NoFreeBlocks) and ships its prefill to the engine (or the
        prefill pool); the loop attaches the lane when the result
        lands."""
        ex = self.executor
        hit_len, cow = self.pool.admit(          # NoFreeBlocks -> req fails
            slot, req.prompt, max_suffix=self.SUFFIX_PREFILL_MAX_ROWS,
            ns=req.ns)
        if hit_len and not self.spec_k:
            self._dispatch_cow(slot, cow, hit_len)
            first = self._suffix_admit(slot, req, self._table_row(slot),
                                       hit_len)
            self.pool.publish(slot, req.prompt, ns=req.ns)
            self._activate(slot, req, first)
            return
        # cold: the blocks are mapped; a hit_len-0 partial-tail hit may
        # still have promoted one block, whose upload must not stay
        # pending
        self._dispatch_cow(slot, cow, hit_len)
        if ex.prefill_remote and req.adapter_idx:
            # the prefill pods serve the BASE model: an adapter prompt
            # prefilled there would hand off base-model KV under a
            # tenant's namespace.  It admits inline on the ring instead
            n = len(req.prompt)
            first = ex.inserts[req.bucket](
                ex.params, ex.cache, self._table_row(slot), ex.tok, ex.temp,
                ex.seeds, req.dev_prompt, n, slot, float(req.temperature),
                req.seed, lora=ex.lora_insert_tail(slot))
            self.stats["prefill_calls"] += 1
            self.stats["prefill_tokens"] += n
            self.pool.publish(slot, req.prompt, ns=req.ns)
            self._activate(slot, req, first)
            return
        self._disagg_waiting[slot] = req
        req.t_prefill0 = time.monotonic()
        ex.prefill_exec.submit(req, slot)

    def _await_snapshot(self, snap) -> None:
        """Order the ring's stream after the engine's writes of an
        in-process snapshot (its ``ready`` event; none off the card)."""
        ev = snap.get("ready")
        if ev is not None:
            torch.cuda.current_stream(self.device).wait_event(ev)

    def _release_handoff(self, req) -> None:
        """The snapshot-lifetime rule's consumer half: ``req``'s terminal
        item has been landed or dropped — hand its engine lane back with
        an event recorded on the ring's stream after the copies queued
        so far (a remote pod's payloads are host copies: nothing to
        release)."""
        ex = self.executor
        if ex.prefill_remote:
            return
        ev = None
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
        ex.prefill_exec.release(req, ev)

    def _land_handoff_blocks(self, slot: int, payload, lane, j0: int,
                             j1: int) -> None:
        """Upload one handoff block group ``[j0, j1)`` into the lane's
        reserved decode-pool blocks: the promote scatter for a remote
        (host) payload, whose arrays start at block ``j0``; the in-place
        frame transfer from engine lane ``lane``'s blocks for an
        in-process snapshot, queued behind the engine's event.  Shared by
        streamed frames and the terminal item's remainder; both are
        queued on the ring's stream and overlap the decoding chunk."""
        if j1 <= j0:
            return
        ex = self.executor
        dst = self.pool.table[slot][j0:j1]
        if ex.prefill_remote:
            keys = ("k", "v", "ks", "vs") if ex.quant else ("k", "v")
            ex._promote_blocks(dst, {key: payload[key] for key in keys})
            return
        self._await_snapshot(payload)
        src = ex.prefill_exec.tables[lane][j0:j1]
        ex._frame_transfer(ex.cache, payload,
                           X.to_device(src, self.device).long(),
                           X.to_device(dst, self.device).long())

    def _land_remote_tail(self, slot: int, payload) -> None:
        """A REMOTE handoff's (int8) staging tail: the wire payload's
        exact tail row lands in decode tail row ``slot``."""
        c = self.executor.cache
        for key in ("kt", "vt"):
            c[key][:, slot].copy_(
                X.to_device(payload[key][:, 0], self.device))

    def _drain_handoffs(self) -> None:
        """Attach completed disaggregated prefills: copy the blocks into
        the lane's already-mapped decode-pool blocks, then one small
        attach of the lane state.  Results for requests that resolved
        meanwhile (cancel, deadline, heal) are dropped — their decode
        blocks were retired with the lane.

        Every engine and the remote client end a job in one terminal
        ``("final", req, slot, payload, lane, j0, n_blocks, first,
        t_done)`` — blocks ``[j0, n_blocks)``, the (int8) staging tail
        and the first token — or ``(req, slot, error)``.  Streamed
        handoff: the N-lane engine (and the streaming remote client)
        post ``("frame", req, slot, payload, lane, j0, j1)`` block
        groups before it, WHILE the prompt is still prefilling, so the
        upload overlaps the remaining prefill.  Frames of a resolved
        request drop like stale results; a retried remote stream
        re-uploads from block 0 (uploads are idempotent by
        destination).  Every in-process terminal item, landed or
        dropped, releases its engine lane (:meth:`_release_handoff`)."""
        ex = self.executor
        pexec = ex.prefill_exec
        if self.handoff_gate is not None:
            self.handoff_gate()
        while True:
            try:
                item = pexec.results.get_nowait()
            except queue.Empty:
                return
            error = not isinstance(item[0], str)    # (req, slot, error)
            req, slot = item[:2] if error else item[1:3]
            try:
                self._land_item(item, error, req, slot)
            finally:
                if error or item[0] == "final":
                    self._release_handoff(req)

    def _land_item(self, item, error: bool, req, slot: int) -> None:
        """One handoff item of :meth:`_drain_handoffs`."""
        ex = self.executor
        if (self._disagg_waiting.get(slot) is not req
                or self.lane[slot] is not req or req.done.is_set()):
            return                      # stale frame or result: drop
        if error:
            del self._disagg_waiting[slot]
            self._finish(req, item[2])
            self._evict(slot)
            return
        if item[0] == "frame":
            _, _, _, payload, lane, j0, j1 = item
            t_fr0 = time.monotonic()
            self._land_handoff_blocks(slot, payload, lane, j0, j1)
            self.stats["handoff_frames"] += 1
            self._handoff_frame_t.setdefault(slot, []).append(
                time.monotonic())
            if req.trace is not None:
                # host time of the frame's upload dispatch (queued: it
                # overlaps the decoding chunk)
                req.trace.add("handoff_frame", t_fr0, j0=j0, j1=j1)
            return
        _, _, _, payload, lane, j0, n_blocks, first, t_done = item
        del self._disagg_waiting[slot]
        # a remote payload is the wire envelope's HOST arrays, landed
        # through the promote scatter (codes and scales verbatim under
        # int8) with the exact tail row
        self._land_handoff_blocks(slot, payload, lane, j0, n_blocks)
        if ex.quant:
            if ex.prefill_remote:
                self._land_remote_tail(slot, payload)
            else:
                ex._tail_copy(ex.cache, payload, lane, slot)
        stamps = self._handoff_frame_t.pop(slot, [])
        self.stats["overlapped_frames"] += sum(1 for t in stamps
                                               if t < t_done)
        if ex.prefill_remote:
            self.stats["remote_prefills"] += 1
        self._attach_handoff(slot, req, len(req.prompt), first)

    def _attach_handoff(self, slot: int, req: _Request, n: int,
                        first) -> None:
        """The handoff's decode-side tail, shared by the in-process
        (device block copy) and remote (promote upload) paths: one small
        attach — a speculative ring also prefills the DRAFT lane here,
        which is why a handoff never carries draft state — then publish
        and activate.  ``first``: a device scalar from an in-process
        engine (its memory is marked in use on the ring's stream) or a
        remote pod's int."""
        ex = self.executor
        t_att0 = time.monotonic()
        if req.trace is not None and req.t_prefill0 is not None:
            # the whole off-ring prefill phase: the engine's queue wait
            # and compute (and, remote, the wire) up to this attach
            req.trace.add("disagg_prefill", req.t_prefill0, t_att0,
                          remote=bool(ex.prefill_remote))
        if isinstance(first, torch.Tensor):
            if first.is_cuda:
                first.record_stream(torch.cuda.current_stream(self.device))
        else:
            first = torch.tensor(int(first), dtype=torch.int32)
        if self.spec_k:
            ex.spec_attach(req.bucket)(
                ex.draft_params, ex.dcache, ex.cache, ex.tok, ex.temp,
                ex.seeds, req.dev_prompt, n, slot, first,
                float(req.temperature), req.seed)
        else:
            ex._attach(ex.cache, ex.tok, ex.temp, ex.seeds, slot, first, n,
                       float(req.temperature), req.seed)
        self.stats["prefill_calls"] += 1
        self.stats["prefill_tokens"] += n
        self.stats["disagg_prefills"] += 1
        if req.trace is not None:
            req.trace.add("handoff_attach", t_att0, slot=slot)
        self.pool.publish(slot, req.prompt, ns=req.ns)
        self._activate(slot, req, first, draft=False)

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
            if req.trace is not None:
                req.trace.add("ttft", req.t_submit, now)
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
        if not req.done.is_set():
            # e2e latency: successful resolutions only (deadline
            # partials included)
            if req.error is None:
                self.hist.e2e.observe(
                    (time.monotonic() - req.t_submit) * 1e3)
            if req.trace is not None:
                req.trace.finish(
                    error=(type(req.error).__name__
                           if req.error is not None else None))
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
        # drops its slice or handoff state; a late disaggregated result
        # is dropped by the identity check in _drain_handoffs
        self._prefilling.pop(slot, None)
        self._disagg_waiting.pop(slot, None)
        self._handoff_frame_t.pop(slot, None)
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
        first, then park order (FIFO within a class).  A lane whose
        envelope is on the wire to a peer is not restorable: resuming it
        here while the peer adopts it would decode the stream twice."""
        candidates = [p for p in self._parked if not p.migrating]
        if not candidates:
            return None
        return min(candidates, key=lambda p: (p.req.priority, p.seq))

    def _release_parked(self, pk: _ParkedLane) -> None:
        """Drop a parked lane; an unresolved request resolves with the
        tokens it had at the spill boundary."""
        self._parked.remove(pk)
        self.executor.drop_spill(pk.spill)
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
        mid-prefill (chunked) or awaiting their disaggregated handoff,
        which are never preemption victims and never step in a
        dispatch."""
        return set(self._prefilling) | set(self._disagg_waiting)

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
        t_sp0 = time.monotonic()
        spill = self.executor.spill_lane(slot)
        if req.trace is not None:
            req.trace.add("spill", t_sp0, pos=int(self._lane_pos[slot]))
        self.flightrec.record("preempt", rid=req.request_id, slot=slot,
                              prio=req.priority)
        self._park_seq += 1
        self._parked.append(_ParkedLane(
            req, spill, self._lane_out[slot], self._lane_left[slot],
            self._lane_pos[slot], self._park_seq, self.generation))
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
        t_rs0 = time.monotonic()
        try:
            self.executor.restore_lane(slot, pk.spill)
        except self.executor._pg.NoFreeBlocks:
            self.pool.retire(slot)  # roll back ensure's partial mapping
            return False
        if req.trace is not None:
            req.trace.add("restore", t_rs0, slot=slot)
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

    def handoff_fingerprint(self) -> Dict[str, Any]:
        """The geometry and sampling rule a remote-prefill HANDOFF must
        match (infer/prefill_serve.py ``handoff_fingerprint``, the JAX
        ring's dict key for key): narrower than the store fingerprint —
        spec depth is absent (the draft lane prefills decode-side at
        attach) and top-k/top-p are PRESENT (the pod samples the first
        token)."""
        from paddle_operator_tpu_torch.infer.prefill_serve import (
            handoff_fingerprint,
        )

        return handoff_fingerprint(
            self.cfg, block_size=self.executor.block_size,
            kv_quant=self.kv_quant, top_k=self._top_k, top_p=self._top_p,
            wquant=self.weight_quant_mode(), generation=self.generation)

    def attach_kv_store(self, store) -> None:
        """Wire the durable prefix store (infer/kvstore.KVBlockStore)
        into both halves: the POOL's spill path (tier overflow persists,
        its radix nodes surviving store-resident) and the SUBMIT probe.
        Requires the paged pool with the host tier (so never on a
        tensor-parallel ring)."""
        if self.pool is None or self.pool.host is None:
            raise ValueError(
                "KV store requires paged attention with the host cache "
                "tier (host_cache_blocks > 0)")
        self.pool.attach_store(store)
        self.kv_store = store

    def _maybe_peer_fetch(self, prompt) -> None:
        """Submit-thread prefix probe, order peer -> store: when the
        prompt's full-block chain is not covered locally (an entry counts
        only if SERVABLE — device or host resident; a store-resident node
        is exactly what the probe re-fills), ask the fleet for its
        demoted blocks (one bounded HTTP round trip on the caller's
        thread, never the ring's) and, on a peer miss, read the missing
        blocks from the store (a bounded disk read).  Either hit queues
        the payloads for import ahead of the request, so its admission
        host-hits them."""
        from paddle_operator_tpu_torch.utils import fleetkv as FK
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
        # the seen-cache dedupes the PEER round trip only (one ask per
        # distinct chain); the store probe stays outside it: a clean
        # miss costs one file stat, and a store-resident node exists to
        # be probed again
        tail = keys[-1]
        seen = tail in self._peer_fetch_seen
        if seen:
            self._peer_fetch_seen.move_to_end(tail)
        else:
            self._peer_fetch_seen[tail] = True
            while len(self._peer_fetch_seen) > 1024:
                self._peer_fetch_seen.popitem(last=False)
        if self.peer_fetch is not None and not seen:
            buf = self.peer_fetch(tokens, 0)
            if buf:
                meta, chunks, idx, payloads = FK.decode_prefix(buf)
                FK.check_fingerprint(meta, self._fingerprint())
                if idx:
                    self._host_imports.put((chunks, idx, payloads, 0))
                    self.stats["peer_prefix_fetches"] += 1
                    self._wake.set()
                    return
        if self.kv_store is None:
            return
        self.stats["kv_store_probes"] += 1
        chunks, idx, payloads, _fp = self.kv_store.fetch(
            tokens, bs, ns=0, skip=covered)
        if not idx:
            return
        self.stats["kv_store_hits"] += 1
        self._host_imports.put((chunks, idx, payloads, 0))
        self._wake.set()

    def _import_fetched(self) -> None:
        """Land the peer and store payloads fetched so far in the host
        tier and the radix (ring thread: the queue's only consumer).
        Called before each admission: a request's fetch is queued before
        the request, so its blocks are in the tier when it admits — and
        not earlier, where the demotes of the admissions before it could
        push them out again."""
        while not self._host_imports.empty():
            chunks, idx, payloads, ns = self._host_imports.get_nowait()
            if self.pool is not None:
                try:
                    self.pool.import_host_blocks(chunks, idx, payloads,
                                                 ns=ns)
                except Exception:
                    pass    # an import is an optimization, never a fault

    # -- fleet-level KV: lane migration ------------------------------------

    def _migration_meta(self, pk: _ParkedLane) -> Dict[str, Any]:
        """The JSON half of a lane envelope (the JAX ring's keys): the
        request's identity, its stream state, the REMAINING deadline
        (monotonic stamps are process-local: the adopter re-anchors it),
        the spans traced so far, and the ring fingerprint the adopter
        validates against."""
        req = pk.req
        return {"requestId": req.request_id,
                "prompt": [int(t) for t in req.prompt],
                "out": [int(t) for t in pk.out],
                "left": int(pk.left),
                "maxNew": int(req.max_new),
                "temperature": float(req.temperature),
                "seed": int(req.seed),
                "eos": req.eos,
                "priority": int(req.priority),
                "adapter": req.adapter,
                "deadlineS": (round(req.deadline - time.monotonic(), 3)
                              if req.deadline is not None else None),
                "trace": (req.trace.to_wire()
                          if req.trace is not None else None),
                "fingerprint": self._fingerprint()}

    def adopt(self, meta: Dict[str, Any],
              spill: Dict[str, Any]) -> _Request:
        """Adopt a migrated lane from a peer (the ``/v1/kv/restore``
        handler, on its own thread): validate the envelope against THIS
        ring, re-resolve the adapter by name, and queue the lane for the
        ring loop, which parks it and restores it through the preemption
        restore (``RingExecutor.restore_lane``, every write in place), so
        the resumed stream equals the unmigrated one.  Touches no device
        state and no lane.  Raises
        :class:`~paddle_operator_tpu_torch.utils.fleetkv.EnvelopeError`
        (409 upstream) on any mismatch — the origin then keeps the lane
        — and :class:`ShuttingDown` while draining."""
        from paddle_operator_tpu_torch.utils import fleetkv as FK

        if self.pool is None:
            raise FK.EnvelopeError(
                "lane adoption requires the paged ring (the spill is "
                "block-granular); this replica is contiguous")
        FK.check_fingerprint(meta, self._fingerprint())
        if self._draining or self._stop.is_set() or not self.healthy:
            raise ShuttingDown("replica not accepting migrations")
        left = int(meta["left"])
        if left <= 0:
            raise FK.EnvelopeError(
                "migrated lane has no remaining token budget")
        ex = self.executor
        m = int(spill["n_blocks"])
        if not 0 <= m <= self.pool.max_blocks:
            raise FK.EnvelopeError(
                f"lane carries {m} blocks; a lane here maps at most "
                f"{self.pool.max_blocks}")
        exp = (self.cfg.n_layers, m, self.cfg.n_kv_heads, ex.block_size,
               self.cfg.head_dim)
        pool_dtype = ex.cache["k"].dtype
        for name in ("k", "v"):
            got = spill[name]
            if tuple(got.shape) != exp:
                raise FK.EnvelopeError(
                    f"lane payload {name} shape {tuple(got.shape)} != "
                    f"expected {exp}")
            if got.dtype != pool_dtype:
                raise FK.EnvelopeError(
                    f"lane payload {name} dtype {got.dtype} != the "
                    f"pool's {pool_dtype}")
        if ex.quant:
            if not all(k in spill for k in ("ks", "vs", "kt", "vt")):
                raise FK.EnvelopeError(
                    "int8 ring: lane envelope missing scale/tail planes")
            tail = tuple(ex.cache["kt"][:, 0].shape)
            for name, want in (("ks", exp[:3]), ("vs", exp[:3]),
                               ("kt", tail), ("vt", tail)):
                if tuple(spill[name].shape) != want:
                    raise FK.EnvelopeError(
                        f"lane payload {name} shape "
                        f"{tuple(spill[name].shape)} != expected {want}")
        if ex.spec_k:
            if not all(k in spill for k in ("dk", "dv", "dpos")):
                raise FK.EnvelopeError(
                    "speculative ring: lane envelope missing draft lane")
            # the draft lane's rows are the draft ring's capacity, which
            # the fingerprint's specK does not pin
            want = tuple(ex.dcache["k"][:, 0].shape)
            for name in ("dk", "dv"):
                if tuple(spill[name].shape) != want:
                    raise FK.EnvelopeError(
                        f"lane payload {name} shape "
                        f"{tuple(spill[name].shape)} != expected {want}")
        adapter = meta.get("adapter")
        aidx = ns = 0
        if adapter:
            if self.adapters is None:
                raise FK.EnvelopeError(
                    f"adapter {adapter!r} is not served here "
                    "(no registry)")
            try:
                aidx, ns = self.adapters.resolve_ns(adapter)
            except ValueError as e:
                raise FK.EnvelopeError(str(e)) from None
        prompt = [int(t) for t in meta["prompt"]]
        out = [int(t) for t in meta.get("out", ())]
        dl = meta.get("deadlineS")
        req = _Request(prompt,
                       int(meta.get("maxNew", left + len(out))),
                       float(meta.get("temperature", spill["temp"])),
                       int(meta.get("seed", spill["seed"])),
                       meta.get("eos"),
                       deadline=(time.monotonic() + max(0.0, float(dl))
                                 if dl is not None else None))
        req.priority = min(max(0, int(meta.get(
            "priority", self.qos.default_priority))),
            self.qos.priorities - 1)
        req.adapter = adapter
        req.adapter_idx = aidx
        req.ns = ns if aidx else 0
        req.request_id = meta.get("requestId")
        # TTFT was produced (and observed) at the origin: pre-stamp
        # t_first, so this ring never counts the stream's first token
        req.t_first = time.monotonic()
        if self.tracer is not None:
            wire = meta.get("trace")
            if isinstance(wire, dict) and wire.get("spans"):
                # the same trace, parented on the ORIGIN's request root:
                # the stitched timeline stays one tree
                req.trace = self.tracer.begin(
                    ctx=(wire.get("traceId"), wire.get("rootId")),
                    request_id=req.request_id)
                req.trace.seed(wire["spans"])
            else:
                req.trace = self.tracer.begin(request_id=req.request_id)
            req.trace.add("adopt", time.monotonic(), blocks=m)
        self.flightrec.record("adopt", rid=req.request_id, blocks=m)
        spill = dict(spill)
        # adapter SLOT ids are replica-local: re-stamp with OUR slot
        if self.adapters is not None:
            spill["aid"] = aidx
        else:
            spill.pop("aid", None)
        pk = _ParkedLane(req, spill, out, left, int(spill["pos"]), 0,
                         self.generation)
        self.stats["adopted_lanes"] += 1
        self._adopt_q.put(pk)
        self._wake.set()
        return req

    def _kick_migration(self, pk: _ParkedLane) -> None:
        """Offer one parked lane to the fleet on a side thread (the POST
        never holds the ring thread).  The meta is taken here, on the
        ring thread, so its fingerprint is the generation the lane's KV
        was parked under."""
        pk.migrating = True
        pk.req.migrate_state = "inflight"
        meta = self._migration_meta(pk)
        threading.Thread(target=self._migrate_worker, args=(pk, meta),
                         daemon=True, name="kv-migrate").start()

    def _migrate_worker(self, pk: _ParkedLane, meta: Dict[str, Any]) -> None:
        ok = False
        try:
            ok = bool(self.migrate_out(meta, pk.spill))
        except Exception:
            ok = False
        self._migr_done.put((pk, ok))
        self._wake.set()

    def _pump_fleetkv(self, pending: List[tuple]) -> None:
        """One loop pass of fleet-KV work (ring thread): land adopted
        lanes in the parked list, apply migration outcomes, and —
        draining with migration on, or a parked lane past its patience —
        offer lanes to the fleet.  The drain parks every resident decode
        lane at THE boundary: every dispatch in flight is consumed first,
        so the spill holds exactly the tokens the stream has emitted."""
        # the loop is the only consumer of both queues: the empty()
        # checks are race-free
        while not self._adopt_q.empty():
            pk = self._adopt_q.get_nowait()
            if self._stop.is_set() or self._draining:
                # raced a shutdown: fail retriably, so the client's next
                # retry goes elsewhere
                self._finish(pk.req, ShuttingDown(
                    "replica shut down before the adopted lane ran"))
                continue
            self._park_seq += 1
            pk.seq = self._park_seq
            self._parked.append(pk)
        while not self._migr_done.empty():
            pk, ok = self._migr_done.get_nowait()
            if pk not in self._parked:
                continue    # healed away while on the wire
            self.flightrec.record("migrate_out", ok=bool(ok),
                                  rid=pk.req.request_id)
            if ok:
                self._parked.remove(pk)
                self.stats["lane_migrations"] += 1
                pk.req.migrate_state = "done"
                self._finish(pk.req, LaneMigrated(
                    "lane migrated to a peer replica; retry with the "
                    "same request_id to collect the result"))
            else:
                # refused or unreachable: resume here, never offered
                # again (completion-wait is the drain's fallback)
                pk.req.migrate_state = "failed"
                pk.migrating = False
        if self.migrate_out is None:
            return
        drain_migrate = (self._draining and self._migrate_on_drain
                         and self.pool is not None)
        if drain_migrate:
            prefill_pending = self._pending_prefill_slots()
            todo = [i for i, r in enumerate(self.lane)
                    if r is not None and i not in prefill_pending
                    and not r.done.is_set() and not r._cancel
                    and r.migrate_state is None and r._stream is None
                    and r.request_id is not None]
            if todo:
                try:
                    while pending:
                        self._consume_oldest(pending)
                    for i in todo:
                        r = self.lane[i]
                        if (r is not None and not r.done.is_set()
                                and r.migrate_state is None):
                            self._preempt(i)
                except Exception as e:      # a device fault: heal
                    self._fault = e
                    return
        now = time.monotonic()
        for pk in list(self._parked):
            r = pk.req
            if (pk.migrating or r.migrate_state is not None
                    or r.request_id is None or r._stream is not None
                    or r._cancel or r.done.is_set()
                    or pk.generation != self.generation):
                continue
            if drain_migrate or (
                    self.migrate_parked_s is not None
                    and self.migrate_parked_s > 0
                    and now - pk.t_parked >= self.migrate_parked_s):
                self._kick_migration(pk)

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

    def _scrub_lane_blocks(self, slot: int, req=None) -> None:
        """Clear lane ``slot``'s PRIVATE pool blocks (and, int8, its
        staging tail) before they return to the free list: a NaN row in
        a re-mapped block would poison the next lane through the masked
        contraction of the plain path (a masked column's probability is
        exactly 0, but 0 * NaN = NaN).  Published (radix-cached) blocks
        are skipped (``pool.private_blocks``): other admissions read
        them, and this lane cannot have written them.  With ``req``, the
        host tier's and the store's copies on its prompt's chain go too:
        they cannot be re-verified."""
        self.executor.scrub_lane(slot, self.pool.private_blocks(slot))
        if req is not None:
            self.pool.scrub_host_chain(req.prompt, ns=req.ns)

    def _consume(self, chunk_reqs, toks: np.ndarray,
                 counts: Optional[np.ndarray] = None,
                 spec_raw: Optional[np.ndarray] = None,
                 ok: Optional[np.ndarray] = None) -> None:
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
        fused round the lane sat out, which feeds no stat.

        ``ok`` (SERVE_NAN_CHECK): each lane's isfinite verdict for this
        chunk — a False lane is QUARANTINED: its request fails with
        :class:`LaneQuarantined`, its private blocks are scrubbed and
        freed, and no token of the poisoned chunk reaches a consumer.
        The other lanes are attention-independent, so their streams are
        unchanged."""
        now = time.monotonic()
        for i, req in chunk_reqs:
            if req is None or self.lane[i] is not req \
                    or req.done.is_set():
                continue
            if ok is not None and not bool(ok[i]):
                self.stats["quarantined_lanes"] += 1
                self.flightrec.record("nan_quarantine", lane=i,
                                      rid=req.request_id)
                if self.pool is not None:
                    self._scrub_lane_blocks(i, req)
                self._finish(req, LaneQuarantined(
                    f"lane {i} produced non-finite logits; request "
                    "failed, lane quarantined (ring unaffected)"))
                self._evict(i)
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
            ok = res.ok_host()
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
        # decode spans: one a consumed dispatch a traced lane, dispatch to
        # the end of the completion wait (megastep-granular; the span cap
        # bounds a long generation)
        if any(r is not None and r.trace is not None
               for _, r in chunk_reqs):
            t1 = time.monotonic()
            for _, r in chunk_reqs:
                if r is not None and r.trace is not None:
                    r.trace.add("decode_dispatch", t0, t1,
                                steps=res.n_steps)
        if self._fault is not None:
            return              # stall-failed chunks must not apply
        if counts is None:
            self._consume(chunk_reqs, toks, ok=ok)
            return
        # fused megastep: apply the N boundaries in order — each is one
        # 1-step consume with the eos/budget walk the device precomputed
        # (counts); a lane evicted at boundary r drops out of rounds
        # r+1.. through the chunk_reqs identity guard
        for r in range(res.n_steps):
            self._consume(chunk_reqs, toks[r], counts=counts[r],
                          spec_raw=None if raw is None else raw[r],
                          ok=None if ok is None else ok[r])

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
            # disaggregated prefills that completed since the last pass:
            # block copy and attach.  Gated on the ENGINE, not on
            # _disagg_waiting: a result posted for an evicted request
            # must still be popped, dropped and its engine lane released
            if ex.prefill_exec is not None:
                try:
                    self._drain_handoffs()
                except Exception as e:
                    self._fault = e
                    continue
            # a posted live swap fires at THE quiesced boundary: every
            # dispatch in flight consumed, no lane mid-prefill or awaiting
            # its handoff (the admissions pause below while it is
            # pending, so both drain within a few passes)
            if (self._swap_req is not None and not self._prefilling
                    and not self._disagg_waiting):
                try:
                    while pending:
                        self._consume_oldest(pending)
                except Exception as e:
                    self._fault = e
                    continue
                if self._fault is None:
                    self._do_swap()
                continue
            if self._draining:
                self._shed_queue(ShuttingDown(
                    "server draining; retry another replica"))
            # fleet-level KV: adopted lanes land, migration outcomes
            # apply, and — draining with migration on — the residents
            # park and are offered out
            self._pump_fleetkv(pending)
            if self._fault is not None:
                continue
            self._expire_deadlines()
            # cancelled lanes leave at the chunk boundary
            for i, r in enumerate(self.lane):
                if r is not None and r._cancel:
                    self._evict(i)
            # parked lanes honor cancel too, without waiting for a lane
            # (one on the wire waits for its outcome first)
            for pk in list(self._parked):
                if pk.migrating:
                    continue
                if pk.req._cancel or pk.req.done.is_set():
                    self._release_parked(pk)
            # admit into free lanes: parked (preempted) lanes resume
            # ahead of queued work of the same class — they were admitted
            # first and already hold tokens — and queued work pops in
            # class-then-FIFO order.  Restores run even while draining:
            # a parked lane is admitted work the drain promises to finish
            while any(r is None for r in self.lane):
                if self._swap_req is not None:
                    # a swap is pending: admissions and restores wait,
                    # so the quiesce converges; both resume after it
                    break
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
                t_admit0 = time.monotonic()
                try:
                    self._admit(slot, req)
                    if req.trace is not None:
                        # the admission's host time (inline: the insert;
                        # chunked: the block map, the slices have their
                        # own spans)
                        req.trace.add("admit", t_admit0, slot=slot,
                                      mode=self.prefill_mode)
                except Exception as e:          # bad request: fail it only
                    self._finish(req, e)
                    self.lane[slot] = None
                    ex.set_aid(slot, 0)
                    self._lane_pos[slot] = 0
                    self._lane_first[slot] = None
                    self._prefilling.pop(slot, None)
                    self._disagg_waiting.pop(slot, None)
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
