"""Device half of the serving ring — the port of
``paddle_operator_tpu/infer/executor.py``: the ring's step and
admission programs, its KV cache (contiguous ring or paged pool) and
the per-lane tok/temp/seed state.  ``infer/scheduler.py`` holds no
tensors of its own; it sequences work on :class:`RingExecutor`.

In PyTorch's idiom: the cache and lane state are device tensors
updated IN PLACE (where the JAX programs took donated buffers and
returned new ones), layers and ticks are Python loops (the JAX
``scan``s), and the ``make_*`` functions return plain callables — there
is nothing to compile.  What stays is everything that changes
behaviour: the per-lane positions, the trash-block and zeroed-position
rules for inactive lanes, the block-rounded prefill writes, the
suffix-hit cap and the shared sampling rule.

One sampling rule differs by necessity: ``jax.random`` cannot be
reproduced, so :func:`_sample_tokens` draws Gumbel noise from a
counter-based hash of (seed, position, vocab id).  A lane's sampled
stream still depends only on (seed, position) — never on its
co-residents — and greedy (temperature 0) stays exact.

The paged ring carries the bf16 pool and the int8 pool
(``kv_quant="int8"``, SERVE_KV_QUANT).  Every resident decode dispatch
runs through :meth:`RingExecutor.replay`: the 1-step chunk, or the
megastep (SERVE_MEGASTEP: ``n_steps`` chunks fused into one dispatch,
with the eos, token-budget and step-budget decisions made on the
device by :func:`_mega_continue`).  On the card each of the two
programs is replayed as a CUDA graph, the port's form of the JAX
package's ``jax.jit`` of the same program; on the CPU the same programs
run eagerly.  A paged lane can be spilled to host memory and restored
into any free slot (:meth:`RingExecutor.spill_lane`,
:meth:`RingExecutor.restore_lane`: the preemption primitive), between
replays and in place, so the graphs keep their addresses.

With the host spill tier on (``host_cache_blocks``), demoted blocks live
in ONE host slab (:class:`HostSlab`: page-locked on the card, allocated
once when the ring is built, one slot per block): a demote queues a
slice of the pool and a non-blocking device-to-host copy into a free
slot on the ring's stream (:meth:`RingExecutor._demote_fetch`), and a
promote queues non-blocking copies out of the slots and the in-place
promote scatter (:meth:`RingExecutor.dispatch_promotions`) — neither
waits for the device nor pins host memory.

Chunked prefill (SERVE_PREFILL=chunked) admits a prompt in
``prefill_chunk``-row slices run eagerly between the replays:
:meth:`RingExecutor.chunk_prog` appends a slice's KV (a private staging
lane on the contiguous ring, the lane's blocks on the paged pools) and
:meth:`RingExecutor.final_insert` runs the last slice, samples the first
token and activates the lane, every write in place.

Speculative decoding (``spec_k``, SERVE_SPEC_K; infer/speculative.py)
replaces the chunk step with the round: the draft's K+1 propose ticks
on its own contiguous ring (``dcache``, beside the target's cache of
either kind), the target's multi-row verify, the acceptance and the
rewind, each dispatch (a round, or N rounds fused) replayed as a CUDA
graph; the admissions prefill the draft lane too, and a spilled lane
carries it.

Many-adapter serving (``adapters``: an infer/qos.py ``AdapterRegistry``)
threads ``lora=(stacks, aid)`` through every program: the registry's
fixed stacks and a per-lane adapter-slot buffer ``RingExecutor.aid``
(device int32, written in place by admission, eviction, restore and a
heal), so a batch of lanes on different adapters is one dispatch, one
CUDA graph replay on the card.

Disaggregated prefill (SERVE_PREFILL=disagg) moves cold prompts off the
ring's stream: :class:`PrefillExecutor` prefills them on its own thread,
CUDA stream and block pool (one lane, or N chunk-interleaved lanes), and
the ring lands each result by an in-place block copy into the lane's
reserved blocks (``paged.make_pool_frame_transfer``, and on the int8
pool ``paged.make_pool_tail_copy``, queued on the ring's stream behind
the engine's event) and a
tiny attach (:func:`make_attach_lane`; :func:`make_spec_attach` on a
speculative ring).  A remote prefill pod's result lands through the
promote scatter instead.
"""

from __future__ import annotations

import gc
import queue
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from paddle_operator_tpu_torch.infer import decode as D
from paddle_operator_tpu_torch.infer import quant as Q
from paddle_operator_tpu_torch.infer.qos import layer_lora
from paddle_operator_tpu_torch.models.llama import LlamaConfig
from paddle_operator_tpu_torch.ops.decode_attention import (
    decode_attention,
    paged_decode_attention,
    sharded_decode_attention,
)
from paddle_operator_tpu_torch.ops.quant_matmul import quant_gemm, quant_matmul


class ExecPlan:
    """One resident ring dispatch, fully described host-side: the
    scheduler FILLS a plan and :meth:`RingExecutor.replay` executes it.

    - ``n_steps``  fused ring iterations (1: the chunk step; N > 1: the
      megastep);
    - ``active``   per-lane participation (host bools, [slots]);
    - ``table``    block-table snapshot (np [slots, M]; None on the
      contiguous ring);
    - ``eos``      per-lane eos token id, -1 for none (np int32);
    - ``left``     per-lane remaining token budget: what the device may
      still emit (the admission-sampled first token, if still
      unmaterialized, is already subtracted);
    - ``steps``    per-lane max fused iterations this dispatch (the
      deadline-tick budget; ``n_steps`` when unconstrained).

    ``eos``/``left``/``steps`` are only consulted when ``n_steps > 1``."""

    __slots__ = ("n_steps", "active", "table", "eos", "left", "steps")

    def __init__(self, n_steps, active, table=None, eos=None, left=None,
                 steps=None):
        self.n_steps = int(n_steps)
        self.active = active
        self.table = table
        self.eos = eos
        self.left = left
        self.steps = steps


class DispatchResult:
    """What one :meth:`RingExecutor.replay` returns — the scheduler's
    pipelining queue holds it until the consume boundary.  ``toks`` is
    the device tensor [chunk, B] at ``n_steps`` 1 and [n, chunk, B]
    fused; ``counts`` [n, B] the rows of each fused boundary the host
    consumes (None at ``n_steps`` 1, where every row is valid).  A
    speculative ring's dispatch is always shaped as fused: ``toks`` [n,
    K+1, B] committed tokens, ``counts`` [n, B] and ``raw`` [n, B], each
    round's device commit count (the acceptance telemetry; ``counts``
    equals it at ``n_steps`` 1).  On the card their copies to pinned
    host memory are queued right behind the dispatch (``_host``,
    ``_event``), so the consume waits for THIS dispatch only, never for
    the one dispatched after it.  Under a CUDA graph the device tensors
    are the graph's static outputs, which the next replay overwrites:
    read them through the host copies.  ``ok`` (a ring with
    ``check_finite``): each lane's isfinite verdict, [B] at ``n_steps``
    1 and [n, B] fused; None otherwise."""

    __slots__ = ("toks", "counts", "raw", "ok", "n_steps", "_host",
                 "_event")

    def __init__(self, toks, counts, n_steps, raw=None, ok=None):
        self.toks = toks
        self.counts = counts
        self.raw = raw
        self.ok = ok
        self.n_steps = n_steps
        self._host, self._event = _to_host_async(
            *(t for t in (toks, counts, raw, ok) if t is not None))

    def _at(self, name: str) -> Optional[np.ndarray]:
        """Output ``name``'s host copy, None when the dispatch has no
        such output."""
        present = [k for k in ("toks", "counts", "raw", "ok")
                   if getattr(self, k) is not None]
        if name not in present:
            return None
        return self._host[present.index(name)].numpy()

    def host(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """``(toks, counts)`` on the host — the ring's one sync."""
        if self._event is not None:
            self._event.synchronize()
        return self._at("toks"), self._at("counts")

    def raw_host(self) -> Optional[np.ndarray]:
        """``raw`` on the host (after :meth:`host`), None off a
        speculative ring."""
        return self._at("raw")

    def ok_host(self) -> Optional[np.ndarray]:
        """``ok`` on the host (after :meth:`host`), None without the
        check."""
        return self._at("ok")


def _to_host_async(*ts: torch.Tensor):
    """Queue device->host copies of ``ts`` into pinned memory on the
    current stream and return ``(host_tensors, event)``; the host
    tensors are valid once the event completes.  CPU tensors come back
    as they are, with no event."""
    if ts[0].device.type != "cuda":
        return list(ts), None
    hosts = []
    for t in ts:
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        hosts.append(host)
    ev = torch.cuda.Event(blocking=True)
    ev.record()
    return hosts, ev


def to_device(arr, device, dtype=None) -> torch.Tensor:
    """Host array or CPU tensor -> device tensor without a stream sync:
    on the card the copy goes through pinned memory (a tensor already
    pinned is used as it is), asynchronously, in stream order (a
    pageable copy would wait for every queued chunk)."""
    t = (arr if isinstance(arr, torch.Tensor)
         else torch.as_tensor(np.ascontiguousarray(arr)))
    if dtype is not None:
        t = t.to(dtype)
    if torch.device(device).type != "cuda" or t.device.type == "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


class HostBlock(dict):
    """One demoted block's payload in the host tier: the JAX payload's
    keys (``k``/``v`` [L, 1, H_kv, bs, D]; ``ks``/``vs`` [L, 1, H_kv] on
    the int8 pool), each a view of one slot of a :class:`HostSlab`.
    ``hold``/``release`` count the slot's owners (the tier, a pending
    promote, the store's writer); the slot returns to the free list at
    zero.  ``wait`` returns once the slot's last queued copy landed."""

    __slots__ = ("slab", "slot")

    def hold(self) -> None:
        self.slab.hold(self.slot)

    def release(self) -> None:
        self.slab.release(self.slot)

    def wait(self) -> None:
        self.slab.wait(self.slot)


class HostSlab:
    """The host tier's memory: ONE allocation of ``n_slots`` block-sized
    slots, made when the ring is built and page-locked on the card
    (``cudaHostRegister`` over one pageable allocation, so the bytes
    pinned are the bytes asked for), so demotes and promotes are
    asynchronous copies that never pin host memory afterwards.
    ``boot_s`` is what the allocation and the pinning cost.

    ``layout``: ``[(name, shape, dtype)]`` of one slot's arrays.  Slot
    reuse is stream-ordered: a demote (a device write into the slot)
    and a promote (a device read) are queued on the ring's stream, and
    every slot remembers the event after its last queued copy, which a
    HOST access of the slot (the store writer's read, an import's
    write) waits for.  When no slot is free, ``reclaim`` (the durable
    store's :meth:`~paddle_operator_tpu_torch.infer.kvstore.KVBlockStore.
    shed_oldest`) gives one back."""

    ALIGN = 256

    def __init__(self, n_slots: int, layout, pin: bool) -> None:
        t0 = time.perf_counter()
        self.n_slots = int(n_slots)
        self.layout = []
        off = 0
        for name, shape, dtype in layout:
            nbytes = int(np.prod(shape)) * torch.empty(
                0, dtype=dtype).element_size()
            self.layout.append((name, tuple(shape), dtype, off, nbytes))
            off += -(-nbytes // self.ALIGN) * self.ALIGN
        self.slot_bytes = off
        self.buf = torch.empty((self.n_slots, off), dtype=torch.uint8)
        self.registered = False
        if pin:
            cudart = torch.cuda.cudart()
            err = cudart.cudaHostRegister(self.buf.data_ptr(),
                                          self.buf.numel(), 0)
            if int(err) != 0:
                raise RuntimeError(f"cudaHostRegister of the host tier's "
                                   f"{self.buf.numel()} bytes failed "
                                   f"({err})")
            self.registered = True
        self._views = [{name: self.buf[i, o:o + nb].view(dtype).view(shape)
                        for name, shape, dtype, o, nb in self.layout}
                       for i in range(self.n_slots)]
        self.refs = [0] * self.n_slots
        self.events: List[Any] = [None] * self.n_slots
        self.free = deque(range(self.n_slots))
        self._cv = threading.Condition()
        self.reclaim = None
        self.boot_s = time.perf_counter() - t0

    def nbytes(self) -> int:
        return self.n_slots * self.slot_bytes

    def acquire(self, timeout: float = 30.0) -> HostBlock:
        """A free slot as a :class:`HostBlock` (one owner).  A full slab
        first asks ``reclaim`` for a slot, then waits for a holder (the
        store's writer copying a slot out) to release one; it raises
        when nothing can free a slot."""
        deadline = time.monotonic() + timeout
        while True:
            with self._cv:
                if self.free:
                    slot = self.free.popleft()
                    self.refs[slot] = 1
                    block = HostBlock(self._views[slot])
                    block.slab, block.slot = self, slot
                    return block
            if self.reclaim is not None and self.reclaim():
                continue
            with self._cv:
                left = deadline - time.monotonic()
                if (self.reclaim is None or left <= 0
                        or not self._cv.wait_for(lambda: bool(self.free),
                                                 timeout=left)):
                    raise RuntimeError(
                        f"host tier slab exhausted: all {self.n_slots} "
                        "slots are held")

    def hold(self, slot: int) -> None:
        with self._cv:
            self.refs[slot] += 1

    def release(self, slot: int) -> None:
        with self._cv:
            if self.refs[slot] <= 0:
                raise AssertionError(f"host slot {slot} released twice")
            self.refs[slot] -= 1
            if not self.refs[slot]:
                self.free.append(slot)
                self._cv.notify_all()

    def mark(self, slots) -> None:
        """Record, for ``slots``, the copies just queued on the current
        stream (no-op off the card)."""
        if not self.registered:
            return
        ev = torch.cuda.Event()
        ev.record()
        for slot in slots:
            self.events[slot] = ev

    def wait(self, slot: int) -> None:
        ev = self.events[slot]
        if ev is not None:
            ev.synchronize()

    def close(self) -> None:
        """Unpin and drop the slab (the ring is closing): waits for the
        card, so no copy is in flight over the memory."""
        if self.buf is None:
            return
        if self.registered:
            torch.cuda.synchronize()
            torch.cuda.cudart().cudaHostUnregister(self.buf.data_ptr())
            self.registered = False
        self.buf = None
        self._views = []
        self.events = [None] * self.n_slots


# ---------------------------------------------------------------------------
# Per-lane-position forward step
# ---------------------------------------------------------------------------


def init_ring_cache(cfg: LlamaConfig, slots: int, max_len: int, *,
                    device="cuda") -> Dict[str, torch.Tensor]:
    """KV ring: like decode.init_cache (same head-major layout,
    block-aligned allocation) but with a per-lane fill position vector
    (int32, on the device) instead of one host int."""
    if max_len > cfg.max_seq_len:
        raise ValueError(f"max_len {max_len} exceeds the RoPE table "
                         f"(cfg.max_seq_len={cfg.max_seq_len})")
    alloc = D.cache_alloc_len(max_len)
    shape = (cfg.n_layers, slots, cfg.n_kv_heads, alloc, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "pos": torch.zeros((slots,), dtype=torch.int32, device=device),
    }


def _write_lane(cache_l: torch.Tensor, kv: torch.Tensor,
                pos: torch.Tensor) -> None:
    """One layer's cache [B, H, S, D] <- [B, H, D] new row at per-lane
    ``pos``, in place (one indexed write for every lane).  A position
    past the allocation — a pipelined overshoot row — lands in the last
    row, as the JAX dynamic_update_slice clamps."""
    b = kv.shape[0]
    p = torch.clamp(pos.long(), max=cache_l.shape[2] - 1)
    cache_l[torch.arange(b, device=kv.device), :, p] = kv.to(cache_l.dtype)


def _qkv_ring(cfg: LlamaConfig, lp, x: torch.Tensor, cos: torch.Tensor,
              sin: torch.Tensor, pos: torch.Tensor, lora=None):
    """Pre-attention half for ONE new token per lane at per-lane
    positions ``pos`` [B]: RMSNorm -> projections (+ each lane's LoRA
    delta with ``lora=(adp_l, aid)``, one layer's stacks and the
    per-LANE slots, decode._proj) -> RoPE at each lane's own position.
    Shapes [B, 1, H, D].  Positions past the RoPE table (pipelined
    overshoot of a finished lane) read its last row, as the JAX gather
    clamps."""
    b = x.shape[0]
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = D._rms(x, lp.attn_norm.scale, cfg.norm_eps, cfg.dtype)
    q, k, v = D._proj(cfg, lp, h, lora)
    q = q.reshape(b, 1, hq, d)
    k = k.reshape(b, 1, hkv, d)
    v = v.reshape(b, 1, hkv, d)
    p = torch.clamp(pos.long(), max=cos.shape[0] - 1)
    cos_b = cos[p][:, None, None, :]            # [B, 1, 1, d/2]
    sin_b = sin[p][:, None, None, :]

    def rot(t):
        t1, t2 = t.float().chunk(2, dim=-1)
        return torch.cat([t1 * cos_b - t2 * sin_b, t2 * cos_b + t1 * sin_b],
                         dim=-1).to(t.dtype)

    return rot(q), rot(k), v


def _layer_step(cfg: LlamaConfig, lp, x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, pos: torch.Tensor,
                lora=None) -> torch.Tensor:
    """One decoder layer for ONE new token per lane ([B, 1, dim] at lane
    positions ``pos``) with the plain einsum attention over the whole
    lane (masked past ``pos``); writes the layer's cache in place."""
    b = x.shape[0]
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _qkv_ring(cfg, lp, x, cos, sin, pos, lora)
    _write_lane(k_cache, k[:, 0], pos)
    _write_lane(v_cache, v[:, 0], pos)
    n_rep = hq // hkv
    max_len = k_cache.shape[2]
    qg = q.reshape(b, 1, hkv, n_rep, d)
    scores = torch.einsum("bthrd,bhsd->bthrs", qg.float(),
                          k_cache.float()) / (float(d) ** 0.5)
    # lane b may attend cache cols [0, pos_b] (its own new row incl.)
    mask = (torch.arange(max_len, device=x.device)[None, :]
            <= pos[:, None].long())
    scores = scores.masked_fill(~mask[:, None, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bthrs,bhsd->bthrd", probs.to(cfg.dtype).float(),
                       v_cache.float())
    out = out.reshape(b, 1, hq * d).to(cfg.dtype)
    return D._finish_layer(cfg, lp, x, out)


def _ring_forward(cfg: LlamaConfig, params, tok: torch.Tensor,
                  cache: Dict[str, torch.Tensor], lora=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tok [B] at per-lane cache['pos'] -> (logits [B, V] f32, cache
    written in place with ``pos + 1``).  With the kernel selected (a
    CUDA tensor) each layer's attention and wo are
    ``sharded_decode_attention`` over the stacked cache with lengths
    ``pos + 1`` — kernel #1 serves the contiguous ring as it serves
    batch decoding.  ``lora``: ``(stacks, aid [B])``, each lane's
    adapter (infer/qos.py)."""
    pos = cache["pos"]
    x = D._embed(cfg, params, tok[:, None])
    cos, sin = params.rope_cos, params.rope_sin
    cfg = D._local(cfg, params)
    k_cache, v_cache = cache["k"], cache["v"]
    if cfg.resolved_decode_attn(x.device) == "kernel":
        # kernel #1 on the rank's heads (all of them on one card), wo's
        # rows and, on a serving mesh, the all-reduce: JAX's shard_map
        # region
        group = D._attn_group(D._shard_of(params))
        lengths = pos + 1
        for li, lp in enumerate(params.layers):
            q, k, v = _qkv_ring(cfg, lp, x, cos, sin, pos,
                                layer_lora(lora, li))
            _write_lane(k_cache[li], k[:, 0], pos)
            _write_lane(v_cache[li], v[:, 0], pos)
            proj = sharded_decode_attention(
                q[:, 0].contiguous(), k_cache, v_cache, lengths, lp.attn.wo,
                group=group, layer=li, compute_dtype=cfg.dtype)
            x = D._ffn_residual(cfg, lp, x + proj[:, None].to(cfg.dtype))
    else:
        for li, lp in enumerate(params.layers):
            x = _layer_step(cfg, lp, x, cos, sin, k_cache[li], v_cache[li],
                            pos, layer_lora(lora, li))
    logits = D._logits(cfg, params, x)
    return logits[:, 0], {"k": k_cache, "v": v_cache, "pos": pos + 1}


# ---------------------------------------------------------------------------
# Sampling: counter-based Gumbel noise
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 ``x`` in [0, 2**32), exact on every
    device: the constant is split into 16-bit halves so no product
    overflows int64."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + ((x * hi) & 0xFFFF) * 65536) & _M32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer finalizer (xor-shift-multiply, "lowbias32")."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def _uniform(seeds: torch.Tensor, pos: torch.Tensor, n: int) -> torch.Tensor:
    """[B, n] uniforms in (0, 1), a pure function of each lane's (seed,
    position) and the column — computed on the device, no generator
    state, so a lane's draws never depend on its co-residents or on how
    many other lanes sampled before it."""
    s = _mix32((seeds.long() & _M32) ^ 0x9E3779B9)
    s = _mix32(s ^ (pos.long() & _M32))
    ids = torch.arange(n, device=seeds.device, dtype=torch.int64)
    h = _mix32((s[:, None] + _mul32(ids, 0x85EBCA6B)[None, :]) & _M32)
    h = _mix32(h ^ 0x27D4EB2F)
    return (h >> 8).float() * (2.0 ** -24) + 2.0 ** -25


def _gumbel(seeds: torch.Tensor, pos: torch.Tensor,
            vocab: int) -> torch.Tensor:
    """[B, V] standard Gumbel noise of (seed, position, vocab id), from
    :func:`_uniform`."""
    return -torch.log(-torch.log(_uniform(seeds, pos, vocab)))


def _stream(seeds: torch.Tensor, stream: int) -> torch.Tensor:
    """The seeds of sampling stream ``stream`` (1, 2, 3, ...): each
    lane's seed hashed with the stream id, so draws keyed on a stream's
    seeds are independent of stream 0 (the seeds themselves, which
    :func:`_sample_tokens` uses) and of every other stream — the port's
    form of ``jax.random.fold_in(key, stream)``."""
    return _mix32((seeds.long() & _M32) ^ (stream * 0x632BE5AB & _M32))


def _sample_tokens(logits: torch.Tensor, temp: torch.Tensor,
                   seeds: torch.Tensor, pos: torch.Tensor,
                   top_k: Optional[int], top_p: Optional[float]
                   ) -> torch.Tensor:
    """THE per-lane sampling rule — shared by the chunk step and every
    admission insert.  logits [B, V] f32, temp [B], seeds [B], pos [B]
    -> [B] int32: greedy at temp 0, else the Gumbel-max draw of the
    temperature + top-k/top-p filtered logits (a categorical sample)
    with :func:`_gumbel` noise of (seed, pos)."""
    greedy = logits.argmax(-1).to(torch.int32)
    filt = D._filter_logits(
        logits / torch.clamp(temp, min=1e-6)[:, None], top_k, top_p)
    drawn = (filt + _gumbel(seeds, pos, logits.shape[-1])).argmax(-1)
    return torch.where(temp > 0, drawn.to(torch.int32), greedy)


# ---------------------------------------------------------------------------
# Resident step + admission (contiguous ring)
# ---------------------------------------------------------------------------


def _ticks(forward, cache: Dict[str, torch.Tensor], tok: torch.Tensor,
           temp: torch.Tensor, seeds: torch.Tensor, mask: torch.Tensor,
           chunk_tokens: int, top_k: Optional[int], top_p: Optional[float],
           check_finite: bool = False):
    """``chunk_tokens`` ring ticks — the body every resident program
    shares (contiguous or paged, 1-step or fused).  ``forward(tok,
    cache) -> (logits, cache')`` is one tick's forward; lanes outside
    ``mask`` compute (the price of fixed shapes) but their position is
    ZEROED each tick and their token held.  Returns ``(tok', toks
    [chunk, B])``; ``cache['pos']`` is rebound each tick.

    ``check_finite`` (SERVE_NAN_CHECK) adds ``ok [B]`` last: the
    isfinite fold of every tick's logits a lane, forced True outside
    ``mask`` (a masked lane's garbage never quarantines it), so the
    host can fail one non-finite lane without reading logits back."""
    toks = []
    ok = torch.ones_like(mask) if check_finite else None
    for _ in range(chunk_tokens):
        pos = cache["pos"]
        logits, new = forward(tok, cache)
        nxt = _sample_tokens(logits, temp, seeds, pos, top_k, top_p)
        if check_finite:
            ok = ok & (torch.isfinite(logits).all(-1) | ~mask)
        cache["pos"] = torch.where(mask, new["pos"],
                                   torch.zeros_like(new["pos"]))
        tok = torch.where(mask, nxt, tok)
        toks.append(tok)
    if check_finite:
        return tok, torch.stack(toks), ok
    return tok, torch.stack(toks)


def make_chunk_step(cfg: LlamaConfig, chunk_tokens: int,
                    top_k: Optional[int] = None,
                    top_p: Optional[float] = None,
                    check_finite: bool = False):
    """The contiguous ring's resident decode step.

    ``step(params, cache, tok [B], temp [B], seeds [B], active [B],
    lora=None) -> (tok', toks [chunk, B])``

    Runs ``chunk_tokens`` ticks for every lane, the cache updated in
    place.  Inactive lanes compute (the price of fixed shapes) but
    their position is ZEROED each tick, so their ignored writes land at
    row 0, which the next admission's splice overwrites.  ``lora``:
    ``(stacks, aid [B])`` on an adapter ring (every lane its own
    adapter, slot 0 the base).  ``check_finite``: ``ok [B]`` last
    (:func:`_ticks`)."""

    def step(params, cache, tok, temp, seeds, active, lora=None):
        return _ticks(lambda t, c: _ring_forward(cfg, params, t, c, lora),
                      cache, tok, temp, seeds, active, chunk_tokens, top_k,
                      top_p, check_finite)

    return step


def _mega_advance(toks: torch.Tensor, raw: torch.Tensor, live: torch.Tensor,
                  left: torch.Tensor, eos: torch.Tensor):
    """On-device continuation bookkeeping at one fused-iteration
    boundary of a megastep — the decision the host makes between two
    1-step dispatches, as tensor ops with no host read.

    ``toks`` [T, B] the boundary's tokens, ``raw`` [B] the device-valid
    row count per lane (``chunk`` while live, 0 for lanes that sat the
    iteration out), ``live`` [B] the continuation mask at the
    iteration's start, ``left`` [B] the remaining token budget, ``eos``
    [B] the eos id (-1: none).  Returns ``(count, live', left')``: the
    tokens the host consumes for this boundary (up to and INCLUDING an
    eos, capped by the budget — the walk of the scheduler's
    ``_consume``) and the advanced state.  A lane that saw eos or spent
    its budget goes dead and free-runs masked until the megastep
    ends."""
    t = toks.shape[0]
    idx = torch.arange(t, device=toks.device)[:, None]
    hitv = (eos[None, :] >= 0) & (toks == eos[None, :])
    hit = hitv.to(torch.int32)
    eos_before = (torch.cumsum(hit, dim=0) - hit) > 0
    valid = ((idx < raw[None, :]) & ~eos_before
             & (idx < left[None, :]) & live[None, :])
    count = valid.sum(dim=0).to(torch.int32)
    saw_eos = (hitv & valid).any(dim=0)
    left2 = left - count
    live2 = live & ~saw_eos & (left2 > 0)
    return count, live2, left2


def _mega_continue(toks: torch.Tensor, raw: torch.Tensor,
                   live: torch.Tensor, left: torch.Tensor,
                   steps: torch.Tensor, eos: torch.Tensor):
    """The whole per-boundary continuation update, shared by both
    megasteps: :func:`_mega_advance` plus the deadline-tick step
    accounting.  Returns ``(count, live', left', steps')``."""
    count, live2, left2 = _mega_advance(toks, raw, live, left, eos)
    steps2 = steps - live.to(torch.int32)
    live2 = live2 & (steps2 > 0)
    return count, live2, left2, steps2


def _fused(run_chunk, n_steps: int, caches, tok: torch.Tensor,
           active: torch.Tensor, eos: torch.Tensor, left: torch.Tensor,
           steps: torch.Tensor, check_finite: bool = False):
    """The megastep's outer loop over ``n_steps`` iterations (the JAX
    outer ``scan``), shared by the plain and speculative megasteps:
    ``run_chunk(tok, live) -> (tok', toks [T, B][, raw [B]])`` runs one
    iteration with the lanes outside ``live`` masked (``raw``: the rows
    of ``toks`` each lane produced, 0 outside ``live``; a plain chunk
    leaves it out, every row of a live lane being valid); at each
    boundary :func:`_mega_continue` advances the continuation state and
    a lane that was not live through the iteration gets back the
    positions it had before it in every cache of ``caches`` (so a lane
    frozen by its step budget resumes where its last consumed token
    left it).  Returns ``(tok', toks [n, T, B], counts [n, B], raws
    [n, B])``, and ``oks [n, B]`` last under ``check_finite`` (then
    ``run_chunk`` returns its iteration's ``ok`` last, True for lanes
    that sat the iteration out)."""
    live = active & (left > 0) & (steps > 0)
    all_toks, counts, raws, oks = [], [], [], []
    for _ in range(n_steps):
        p0 = [c["pos"].clone() for c in caches]
        tok, toks, *raw = run_chunk(tok, live)
        if check_finite:
            oks.append(raw.pop())
        raw = (raw[0] if raw
               else torch.where(live, toks.shape[0], 0).to(torch.int32))
        count, live2, left, steps = _mega_continue(toks, raw, live, left,
                                                   steps, eos)
        for c, p in zip(caches, p0):
            c["pos"] = torch.where(live, c["pos"], p)
        live = live2
        all_toks.append(toks)
        counts.append(count)
        raws.append(raw)
    out = (tok, torch.stack(all_toks), torch.stack(counts),
           torch.stack(raws))
    return out + (torch.stack(oks),) if check_finite else out


def make_megastep(cfg: LlamaConfig, chunk_tokens: int, n_steps: int,
                  top_k: Optional[int] = None,
                  top_p: Optional[float] = None,
                  check_finite: bool = False):
    """N fused ring iterations in ONE dispatch (SERVE_MEGASTEP) on the
    contiguous ring: :func:`make_chunk_step`'s ticks run ``n_steps``
    times with the host's boundary decisions — eos, token budget, step
    budget — carried on the device (:func:`_mega_continue`).  A lane
    that finishes mid-megastep free-runs masked: its position stops
    advancing and its writes land at its own row 0, like an inactive
    lane's in the 1-step program, which the next admission's splice
    overwrites.  So the contiguous ring must only freeze lanes it will
    EVICT at the boundary (eos / budget spent): a frozen-and-resumed
    lane would have lost its first prompt row, and the scheduler never
    hands a contiguous ring a step budget below ``n_steps`` (the paged
    megastep, whose dead lanes write the trash block, is the resumable
    one).

    ``mega(params, cache, tok, temp, seeds, active, eos, left, steps,
    lora=None) -> (tok', toks [n, chunk, B], counts [n, B])``, the cache
    and positions updated in place (``cache['pos']`` rebound).
    ``counts[r, b]`` is the number of ``toks[r, :, b]`` rows the host
    consumes for iteration ``r`` (0 once the lane is dead).
    ``check_finite``: ``oks [n, B]`` last, each iteration's isfinite
    verdict (True for a lane dead through that iteration)."""

    def mega(params, cache, tok, temp, seeds, active, eos, left, steps,
             lora=None):
        def run_chunk(t, live):
            return _ticks(
                lambda tt, c: _ring_forward(cfg, params, tt, c, lora),
                cache, t, temp, seeds, live, chunk_tokens, top_k, top_p,
                check_finite)

        tok, toks, counts, _, *oks = _fused(
            run_chunk, n_steps, (cache,), tok, active, eos, left, steps,
            check_finite)
        return (tok, toks, counts, *oks)

    return mega


def _splice_lane(ring: Dict[str, torch.Tensor],
                 lane: Dict[str, torch.Tensor], slot: int,
                 prompt_len: int) -> None:
    """Zero ring lane ``slot`` and copy a freshly prefilled batch-of-one
    lane cache into it, setting the lane's fill position to
    ``prompt_len`` — in place.  A lane cache LONGER than the ring lane
    is truncated (rows past the ring allocation are pads)."""
    ring_alloc = ring["k"].shape[3]
    n = min(lane["k"].shape[3], ring_alloc)
    for key in ("k", "v"):
        ring[key][:, slot].zero_()
        ring[key][:, slot, :, :n] = lane[key][:, 0, :, :n]
    ring["pos"][slot].fill_(int(prompt_len))


def make_prefill_insert(cfg: LlamaConfig, bucket: int,
                        top_k: Optional[int] = None,
                        top_p: Optional[float] = None):
    """Contiguous-ring admission: prefill the prompt, splice its KV
    into ring lane ``slot``, sample the first token and set the lane's
    tok/temp/seed — device work only, nothing read back.

    ``insert(params, cache, tok, temp, seeds, prompt [1, n],
    prompt_len, slot, temp_val, seed, lora=None) -> first_token`` (0-d
    device tensor; ``lora``: the stacks and the admitted lane's slot
    [1]).  ``bucket`` is the admission's prompt bucket; the prompt is
    forwarded at its own length."""
    from paddle_operator_tpu_torch.infer.paged import _set_lane

    def insert(params, cache, tok, temp, seeds, prompt, prompt_len, slot,
               temp_val, seed, lora=None):
        lane = D.init_cache(cfg, 1, prompt_len, device=prompt.device)
        logits, lane = D._forward(cfg, params, prompt[:, :prompt_len],
                                  lane, last_only=True, lora=lora)
        _splice_lane(cache, lane, slot, prompt_len)
        return _set_lane(cache, tok, temp, seeds, logits[0, -1],
                         prompt_len, slot, temp_val, seed, top_k, top_p,
                         _sample_tokens)

    return insert


# ---------------------------------------------------------------------------
# Chunked prefill: intermediate slice + final-insert programs
# ---------------------------------------------------------------------------


def _staged(lane_k: torch.Tensor, lane_v: torch.Tensor,
            start: int) -> Dict[str, torch.Tensor]:
    """A staging lane ([L, 1, H, staging_len, D] K and V) as a cache
    dict positioned at absolute row ``start``."""
    return {"k": lane_k, "v": lane_v,
            "pos": torch.full((1,), int(start), dtype=torch.int32,
                              device=lane_k.device)}


def make_prefill_chunk(cfg: LlamaConfig, slice_bucket: int,
                       staging_len: int):
    """One INTERMEDIATE chunked-prefill slice against a contiguous
    staging lane cache ([L, 1, H, staging_len, D], private to the
    admission): append the slice's KV rows at absolute positions
    [start, start + slice_bucket), in place, and skip the lm head
    entirely (only the FINAL slice needs logits).  Pad rows of the last
    full-width slice land past the real prompt and are either
    overwritten by the next slice or truncated/masked at the splice.

    ``chunk(params, lane_k, lane_v, toks [1, slice_bucket], start,
    lora=None)``"""
    from paddle_operator_tpu_torch.infer.speculative import _multi_forward

    def chunk(params, lane_k, lane_v, toks, start, lora=None):
        _multi_forward(cfg, params, toks, _staged(lane_k, lane_v, start),
                       head=False, lora=lora)

    return chunk


def make_chunked_final_insert(cfg: LlamaConfig, slice_bucket: int,
                              staging_len: int,
                              top_k: Optional[int] = None,
                              top_p: Optional[float] = None):
    """The FINAL chunked-prefill slice for the contiguous ring: run the
    last (right-padded) slice over the staging lane cache, splice the
    completed lane into ring slot ``slot`` and sample the first token —
    the back half of :func:`make_prefill_insert` with the forward
    restricted to the rows the intermediate slices did not cover.  Every
    write is in place (the ring's cache, tok, temp and seeds keep the
    addresses the captured graphs read).

    ``insert(params, cache, lane_k, lane_v, tok, temp, seeds,
    toks [1, slice_bucket], n_rows, start, prompt_len, slot, temp_val,
    seed, lora=None) -> first_token`` (a 0-d device tensor)."""
    from paddle_operator_tpu_torch.infer.paged import _set_lane
    from paddle_operator_tpu_torch.infer.speculative import _multi_forward

    def insert(params, cache, lane_k, lane_v, tok, temp, seeds, toks,
               n_rows, start, prompt_len, slot, temp_val, seed, lora=None):
        logits, lane = _multi_forward(cfg, params, toks,
                                      _staged(lane_k, lane_v, start),
                                      lora=lora)
        _splice_lane(cache, lane, slot, prompt_len)
        return _set_lane(cache, tok, temp, seeds, logits[0, int(n_rows) - 1],
                         prompt_len, slot, temp_val, seed, top_k, top_p,
                         _sample_tokens)

    return insert


def _default_buckets(max_len: int) -> Tuple[int, ...]:
    """2-3 prefill buckets, always ending at max_len so every
    admissible prompt has a bucket (the largest bucket is the submit-time
    prompt-length cap)."""
    out: List[int] = []
    b = 64
    while b < max_len and len(out) < 2:
        out.append(b)
        b *= 8
    out.append(max_len)
    return tuple(out)


# ---------------------------------------------------------------------------
# Disaggregated prefill: the handoff programs and the prefill engine
# ---------------------------------------------------------------------------


def make_attach_lane():
    """The decode ring's half of a disaggregated handoff: activate lane
    ``slot`` — fill position, carry token, temperature, sampling seed —
    once the prefilled blocks have been copied into the decode pool.  No
    forward runs here; that is the point of disaggregation.  Every write
    is in place (the captured graphs read the lane state at fixed
    addresses); ``first`` is a device scalar (an in-process engine's
    sample, copied on the device) or a host int (a remote pod's).

    ``attach(cache, tok, temp, seeds, slot, first, prompt_len, temp_val,
    seed)``"""

    def attach(cache, tok, temp, seeds, slot, first, prompt_len, temp_val,
               seed):
        cache["pos"][slot].fill_(int(prompt_len))
        if isinstance(first, torch.Tensor) and first.device == tok.device:
            tok[slot] = first
        else:
            tok[slot].fill_(int(first))
        temp[slot].fill_(float(temp_val))
        seeds[slot].fill_(int(seed))

    return attach


def _draft_prefill(dcfg: LlamaConfig, dparams, dcache, prompt: torch.Tensor,
                   prompt_len: int, slot: int) -> None:
    """Prefill a prompt ([1, n], its first ``prompt_len`` tokens real)
    through the draft model into a batch-of-one lane and splice it into
    the draft ring's lane ``slot`` at position ``prompt_len``, in place.
    The logits are discarded: the draft needs only the KV context to
    propose from.  The draft lane is a contiguous ring whatever the
    target's cache is."""
    dlane = D.init_cache(dcfg, 1, prompt_len, device=prompt.device)
    _, dlane = D._forward(dcfg, dparams, prompt[:, :prompt_len], dlane,
                          last_only=True)
    _splice_lane(dcache, dlane, slot, prompt_len)


def make_spec_attach(cfg: LlamaConfig, dcfg: LlamaConfig, bucket: int):
    """The disaggregated handoff for a SPECULATIVE ring: the target KV
    arrived by block copy, but the DRAFT lane still needs its prompt
    context to propose from — prefill it here (:func:`_draft_prefill`)
    together with the lane activation.  ``bucket`` is the admission's
    bucket (the prompt is forwarded at its own length).

    ``attach(dparams, dcache, cache, tok, temp, seeds, prompt [1, n],
    prompt_len, slot, first, temp_val, seed)``, in place."""
    lane = make_attach_lane()

    def attach(dparams, dcache, cache, tok, temp, seeds, prompt,
               prompt_len, slot, first, temp_val, seed):
        _draft_prefill(dcfg, dparams, dcache, prompt, prompt_len, slot)
        lane(cache, tok, temp, seeds, slot, first, prompt_len, temp_val,
             seed)

    return attach


def make_disagg_prefill(cfg: LlamaConfig, bucket: int, block_size: int,
                        top_k: Optional[int] = None,
                        top_p: Optional[float] = None,
                        quant: bool = False):
    """The 1-lane engine's whole-prompt program: prefill a prompt into
    the ENGINE pool's blocks (the same ``decode.paged_prefill`` call as
    the inline paged insert, at the prompt's own length — what keeps the
    disaggregated first token and KV bit-identical to inline) and sample
    the first token through the shared rule.  It touches no ring state:
    the handoff copies blocks and attaches the lane later, on the ring's
    thread.  ``bucket`` (a block multiple) is the engine's bucket.

    ``quant=True``: whole blocks quantize once into the engine's int8
    pool and the prompt's write-frontier block lands exact in tail row 0
    (the 1-lane pool is one lane wide) — the handoff carries codes,
    scales AND tail across.

    ``prefill(params, cache, table_row, prompt [1, n], prompt_len,
    temp_val, seed, lora=None) -> first`` (a 0-d device tensor)."""
    if bucket % block_size:
        raise ValueError(f"prefill bucket {bucket} not a multiple of the "
                         f"block size {block_size}")

    def prefill(params, cache, table_row, prompt, prompt_len, temp_val,
                seed, lora=None):
        if quant:
            logits, _, tail_k, tail_v = D.paged_prefill(
                params, cfg, prompt[:, :prompt_len], cache, table_row,
                block_size=block_size, last_only=True, quant=True,
                prompt_len=prompt_len, lora=lora)
            cache["kt"][:, 0] = tail_k[:, 0]
            cache["vt"][:, 0] = tail_v[:, 0]
        else:
            logits, _ = D.paged_prefill(params, cfg, prompt[:, :prompt_len],
                                        cache, table_row,
                                        block_size=block_size,
                                        last_only=True, lora=lora)
        dev = logits.device
        return _sample_tokens(
            logits[0, -1][None],
            torch.full((1,), float(temp_val), device=dev),
            torch.full((1,), int(seed), dtype=torch.int64, device=dev),
            torch.full((1,), int(prompt_len) - 1, dtype=torch.int32,
                       device=dev), top_k, top_p)[0]

    return prefill


def _engine_lanes(cache: Dict[str, torch.Tensor], starts: torch.Tensor,
                  quant: bool) -> Dict[str, torch.Tensor]:
    """The N-lane engine pool as a multi-lane cache dict positioned at
    ``starts`` [N] (the batch index IS the engine lane, so the pool's
    per-lane staging tails address directly)."""
    lane = {"k": cache["k"], "v": cache["v"], "pos": starts}
    if quant:
        for key in ("ks", "vs", "kt", "vt"):
            lane[key] = cache[key]
    return lane


def make_pool_prefill_slice(cfg: LlamaConfig, quant: bool = False):
    """One MULTI-LANE intermediate prefill slice for the N-lane engine:
    advance every participating lane's job by ``slice`` tokens in ONE
    forward — per-lane block tables, per-lane absolute positions, no lm
    head.  Lanes sitting the iteration out ride masked: their rows route
    to the trash block (``limits`` 0) and — quant — their staging-tail
    writes go to the trash tail (``mask``), so a paused lane's live tail
    is never touched.  bf16 writes go whole-block (``aligned``: the
    engine rounds its slice to a block multiple, so every start is
    block-aligned); the quant tail protocol is per-row.

    ``slice(params, cache, tables [N, M], toks [N, sb], starts [N],
    limits [N], mask [N], lora=None)``, the pool written in place."""
    from paddle_operator_tpu_torch.infer.speculative import (
        _multi_forward_paged,
    )

    def slice_(params, cache, tables, toks, starts, limits, mask,
               lora=None):
        _multi_forward_paged(cfg, params, toks,
                             _engine_lanes(cache, starts, quant), tables,
                             limit=limits, quant=quant, head=False,
                             lane_mask=mask if quant else None, lora=lora,
                             aligned=not quant)

    return slice_


def make_pool_prefill_final(cfg: LlamaConfig,
                            top_k: Optional[int] = None,
                            top_p: Optional[float] = None,
                            quant: bool = False):
    """The FINAL prefill slice for the N-lane engine: each finishing
    lane's last ``n_rows`` prompt tokens (right-padded to the slice
    width) WITH the lm head, and every finishing lane's first token
    sampled through the shared rule at its last real row.  Lanes that do
    not finish ride masked as in :func:`make_pool_prefill_slice`; their
    sampled "firsts" are garbage the host ignores.  bf16 writes are
    whole-block like the intermediate slice: the straddling block's pad
    rows land in the lane's real block (masked in the slice, overwritten
    by decode before any read), as in the JAX engine.

    ``final(params, cache, tables [N, M], toks [N, sb], n_rows [N],
    starts [N], temps [N], seeds [N], limits [N], mask [N], lora=None)
    -> firsts [N]``"""
    from paddle_operator_tpu_torch.infer.speculative import (
        _multi_forward_paged,
    )

    def final(params, cache, tables, toks, n_rows, starts, temps, seeds,
              limits, mask, lora=None):
        logits, _ = _multi_forward_paged(
            cfg, params, toks, _engine_lanes(cache, starts, quant), tables,
            limit=limits, quant=quant, lane_mask=mask if quant else None,
            lora=lora, aligned=not quant)
        last = torch.clamp(n_rows - 1, min=0)
        rows = logits.gather(1, last.long()[:, None, None].expand(
            -1, 1, logits.shape[-1]))[:, 0]
        return _sample_tokens(rows, temps.float(), seeds.long(),
                              (starts + last).to(torch.int32), top_k, top_p)

    return final


class PrefillPrefixCache:
    """The prefill engine's OWN radix prefix cache: completed full
    blocks' exact pool bytes, host-resident, keyed by the SAME
    ``utils/radixkey`` rolling-hash chain the decode radix uses — so a
    repeated system prompt prefills only its suffix on the prefill side
    too.  A hit's payloads upload into the job's lane blocks through the
    promote scatter (byte-exact, no requantization), which keeps a hit
    bit-identical to cold.  Bounded LRU by block count; stored chunks
    are compared on a hit (the radix collision check).  A payload's
    device-to-host copy may still be in flight when it is stored: its
    event is waited for in :meth:`materialize`, before the next lookup."""

    def __init__(self, capacity_blocks: int) -> None:
        from collections import OrderedDict

        self.cap = int(capacity_blocks)
        self._d: "OrderedDict[Any, tuple]" = OrderedDict()
        self._lazy: List[Any] = []

    def __len__(self) -> int:
        return len(self._d)

    def materialize(self) -> None:
        for ev in self._lazy:
            ev.synchronize()
        self._lazy.clear()

    def put(self, key, chunk: Tuple[int, ...], payload: Dict[str, Any],
            event=None) -> None:
        if self.cap <= 0 or key in self._d:
            if key in self._d:
                self._d.move_to_end(key)
            return
        self._d[key] = (tuple(chunk), payload)
        if event is not None:
            self._lazy.append(event)
        while len(self._d) > self.cap:
            self._d.popitem(last=False)

    def get(self, key, chunk: Tuple[int, ...]) -> Optional[Dict[str, Any]]:
        ent = self._d.get(key)
        if ent is None or ent[0] != tuple(chunk):
            return None
        self._d.move_to_end(key)
        return ent[1]


class _EngineJob:
    """One in-flight job's host state on the N-lane prefill engine."""

    __slots__ = ("req", "slot", "n", "start", "hit", "frames_done",
                 "prompt")

    def __init__(self, req, slot, start, hit):
        self.req = req
        self.slot = slot
        self.prompt = [int(t) for t in req.prompt]
        self.n = len(self.prompt)
        self.start = start          # next absolute row to prefill
        self.hit = hit              # prefix-cache rows (block-aligned)
        self.frames_done = 0        # blocks already posted as frames


class PrefillExecutor:
    """The disaggregated prefill engine: its OWN thread, its OWN CUDA
    stream and its OWN block pool, so a cold 2k-token prefill never
    occupies the decode ring's stream.  The decode scheduler submits
    ``(request, slot)`` jobs; this thread prefills prompts into its
    private pool and posts results the scheduler lands through the
    handoff path.

    **Two engine shapes.**

    - ``lanes == 1`` (default): the monolithic engine — one job at a
      time, the whole prompt in one forward into lane 0's blocks, one
      terminal item (below) with every block; the parity ORACLE for the
      rest.
    - ``lanes >= 2``: lane ``i`` owns the FIXED identity blocks
      ``[1 + i*M, 1 + (i+1)*M)`` (block 0 stays trash) and the loop is a
      mini-ring: each iteration coalesces every active job into ONE
      batched slice (``make_pool_prefill_slice``), long jobs advance one
      ``prefill_chunk`` slice per iteration ALONGSIDE short ones
      (chunk-interleaved: a 40-token prompt is never stuck behind a
      2k-token one), and finishing jobs run the lm head and the shared
      first-token sample in the batched final program.

    **Results.**  A job ends in ONE terminal item, ``("final", req, slot,
    snapshot, lane, j0, n_blocks, first, t_done)``: blocks ``[j0,
    n_blocks)`` of engine lane ``lane``, its (int8) staging-tail row and
    the first token.  **Streamed handoff** (``stream=True``, lanes >= 2):
    completed block groups post before it as ``("frame", req, slot,
    snapshot, lane, j0, j1)`` items the decode side copies WHILE this
    engine computes the rest, and the terminal's ``j0`` is the first
    block no frame carried (0 without frames).

    **The snapshot-lifetime rule.**  A ``snapshot`` is the engine pool
    itself (its tensors, at fixed addresses) plus ``"ready"``: the CUDA
    event recorded on the engine's stream after the dispatch that wrote
    the blocks (None off the card).  The consumer's stream waits on it
    before it copies — the engine's writes are ordered before the
    transfer by the event, not by the host.  The pool is written in
    place (where JAX arrays were immutable versions), so a lane is
    reassigned only after the consumer's copy of its job's last item has
    completed: posting a job's terminal item — its final or its error —
    HOLDS the lane, the consumer calls :meth:`release` once its copy is
    queued, with an event recorded on its own stream after that copy,
    and this engine's stream waits on that event before it next writes
    the lane.  Every terminal item must be released, landed or dropped;
    a jobs's frames precede its terminal item, so the terminal's release
    covers them.

    **Prefix reuse** (``prefix_blocks > 0``, lanes >= 2): a
    :class:`PrefillPrefixCache` keyed on the shared radix chain; a hit
    uploads cached block bytes into the job's lane and the prefill
    starts at the (block-aligned) hit frontier — bit-identical to cold,
    because the uploaded bytes ARE a cold run's.  Adapter jobs skip the
    cache (deltas change the KV).

    Fault isolation: a prefill dispatch failure posts ``(request, slot,
    error)`` — batch-granular on the N-lane engine (one fused dispatch
    serves every active job, so all of them fail; their lanes are
    rewritten by the next assignments) — and the decode ring never sees
    the fault.  Jobs whose request resolved meanwhile (cancel, deadline,
    heal) are dropped at either end.

    The int8 engine pool starts its scales at 0.0, the JAX pool's
    initial value (``paged.init_paged_cache``): a block a handoff
    carries that no job ever committed — an N-lane job's write-frontier
    block — crosses the wire with the bytes a JAX engine sends."""

    def __init__(self, params: Any, cfg: LlamaConfig, *, max_len: int,
                 block_size: int, buckets: Tuple[int, ...],
                 top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 kv_quant: str = "none", adapters=None,
                 lanes: int = 1, prefill_chunk: int = 64,
                 stream: bool = False, prefix_blocks: int = 0) -> None:
        from paddle_operator_tpu_torch.infer import paged as PG

        self._pg = PG
        # the adapter registry shared with the decode ring: a cold
        # adapter prompt prefills WITH its delta
        self.adapters = adapters
        self.params = params
        self.cfg = cfg
        self.device = params.tok_embed.embedding.device
        self.block_size = int(block_size)
        self.kv_quant = kv_quant
        self.quant = kv_quant == "int8"
        self.lanes = max(1, int(lanes))
        self.stream = bool(stream) and self.lanes > 1
        self.prefill_chunk = max(1, int(prefill_chunk))
        if self.lanes > 1 and not self.quant:
            # bf16 slices write WHOLE BLOCKS, which needs every slice
            # start block-aligned: round the slice up to a block
            # multiple (the int8 tail protocol is per-row regardless)
            self.prefill_chunk = (-(-self.prefill_chunk // self.block_size)
                                  * self.block_size)
        self.max_blocks = -(-D.cache_alloc_len(max_len) // self.block_size)
        m = self.max_blocks
        self.cache = PG.init_paged_cache(
            cfg, self.lanes, self.lanes * m + 1, self.block_size,
            device=self.device, quant=kv_quant)
        self.table_row = to_device(np.arange(1, m + 1, dtype=np.int32),
                                   self.device)
        self.tables = np.stack(
            [np.arange(1 + i * m, 1 + (i + 1) * m, dtype=np.int32)
             for i in range(self.lanes)])
        self._cuda = self.device.type == "cuda"
        self._stream = (torch.cuda.Stream(self.device) if self._cuda
                        else None)
        # the snapshot-lifetime rule: lane -> the request whose terminal
        # item is out, and lane -> the consumer's copy event
        self._cv = threading.Condition()
        self._held: Dict[int, Any] = {}
        self._fence: Dict[int, Any] = {}
        self.lane_waits = 0
        # test hook: a callable the loop invokes at each iteration top
        self.pause_gate = None
        # telemetry: batch occupancy EMA (lanes busy / N per iteration)
        # and per-job head-of-line wait samples
        self._occ_ema = 0.0
        self._hol: List[float] = []
        self._stats_lock = threading.Lock()
        self.iterations = 0
        self.prefix_hits = 0
        # the engine's own radix prefix cache (N-lane engine only — the
        # 1-lane path stays the byte-identical oracle)
        self.prefix = (PrefillPrefixCache(prefix_blocks)
                       if prefix_blocks > 0 and self.lanes > 1 else None)
        if self.lanes > 1:
            self.buckets = (self.prefill_chunk,)
            self._slice_prog = make_pool_prefill_slice(cfg, quant=self.quant)
            self._final_prog = make_pool_prefill_final(cfg, top_k, top_p,
                                                       quant=self.quant)
            self._progs: Dict[int, Any] = {}
            if self.prefix is not None:
                self._upload_prog = PG.make_promote_blocks(
                    self.block_size, quant=self.quant)
        else:
            # the engine's own bucket ladder, finer than the ring's:
            # block-multiple powers of two up to the ring's largest
            cap = max(buckets)
            ladder = []
            b = self.block_size
            while b < cap:
                ladder.append(b)
                b *= 2
            self.buckets = tuple(ladder) + (cap,)
            self._progs = {b: make_disagg_prefill(
                cfg, b, self.block_size, top_k, top_p, quant=self.quant)
                for b in self.buckets}
        self.jobs: "queue.Queue[tuple]" = queue.Queue()
        self.results: "queue.Queue[tuple]" = queue.Queue()
        if self._cuda:
            # the pool's zeros and the table were queued on the caller's
            # stream: the engine's stream starts behind them
            self._stream.wait_stream(torch.cuda.current_stream(self.device))
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="prefill-executor")
        self._thread.start()

    def submit(self, req, slot: int) -> None:
        self.jobs.put((req, slot, time.monotonic()))

    # -- the snapshot-lifetime rule ------------------------------------------

    def release(self, req, event=None) -> None:
        """The consumer's half of the snapshot-lifetime rule: ``req``'s
        terminal item has been landed (its copies queued on the
        consumer's stream, ``event`` recorded after them) or dropped, so
        its lane may take the next job — whose writes this engine's
        stream orders after ``event``."""
        with self._cv:
            for lane, r in list(self._held.items()):
                if r is req:
                    del self._held[lane]
                    self._fence[lane] = event
            self._cv.notify_all()

    def _hold(self, lane: int, req) -> None:
        with self._cv:
            self._held[lane] = req

    def _lane_free(self, lane: int) -> bool:
        with self._cv:
            return lane not in self._held

    def _claim(self, lane: int) -> bool:
        """Wait (host) until ``lane``'s last terminal item is released,
        then order this stream after the consumer's copy.  False when
        the engine is closing."""
        with self._cv:
            if lane in self._held:
                self.lane_waits += 1
            while lane in self._held:
                if self._stop.is_set():
                    return False
                self._cv.wait(0.05)
            ev = self._fence.pop(lane, None)
        if ev is not None:
            self._stream.wait_event(ev)
        return True

    def _mark(self):
        """An event on the engine's stream after the work queued so far
        (None off the card)."""
        if not self._cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(self._stream)
        return ev

    def _snapshot(self) -> Dict[str, Any]:
        snap = {key: self.cache[key]
                for key in ("k", "v", "ks", "vs", "kt", "vt")
                if key in self.cache}
        snap["ready"] = self._mark()
        return snap

    # -- telemetry ------------------------------------------------------------

    def batch_occupancy(self) -> float:
        """EMA of lanes-busy / N per engine iteration — 1.0 is a
        saturated batch."""
        with self._stats_lock:
            return round(self._occ_ema, 4)

    def hol_wait_ms_p95(self) -> float:
        """p95 of recent jobs' queue wait (submit -> lane assignment),
        ms — the head-of-line blocking proxy."""
        with self._stats_lock:
            if not self._hol:
                return 0.0
            s = sorted(self._hol)
            return round(s[min(len(s) - 1, int(0.95 * (len(s) - 1)))], 3)

    def _note_wait(self, t_enq: float) -> None:
        with self._stats_lock:
            self._hol.append((time.monotonic() - t_enq) * 1e3)
            if len(self._hol) > 256:
                del self._hol[:len(self._hol) - 256]

    def _note_occ(self, busy: int) -> None:
        occ = busy / self.lanes
        with self._stats_lock:
            self._occ_ema = (occ if not self._occ_ema
                             else 0.8 * self._occ_ema + 0.2 * occ)
            self.iterations += 1

    # -- the engine thread ---------------------------------------------------

    def _run(self) -> None:
        loop = self._loop_engine if self.lanes > 1 else self._loop
        with torch.inference_mode():
            if self._cuda:
                with torch.cuda.device(self.device), \
                        torch.cuda.stream(self._stream):
                    loop()
            else:
                loop()

    def _prompt(self, prompt) -> torch.Tensor:
        """The prompt [1, n] on the card, copied on the engine's stream
        (a request's ``dev_prompt`` was shipped on another stream)."""
        return to_device(np.asarray([prompt], np.int32), self.device)

    def _lora1(self, req):
        if self.adapters is None:
            return None
        return (self.adapters.arrays(),
                torch.full((1,), int(getattr(req, "adapter_idx", 0)),
                           dtype=torch.int32, device=self.device))

    @torch.inference_mode()
    def warm(self) -> None:
        """Run the smallest program once on the engine's stream (the card
        loads its kernels and the GEMM library its handles before the
        first cold prompt pays for them).  Writes only lane 0's blocks:
        call it while no job is in flight."""
        ctx = (torch.cuda.stream(self._stream) if self._cuda
               else torch.inference_mode())
        with ctx:
            sb = self.buckets[0]
            if self.lanes == 1:
                self._progs[sb](self.params, self.cache, self.table_row,
                                self._prompt([0] * sb), sb, 0.0, 0,
                                lora=self._lora1(None))
            else:
                nl = self.lanes
                z = torch.zeros((nl,), dtype=torch.int32, device=self.device)
                tables = to_device(self.tables[:, :1], self.device)
                toks = torch.zeros((nl, sb), dtype=torch.int32,
                                   device=self.device)
                mask = torch.zeros((nl,), dtype=torch.bool,
                                   device=self.device)
                lora = self._lora_tail({})
                self._slice_prog(self.params, self.cache, tables, toks, z, z,
                                 mask, lora=lora)
                self._final_prog(self.params, self.cache, tables, toks,
                                 z + 1, z, z.float(), z, z, mask, lora=lora)
            if self._cuda:
                self._stream.synchronize()

    # -- the 1-lane monolithic loop (the oracle) -------------------------------

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                req, slot, t_enq = self.jobs.get(timeout=0.05)
            except queue.Empty:
                continue
            if self.pause_gate is not None:
                self.pause_gate()
            if req.done.is_set() or req._cancel:
                continue            # resolved while queued: drop
            if not self._claim(0):
                return
            try:
                self._note_wait(t_enq)
                self._note_occ(1)
                n = len(req.prompt)
                pb = next((b for b in self.buckets if b >= n), None)
                if pb is None:
                    raise ValueError(f"prompt length {n} exceeds the "
                                     f"engine's largest bucket "
                                     f"({self.buckets[-1]})")
                first = self._progs[pb](
                    self.params, self.cache, self.table_row,
                    self._prompt(req.prompt), n, float(req.temperature),
                    req.seed, lora=self._lora1(req))
                snap = self._snapshot()
                self._hold(0, req)
                self.results.put(("final", req, slot, snap, 0, 0,
                                  -(-n // self.block_size), first,
                                  time.monotonic()))
            except Exception as e:      # noqa: BLE001 — isolate per job
                self._hold(0, req)
                self.results.put((req, slot, e))

    # -- the N-lane batched, chunk-interleaved engine ------------------------

    def _prefix_walk(self, prompt: List[int]) -> Tuple[int, list]:
        """Longest cached chain of leading FULL blocks, capped so at
        least one real token remains to prefill (the final slice samples
        from a real row); returns (hit_blocks, payloads)."""
        from paddle_operator_tpu_torch.utils.radixkey import chain_key

        bs = self.block_size
        self.prefix.materialize()
        key = None
        payloads = []
        for j in range((len(prompt) - 1) // bs):
            chunk = tuple(prompt[j * bs:(j + 1) * bs])
            key = chain_key(key, chunk)
            p = self.prefix.get(key, chunk)
            if p is None:
                break
            payloads.append(p)
        return len(payloads), payloads

    def _prefix_upload(self, lane: int, payloads: list) -> None:
        """Land prefix-hit payloads in the lane's identity blocks through
        the in-place promote scatter — byte-exact."""
        n = len(payloads)
        bs = self.block_size
        lc, _, h, _, d = payloads[0]["k"].shape
        cat = {key: torch.cat([p[key] for p in payloads], dim=1)
               for key in payloads[0]}
        dev = {key: to_device(t, self.device) for key, t in cat.items()}

        def slab(t):
            return t.permute(0, 2, 1, 3, 4).reshape(lc, h, n * bs, d)[:, None]

        ids = to_device(self.tables[lane][:n], self.device)
        self._upload_prog(self.cache, slab(dev["k"]), slab(dev["v"]), ids,
                          dev.get("ks"), dev.get("vs"))

    def _store_prefix(self, lane: int, job: _EngineJob) -> None:
        """Store the finished job's full blocks under their chain keys:
        device-to-host copies queued on the engine's stream (pinned on
        the card), waited for at the next lookup.  Never called for
        adapter jobs: their KV is delta-dependent."""
        from paddle_operator_tpu_torch.utils.radixkey import chain_key

        bs = self.block_size
        key = None
        keys = ("k", "v", "ks", "vs") if self.quant else ("k", "v")
        todo = []
        for j in range(job.n // bs):
            chunk = tuple(job.prompt[j * bs:(j + 1) * bs])
            key = chain_key(key, chunk)
            if self.prefix.get(key, chunk) is None:
                todo.append((key, chunk, int(self.tables[lane][j])))
        if not todo:
            return
        payloads = []
        for key, chunk, blk in todo:
            payload = {}
            for name in keys:
                src = self.cache[name].narrow(1, blk, 1)
                host = torch.empty(src.shape, dtype=src.dtype,
                                   pin_memory=self._cuda)
                host.copy_(src, non_blocking=self._cuda)
                payload[name] = host
            payloads.append(payload)
        ev = self._mark()
        for (key, chunk, _), payload in zip(todo, payloads):
            self.prefix.put(key, chunk, payload, event=ev)

    def _start_job(self, lane: int, req, slot: int) -> _EngineJob:
        hit = 0
        if self.prefix is not None and not getattr(req, "adapter_idx", 0):
            try:
                n_hit, payloads = self._prefix_walk(
                    [int(t) for t in req.prompt])
            except Exception:       # the cache is an optimization only
                n_hit, payloads = 0, []
            if n_hit:
                self._prefix_upload(lane, payloads)
                hit = n_hit * self.block_size
                self.prefix_hits += 1
        return _EngineJob(req, slot, hit, hit)

    def _lora_tail(self, active: Dict[int, _EngineJob]):
        if self.adapters is None:
            return None
        aid = np.zeros((self.lanes,), np.int32)
        for lane, job in active.items():
            aid[lane] = getattr(job.req, "adapter_idx", 0)
        return (self.adapters.arrays(), to_device(aid, self.device))

    def _width(self, rows_max: int) -> int:
        """Table width (blocks) for one batched dispatch: the smallest
        power-of-two block count covering the deepest participating
        lane's attended rows, capped at the lane width — the gathered
        lane view, and with it the attention's score width, is the
        table's, so slice work stays prompt-proportional."""
        need = -(-rows_max // self.block_size)
        w = 1
        while w < need:
            w *= 2
        return min(w, self.max_blocks)

    def _advance(self, active: Dict[int, _EngineJob],
                 free: List[int]) -> None:
        """One engine iteration: ONE batched intermediate slice for every
        long job and ONE batched final slice for every finishing job,
        then the frame and terminal posts."""
        sb = self.prefill_chunk
        bs = self.block_size
        nl = self.lanes
        dev = self.device
        inter = [ln for ln, j in sorted(active.items()) if j.n - j.start > sb]
        fin = [ln for ln, j in sorted(active.items()) if j.n - j.start <= sb]
        self._note_occ(len(active))
        lora = self._lora_tail(active)
        trash = self._pg.TRASH_BLOCK
        if inter:
            mw = self._width(max(active[ln].start + sb for ln in inter))
            toks = np.zeros((nl, sb), np.int32)
            starts = np.zeros((nl,), np.int32)
            limits = np.zeros((nl,), np.int32)
            tables = np.full((nl, mw), trash, np.int32)
            mask = np.zeros((nl,), bool)
            for ln in inter:
                j = active[ln]
                toks[ln] = j.prompt[j.start:j.start + sb]
                starts[ln] = j.start
                limits[ln] = j.start + sb
                tables[ln] = self.tables[ln][:mw]
                mask[ln] = True
            self._slice_prog(self.params, self.cache, to_device(tables, dev),
                             to_device(toks, dev), to_device(starts, dev),
                             to_device(limits, dev), to_device(mask, dev),
                             lora=lora)
            for ln in inter:
                active[ln].start += sb
        firsts = None
        if fin:
            mw = self._width(max(active[ln].start + sb for ln in fin))
            toks = np.zeros((nl, sb), np.int32)
            starts = np.zeros((nl,), np.int32)
            limits = np.zeros((nl,), np.int32)
            n_rows = np.zeros((nl,), np.int32)
            temps = np.zeros((nl,), np.float32)
            seeds = np.zeros((nl,), np.int64)
            tables = np.full((nl, mw), trash, np.int32)
            mask = np.zeros((nl,), bool)
            for ln in fin:
                j = active[ln]
                rem = j.n - j.start
                toks[ln, :rem] = j.prompt[j.start:]
                starts[ln] = j.start
                limits[ln] = j.n
                n_rows[ln] = rem
                temps[ln] = float(j.req.temperature)
                seeds[ln] = int(j.req.seed)
                tables[ln] = self.tables[ln][:mw]
                mask[ln] = True
            firsts = self._final_prog(
                self.params, self.cache, to_device(tables, dev),
                to_device(toks, dev), to_device(n_rows, dev),
                to_device(starts, dev), to_device(temps, dev),
                to_device(seeds, dev), to_device(limits, dev),
                to_device(mask, dev), lora=lora)
            for ln in fin:
                active[ln].start = active[ln].n
        # streamed frames: every lane's newly COMPLETED blocks (frames
        # carry full blocks only; the moving write frontier crosses once,
        # with the terminal item).  ONE snapshot after both dispatches
        # serves every post: completed blocks never change afterwards
        snap = (self._snapshot()
                if fin or (self.stream and inter) else None)
        if self.stream:
            for ln in inter:
                j = active[ln]
                done = j.start // bs
                if done > j.frames_done:
                    self.results.put(("frame", j.req, j.slot, snap, ln,
                                      j.frames_done, done))
                    j.frames_done = done
        for ln in fin:
            j = active.pop(ln)
            free.append(ln)
            self._hold(ln, j.req)
            self.results.put(("final", j.req, j.slot, snap, ln,
                              j.frames_done, -(-j.n // bs), firsts[ln],
                              time.monotonic()))
            if self.prefix is not None and not getattr(j.req, "adapter_idx",
                                                       0):
                try:
                    self._store_prefix(ln, j)
                except Exception:
                    pass            # the cache is an optimization only
        free.sort()

    def _loop_engine(self) -> None:
        pending: "deque[tuple]" = deque()
        active: Dict[int, _EngineJob] = {}
        free = list(range(self.lanes))
        # depth-2 dispatch pacing: the host runs at most two iterations
        # ahead of the engine's stream, so a late arrival reaches the
        # front of the batch within ~2 slices in DEVICE order
        fences: "deque[Any]" = deque()
        while not self._stop.is_set():
            if self.pause_gate is not None:
                self.pause_gate()
            try:
                if not active and not pending:
                    pending.append(self.jobs.get(timeout=0.05))
                while True:
                    pending.append(self.jobs.get_nowait())
            except queue.Empty:
                pass
            # assign free lanes FIFO (lowest lane first); a lane whose
            # last terminal item the consumer has not released yet waits
            while pending:
                ready = [ln for ln in free if self._lane_free(ln)]
                if not ready:
                    break
                req, slot, t_enq = pending.popleft()
                if req.done.is_set() or req._cancel:
                    continue        # resolved while queued: drop
                lane = ready[0]
                free.remove(lane)
                if not self._claim(lane):
                    return
                try:
                    self._note_wait(t_enq)
                    active[lane] = self._start_job(lane, req, slot)
                except Exception as e:  # noqa: BLE001
                    self._hold(lane, req)
                    self.results.put((req, slot, e))
                    free.append(lane)
                    free.sort()
            if not active:
                if pending:
                    with self._cv:
                        self.lane_waits += 1
                        self._cv.wait(0.05)
                continue
            try:
                while len(fences) >= 2:
                    fences.popleft().synchronize()
                self._advance(active, free)
                ev = self._mark()
                if ev is not None:
                    fences.append(ev)
            except Exception as e:      # noqa: BLE001 — batch-granular
                fences.clear()
                for lane, job in list(active.items()):
                    self._hold(lane, job.req)
                    self.results.put((job.req, job.slot, e))
                    free.append(lane)
                active.clear()
                free.sort()

    def close(self) -> None:
        self._stop.set()
        with self._cv:
            self._cv.notify_all()
        self._thread.join(timeout=30)
        if self._cuda:
            self._stream.synchronize()


# ---------------------------------------------------------------------------
# RingExecutor: step + admission programs and device state for one ring
# ---------------------------------------------------------------------------


class _Graph:
    """One captured resident program: the graph, its static outputs and
    the kernel launches it recorded."""

    __slots__ = ("graph", "toks", "counts", "raw", "ok", "launches")

    def __init__(self, graph, toks, counts, raw, ok, launches):
        self.graph = graph
        self.toks = toks
        self.counts = counts
        self.raw = raw
        self.ok = ok
        self.launches = launches


_COUNTERS = ((decode_attention, "launches"),
             (paged_decode_attention, "launches"),
             (paged_decode_attention, "quant_launches"),
             (quant_matmul, "launches"),
             (quant_gemm, "launches"))


def _launch_counts() -> List[int]:
    """The decode kernels' launch counts (contiguous, paged, int8 pool,
    the int8-weight kernels A and B)."""
    return [getattr(fn, attr) for fn, attr in _COUNTERS]


def _add_launches(delta) -> None:
    for (fn, attr), d in zip(_COUNTERS, delta):
        setattr(fn, attr, getattr(fn, attr) + d)


class RingExecutor:
    """Owns everything device-side about one continuous-batching ring:
    the resident chunk step, the admission inserts (cold, and suffix
    on a prefix hit), the KV cache or block pool, and the per-lane
    tok/temp/seed state.  The scheduler (infer/scheduler.py
    ContinuousBatcher) holds no tensors of its own — it sequences work
    on this object, which is what makes the watchdog's full device
    rebuild (:meth:`reset_state`) possible.

    ``megastep`` is the fused iteration count the scheduler dispatches
    (SERVE_MEGASTEP; 1 = the chunk step alone).  On a CUDA device the
    resident programs — the 1-step chunk and the ``megastep``-step one
    — are captured as CUDA graphs sharing one memory pool
    (:meth:`capture_graphs`, while no lane is resident), and
    :meth:`replay` replays them: the plan goes into one static device
    buffer, the state (cache, tok, temp, seeds) stays at fixed
    addresses, and admissions write it in place between replays.

    ``spec_k`` > 0 (with ``draft_params`` and ``draft_cfg``): the
    resident programs are the speculative round and its megastep
    (infer/speculative.py) over the target's cache and the draft's
    contiguous ring ``dcache``; the prefix cache and the host tier are
    off, as on the JAX ring.

    ``adapters`` (an infer/qos.py ``AdapterRegistry`` on this ring's
    device): every program adds each lane's LoRA delta; the lane's
    adapter slot lives in :attr:`aid` (device int32 [slots], with the
    host mirror :attr:`aid_host`).  Refused with ``spec_k``, as in JAX.

    ``check_finite`` (SERVE_NAN_CHECK): every resident program also
    returns ``ok``, the isfinite fold of each lane's logits (a static
    output of each captured graph, read after the replay's event beside
    the tokens); the scheduler quarantines a lane whose ``ok`` is False.
    Off, the programs and graphs are the unchecked ones.  A speculative
    ring's round has no such fold (the scheduler refuses the pair).

    :meth:`swap_weights` replaces the served params (the device half of
    the live weight swap): the caller parks every lane, swaps, rebuilds
    the state (:meth:`reset_state`) and captures the graphs again
    before any lane resumes."""

    # a prefix hit with a LONGER divergent suffix admits through the
    # cold block-granular prefill instead (the JAX package's cut-over
    # point; the prefill counters the tests pin depend on it)
    SUFFIX_PREFILL_MAX_ROWS = 256

    def __init__(self, params: Any, cfg: LlamaConfig, *, slots: int,
                 max_len: int, chunk_tokens: int,
                 prefill_buckets: Tuple[int, ...] = (),
                 top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 paged: bool = False, block_size: int = 256,
                 num_blocks: Optional[int] = None,
                 prefix_cache: bool = True,
                 kv_quant: str = "none", megastep: int = 1,
                 host_cache_blocks: int = 0,
                 prefill_chunk: int = 64,
                 draft_params: Any = None,
                 draft_cfg: Optional[LlamaConfig] = None,
                 spec_k: int = 0, adapters=None,
                 check_finite: bool = False,
                 prefill_mode: str = "inline",
                 prefill_client: Any = None,
                 prefill_lanes: int = 1,
                 prefill_stream: bool = False,
                 prefill_prefix_blocks: int = 0,
                 mesh=None) -> None:
        self.check_finite = bool(check_finite)
        self.prefill_mode = prefill_mode
        # tensor-parallel serving: this rank's cut of the model, its
        # heads' config and KV, the dispatch mode its group allows
        tp = D.mesh_tp(mesh)
        self.eager = False
        if tp > 1:
            # what such a ring refuses, the scheduler refuses by name
            # (scheduler._refuse_on_tp)
            D._require_shard(params, mesh)
            cfg = D._local(cfg, params)
            group = D._shard_of(params).group
            backend = dist.get_backend(group)
            on_card = params.tok_embed.embedding.device.type == "cuda"
            # a gloo group's collectives cannot be captured in a CUDA
            # graph: every dispatch then runs the program eagerly
            self.eager = on_card and backend == "gloo"
            how = ("as captured CUDA graphs" if on_card and not self.eager
                   else "eagerly")
            print(f"tensor-parallel ring: rank {dist.get_rank(group)} of "
                  f"tp={tp} over {backend}; dispatches run {how}",
                  flush=True)
        # many-adapter serving: a draft proposing base-only against an
        # adapted target would collapse acceptance, so the JAX ring
        # refuses the pair
        if adapters is not None and spec_k:
            raise ValueError(
                "adapters are not supported on speculative rings (the "
                "draft proposes base-only); disable one of them")
        self.adapters = adapters
        self.aid: Optional[torch.Tensor] = None
        self.aid_host = np.zeros((slots,), np.int32)
        if int(megastep) < 1:
            raise ValueError(f"megastep must be >= 1 (got {megastep})")
        self.megastep = int(megastep)
        # SERVE_PREFILL_CHUNK: the chunked prefill's slice width (rows)
        self.prefill_chunk = int(prefill_chunk)
        if self.prefill_chunk < 1:
            raise ValueError(
                f"prefill_chunk must be >= 1 (got {prefill_chunk})")
        self._chunk_progs: Dict[Any, Any] = {}
        self._final_inserts: Dict[Any, Any] = {}
        self.params = params
        self.cfg = cfg
        self.device = params.tok_embed.embedding.device
        self.slots = slots
        self.max_len = max_len
        self.chunk = chunk_tokens
        self.buckets = tuple(sorted(prefill_buckets)) or _default_buckets(
            max_len)
        self.top_k, self.top_p = top_k, top_p
        self.paged = bool(paged)
        self.pool: Optional[Any] = None
        self._suffix_inserts: Dict[int, Any] = {}
        # SERVE_KV_QUANT: int8 codes + per-block scales for the paged
        # pool, the dequant fused into the paged kernel — about twice
        # the resident lanes per byte; "none" keeps the bf16 pool
        from paddle_operator_tpu_torch.infer import paged as PG

        if kv_quant not in PG.KV_QUANT_MODES:
            raise ValueError(f"kv_quant {kv_quant!r} not in "
                             f"{PG.KV_QUANT_MODES}")
        self.kv_quant = kv_quant
        self.quant = kv_quant == "int8"
        if self.quant and not self.paged:
            raise ValueError("kv_quant='int8' requires the paged ring "
                             "(the pool block is the quantization "
                             "unit); set paged=True / SERVE_PAGED=1")
        self._tail_init = None
        self._slab: Optional[HostSlab] = None
        if self.paged:
            self._pg = PG
            self.block_size = int(block_size)
            self._num_blocks = num_blocks
            self.prefix_cache = prefix_cache
            # the host spill tier: demoted radix blocks live in host
            # memory and promote back on a hit — only meaningful with the
            # prefix cache on
            self.host_cache_blocks = (int(host_cache_blocks)
                                      if self.prefix_cache else 0)
            if spec_k:
                # a speculative ring turns the prefix cache and the host
                # tier off, as the JAX ring does: every admission
                # prefills the draft's whole prompt anyway
                self.prefix_cache = False
                self.host_cache_blocks = 0
            self.pool = PG.PagedCacheManager(
                slots, max_len, self.block_size, num_blocks,
                prefix_cache=self.prefix_cache,
                host_cache_blocks=self.host_cache_blocks)
            if self.host_cache_blocks:
                self._slab = self._build_slab()
            # prefill buckets scatter whole blocks: round each up to a
            # block multiple, capped at the lane view
            self.buckets = tuple(sorted(
                {min(-(-b // self.block_size) * self.block_size,
                     self.pool.view_len) for b in self.buckets}))
            self._copy_block = PG.make_block_copier()
            self._promote = PG.make_promote_blocks(self.block_size,
                                                   quant=self.quant)
            if self.quant:
                self._tail_init = PG.make_tail_init()
            self.step = PG.make_paged_chunk_step(
                cfg, chunk_tokens, top_k, top_p, quant=self.quant,
                check_finite=self.check_finite)
            self.inserts = {b: PG.make_paged_prefill_insert(
                cfg, b, self.block_size, top_k, top_p, quant=self.quant)
                for b in self.buckets}
        else:
            self.block_size = int(block_size)
            self.prefix_cache = False
            self.host_cache_blocks = 0
            self.step = make_chunk_step(cfg, chunk_tokens, top_k, top_p,
                                        self.check_finite)
            self.inserts = {b: make_prefill_insert(cfg, b, top_k, top_p)
                            for b in self.buckets}
        # SERVE_SPEC_K: speculative rounds (infer/speculative.py) replace
        # the chunk step as the resident program, and every admission
        # prefills the draft lane too
        self.spec_k = int(spec_k)
        self.draft_cfg = draft_cfg
        self.draft_params = None
        self.dcache: Optional[Dict[str, torch.Tensor]] = None
        if adapters is not None and adapters.device != self.device:
            raise ValueError(f"the adapter stacks are on "
                             f"{adapters.device}, the params on "
                             f"{self.device}")
        if self.spec_k < 0:
            raise ValueError(f"spec_k must be >= 0 (got {spec_k})")
        if self.spec_k:
            self._init_spec(draft_params, draft_cfg)
        self._mega: Dict[int, Any] = {}
        # the plan's one static device buffer (int32): active, eos,
        # left, steps ([slots] each), then the table [slots, M]
        width = self.pool.max_blocks if self.paged else 0
        self._plan = torch.zeros((4 + width) * slots, dtype=torch.int32,
                                 device=self.device)
        self._graphs: Optional[Dict[int, _Graph]] = None
        self.capture_s = 0.0
        self.graph_replays = 0
        self.reset_state()
        # the disaggregated prefill engine (prefill_mode="disagg"): built
        # with the ring, so its pool lives with the rest of the device
        # state; the scheduler drives its queues.  With a
        # ``prefill_client`` (infer/prefill_serve.RemotePrefillClient)
        # the engine lives in the prefill pool's own pods: the client
        # keeps the same submit/results contract, its results are HOST
        # payloads the scheduler lands through the promote scatter, and
        # only the attach runs here
        self.prefill_exec: Optional[Any] = None
        self.prefill_remote = False
        self.prefill_lanes = max(1, int(prefill_lanes))
        self.prefill_stream = bool(prefill_stream)
        self._attach = None
        self._spec_attach: Dict[int, Any] = {}
        self._frame_transfer = None
        self._tail_copy = None
        if prefill_mode == "disagg":
            if not self.paged:
                raise ValueError("prefill_mode='disagg' requires the paged "
                                 "ring (block-granular handoff)")
            self._attach = make_attach_lane()
            if prefill_client is not None:
                self.prefill_exec = prefill_client
                self.prefill_remote = True
            else:
                self.prefill_exec = PrefillExecutor(
                    self.params, cfg, max_len=max_len,
                    block_size=self.block_size, buckets=self.buckets,
                    top_k=top_k, top_p=top_p, kv_quant=self.kv_quant,
                    adapters=adapters, lanes=self.prefill_lanes,
                    prefill_chunk=self.prefill_chunk,
                    stream=self.prefill_stream,
                    prefix_blocks=int(prefill_prefix_blocks))
                # handoffs land block group by block group through the
                # frame transfer, the (int8) staging tail once, with the
                # terminal item, through the lane-addressed copy
                self._frame_transfer = self._pg.make_pool_frame_transfer(
                    self.pool.max_blocks, quant=self.quant)
                if self.quant:
                    self._tail_copy = self._pg.make_pool_tail_copy()

    def _init_spec(self, draft_params: Any,
                   draft_cfg: Optional[LlamaConfig]) -> None:
        """The speculative ring's checks and its 1-step program, the
        round.  The admissions stay the target's: the scheduler adds
        :meth:`draft_prefill` after each."""
        from paddle_operator_tpu_torch.infer.speculative import (
            check_draft_compat,
            make_spec_round_fn,
        )

        cfg = self.cfg
        if draft_params is None or draft_cfg is None:
            raise ValueError("spec_k > 0 requires draft_params and "
                             "draft_cfg (see LlamaConfig.draft())")
        check_draft_compat(cfg, draft_cfg)
        if self.max_len > draft_cfg.max_seq_len:
            raise ValueError(
                f"draft max_seq_len ({draft_cfg.max_seq_len}) < ring "
                f"max_len ({self.max_len}); derive the draft with "
                "cfg.draft() to inherit the target's RoPE table")
        ddev = draft_params.tok_embed.embedding.device
        if ddev != self.device:
            raise ValueError(f"the draft's params are on {ddev}, the "
                             f"target's on {self.device}")
        self.draft_params = draft_params
        self.step = make_spec_round_fn(cfg, draft_cfg, self.spec_k,
                                       self.top_k, self.top_p,
                                       quant=self.quant)

    @torch.inference_mode()
    def draft_prefill(self, slot: int, prompt: torch.Tensor,
                      prompt_len: int) -> None:
        """The draft's half of a speculative admission, queued after the
        target's insert (or chunked prefill's final slice):
        :func:`_draft_prefill` of the whole prompt ([1, n] on the card)
        into the draft ring's lane ``slot``."""
        _draft_prefill(self.draft_cfg, self.draft_params, self.dcache,
                       prompt, prompt_len, slot)

    # -- state lifecycle ---------------------------------------------------

    @torch.inference_mode()
    def reset_state(self) -> None:
        """(Re)build every piece of mutable device state from scratch —
        construction AND the watchdog's self-heal land here, so a
        rebuilt ring never carries poisoned state forward.  Paged: a
        fresh allocator too (the radix cache keys blocks of the
        replaced pool)."""
        dev = self.device
        # the graphs hold the old state's addresses: captured again, by
        # capture_graphs, before the next dispatch
        self._graphs = None
        if self.paged:
            # the host tier resets with the allocator: in-flight
            # promotions and the old tier's payloads (settled or not)
            # give their slots back — payloads keyed against the dead
            # allocator's chains must never promote into the new pool
            if self.pool is not None:
                self.pool.drop_host_tier()
            self.pool = self._pg.PagedCacheManager(
                self.slots, self.max_len, self.block_size,
                self._num_blocks, prefix_cache=self.prefix_cache,
                host_cache_blocks=self.host_cache_blocks)
            if self.host_cache_blocks:
                self.pool.demote_fetch = self._demote_fetch
                self.pool.host_import = self._import_payload
            self.cache = None          # free the old pool before the new
            self.cache = self._pg.init_paged_cache(
                self.cfg, self.slots, self.pool.total, self.block_size,
                device=dev, quant=self.kv_quant)
        else:
            self.cache = None
            self.cache = init_ring_cache(self.cfg, self.slots,
                                         self.max_len, device=dev)
        self._pool_bytes = sum(t.numel() * t.element_size()
                               for key, t in self.cache.items()
                               if key != "pos")
        if self.spec_k:
            # the draft's contiguous ring, allocated once: a rebuild
            # zeroes it in place (a heal rebuilds BOTH caches)
            if self.dcache is None:
                self.dcache = init_ring_cache(self.draft_cfg, self.slots,
                                              self.max_len, device=dev)
            else:
                for t in self.dcache.values():
                    t.zero_()
        if self.adapters is not None:
            # the per-lane adapter slots, allocated once: the graphs read
            # them at a fixed address, and a heal zeroes them in place
            if self.aid is None:
                self.aid = torch.zeros((self.slots,), dtype=torch.int32,
                                       device=dev)
            else:
                self.aid.zero_()
            self.aid_host[:] = 0
        self.tok = torch.zeros((self.slots,), dtype=torch.int32, device=dev)
        self.temp = torch.zeros((self.slots,), dtype=torch.float32,
                                device=dev)
        self.seeds = torch.zeros((self.slots,), dtype=torch.int64,
                                 device=dev)

    def prewarm(self) -> None:
        """Build the kernel library this ring launches and, on the card,
        capture its resident programs (:meth:`capture_graphs`) — so the
        first dispatch pays neither.  Off the card a no-op.  Call it
        only while no lane is resident."""
        if self.device.type != "cuda":
            return
        from paddle_operator_tpu_torch.ops import _build

        models = [(self.cfg, self.params)]
        if self.spec_k:
            models.append((self.draft_cfg, self.draft_params))
        if any(cfg.resolved_decode_attn(self.device) == "kernel"
               for cfg, _ in models):
            _build.load("decode_attention")
        if any(Q.weight_quant_mode(p) != "none" for _, p in models):
            _build.load("quant_matmul")
        if self.prefill_exec is not None and not self.prefill_remote:
            # the engine's programs on its own stream, so the first cold
            # prompt pays no first-call cost in its TTFT (a remote ring's
            # programs live, and warm, in the prefill pods)
            self.prefill_exec.warm()
        self.capture_graphs()

    # -- adapter (LoRA) operands ------------------------------------------

    def lora_step_tail(self):
        """The resident programs' ``lora``: the registry's stacks and the
        per-lane slot buffer (both at fixed addresses, so a captured
        graph reads every load, evict and admission), or None without
        adapters."""
        if self.adapters is None:
            return None
        return (self.adapters.arrays(), self.aid)

    def lora_insert_tail(self, slot: int):
        """An admission's ``lora`` for lane ``slot``: the stacks and the
        lane's own slot ([1], a view of :attr:`aid`, which
        :meth:`set_aid` wrote before the insert in stream order), or
        None without adapters."""
        if self.adapters is None:
            return None
        return (self.adapters.arrays(), self.aid[slot:slot + 1])

    def set_aid(self, slot: int, idx: int) -> None:
        """Lane ``slot``'s adapter slot, host mirror and device buffer
        (in place, ``fill_``: queued in stream order, no wait)."""
        if self.adapters is None:
            return
        self.aid_host[slot] = int(idx)
        self.aid[slot].fill_(int(idx))

    # -- plan replay: the ONE resident dispatch path -----------------------

    def megastep_prog(self, n: int):
        """The N-fused-iteration program for this ring's mode
        (contiguous, paged or int8 paged), built once per N."""
        prog = self._mega.get(n)
        if prog is None:
            if self.spec_k:
                from paddle_operator_tpu_torch.infer.speculative import (
                    make_spec_megastep,
                )

                prog = make_spec_megastep(
                    self.cfg, self.draft_cfg, self.spec_k, n, self.top_k,
                    self.top_p, quant=self.quant)
            elif self.paged:
                prog = self._pg.make_paged_megastep(
                    self.cfg, self.chunk, n, self.top_k, self.top_p,
                    quant=self.quant, check_finite=self.check_finite)
            else:
                prog = make_megastep(self.cfg, self.chunk, n, self.top_k,
                                     self.top_p, self.check_finite)
            self._mega[n] = prog
        return prog

    def _plan_views(self):
        s = self.slots
        p = self._plan
        table = p[4 * s:].view(s, -1) if self.paged else None
        return p[:s], p[s:2 * s], p[2 * s:3 * s], p[3 * s:4 * s], table

    def _upload(self, plan: ExecPlan) -> None:
        """The plan into the static buffer: one host->device copy,
        queued in stream order (from pinned memory on the card, so the
        host does not wait for the dispatches still queued)."""
        s = self.slots
        host = np.zeros(self._plan.shape[0], np.int32)
        host[:s] = np.asarray(plan.active, bool)
        if plan.n_steps > 1:
            host[s:2 * s] = plan.eos
            host[2 * s:3 * s] = plan.left
            host[3 * s:4 * s] = plan.steps
        if self.paged:
            host[4 * s:] = np.asarray(plan.table, np.int32).reshape(-1)
        src = torch.from_numpy(host)
        if self.device.type == "cuda":
            self._plan.copy_(src.pin_memory(), non_blocking=True)
        else:
            self._plan.copy_(src)

    def run(self, plan: ExecPlan):
        """The plan's program called eagerly, op by op: what
        :meth:`replay` runs on the CPU, and on the card the program its
        graph replays (for comparing the two).  Returns ``(toks,
        counts)``."""
        self._upload(plan)
        return self._program(plan.n_steps)[:2]

    def _program(self, n_steps: int):
        """The resident program of ``n_steps`` fused iterations over the
        static state and the uploaded plan — what :meth:`run` calls and
        :meth:`capture_graphs` records (1 step: ``self.step``, the seam
        pacing wrappers install on; on a speculative ring the round).
        The state stays at its addresses: positions and tokens are
        written back in place.  Returns ``(toks, counts, raw, ok)``
        (``raw`` None off a speculative ring, ``ok`` None without
        ``check_finite``)."""
        active_i, eos, left, steps, table = self._plan_views()
        active = active_i != 0
        lead = (table,) if self.paged else ()
        # adapterless, the programs are called as they always were (the
        # seam wrappers of ``self.step`` take positional arguments)
        lora = self.lora_step_tail()
        lora_kw = {} if lora is None else {"lora": lora}
        caches = [self.cache] + ([self.dcache] if self.spec_k else [])
        held = [c["pos"] for c in caches]
        raw = ok = None
        if self.spec_k:
            args = (self.params, self.draft_params, self.cache, self.dcache,
                    self.tok, self.temp, self.seeds, active)
            tbl = table if self.paged else None
            if n_steps == 1:
                tok, toks, counts = self.step(*args, table=tbl)
                toks, counts = toks[None], counts[None]
                raw = counts
            else:
                tok, toks, raw, counts = self.megastep_prog(n_steps)(
                    *args, eos, left, steps, table=tbl)
        elif n_steps == 1:
            tok, toks, *ok = self.step(self.params, self.cache, *lead,
                                       self.tok, self.temp, self.seeds,
                                       active, **lora_kw)
            counts = None
        else:
            tok, toks, counts, *ok = self.megastep_prog(n_steps)(
                self.params, self.cache, *lead, self.tok, self.temp,
                self.seeds, active, eos, left, steps, **lora_kw)
        if not self.spec_k:
            ok = ok[0] if ok else None
        for c, pos in zip(caches, held):
            pos.copy_(c["pos"])
            c["pos"] = pos
        self.tok.copy_(tok)
        return toks, counts, raw, ok

    def replay(self, plan: ExecPlan) -> DispatchResult:
        """Execute one scheduler-filled :class:`ExecPlan` against the
        ring's device state: ``plan.n_steps`` chunks of ``chunk_tokens``
        ticks for every lane (inactive lanes masked).  On the card, the
        CUDA graph of that program (a missing graph raises: nothing runs
        eagerly there); on the CPU, :meth:`run`.  The watchdog brackets
        it; the tokens come back as device tensors whose host copies are
        already queued."""
        n = plan.n_steps
        if self.device.type != "cuda" or self.eager:
            self._upload(plan)
            toks, counts, raw, ok = self._program(n)
            return DispatchResult(toks, counts, n, raw, ok)
        g = (self._graphs or {}).get(n)
        if g is None:
            raise RuntimeError(
                f"no CUDA graph of the {n}-step program: capture_graphs() "
                f"(prewarm) captures steps {sorted({1, self.megastep})} "
                "while no lane is resident")
        self._upload(plan)
        g.graph.replay()
        self.graph_replays += 1
        _add_launches(g.launches)
        return DispatchResult(g.toks, g.counts, n, g.raw, g.ok)

    @property
    def needs_capture(self) -> bool:
        """On the card, before the first dispatch and after every
        :meth:`reset_state`: the graphs must be captured (while no lane
        is resident)."""
        return (self.device.type == "cuda" and not self.eager
                and self._graphs is None)

    @torch.inference_mode()
    def capture_graphs(self) -> None:
        """Capture the 1-step program and the ``megastep``-step one as
        CUDA graphs sharing one memory pool (a no-op off the card or
        when captured).  Each is first run once for real (sizing the
        decode kernels' split scratch and setting their attributes, which
        must not happen under capture) with every lane inactive and the
        table all trash: inactive lanes write row 0 of their own lane,
        the trash block and the trash tail, and keep position 0 and
        their token.  So this runs only while no lane is resident — at
        prewarm and after :meth:`reset_state` — and raises otherwise.
        The launches each graph recorded are kept and added to the
        kernels' counts at every replay; the warm-up's and the
        capture's own are taken back off."""
        if not self.needs_capture:
            return
        if bool(self.cache["pos"].any()) or (
                self.spec_k and bool(self.dcache["pos"].any())):
            raise RuntimeError("capture_graphs: lanes are resident "
                               "(non-zero positions); capture only while "
                               "the ring is empty")
        t0 = time.perf_counter()
        s = self.slots
        width = self.pool.max_blocks if self.paged else 0
        idle = ExecPlan(self.megastep, [False] * s,
                        table=np.zeros((s, width), np.int32),
                        eos=np.full(s, -1, np.int32),
                        left=np.zeros(s, np.int32),
                        steps=np.zeros(s, np.int32))
        steps = sorted({1, self.megastep})
        before = _launch_counts()
        graphs = {}
        with torch.cuda.device(self.device):
            for n in steps:
                idle.n_steps = n
                self.run(idle)
            torch.cuda.synchronize()
            pool = torch.cuda.graph_pool_handle()
            # no garbage collection while capturing: collecting an
            # unreachable object that holds a CUDA graph (an old ring)
            # destroys that graph, which invalidates the capture
            collecting = gc.isenabled()
            gc.disable()
            try:
                for n in steps:
                    c0 = _launch_counts()
                    g = torch.cuda.CUDAGraph()
                    with torch.cuda.graph(g, pool=pool,
                                          capture_error_mode="thread_local"):
                        toks, counts, raw, ok = self._program(n)
                    graphs[n] = _Graph(g, toks, counts, raw, ok, [
                        b - a for a, b in zip(c0, _launch_counts())])
            finally:
                if collecting:
                    gc.enable()
            _add_launches([a - b for a, b in zip(before, _launch_counts())])
            torch.cuda.synchronize()
        self._graphs = graphs
        self.capture_s = time.perf_counter() - t0

    def graph_pool_bytes(self) -> int:
        """Device bytes the captured graphs' memory pool holds (0 with
        no graph)."""
        if not self._graphs:
            return 0
        pool = next(iter(self._graphs.values())).graph.pool()
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == tuple(pool))

    # -- lane spill/restore: the preemption primitive ----------------------

    def _state_ptrs(self) -> Dict[str, int]:
        """Addresses of the state a captured graph reads."""
        ptrs = {key: t.data_ptr() for key, t in self.cache.items()}
        if self.spec_k:
            ptrs.update({"d" + key: t.data_ptr()
                         for key, t in self.dcache.items()})
        ptrs.update(tok=self.tok.data_ptr(), temp=self.temp.data_ptr(),
                    seeds=self.seeds.data_ptr(), plan=self._plan.data_ptr())
        if self.aid is not None:
            ptrs["aid"] = self.aid.data_ptr()
        return ptrs

    def _promote_blocks(self, ids, blocks: Dict[str, torch.Tensor]) -> None:
        """Host blocks ``blocks["k"]``/``["v"]`` [L, n, H, bs, D] (and
        the scale rows ``["ks"]``/``["vs"]`` [L, n, H] of the int8 pool)
        into pool blocks ``ids`` through the promote scatter: each
        tensor crosses to the card in one copy, then lands as one
        contiguous slab."""
        dev = {key: to_device(t, self.device) for key, t in blocks.items()}
        lcount, n, h, bs, d = dev["k"].shape

        def slab(t):
            return t.permute(0, 2, 1, 3, 4).reshape(lcount, h, n * bs,
                                                    d)[:, None]

        self._promote(self.cache, slab(dev["k"]), slab(dev["v"]),
                      to_device(np.asarray(ids, np.int32), self.device),
                      dev.get("ks"), dev.get("vs"))

    # -- host spill tier: demote, import and the batched promote ----------

    def _build_slab(self) -> HostSlab:
        """The tier's pinned slab: one slot per tier block, plus the
        slots a demote and an admission can hold beyond the tier's bound
        (the hit chain a lane pins and promotes, at most a lane's
        ``max_blocks``; the demote fetched before its put drops the
        oldest; one in the store writer's hands).  Its cost is logged."""
        cfg, bs = self.cfg, self.block_size
        rows = (cfg.n_layers, 1, cfg.n_kv_heads, bs, cfg.head_dim)
        dt = torch.int8 if self.quant else cfg.dtype
        layout = [("k", rows, dt), ("v", rows, dt)]
        if self.quant:
            layout += [(name, rows[:3], torch.float32) for name in ("ks",
                                                                    "vs")]
        slab = HostSlab(self.host_cache_blocks + self.pool.max_blocks + 2,
                        layout, pin=self.device.type == "cuda")
        slab.reclaim = self._reclaim_slot
        print(f"host tier: {self.host_cache_blocks} blocks in a "
              f"{slab.nbytes()}-byte host slab of {slab.n_slots} slots "
              f"({'pinned' if slab.registered else 'pageable'}), built in "
              f"{slab.boot_s * 1e3:.1f} ms", flush=True)
        return slab

    def _reclaim_slot(self) -> bool:
        """A full slab's fallback: the durable store gives back its
        oldest queued (not yet written) offer."""
        store = self.pool.store if self.pool is not None else None
        return bool(store is not None and store.shed_oldest())

    def _demote_fetch(self, blk: int) -> HostBlock:
        """``PagedCacheManager.demote_fetch``: one pool block's exact
        bytes (all layers; K and V, and the scale rows on the int8 pool)
        into a free slab slot — a slice of the pool and a non-blocking
        device-to-host copy queued on the ring's stream behind any
        dispatch in flight (so it reads the block's final content).  No
        host wait: the slot's event marks when the bytes have landed."""
        block = self._slab.acquire()
        c = self.cache
        for key, view in block.items():
            view.copy_(c[key].narrow(1, blk, 1), non_blocking=True)
        self._slab.mark([block.slot])
        return block

    def _import_payload(self, payload) -> HostBlock:
        """``PagedCacheManager.host_import``: a fetched payload (a store
        hit: CPU tensors or arrays of the tier's shapes and dtypes)
        copied into a free slot, after the slot's last queued copy."""
        block = self._slab.acquire()
        try:
            block.wait()
            for key, view in block.items():
                src = torch.as_tensor(payload[key])
                if src.shape != view.shape or src.dtype != view.dtype:
                    raise ValueError(
                        f"imported payload {key!r} is {src.dtype} "
                        f"{tuple(src.shape)}, the tier holds {view.dtype} "
                        f"{tuple(view.shape)}")
                view.copy_(src)
        except Exception:
            block.release()
            raise
        return block

    @torch.inference_mode()
    def dispatch_promotions(self, promotes) -> None:
        """Upload a batch of host payloads into their RESERVED pool blocks
        (``promotes``: ``(dst block, payload, key)`` triples — host-tier
        hits from ``pool.take_promotions()``, or a spilled lane's blocks —
        each payload one block: ``k``/``v`` [L, 1, H, bs, D], and under
        int8 ``ks``/``vs`` [L, 1, H]) through the in-place promote
        scatter.  Each block crosses in a non-blocking copy (from its
        pinned slot, for a tier payload), queued in stream order between
        replays (never captured into a graph); tier slots then go back to
        the slab, their reuse ordered behind these copies on the same
        stream."""
        keys = ("k", "v", "ks", "vs") if self.quant else ("k", "v")
        dev = {}
        for key in keys:
            ref = promotes[0][1][key]
            buf = torch.empty((len(promotes), ref.shape[0]) + ref.shape[2:],
                              dtype=ref.dtype, device=self.device)
            for j, (_, payload, _) in enumerate(promotes):
                buf[j].copy_(payload[key][:, 0], non_blocking=True)
            dev[key] = buf.transpose(0, 1)
        if self._slab is not None:
            self._slab.mark([p.slot for _, p, _ in promotes
                             if isinstance(p, HostBlock)])
        self._promote_blocks([int(dst) for dst, _, _ in promotes], dev)
        for _, payload, _ in promotes:
            if isinstance(payload, HostBlock):
                payload.release()

    def close_host_tier(self) -> None:
        """Give the host tier's memory back (the ring is closing): the
        tier's payloads are dropped and the slab is unpinned."""
        if self.pool is not None:
            self.pool.drop_host_tier()
        if self._slab is not None:
            self._slab.close()

    @torch.inference_mode()
    def spill_lane(self, slot: int, ids=None) -> Dict[str, Any]:
        """Capture a LIVE paged lane to host memory: its mapped blocks'
        exact pool bytes (codes and scales under int8, plus the lane's
        staging-tail row), its fill position and its carry token,
        temperature and sampling seed — everything :meth:`restore_lane`
        needs to resume the lane bit-identically.  Reads only: the
        caller retires the lane afterwards.  Call it at a chunk
        boundary, with no dispatch in flight.

        The keys and layouts are the JAX package's (``n_blocks``,
        ``pos``, ``tok``, ``temp``; ``k``/``v`` [L, m, H_kv, bs, D];
        ``ks``/``vs`` [L, m, H_kv] and ``kt``/``vt`` [L, H_kv, bs, D]
        under int8; on a speculative ring the draft lane ``dk``/``dv``
        [L, H_kv, S, D] and ``dpos``; on an adapter ring the lane's
        adapter slot ``aid``), with ``seed`` (the lane's int64
        sampler seed) where JAX keeps ``key``.  The tensors are CPU
        tensors — pinned on the card, where the device copies are queued
        together and waited for once.

        ``ids``: the lane's pool blocks, given by the leader of a
        tensor-parallel ring (infer/tp.py) to a follower, whose own
        allocator is not the ring's: each rank spills its own kv-head
        slice of the same blocks."""
        if ids is None:
            pm = self.pool
            ids = pm.table[slot][:int(pm.mapped_count[slot])]
        m = len(ids)
        ids = to_device(np.asarray(ids, np.int32), self.device).long()
        c = self.cache
        parts = {"k": c["k"].index_select(1, ids),
                 "v": c["v"].index_select(1, ids)}
        if self.quant:
            parts["ks"] = c["ks"].index_select(1, ids)
            parts["vs"] = c["vs"].index_select(1, ids)
            parts["kt"] = c["kt"][:, slot].clone(
                memory_format=torch.contiguous_format)
            parts["vt"] = c["vt"][:, slot].clone(
                memory_format=torch.contiguous_format)
        if self.spec_k:
            # the DRAFT lane is resident context too (a contiguous ring
            # lane, captured whole: rows past dpos are hidden by the fill
            # mask): a round resumed without it would propose from a
            # zeroed draft cache and diverge from the uninterrupted stream
            # the moment a draft is accepted
            d = self.dcache
            parts["dk"] = d["k"][:, slot].clone(
                memory_format=torch.contiguous_format)
            parts["dv"] = d["v"][:, slot].clone(
                memory_format=torch.contiguous_format)
        lane = torch.stack([c["pos"][slot].long(), self.tok[slot].long(),
                            self.seeds[slot].long()]
                           + ([self.dcache["pos"][slot].long()]
                              if self.spec_k else []))
        temp = self.temp[slot:slot + 1].clone()
        hosts, ev = _to_host_async(*parts.values(), lane, temp)
        if ev is not None:
            ev.synchronize()
        *blocks, lane, temp = hosts
        spill: Dict[str, Any] = {
            "n_blocks": m, "pos": int(lane[0]), "tok": int(lane[1]),
            "temp": float(temp[0]), "seed": int(lane[2])}
        spill.update(zip(parts, blocks))
        if self.spec_k:
            spill["dpos"] = int(lane[3])
        if self.adapters is not None:
            spill["aid"] = int(self.aid_host[slot])
        return spill

    @torch.inference_mode()
    def restore_lane(self, slot: int, spill: Dict[str, Any],
                     ids=None) -> None:
        """Re-admit a spilled lane into the empty ``slot``: map fresh pool
        blocks, upload the spilled blocks through the promote scatter,
        write the staging-tail row (int8), the draft lane (speculative)
        and the lane's pos, tok, temp and seed — every write in place,
        so the captured graphs read the restored lane at the addresses
        they hold, and the resumed stream is bit-identical to the
        uninterrupted one.  No forward runs.
        Raises :class:`~paddle_operator_tpu_torch.infer.paged.
        NoFreeBlocks` when the pool cannot map the lane (the caller
        retires ``slot`` to roll the partial mapping back).  ``ids``
        (a follower of a tensor-parallel ring): the blocks the leader's
        allocator mapped, uploaded without touching this rank's."""
        m = int(spill["n_blocks"])
        if ids is None:
            pm = self.pool
            if pm.mapped_count[slot]:
                raise AssertionError(f"slot {slot} still holds blocks")
            pm.ensure(slot, m * self.block_size)
            ids = pm.table[slot][:m]
        before = self._state_ptrs()
        keys = ("k", "v", "ks", "vs") if self.quant else ("k", "v")
        if m:
            self._promote_blocks(ids, {key: spill[key] for key in keys})
        c = self.cache
        if self.quant:
            c["kt"][:, slot].copy_(to_device(spill["kt"], self.device))
            c["vt"][:, slot].copy_(to_device(spill["vt"], self.device))
        if self.spec_k:
            d = self.dcache
            d["k"][:, slot].copy_(to_device(spill["dk"], self.device))
            d["v"][:, slot].copy_(to_device(spill["dv"], self.device))
            d["pos"][slot].fill_(int(spill["dpos"]))
        # fill_, not item assignment: assigning a Python number to a
        # CUDA tensor copies it from pageable memory and waits for the
        # stream, i.e. for any dispatch in flight
        c["pos"][slot].fill_(int(spill["pos"]))
        self.tok[slot].fill_(int(spill["tok"]))
        self.temp[slot].fill_(float(spill["temp"]))
        self.seeds[slot].fill_(int(spill["seed"]))
        if "aid" in spill:
            self.set_aid(slot, spill["aid"])
        if self._state_ptrs() != before:
            raise AssertionError("restore_lane rebound a tensor the "
                                 "captured graphs read")

    @torch.inference_mode()
    def scrub_lane(self, slot: int, blocks) -> None:
        """Clear a quarantined lane's private state before its blocks go
        back to the free list, in place and queued on the stream behind
        the dispatches in flight (no wait): pool blocks ``blocks`` to
        zero (on the int8 pool codes 0 and scales 1.0, the all-zero
        block's scale, so no stale scale dequantizes a NaN) and, on the
        int8 pool, lane ``slot``'s staging-tail row, where the poisoned
        rows of a block not yet complete live."""
        c = self.cache
        if blocks:
            ids = to_device(np.asarray(blocks, np.int32),
                            self.device).long()
            for key in ("k", "v"):
                c[key].index_fill_(1, ids, 0)
            if self.quant:
                for key in ("ks", "vs"):
                    c[key].index_fill_(1, ids, 1.0)
        if self.quant:
            c["kt"][:, slot].zero_()
            c["vt"][:, slot].zero_()

    def drop_spill(self, spill: Dict[str, Any]) -> None:
        """A parked lane's spill is dropped without a restore (nothing
        to do here; a tensor-parallel ring's leader tells its
        followers)."""

    def stop_followers(self) -> None:
        """The ring is closing (nothing to do without followers)."""

    # -- live weight swap: the device half ----------------------------------

    def swap_weights(self, params: Any, draft_params: Any = None) -> tuple:
        """Make ``params`` (and, on a speculative ring, ``draft_params``:
        a swap ships the draft with the target, whose drafts are
        verified against the new weights only) the served models and
        return the old ``(params, draft_params)`` for a rollback.  The
        programs take the params as an argument, so a model of another
        weight-quant mode routes its projections as at boot (kernel A or
        B for quantized ones).  The captured graphs hold the old
        models' addresses: the caller has parked every lane and runs
        :meth:`reset_state` and :meth:`capture_graphs` before the next
        dispatch, and keeps the returned models alive until that capture
        is done (collecting an object that holds a graph during a
        capture invalidates it)."""
        if self.spec_k and draft_params is None:
            raise ValueError(
                "speculative ring: a weight swap must ship the draft "
                "with the target (drafts are verified against the NEW "
                "params only; a stale draft would silently collapse "
                "acceptance)")
        for model, what in ((params, "params"),
                            (draft_params if self.spec_k else None,
                             "draft params")):
            if model is None:
                continue
            dev = model.tok_embed.embedding.device
            if dev != self.device:
                raise ValueError(f"the new {what} are on {dev}, the ring "
                                 f"on {self.device}")
        old = (self.params, self.draft_params)
        self.params = params
        if self.spec_k:
            self.draft_params = draft_params
        if self.prefill_exec is not None and not self.prefill_remote:
            # the in-process engine dispatches the same model; the
            # scheduler quiesced its queues before the flip, so no job
            # reads a torn reference
            self.prefill_exec.params = params
        return old

    # -- admission programs ------------------------------------------------

    def suffix_bucket(self, n: int) -> int:
        """Padding for a prefix-hit SUFFIX forward: a power-of-two ladder
        up to one block, then block multiples, capped at the lane view
        (the JAX package's compile buckets; here they only bound the
        pad rows, which write the trash block)."""
        cap = self.pool.view_len
        b = 8
        while b < min(n, self.block_size):
            b *= 2
        if b < n:
            b = -(-n // self.block_size) * self.block_size
        return min(b, cap)

    def suffix_insert(self, sb: int):
        ins = self._suffix_inserts.get(sb)
        if ins is None:
            ins = self._pg.make_paged_suffix_insert(
                self.cfg, sb, self.block_size, self.top_k, self.top_p,
                quant=self.quant)
            self._suffix_inserts[sb] = ins
        return ins

    # -- chunked prefill: the slice programs and the staging lane -----------

    def chunk_prog(self, staging_len: Optional[int]):
        """Intermediate chunked-prefill slice program: paged (keyed by
        the fixed slice width) or contiguous (keyed by staging
        length)."""
        sb = self.prefill_chunk
        key = ("paged", sb) if self.paged else ("ring", sb, staging_len)
        prog = self._chunk_progs.get(key)
        if prog is None:
            if self.paged:
                prog = self._pg.make_paged_prefill_chunk(
                    self.cfg, sb, self.block_size, quant=self.quant)
            else:
                prog = make_prefill_chunk(self.cfg, sb, staging_len)
            self._chunk_progs[key] = prog
        return prog

    def final_insert(self, staging_len: Optional[int]):
        """Final chunked-prefill slice program.  A paged ring reuses the
        SUFFIX insert at the slice width (a chunked prefill's last slice
        IS a suffix insert whose 'hit' is the rows the earlier slices
        wrote; the ``suffix_bucket`` ladder never re-pads it)."""
        sb = self.prefill_chunk
        if self.paged:
            return self.suffix_insert(sb)
        key = ("ring", sb, staging_len)
        prog = self._final_inserts.get(key)
        if prog is None:
            prog = make_chunked_final_insert(self.cfg, sb, staging_len,
                                             self.top_k, self.top_p)
            self._final_inserts[key] = prog
        return prog

    def spec_attach(self, bucket: int):
        """The disaggregated attach of a speculative ring (the draft
        lane's prefill with the lane activation), built once per
        bucket."""
        prog = self._spec_attach.get(bucket)
        if prog is None:
            prog = make_spec_attach(self.cfg, self.draft_cfg, bucket)
            self._spec_attach[bucket] = prog
        return prog

    def staging_len(self, bucket: int) -> int:
        """Contiguous chunked prefill stages in a private lane cache
        whose length is the bucket rounded up to whole slices, so every
        full-width slice write stays in bounds (a clamped write would
        shift pad rows over real ones).  The splice truncates back to
        the ring allocation."""
        sb = self.prefill_chunk
        return -(-bucket // sb) * sb

    def make_staging(self, bucket: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fresh zeroed staging K/V for one contiguous chunked prefill
        ([L, 1, H_kv, staging_len(bucket), D] on the ring's device)."""
        shape = (self.cfg.n_layers, 1, self.cfg.n_kv_heads,
                 self.staging_len(bucket), self.cfg.head_dim)
        return (torch.zeros(shape, dtype=self.cfg.dtype, device=self.device),
                torch.zeros(shape, dtype=self.cfg.dtype, device=self.device))

    def pool_bytes(self) -> int:
        """Device bytes held by the KV cache (block pool with the int8
        pool's scale planes and staging tails, or the contiguous ring) —
        the ``tpujob_serve_kv_pool_bytes`` gauge.  Shape arithmetic, kept
        at :meth:`reset_state`, so a status read during a rebuild (while
        the old pool is released) still answers."""
        return self._pool_bytes

    def param_bytes(self) -> int:
        """Device bytes of the served params (the target, plus the draft
        on a speculative ring), as the JAX package counts them
        (infer/quant.py ``param_bytes``: a quantized projection's codes
        and scales, not the RoPE tables) — the
        ``tpujob_serve_param_bytes`` gauge."""
        total = Q.param_bytes(self.params)
        if self.draft_params is not None:
            total += Q.param_bytes(self.draft_params)
        return total
