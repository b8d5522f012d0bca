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
replays and in place, so the graphs keep their addresses.  Not ported
yet (ROADMAP.md Queue A): speculative rounds, chunked and disaggregated
prefill, the host tier and LoRA adapters.
"""

from __future__ import annotations

import gc
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from paddle_operator_tpu_torch.infer import decode as D
from paddle_operator_tpu_torch.models.llama import LlamaConfig
from paddle_operator_tpu_torch.ops.decode_attention import (
    decode_attention,
    paged_decode_attention,
)


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
    consumes (None at ``n_steps`` 1, where every row is valid).  On the
    card their copies to pinned host memory are queued right behind the
    dispatch (``_host``, ``_event``), so the consume waits for THIS
    dispatch only, never for the one dispatched after it.  Under a CUDA
    graph the device tensors are the graph's static outputs, which the
    next replay overwrites: read them through the host copies."""

    __slots__ = ("toks", "counts", "n_steps", "_host", "_event")

    def __init__(self, toks, counts, n_steps):
        self.toks = toks
        self.counts = counts
        self.n_steps = n_steps
        self._host, self._event = _to_host_async(
            *(t for t in (toks, counts) if t is not None))

    def host(self) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """``(toks, counts)`` on the host — the ring's one sync."""
        if self._event is not None:
            self._event.synchronize()
        toks = self._host[0].numpy()
        return toks, (self._host[1].numpy() if self.counts is not None
                      else None)


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
    if torch.device(device).type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)


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
              sin: torch.Tensor, pos: torch.Tensor):
    """Pre-attention half for ONE new token per lane at per-lane
    positions ``pos`` [B]: RMSNorm -> projections -> RoPE at each
    lane's own position.  Shapes [B, 1, H, D].  Positions past the RoPE
    table (pipelined overshoot of a finished lane) read its last row,
    as the JAX gather clamps."""
    b = x.shape[0]
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = D._rms(x, lp.attn_norm.scale, cfg.norm_eps, cfg.dtype)
    q = D._mm(h, lp.attn.wq.kernel, cfg.dtype).reshape(b, 1, hq, d)
    k = D._mm(h, lp.attn.wk.kernel, cfg.dtype).reshape(b, 1, hkv, d)
    v = D._mm(h, lp.attn.wv.kernel, cfg.dtype).reshape(b, 1, hkv, d)
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
                v_cache: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """One decoder layer for ONE new token per lane ([B, 1, dim] at lane
    positions ``pos``) with the plain einsum attention over the whole
    lane (masked past ``pos``); writes the layer's cache in place."""
    b = x.shape[0]
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _qkv_ring(cfg, lp, x, cos, sin, pos)
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
                  cache: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """tok [B] at per-lane cache['pos'] -> (logits [B, V] f32, cache
    written in place with ``pos + 1``).  With the kernel selected (a
    CUDA tensor) each layer's attention is ``decode_attention`` over
    that layer's cache view with lengths ``pos + 1`` — kernel #1 serves
    the contiguous ring as it serves batch decoding."""
    pos = cache["pos"]
    x = params.tok_embed.embedding.to(cfg.dtype)[tok[:, None].long()]
    cos, sin = params.rope_cos, params.rope_sin
    b = x.shape[0]
    hq, d = cfg.n_heads, cfg.head_dim
    k_cache, v_cache = cache["k"], cache["v"]
    if cfg.resolved_decode_attn(x.device) == "kernel":
        lengths = pos + 1
        for li, lp in enumerate(params.layers):
            q, k, v = _qkv_ring(cfg, lp, x, cos, sin, pos)
            _write_lane(k_cache[li], k[:, 0], pos)
            _write_lane(v_cache[li], v[:, 0], pos)
            out = decode_attention(q[:, 0].contiguous(), k_cache, v_cache,
                                   lengths, layer=li)
            x = D._finish_layer(cfg, lp, x,
                                out.reshape(b, 1, hq * d).to(cfg.dtype))
    else:
        for li, lp in enumerate(params.layers):
            x = _layer_step(cfg, lp, x, cos, sin, k_cache[li], v_cache[li],
                            pos)
    x = D._rms(x, params.final_norm.scale, cfg.norm_eps, cfg.dtype)
    logits = D._mm(x, params.lm_head.kernel, cfg.dtype).float()
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


def _gumbel(seeds: torch.Tensor, pos: torch.Tensor,
            vocab: int) -> torch.Tensor:
    """[B, V] standard Gumbel noise, a pure function of each lane's
    (seed, position) and the vocab id — computed on the device, no
    generator state, so a lane's draws never depend on its
    co-residents or on how many other lanes sampled before it."""
    s = _mix32((seeds.long() & _M32) ^ 0x9E3779B9)
    s = _mix32(s ^ (pos.long() & _M32))
    ids = torch.arange(vocab, device=seeds.device, dtype=torch.int64)
    h = _mix32((s[:, None] + _mul32(ids, 0x85EBCA6B)[None, :]) & _M32)
    h = _mix32(h ^ 0x27D4EB2F)
    u = (h >> 8).float() * (2.0 ** -24) + 2.0 ** -25      # (0, 1)
    return -torch.log(-torch.log(u))


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
           chunk_tokens: int, top_k: Optional[int], top_p: Optional[float]
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``chunk_tokens`` ring ticks — the body every resident program
    shares (contiguous or paged, 1-step or fused).  ``forward(tok,
    cache) -> (logits, cache')`` is one tick's forward; lanes outside
    ``mask`` compute (the price of fixed shapes) but their position is
    ZEROED each tick and their token held.  Returns ``(tok', toks
    [chunk, B])``; ``cache['pos']`` is rebound each tick."""
    toks = []
    for _ in range(chunk_tokens):
        pos = cache["pos"]
        logits, new = forward(tok, cache)
        nxt = _sample_tokens(logits, temp, seeds, pos, top_k, top_p)
        cache["pos"] = torch.where(mask, new["pos"],
                                   torch.zeros_like(new["pos"]))
        tok = torch.where(mask, nxt, tok)
        toks.append(tok)
    return tok, torch.stack(toks)


def make_chunk_step(cfg: LlamaConfig, chunk_tokens: int,
                    top_k: Optional[int] = None,
                    top_p: Optional[float] = None):
    """The contiguous ring's resident decode step.

    ``step(params, cache, tok [B], temp [B], seeds [B], active [B])
    -> (tok', toks [chunk, B])``

    Runs ``chunk_tokens`` ticks for every lane, the cache updated in
    place.  Inactive lanes compute (the price of fixed shapes) but
    their position is ZEROED each tick, so their ignored writes land at
    row 0, which the next admission's splice overwrites."""

    def step(params, cache, tok, temp, seeds, active):
        return _ticks(lambda t, c: _ring_forward(cfg, params, t, c), cache,
                      tok, temp, seeds, active, chunk_tokens, top_k, top_p)

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


def _fused(run_chunk, n_steps: int, chunk_tokens: int,
           cache: Dict[str, torch.Tensor], tok: torch.Tensor,
           active: torch.Tensor, eos: torch.Tensor, left: torch.Tensor,
           steps: torch.Tensor):
    """The megastep's outer loop over ``n_steps`` chunks (the JAX
    outer ``scan``): ``run_chunk(tok, live) -> (tok', toks [chunk, B])``
    runs one chunk with the lanes outside ``live`` masked; at each
    boundary :func:`_mega_continue` advances the continuation state and
    a lane that was not live through the chunk gets back the position
    it had before it (so a lane frozen by its step budget resumes where
    its last consumed token left it).  Returns ``(tok', toks [n, chunk,
    B], counts [n, B])``."""
    live = active & (left > 0) & (steps > 0)
    all_toks, counts = [], []
    for _ in range(n_steps):
        p0 = cache["pos"].clone()
        tok, toks = run_chunk(tok, live)
        raw = torch.where(live, chunk_tokens, 0).to(torch.int32)
        count, live2, left, steps = _mega_continue(toks, raw, live, left,
                                                   steps, eos)
        cache["pos"] = torch.where(live, cache["pos"], p0)
        live = live2
        all_toks.append(toks)
        counts.append(count)
    return tok, torch.stack(all_toks), torch.stack(counts)


def make_megastep(cfg: LlamaConfig, chunk_tokens: int, n_steps: int,
                  top_k: Optional[int] = None,
                  top_p: Optional[float] = None):
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

    ``mega(params, cache, tok, temp, seeds, active, eos, left, steps)
    -> (tok', toks [n, chunk, B], counts [n, B])``, the cache and
    positions updated in place (``cache['pos']`` rebound).
    ``counts[r, b]`` is the number of ``toks[r, :, b]`` rows the host
    consumes for iteration ``r`` (0 once the lane is dead)."""

    def mega(params, cache, tok, temp, seeds, active, eos, left, steps):
        def run_chunk(t, live):
            return _ticks(lambda tt, c: _ring_forward(cfg, params, tt, c),
                          cache, t, temp, seeds, live, chunk_tokens, top_k,
                          top_p)

        return _fused(run_chunk, n_steps, chunk_tokens, cache, tok, active,
                      eos, left, steps)

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
    ring["pos"][slot] = int(prompt_len)


def make_prefill_insert(cfg: LlamaConfig, bucket: int,
                        top_k: Optional[int] = None,
                        top_p: Optional[float] = None):
    """Contiguous-ring admission: prefill the prompt, splice its KV
    into ring lane ``slot``, sample the first token and set the lane's
    tok/temp/seed — device work only, nothing read back.

    ``insert(params, cache, tok, temp, seeds, prompt [1, n],
    prompt_len, slot, temp_val, seed) -> first_token`` (0-d device
    tensor).  ``bucket`` is the admission's prompt bucket; the prompt
    is forwarded at its own length."""
    from paddle_operator_tpu_torch.infer.paged import _set_lane

    def insert(params, cache, tok, temp, seeds, prompt, prompt_len, slot,
               temp_val, seed):
        lane = D.init_cache(cfg, 1, prompt_len, device=prompt.device)
        logits, lane = D._forward(cfg, params, prompt[:, :prompt_len],
                                  lane, last_only=True)
        _splice_lane(cache, lane, slot, prompt_len)
        return _set_lane(cache, tok, temp, seeds, logits[0, -1],
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
# RingExecutor: step + admission programs and device state for one ring
# ---------------------------------------------------------------------------


class _Graph:
    """One captured resident program: the graph, its static outputs and
    the kernel launches it recorded."""

    __slots__ = ("graph", "toks", "counts", "launches")

    def __init__(self, graph, toks, counts, launches):
        self.graph = graph
        self.toks = toks
        self.counts = counts
        self.launches = launches


_COUNTERS = ((decode_attention, "launches"),
             (paged_decode_attention, "launches"),
             (paged_decode_attention, "quant_launches"))


def _launch_counts() -> List[int]:
    """The decode kernels' launch counts (contiguous, paged, int8)."""
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
    addresses, and admissions write it in place between replays."""

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
                 kv_quant: str = "none", megastep: int = 1) -> None:
        if int(megastep) < 1:
            raise ValueError(f"megastep must be >= 1 (got {megastep})")
        self.megastep = int(megastep)
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
        if self.paged:
            self._pg = PG
            self.block_size = int(block_size)
            self._num_blocks = num_blocks
            self.prefix_cache = prefix_cache
            self.pool = PG.PagedCacheManager(
                slots, max_len, self.block_size, num_blocks,
                prefix_cache=self.prefix_cache)
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
            self.step = PG.make_paged_chunk_step(cfg, chunk_tokens, top_k,
                                                 top_p, quant=self.quant)
            self.inserts = {b: PG.make_paged_prefill_insert(
                cfg, b, self.block_size, top_k, top_p, quant=self.quant)
                for b in self.buckets}
        else:
            self.block_size = int(block_size)
            self.prefix_cache = False
            self.step = make_chunk_step(cfg, chunk_tokens, top_k, top_p)
            self.inserts = {b: make_prefill_insert(cfg, b, top_k, top_p)
                            for b in self.buckets}
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
            self.pool = self._pg.PagedCacheManager(
                self.slots, self.max_len, self.block_size,
                self._num_blocks, prefix_cache=self.prefix_cache)
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
        if self.cfg.resolved_decode_attn(self.device) == "kernel":
            from paddle_operator_tpu_torch.ops import _build

            _build.load("decode_attention")
        self.capture_graphs()

    # -- plan replay: the ONE resident dispatch path -----------------------

    def megastep_prog(self, n: int):
        """The N-fused-iteration program for this ring's mode
        (contiguous, paged or int8 paged), built once per N."""
        prog = self._mega.get(n)
        if prog is None:
            if self.paged:
                prog = self._pg.make_paged_megastep(
                    self.cfg, self.chunk, n, self.top_k, self.top_p,
                    quant=self.quant)
            else:
                prog = make_megastep(self.cfg, self.chunk, n, self.top_k,
                                     self.top_p)
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
        return self._program(plan.n_steps)

    def _program(self, n_steps: int):
        """The resident program of ``n_steps`` fused iterations over the
        static state and the uploaded plan — what :meth:`run` calls and
        :meth:`capture_graphs` records (1 step: ``self.step``, the seam
        pacing and fault-injection wrappers install on).  The state
        stays at its addresses: positions and tokens are written back in
        place.  Returns ``(toks, counts)``."""
        active_i, eos, left, steps, table = self._plan_views()
        active = active_i != 0
        lead = (table,) if self.paged else ()
        pos = self.cache["pos"]
        if n_steps == 1:
            tok, toks = self.step(self.params, self.cache, *lead, self.tok,
                                  self.temp, self.seeds, active)
            counts = None
        else:
            tok, toks, counts = self.megastep_prog(n_steps)(
                self.params, self.cache, *lead, self.tok, self.temp,
                self.seeds, active, eos, left, steps)
        pos.copy_(self.cache["pos"])
        self.cache["pos"] = pos
        self.tok.copy_(tok)
        return toks, counts

    def replay(self, plan: ExecPlan) -> DispatchResult:
        """Execute one scheduler-filled :class:`ExecPlan` against the
        ring's device state: ``plan.n_steps`` chunks of ``chunk_tokens``
        ticks for every lane (inactive lanes masked).  On the card, the
        CUDA graph of that program (a missing graph raises: nothing runs
        eagerly there); on the CPU, :meth:`run`.  The watchdog brackets
        it; the tokens come back as device tensors whose host copies are
        already queued."""
        n = plan.n_steps
        if self.device.type != "cuda":
            return DispatchResult(*self.run(plan), n)
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
        return DispatchResult(g.toks, g.counts, n)

    @property
    def needs_capture(self) -> bool:
        """On the card, before the first dispatch and after every
        :meth:`reset_state`: the graphs must be captured (while no lane
        is resident)."""
        return self.device.type == "cuda" and self._graphs is None

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
        if bool(self.cache["pos"].any()):
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
                        toks, counts = self._program(n)
                    graphs[n] = _Graph(g, toks, counts, [
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
        ptrs.update(tok=self.tok.data_ptr(), temp=self.temp.data_ptr(),
                    seeds=self.seeds.data_ptr(), plan=self._plan.data_ptr())
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

    @torch.inference_mode()
    def dispatch_promotions(self, promotes) -> None:
        """Upload a batch of host payloads into their RESERVED pool blocks
        (``promotes``: ``(dst block, payload, key)`` triples, a payload
        holding one block: ``k``/``v`` [L, 1, H, bs, D], and under int8
        ``ks``/``vs`` [L, 1, H]) as one slab through the promote
        scatter.  Eager, in stream order, between replays — never
        captured into a graph — and in place."""
        keys = ("k", "v", "ks", "vs") if self.quant else ("k", "v")
        self._promote_blocks(
            [int(dst) for dst, _, _ in promotes],
            {key: torch.cat([p[key] for _, p, _ in promotes], dim=1)
             for key in keys})

    @torch.inference_mode()
    def spill_lane(self, slot: int) -> Dict[str, Any]:
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
        under int8), with ``seed`` (the lane's int64 sampler seed) where
        JAX keeps ``key``.  The tensors are CPU tensors — pinned on the
        card, where the device copies are queued together and waited
        for once."""
        pm = self.pool
        m = int(pm.mapped_count[slot])
        ids = to_device(np.asarray(pm.table[slot][:m], np.int32),
                        self.device).long()
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
        lane = torch.stack([c["pos"][slot].long(), self.tok[slot].long(),
                            self.seeds[slot].long()])
        temp = self.temp[slot:slot + 1].clone()
        hosts, ev = _to_host_async(*parts.values(), lane, temp)
        if ev is not None:
            ev.synchronize()
        *blocks, lane, temp = hosts
        spill: Dict[str, Any] = {
            "n_blocks": m, "pos": int(lane[0]), "tok": int(lane[1]),
            "temp": float(temp[0]), "seed": int(lane[2])}
        spill.update(zip(parts, blocks))
        # the draft lane (spec_k, Queue A item 7) and the adapter id
        # (aid, item 8) join the spill with those items; the ring
        # refuses both at construction
        return spill

    @torch.inference_mode()
    def restore_lane(self, slot: int, spill: Dict[str, Any]) -> None:
        """Re-admit a spilled lane into the empty ``slot``: map fresh pool
        blocks, upload the spilled blocks through the promote scatter,
        write the staging-tail row (int8) and the lane's pos, tok, temp
        and seed — every write in place, so the captured graphs read the
        restored lane at the addresses they hold, and the resumed stream
        is bit-identical to the uninterrupted one.  No forward runs.
        Raises :class:`~paddle_operator_tpu_torch.infer.paged.
        NoFreeBlocks` when the pool cannot map the lane (the caller
        retires ``slot`` to roll the partial mapping back)."""
        pm = self.pool
        if pm.mapped_count[slot]:
            raise AssertionError(f"slot {slot} still holds blocks")
        before = self._state_ptrs()
        m = int(spill["n_blocks"])
        pm.ensure(slot, m * self.block_size)
        keys = ("k", "v", "ks", "vs") if self.quant else ("k", "v")
        if m:
            self._promote_blocks(pm.table[slot][:m],
                                 {key: spill[key] for key in keys})
        c = self.cache
        if self.quant:
            c["kt"][:, slot].copy_(to_device(spill["kt"], self.device))
            c["vt"][:, slot].copy_(to_device(spill["vt"], self.device))
        c["pos"][slot] = int(spill["pos"])
        self.tok[slot] = int(spill["tok"])
        self.temp[slot] = float(spill["temp"])
        self.seeds[slot] = int(spill["seed"])
        if self._state_ptrs() != before:
            raise AssertionError("restore_lane rebound a tensor the "
                                 "captured graphs read")

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

    def pool_bytes(self) -> int:
        """Device bytes held by the KV cache (block pool with the int8
        pool's scale planes and staging tails, or the contiguous ring) —
        the ``tpujob_serve_kv_pool_bytes`` gauge.  Shape arithmetic, kept
        at :meth:`reset_state`, so a status read during a rebuild (while
        the old pool is released) still answers."""
        return self._pool_bytes

    def param_bytes(self) -> int:
        """Device bytes of the served params — the
        ``tpujob_serve_param_bytes`` gauge."""
        return sum(p.numel() * p.element_size()
                   for p in self.params.parameters())
