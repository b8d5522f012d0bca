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
(``kv_quant="int8"``, SERVE_KV_QUANT).  Not ported yet (ROADMAP.md
Queue A): speculative rounds, the megastep (``n_steps > 1``), chunked
and disaggregated prefill, the host tier, lane spill/restore and LoRA
adapters.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from paddle_operator_tpu_torch.infer import decode as D
from paddle_operator_tpu_torch.models.llama import LlamaConfig
from paddle_operator_tpu_torch.ops.decode_attention import decode_attention


class ExecPlan:
    """One resident ring dispatch, fully described host-side: the
    scheduler FILLS a plan and :meth:`RingExecutor.replay` executes it.

    - ``n_steps``  fused ring iterations (only 1 is ported);
    - ``active``   per-lane participation (host bools, [slots]);
    - ``table``    block-table snapshot (np [slots, M]; None on the
      contiguous ring)."""

    __slots__ = ("n_steps", "active", "table")

    def __init__(self, n_steps, active, table=None):
        self.n_steps = int(n_steps)
        self.active = active
        self.table = table


class DispatchResult:
    """What one :meth:`RingExecutor.replay` returns — the scheduler's
    pipelining queue holds it until the consume boundary.  ``toks`` is
    the device tensor [chunk, B]; on the card its copy to pinned host
    memory is queued right behind the chunk (``_host``, ``_event``), so
    the consume waits for THIS chunk only, never for the chunk
    dispatched after it."""

    __slots__ = ("toks", "n_steps", "_host", "_event")

    def __init__(self, toks, n_steps):
        self.toks = toks
        self.n_steps = n_steps
        self._host, self._event = _to_host_async(toks)

    def host_toks(self) -> np.ndarray:
        """The chunk's tokens on the host — the ring's one sync."""
        if self._event is not None:
            self._event.synchronize()
        return self._host.numpy()


def _to_host_async(t: torch.Tensor):
    """Queue a device->host copy of ``t`` into pinned memory on the
    current stream and return ``(host_tensor, event)``; the host tensor
    is valid once the event completes.  CPU tensors come back as they
    are, with no event."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    ev = torch.cuda.Event(blocking=True)
    ev.record()
    return host, ev


def to_device(arr, device, dtype=None) -> torch.Tensor:
    """Host array -> device tensor without a stream sync: on the card
    the copy goes through pinned memory, asynchronously, in stream
    order (a pageable copy would wait for every queued chunk)."""
    t = torch.as_tensor(np.ascontiguousarray(arr))
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
        toks = []
        for _ in range(chunk_tokens):
            pos = cache["pos"]
            logits, new = _ring_forward(cfg, params, tok, cache)
            nxt = _sample_tokens(logits, temp, seeds, pos, top_k, top_p)
            cache["pos"] = torch.where(active, new["pos"],
                                       torch.zeros_like(new["pos"]))
            tok = torch.where(active, nxt, tok)
            toks.append(tok)
        return tok, torch.stack(toks)

    return step


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


class RingExecutor:
    """Owns everything device-side about one continuous-batching ring:
    the resident chunk step, the admission inserts (cold, and suffix
    on a prefix hit), the KV cache or block pool, and the per-lane
    tok/temp/seed state.  The scheduler (infer/scheduler.py
    ContinuousBatcher) holds no tensors of its own — it sequences work
    on this object, which is what makes the watchdog's full device
    rebuild (:meth:`reset_state`) possible."""

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
                 kv_quant: str = "none") -> None:
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
        self.tok = torch.zeros((self.slots,), dtype=torch.int32, device=dev)
        self.temp = torch.zeros((self.slots,), dtype=torch.float32,
                                device=dev)
        self.seeds = torch.zeros((self.slots,), dtype=torch.int64,
                                 device=dev)

    def prewarm(self) -> None:
        """Build the kernel library this ring launches (PyTorch has no
        programs to compile) so the first dispatch does not pay the
        nvcc build — a no-op off the card."""
        if self.device.type == "cuda" and \
                self.cfg.resolved_decode_attn(self.device) == "kernel":
            from paddle_operator_tpu_torch.ops import _build

            _build.load("decode_attention")

    # -- plan replay: the ONE resident dispatch path -----------------------

    def replay(self, plan: ExecPlan) -> DispatchResult:
        """Execute one scheduler-filled :class:`ExecPlan` against the
        ring's device state: one chunk of ``chunk_tokens`` ticks for
        every lane (inactive lanes masked).  The watchdog brackets it;
        the tokens come back as a device tensor whose host copy is
        already queued."""
        if plan.n_steps != 1:
            raise NotImplementedError(
                "the megastep (n_steps > 1, SERVE_MEGASTEP) is not ported "
                "to the torch package yet (ROADMAP.md Queue A)")
        dev = self.device
        active = to_device(np.asarray(plan.active, bool), dev)
        if self.paged:
            tbl = to_device(plan.table, dev, torch.int32)
            self.tok, toks = self.step(self.params, self.cache, tbl,
                                       self.tok, self.temp, self.seeds,
                                       active)
        else:
            self.tok, toks = self.step(self.params, self.cache, self.tok,
                                       self.temp, self.seeds, active)
        return DispatchResult(toks, 1)

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
        the ``tpujob_serve_kv_pool_bytes`` gauge.  Shape arithmetic."""
        return sum(t.numel() * t.element_size()
                   for key, t in self.cache.items() if key != "pos")

    def param_bytes(self) -> int:
        """Device bytes of the served params — the
        ``tpujob_serve_param_bytes`` gauge."""
        return sum(p.numel() * p.element_size()
                   for p in self.params.parameters())
