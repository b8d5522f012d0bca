"""Paged KV cache + radix prefix reuse for the serving ring — the port
of ``paddle_operator_tpu/infer/paged.py``: the bf16 pool and the int8
pool (SERVE_KV_QUANT=int8).

- **Block pool** ``[L, num_blocks + 1, H_kv, block_size, D]`` plus
  per-lane block tables ``[slots, max_blocks_per_lane]`` int32 (host
  numpy, uploaded with every dispatch): lane KV is a list of pool
  blocks, allocated on demand as the lane's ``pos`` crosses a block
  boundary and returned at retire.  Pool block 0 is the reserved TRASH
  block — freed lanes, inactive lanes and pad rows write there, so an
  in-flight pipelined chunk can never corrupt a re-allocated block.
- **Radix prefix cache** (host side, :class:`PagedCacheManager`):
  completed-prefill FULL blocks are keyed by the
  ``utils/radixkey.py`` chain; a request hitting a cached prefix maps
  those blocks read-only (refcounted), prefills only the suffix, and
  copies-on-write any shared block its writes will land in.
- **Kernel/plain split**: on a CUDA tensor the decode attention walks
  the block table inside the CUDA kernel (ops/decode_attention.py
  ``paged_decode_attention``); the plain path gathers the lane view per
  layer (:func:`_gather_lane_view`) — the copy the kernel avoids.
- **int8 pool** (``quant="int8"``): blocks hold int8 codes with one f32
  scale per (layer, block, kv head), and each lane's write-frontier
  block accumulates exact rows in a staging tail (cfg.dtype) until it
  completes, when it quantizes into the pool once.  Tail row ``slots``
  is the trash tail.  The ring's tick quantizes every lane's tail each
  tick and sends the codes of lanes that did not complete a block to
  trash block 0 (:func:`_commit_tails`): fixed shapes and no host read
  inside a chunk, where the JAX module committed behind a ``lax.cond``.

In PyTorch's idiom: the pool is written IN PLACE (indexed tensor
writes where the JAX module returned donated copies), layers are a
Python loop where JAX scanned, and the ``make_*`` functions return plain
callables that update the pool in place — there is nothing to compile.

The megastep (SERVE_MEGASTEP) fuses N chunks into one dispatch
(:func:`make_paged_megastep`).  A preempted lane's blocks come back
through :func:`make_promote_blocks` (the in-place promote scatter).
Not ported yet (ROADMAP.md Queue A): the host spill tier and the
durable store (bf16 and int8) and the prefill-pool transfers.
``ContinuousBatcher`` refuses them.
"""

from __future__ import annotations

import heapq
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from paddle_operator_tpu_torch.infer import decode as D
from paddle_operator_tpu_torch.models.llama import LlamaConfig
from paddle_operator_tpu_torch.ops.decode_attention import (
    gather_lane_view,
    gather_lane_view_quant,
    paged_decode_attention,
)
from paddle_operator_tpu_torch.utils.radixkey import (
    chain_key as _radix_chain_key,
)

TRASH_BLOCK = 0

# SERVE_KV_QUANT: "none" keeps the bf16 pool (the default and the parity
# oracle); "int8" stores pool blocks as int8 codes + one f32 scale per
# (layer, block, kv head), with the dequant fused into the paged kernel
# (ops/decode_attention.py) or the gather view.  The win is capacity:
# about twice the resident lanes per byte of device memory.
KV_QUANT_MODES = ("none", "int8")


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pool block (..., bs, D) -> (int8 codes, f32 absmax/127 scale
    over the trailing two axes — per (..., kv head) on [L, N, H, bs, D]
    tiles).  An all-zero block gets scale 1.0 so the dequant never
    divides by zero; the f32 division, round-half-even and the clip to
    ±127 are the JAX function's, so codes and scales are bit-equal to it
    and quantize -> dequantize -> quantize is a fixed point.  The
    absmax is one reduction that never materializes |x|; the f32
    quotient is rounded and clipped in place."""
    amax = torch.linalg.vector_norm(x, ord=float("inf"),
                                    dim=(-2, -1)).float()
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    codes = torch.div(x, scale[..., None, None])      # f32, x upcast exactly
    codes.round_().clamp_(-127, 127)
    return codes.to(torch.int8), scale


def dequantize_kv(codes: torch.Tensor, scale: torch.Tensor,
                  dtype) -> torch.Tensor:
    """codes (..., bs, D) x scale (...) -> values in ``dtype`` (the
    product in f32)."""
    return (codes.float() * scale[..., None, None].float()).to(dtype)


class NoFreeBlocks(RuntimeError):
    """The pool has no free block and no reclaimable (refcount-0)
    cached block — admission/growth must fail loudly rather than
    corrupt a mapped block."""


# ---------------------------------------------------------------------------
# Host side: block allocator + radix prefix cache
# ---------------------------------------------------------------------------


class _CacheEntry:
    __slots__ = ("key", "block", "chunk", "parent", "freed_at", "ns")

    def __init__(self, key, block, chunk, parent, ns=0):
        self.key = key
        self.block: int = block
        self.chunk = chunk        # the bs tokens this block's KV encodes
        self.parent = parent      # chain key of the preceding block
        self.freed_at: Optional[int] = None   # LRU clock at refcount 0
        self.ns = ns              # radix namespace (0 = base model)


class PagedCacheManager:
    """Host-side truth for the pool: free list, per-block lane
    refcounts, the per-slot block tables, and the radix prefix cache.

    Block states partition the allocatable ids (1..num_blocks; 0 is the
    trash block):

    - **free**: on the free list;
    - **mapped**: referenced by >= 1 lane table (``ref[b] > 0``) —
      possibly ALSO cached (a published prompt block still in use);
    - **cached**: in the radix cache at refcount 0 — reclaimable, LRU
      by refcount-0 age when the free list runs dry (leaves first).

    ``check_invariant()`` asserts the partition exactly
    (free + mapped + cached-only == num_blocks, refcounts == table
    occurrences)."""

    def __init__(self, slots: int, max_len: int, block_size: int,
                 num_blocks: Optional[int] = None,
                 prefix_cache: bool = True) -> None:
        alloc = D.cache_alloc_len(max_len)
        if block_size < 1:
            raise ValueError(f"block_size must be >= 1 (got {block_size})")
        self.bs = int(block_size)
        self.max_blocks = -(-alloc // self.bs)          # per-lane table width
        self.view_len = self.max_blocks * self.bs       # gathered lane view
        # default pool = contiguous-ring parity: every lane can still
        # reach max_len
        self.num_blocks = int(num_blocks or slots * self.max_blocks)
        if self.num_blocks < self.max_blocks:
            raise ValueError(
                f"num_blocks ({self.num_blocks}) smaller than one lane's "
                f"worst case ({self.max_blocks} blocks)")
        self.total = self.num_blocks + 1                # + trash block 0
        self.free: List[int] = list(range(self.total - 1, 0, -1))
        self.ref = np.zeros((self.total,), np.int64)
        self.table = np.zeros((slots, self.max_blocks), np.int32)
        self.mapped_count = [0] * slots
        self.prefix_cache = bool(prefix_cache)
        self.entries: Dict[Any, _CacheEntry] = {}       # chain key -> entry
        self.by_block: Dict[int, Any] = {}              # block -> chain key
        self.children: Dict[Any, set] = {}              # parent key -> keys
        self._tick = 0
        # lazy-deletion min-heap of (freed_at, seq, key), pushed at every
        # ref -> 0 transition; selection semantics are IDENTICAL to the
        # full scan (:meth:`_select_victim_scan`, the regression oracle)
        self._ref0_heap: List[Tuple[int, int, Any]] = []
        self._heap_seq = 0
        self.stats = {
            "prefix_lookup_tokens": 0, "prefix_hit_tokens": 0,
            "prefix_lookups": 0, "prefix_full_hits": 0,
            "cow_copies": 0, "cache_evictions": 0, "blocks_hwm": 0,
        }

    # -- allocation --------------------------------------------------------

    def blocks_free(self) -> int:
        return len(self.free)

    def blocks_cached(self) -> int:
        """Cached blocks currently reclaimable (refcount 0)."""
        return sum(1 for e in self.entries.values() if self.ref[e.block] == 0)

    def _alloc_one(self) -> int:
        if not self.free:
            self._evict_lru()
        blk = self.free.pop()
        used = self.num_blocks - len(self.free)
        self.stats["blocks_hwm"] = max(self.stats["blocks_hwm"], used)
        return blk

    def _select_victim_scan(self) -> Optional[_CacheEntry]:
        """The O(n·children) victim scan, kept as the regression oracle
        for :meth:`_select_victim`: prefer leaves (no children), oldest
        refcount-0 age among them."""
        victims = [e for e in self.entries.values()
                   if self.ref[e.block] == 0]
        if not victims:
            return None
        leaves = [e for e in victims if not self.children.get(e.key)]
        pool = leaves or victims
        return min(pool, key=lambda e: (e.freed_at
                                        if e.freed_at is not None else 0))

    def _heap_push(self, e: _CacheEntry) -> None:
        self._heap_seq += 1
        heapq.heappush(self._ref0_heap,
                       (e.freed_at if e.freed_at is not None else 0,
                        self._heap_seq, e.key))

    def _select_victim(self) -> Optional[_CacheEntry]:
        """Heap-backed victim selection, O(log n) amortized: pop the
        refcount-0 index in age order, discarding stale items (entry
        re-mapped or dropped since push — ``freed_at`` is the version
        stamp) and setting valid NON-leaves aside; the first valid leaf
        wins.  A treeful of inner nodes with no leaf falls back to the
        oldest set-aside entry — exactly the scan's semantics."""
        stash: List[Tuple[int, int, Any]] = []
        victim: Optional[_CacheEntry] = None
        while self._ref0_heap:
            fa, seq, key = heapq.heappop(self._ref0_heap)
            e = self.entries.get(key)
            if (e is None or self.ref[e.block] != 0
                    or (e.freed_at if e.freed_at is not None else 0) != fa):
                continue                     # stale: lazily deleted
            if self.children.get(key):
                stash.append((fa, seq, key))  # valid, but not a leaf
                continue
            victim = e
            break
        if victim is None and stash:
            fa, seq, key = stash.pop(0)       # oldest valid non-leaf
            victim = self.entries[key]
        for item in stash:                    # survivors stay indexed
            heapq.heappush(self._ref0_heap, item)
        return victim

    def _evict_lru(self) -> None:
        """Reclaim ONE cached refcount-0 block (its radix entry is
        discarded)."""
        victim = self._select_victim()
        if victim is None:
            raise NoFreeBlocks(
                f"all {self.num_blocks} pool blocks are lane-mapped; "
                "grow num_blocks or retire lanes first")
        blk = victim.block
        self._drop_entry(victim)
        self.free.append(blk)
        self.stats["cache_evictions"] += 1

    def _drop_entry(self, e: _CacheEntry) -> None:
        del self.entries[e.key]
        self.by_block.pop(e.block, None)
        kids = self.children.get(e.parent)
        if kids is not None:
            kids.discard(e.key)
            if not kids:
                del self.children[e.parent]

    def _release_block(self, blk: int) -> None:
        """One lane unmaps ``blk``: decref; at 0 it either becomes a
        reclaimable cached block (stamped with its LRU age) or goes
        straight back to the free list."""
        if blk == TRASH_BLOCK:
            return
        if self.ref[blk] <= 0:
            raise AssertionError(f"double free of pool block {blk}")
        self.ref[blk] -= 1
        if self.ref[blk] == 0:
            key = self.by_block.get(blk)
            if key is not None:
                self._tick += 1
                e = self.entries[key]
                e.freed_at = self._tick
                self._heap_push(e)      # enters the ref-0 age index
            else:
                self.free.append(blk)

    # -- radix cache -------------------------------------------------------

    @staticmethod
    def _chain_key(parent, chunk: Tuple[int, ...]):
        """Rolling key for one full block (utils/radixkey.py — the
        fleet router keys its affinity on the same chain)."""
        return _radix_chain_key(parent, chunk)

    @staticmethod
    def _root_key(ns: int):
        """Chain root for namespace ``ns``: 0 is the unsalted chain of
        base-model traffic; a non-zero namespace (an adapter load)
        starts at a salted key, so cross-namespace hits cannot happen."""
        if not ns:
            return None
        return _radix_chain_key(0x5A17ED, (int(ns),))

    def _lookup(self, tokens: Tuple[int, ...], ns: int = 0):
        """Walk the cached chain: full-block hits, then at most one
        partial-tail hit (a cached child block whose chunk STARTS with
        the remaining < bs tokens — mappable read-only, CoW'd before
        the lane's first write into it).  Returns
        (entries, full_hit_tokens, used_partial)."""
        bs = self.bs
        hits: List[_CacheEntry] = []
        key = self._root_key(ns)
        j = 0
        n = len(tokens)
        while (j + 1) * bs <= n:
            chunk = tokens[j * bs:(j + 1) * bs]
            k2 = self._chain_key(key, chunk)
            e = self.entries.get(k2)
            if e is None or e.chunk != chunk:
                break
            hits.append(e)
            key = k2
            j += 1
        hit = j * bs
        partial = False
        rem = tokens[j * bs:]
        if rem and len(rem) < bs:
            for ck in self.children.get(key, ()):
                e = self.entries[ck]
                if e.chunk[:len(rem)] == rem:
                    hits.append(e)
                    hit += len(rem)
                    partial = True
                    break
        return hits, hit, partial

    # -- lane lifecycle ----------------------------------------------------

    def admit(self, slot: int, prompt,
              max_suffix: Optional[int] = None, ns: int = 0
              ) -> Tuple[int, List[Tuple[int, int]]]:
        """Map blocks for a new lane: radix hits read-only (refcounted),
        copy-on-write for any shared block the suffix/decode writes will
        land in, fresh blocks for the rest of the prompt.  Returns
        ``(hit_len, cow)`` — the usable prefix length (always leaving
        >= 1 suffix token: the first sampled token needs the last prompt
        position's logits) and the [(src, dst)] block copies the caller
        must run BEFORE the admission dispatch.

        ``max_suffix``: a hit whose remaining suffix exceeds it is NOT
        taken (fresh blocks throughout, hit_len 0)."""
        tokens = tuple(int(t) for t in prompt)
        n = len(tokens)
        bs = self.bs
        if self.mapped_count[slot]:
            raise AssertionError(f"slot {slot} still holds blocks")
        if self.prefix_cache:
            hit_entries, hit_full, _partial = self._lookup(tokens, ns)
            self.stats["prefix_lookups"] += 1
            self.stats["prefix_lookup_tokens"] += n
            if (max_suffix is not None
                    and n - min(hit_full, n - 1) > max_suffix):
                hit_entries, hit_full = [], 0
        else:
            hit_entries, hit_full = [], 0
        hit_len = min(hit_full, n - 1)
        self.stats["prefix_hit_tokens"] += hit_len
        if hit_len and hit_len == n - 1 and hit_full >= n:
            self.stats["prefix_full_hits"] += 1

        row = self.table[slot]
        try:
            for j, e in enumerate(hit_entries):
                blk = e.block
                row[j] = blk
                self.ref[blk] += 1
                self.mapped_count[slot] = j + 1
            # CoW: every shared block at/after the first written block
            # (index hit_len // bs) gets a private copy — by
            # construction that is at most the last hit block
            cow: List[Tuple[int, int]] = []
            first_write_blk = hit_len // bs
            for j in range(first_write_blk, len(hit_entries)):
                src = int(row[j])
                dst = self._alloc_one()
                self.ref[dst] += 1
                self._release_block(src)
                row[j] = dst
                cow.append((src, dst))
                self.stats["cow_copies"] += 1
            # fresh blocks for the rest of the prompt
            need = -(-n // bs)
            while self.mapped_count[slot] < need:
                blk = self._alloc_one()
                self.ref[blk] += 1
                row[self.mapped_count[slot]] = blk
                self.mapped_count[slot] += 1
        except NoFreeBlocks:
            self.retire(slot)
            raise
        return hit_len, cow

    def publish(self, slot: int, prompt, ns: int = 0) -> None:
        """Register the lane's FULL prompt blocks in the radix cache
        (called once the admission prefill is dispatched — later readers
        are later work on the same stream).  Blocks already cached
        under the same key are left alone."""
        if not self.prefix_cache:
            return
        tokens = tuple(int(t) for t in prompt)
        bs = self.bs
        key = self._root_key(ns)
        for j in range(len(tokens) // bs):
            chunk = tokens[j * bs:(j + 1) * bs]
            k2 = self._chain_key(key, chunk)
            if k2 not in self.entries:
                blk = int(self.table[slot, j])
                if blk != TRASH_BLOCK and blk not in self.by_block:
                    self.entries[k2] = _CacheEntry(k2, blk, chunk, key,
                                                   ns=ns)
                    self.by_block[blk] = k2
                    self.children.setdefault(key, set()).add(k2)
            key = k2

    def ensure(self, slot: int, pos_needed: int) -> None:
        """Grow the lane's table so blocks cover positions
        [0, pos_needed) — the on-demand allocation the decode loop runs
        before each dispatch.  Capped at the lane view; overshoot rows
        (pipelined chunks past the budget) land in the lane's own last
        block and are discarded with the lane."""
        need = min(-(-int(pos_needed) // self.bs), self.max_blocks)
        row = self.table[slot]
        while self.mapped_count[slot] < need:
            blk = self._alloc_one()
            self.ref[blk] += 1
            row[self.mapped_count[slot]] = blk
            self.mapped_count[slot] += 1

    def retire(self, slot: int) -> None:
        """Lane done (eos/budget/cancel/error): unmap every block —
        published ones become reclaimable cache, private ones go back
        to the free list — and zero the table row so any in-flight
        pipelined chunk writes land in the trash block."""
        row = self.table[slot]
        for j in range(self.mapped_count[slot]):
            self._release_block(int(row[j]))
        row[:] = TRASH_BLOCK
        self.mapped_count[slot] = 0

    # -- accounting --------------------------------------------------------

    def hit_rate(self) -> float:
        lk = self.stats["prefix_lookup_tokens"]
        return round(self.stats["prefix_hit_tokens"] / lk, 4) if lk else 0.0

    def check_invariant(self) -> None:
        """free + mapped + cached-only == num_blocks, with refcounts
        exactly equal to table occurrences and no id in two states."""
        free = set(self.free)
        assert len(free) == len(self.free), "free list holds duplicates"
        assert TRASH_BLOCK not in free, "trash block leaked to free list"
        occurrences: Dict[int, int] = {}
        for row in self.table:
            for blk in row:
                if blk != TRASH_BLOCK:
                    occurrences[int(blk)] = occurrences.get(int(blk), 0) + 1
        for blk, cnt in occurrences.items():
            assert self.ref[blk] == cnt, \
                f"block {blk}: ref {self.ref[blk]} != {cnt} table uses"
            assert blk not in free, f"block {blk} mapped AND free"
        mapped = set(occurrences)
        for blk in range(1, self.total):
            if self.ref[blk] and blk not in mapped:
                raise AssertionError(f"block {blk} refcounted but unmapped")
        cached_only = {e.block for e in self.entries.values()
                       if self.ref[e.block] == 0}
        assert not (cached_only & free), "cached block on the free list"
        assert len(free) + len(mapped) + len(cached_only) \
            == self.num_blocks, (
            f"pool partition broken: {len(free)} free + {len(mapped)} "
            f"mapped + {len(cached_only)} cached != {self.num_blocks}")


# ---------------------------------------------------------------------------
# Device side: pool init, writes, gather view, forwards
# ---------------------------------------------------------------------------


def init_paged_cache(cfg: LlamaConfig, slots: int, total_blocks: int,
                     block_size: int, *, device="cuda",
                     quant: str = "none") -> Dict[str, torch.Tensor]:
    """The paged ring state: k/v pools [L, total_blocks, H_kv, bs, D]
    in the compute dtype on ``device`` plus the per-lane fill position
    vector (int32, on the device).  ``total_blocks`` INCLUDES the trash
    block (PagedCacheManager.total).

    ``quant="int8"``: the pools hold int8 codes (same shape), with f32
    scales ``ks``/``vs`` [L, total_blocks, H_kv] and the staging tails
    ``kt``/``vt`` [L, slots + 1, H_kv, bs, D] in the compute dtype —
    lane b's write block accumulates exact rows in tail row b and
    quantizes into the pool once, when it completes; row ``slots`` is
    the trash tail."""
    shape = (cfg.n_layers, total_blocks, cfg.n_kv_heads, block_size,
             cfg.head_dim)
    pos = torch.zeros((slots,), dtype=torch.int32, device=device)
    if quant == "none":
        return {
            "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "pos": pos,
        }
    if quant != "int8":
        raise ValueError(f"kv_quant {quant!r} not in {KV_QUANT_MODES}")
    scale_shape = shape[:3]
    tail_shape = (cfg.n_layers, slots + 1) + shape[2:]
    return {
        "k": torch.zeros(shape, dtype=torch.int8, device=device),
        "v": torch.zeros(shape, dtype=torch.int8, device=device),
        "ks": torch.ones(scale_shape, dtype=torch.float32, device=device),
        "vs": torch.ones(scale_shape, dtype=torch.float32, device=device),
        "kt": torch.zeros(tail_shape, dtype=cfg.dtype, device=device),
        "vt": torch.zeros(tail_shape, dtype=cfg.dtype, device=device),
        "pos": pos,
    }


def _block_index(table: torch.Tensor, p: torch.Tensor,
                 block_size: int) -> torch.Tensor:
    """Pool block holding absolute position ``p`` of each lane (``p``
    [B] or [B, T]).  Positions past the lane view — pipelined overshoot
    rows — clamp to the lane's last table entry, as the JAX gather
    clamps."""
    col = torch.clamp(p // block_size, max=table.shape[1] - 1).long()
    if p.dim() == 1:
        return table.gather(1, col[:, None])[:, 0].long()
    return table.gather(1, col).long()


def _write_token_paged(pool_l: torch.Tensor, kv: torch.Tensor,
                       table: torch.Tensor, pos: torch.Tensor,
                       block_size: int) -> None:
    """One layer's pool [N, H, bs, D] <- [B, H, D] new rows, lane b's
    row at pool block ``table[b, pos_b // bs]`` offset ``pos_b % bs``.
    One indexed write for every lane (the JAX module unrolled a
    dynamic_update_slice per lane).  Inactive lanes have a zeroed table
    row and position, so they all write block 0 at offset 0: the
    duplicate index is harmless only because that block is trash."""
    blk = _block_index(table, pos, block_size)
    pool_l[blk, :, (pos % block_size).long()] = kv.to(pool_l.dtype)


def _write_rows_paged(pool_l: torch.Tensor, kv: torch.Tensor,
                      table: torch.Tensor, pos: torch.Tensor,
                      block_size: int,
                      limit: Optional[torch.Tensor] = None) -> None:
    """One layer's pool [N, H, bs, D] <- [B, H, T, D] rows at per-lane
    start positions ``pos`` — each row lands in whatever pool block the
    table maps for its absolute position (a row span may straddle
    blocks).  Rows at/after ``limit`` (per lane; suffix-prefill pads)
    are redirected to the trash block."""
    b, h, t, d = kv.shape
    p = pos[:, None].long() + torch.arange(t, device=pos.device)[None, :]
    blk = _block_index(table, p, block_size)
    if limit is not None:
        blk = torch.where(p < limit[:, None].long(), blk,
                          torch.zeros_like(blk))
    rows = kv.permute(0, 2, 1, 3).reshape(b * t, h, d)
    pool_l[blk.reshape(-1), :, (p % block_size).reshape(-1)] = \
        rows.to(pool_l.dtype)


def _gather_lane_view(pool: torch.Tensor, table: torch.Tensor,
                      li: int) -> torch.Tensor:
    """Plain-path view: pool layer ``li`` gathered through the block
    tables into the contiguous [B, H, M*bs, D] layout the einsum
    attention expects (a materialized copy per layer — what the paged
    kernel's table walk avoids)."""
    return gather_lane_view(pool[li], table)


def _write_token_tail(tail_l: torch.Tensor, kv: torch.Tensor,
                      rows_idx: torch.Tensor, pos: torch.Tensor,
                      block_size: int) -> None:
    """One layer's staging tails [slots + 1, H, bs, D] <- [B, H, D] new
    rows: lane b's row at tail row ``rows_idx[b]`` (its own, or the
    trash tail for an inactive lane), offset ``pos_b % bs``."""
    tail_l[rows_idx, :, (pos % block_size).long()] = kv.to(tail_l.dtype)


def _commit_tails(cache: Dict[str, torch.Tensor], table: torch.Tensor,
                  pos: torch.Tensor, commit: torch.Tensor,
                  block_size: int) -> None:
    """The int8 ring tick's quantize-on-completion, every layer at once:
    each lane's staging tile (tail row b) quantizes into codes + scales;
    a lane whose row at ``pos`` completed its block (``commit``) writes
    them to its table entry for ``pos``, every other lane to trash
    block 0.  Fixed shapes, no host read: the price is quantizing B
    tiles a tick where the JAX module quantized only the completing
    ones behind a ``lax.cond``.  A completed block is first read from
    the pool at the next tick (this tick reads it from the tail), so
    committing after the layer loop equals the JAX per-layer commit."""
    b = pos.shape[0]
    dst = torch.where(commit, _block_index(table, pos, block_size),
                      torch.zeros_like(pos, dtype=torch.long))
    for pool, scales, tail in (("k", "ks", "kt"), ("v", "vs", "vt")):
        codes, scale = quantize_kv(cache[tail][:, :b])
        cache[pool][:, dst] = codes
        cache[scales][:, dst] = scale


def _gather_view_quant(cache: Dict[str, torch.Tensor], kind: str,
                       table: torch.Tensor, li: int,
                       wb: torch.Tensor) -> torch.Tensor:
    """Plain-path view of layer ``li`` of the int8 pool (``kind`` "k" or
    "v"): :func:`~paddle_operator_tpu_torch.ops.decode_attention.
    gather_lane_view_quant` with write-frontier blocks ``wb`` [B] read
    from the staging tails."""
    return gather_lane_view_quant(cache[kind][li], cache[kind + "s"][li],
                                  cache[kind + "t"][li], table, wb)


def _attend_plain(cfg: LlamaConfig, q: torch.Tensor, k_view: torch.Tensor,
                  v_view: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """The ring's single-token attention over a [B, H, S, D] view
    (paged.py ``_attend_einsum`` of the JAX package): lane b attends
    columns [0, pos_b]; masked columns contribute exact zeros.  Scores
    and softmax in f32, probabilities cast to the compute dtype for the
    value product.  q [B, 1, Hq, D] -> [B, 1, Hq*D]."""
    b = q.shape[0]
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    n_rep = hq // hkv
    s = k_view.shape[2]
    qg = q.reshape(b, 1, hkv, n_rep, d)
    scores = torch.einsum("bthrd,bhsd->bthrs", qg.float(),
                          k_view.float()) / (float(d) ** 0.5)
    mask = (torch.arange(s, device=q.device)[None, :]
            <= pos[:, None].long())                          # [B, S]
    scores = scores.masked_fill(~mask[:, None, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bthrs,bhsd->bthrd", probs.to(cfg.dtype).float(),
                       v_view.float())
    return out.reshape(b, 1, hq * d).to(cfg.dtype)


def paged_ring_forward(cfg: LlamaConfig, params, tok: torch.Tensor,
                       cache: Dict[str, torch.Tensor], table: torch.Tensor,
                       quant: bool = False,
                       active: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The ring's one-token step over the paged pool: tok [B] at
    per-lane ``cache['pos']`` -> (logits [B, V] f32, cache with the
    pools written in place and ``pos + 1``).  With the kernel selected
    (``cfg.resolved_decode_attn``: a CUDA tensor) each layer's
    attention is ``paged_decode_attention`` over the pool layer and the
    table, lengths ``pos + 1`` after the write — an inactive lane
    (``pos`` zeroed) reads one trash row; otherwise the plain path
    gathers the lane view.

    ``quant=True``: the cache is the int8 pool's dict (init_paged_cache
    quant): new rows go to the lanes' staging tails, the attention
    reads codes with the dequant fused (the int8 kernel, or the
    dequantizing view), and after the layers each lane whose row
    completed its block commits it (:func:`_commit_tails`).  ``active``
    [B] (default: all) sends inactive lanes' tail rows to the trash
    tail — a lane whose admission is queued may hold a live tail."""
    from paddle_operator_tpu_torch.infer.executor import _qkv_ring

    pos = cache["pos"]
    block_size = cache["k"].shape[3]
    x = params.tok_embed.embedding.to(cfg.dtype)[tok[:, None].long()]
    cos, sin = params.rope_cos, params.rope_sin
    b = x.shape[0]
    hq, d = cfg.n_heads, cfg.head_dim
    kernel = cfg.resolved_decode_attn(x.device) == "kernel"
    lengths = pos + 1
    if quant:
        lanes = torch.arange(b, device=x.device)
        trash_row = cache["kt"].shape[1] - 1
        rows_idx = (lanes if active is None
                    else torch.where(active, lanes,
                                     torch.full_like(lanes, trash_row)))
        wb = (pos // block_size).long()
    for li, lp in enumerate(params.layers):
        q, k, v = _qkv_ring(cfg, lp, x, cos, sin, pos)
        if quant:
            _write_token_tail(cache["kt"][li], k[:, 0], rows_idx, pos,
                              block_size)
            _write_token_tail(cache["vt"][li], v[:, 0], rows_idx, pos,
                              block_size)
        else:
            _write_token_paged(cache["k"][li], k[:, 0], table, pos,
                               block_size)
            _write_token_paged(cache["v"][li], v[:, 0], table, pos,
                               block_size)
        if kernel:
            qkw = ({"k_scale": cache["ks"], "v_scale": cache["vs"],
                    "k_tail": cache["kt"], "v_tail": cache["vt"]}
                   if quant else {})
            out = paged_decode_attention(q[:, 0].contiguous(), cache["k"],
                                         cache["v"], table, lengths,
                                         layer=li, **qkw)
            out = out.reshape(b, 1, hq * d).to(cfg.dtype)
        elif quant:
            out = _attend_plain(cfg, q,
                                _gather_view_quant(cache, "k", table, li, wb),
                                _gather_view_quant(cache, "v", table, li, wb),
                                pos)
        else:
            out = _attend_plain(cfg, q, _gather_lane_view(cache["k"], table,
                                                          li),
                                _gather_lane_view(cache["v"], table, li),
                                pos)
        x = D._finish_layer(cfg, lp, x, out)
    if quant:
        commit = (pos + 1) % block_size == 0
        if active is not None:
            commit = commit & active
        with torch.profiler.record_function("kv_quant_commit"):
            _commit_tails(cache, table, pos, commit, block_size)
    x = D._rms(x, params.final_norm.scale, cfg.norm_eps, cfg.dtype)
    logits = D._mm(x, params.lm_head.kernel, cfg.dtype).float()
    return logits[:, 0], dict(cache, pos=pos + 1)


def make_paged_chunk_step(cfg: LlamaConfig, chunk_tokens: int,
                          top_k: Optional[int] = None,
                          top_p: Optional[float] = None,
                          quant: bool = False):
    """The paged ring's resident decode step — executor.make_chunk_step
    plus the block table:

    ``step(params, cache, table, tok, temp, seeds, active)
    -> (tok', toks [chunk, B])``

    ``chunk_tokens`` ticks for every lane, the pool and ``cache['pos']``
    updated in place.  Inactive lanes compute (the price of fixed
    shapes) but their position is ZEROED each tick and their table row
    is the trash block, so nothing they write reaches a real block.
    ``quant=True``: the int8 pool, ``active`` also steering inactive
    lanes' tail rows to the trash tail (:func:`paged_ring_forward`).
    Everything stays on the device: no host read inside the chunk."""
    from paddle_operator_tpu_torch.infer.executor import _ticks

    def step(params, cache, table, tok, temp, seeds, active):
        return _ticks(
            lambda t, c: paged_ring_forward(cfg, params, t, c, table,
                                            quant=quant,
                                            active=active if quant else None),
            cache, tok, temp, seeds, active, chunk_tokens, top_k, top_p)

    return step


def make_paged_megastep(cfg: LlamaConfig, chunk_tokens: int, n_steps: int,
                        top_k: Optional[int] = None,
                        top_p: Optional[float] = None,
                        quant: bool = False):
    """N fused PAGED ring iterations in one dispatch (SERVE_MEGASTEP):
    :func:`make_paged_chunk_step`'s ticks run ``n_steps`` chunks with
    the host's boundary decisions — eos, token budget, step budget —
    carried on the device (executor._mega_continue).  The pool is what
    makes a mid-megastep finish safe without the host: each fused chunk
    runs on an EFFECTIVE table whose dead lanes' rows are the trash
    block (the redirect ``retire`` makes on the host by zeroing the
    row), so a dead lane's free-running writes — pool rows, and under
    quant the commits and staging-tail rows (``active=live`` sends
    those to the trash tail) — never touch a real block.  Its position
    is restored from the pre-chunk snapshot at each boundary, so a lane
    frozen by its STEP budget (deadline ticks) resumes bit for bit in a
    later dispatch: its blocks, tail and position are exactly as its
    last consumed token left them.

    ``mega(params, cache, table, tok, temp, seeds, active, eos, left,
    steps) -> (tok', toks [n, chunk, B], counts [n, B])`` — the output
    contract of executor.make_megastep, table operand added."""
    from paddle_operator_tpu_torch.infer.executor import _fused, _ticks

    def mega(params, cache, table, tok, temp, seeds, active, eos, left,
             steps):
        def run_chunk(t, live):
            tbl = torch.where(live[:, None], table,
                              torch.full_like(table, TRASH_BLOCK))
            return _ticks(
                lambda tt, c: paged_ring_forward(
                    cfg, params, tt, c, tbl, quant=quant,
                    active=live if quant else None),
                cache, t, temp, seeds, live, chunk_tokens, top_k, top_p)

        return _fused(run_chunk, n_steps, chunk_tokens, cache, tok, active,
                      eos, left, steps)

    return mega


def make_paged_prefill_insert(cfg: LlamaConfig, bucket: int,
                              block_size: int,
                              top_k: Optional[int] = None,
                              top_p: Optional[float] = None,
                              quant: bool = False):
    """Cold (no prefix hit) paged admission: prefill the prompt, write
    its KV into the lane's blocks as whole-block writes, sample the
    first token and set the lane's pos/tok/temp/seed — all on the
    device, nothing read back.

    ``insert(params, cache, table_row, tok, temp, seeds, prompt [1, n],
    prompt_len, slot, temp_val, seed) -> first_token`` (a 0-d device
    tensor; ``cache``/``tok``/``temp``/``seeds`` are updated in place).
    ``bucket`` is the admission's prompt bucket, a block multiple —
    prompts are forwarded at their own length (PyTorch compiles
    nothing) and the KV slab is rounded to whole blocks for the
    scatter.

    ``quant=True``: whole blocks quantize once into the int8 pool and
    the prompt's write-frontier block lands exact in the lane's staging
    tail (decode.paged_prefill's quant contract)."""
    from paddle_operator_tpu_torch.infer.executor import _sample_tokens

    if bucket % block_size:
        raise ValueError(f"prefill bucket {bucket} not a multiple of the "
                         f"block size {block_size}")

    def insert(params, cache, table_row, tok, temp, seeds, prompt,
               prompt_len, slot, temp_val, seed):
        if quant:
            logits, _, tail_k, tail_v = D.paged_prefill(
                params, cfg, prompt[:, :prompt_len], cache, table_row,
                block_size=block_size, last_only=True, quant=True,
                prompt_len=prompt_len)
            cache["kt"][:, slot] = tail_k[:, 0]
            cache["vt"][:, slot] = tail_v[:, 0]
        else:
            logits, _ = D.paged_prefill(params, cfg, prompt[:, :prompt_len],
                                        cache, table_row,
                                        block_size=block_size,
                                        last_only=True)
        return _set_lane(cache, tok, temp, seeds, logits[0, -1], prompt_len,
                         slot, temp_val, seed, top_k, top_p, _sample_tokens)

    return insert


def _set_lane(cache, tok, temp, seeds, logits, prompt_len, slot, temp_val,
              seed, top_k, top_p, sample):
    """The admission's lane-state update, shared by every insert: the
    first token through the SHARED sampling rule at position
    ``prompt_len - 1``, then pos/tok/temp/seed of ``slot`` set in place
    (device scalars, no host read)."""
    dev = logits.device
    first = sample(logits[None],
                   torch.full((1,), float(temp_val), device=dev),
                   torch.full((1,), int(seed), dtype=torch.int64,
                              device=dev),
                   torch.full((1,), int(prompt_len) - 1, dtype=torch.int32,
                              device=dev), top_k, top_p)[0]
    cache["pos"][slot] = int(prompt_len)
    tok[slot] = first
    temp[slot] = float(temp_val)
    seeds[slot] = int(seed)
    return first


def _slice_lane_tails(cache: Dict[str, torch.Tensor], slot: int):
    """One lane's staging tails as 2-row mini tails (row 0 the lane,
    row 1 a zeroed trash row) for a batch-of-one int8 forward, which
    addresses tails by lane index with the last row as trash."""
    return tuple(torch.stack([cache[key][:, slot],
                              torch.zeros_like(cache[key][:, slot])], dim=1)
                 for key in ("kt", "vt"))


def _restore_lane_tails(cache: Dict[str, torch.Tensor],
                        lane: Dict[str, torch.Tensor], slot: int) -> None:
    """Write a batch-of-one int8 forward's mini tail row back into the
    lane's row of the full tails, in place."""
    cache["kt"][:, slot] = lane["kt"][:, 0]
    cache["vt"][:, slot] = lane["vt"][:, 0]


def make_paged_suffix_insert(cfg: LlamaConfig, suffix_bucket: int,
                             block_size: int,
                             top_k: Optional[int] = None,
                             top_p: Optional[float] = None,
                             quant: bool = False):
    """Prefix-HIT paged admission: the lane's table already maps the
    cached prefix blocks (read-only; CoW'd where the suffix will
    write), so the forward runs over the SUFFIX ONLY — a multi-token
    per-lane-offset forward (speculative._multi_forward_paged) whose
    writes and attention walk the block table.  The suffix arrives
    padded to ``suffix_bucket``; pad rows past the prompt write the
    trash block.

    ``quant=True``: the suffix rows accumulate in the lane's staging
    tail (sliced to a 2-row mini tail for the batch-of-one forward and
    restored after it) and whole blocks quantize on completion; when
    ``hit_len`` lands mid-block the scheduler has already seeded the
    tail from the dequantized CoW copy (:func:`make_tail_init`).

    ``insert(params, cache, table_row [M], tok, temp, seeds,
    suffix [1, suffix_bucket], suffix_len, hit_len, slot, temp_val,
    seed) -> first_token``"""
    from paddle_operator_tpu_torch.infer.executor import _sample_tokens
    from paddle_operator_tpu_torch.infer.speculative import (
        _multi_forward_paged,
    )

    def insert(params, cache, table_row, tok, temp, seeds, suffix,
               suffix_len, hit_len, slot, temp_val, seed):
        prompt_len = hit_len + suffix_len
        dev = suffix.device
        lane_cache = {"k": cache["k"], "v": cache["v"],
                      "pos": torch.full((1,), int(hit_len),
                                        dtype=torch.int32, device=dev)}
        if quant:
            lane_cache["ks"], lane_cache["vs"] = cache["ks"], cache["vs"]
            lane_cache["kt"], lane_cache["vt"] = _slice_lane_tails(cache,
                                                                   slot)
        logits, lane_cache = _multi_forward_paged(
            cfg, params, suffix, lane_cache, table_row[None, :],
            limit=torch.full((1,), int(prompt_len), dtype=torch.int32,
                             device=dev), quant=quant)
        if quant:
            _restore_lane_tails(cache, lane_cache, slot)
        return _set_lane(cache, tok, temp, seeds,
                         logits[0, int(suffix_len) - 1], prompt_len, slot,
                         temp_val, seed, top_k, top_p, _sample_tokens)

    return insert


def make_block_copier():
    """The CoW device op: copy pool block ``src`` over block ``dst`` in
    place, in every block-indexed entry of the cache (all layers: K and
    V, and the scales ``ks``/``vs`` of the int8 pool) — run once per
    copy-on-write admission, BEFORE the admission insert, so the insert
    reads the private copy.  ``cp(cache, src, dst)``"""

    def cp(cache, src, dst):
        for key in ("k", "v", "ks", "vs"):
            if key in cache:
                cache[key][:, dst] = cache[key][:, src]
        return cache

    return cp


def make_promote_blocks(block_size: int, quant: bool = False):
    """The PROMOTE upload: write a batch of whole blocks coming back from
    the host (a spilled lane's restore) into their reserved pool blocks,
    in place.  The batch rides as one contiguous slab ``rows_*`` [L, 1,
    H, n * bs, D], block j landing at ``ids[j]``: the bf16 leg is the
    prefill path's whole-block write (ops/decode_attention.py
    ``scatter_prefill_blocks``); the int8 leg copies codes AND the scale
    rows ``srow_*`` [L, n, H] verbatim
    (``scatter_promote_blocks_quant``) — a promote never re-quantizes,
    so a restored block is the block that was spilled, byte for byte.

    ``up(cache, rows_k, rows_v, ids[, srow_k, srow_v]) -> cache`` writes
    ``cache["k"]``, ``cache["v"]`` (and ``cache["ks"]``,
    ``cache["vs"]``) and rebinds nothing, so a captured CUDA graph keeps
    reading the pool it was captured over.  The JAX function pads the
    batch to a ladder of shapes with trash-block ids to bound its jit
    compiles; eager PyTorch compiles nothing, so the batch is written at
    its own size."""
    from paddle_operator_tpu_torch.ops.decode_attention import (
        scatter_prefill_blocks,
        scatter_promote_blocks_quant,
    )

    def up(cache, rows_k, rows_v, ids, srow_k=None, srow_v=None):
        if quant:
            scatter_promote_blocks_quant(cache["k"], cache["ks"], rows_k,
                                         srow_k, ids, block_size)
            scatter_promote_blocks_quant(cache["v"], cache["vs"], rows_v,
                                         srow_v, ids, block_size)
        else:
            scatter_prefill_blocks(cache["k"], rows_k, ids, block_size)
            scatter_prefill_blocks(cache["v"], rows_v, ids, block_size)
        return cache

    return up


def make_tail_init():
    """int8-pool admission helper: a lane starting MID-BLOCK (a
    partial-tail radix hit, or a full hit capped at n - 1 tokens) will
    write into a block that already holds quantized rows (its CoW'd
    private copy), so its staging tail is seeded with that block's
    DEQUANTIZED rows — the suffix forward then reads
    [block_start, hit_len) as every other reader does, and the block's
    eventual requantize sees them.  In place, after the CoW copy.

    ``init(cache, slot, blk) -> cache``"""

    def init(cache, slot, blk):
        for kind in ("k", "v"):
            tail = cache[kind + "t"]
            tail[:, slot] = dequantize_kv(cache[kind][:, blk],
                                          cache[kind + "s"][:, blk],
                                          tail.dtype)
        return cache

    return init
