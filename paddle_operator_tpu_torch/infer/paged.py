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
(:func:`make_paged_megastep`).  Chunked prefill writes a prompt through
the lane's table one slice at a time (:func:`make_paged_prefill_chunk`,
then the suffix insert for the last slice).  A preempted lane's blocks
come back through :func:`make_promote_blocks` (the in-place promote
scatter).

- **Host spill tier** (``host_cache_blocks``, SERVE_HOST_CACHE_MB):
  with the tier on, eviction DEMOTES a refcount-0 cached block — its
  exact device bytes move to host memory (:class:`HostCacheTier`, the
  executor's ``demote_fetch`` hook) and its radix node stays alive — and
  a later hit promotes it back into a fresh block through the same
  scatter, byte for byte (codes and scales verbatim on the int8 pool).
- **Durable store** (:meth:`PagedCacheManager.attach_store`, the
  ``infer/kvstore.py`` tier below the host tier): a tier overflow
  persists the dropped payload instead of discarding it, and its radix
  node survives store-resident (``stored``) for a later store probe to
  re-fill through :meth:`PagedCacheManager.import_host_blocks`.

- **Peer export** (:meth:`PagedCacheManager.export_host_chain`,
  fleet-level KV): a peer whose radix walk missed gets copies of a
  prompt's demoted blocks (serve.py ``/v1/kv/prefix``), read from an
  HTTP thread under the slot-reuse rule of the method's docstring, and
  imports them through :meth:`PagedCacheManager.import_host_blocks`.
"""

from __future__ import annotations

import heapq
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from paddle_operator_tpu_torch.infer import decode as D
from paddle_operator_tpu_torch.models.llama import LlamaConfig
from paddle_operator_tpu_torch.ops.decode_attention import (
    gather_lane_view,
    gather_lane_view_quant,
    sharded_paged_decode_attention,
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
    __slots__ = ("key", "block", "chunk", "parent", "freed_at", "ns",
                 "stored")

    def __init__(self, key, block, chunk, parent, ns=0):
        self.key = key
        # device pool block id, or None while the entry's content lives
        # in the host tier (demoted: the radix node stays alive and a
        # later hit promotes it back into a fresh device block)
        self.block: Optional[int] = block
        self.chunk = chunk        # the bs tokens this block's KV encodes
        self.parent = parent      # chain key of the preceding block
        self.freed_at: Optional[int] = None   # LRU clock at refcount 0
        self.ns = ns              # radix namespace (0 = base model)
        # durable-store residency: True while the entry's bytes live
        # ONLY in the KV store (no device block, no host payload).  The
        # walk treats it as a miss, but the node survives so a store
        # fetch can re-fill it through import_host_blocks.
        self.stored = False


def host_block_bytes(cfg: LlamaConfig, block_size: int,
                     quant: str = "none") -> int:
    """Host bytes one demoted block costs in the spill tier: K + V rows
    ([L, H_kv, bs, D] each — 2 bytes an element, or int8 codes plus the
    per-(layer, kv head) f32 scale planes).  serve.py divides
    ``SERVE_HOST_CACHE_MB`` by this to size ``host_cache_blocks``."""
    rows = cfg.n_layers * cfg.n_kv_heads * block_size * cfg.head_dim
    if quant == "int8":
        return 2 * rows + 2 * cfg.n_layers * cfg.n_kv_heads * 4
    return 2 * rows * 2


def _release(payload) -> None:
    """A payload leaves the tier for good: give back its host slot (the
    executor's slab-backed payloads hold one; plain dicts hold none)."""
    release = getattr(payload, "release", None)
    if release is not None:
        release()


class HostCacheTier:
    """The bounded host-memory ring behind the radix cache: demoted
    block payloads (dicts — ``k``/``v`` rows, plus ``ks``/``vs`` scale
    rows on the int8 pool), keyed by the entry's chain key, LRU within
    the tier.  ``put`` on a full tier drops the oldest payloads and
    returns their keys so the manager can retire the orphaned radix
    nodes; a promote ``pop`` moves the payload back out (one canonical
    location per block keeps the accounting exact).

    A payload that holds a slot of the executor's pinned slab gives it
    back when it leaves the tier other than by ``pop`` (overflow drop,
    ``drop``); ``pop`` hands the slot to the promote."""

    def __init__(self, capacity: int) -> None:
        if capacity < 1:
            raise ValueError(f"host tier capacity must be >= 1 "
                             f"(got {capacity}); use host_cache_blocks=0 "
                             "to disable the tier")
        self.capacity = int(capacity)
        self._data: Dict[Any, Dict[str, Any]] = {}    # insertion = LRU age
        self.stats = {"demoted": 0, "promoted": 0, "overflow_drops": 0}
        # durable-store spill hook: called with ``(key, payload)`` BEFORE
        # an overflow drop deletes the payload (the store holds what it
        # keeps).  None: the drop discards.
        self.on_spill: Optional[Callable[[Any, Dict[str, Any]], None]] = None

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key) -> bool:
        return key in self._data

    def keys(self):
        return self._data.keys()

    def _overflow(self, old) -> None:
        payload = self._data.pop(old)
        if self.on_spill is not None:
            self.on_spill(old, payload)
        _release(payload)
        self.stats["overflow_drops"] += 1

    def put(self, key, payload: Dict[str, Any],
            pinned: frozenset = frozenset()) -> List[Any]:
        """Store one demoted payload; returns the keys LRU-dropped to
        make room (the caller must drop their radix entries).

        ``pinned``: keys that must NOT be overflow-dropped — the current
        admission's hit chain, whose payloads the admission is about to
        pop.  With every resident key pinned the tier exceeds its bound
        by at most the chain length until the manager trims it back."""
        dropped: List[Any] = []
        stale = self._data.pop(key, None)
        if stale is not None and stale is not payload:
            _release(stale)
        while len(self._data) >= self.capacity:
            old = next((k for k in self._data if k not in pinned), None)
            if old is None:
                break                   # all pinned: exceed, trim later
            self._overflow(old)
            dropped.append(old)
        self._data[key] = payload
        self.stats["demoted"] += 1
        return dropped

    def trim(self) -> List[Any]:
        """Drop oldest payloads until back within the bound (after an
        admission that pinned its chain released the pins)."""
        dropped: List[Any] = []
        while len(self._data) > self.capacity:
            old = next(iter(self._data))
            self._overflow(old)
            dropped.append(old)
        return dropped

    def pop(self, key) -> Dict[str, Any]:
        """Remove + return a payload for promotion back to the pool."""
        payload = self._data.pop(key)
        self.stats["promoted"] += 1
        return payload

    def peek(self, key) -> Optional[Dict[str, Any]]:
        """Read a payload WITHOUT removing it."""
        return self._data.get(key)

    def drop(self, key) -> None:
        payload = self._data.pop(key, None)
        if payload is not None:
            _release(payload)


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
    occurrences), and with the host tier on its accounting too."""

    def __init__(self, slots: int, max_len: int, block_size: int,
                 num_blocks: Optional[int] = None,
                 prefix_cache: bool = True,
                 host_cache_blocks: int = 0) -> None:
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
        # host spill tier: demoted refcount-0 cached blocks keep their
        # radix node alive with their bytes in host memory.  The
        # executor wires ``demote_fetch`` (block id -> payload) and
        # ``host_import`` (a fetched payload -> the tier's form) after
        # construction.  0 blocks = tier off = the tierless pool.
        self.host = (HostCacheTier(host_cache_blocks)
                     if host_cache_blocks else None)
        self.demote_fetch: Optional[Callable[[int], Dict[str, Any]]] = None
        self.host_import: Optional[Callable[[Dict[str, Any]],
                                            Dict[str, Any]]] = None
        # durable prefix store (attach_store); None keeps the silent
        # overflow discard
        self.store = None
        # the in-flight admission's hit-chain keys: shielded from tier
        # overflow drops while the admit that will pop them runs
        self._pinned_host_keys: frozenset = frozenset()
        # promotions ALLOCATED by the current admit() and not yet
        # uploaded: [(dst_block, payload, key)] — the scheduler drains
        # them (take_promotions) into ONE batched upload BEFORE the CoW
        # copies and the admission insert it dispatches next
        self._pending_promotes: List[Tuple[int, Dict[str, Any], Any]] = []
        # fault injection (infer/chaos.py pool_oom): the next N
        # allocations raise NoFreeBlocks whatever the free list holds
        self.chaos_fail_allocs = 0
        self.stats = {
            "prefix_lookup_tokens": 0, "prefix_hit_tokens": 0,
            "prefix_lookups": 0, "prefix_full_hits": 0,
            "cow_copies": 0, "cache_evictions": 0, "blocks_hwm": 0,
            # host tier: blocks demoted to / promoted from host memory,
            # and the prefix-hit tokens served out of host payloads (the
            # hostHitRate numerator)
            "host_demotions": 0, "host_promotions": 0,
            "host_hit_tokens": 0,
            # durable store: payloads offered to the store writer on
            # tier overflow, and store-fetched blocks re-filled into
            # store-resident radix nodes
            "store_spills": 0, "store_refills": 0,
            # fetched blocks imported into the tier (store hits)
            "peer_blocks_imported": 0,
        }

    # -- allocation --------------------------------------------------------

    def blocks_free(self) -> int:
        return len(self.free)

    def blocks_cached(self) -> int:
        """DEVICE-resident cached blocks currently reclaimable
        (refcount 0); host-demoted entries hold no pool block."""
        return sum(1 for e in self.entries.values()
                   if e.block is not None and self.ref[e.block] == 0)

    def host_blocks(self) -> int:
        """Blocks currently resident in the host spill tier."""
        return len(self.host) if self.host is not None else 0

    def host_hit_rate(self) -> float:
        """Share of looked-up prefix tokens served from HOST payloads
        (the promote path) — the ``hostHitRate`` status key."""
        lk = self.stats["prefix_lookup_tokens"]
        return (round(self.stats["host_hit_tokens"] / lk, 4)
                if lk else 0.0)

    def host_evictions(self) -> int:
        """Cumulative tier overflow drops — the
        ``tpujob_serve_host_cache_evictions_total`` gauge."""
        return (self.host.stats["overflow_drops"]
                if self.host is not None else 0)

    def _alloc_one(self) -> int:
        if self.chaos_fail_allocs > 0:
            self.chaos_fail_allocs -= 1
            raise NoFreeBlocks("chaos: injected pool OOM")
        if not self.free:
            self._evict_lru()
        blk = self.free.pop()
        used = self.num_blocks - len(self.free)
        self.stats["blocks_hwm"] = max(self.stats["blocks_hwm"], used)
        return blk

    def _promoting_blocks(self) -> set:
        """Blocks reserved by the CURRENT admission's promotions whose
        uploads have not been queued yet: never eviction victims (a CoW
        in the same admit can drop such a block to refcount 0, and
        demoting it would read bytes the upload has not written)."""
        return {dst for dst, _, _ in self._pending_promotes}

    def _select_victim_scan(self) -> Optional[_CacheEntry]:
        """The O(n·children) victim scan, kept as the regression oracle
        for :meth:`_select_victim`: prefer leaves (no children), oldest
        refcount-0 age among them."""
        promoting = self._promoting_blocks()
        victims = [e for e in self.entries.values()
                   if e.block is not None and self.ref[e.block] == 0
                   and e.block not in promoting]
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
        re-mapped, dropped or demoted since push — ``freed_at`` is the
        version stamp), deferring blocks a pending promotion reserved
        and setting valid NON-leaves aside; the first valid leaf wins.
        A treeful of inner nodes with no leaf falls back to the oldest
        set-aside entry — exactly the scan's semantics."""
        promoting = self._promoting_blocks()
        stash: List[Tuple[int, int, Any]] = []
        defer: List[Tuple[int, int, Any]] = []
        victim: Optional[_CacheEntry] = None
        while self._ref0_heap:
            fa, seq, key = heapq.heappop(self._ref0_heap)
            e = self.entries.get(key)
            if (e is None or e.block is None or self.ref[e.block] != 0
                    or (e.freed_at if e.freed_at is not None else 0) != fa):
                continue                     # stale: lazily deleted
            if e.block in promoting:
                defer.append((fa, seq, key))  # not selectable this round
                continue
            if self.children.get(key):
                stash.append((fa, seq, key))  # valid, but not a leaf
                continue
            victim = e
            break
        if victim is None and stash:
            fa, seq, key = stash.pop(0)       # oldest valid non-leaf
            victim = self.entries[key]
        for item in stash + defer:            # survivors stay indexed
            heapq.heappush(self._ref0_heap, item)
        return victim

    def _evict_lru(self) -> None:
        """Reclaim ONE cached refcount-0 block.  With the host tier on
        the victim DEMOTES — its exact device bytes move to host memory
        and its radix node stays alive at a host location
        (``block = None``), so a later admission promotes it back instead
        of re-prefilling; with the tier off the entry is discarded."""
        victim = self._select_victim()
        if victim is None:
            raise NoFreeBlocks(
                f"all {self.num_blocks} pool blocks are lane-mapped; "
                "grow num_blocks or retire lanes first")
        blk = victim.block
        if self.host is not None and self.demote_fetch is not None:
            payload = self.demote_fetch(blk)
            self.by_block.pop(blk, None)
            victim.block = None
            for key in self.host.put(victim.key, payload,
                                     pinned=self._pinned_host_keys):
                self._drop_host_entry(key)
            self.stats["host_demotions"] += 1
        else:
            self._drop_entry(victim)
        self.free.append(blk)
        self.stats["cache_evictions"] += 1

    def _drop_host_entry(self, key) -> None:
        """A tier payload aged out (overflow).  Without a durable store
        its radix node retires — the prefix is cold again.  With the
        store attached and a base-namespace entry, the payload was just
        offered to the store writer (``on_spill`` fires before the drop):
        the node SURVIVES at ``block=None, stored=True`` so a later walk
        can re-probe the store instead of re-prefilling."""
        e = self.entries.get(key)
        if e is None:
            return
        if self.store is not None and not e.ns:
            e.stored = True
            return
        self._drop_entry(e)

    def attach_store(self, store) -> None:
        """Wire the durable prefix store (infer/kvstore.KVBlockStore)
        below the host tier: overflow drops persist instead of
        discarding, and their radix nodes survive store-resident.
        Requires the host tier."""
        if self.host is None:
            raise ValueError("KV store requires the host cache tier "
                             "(host_cache_blocks > 0)")
        self.store = store
        self.host.on_spill = self._spill_to_store

    def _spill_to_store(self, key, payload: Dict[str, Any]) -> None:
        """The tier's overflow hook: offer the about-to-be-dropped
        payload to the store's background writer (bounded, drop-oldest —
        never blocks the ring thread).  Adapter namespaces abstain:
        their chain salts are per-load per-replica."""
        e = self.entries.get(key)
        if e is None or e.ns or self.store is None:
            return
        self.store.offer(key, e.chunk, payload, ns=0)
        self.stats["store_spills"] += 1

    def _servable(self, e: _CacheEntry) -> bool:
        """Can this radix node serve a hit NOW — device-resident, or
        host-resident with its payload in the tier?  A store-resident
        node cannot (admit would have nothing to promote)."""
        if e.block is not None:
            return True
        return self.host is not None and e.key in self.host

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
        the lane's first write into it).  Each hit is device-resident
        (``block`` set) or host-resident (``block is None``: admit
        promotes it); a store-resident node ends the walk.  Returns
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
            if e is None or e.chunk != chunk or not self._servable(e):
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
                if e.chunk[:len(rem)] == rem and self._servable(e):
                    hits.append(e)
                    hit += len(rem)
                    partial = True
                    break
        return hits, hit, partial

    def take_promotions(self) -> List[Tuple[int, Dict[str, Any], Any]]:
        """Drain the promotions the last ``admit`` allocated:
        [(dst_block, host_payload, chain_key)].  The scheduler turns the
        batch into ONE upload (RingExecutor.dispatch_promotions) queued
        BEFORE the CoW copies and the admission insert."""
        out, self._pending_promotes = self._pending_promotes, []
        return out

    # -- lane lifecycle ----------------------------------------------------

    def admit(self, slot: int, prompt,
              max_suffix: Optional[int] = None, ns: int = 0
              ) -> Tuple[int, List[Tuple[int, int]]]:
        """Map blocks for a new lane: radix hits read-only (refcounted;
        a host-resident hit first promoted into a fresh block), copy-on-
        write for any shared block the suffix/decode writes will land
        in, fresh blocks for the rest of the prompt.  Returns
        ``(hit_len, cow)`` — the usable prefix length (always leaving
        >= 1 suffix token: the first sampled token needs the last prompt
        position's logits) and the [(src, dst)] block copies the caller
        must run BEFORE the admission dispatch (after the promotions,
        :meth:`take_promotions`).

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
        host_tokens_this_admit = 0
        # pin this admission's WHOLE hit chain: a demotion fired by one
        # of our own allocations must never overflow-drop a payload we
        # are about to pop.  Device-resident hits pin too: one not yet
        # mapped by this loop is refcount 0 and may itself be demoted
        # mid-admit, and its turn then takes the promote branch.
        self._pinned_host_keys = frozenset(e.key for e in hit_entries)
        try:
            for j, e in enumerate(hit_entries):
                if e.block is None:
                    # HOST hit: reserve a device block NOW (the whole
                    # admission fits or fails up front) and queue the
                    # byte-exact upload; the entry re-anchors device-side
                    dst = self._alloc_one()
                    payload = self.host.pop(e.key)
                    e.block = dst
                    self.by_block[dst] = e.key
                    self._pending_promotes.append((dst, payload, e.key))
                    self.stats["host_promotions"] += 1
                    tok_inc = min(bs, max(0, hit_len - j * bs))
                    self.stats["host_hit_tokens"] += tok_inc
                    host_tokens_this_admit += tok_inc
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
            # roll back this admit's promotions: their uploads never
            # queued, so the re-anchored entries would map garbage
            # blocks — each payload goes back to the tier (there is
            # room: it was just popped) and retire() below frees the
            # reserved blocks
            for dst, payload, key in self._pending_promotes:
                e = self.entries.get(key)
                if e is not None:
                    for k2 in self.host.put(key, payload,
                                            pinned=self._pinned_host_keys):
                        self._drop_host_entry(k2)
                    e.block = None
                self.by_block.pop(dst, None)
                # a promoted block the CoW already released sits at
                # refcount 0 with no radix anchor: retire() cannot reach
                # it, so it returns to the free list here
                if self.ref[dst] == 0 and dst not in self.free:
                    self.free.append(dst)
                self.stats["host_promotions"] -= 1
            self._pending_promotes = []
            self.stats["host_hit_tokens"] -= host_tokens_this_admit
            self.retire(slot)
            raise
        finally:
            if self.host is not None:
                self._pinned_host_keys = frozenset()
                for key in self.host.trim():    # back within the bound
                    self._drop_host_entry(key)
        return hit_len, cow

    def publish(self, slot: int, prompt, ns: int = 0) -> None:
        """Register the lane's FULL prompt blocks in the radix cache
        (called once the admission prefill is dispatched — later readers
        are later work on the same stream).  Blocks already cached under
        the same key are left alone; a store-resident node whose prefix
        this lane just re-prefilled re-anchors on the lane's block."""
        if not self.prefix_cache:
            return
        tokens = tuple(int(t) for t in prompt)
        bs = self.bs
        key = self._root_key(ns)
        for j in range(len(tokens) // bs):
            chunk = tokens[j * bs:(j + 1) * bs]
            k2 = self._chain_key(key, chunk)
            e = self.entries.get(k2)
            blk = int(self.table[slot, j])
            if e is None:
                if blk != TRASH_BLOCK and blk not in self.by_block:
                    self.entries[k2] = _CacheEntry(k2, blk, chunk, key,
                                                   ns=ns)
                    self.by_block[blk] = k2
                    self.children.setdefault(key, set()).add(k2)
            elif e.block is None and e.stored and e.chunk == chunk:
                if blk != TRASH_BLOCK and blk not in self.by_block:
                    e.block = blk
                    e.stored = False
                    self.by_block[blk] = k2
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

    def private_blocks(self, slot: int) -> List[int]:
        """Lane ``slot``'s PRIVATE mapped blocks: refcount 1 and not in
        the radix cache, so no other lane reads them (a block the lane
        writes is private by construction: admission copies any hit
        block at or after its first written position)."""
        row = self.table[slot]
        return [int(row[j]) for j in range(self.mapped_count[slot])
                if self.ref[int(row[j])] == 1
                and int(row[j]) not in self.by_block]

    def scrub_host_chain(self, prompt, ns: int = 0) -> int:
        """Quarantine hygiene: drop every HOST-tier payload on
        ``prompt``'s radix chain (an opaque host copy cannot be
        re-verified against the pool), and with the store attached
        delete every store copy along the chain and retire its
        store-resident nodes — a quarantined chain must not resurrect
        from disk.  Returns the number of host or store-resident nodes
        dropped.  The NaN-lane quarantine calls it
        (``ContinuousBatcher._scrub_lane_blocks``)."""
        if self.host is None and self.store is None:
            return 0
        tokens = tuple(int(t) for t in prompt)
        key = self._root_key(ns)
        dropped = 0
        for j in range(len(tokens) // self.bs):
            chunk = tokens[j * self.bs:(j + 1) * self.bs]
            key = self._chain_key(key, chunk)
            if self.store is not None and not ns:
                self.store.delete(key, ns=0)
            e = self.entries.get(key)
            if e is None:
                continue    # gap in the chain: deeper entries may remain
            if e.block is None:
                if self.host is not None:
                    self.host.drop(key)
                self._drop_entry(e)
                dropped += 1
        return dropped

    def drop_host_tier(self) -> None:
        """Discard the tier (the ring is rebuilt or closing): pending
        promotions and every tier payload give their slots back, and the
        host-resident radix nodes retire."""
        for _, payload, _ in self.take_promotions():
            _release(payload)
        if self.host is None:
            return
        for key in list(self.host.keys()):
            self.host.drop(key)
            e = self.entries.get(key)
            if e is not None:
                self._drop_entry(e)

    def export_host_chain(self, prompt, ns: int = 0):
        """The peer-fetch EXPORT: walk ``prompt``'s radix chain and
        collect every HOST-resident (demoted) full block along it —
        ``(chunks, block_idx, payloads)``: ``chunks`` lists EVERY full
        block's tokens from the chain start (the importer recomputes the
        parent keys from them), ``block_idx``/``payloads`` the demoted
        subset that travels, as copies.  Device-resident blocks are
        skipped and the walk goes on: the importer may hold the head
        already.

        Called on an HTTP handler thread while the ring thread mutates
        the radix and reuses host slots.  A payload's bytes are read
        after its slot's last queued copy landed (``wait``), copied out,
        and kept only if the tier still holds THAT payload under the key
        afterwards — a slot the ring released (and may have refilled)
        meanwhile raises ``LookupError``, never torn bytes.  Callers
        treat any exception as "nothing to export" (serve answers
        204)."""
        if self.host is None:
            return [], [], []
        tokens = tuple(int(t) for t in prompt)
        bs = self.bs
        chunks, block_idx, payloads = [], [], []
        key = self._root_key(ns)
        for j in range(len(tokens) // bs):
            chunk = tokens[j * bs:(j + 1) * bs]
            key = self._chain_key(key, chunk)
            e = self.entries.get(key)
            if e is None or e.chunk != chunk:
                break               # chain cold from here on
            chunks.append(list(chunk))
            if e.block is not None:
                continue
            payload = self.host.peek(key)
            if payload is None:
                continue
            wait = getattr(payload, "wait", None)
            if wait is not None:
                wait()              # the demote's copy has landed
            copy = {name: (a.clone() if isinstance(a, torch.Tensor)
                           else np.array(a, copy=True))
                    for name, a in payload.items()}
            if self.host.peek(key) is not payload:
                raise LookupError(f"host block {j} of the chain left the "
                                  "tier during its export")
            block_idx.append(j)
            payloads.append(copy)
        return chunks, block_idx, payloads

    def import_host_blocks(self, chunks, block_idx, payloads,
                           ns: int = 0) -> int:
        """Insert fetched payloads (a store hit) into the host tier and
        the radix (ring thread only), exactly as if this replica had
        demoted them — the next admission's walk host-hits them and
        promotes through the batched upload.  A store-resident node is
        re-filled; other keys already present are left alone; a block
        whose parent is neither present nor imported is skipped (the
        walk could never reach it).  ``host_import`` (the executor's)
        brings each payload into the tier's form first.  Returns the
        number of blocks imported."""
        if self.host is None or not self.prefix_cache:
            return 0
        bs = self.bs
        keys = []
        key = self._root_key(ns)
        for chunk in chunks:
            if len(chunk) != bs:
                return 0            # malformed: full blocks only
            key = self._chain_key(key, tuple(int(t) for t in chunk))
            keys.append(key)

        def put(k, payload):
            if self.host_import is not None:
                payload = self.host_import(payload)
            for dropped in self.host.put(k, payload,
                                         pinned=self._pinned_host_keys):
                self._drop_host_entry(dropped)

        imported = 0
        for j, payload in zip(block_idx, payloads):
            if not 0 <= j < len(keys):
                continue
            chunk = tuple(int(t) for t in chunks[j])
            existing = self.entries.get(keys[j])
            if existing is not None:
                if (existing.block is None and existing.stored
                        and existing.chunk == chunk):
                    put(keys[j], payload)
                    existing.stored = False
                    self.stats["store_refills"] += 1
                    imported += 1
                continue
            if j and keys[j - 1] not in self.entries:
                continue            # parent-gapped: unreachable
            parent = keys[j - 1] if j else self._root_key(ns)
            e = _CacheEntry(keys[j], None, chunk, parent, ns=ns)
            self.entries[keys[j]] = e
            self.children.setdefault(parent, set()).add(keys[j])
            put(keys[j], payload)
            imported += 1
        self.stats["peer_blocks_imported"] += imported
        return imported

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
                       if e.block is not None and self.ref[e.block] == 0}
        assert not (cached_only & free), "cached block on the free list"
        assert len(free) + len(mapped) + len(cached_only) \
            == self.num_blocks, (
            f"pool partition broken: {len(free)} free + {len(mapped)} "
            f"mapped + {len(cached_only)} cached != {self.num_blocks}")
        # host tier: every demoted entry's payload is in the tier, every
        # tier payload has a live radix node, the tier respects its
        # bound, and in-flight promotions target mapped blocks.
        # Store-resident nodes hold NO local payload (their bytes are on
        # disk only): outside the demoted == tier identity, disjoint
        # from the tier, and impossible without a store.
        stored_keys = {e.key for e in self.entries.values()
                       if e.block is None and e.stored}
        if self.store is None:
            assert not stored_keys, \
                "store-resident entry without a KV store"
        demoted = {e.key for e in self.entries.values()
                   if e.block is None and not e.stored}
        if self.host is not None:
            host_keys = set(self.host.keys())
            assert demoted == host_keys, (
                f"host tier desync: {len(demoted)} demoted entries vs "
                f"{len(host_keys)} host payloads")
            assert not (stored_keys & host_keys), \
                "store-resident entry also holds a host payload"
            assert len(self.host) <= self.host.capacity, \
                "host tier exceeded its bound"
            promoting = {dst for dst, _, _ in self._pending_promotes}
            assert promoting <= mapped, \
                "in-flight promotion targets an unmapped block"
        else:
            assert not demoted, "demoted entry without a host tier"


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
    the trash tail.  The scales start at 0.0, the JAX pool's value: a
    block no completion has quantized yet (a lane's frontier, read from
    its tail) keeps it, so a spill of the lane carries JAX's bytes."""
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
        "ks": torch.zeros(scale_shape, dtype=torch.float32, device=device),
        "vs": torch.zeros(scale_shape, dtype=torch.float32, device=device),
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
                      limit: Optional[torch.Tensor] = None,
                      aligned: bool = False) -> None:
    """One layer's pool [N, H, bs, D] <- [B, H, T, D] rows at per-lane
    start positions ``pos`` — each row lands in whatever pool block the
    table maps for its absolute position (a row span may straddle
    blocks).  Rows at/after ``limit`` (per lane; suffix-prefill pads)
    are redirected to the trash block.

    ``aligned=True`` (the N-lane prefill engine's slices: ``pos`` a
    block multiple, ``T`` a multiple of ``block_size``): the JAX
    function's whole-block writes — a block whose FIRST row is real
    writes whole, its pad rows past ``limit`` included (masked in the
    slice, overwritten by decode before any read), and a block
    entirely past ``limit`` goes to the trash block.  So the straddling
    block holds the pad tokens' KV, as the JAX engine's pool does."""
    b, h, t, d = kv.shape
    p = pos[:, None].long() + torch.arange(t, device=pos.device)[None, :]
    blk = _block_index(table, p, block_size)
    if limit is not None:
        first = (p // block_size) * block_size if aligned else p
        blk = torch.where(first < limit[:, None].long(), blk,
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
                       active: Optional[torch.Tensor] = None, lora=None
                       ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The ring's one-token step over the paged pool: tok [B] at
    per-lane ``cache['pos']`` -> (logits [B, V] f32, cache with the
    pools written in place and ``pos + 1``).  With the kernel selected
    (``cfg.resolved_decode_attn``: a CUDA tensor) each layer's
    attention and wo are ``sharded_paged_decode_attention`` over the
    stacked pool at the layer and the table, lengths ``pos + 1`` after
    the write — an inactive lane
    (``pos`` zeroed) reads one trash row; otherwise the plain path
    gathers the lane view.

    ``quant=True``: the cache is the int8 pool's dict (init_paged_cache
    quant): new rows go to the lanes' staging tails, the attention
    reads codes with the dequant fused (the int8 kernel, or the
    dequantizing view), and after the layers each lane whose row
    completed its block commits it (:func:`_commit_tails`).  ``active``
    [B] (default: all) sends inactive lanes' tail rows to the trash
    tail — a lane whose admission is queued may hold a live tail.
    ``lora``: ``(stacks, aid [B])``, each lane's adapter (infer/qos.py):
    adapter K/V enters either pool like any other K/V."""
    from paddle_operator_tpu_torch.infer.executor import _qkv_ring
    from paddle_operator_tpu_torch.infer.qos import layer_lora

    pos = cache["pos"]
    block_size = cache["k"].shape[3]
    x = D._embed(cfg, params, tok[:, None])
    cos, sin = params.rope_cos, params.rope_sin
    b = x.shape[0]
    cfg = D._local(cfg, params)
    kernel = cfg.resolved_decode_attn(x.device) == "kernel"
    group = D._attn_group(D._shard_of(params))
    lengths = pos + 1
    if quant:
        lanes = torch.arange(b, device=x.device)
        trash_row = cache["kt"].shape[1] - 1
        rows_idx = (lanes if active is None
                    else torch.where(active, lanes,
                                     torch.full_like(lanes, trash_row)))
        wb = (pos // block_size).long()
    for li, lp in enumerate(params.layers):
        q, k, v = _qkv_ring(cfg, lp, x, cos, sin, pos, layer_lora(lora, li))
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
        qkw = ({"k_scale": cache["ks"], "v_scale": cache["vs"],
                "k_tail": cache["kt"], "v_tail": cache["vt"]}
               if quant else {})
        if kernel:
            # kernel #2 (#3 on the int8 pool) on the rank's kv-head slice
            # of the pool (all of it on one card), wo's rows and, on a
            # serving mesh, the all-reduce
            proj = sharded_paged_decode_attention(
                q[:, 0].contiguous(), cache["k"], cache["v"], table,
                lengths, lp.attn.wo, group=group, layer=li,
                compute_dtype=cfg.dtype, **qkw)
            x = D._ffn_residual(cfg, lp, x + proj[:, None].to(cfg.dtype))
            continue
        if quant:
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
    logits = D._logits(cfg, params, x)
    return logits[:, 0], dict(cache, pos=pos + 1)


def make_paged_chunk_step(cfg: LlamaConfig, chunk_tokens: int,
                          top_k: Optional[int] = None,
                          top_p: Optional[float] = None,
                          quant: bool = False,
                          check_finite: bool = False):
    """The paged ring's resident decode step — executor.make_chunk_step
    plus the block table:

    ``step(params, cache, table, tok, temp, seeds, active, lora=None)
    -> (tok', toks [chunk, B])``

    ``chunk_tokens`` ticks for every lane, the pool and ``cache['pos']``
    updated in place.  Inactive lanes compute (the price of fixed
    shapes) but their position is ZEROED each tick and their table row
    is the trash block, so nothing they write reaches a real block.
    ``quant=True``: the int8 pool, ``active`` also steering inactive
    lanes' tail rows to the trash tail (:func:`paged_ring_forward`).
    Everything stays on the device: no host read inside the chunk.
    ``check_finite``: ``ok [B]`` last (executor._ticks)."""
    from paddle_operator_tpu_torch.infer.executor import _ticks

    def step(params, cache, table, tok, temp, seeds, active, lora=None):
        return _ticks(
            lambda t, c: paged_ring_forward(cfg, params, t, c, table,
                                            quant=quant,
                                            active=active if quant else None,
                                            lora=lora),
            cache, tok, temp, seeds, active, chunk_tokens, top_k, top_p,
            check_finite)

    return step


def make_paged_megastep(cfg: LlamaConfig, chunk_tokens: int, n_steps: int,
                        top_k: Optional[int] = None,
                        top_p: Optional[float] = None,
                        quant: bool = False,
                        check_finite: bool = False):
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
    steps, lora=None) -> (tok', toks [n, chunk, B], counts [n, B])`` —
    the output contract of executor.make_megastep, table operand
    added (``oks [n, B]`` last under ``check_finite``)."""
    from paddle_operator_tpu_torch.infer.executor import _fused, _ticks

    def mega(params, cache, table, tok, temp, seeds, active, eos, left,
             steps, lora=None):
        def run_chunk(t, live):
            tbl = torch.where(live[:, None], table,
                              torch.full_like(table, TRASH_BLOCK))
            return _ticks(
                lambda tt, c: paged_ring_forward(
                    cfg, params, tt, c, tbl, quant=quant,
                    active=live if quant else None, lora=lora),
                cache, t, temp, seeds, live, chunk_tokens, top_k, top_p,
                check_finite)

        tok, toks, counts, _, *oks = _fused(
            run_chunk, n_steps, (cache,), tok, active, eos, left, steps,
            check_finite)
        return (tok, toks, counts, *oks)

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
    prompt_len, slot, temp_val, seed, lora=None) -> first_token`` (a
    0-d device tensor; ``cache``/``tok``/``temp``/``seeds`` are updated
    in place; ``lora``: the stacks and the lane's adapter slot [1]).
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
               prompt_len, slot, temp_val, seed, lora=None):
        if quant:
            logits, _, tail_k, tail_v = D.paged_prefill(
                params, cfg, prompt[:, :prompt_len], cache, table_row,
                block_size=block_size, last_only=True, quant=True,
                prompt_len=prompt_len, lora=lora)
            cache["kt"][:, slot] = tail_k[:, 0]
            cache["vt"][:, slot] = tail_v[:, 0]
        else:
            logits, _ = D.paged_prefill(params, cfg, prompt[:, :prompt_len],
                                        cache, table_row,
                                        block_size=block_size,
                                        last_only=True, lora=lora)
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
    # fill_ (a kernel argument), not item assignment of a Python
    # number, which would wait for the stream (restore_lane's note)
    cache["pos"][slot].fill_(int(prompt_len))
    tok[slot] = first
    temp[slot].fill_(float(temp_val))
    seeds[slot].fill_(int(seed))
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
    seed, lora=None) -> first_token``"""
    from paddle_operator_tpu_torch.infer.executor import _sample_tokens
    from paddle_operator_tpu_torch.infer.speculative import (
        _multi_forward_paged,
    )

    def insert(params, cache, table_row, tok, temp, seeds, suffix,
               suffix_len, hit_len, slot, temp_val, seed, lora=None):
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
                             device=dev), quant=quant, lora=lora)
        if quant:
            _restore_lane_tails(cache, lane_cache, slot)
        return _set_lane(cache, tok, temp, seeds,
                         logits[0, int(suffix_len) - 1], prompt_len, slot,
                         temp_val, seed, top_k, top_p, _sample_tokens)

    return insert


def make_paged_prefill_chunk(cfg: LlamaConfig, slice_bucket: int,
                             block_size: int, quant: bool = False):
    """One INTERMEDIATE chunked-prefill slice against the block pool
    (``prefill_mode="chunked"``): append the slice's KV rows at absolute
    positions [start, start + slice_bucket) through the lane's table —
    no lm head, no lane-state update, no first token; only the FINAL
    slice (the SUFFIX insert with ``hit_len`` = the rows already
    written) does those.  Rows at or past ``limit`` route to the trash
    block, so a partial-tail radix hit can start a chunked prefill
    mid-block safely.  The pools are written in place.

    ``chunk(params, cache, table_row [M], toks [1, slice_bucket],
    start, limit, lora=None)``

    ``quant=True`` adds a trailing ``slot`` argument (the tail rows
    address by lane): the slice rides the lane's staging tail (sliced
    to a 2-row mini tail for the batch-of-one forward and written back
    in place after it) and whole blocks quantize as they complete, so
    the tail state carried between slices IS the cache's."""
    from paddle_operator_tpu_torch.infer.speculative import (
        _multi_forward_paged,
    )

    def _lane(cache, start, dev):
        return {"k": cache["k"], "v": cache["v"],
                "pos": torch.full((1,), int(start), dtype=torch.int32,
                                  device=dev)}

    def _limit(limit, dev):
        return torch.full((1,), int(limit), dtype=torch.int32, device=dev)

    def chunk(params, cache, table_row, toks, start, limit, lora=None):
        _multi_forward_paged(cfg, params, toks,
                             _lane(cache, start, toks.device),
                             table_row[None, :],
                             limit=_limit(limit, toks.device), head=False,
                             lora=lora)

    def chunk_quant(params, cache, table_row, toks, start, limit, slot,
                    lora=None):
        lane = _lane(cache, start, toks.device)
        lane["ks"], lane["vs"] = cache["ks"], cache["vs"]
        lane["kt"], lane["vt"] = _slice_lane_tails(cache, slot)
        _, lane = _multi_forward_paged(cfg, params, toks, lane,
                                       table_row[None, :],
                                       limit=_limit(limit, toks.device),
                                       quant=True, head=False, lora=lora)
        _restore_lane_tails(cache, lane, slot)

    return chunk_quant if quant else chunk


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


def make_pool_frame_transfer(max_blocks: int, quant: bool = False):
    """The disaggregated HANDOFF copy of one block group: pool blocks of
    the prefill engine's (small, private) pool into the decode pool's
    reserved blocks — all layers, K and V (codes and scales on the int8
    pool) — in place, on the current stream (the ring's), so the
    captured graphs keep reading the decode pool at its address.  A
    streamed frame and a terminal item's remainder both land through
    it; the int8 staging tail crosses once, with the terminal item
    (:func:`make_pool_tail_copy`).  The JAX ops pad their id vectors to
    ``max_blocks`` with the trash block to bound their compiles; eager
    PyTorch compiles nothing, so the ids go at their own length
    (``max_blocks`` is kept as the bound they must respect).

    ``transfer(dst, src, src_ids [n], dst_ids [n])``: ``dst``/``src``
    the two pools' cache dicts, the ids long tensors on the device."""
    keys = ("k", "v", "ks", "vs") if quant else ("k", "v")

    def transfer(dst, src, src_ids, dst_ids):
        if src_ids.numel() > max_blocks:
            raise ValueError(f"a handoff of {src_ids.numel()} blocks "
                             f"exceeds the lane's {max_blocks}")
        for key in keys:
            dst[key].index_copy_(1, dst_ids, src[key].index_select(
                1, src_ids))

    return transfer


def make_pool_tail_copy():
    """The terminal handoff item's staging-tail copy (int8 pools):
    src tail row ``src_row`` — the prefill ENGINE lane that ran the job
    — lands in decode tail row ``slot``, in place.

    ``cp(dst, src, src_row, slot)``"""

    def cp(dst, src, src_row, slot):
        for key in ("kt", "vt"):
            dst[key][:, slot].copy_(src[key][:, src_row])

    return cp


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
