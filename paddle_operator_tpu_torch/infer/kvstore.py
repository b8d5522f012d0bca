"""Durable prefix store — the persistent KV tier below the host tier;
the port of ``paddle_operator_tpu/infer/kvstore.py``.

One store entry is one demoted block payload, wrapped in a fleet-KV
envelope (``utils/fleetkv.py``) of kind ``"kvblock"`` whose meta carries
the radix chain key, the namespace, the raw token chunk (so a hash
collision is caught by the radix walk's equality check) and the ring
fingerprint.  Files are named by the process-stable chain key
(``ns{ns}/{sign}{key:x}.tpkv``), so the port and the JAX package read
and write the same volume: a file either writes decodes under the
other's ``fetch``.  Everything the envelope refuses — truncation, CRC
mismatch, version or fingerprint skew, a file under another key's name —
the store refuses too, wholesale, and deletes the file.

Write path: the host tier's overflow drops are offered to a BACKGROUND
writer thread through a bounded drop-oldest queue — the ring thread
never blocks on disk.  A payload that lives in a slot of the ring's
pinned host slab (``infer/executor.py`` ``HostSlab``) is HELD by the
store from ``offer`` until the writer has copied its bytes out (after
waiting for the slot's device-to-host copy), and the writer releases the
slot then, before the file write; a shed offer releases it at once.
:meth:`KVBlockStore.shed_oldest` gives a slot back to a ring that finds
its slab full.  Files land via write-tmp + fsync + rename, so a crash
mid-write leaves only a ``*.tmp`` orphan that readers never see.

Read path: ``ContinuousBatcher`` probes the store on the submit thread
and queues a hit through ``PagedCacheManager.import_host_blocks`` -> host
tier -> the batched promote, so a store hit is bit-identical to a cold
prefill by the same construction the host tier already pins.

Lifecycle: :meth:`KVBlockStore.janitor` applies a TTL (last-touch mtime)
then a size budget (LRU by mtime); ``python -m
paddle_operator_tpu_torch.infer.kvstore dir:/path --ttl-s ... --budget-mb
...`` runs the same pass against a shared volume.  The router's own
consult of the store (JAX ``KVBlockStore.fetch_prefix_envelope``) runs
in the router, which reads the same volume; a replica never calls it.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

from paddle_operator_tpu_torch.utils import fleetkv as FK
from paddle_operator_tpu_torch.utils.radixkey import chain_key

KIND = "kvblock"
_SUFFIX = ".tpkv"
# a *.tmp older than this is a torn write from a dead process — the
# janitor may reclaim it (a live writer renames within milliseconds)
TMP_REAP_S = 300.0

_tmp_seq = itertools.count()


def parse_store_url(url: str) -> "DirBackend":
    """``SERVE_KV_STORE`` value -> backend.  ``dir:/path`` is the
    local-disk (or shared-volume) backend; the scheme prefix leaves room
    for a second backend behind a new scheme."""
    url = url.strip()
    scheme, _, rest = url.partition(":")
    if scheme == "dir" and rest:
        return DirBackend(rest)
    raise ValueError(
        f"unsupported KV store url {url!r} (expected dir:/path)")


class DirBackend:
    """Directory-per-namespace block files, one fleet-KV envelope each:
    ``put`` (atomic), ``get``, ``exists``, ``touch``, ``delete``,
    ``entries`` (size + last-touch listing for the janitor) and
    ``sweep_tmp``."""

    def __init__(self, root: str) -> None:
        self.root = os.path.abspath(root)
        os.makedirs(self.root, exist_ok=True)

    def _ns_dir(self, ns: int) -> str:
        return os.path.join(self.root, f"ns{int(ns)}")

    def path(self, ns: int, key: int) -> str:
        # chain keys are arbitrary-width ints and may be NEGATIVE (a
        # tuple hash): the sign is explicit, the magnitude hex
        k = int(key)
        sign = "n" if k < 0 else "p"
        return os.path.join(self._ns_dir(ns),
                            f"{sign}{abs(k):x}{_SUFFIX}")

    def put(self, ns: int, key: int, blob: bytes) -> None:
        """Atomic publish: write a sibling ``*.tmp``, fsync, rename.  A
        reader sees the old file, the new file, or nothing."""
        final = self.path(ns, key)
        os.makedirs(os.path.dirname(final), exist_ok=True)
        tmp = f"{final}.{os.getpid()}.{next(_tmp_seq)}.tmp"
        with open(tmp, "wb") as f:
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, final)

    def get(self, ns: int, key: int) -> Optional[bytes]:
        try:
            with open(self.path(ns, key), "rb") as f:
                return f.read()
        except (FileNotFoundError, NotADirectoryError, IsADirectoryError):
            return None

    def exists(self, ns: int, key: int) -> bool:
        return os.path.isfile(self.path(ns, key))

    def touch(self, ns: int, key: int) -> None:
        """Stamp last-touch time — the janitor's LRU/TTL clock."""
        try:
            os.utime(self.path(ns, key), None)
        except OSError:
            pass

    def delete(self, ns: int, key: int) -> None:
        try:
            os.remove(self.path(ns, key))
        except OSError:
            pass

    def entries(self) -> List[Tuple[str, int, float]]:
        """Every published entry as ``(path, size, last_touch)``."""
        out: List[Tuple[str, int, float]] = []
        for dirpath, _dirs, files in os.walk(self.root):
            for fn in files:
                if not fn.endswith(_SUFFIX):
                    continue
                p = os.path.join(dirpath, fn)
                try:
                    st = os.stat(p)
                except OSError:
                    continue
                out.append((p, int(st.st_size), float(st.st_mtime)))
        return out

    def sweep_tmp(self, max_age_s: float = TMP_REAP_S) -> int:
        """Reap torn-write ``*.tmp`` orphans older than ``max_age_s``."""
        now = time.time()
        reaped = 0
        for dirpath, _dirs, files in os.walk(self.root):
            for fn in files:
                if not fn.endswith(".tmp"):
                    continue
                p = os.path.join(dirpath, fn)
                try:
                    if now - os.stat(p).st_mtime >= max_age_s:
                        os.remove(p)
                        reaped += 1
                except OSError:
                    continue
        return reaped


def _release(payload) -> None:
    """Give back a slab-backed payload's slot (plain dicts hold none)."""
    release = getattr(payload, "release", None)
    if release is not None:
        release()


class KVBlockStore:
    """The durable tier: a backend + a background writer + a janitor.

    ``fingerprint`` is the owning ring's geometry dict
    (``ContinuousBatcher._fingerprint()``); ``None`` means a ring-less
    consumer, which takes the first fetched entry's fingerprint and
    requires the rest of the chain to agree with it."""

    def __init__(self, backend: DirBackend,
                 fingerprint: Optional[Dict[str, Any]] = None,
                 ttl_s: float = 0.0, budget_mb: int = 0,
                 queue_len: int = 256) -> None:
        self.backend = backend
        self.fingerprint = fingerprint
        self.ttl_s = float(ttl_s)
        self.budget_mb = int(budget_mb)
        self._q: "deque[Tuple[int, int, Tuple[int, ...], Dict[str, Any]]]" \
            = deque()
        self._q_max = max(1, int(queue_len))
        # offers not yet persisted or shed (queued + the one in the
        # writer's hands): flush() waits for 0 under the condition
        self._unsettled = 0
        self._cv = threading.Condition()
        self._stop = False
        self._writer: Optional[threading.Thread] = None
        self.stats = {
            # write side: payloads persisted, offers shed by the bounded
            # queue (drop-oldest) or given back to a full slab, bytes
            # written
            "puts": 0, "put_drops": 0, "bytes_written": 0,
            # read side: fetch calls, fetch calls that returned >= 1
            # block, blocks returned, entries refused + deleted
            "probes": 0, "hits": 0, "blocks_fetched": 0, "refused": 0,
            # lifecycle: janitor removals (TTL + budget LRU)
            "evicted": 0,
        }

    # -- write path (ring thread -> writer thread) --------------------------

    def offer(self, key: int, chunk: Sequence[int],
              payload: Dict[str, Any], ns: int = 0) -> None:
        """Queue one demoted payload for persistence (holding its slab
        slot, if it has one).  NEVER blocks: on backpressure the OLDEST
        queued offer is shed — it aged out of the host tier first."""
        hold = getattr(payload, "hold", None)
        if hold is not None:
            hold()
        with self._cv:
            if len(self._q) >= self._q_max:
                self._shed_locked()
            self._q.append((int(ns), int(key),
                            tuple(int(t) for t in chunk), payload))
            self._unsettled += 1
            if self._writer is None:
                self._writer = threading.Thread(
                    target=self._writer_loop, daemon=True,
                    name="kvstore-writer")
                self._writer.start()
            self._cv.notify_all()

    def _shed_locked(self) -> bool:
        """Drop the oldest queued offer (the caller holds the lock)."""
        if not self._q:
            return False
        _, _, _, payload = self._q.popleft()
        self.stats["put_drops"] += 1
        self._unsettled -= 1
        _release(payload)
        self._cv.notify_all()
        return True

    def shed_oldest(self) -> bool:
        """Give the oldest queued (not yet started) offer's slot back:
        what a ring whose slab has no free slot calls instead of waiting
        for the disk.  Counts as a drop-oldest shed.  Returns False when
        nothing is queued."""
        with self._cv:
            return self._shed_locked()

    def _writer_loop(self) -> None:
        while True:
            with self._cv:
                while not self._q and not self._stop:
                    self._cv.wait()
                if not self._q:
                    return
                ns, key, chunk, payload = self._q.popleft()
            try:
                try:
                    blob = self._encode_one(ns, key, chunk, payload)
                finally:
                    _release(payload)   # the bytes are out of the slot
                if blob is not None:
                    self.backend.put(ns, key, blob)
                    self.stats["puts"] += 1
                    self.stats["bytes_written"] += len(blob)
            except Exception:
                pass    # persistence is an optimization, never a fault
            finally:
                with self._cv:
                    self._unsettled -= 1
                    self._cv.notify_all()

    def _encode_one(self, ns: int, key: int, chunk: Tuple[int, ...],
                    payload: Dict[str, Any]) -> Optional[bytes]:
        """The entry's envelope, or None when the key is already on disk
        (same chain key = same immutable bytes under the same
        fingerprint: its LRU stamp is refreshed instead)."""
        if self.backend.exists(ns, key):
            self.backend.touch(ns, key)
            return None
        wait = getattr(payload, "wait", None)
        if wait is not None:
            wait()          # the slot's device-to-host copy has landed
        return FK.encode_envelope(KIND, {
            "key": int(key), "ns": int(ns),
            "chunk": [int(t) for t in chunk],
            "fingerprint": self.fingerprint,
        }, dict(payload))

    def flush(self, timeout: float = 10.0) -> bool:
        """Wait until every offer so far is persisted or shed; False on
        timeout.  A condition wait, no polling: the writer notifies as
        each offer settles."""
        with self._cv:
            return self._cv.wait_for(lambda: self._unsettled == 0,
                                     timeout=timeout)

    def close(self) -> None:
        """Stop the writer after the offer in its hands; queued offers
        are shed (their slots released)."""
        with self._cv:
            self._stop = True
            while self._shed_locked():
                pass
            self._cv.notify_all()
        if self._writer is not None:
            self._writer.join(timeout=30.0)

    # -- read path ----------------------------------------------------------

    def _decode_one(self, ns: int, key: int, chunk: Tuple[int, ...],
                    blob: bytes, want_fp: Optional[Dict[str, Any]]
                    ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """One entry's bytes -> ``(meta, payload)``, or EnvelopeError:
        the envelope's own checks plus kind, key/ns/chunk identity, k/v
        presence and the fingerprint."""
        kind, meta, arrays = FK.decode_envelope(blob)
        if kind != KIND:
            raise FK.EnvelopeError(
                f"expected a {KIND} envelope, got {kind!r}")
        if (int(meta.get("key", 0)) != int(key)
                or int(meta.get("ns", -1)) != int(ns)
                or [int(t) for t in meta.get("chunk", ())] != list(chunk)):
            raise FK.EnvelopeError(
                "store entry identity mismatch (key/ns/chunk disagree "
                "with its chain position) — refusing")
        if "k" not in arrays or "v" not in arrays:
            raise FK.EnvelopeError("store entry missing k/v payload")
        if want_fp is not None:
            FK.check_fingerprint(meta, want_fp)
        return meta, arrays

    def fetch(self, tokens: Sequence[int], block_size: int, ns: int = 0,
              skip: int = 0) -> Tuple[List[List[int]], List[int],
                                      List[Dict[str, Any]],
                                      Optional[Dict[str, Any]]]:
        """Probe the store for the prompt's chain: ``(chunks, block_idx,
        payloads, fingerprint)`` — chunks = EVERY full block's tokens
        from the chain start (the importer recomputes parent keys from
        them), then the hit blocks' indices and payloads (CPU tensors),
        and the entries' fingerprint.  ``skip`` = leading blocks the
        caller already covers; probing stops at the first miss past it
        (deeper blocks would be unreachable).  A refused entry is deleted
        and ends the probe.  Adapter namespaces abstain."""
        self.stats["probes"] += 1
        empty: Tuple[List[List[int]], List[int], List[Dict[str, Any]],
                     Optional[Dict[str, Any]]] = ([], [], [], None)
        if ns:
            return empty
        bs = int(block_size)
        toks = [int(t) for t in tokens]
        n_full = len(toks) // bs
        if n_full == 0:
            return empty
        chunks: List[List[int]] = []
        keys: List[int] = []
        key: Optional[int] = None
        for j in range(n_full):
            chunk = tuple(toks[j * bs:(j + 1) * bs])
            key = chain_key(key, chunk)
            chunks.append(list(chunk))
            keys.append(key)
        block_idx: List[int] = []
        payloads: List[Dict[str, Any]] = []
        fp: Optional[Dict[str, Any]] = self.fingerprint
        for j in range(max(0, int(skip)), n_full):
            blob = self.backend.get(ns, keys[j])
            if blob is None:
                break
            try:
                meta, payload = self._decode_one(
                    ns, keys[j], tuple(chunks[j]), blob, fp)
            except FK.EnvelopeError:
                self.backend.delete(ns, keys[j])
                self.stats["refused"] += 1
                break
            if fp is None:
                fp = meta.get("fingerprint")
            self.backend.touch(ns, keys[j])
            block_idx.append(j)
            payloads.append(payload)
        if block_idx:
            self.stats["hits"] += 1
            self.stats["blocks_fetched"] += len(block_idx)
        return chunks, block_idx, payloads, fp

    def delete(self, key: int, ns: int = 0) -> None:
        """Drop one entry (quarantine scrub of a store-resident chain)."""
        self.backend.delete(ns, key)

    # -- lifecycle ----------------------------------------------------------

    def usage(self) -> Tuple[int, int]:
        """``(blocks, bytes)`` resident — the kvStoreBlocks /
        kvStoreBytes status keys."""
        ents = self.backend.entries()
        return len(ents), sum(sz for _, sz, _ in ents)

    def hit_rate(self) -> float:
        """Share of probes that returned >= 1 block — kvStoreHitRate."""
        p = self.stats["probes"]
        return round(self.stats["hits"] / p, 4) if p else 0.0

    def evictions(self) -> int:
        return self.stats["evicted"]

    def janitor(self, now: Optional[float] = None) -> Dict[str, int]:
        """One lifecycle pass: reap torn-write tmp orphans, expire
        entries past the TTL (last touch), then enforce the size budget
        LRU-oldest-first."""
        now = time.time() if now is None else float(now)
        reaped_tmp = self.backend.sweep_tmp()
        expired = 0
        ents = self.backend.entries()
        if self.ttl_s > 0:
            live: List[Tuple[str, int, float]] = []
            for p, sz, mt in ents:
                if now - mt >= self.ttl_s:
                    try:
                        os.remove(p)
                        expired += 1
                    except OSError:
                        pass
                else:
                    live.append((p, sz, mt))
            ents = live
        budget_evicted = 0
        if self.budget_mb > 0:
            budget = self.budget_mb * (1 << 20)
            total = sum(sz for _, sz, _ in ents)
            for p, sz, _mt in sorted(ents, key=lambda e: e[2]):
                if total <= budget:
                    break
                try:
                    os.remove(p)
                    total -= sz
                    budget_evicted += 1
                except OSError:
                    pass
        self.stats["evicted"] += expired + budget_evicted
        return {"tmp_reaped": reaped_tmp, "expired": expired,
                "budget_evicted": budget_evicted}


def _janitor_main(argv: Optional[List[str]] = None) -> int:
    """Offline GC against a (shared-volume) store directory:
    ``python -m paddle_operator_tpu_torch.infer.kvstore dir:/path
    --ttl-s ... --budget-mb ... [--interval-s N]`` — one pass by
    default, a long-running janitor with ``--interval-s``."""
    import argparse

    p = argparse.ArgumentParser(
        prog="python -m paddle_operator_tpu_torch.infer.kvstore",
        description="durable prefix store janitor (TTL + size budget)")
    p.add_argument("store", help="store url, e.g. dir:/var/kvstore")
    p.add_argument("--ttl-s", type=float, default=0.0,
                   help="expire entries idle longer than this (0 = off)")
    p.add_argument("--budget-mb", type=int, default=0,
                   help="LRU-evict down to this size (0 = unbounded)")
    p.add_argument("--interval-s", type=float, default=0.0,
                   help="loop every N seconds (0 = one pass and exit)")
    args = p.parse_args(argv)
    store = KVBlockStore(parse_store_url(args.store),
                         ttl_s=args.ttl_s, budget_mb=args.budget_mb)
    while True:
        out = store.janitor()
        blocks, nbytes = store.usage()
        print(f"kvstore janitor: {out} now {blocks} blocks "
              f"{nbytes} bytes", flush=True)
        if args.interval_s <= 0:
            return 0
        time.sleep(args.interval_s)


if __name__ == "__main__":
    raise SystemExit(_janitor_main())
