"""The fleet-KV wire envelope — own copy of the envelope, handoff,
streamed-frame, prefix and HTTP-client parts of
``paddle_operator_tpu/utils/fleetkv.py``.

A block payload (the host tier's demoted bytes) travels and rests in ONE
self-describing form: the durable prefix store (``infer/kvstore.py``)
writes each demoted block as one ``kind="kvblock"`` envelope, and the
files must stay byte-compatible with the JAX replica's, both ways, so a
fleet of mixed replicas — and the router, which reads the same volume —
share one store.

Layout (little-endian)::

    b"TPKV" | u32 version | u32 header_len | header JSON | payload

The header carries ``meta`` (JSON scalars: chain key, chunk, ring
fingerprint), an ``arrays`` manifest (name / dtype / shape / offset /
nbytes into the payload, sorted by name) and ``crc`` (zlib.crc32 of the
payload).  For the same meta and arrays the port writes the JAX
package's bytes exactly: the same JSON, the same manifest, the same CRC.

Arrays are numpy arrays or CPU torch tensors on the way in and CPU torch
tensors on the way out.  A bfloat16 array travels by the dtype NAME
``"bfloat16"`` (numpy has no bfloat16; the JAX package writes the
ml_dtypes name), and is read back as ``torch.bfloat16`` through an int16
view of its bytes — no ``ml_dtypes`` needed.  Every other dtype travels
as numpy's byte-order-explicit ``.str``.

:func:`decode_envelope` refuses ANY inconsistency with
:class:`EnvelopeError` (bad magic, version skew, truncation, checksum,
manifest bounds): a torn or skewed envelope refuses wholesale, never
half-applies.

A disaggregated prefill's result crosses hosts as a HANDOFF envelope
(:func:`encode_handoff`) or, streamed, as length-prefixed frames
(:func:`encode_handoff_frame` ... :func:`encode_handoff_final`) on a
chunked HTTP response; :func:`http_post_retry` is the bounded-retry POST
the remote prefill client walks the prefill pool with.

A live lane crosses replicas as a LANE envelope (:func:`encode_lane`,
:func:`decode_lane`): drain-by-migration and the parked-lane shed post
it to a peer's ``/v1/kv/restore`` (through the router's
``/v1/kv/migrate`` when one brokers), and a peer whose radix walk misses
asks for a prompt's demoted blocks as a PREFIX envelope
(``/v1/kv/prefix``).  :class:`FleetKVClient` is the replica's side of
both wires.  The port's spill keeps the lane's sampling ``seed`` where
the JAX spill keeps ``key`` (``jax.random.PRNGKey(seed)``, fixed for
the lane's life): the lane envelope carries JAX's ``key`` pair
(:func:`lane_key`), so a lane envelope of either package adopts on
the other.
"""

from __future__ import annotations

import json
import random
import socket
import struct
import time
import zlib
from http.client import HTTPConnection
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

MAGIC = b"TPKV"
VERSION = 1
_HDR = struct.Struct("<II")           # version, header_len

_BF16 = "bfloat16"

# The replica's budget for one fleet-KV POST, the JAX package's: the
# router's forward to an adopter (its own 4 s budget) completes or fails
# well inside it, so an ambiguous hop never reads as a clean refusal —
# which would resume the lane here while the adopter decodes it too.
BROKER_TIMEOUT_S = 8.0


class EnvelopeError(ValueError):
    """A wire envelope failed validation (bad magic, version skew,
    truncation, checksum mismatch, manifest/fingerprint disagreement).
    Receivers refuse the whole envelope."""


def _dtype_token(a) -> str:
    """Manifest token for an array's dtype: ``"bfloat16"`` for a
    bfloat16 tensor (and for a numpy extension dtype, by its name, as
    the JAX package writes it), numpy's ``.str`` otherwise."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return _BF16
        return torch.empty(0, dtype=a.dtype).numpy().dtype.str
    dt = np.dtype(a.dtype)
    return dt.name if dt.kind == "V" else dt.str


def _resolve_dtype(token: str):
    """Manifest token -> numpy dtype, or ``"bfloat16"`` (read through
    an int16 view)."""
    if token == _BF16:
        return _BF16
    try:
        dt = np.dtype(token)
        if dt.kind != "V":
            return dt
    except TypeError:
        pass
    raise EnvelopeError(f"unresolvable array dtype {token!r} in envelope "
                        "manifest")


def _raw(a) -> bytes:
    """The array's bytes in C order."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().tobytes()
    return np.ascontiguousarray(a).tobytes()


def encode_envelope(kind: str, meta: Dict[str, Any],
                    arrays: Dict[str, Any]) -> bytes:
    """Serialize ``arrays`` (name -> ndarray or CPU tensor) plus
    JSON-safe ``meta`` into one self-describing envelope."""
    manifest: List[Dict[str, Any]] = []
    chunks: List[bytes] = []
    off = 0
    for name in sorted(arrays):
        a = arrays[name]
        raw = _raw(a)
        manifest.append({"name": name, "dtype": _dtype_token(a),
                         "shape": [int(s) for s in a.shape], "offset": off,
                         "nbytes": len(raw)})
        chunks.append(raw)
        off += len(raw)
    payload = b"".join(chunks)
    header = json.dumps({
        "version": VERSION, "kind": kind, "meta": meta,
        "arrays": manifest, "crc": zlib.crc32(payload) & 0xFFFFFFFF,
    }).encode()
    return MAGIC + _HDR.pack(VERSION, len(header)) + header + payload


def peek_header(buf: bytes) -> Dict[str, Any]:
    """Parse and validate ONLY the header (magic, version, JSON)."""
    if len(buf) < len(MAGIC) + _HDR.size or buf[:len(MAGIC)] != MAGIC:
        raise EnvelopeError("not a fleet-KV envelope (bad magic)")
    version, hlen = _HDR.unpack_from(buf, len(MAGIC))
    if version != VERSION:
        raise EnvelopeError(
            f"envelope version {version} != supported {VERSION}; "
            "refusing (mixed-version fleet mid-rollout — retry after "
            "the rollout converges)")
    start = len(MAGIC) + _HDR.size
    if len(buf) < start + hlen:
        raise EnvelopeError("truncated envelope (header cut short)")
    try:
        header = json.loads(buf[start:start + hlen])
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise EnvelopeError(f"corrupt envelope header: {e}") from None
    if header.get("version") != version:
        raise EnvelopeError("envelope header/frame version disagree")
    return header


def decode_envelope(buf: bytes) -> Tuple[str, Dict[str, Any],
                                         Dict[str, torch.Tensor]]:
    """Validate + deserialize: returns ``(kind, meta, arrays)`` with
    the arrays as CPU tensors.  Raises :class:`EnvelopeError` on ANY
    inconsistency."""
    header = peek_header(buf)
    # the payload starts where the FRAME's header_len says, never where
    # a re-serialized header would end (JSON re-dumps are not
    # byte-stable)
    _, hlen = _HDR.unpack_from(buf, len(MAGIC))
    start = len(MAGIC) + _HDR.size + hlen
    payload = buf[start:]
    total = sum(int(m["nbytes"]) for m in header["arrays"])
    if len(payload) != total:
        raise EnvelopeError(
            f"truncated envelope: payload {len(payload)} bytes, "
            f"manifest expects {total}")
    if (zlib.crc32(payload) & 0xFFFFFFFF) != header.get("crc"):
        raise EnvelopeError("payload checksum mismatch (corrupt or "
                            "truncated envelope)")
    arrays: Dict[str, torch.Tensor] = {}
    for m in header["arrays"]:
        off, nb = int(m["offset"]), int(m["nbytes"])
        if off < 0 or off + nb > len(payload):
            raise EnvelopeError(f"array {m['name']!r} manifest out of "
                                "payload bounds")
        dt = _resolve_dtype(m["dtype"])
        raw = np.dtype(np.int16) if dt == _BF16 else dt
        a = np.frombuffer(payload, dtype=raw, count=nb // raw.itemsize,
                          offset=off).reshape(m["shape"]).copy()
        t = torch.from_numpy(a)
        arrays[m["name"]] = t.view(torch.bfloat16) if dt == _BF16 else t
    return header["kind"], header["meta"], arrays


def check_fingerprint(meta: Dict[str, Any], mine: Dict[str, Any]) -> None:
    """Reject an envelope whose ring fingerprint (layer/head geometry,
    block size, quant mode, spec depth, generation) disagrees with the
    receiver — the byte layouts would silently misinterpret each
    other."""
    theirs = meta.get("fingerprint")
    if theirs != mine:
        raise EnvelopeError(
            f"ring fingerprint mismatch: envelope {theirs} vs "
            f"receiver {mine} — refusing (mixed fleet config?)")


# ---------------------------------------------------------------------------
# Lane (migration) envelopes
# ---------------------------------------------------------------------------

# spill-dict keys that are arrays (everything else rides in meta)
_LANE_ARRAYS = ("k", "v", "ks", "vs", "kt", "vt", "dk", "dv")


def lane_key(seed: int) -> List[int]:
    """The JAX lane's sampler key for ``seed``: ``jax.random.PRNGKey``'s
    threefry seed pair ``[seed >> 32, seed & 0xFFFFFFFF]`` as uint32
    words (the key never changes over a JAX lane's life: its draws fold
    the position in)."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    return [(seed >> 32) & 0xFFFFFFFF, seed & 0xFFFFFFFF]


def encode_lane(meta: Dict[str, Any], spill: Dict[str, Any]) -> bytes:
    """A live lane's spill (``RingExecutor.spill_lane``) plus request
    meta -> wire envelope, byte-equal to the JAX package's for the same
    meta and arrays.  Scalars (pos/tok/temp/key/n_blocks/dpos) fold into
    meta; the port's ``seed`` travels as JAX's ``key`` (:func:`lane_key`;
    a spill that already holds ``key`` keeps it).  The per-replica
    adapter SLOT does not travel: the adopter re-resolves the adapter by
    name."""
    m = dict(meta)
    m["pos"] = int(spill["pos"])
    m["tok"] = int(spill["tok"])
    m["temp"] = float(spill["temp"])
    m["key"] = ([int(x) for x in np.asarray(spill["key"]).ravel()]
                if "key" in spill else lane_key(spill["seed"]))
    m["nBlocks"] = int(spill["n_blocks"])
    if "dpos" in spill:
        m["dpos"] = int(spill["dpos"])
    arrays = {k: spill[k] for k in _LANE_ARRAYS if k in spill}
    return encode_envelope("lane", m, arrays)


def decode_lane(buf: bytes) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Wire envelope -> ``(meta, spill)`` ready for
    ``ContinuousBatcher.adopt`` / ``RingExecutor.restore_lane``: the
    arrays as CPU tensors, ``seed`` from ``meta["seed"]`` (or, without
    it, the key's low word) beside JAX's ``key``.  Refuses what the JAX
    decoder refuses, with :class:`EnvelopeError`."""
    kind, meta, arrays = decode_envelope(buf)
    if kind != "lane":
        raise EnvelopeError(f"expected a lane envelope, got {kind!r}")
    for req_key in ("pos", "tok", "temp", "key", "nBlocks", "prompt",
                    "left"):
        if req_key not in meta:
            raise EnvelopeError(f"lane envelope missing meta "
                                f"{req_key!r}")
    if "k" not in arrays or "v" not in arrays:
        raise EnvelopeError("lane envelope missing k/v arrays")
    key = np.asarray(meta["key"], np.uint32)
    spill: Dict[str, Any] = {
        "pos": int(meta["pos"]), "tok": int(meta["tok"]),
        "temp": float(meta["temp"]), "key": key,
        "seed": (int(meta["seed"]) if meta.get("seed") is not None
                 else int(key.ravel()[-1])),
        "n_blocks": int(meta["nBlocks"]),
    }
    if "dpos" in meta:
        spill["dpos"] = int(meta["dpos"])
    spill.update(arrays)
    return meta, spill


# ---------------------------------------------------------------------------
# Disaggregated prefill: the handoff envelope and its streamed frames
# ---------------------------------------------------------------------------


def encode_handoff(meta: Dict[str, Any], arrays: Dict[str, Any]) -> bytes:
    """A completed remote PREFILL's block snapshot -> wire envelope.  The
    prefill pod ran the whole-prompt forward and sampled the first
    token; the decode replica lands the blocks through its promote
    scatter and attaches the lane exactly as the in-process handoff
    does.  ``meta`` must carry ``first`` (the sampled first token),
    ``promptLen``, ``nBlocks`` and the HANDOFF fingerprint
    (``infer/prefill_serve.handoff_fingerprint``)."""
    return encode_envelope("handoff", meta, arrays)


def decode_handoff(buf: bytes) -> Tuple[Dict[str, Any],
                                        Dict[str, torch.Tensor]]:
    """Wire envelope -> ``(meta, arrays)`` for the decode-side handoff
    receiver.  Raises :class:`EnvelopeError` on any inconsistency — kind
    mismatch, missing meta, missing k/v payload, a block count that
    disagrees with the meta — on top of :func:`decode_envelope`'s
    magic/version/CRC/manifest checks."""
    kind, meta, arrays = decode_envelope(buf)
    if kind != "handoff":
        raise EnvelopeError(f"expected a handoff envelope, got {kind!r}")
    for req_key in ("first", "promptLen", "nBlocks"):
        if req_key not in meta:
            raise EnvelopeError(
                f"handoff envelope missing meta {req_key!r}")
    if "k" not in arrays or "v" not in arrays:
        raise EnvelopeError("handoff envelope missing k/v arrays")
    n = int(meta["nBlocks"])
    for name in ("k", "v"):
        if arrays[name].shape[1] != n:
            raise EnvelopeError(
                f"handoff payload {name} carries "
                f"{arrays[name].shape[1]} blocks, meta says {n}")
    return meta, arrays


# Each streamed-handoff frame is a full envelope (magic + version +
# manifest + per-frame CRC) carried length-prefixed on a chunked HTTP
# response, so the decode side uploads completed block groups WHILE the
# prefill pod computes the rest of the prompt.  The terminal frame
# carries the handoff meta plus the frame count — a receiver that saw
# any gap, reorder, CRC failure or truncation refuses the WHOLE stream:
# partially-applied prefill KV must never activate a lane.
_FRAME_LEN = struct.Struct("<I")

FRAME_KIND = "hframe"
FINAL_KIND = "hfinal"


def frame_wire(envelope: bytes) -> bytes:
    """Length-prefix one frame envelope for the chunked stream."""
    return _FRAME_LEN.pack(len(envelope)) + envelope


def encode_handoff_frame(seq: int, j0: int,
                         arrays: Dict[str, Any]) -> bytes:
    """One INTERMEDIATE streamed-handoff frame: a completed block group
    ``[j0, j0 + width)`` (k/v, plus the verbatim scale rows under int8).
    Returns the WIRE bytes (length prefix included)."""
    return frame_wire(encode_envelope(
        FRAME_KIND, {"seq": int(seq), "j0": int(j0)}, arrays))


def encode_handoff_final(meta: Dict[str, Any],
                         arrays: Dict[str, Any]) -> bytes:
    """The TERMINAL streamed-handoff frame: the remaining blocks
    ``[j0, nBlocks)`` plus (int8) the exact staging tail, and the handoff
    meta — ``first``, ``promptLen``, ``nBlocks``, ``seq``, ``nFrames``
    and the fingerprint the receiver validates before any frame's bytes
    are trusted."""
    return frame_wire(encode_envelope(FINAL_KIND, meta, arrays))


def read_wire_frame(read) -> Optional[bytes]:
    """Read one length-prefixed frame from ``read(n)`` (an HTTP response
    or socket-like).  Returns None on a clean EOF BEFORE a frame starts;
    raises EnvelopeError on a frame cut short (a mid-stream death)."""
    head = b""
    while len(head) < _FRAME_LEN.size:
        got = read(_FRAME_LEN.size - len(head))
        if not got:
            if head:
                raise EnvelopeError(
                    "streamed handoff died mid-frame (length prefix "
                    "cut short)")
            return None
        head += got
    (n,) = _FRAME_LEN.unpack(head)
    buf = b""
    while len(buf) < n:
        got = read(n - len(buf))
        if not got:
            raise EnvelopeError(
                f"streamed handoff died mid-frame ({len(buf)} of {n} "
                "bytes)")
        buf += got
    return buf


def decode_handoff_frame(buf: bytes, expect_seq: int
                         ) -> Tuple[str, Dict[str, Any],
                                    Dict[str, torch.Tensor]]:
    """Validate one streamed-handoff frame (magic/CRC/manifest via
    :func:`decode_envelope`, kind, sequence continuity).  Returns
    ``(kind, meta, arrays)`` — kind is FRAME_KIND or FINAL_KIND.  The
    terminal frame's fingerprint check is the CALLER's (it owns the ring
    fingerprint); everything frame-local is enforced here."""
    kind, meta, arrays = decode_envelope(buf)
    if kind not in (FRAME_KIND, FINAL_KIND):
        raise EnvelopeError(
            f"expected a streamed-handoff frame, got {kind!r}")
    if int(meta.get("seq", -1)) != int(expect_seq):
        raise EnvelopeError(
            f"handoff frame out of order: seq {meta.get('seq')} != "
            f"expected {expect_seq} — refusing the stream")
    if kind == FINAL_KIND:
        for req_key in ("first", "promptLen", "nBlocks", "nFrames",
                        "j0"):
            if req_key not in meta:
                raise EnvelopeError(
                    f"terminal handoff frame missing meta {req_key!r}")
        if int(meta["nFrames"]) != int(meta["seq"]) + 1:
            raise EnvelopeError(
                f"terminal frame count {meta['nFrames']} disagrees "
                f"with its own seq {meta['seq']} — refusing")
    else:
        if "j0" not in meta:
            raise EnvelopeError("handoff frame missing meta 'j0'")
        if "k" not in arrays or "v" not in arrays:
            raise EnvelopeError("handoff frame missing k/v arrays")
    return kind, meta, arrays


def encode_prefix(meta: Dict[str, Any],
                  chunks: Sequence[Sequence[int]],
                  block_idx: Sequence[int],
                  payloads: Sequence[Dict[str, Any]]) -> bytes:
    """Prefix blocks -> wire envelope.  ``chunks`` is EVERY full block's
    token chunk from the chain start (the importer recomputes parent
    chain keys from them), ``block_idx`` the subset of indices whose
    payloads travel."""
    m = dict(meta)
    m["chunks"] = [[int(t) for t in c] for c in chunks]
    m["blocks"] = [int(j) for j in block_idx]
    arrays: Dict[str, Any] = {}
    for j, payload in zip(block_idx, payloads):
        for name, a in payload.items():
            arrays[f"{name}{j}"] = a
    return encode_envelope("prefix", m, arrays)


def decode_prefix(buf: bytes) -> Tuple[Dict[str, Any], List[List[int]],
                                       List[int],
                                       List[Dict[str, torch.Tensor]]]:
    kind, meta, arrays = decode_envelope(buf)
    if kind != "prefix":
        raise EnvelopeError(f"expected a prefix envelope, got {kind!r}")
    chunks = [list(map(int, c)) for c in meta.get("chunks", ())]
    block_idx = [int(j) for j in meta.get("blocks", ())]
    payloads: List[Dict[str, torch.Tensor]] = []
    for j in block_idx:
        p = {name: arrays[f"{name}{j}"]
             for name in ("k", "v", "ks", "vs")
             if f"{name}{j}" in arrays}
        if "k" not in p or "v" not in p:
            raise EnvelopeError(f"prefix envelope block {j} missing "
                                "k/v payload")
        payloads.append(p)
    return meta, chunks, block_idx, payloads


# ---------------------------------------------------------------------------
# HTTP: the POST helpers and the shared bounded-retry loop
# ---------------------------------------------------------------------------


def _http_post_full(endpoint: str, path: str, body: bytes,
                    content_type: str = "application/octet-stream",
                    timeout: float = 10.0,
                    headers: Optional[Dict[str, str]] = None
                    ) -> Tuple[int, bytes, Dict[str, str]]:
    """One POST, returning (status, body, lowercased response headers)
    — the headers carry the server's ``Retry-After`` hint the retry
    wrapper honors."""
    host, _, port = endpoint.rpartition(":")
    conn = HTTPConnection(host, int(port), timeout=timeout)
    try:
        hdrs = {"Content-Type": content_type}
        if headers:
            hdrs.update(headers)
        conn.request("POST", path, body=body, headers=hdrs)
        resp = conn.getresponse()
        return (resp.status, resp.read(),
                {k.lower(): v for k, v in resp.getheaders()})
    finally:
        conn.close()


def http_post(endpoint: str, path: str, body: bytes,
              content_type: str = "application/octet-stream",
              timeout: float = 10.0,
              headers: Optional[Dict[str, str]] = None
              ) -> Tuple[int, bytes]:
    """One POST: ``(status, body)``."""
    code, raw, _ = _http_post_full(endpoint, path, body,
                                   content_type=content_type,
                                   timeout=timeout, headers=headers)
    return code, raw


def backoff_delay(attempt: int, *, base_s: float = 0.25,
                  max_s: float = 8.0,
                  retry_after: Optional[str] = None,
                  rng=None) -> float:
    """The jittered-backoff law every fleet retry loop shares:

    - exponential ``base_s * 2^attempt`` capped at ``max_s``;
    - a numeric ``Retry-After`` (the server's own hint) REPLACES the
      computed backoff for this attempt; HTTP-date forms keep the
      computed value;
    - multiplicative jitter in ``[0.5, 1.5)``, so clients shed by one
      draining pod do not re-dogpile its replacement in sync.

    ``rng`` is injectable for deterministic tests."""
    delay = min(max_s, base_s * (2 ** attempt))
    if retry_after is not None:
        try:
            delay = float(retry_after)
        except (TypeError, ValueError):
            pass
    r = rng if rng is not None else random
    return delay * (0.5 + r.random())


def http_post_retry(endpoints, path: str, body: bytes, *,
                    content_type: str = "application/octet-stream",
                    timeout: float = 10.0,
                    headers: Optional[Dict[str, str]] = None,
                    max_attempts: int = 4,
                    backoff_base_s: float = 0.25,
                    backoff_max_s: float = 8.0,
                    retry_statuses: Tuple[int, ...] = (503,),
                    honor_retry_after: bool = True,
                    rng=None, sleep: Callable[[float], None] = time.sleep,
                    on_conn_error: Optional[Callable[[str], None]] = None,
                    on_retry: Optional[Callable[[str, int], None]] = None,
                    abort: Optional[Callable[[], bool]] = None
                    ) -> Tuple[int, bytes, Optional[str]]:
    """Bounded-retry POST over :func:`http_post`, for wires that may
    retry freely (prefill is side-effect-free).

    Walks ``endpoints`` (a str, or a list cycled round-robin) for up to
    ``max_attempts``; connection errors and ``retry_statuses`` codes
    retry with :func:`backoff_delay` pacing (``Retry-After`` honored
    unless ``honor_retry_after=False``).  Any other status returns at
    once.  Hooks: ``on_conn_error(ep)``, ``on_retry(ep, attempt)``,
    ``abort()`` (stop early — the request resolved elsewhere).  Returns
    ``(status, body, endpoint)``; ``(0, b"", None)`` when no attempt got
    a response."""
    eps = [endpoints] if isinstance(endpoints, str) else \
        [e for e in endpoints if e]
    if not eps:
        return 0, b"", None
    last: Tuple[int, bytes, Optional[str]] = (0, b"", None)
    for attempt in range(max(1, int(max_attempts))):
        if abort is not None and abort():
            return last
        ep = eps[attempt % len(eps)]
        retry_after = None
        try:
            code, raw, rhdrs = _http_post_full(
                ep, path, body, content_type=content_type,
                timeout=timeout, headers=headers)
        except (OSError, socket.timeout):
            if on_conn_error is not None:
                on_conn_error(ep)
        else:
            if code not in retry_statuses:
                return code, raw, ep
            last = (code, raw, ep)
            if honor_retry_after:
                retry_after = rhdrs.get("retry-after")
        if attempt + 1 >= max_attempts:
            break
        if on_retry is not None:
            on_retry(ep, attempt)
        delay = backoff_delay(attempt, base_s=backoff_base_s,
                              max_s=backoff_max_s,
                              retry_after=retry_after, rng=rng)
        if delay > 0:
            sleep(delay)
    return last


class FleetKVClient:
    """The replica-side wire client of fleet-level KV.  ``broker`` (the
    fleet router's ``host:port``) is preferred — it picks the migration
    target from its scraped peer directory and dedupes replayed
    migrations; static ``peers`` (SERVE_KV_PEERS) are the router-less
    fallback, tried in order.  Every failure degrades to ``None``: the
    caller falls back to completion-wait or a cold prefill, never errors
    the request."""

    def __init__(self, broker: str = "", peers: Sequence[str] = (),
                 origin: str = "",
                 timeout: float = BROKER_TIMEOUT_S) -> None:
        self.broker = broker.strip().rstrip("/")
        self.peers = [p.strip() for p in peers if p.strip()]
        self.origin = origin
        self.timeout = timeout

    def _post(self, endpoint: str, path: str, body: bytes,
              content_type: str = "application/octet-stream"
              ) -> Tuple[int, bytes]:
        headers = ({"X-Migrate-Origin": self.origin}
                   if self.origin else None)
        return http_post(endpoint, path, body, content_type=content_type,
                         timeout=self.timeout, headers=headers)

    def migrate_out(self, envelope: bytes) -> Optional[str]:
        """Offer a lane envelope to the fleet; returns the adopting
        endpoint, or None (the lane stays local)."""
        if self.broker:
            try:
                code, body = self._post(self.broker, "/v1/kv/migrate",
                                        envelope)
                if code == 200:
                    return json.loads(body).get("target") or self.broker
            except (OSError, socket.timeout, ValueError):
                pass
            return None
        for peer in self.peers:
            if peer == self.origin:
                continue
            try:
                code, _ = self._post(peer, "/v1/kv/restore", envelope)
                if code == 200:
                    return peer
            except ConnectionRefusedError:
                continue            # never reached: the next peer is safe
            except (OSError, socket.timeout):
                # ambiguous — the peer may have adopted before the
                # socket died; offering the envelope again could run
                # one lane on two replicas.  Keep the lane local.
                return None
        return None

    def fetch_prefix(self, tokens: Sequence[int],
                     ns: int = 0) -> Optional[bytes]:
        """Ask the fleet for demoted blocks of this prompt's chain;
        returns a prefix envelope or None."""
        body = json.dumps({"tokens": [int(t) for t in tokens],
                           "ns": int(ns)}).encode()
        targets = ([self.broker] if self.broker else
                   [p for p in self.peers if p != self.origin])
        for ep in targets:
            try:
                code, raw = self._post(ep, "/v1/kv/prefix", body,
                                       content_type="application/json")
                if code == 200 and raw:
                    return raw
            except (OSError, socket.timeout):
                continue
        return None
