"""The fleet-KV wire envelope — own copy of the envelope part of
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
half-applies.  Lanes, prefixes, handoffs and the HTTP client come with
fleet-level KV (ROADMAP.md Queue A).
"""

from __future__ import annotations

import json
import struct
import zlib
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

MAGIC = b"TPKV"
VERSION = 1
_HDR = struct.Struct("<II")           # version, header_len

_BF16 = "bfloat16"


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
