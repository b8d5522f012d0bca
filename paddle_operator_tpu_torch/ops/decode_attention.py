"""Single-query (decode) attention over the KV cache — the port of
``paddle_operator_tpu/ops/decode_attention.py`` ``decode_attention``
and ``paged_decode_attention`` (bf16 pool, and the int8 pool of
SERVE_KV_QUANT=int8).

Per kernel, three parts:

- the wrapper (:func:`decode_attention` over the contiguous cache,
  :func:`paged_decode_attention` over the paged block pool, which takes
  the int8 pool's kernel when given its scales and tails).  On CUDA
  tensors it launches the hand-written kernel of
  ``csrc/decode_attention.cu`` (built for sm_90a at first use, bound
  through ``ctypes``) on the current stream; on CPU tensors it uses the
  plain version.  There is no fallback: a CUDA tensor the kernel does
  not take, a failed build or a failed launch raises.
- the plain PyTorch version (:func:`decode_attention_reference`, the
  JAX package's einsum ground truth; :func:`paged_decode_attention_
  reference`, the gathered lane view followed by it;
  :func:`paged_decode_attention_quant_reference`, the dequantizing lane
  view followed by it).
- a ``launches`` counter on each wrapper: how many times it launched
  its kernel, so a run can show that its main path went through it.

The kernels read only the filled prefix ``[0, lengths[b])`` of each
lane; see the note at the head of the CUDA source for what bounds them
and what their design does about that.  All three kernels split a
lane's rows into chunks, one thread block each, and a lane's last chunk
to finish merges the chunks' partials: the contiguous kernel into
chunks of :data:`CHUNK_ROWS` key rows of the cache, the paged kernels
into chunks of the block table's reach (:func:`paged_chunk_rows`), whose
tiles they stage through shared memory.  The partials and the merge
tickets come from torch's allocator and are kept on each device, one
scratch for all three (:func:`chunk_scratch`).  The TPU kernels'
block-size knob is gone with their grid: the contiguous kernel takes
any cache length ``S``, the paged ones any pool block size.

Also here: :func:`scatter_prefill_blocks` and
:func:`scatter_prefill_blocks_quant`, the block-granular prefill writes
into the pool (plain tensor writes — they were XLA loops, not Pallas
kernels, in the JAX package).
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch

NEG_INF = -1e30
# the JAX package's pallas key block; kept as the KV-cache allocation
# granule (infer/decode.py cache_alloc_len) so caches keep its layout
DEFAULT_BLOCK_K = 256
MAX_HEAD_DIM = 256
# key rows a block of a split kernel takes (csrc/decode_attention.cu):
# the contiguous kernel's chunk of the cache, and the paged kernels'
# chunk of the table's reach where the pool block size allows it
CHUNK_ROWS = 256

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None
# the split's scratch per device, shared by the three kernels: (f32
# partials, int32 merge tickets); see chunk_scratch.  Replaced buffers
# stay referenced: a CUDA graph captured earlier still holds their
# addresses.
_SCRATCH: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}
_RETIRED: List[Tuple[torch.Tensor, torch.Tensor]] = []


def _library():
    """The kernel library with its C signature declared (built at first
    use; ops/_build.py)."""
    global _lib
    if _lib is None:
        from paddle_operator_tpu_torch.ops import _build

        lib = _build.load("decode_attention")
        fn = lib.decode_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn = lib.paged_decode_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fn = lib.paged_decode_attention_quant_launch
        fn.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 9
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_kernel_inputs(q, k_cache, v_cache, lengths, *, table=None,
                         quant=None, fn: str = "decode_attention") -> None:
    """Everything the CUDA kernels do not take raises here.  ``quant``:
    the int8 pool's (k_scale, v_scale, k_tail, v_tail)."""
    b, hq, d = q.shape
    named = [("q", q), ("k", k_cache), ("v", v_cache), ("lengths", lengths)]
    if table is not None:
        named.append(("block_table", table))
    if quant is not None:
        named += list(zip(("k_scale", "v_scale", "k_tail", "v_tail"), quant))
    for name, t in named:
        if t.device != q.device:
            raise ValueError(f"{fn}: {name} on {t.device}, q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: the kernel runs on CUDA tensors only "
                         f"(got {q.device})")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{fn}: dtype {q.dtype} not supported (float32 "
                         "or bfloat16)")
    if quant is None:
        if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
            raise ValueError(f"{fn}: q, k and v must share one dtype")
    else:
        if k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8:
            raise ValueError(f"{fn}: the quantized pools must be int8")
        if quant[0].dtype != torch.float32 or quant[1].dtype != torch.float32:
            raise ValueError(f"{fn}: k_scale and v_scale must be float32")
        if quant[2].dtype != q.dtype or quant[3].dtype != q.dtype:
            raise ValueError(f"{fn}: k_tail and v_tail must be in q's "
                             f"dtype {q.dtype}")
    if lengths.dtype != torch.int32:
        raise ValueError(f"{fn}: lengths must be int32")
    if table is not None and table.dtype != torch.int32:
        raise ValueError(f"{fn}: block_table must be int32")
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"{fn}: head_dim {d} must be a multiple of 8 up "
                         f"to {MAX_HEAD_DIM}")
    if b > 65535:
        raise ValueError(f"{fn}: batch {b} > 65535")
    aligned = [("q", q), ("k", k_cache), ("v", v_cache)]
    if quant is not None:
        aligned += [("k_tail", quant[2]), ("v_tail", quant[3])]
    for name, t in aligned:
        if t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} is not 16-byte aligned")


def split_chunks(s: int, chunk_rows: int = CHUNK_ROWS) -> int:
    """How many chunks of ``chunk_rows`` key rows the contiguous kernel
    splits a cache of capacity ``s`` into: the grid's chunk dimension,
    fixed by the cache's shape alone (never by the lengths, which live
    on the device)."""
    return max(1, -(-s // chunk_rows))


def split_scratch(device: torch.device, b: int, hq: int, d: int, s: int,
                  chunk_rows: int = CHUNK_ROWS
                  ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The split's scratch on ``device`` for a call of the contiguous
    kernel over B lanes, Hq query heads, head_dim D and a cache of
    capacity S: (partials, tickets), or (None, None) when the cache fits
    one chunk (no partials, no merge).  See :func:`chunk_scratch`."""
    return chunk_scratch(device, b, hq, d, split_chunks(s, chunk_rows))


def chunk_scratch(device: torch.device, b: int, hq: int, d: int,
                  chunks: int
                  ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """The scratch of a split launch of ``chunks`` chunks over B lanes,
    Hq query heads and head_dim D: (partials, tickets), or (None, None)
    for one chunk.

    partials: f32, at least B * Hq * chunks * (D + 2) elements — per
    (lane, query head, chunk) the accumulator [D], the row max and the
    row sum.  tickets: int32, at least B * Hq — one merge counter per
    (lane, head group), which the lane's last chunk to finish takes and
    resets to 0, so the buffer is zero between launches.  One pair per
    device serves all three kernels: taken from torch's allocator at
    first use (tickets zeroed), kept for later calls, and replaced by a
    larger one (each buffer the larger of the old size and the call's
    need) when a call needs more: no allocation per call.  A call under
    CUDA-graph capture that needs more raises: the first call outside
    capture sizes it from the shapes alone (the cache's capacity, or the
    table's width and the pool's block size).  Launches that overlap on
    two streams of one device would share it; the port runs its decode
    attention on one stream."""
    if chunks == 1:
        return None, None
    need, need_tickets = b * hq * chunks * (d + 2), b * hq
    got = _SCRATCH.get(device)
    if got is None or got[0].numel() < need \
            or got[1].numel() < need_tickets:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError("decode attention: the split's scratch must "
                               "be allocated by a call outside CUDA-graph "
                               "capture first")
        if got is not None:
            _RETIRED.append(got)
            need = max(need, got[0].numel())
            need_tickets = max(need_tickets, got[1].numel())
        got = (torch.empty(need, dtype=torch.float32, device=device),
               torch.zeros(need_tickets, dtype=torch.int32, device=device))
        _SCRATCH[device] = got
    return got


def _launch(lib, q, k_cache, v_cache, lengths, out, scale: float,
            stream: int, chunk_rows: int = CHUNK_ROWS) -> None:
    """One kernel launch; raises when the C side reports an error."""
    b, hq, d = q.shape
    _, hkv, s, _ = k_cache.shape
    ws, tickets = split_scratch(q.device, b, hq, d, s, chunk_rows)
    rc = lib.decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(),
        None if tickets is None else tickets.data_ptr(), b, hq, hkv, s, d,
        chunk_rows, float(scale), _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"decode_attention kernel launch failed: CUDA "
                           f"error {rc}")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     scale: Optional[float] = None,
                     layer: Optional[int] = None) -> torch.Tensor:
    """One query per head against the filled prefix of the KV cache.

    q: [B, Hq, D]; k_cache/v_cache: [B, Hkv, S, D] (head-major, the
    decode cache layout); lengths: [B] int32 — lane b attends cache
    cols [0, lengths[b]).  Returns [B, Hq, D] in q's dtype.  Hq must
    be a multiple of Hkv (GQA).

    ``layer``: when given, the caches are the full stacked
    [L, B, Hkv, S, D] buffers and layer ``layer`` is read.  In torch
    ``k_cache[layer]`` is a free contiguous view, so this only selects
    that view (the TPU kernel needed an index map to avoid a copy)."""
    if layer is not None:
        k_cache, v_cache = k_cache[layer], v_cache[layer]
    b, hq, d = q.shape
    if k_cache.dim() != 4 or k_cache.shape != v_cache.shape \
            or k_cache.shape[0] != b or k_cache.shape[3] != d:
        raise ValueError(f"decode_attention: caches {tuple(k_cache.shape)}"
                         f"/{tuple(v_cache.shape)} do not match q "
                         f"{tuple(q.shape)} as [B, Hkv, S, D]")
    hkv = k_cache.shape[1]
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    if lengths.shape != (b,):
        raise ValueError(f"decode_attention: lengths {tuple(lengths.shape)}"
                         f" must be [{b}]")
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    if q.device.type == "cpu":
        return decode_attention_reference(q, k_cache, v_cache, lengths,
                                          scale=scale)
    _check_kernel_inputs(q, k_cache, v_cache, lengths)
    out = torch.empty_like(q)
    if b == 0:
        return out
    _launch(_library(), q, k_cache, v_cache, lengths, out, scale,
            torch.cuda.current_stream(q.device).cuda_stream)
    decode_attention.launches += 1
    return out


decode_attention.launches = 0


def decode_attention_reference(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, lengths: torch.Tensor,
                               *, scale: Optional[float] = None
                               ) -> torch.Tensor:
    """The plain version: einsums over the WHOLE cache with a fill mask
    (the decode._layer math, lifted out).  Scores and softmax in f32;
    probabilities cast to q's dtype for the value product, accumulated
    in f32 — the JAX reference's ``preferred_element_type`` rule."""
    b, hq, d = q.shape
    _, hkv, s, _ = k_cache.shape
    n_rep = hq // hkv
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    qg = q.reshape(b, hkv, n_rep, d)
    scores = torch.einsum("bhrd,bhsd->bhrs", qg.float(),
                          k_cache.float()) * scale
    mask = (torch.arange(s, device=q.device)[None, :]
            < lengths[:, None])                               # [B, S]
    scores = scores.masked_fill(~mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    # fully-masked lanes (length 0): emit zeros like the kernel
    probs = torch.where(mask[:, None, None, :], probs, 0.0)
    out = torch.einsum("bhrs,bhsd->bhrd", probs.to(q.dtype).float(),
                       v_cache.float())
    return out.reshape(b, hq, d).to(q.dtype)


# ---------------------------------------------------------------------------
# Paged block pool
# ---------------------------------------------------------------------------


def paged_chunk_rows(bs: int) -> int:
    """The rows a block of a paged kernel takes at pool block size
    ``bs``: :data:`CHUNK_ROWS` when it divides ``bs``, else the largest
    multiple of ``bs`` up to it (``bs`` itself when ``bs`` is larger), so
    that no staged tile crosses a pool block."""
    return CHUNK_ROWS if bs % CHUNK_ROWS == 0 else \
        bs * max(1, CHUNK_ROWS // bs)


def paged_split_chunks(m: int, bs: int,
                       chunk_rows: Optional[int] = None) -> int:
    """How many chunks a paged kernel splits a lane's table of ``m``
    blocks of ``bs`` rows into: the grid's chunk dimension, from host
    shapes alone.  ``chunk_rows`` (default :func:`paged_chunk_rows`)
    must divide ``bs`` or be a multiple of it."""
    rows = paged_chunk_rows(bs) if chunk_rows is None else chunk_rows
    if rows <= 0 or (rows % bs and bs % rows):
        raise ValueError(f"paged_decode_attention: chunk rows {rows} "
                         f"neither divide the block size {bs} nor are a "
                         f"multiple of it")
    return max(1, -(-(m * bs) // rows))


def _paged_launch(lib, q, k_pool, v_pool, table, lengths, out, scale: float,
                  stream: int, chunk_rows: Optional[int] = None) -> None:
    """One paged-kernel launch; raises when the C side reports an
    error."""
    b, hq, d = q.shape
    n, hkv, bs, _ = k_pool.shape
    m = table.shape[1]
    rows = paged_chunk_rows(bs) if chunk_rows is None else chunk_rows
    ws, tickets = chunk_scratch(q.device, b, hq, d,
                                paged_split_chunks(m, bs, rows))
    rc = lib.paged_decode_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if ws is None else ws.data_ptr(),
        None if tickets is None else tickets.data_ptr(), b, hq, hkv, n, bs,
        m, d, rows, float(scale), _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed: "
                           f"CUDA error {rc}")


def _paged_quant_launch(lib, q, k_pool, v_pool, k_scale, v_scale, k_tail,
                        v_tail, table, lengths, out, scale: float,
                        stream: int, chunk_rows: Optional[int] = None
                        ) -> None:
    """One launch of the int8 pool's kernel; raises when the C side
    reports an error."""
    b, hq, d = q.shape
    n, hkv, bs, _ = k_pool.shape
    m = table.shape[1]
    rows = paged_chunk_rows(bs) if chunk_rows is None else chunk_rows
    ws, tickets = chunk_scratch(q.device, b, hq, d,
                                paged_split_chunks(m, bs, rows))
    rc = lib.paged_decode_attention_quant_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), k_tail.data_ptr(),
        v_tail.data_ptr(), table.data_ptr(), lengths.data_ptr(),
        out.data_ptr(), None if ws is None else ws.data_ptr(),
        None if tickets is None else tickets.data_ptr(), b, hq, hkv, n, bs,
        m, d, k_tail.shape[0], rows, float(scale),
        _DTYPE_CODE[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention (int8 pool) kernel "
                           f"launch failed: CUDA error {rc}")


def paged_decode_attention(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_table: torch.Tensor,
                           lengths: torch.Tensor, *,
                           scale: Optional[float] = None,
                           layer: Optional[int] = None,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None,
                           k_tail: Optional[torch.Tensor] = None,
                           v_tail: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """:func:`decode_attention` over a PAGED cache: lane b's context
    lives in pool blocks ``block_table[b, 0..ceil(len_b/bs)-1]``.

    q: [B, Hq, D]; k_pool/v_pool: [N, Hkv, bs, D] (or stacked
    [L, N, Hkv, bs, D] with ``layer``, the pool layout of the paged
    ring — ``k_pool[layer]`` is a free contiguous view); block_table:
    [B, M] int32 pool ids (lane-local block j of lane b is pool block
    ``block_table[b, j]``; entries past the lane's fill are never
    read); lengths: [B] int32 — lane b attends logical positions
    [0, lengths[b]), capped at M * bs.  Returns [B, Hq, D] in q's
    dtype.

    ``k_scale``/``v_scale``/``k_tail``/``v_tail`` (all four together)
    select the int8 pool (SERVE_KV_QUANT=int8, infer/paged.py): the
    pools hold int8 codes, the scales are f32 [N, Hkv] (one per block
    and kv head), the tails the per-lane staging blocks
    [lanes + 1, Hkv, bs, D] in q's dtype (stacked with a leading L
    under ``layer``).  Lane b's row r reads, in block j = r // bs: the
    tail row ``tail[b, :, r % bs]`` when j is the lane's write-frontier
    block ``max(lengths[b] - 1, 0) // bs``, else ``code * scale`` of its
    pool block, computed in f32 and rounded to q's dtype.  On a CUDA
    tensor that launches the int8 pool's kernel (a separate ``launches``
    count: :attr:`paged_decode_attention.quant_launches`)."""
    quant = (k_scale, v_scale, k_tail, v_tail)
    if any(t is not None for t in quant):
        if any(t is None for t in quant):
            raise ValueError("quantized paged attention needs k_scale, "
                             "v_scale, k_tail and v_tail together")
    else:
        quant = None
    if layer is not None:
        k_pool, v_pool = k_pool[layer], v_pool[layer]
        if quant is not None:
            quant = tuple(t[layer] for t in quant)
    b, hq, d = q.shape
    if k_pool.dim() != 4 or k_pool.shape != v_pool.shape \
            or k_pool.shape[3] != d:
        raise ValueError(f"paged_decode_attention: pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)} do "
                         f"not match q {tuple(q.shape)} as [N, Hkv, bs, D]")
    n, hkv, bs, _ = k_pool.shape
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    if block_table.dim() != 2 or block_table.shape[0] != b \
            or block_table.shape[1] < 1:
        raise ValueError(f"paged_decode_attention: block_table "
                         f"{tuple(block_table.shape)} must be [{b}, M>=1]")
    if lengths.shape != (b,):
        raise ValueError(f"paged_decode_attention: lengths "
                         f"{tuple(lengths.shape)} must be [{b}]")
    if quant is not None:
        ks, vs, kt, vt = quant
        if ks.shape != (n, hkv) or vs.shape != (n, hkv):
            raise ValueError(f"paged_decode_attention: scales "
                             f"{tuple(ks.shape)}/{tuple(vs.shape)} must be "
                             f"[N, Hkv] = [{n}, {hkv}]")
        if kt.dim() != 4 or kt.shape != vt.shape or kt.shape[0] < b \
                or kt.shape[1:] != (hkv, bs, d):
            raise ValueError(f"paged_decode_attention: tails "
                             f"{tuple(kt.shape)}/{tuple(vt.shape)} must be "
                             f"[>= {b}, {hkv}, {bs}, {d}]")
    if scale is None:
        scale = 1.0 / float(d) ** 0.5
    if q.device.type == "cpu":
        if quant is not None:
            return paged_decode_attention_quant_reference(
                q, k_pool, v_pool, block_table, lengths, *quant,
                scale=scale)
        return paged_decode_attention_reference(
            q, k_pool, v_pool, block_table, lengths, scale=scale)
    _check_kernel_inputs(q, k_pool, v_pool, lengths, table=block_table,
                         quant=quant, fn="paged_decode_attention")
    out = torch.empty_like(q)
    if b == 0:
        return out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if quant is not None:
        _paged_quant_launch(_library(), q, k_pool, v_pool, *quant,
                            block_table, lengths, out, scale, stream)
        paged_decode_attention.quant_launches += 1
        return out
    _paged_launch(_library(), q, k_pool, v_pool, block_table, lengths, out,
                  scale, stream)
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention.quant_launches = 0


def gather_lane_view(pool: torch.Tensor,
                     block_table: torch.Tensor) -> torch.Tensor:
    """One layer's pool [N, H, bs, D] gathered through the block tables
    [B, M] into the contiguous [B, H, M*bs, D] layout the plain
    attention reads — a materialized copy, exactly what the paged
    kernel's table walk avoids."""
    b, m = block_table.shape
    _, h, bs, d = pool.shape
    v = pool[block_table.long()]                    # [B, M, H, bs, D]
    return v.permute(0, 2, 1, 3, 4).reshape(b, h, m * bs, d)


def paged_decode_attention_reference(q: torch.Tensor, k_pool: torch.Tensor,
                                     v_pool: torch.Tensor,
                                     block_table: torch.Tensor,
                                     lengths: torch.Tensor, *,
                                     scale: Optional[float] = None
                                     ) -> torch.Tensor:
    """The plain version: the gathered lane view (infer/paged.py
    ``_gather_lane_view`` of the JAX package) followed by
    :func:`decode_attention_reference`."""
    return decode_attention_reference(
        q, gather_lane_view(k_pool, block_table),
        gather_lane_view(v_pool, block_table), lengths, scale=scale)


def gather_lane_view_quant(pool: torch.Tensor, scales: torch.Tensor,
                           tail: torch.Tensor, block_table: torch.Tensor,
                           wb: torch.Tensor) -> torch.Tensor:
    """:func:`gather_lane_view` for the int8 pool (infer/paged.py
    ``_gather_lane_view_quant`` of the JAX package): codes [N, H, bs, D]
    and scales [N, H] gathered through the tables and dequantized in
    f32, then lane b's staging tail ``tail[b]`` substituted for its
    write-frontier block ``wb[b]``; returned in the tail's dtype,
    [B, H, M*bs, D]."""
    b, m = block_table.shape
    _, h, bs, d = pool.shape
    ids = block_table.long()
    deq = pool[ids].float() * scales[ids][..., None, None]  # [B,M,H,bs,D]
    deq = deq.permute(0, 2, 1, 3, 4).reshape(b, h, m * bs, d)
    tiled = tail[:b].float().repeat(1, 1, m, 1)              # [B,H,M*bs,D]
    use_tail = (torch.arange(m * bs, device=pool.device) // bs)[None, :] \
        == wb.long()[:, None]
    return torch.where(use_tail[:, None, :, None], tiled,
                       deq).to(tail.dtype)


def paged_decode_attention_quant_reference(
        q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
        block_table: torch.Tensor, lengths: torch.Tensor,
        k_scale: torch.Tensor, v_scale: torch.Tensor, k_tail: torch.Tensor,
        v_tail: torch.Tensor, *, scale: Optional[float] = None
        ) -> torch.Tensor:
    """The int8 pool kernel's plain version: the dequantizing lane view
    (:func:`gather_lane_view_quant`, frontier block
    ``max(lengths - 1, 0) // bs``) followed by
    :func:`decode_attention_reference` — as tests/test_kvquant.py builds
    the JAX kernel's reference."""
    bs = k_pool.shape[2]
    wb = torch.clamp(lengths.long() - 1, min=0) // bs
    return decode_attention_reference(
        q, gather_lane_view_quant(k_pool, k_scale, k_tail, block_table, wb),
        gather_lane_view_quant(v_pool, v_scale, v_tail, block_table, wb),
        lengths, scale=scale)


def scatter_prefill_blocks(pool: torch.Tensor, rows: torch.Tensor,
                           table_row: torch.Tensor, block_size: int,
                           start_block: int = 0) -> torch.Tensor:
    """The prefill-WRITE path against the block pool: place a
    contiguous slab of prefilled KV rows ``[L, 1, H, T, D]`` (T a
    multiple of ``block_size``) into ``pool`` [L, N, H, bs, D] as
    WHOLE-block writes at the lane's table entries, starting at
    lane-local block ``start_block``.  In place (one indexed write for
    all layers and blocks, where the JAX function chained
    dynamic_update_slice copies); returns ``pool``.  Pad rows past the
    real prompt land in the lane's own last block, where decode
    overwrites them before they become attendable."""
    lcount, _, h, t, d = rows.shape
    if t % block_size:
        raise ValueError(f"scatter_prefill_blocks: {t} rows are not a "
                         f"multiple of the block size {block_size}")
    nb = t // block_size
    blocks = rows[:, 0].reshape(lcount, h, nb, block_size, d)
    ids = table_row[start_block:start_block + nb].to(pool.device).long()
    pool[:, ids] = blocks.permute(0, 2, 1, 3, 4).to(pool.dtype)
    return pool


def scatter_prefill_blocks_quant(pool: torch.Tensor, scales: torch.Tensor,
                                 rows: torch.Tensor, table_row: torch.Tensor,
                                 block_size: int, start_block: int = 0
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`scatter_prefill_blocks` for the int8 pool: each whole block
    of ``rows`` [L, 1, H, T, D] quantizes once on the way in (one
    absmax scale per (layer, block, kv head), infer/paged.py
    ``quantize_kv``), codes into ``pool`` [L, N, H, bs, D] and scales
    into ``scales`` [L, N, H] at the lane's table entries, in place.
    The prompt's partial last block is scattered too (its pad rows make
    its scale meaningless) but is never read from the pool: the lane's
    staging tail serves its write-frontier block until decode completes
    it.  Returns ``(pool, scales)``."""
    from paddle_operator_tpu_torch.infer.paged import quantize_kv

    lcount, _, h, t, d = rows.shape
    if t % block_size:
        raise ValueError(f"scatter_prefill_blocks_quant: {t} rows are not "
                         f"a multiple of the block size {block_size}")
    nb = t // block_size
    blocks = rows[:, 0].reshape(lcount, h, nb, block_size, d)
    codes, scale = quantize_kv(blocks.permute(0, 2, 1, 3, 4))
    ids = table_row[start_block:start_block + nb].to(pool.device).long()
    pool[:, ids] = codes
    scales[:, ids] = scale
    return pool, scales


def scatter_promote_blocks_quant(pool: torch.Tensor, scales: torch.Tensor,
                                 rows: torch.Tensor, scale_rows: torch.Tensor,
                                 table_row: torch.Tensor, block_size: int
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`scatter_prefill_blocks` for already-quantized blocks coming
    back from the host (a spilled lane's restore): the int8 codes
    ``rows`` [L, 1, H, T, D] (T a multiple of ``block_size``) and their
    per-block scale rows ``scale_rows`` [L, T // bs, H] are copied
    VERBATIM into ``pool`` [L, N, H, bs, D] and ``scales`` [L, N, H] at
    the table entries ``table_row[:T // bs]``, in place.  Nothing is
    quantized on the way in: a block's scale was computed once, when the
    block completed, and a promote is a byte copy of it.  Returns
    ``(pool, scales)``."""
    lcount, _, h, t, d = rows.shape
    if t % block_size:
        raise ValueError(f"scatter_promote_blocks_quant: {t} rows are not "
                         f"a multiple of the block size {block_size}")
    nb = t // block_size
    blocks = rows[:, 0].reshape(lcount, h, nb, block_size, d)
    ids = table_row[:nb].to(pool.device).long()
    pool[:, ids] = blocks.permute(0, 2, 1, 3, 4)
    scales[:, ids] = scale_rows.to(scales.device, scales.dtype)
    return pool, scales
