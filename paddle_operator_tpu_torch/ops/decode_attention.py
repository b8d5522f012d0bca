"""Single-query (decode) attention over the KV cache — the port of
``paddle_operator_tpu/ops/decode_attention.py`` ``decode_attention``.

Three parts:

- :func:`decode_attention`, the kernel wrapper.  On CUDA tensors it
  launches the hand-written kernel of ``csrc/decode_attention.cu``
  (built for sm_90a at first use, bound through ``ctypes``) on the
  current stream; on CPU tensors it uses the plain version.  There is
  no fallback: a CUDA tensor the kernel does not take, a failed build
  or a failed launch raises.
- :func:`decode_attention_reference`, the plain PyTorch version (the
  JAX package's einsum ground truth, lifted out of ``decode._layer``).
- ``decode_attention.launches``: how many times the wrapper launched
  the kernel, so a run can show that its main path went through it.

The kernel reads only the filled prefix ``[0, lengths[b])`` of each
lane's cache; see the note at the head of the CUDA source for what
bounds it and what its design does about that.  The TPU kernel's
block-size knob is gone with its grid: the CUDA kernel takes any cache
length ``S``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

NEG_INF = -1e30
# the JAX package's pallas key block; kept as the KV-cache allocation
# granule (infer/decode.py cache_alloc_len) so caches keep its layout
DEFAULT_BLOCK_K = 256
MAX_HEAD_DIM = 256

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _library():
    """The kernel library with its C signature declared (built at first
    use; ops/_build.py)."""
    global _lib
    if _lib is None:
        from paddle_operator_tpu_torch.ops import _build

        lib = _build.load("decode_attention")
        fn = lib.decode_attention_launch
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_kernel_inputs(q, k_cache, v_cache, lengths) -> None:
    """Everything the CUDA kernel does not take raises here."""
    b, hq, d = q.shape
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
                    ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"decode_attention: {name} on {t.device}, "
                             f"q on {q.device}")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be "
                             "contiguous")
    if q.device.type != "cuda":
        raise ValueError("decode_attention: the kernel runs on CUDA "
                         f"tensors only (got {q.device})")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"decode_attention: dtype {q.dtype} not "
                         "supported (float32 or bfloat16)")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise ValueError("decode_attention: q, k_cache and v_cache must "
                         "share one dtype")
    if lengths.dtype != torch.int32:
        raise ValueError("decode_attention: lengths must be int32")
    if d % 8 or d > MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: head_dim {d} must be a "
                         f"multiple of 8 up to {MAX_HEAD_DIM}")
    if b > 65535:
        raise ValueError(f"decode_attention: batch {b} > 65535")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} is not 16-byte "
                             "aligned")


def _launch(lib, q, k_cache, v_cache, lengths, out, scale: float,
            stream: int) -> None:
    """One kernel launch; raises when the C side reports an error."""
    b, hq, d = q.shape
    _, hkv, s, _ = k_cache.shape
    rc = lib.decode_attention_launch(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), b, hq, hkv, s, d,
        float(scale), _DTYPE_CODE[q.dtype], stream)
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
