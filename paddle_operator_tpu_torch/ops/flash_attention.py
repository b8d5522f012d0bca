"""Flash attention, forward and backward — the port of
``paddle_operator_tpu/ops/pallas_attention.py`` (``_fwd_kernel``,
``_bwd_dkv_kernel``, ``_bwd_dq_kernel`` and the ``custom_vjp`` pairs
``_flash``/``_flash_seg`` around them).

Per kernel, three parts:

- the wrapper (:func:`flash_forward`, :func:`flash_backward_dkv`,
  :func:`flash_backward_dq`).  On CUDA tensors it launches its
  hand-written kernel of ``csrc/flash_attention.cu`` (built for sm_90a
  at first use, bound through ``ctypes``) on the current stream; on CPU
  tensors it uses the plain version.  There is no fallback: a CUDA
  tensor the kernel does not take, a failed build or a failed launch
  raises.
- the plain PyTorch version (:func:`flash_forward_reference`,
  :func:`flash_backward_dkv_reference`,
  :func:`flash_backward_dq_reference`): the formulas of the TPU kernel
  bodies written out as dense tensor ops, with the same casts (scores
  in f32 from storage-dtype inputs; p cast to V's dtype before P.V, ds
  to the input dtype before the dK/dQ products; NEG_INF = -1e30; a row
  with no unmasked key gives o = 0 and lse = 0).
- a ``launches`` counter on each wrapper.

:func:`flash_attention` is the public ``[B, S, H, D]`` entry: a
``torch.autograd.Function`` whose forward runs the forward kernel and
saves (q, k, v, o, lse), and whose backward computes
``delta = rowsum(dO * O)`` in f32 (plain torch, as the JAX package
computes it in XLA) and runs the dK/dV and dQ kernels.  Layout: the
kernels read ``[B, S, H, D]`` directly (the TPU kernels' ``[B, H, S, D]``
transposes are gone); lse and delta are ``[B, H, S]`` f32.  GQA: query
head h reads kv head ``h // n_rep``, and dK/dV sum over the n_rep query
heads of each kv head.

Unlike the TPU wrapper, any S is taken (the ragged last tile is masked
in the kernels) and there is no block-size knob; head_dim must be 64,
128 or 256.

The kernels are bound by their products (hundreds of flops per byte at
the training shapes).  The three bf16 kernels at head_dim 64 and 128
(every preset of the port) run the Hopper design of
``csrc/flash_attention.cu``: a block of two warpgroups owns 128 rows,
every product is a ``wgmma`` whose accumulator stays in registers (the
scores, p and ds are formed there and fed to the next product as its
register operand), and one thread's TMA loads fill a 2-stage ring of
shared-memory tiles while the current tile is computed.  float32 (whose
products ``wgmma`` would round to TF32) and bf16 at head_dim 256 keep
the earlier design: intermediates in shared memory, WMMA
fragments (bf16) or FMAs (float32), synchronous loads.  The choice is
made by dtype and head_dim at compile time; there is no switch.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None


def _library():
    """The kernel library with its C signatures declared (built at first
    use; ops/_build.py)."""
    global _lib
    if _lib is None:
        from paddle_operator_tpu_torch.ops import _build

        lib = _build.load("flash_attention")
        tail = [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int,
                                     ctypes.c_void_p]
        for name, pointers in (("flash_fwd_launch", 7),
                               ("flash_bwd_dkv_launch", 10),
                               ("flash_bwd_dq_launch", 9)):
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * pointers + tail
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _shapes(fn: str, q, k, v, seg_q, seg_k) -> Tuple[int, ...]:
    """(B, Sq, Sk, Hq, Hkv, D) of [B, S, H, D] operands; raises on
    operands that do not fit together."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"{fn}: q {tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)} are not [B, S, H, D] with one "
                         "B and D")
    b, sq, hq, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    if hkv == 0 or hq % hkv:
        raise ValueError(f"{fn}: Hq={hq} not a multiple of Hkv={hkv}")
    if (seg_q is None) != (seg_k is None):
        raise ValueError(f"{fn}: give both segment-id tensors or neither")
    if seg_q is not None and (tuple(seg_q.shape) != (b, sq)
                              or tuple(seg_k.shape) != (b, sk)):
        raise ValueError(f"{fn}: segment ids {tuple(seg_q.shape)}/"
                         f"{tuple(seg_k.shape)} must be [{b}, {sq}]/"
                         f"[{b}, {sk}]")
    return b, sq, sk, hq, hkv, d


def _check_kernel_inputs(fn: str, q, data, f32=(), seg=()) -> None:
    """Everything the CUDA kernels do not take raises here.  ``data``:
    (name, tensor) in q's dtype; ``f32``: per-row f32 tensors; ``seg``:
    int32 segment ids."""
    if q.device.type != "cuda":
        raise ValueError(f"{fn}: the kernel runs on CUDA tensors only "
                         f"(got {q.device})")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"{fn}: dtype {q.dtype} not supported (float32 "
                         "or bfloat16)")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"{fn}: head_dim {q.shape[3]} not in {HEAD_DIMS}")
    if q.shape[0] > 65535 or q.shape[2] > 65535:
        raise ValueError(f"{fn}: batch or heads > 65535")
    for group, want in ((data, q.dtype), (f32, torch.float32),
                        (seg, torch.int32)):
        for name, t in group:
            if t.device != q.device:
                raise ValueError(f"{fn}: {name} on {t.device}, q on "
                                 f"{q.device}")
            if t.dtype != want:
                raise ValueError(f"{fn}: {name} must be {want} (got "
                                 f"{t.dtype})")
            if not t.is_contiguous():
                raise ValueError(f"{fn}: {name} must be contiguous")
    for name, t in data:
        if t.data_ptr() % 16:
            raise ValueError(f"{fn}: {name} is not 16-byte aligned")


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _launch(lib, entry: str, fn: str, *args) -> None:
    """One kernel launch through C entry ``entry``; raises when the C
    side reports an error."""
    rc = getattr(lib, entry)(*args)
    if rc != 0:
        raise RuntimeError(f"{fn} kernel launch failed: CUDA error {rc}")


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------


def flash_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  seg_q: Optional[torch.Tensor] = None,
                  seg_k: Optional[torch.Tensor] = None, *,
                  causal: bool = True
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel #4, the flash forward.  q [B, Sq, Hq, D]; k, v
    [B, Sk, Hkv, D]; seg_q [B, Sq] and seg_k [B, Sk] int32 (both or
    neither).  Returns (o like q, lse [B, Hq, Sq] f32)."""
    b, sq, sk, hq, hkv, d = _shapes("flash_forward", q, k, v, seg_q, seg_k)
    if q.device.type == "cpu":
        return flash_forward_reference(q, k, v, seg_q, causal=causal,
                                       seg_k=seg_k)
    _check_kernel_inputs("flash_forward", q,
                         [("q", q), ("k", k), ("v", v)],
                         seg=[("seg_q", seg_q), ("seg_k", seg_k)]
                         if seg_q is not None else ())
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    if b == 0 or sq == 0:
        return o, lse
    _launch(_library(), "flash_fwd_launch", "flash_forward",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(seg_q),
            _ptr(seg_k), o.data_ptr(), lse.data_ptr(), b, sq, sk, hq, hkv, d,
            int(causal), d ** -0.5, _DTYPE_CODE[q.dtype], _stream(q))
    flash_forward.launches += 1
    return o, lse


flash_forward.launches = 0


def _check_backward(fn, q, k, v, do, lse, delta, seg_q, seg_k):
    b, sq, sk, hq, hkv, d = _shapes(fn, q, k, v, seg_q, seg_k)
    if do.shape != q.shape or tuple(lse.shape) != (b, hq, sq) \
            or tuple(delta.shape) != (b, hq, sq):
        raise ValueError(f"{fn}: do {tuple(do.shape)} must be like q, lse "
                         f"{tuple(lse.shape)} and delta "
                         f"{tuple(delta.shape)} [{b}, {hq}, {sq}]")
    if q.device.type != "cpu":
        _check_kernel_inputs(fn, q, [("q", q), ("k", k), ("v", v),
                                     ("do", do)],
                             f32=[("lse", lse), ("delta", delta)],
                             seg=[("seg_q", seg_q), ("seg_k", seg_k)]
                             if seg_q is not None else ())
    return b, sq, sk, hq, hkv, d


def flash_backward_dkv(q, k, v, do, lse, delta,
                       seg_q: Optional[torch.Tensor] = None,
                       seg_k: Optional[torch.Tensor] = None, *,
                       causal: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel #5, dK and dV.  The forward's operands plus do like q and
    lse, delta [B, Hq, Sq] f32.  Returns (dk like k, dv like v), summed
    over the n_rep query heads of each kv head."""
    b, sq, sk, hq, hkv, d = _check_backward(
        "flash_backward_dkv", q, k, v, do, lse, delta, seg_q, seg_k)
    if q.device.type == "cpu":
        return flash_backward_dkv_reference(q, k, v, do, lse, delta, seg_q,
                                            seg_k, causal=causal)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    if b == 0 or sk == 0:
        return dk, dv
    if sq == 0:
        return dk.zero_(), dv.zero_()
    _launch(_library(), "flash_bwd_dkv_launch", "flash_backward_dkv",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), _ptr(seg_q), _ptr(seg_k),
            dk.data_ptr(), dv.data_ptr(), b, sq, sk, hq, hkv, d, int(causal),
            d ** -0.5, _DTYPE_CODE[q.dtype], _stream(q))
    flash_backward_dkv.launches += 1
    return dk, dv


flash_backward_dkv.launches = 0


def flash_backward_dq(q, k, v, do, lse, delta,
                      seg_q: Optional[torch.Tensor] = None,
                      seg_k: Optional[torch.Tensor] = None, *,
                      causal: bool = True) -> torch.Tensor:
    """Kernel #6, dQ.  Operands as :func:`flash_backward_dkv`; returns dq
    like q."""
    b, sq, sk, hq, hkv, d = _check_backward(
        "flash_backward_dq", q, k, v, do, lse, delta, seg_q, seg_k)
    if q.device.type == "cpu":
        return flash_backward_dq_reference(q, k, v, do, lse, delta, seg_q,
                                           seg_k, causal=causal)
    dq = torch.empty_like(q)
    if b == 0 or sq == 0:
        return dq
    _launch(_library(), "flash_bwd_dq_launch", "flash_backward_dq",
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), _ptr(seg_q), _ptr(seg_k),
            dq.data_ptr(), b, sq, sk, hq, hkv, d, int(causal), d ** -0.5,
            _DTYPE_CODE[q.dtype], _stream(q))
    flash_backward_dq.launches += 1
    return dq


flash_backward_dq.launches = 0


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


def _repeat_heads(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    return x if n_rep == 1 else torch.repeat_interleave(x, n_rep, dim=2)


def _scores(q, k, seg_q, seg_k, causal: bool) -> torch.Tensor:
    """[B, Hq, Sq, Sk] f32 scores, scaled, masked with NEG_INF (the TPU
    kernels' ``_masked_scores``): causal on absolute positions, and
    q id == k id when segment ids are given."""
    n_rep = q.shape[2] // k.shape[2]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     _repeat_heads(k, n_rep).float()) * q.shape[3] ** -0.5
    sq, sk = q.shape[1], k.shape[1]
    keep = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        keep = (torch.arange(sq, device=q.device)[:, None]
                >= torch.arange(sk, device=q.device)[None, :])
    keep = keep[None, None]
    if seg_q is not None:
        keep = keep & (seg_q[:, None, :, None] == seg_k[:, None, None, :])
    return s.masked_fill(~keep, NEG_INF)


def flash_forward_reference(q, k, v, seg: Optional[torch.Tensor] = None, *,
                            causal: bool = True,
                            seg_k: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain forward: (o like q, lse [B, Hq, Sq] f32).  ``seg`` holds
    the query rows' ids and, unless ``seg_k`` is given, the keys' too."""
    seg_k = seg if seg_k is None else seg_k
    s = _scores(q, k, seg, seg_k, causal)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    masked = m <= NEG_INF / 2
    l = p.sum(-1, keepdim=True)
    l = torch.where(l == 0, 1.0, l)
    n_rep = q.shape[2] // k.shape[2]
    acc = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(),
                       _repeat_heads(v, n_rep).float())
    o = torch.where(masked, 0.0, acc / l)
    lse = torch.where(masked, 0.0, m + torch.log(l))
    return o.transpose(1, 2).to(q.dtype), lse[..., 0]


def _backward_terms(q, k, v, do, lse, delta, seg_q, seg_k, causal):
    """(p, ds) [B, Hq, Sq, Sk] f32 of the TPU backward kernels."""
    p = torch.exp(_scores(q, k, seg_q, seg_k, causal) - lse[..., None])
    n_rep = q.shape[2] // k.shape[2]
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(),
                      _repeat_heads(v, n_rep).float())
    return p, p * (dp - delta[..., None])


def flash_backward_dkv_reference(q, k, v, do, lse, delta, seg_q=None,
                                 seg_k=None, *, causal: bool = True
                                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain dK/dV: per query head in f32, then summed over the n_rep
    heads of each kv head (``_bwd_impl``'s reduction)."""
    p, ds = _backward_terms(q, k, v, do, lse, delta, seg_q, seg_k, causal)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).float(),
                      q.float()) * q.shape[3] ** -0.5
    b, sk, hkv, d = k.shape
    n_rep = q.shape[2] // hkv
    if n_rep > 1:
        dk = dk.reshape(b, sk, hkv, n_rep, d).sum(3)
        dv = dv.reshape(b, sk, hkv, n_rep, d).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_backward_dq_reference(q, k, v, do, lse, delta, seg_q=None,
                                seg_k=None, *, causal: bool = True
                                ) -> torch.Tensor:
    """The plain dQ."""
    _, ds = _backward_terms(q, k, v, do, lse, delta, seg_q, seg_k, causal)
    n_rep = q.shape[2] // k.shape[2]
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).float(),
                      _repeat_heads(k, n_rep).float()) * q.shape[3] ** -0.5
    return dq.to(q.dtype)


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``delta = rowsum(dO * O)`` in f32, [B, S, H, D] -> [B, H, S]."""
    return (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()


def flash_backward_reference(q, k, v, seg, o, lse, do, *,
                             causal: bool = True,
                             seg_k: Optional[torch.Tensor] = None):
    """The plain backward as a whole: (dq, dk, dv) from the forward's
    operands, its (o, lse) and dO."""
    seg_k = seg if seg_k is None else seg_k
    delta = attention_delta(o, do)
    dk, dv = flash_backward_dkv_reference(q, k, v, do, lse, delta, seg,
                                          seg_k, causal=causal)
    dq = flash_backward_dq_reference(q, k, v, do, lse, delta, seg, seg_k,
                                     causal=causal)
    return dq, dk, dv


# ---------------------------------------------------------------------------
# Public entry
# ---------------------------------------------------------------------------


class _FlashAttention(torch.autograd.Function):
    """Forward: kernel #4, saving (q, k, v, seg, o, lse).  Backward:
    delta in plain torch, then kernels #5 and #6."""

    @staticmethod
    def forward(ctx, q, k, v, seg, causal):
        o, lse = flash_forward(q, k, v, seg, seg, causal=causal)
        ctx.save_for_backward(q, k, v, seg, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = attention_delta(o, do)
        dk, dv = flash_backward_dkv(q, k, v, do, lse, delta, seg, seg,
                                    causal=ctx.causal)
        dq = flash_backward_dq(q, k, v, do, lse, delta, seg, seg,
                               causal=ctx.causal)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    segment_ids: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """[B, S, H, D] flash attention, differentiable, optionally with
    packed-sequence ``segment_ids`` [B, S] (cross-document scores
    masked in the kernels).  On CUDA tensors every call launches the
    kernels (or raises); on CPU tensors it runs the plain versions."""
    if segment_ids is not None:
        segment_ids = segment_ids.to(torch.int32).contiguous()
    return _FlashAttention.apply(q.contiguous(), k.contiguous(),
                                 v.contiguous(), segment_ids, causal)
