"""Attention ops — the port of ``paddle_operator_tpu/ops/attention.py``.

The single entry point :func:`attention` dispatches on the tensors'
device:

- CUDA: the flash forward/backward kernels (ops/flash_attention.py,
  ``csrc/flash_attention.cu``).  A shape the kernels do not take raises:
  unlike the JAX dispatcher there is no fall back to the plain version.
- CPU: :func:`reference_attention`, with f32 scores and softmax (the
  JAX package's path off the TPU).

Shapes follow the [batch, seq, heads, head_dim] convention.  GQA is
handled here (kv heads repeated to query heads) so model code stays
shape-oblivious.
"""

from __future__ import annotations

from typing import Optional

import torch

from paddle_operator_tpu_torch.ops.flash_attention import flash_attention


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, Hkv, D] -> [B, S, Hkv*n_rep, D] (GQA broadcast)."""
    if n_rep == 1:
        return x
    return torch.repeat_interleave(x, n_rep, dim=2)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        segment_ids: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """[B, S, H, D] x3 -> [B, S, H, D].  Scores and softmax in f32; the
    probabilities are cast back to q's dtype for the value product.
    ``segment_ids`` [B, S] masks scores across packed documents."""
    n_rep = q.shape[2] // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scale = q.shape[-1] ** -0.5

    # [B, H, Sq, Sk] scores in f32 for numerical stability
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        sq, sk = scores.shape[-2], scores.shape[-1]
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    if segment_ids is not None:
        same = segment_ids[:, :, None] == segment_ids[:, None, :]
        scores = scores.masked_fill(~same[:, None], float("-inf"))
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True,
              segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dispatching attention.  [B, S, H, D] inputs, head-count ratio =
    GQA: the flash kernels for tensors off the CPU (they launch on CUDA
    or raise), the plain version on the CPU."""
    if q.device.type == "cpu":
        return reference_attention(q, k, v, causal=causal,
                                   segment_ids=segment_ids)
    return flash_attention(q, k, v, causal=causal, segment_ids=segment_ids)
