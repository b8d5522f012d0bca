"""Attention ops — the port of ``paddle_operator_tpu/ops/attention.py``.

Only the plain training-forward attention is ported so far:
:func:`reference_attention`, with f32 scores and softmax (packed
``segment_ids`` come with the flash kernel).  The flash
forward/backward kernels (``ops/pallas_attention.py`` on the TPU) are
still to be ported (ROADMAP.md Queue B); until then the model's forward
runs this plain version on every device.

Shapes follow the [batch, seq, heads, head_dim] convention.  GQA is
handled here (kv heads repeated to query heads).
"""

from __future__ import annotations

import torch


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, Hkv, D] -> [B, S, Hkv*n_rep, D] (GQA broadcast)."""
    if n_rep == 1:
        return x
    return torch.repeat_interleave(x, n_rep, dim=2)


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True) -> torch.Tensor:
    """[B, S, H, D] x3 -> [B, S, H, D].  Scores and softmax in f32; the
    probabilities are cast back to q's dtype for the value product."""
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
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)
