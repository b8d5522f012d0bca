"""Ulysses sequence parallelism — the all-to-all alternative to ring
attention over the ``cp`` mesh axis; the port of
``paddle_operator_tpu/parallel/ulysses.py``.

One ``all_to_all`` re-shards q, k and v from sequence-sharded
``[B, S/cp, H, D]`` to head-sharded ``[B, S, H/cp, D]``, each rank runs
ordinary full-sequence attention on its heads through
``ops/attention.py`` (the flash kernels #4–#6 on the card), and a
second ``all_to_all`` re-shards back.  Two all-to-alls of the
activations whatever the sequence length, against ring attention's
``cp - 1`` K/V hops.

What differs from the JAX module:

- explicit SPMD: :func:`ulysses_attention` takes this rank's chunks and
  the ``cp`` axis as ``(group, rank, size)``; q, k and v cross in ONE
  exchange (``collectives.all_to_all``), and so do their gradients.
- under tensor parallelism a rank holds ``H/tp`` query and ``Hkv/tp``
  kv heads, and the all-to-all splits those.  JAX picks Ulysses when
  ``cp`` divides the model's ``n_heads`` and ``n_kv_heads`` and runs it
  on the global head axis under GSPMD, whatever tp holds.  The port
  follows that rule (``models/llama.py`` ``Attention``) and holds JAX's
  values: where ``cp`` divides a rank's query heads but not its kv heads
  (the tiny preset's 4 and 2 heads at tp 2, cp 2) each kv head is
  repeated within its GQA group (the least factor that makes the kv
  heads split evenly; attention sees the same kv per query head), and
  where ``cp`` does not divide a rank's query heads the call is refused
  by name.
"""

from __future__ import annotations

from typing import Optional

import torch

from paddle_operator_tpu_torch.ops.attention import attention
from paddle_operator_tpu_torch.parallel.collectives import (
    all_to_all, gather_along, group_of)


def kv_repeat(h_local: int, hkv_local: int, n: int) -> int:
    """The least factor ``r`` dividing the GQA group size ``h_local /
    hkv_local`` such that ``n`` divides ``hkv_local * r``: each kv head
    is repeated ``r`` times before the all-to-all.  Raises
    ``NotImplementedError`` when ``n`` does not divide ``h_local``."""
    if h_local % n:
        raise NotImplementedError(
            f"Ulysses over cp={n} on a rank holding {h_local} query heads: "
            "the port's all-to-all splits a rank's own heads (H/tp), and "
            f"{n} does not divide {h_local}.  JAX runs Ulysses on the "
            "global head axis under GSPMD here; the port does not (use "
            "cp_impl='ring', or a tp that leaves cp whole query heads)")
    group = h_local // hkv_local
    return next(r for r in range(1, group + 1)
                if group % r == 0 and (hkv_local * r) % n == 0)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      segment_ids: Optional[torch.Tensor] = None, *,
                      cp=None, causal: bool = True) -> torch.Tensor:
    """This rank's chunks ``[B, S/cp, H, D]`` (k and v: ``Hkv`` heads)
    in, the same shape out.  ``segment_ids`` [B, S/cp] are all-gathered
    to the full sequence: every rank attends full-length for its heads,
    so ordinary attention applies the mask.  ``cp`` None or of size 1:
    plain attention."""
    if cp is None or cp[2] == 1:
        return attention(q, k, v, causal=causal, segment_ids=segment_ids)
    n = cp[2]
    r = kv_repeat(q.shape[2], k.shape[2], n)
    if r > 1:
        k = torch.repeat_interleave(k, r, dim=2)
        v = torch.repeat_interleave(v, r, dim=2)
    # seq-sharded -> head-sharded: split heads (dim 2), gather seq (dim 1)
    qh, kh, vh = all_to_all(q, k, v, split_dim=2, concat_dim=1, cp=cp)
    seg_full = (None if segment_ids is None
                else gather_along(segment_ids, 1, (cp[0],)))
    out = attention(qh, kh, vh, causal=causal, segment_ids=seg_full)
    # head-sharded -> seq-sharded: split seq, gather heads
    (out,) = all_to_all(out, split_dim=1, concat_dim=2, cp=cp)
    return out


def make_ulysses_attention_fn(mesh, *, causal: bool = True,
                              axis_name: str = "cp"):
    """:func:`ulysses_attention` over the ``axis_name`` axis of the
    DeviceMesh ``mesh`` (this rank's chunks in and out)."""
    cp = group_of(mesh, axis_name)

    def call(q, k, v, segment_ids=None):
        return ulysses_attention(q, k, v, segment_ids, cp=cp, causal=causal)

    return call
