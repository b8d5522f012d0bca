"""Ring attention — context (sequence) parallelism over the ``cp`` mesh
axis; the port of ``paddle_operator_tpu/parallel/ring_attention.py``.

The sequence is split over the ``cp`` axis: each rank holds a contiguous
chunk of ``S/cp`` positions of q, k and v.  Q stays where it is; K and V
(and packed-sequence ``segment_ids``) rotate around the ring while each
rank accumulates its rows' softmax online in f32 (flash attention's
arithmetic at chunk granularity).

Causality at chunk granularity: with contiguous chunks, chunk ``src``
contributes to chunk ``my`` fully when ``src < my``, under the diagonal
mask when ``src == my``, and not at all when ``src > my`` (masked to
``NEG_INF``).  As in JAX every rank runs every hop's operations, the
masked ones included: the ranks' programs are the same, so a per-layer
checkpoint recomputes the same exchanges on every rank of the ring.

What differs from the JAX module:

- explicit SPMD: :func:`ring_attention` takes this rank's chunks and
  the ``cp`` axis as ``(group, rank, size)`` (``parallel/collectives.py``
  ``group_of``); there is no ``shard_map`` and no ``ring_pos`` (the rank
  knows its position).  :func:`make_ring_attention_fn` binds the axis of
  a DeviceMesh.
- the rotation is ``collectives.ring_shift`` (one exchange a hop for K
  and V together; the last hop's rotation, whose result JAX discards,
  is not made).  Autograd differentiates through it as JAX
  differentiates its scan: the backward shifts the gradients back.
- the products run in f32 on f32 copies of the operands (JAX: the
  operands' dtype with an f32 result); a bf16 value is exact in f32, so
  the products are the same.

Plain PyTorch operations throughout, as JAX computes it with plain
einsums outside any Pallas kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from paddle_operator_tpu_torch.parallel.collectives import (group_of,
                                                            ring_shift)

NEG_INF = -1e30


def _chunk_scores(q: torch.Tensor, k: torch.Tensor, *, scale: float
                  ) -> torch.Tensor:
    """[B, Sq, H, D] x [B, Sk, Hkv, D] -> [B, H, Sq, Sk] f32 (GQA: K
    repeated to the query heads)."""
    n_rep = q.shape[2] // k.shape[2]
    if n_rep > 1:
        k = torch.repeat_interleave(k, n_rep, dim=2)
    return torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   segment_ids: Optional[torch.Tensor] = None, *,
                   cp=None, causal: bool = True) -> torch.Tensor:
    """This rank's chunks ``[B, S/cp, H, D]`` (k and v: ``Hkv`` heads)
    in, this rank's rows of attention over the whole distributed
    sequence out (``[B, S/cp, H, D]``, q's dtype).

    ``cp``: (group, rank, size) of the axis, or None (one rank: a
    one-hop ring, plain attention).  ``segment_ids`` [B, S/cp]: this
    chunk's packed-document ids; they rotate with K and V, so every
    score tile masks cross-document pairs."""
    my, n = (0, 1) if cp is None else (cp[1], cp[2])
    scale = q.shape[-1] ** -0.5
    b, s_loc, h, d = q.shape
    n_rep = h // k.shape[2]

    m = torch.full((b, h, s_loc, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, s_loc, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, h, s_loc, d), dtype=torch.float32,
                      device=q.device)
    diag = torch.ones((s_loc, s_loc), dtype=torch.bool,
                      device=q.device).tril()
    k_cur, v_cur, seg_cur = k, v, segment_ids
    for step in range(n):
        src = (my - step) % n          # the chunk k_cur/v_cur came from
        s = _chunk_scores(q, k_cur, scale=scale)          # [B, H, Sq, Sk]
        if causal:
            # full when src < my; diagonal-causal when src == my; none
            # after
            keep = diag if src == my else torch.full_like(diag, src < my)
            s = torch.where(keep, s, NEG_INF)
        if segment_ids is not None:
            same = segment_ids[:, :, None] == seg_cur[:, None, :]
            s = torch.where(same[:, None], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        v_rep = (torch.repeat_interleave(v_cur, n_rep, dim=2)
                 if n_rep > 1 else v_cur)
        pv = torch.einsum("bhqk,bkhd->bhqd", p.to(v_rep.dtype).float(),
                          v_rep.float())
        l = l * corr + p.sum(dim=-1, keepdim=True)
        acc = acc * corr + pv
        m = m_new
        if step < n - 1:
            k_cur, v_cur = ring_shift(k_cur, v_cur, cp=cp)
            if segment_ids is not None:
                (seg_cur,) = ring_shift(seg_cur, cp=cp)
    l = torch.where(l == 0.0, 1.0, l)
    out = (acc / l).to(q.dtype)                           # [B, H, Sq, D]
    return out.transpose(1, 2)                            # [B, Sq, H, D]


def make_ring_attention_fn(mesh, *, causal: bool = True,
                           axis_name: str = "cp"):
    """:func:`ring_attention` over the ``axis_name`` axis of the
    DeviceMesh ``mesh`` (this rank's chunks in and out).  With that axis
    of size 1 it is plain attention (a one-hop ring), so model code may
    call it unconditionally."""
    cp = group_of(mesh, axis_name)

    def call(q, k, v, segment_ids=None):
        return ring_attention(q, k, v, segment_ids, cp=cp, causal=causal)

    return call
