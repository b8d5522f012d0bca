"""The multi-token paged forward — the part of
``paddle_operator_tpu/infer/speculative.py`` the paged ring's prefix-hit
admission needs: :func:`_proj_qkv`, :func:`_write_rows_quant`,
:func:`_layer_multi_paged` and :func:`_multi_forward_paged` (bf16 and
int8 pool, ``head=True``).  A cached prefix lives in the pool
already, so the suffix insert runs the uncached tail as one [B, T]
forward at per-lane offsets whose writes and attention walk the block
table.

Speculative decoding itself (draft propose, chunked verify, exact
greedy acceptance) is not ported yet (ROADMAP.md Queue A).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from paddle_operator_tpu_torch.infer import decode as D
from paddle_operator_tpu_torch.models.llama import LlamaConfig


def _proj_qkv(cfg: LlamaConfig, lp, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shared multi-token projection block: norm -> q/k/v, reshaped to
    [B, T, H, D] pre-RoPE."""
    b, t, _ = x.shape
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = D._rms(x, lp.attn_norm.scale, cfg.norm_eps, cfg.dtype)
    q = D._mm(h, lp.attn.wq.kernel, cfg.dtype)
    k = D._mm(h, lp.attn.wk.kernel, cfg.dtype)
    v = D._mm(h, lp.attn.wv.kernel, cfg.dtype)
    return (q.reshape(b, t, hq, d), k.reshape(b, t, hkv, d),
            v.reshape(b, t, hkv, d))


def _layer_multi_paged(cfg: LlamaConfig, lp, x: torch.Tensor,
                       cos: torch.Tensor, sin: torch.Tensor,
                       cache: Dict[str, torch.Tensor], li: int,
                       table: torch.Tensor, pos: torch.Tensor,
                       limit: Optional[torch.Tensor],
                       quant: bool) -> torch.Tensor:
    """One decoder layer over [B, T] new tokens at PER-LANE offsets
    ``pos`` [B] over the paged pool: row (b, j) sits at absolute
    position pos[b]+j, lands in whatever pool block the lane's table
    maps there (rows at/after ``limit`` — pads — go to the trash
    block), and attends the gathered lane view's columns
    [0, pos[b]+j].  Writes layer ``li`` of the pools in place.

    ``quant=True`` (the int8 pool): each new row goes to the lane's
    staging tail, and a row completing its block quantizes the whole
    block into the pool (codes + one scale each,
    :func:`_write_rows_quant`); pads are written nowhere.  The
    attention then reads the dequantizing view with the write-frontier
    block ``max(min(pos + T, limit) - 1, 0) // bs`` from the tail: the
    suffix's own completed blocks are read as codes, as in the JAX
    function."""
    from paddle_operator_tpu_torch.infer.paged import (
        _gather_lane_view,
        _gather_view_quant,
        _write_rows_paged,
    )

    b, t, _ = x.shape
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _proj_qkv(cfg, lp, x)
    abs_pos = pos[:, None].long() + torch.arange(t, device=x.device)[None]
    p = torch.clamp(abs_pos, max=cos.shape[0] - 1)
    cos_b = cos[p][:, :, None, :]                            # [B, T, 1, d/2]
    sin_b = sin[p][:, :, None, :]

    def rot(u):
        u1, u2 = u.float().chunk(2, dim=-1)
        return torch.cat([u1 * cos_b - u2 * sin_b, u2 * cos_b + u1 * sin_b],
                         dim=-1).to(u.dtype)

    q, k = rot(q), rot(k)
    block_size = cache["k"].shape[3]
    if quant:
        end = pos.long() + t
        if limit is not None:
            end = torch.minimum(end, limit.long())
        n_real = torch.clamp(end - pos.long(), min=0)
        for kind, rows in (("k", k), ("v", v)):
            _write_rows_quant(cache[kind][li], cache[kind + "s"][li],
                              cache[kind + "t"][li], rows.transpose(1, 2),
                              table, pos, n_real)
        wb = torch.clamp(end - 1, min=0) // block_size
        k_view = _gather_view_quant(cache, "k", table, li, wb)
        v_view = _gather_view_quant(cache, "v", table, li, wb)
    else:
        for kind, rows in (("k", k), ("v", v)):
            _write_rows_paged(cache[kind][li], rows.transpose(1, 2), table,
                              pos, block_size, limit)
        k_view = _gather_lane_view(cache["k"], table, li)
        v_view = _gather_lane_view(cache["v"], table, li)

    n_rep = hq // hkv
    s = k_view.shape[2]
    qg = q.reshape(b, t, hkv, n_rep, d)
    scores = torch.einsum("bthrd,bhsd->bthrs", qg.float(),
                          k_view.float()) / (float(d) ** 0.5)
    mask = (torch.arange(s, device=x.device)[None, None, :]
            <= abs_pos[:, :, None])                          # [B, T, S]
    scores = scores.masked_fill(~mask[:, :, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bthrs,bhsd->bthrd", probs.to(cfg.dtype).float(),
                       v_view.float())
    out = out.reshape(b, t, hq * d).to(cfg.dtype)
    return D._finish_layer(cfg, lp, x, out)


def _write_rows_quant(pool_l: torch.Tensor, scales_l: torch.Tensor,
                      tail_l: torch.Tensor, kv: torch.Tensor,
                      table: torch.Tensor, pos: torch.Tensor,
                      n_real: torch.Tensor) -> None:
    """One layer of the int8 pool (codes [N, H, bs, D], scales [N, H],
    tails [B + 1, H, bs, D]) <- [B, H, T, D] new rows at per-lane
    positions ``pos`` [B], of which the first ``n_real`` [B] are real —
    with the JAX function's row-order effect, in fixed shapes and
    without a host read.  The span of T rows touches at most
    ``ceil(T / bs) + 1`` blocks from the lane's frontier block
    ``pos // bs``: they are laid out in an extended tile whose first
    block starts as the lane's tail (the rows before ``pos``), the real
    rows are written in, every block of it quantizes, and a block whose
    last row is real (it completed) writes its codes and scale to the
    lane's table entry — the rest to trash block 0.  The lane's tail
    becomes the block of its last real row.  Rows past that row in the
    new tail differ from the JAX function's (stale rows of an earlier
    block there, zeros here); they sit past the fill and are
    overwritten before any read."""
    from paddle_operator_tpu_torch.infer.paged import quantize_kv

    b, h, t, d = kv.shape
    bs = pool_l.shape[2]
    nb = -(-t // bs) + 1
    dev = kv.device
    lanes = torch.arange(b, device=dev)
    c0 = (pos // bs).long()
    ext = torch.zeros((b, h, nb * bs, d), dtype=tail_l.dtype, device=dev)
    ext[:, :, :bs] = tail_l[:b]
    idx = ((pos % bs).long()[:, None]
           + torch.arange(t, device=dev)[None, :])          # [B, T]
    real = torch.arange(t, device=dev)[None, :] < n_real[:, None]
    idx4 = idx[:, None, :, None].expand(b, h, t, d)
    ext.scatter_(2, idx4, torch.where(real[:, None, :, None],
                                      kv.to(ext.dtype), ext.gather(2, idx4)))
    tiles = ext.reshape(b, h, nb, bs, d).transpose(1, 2)    # [B, nb, H, bs, D]
    codes, scale = quantize_kv(tiles)
    blk = c0[:, None] + torch.arange(nb, device=dev)[None, :]
    done = (blk + 1) * bs <= (pos.long() + n_real.long())[:, None]
    dst = torch.where(done, table.long().gather(
        1, torch.clamp(blk, max=table.shape[1] - 1)), torch.zeros_like(blk))
    pool_l[dst.reshape(-1)] = codes.reshape(b * nb, h, bs, d)
    scales_l[dst.reshape(-1)] = scale.reshape(b * nb, h)
    last = torch.clamp((pos.long() + n_real.long() - 1) // bs - c0, min=0)
    rows = torch.where(n_real > 0, lanes,
                       torch.full_like(lanes, tail_l.shape[0] - 1))
    tail_l[rows] = tiles[lanes, last]


def _multi_forward_paged(cfg: LlamaConfig, params, toks: torch.Tensor,
                         cache: Dict[str, torch.Tensor],
                         table: torch.Tensor,
                         limit: Optional[torch.Tensor] = None,
                         quant: bool = False
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """[B, T] new tokens at per-lane ``cache['pos']`` over the paged
    pool -> ([B, T, vocab] f32 logits, cache with the pools written in
    place and ``pos + T``).  ``table`` [B, M] int32; ``limit`` [B]
    bounds the real rows per lane (pads beyond it write the trash
    block).  ``quant=True``: the int8 pool's dict, with tails
    [B + 1, ...] (the last row the trash tail).  The JAX function's
    ``head=False`` (KV append only), ``lane_mask``, LoRA, TP and
    ``aligned`` variants are not ported yet."""
    pos = cache["pos"]
    x = params.tok_embed.embedding.to(cfg.dtype)[toks.long()]
    cos, sin = params.rope_cos, params.rope_sin
    for li, lp in enumerate(params.layers):
        x = _layer_multi_paged(cfg, lp, x, cos, sin, cache, li, table, pos,
                               limit, quant)
    new_cache = dict(cache, pos=pos + toks.shape[1])
    x = D._rms(x, params.final_norm.scale, cfg.norm_eps, cfg.dtype)
    logits = D._mm(x, params.lm_head.kernel, cfg.dtype).float()
    return logits, new_cache
