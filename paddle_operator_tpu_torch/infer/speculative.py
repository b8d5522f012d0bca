"""The multi-token paged forward — the part of
``paddle_operator_tpu/infer/speculative.py`` the paged ring's prefix-hit
admission needs: :func:`_proj_qkv`, :func:`_layer_multi_paged` and
:func:`_multi_forward_paged` (bf16 pool, ``head=True``).  A cached
prefix lives in the pool already, so the suffix insert runs the
uncached tail as one [B, T] forward at per-lane offsets whose writes
and attention walk the block table.

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
                       k_pool: torch.Tensor, v_pool: torch.Tensor, li: int,
                       table: torch.Tensor, pos: torch.Tensor,
                       limit: Optional[torch.Tensor]) -> torch.Tensor:
    """One decoder layer over [B, T] new tokens at PER-LANE offsets
    ``pos`` [B] over the paged pool: row (b, j) sits at absolute
    position pos[b]+j, lands in whatever pool block the lane's table
    maps there (rows at/after ``limit`` — pads — go to the trash
    block), and attends the gathered lane view's columns
    [0, pos[b]+j].  Writes layer ``li`` of the pools in place."""
    from paddle_operator_tpu_torch.infer.paged import (
        _gather_lane_view,
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
    block_size = k_pool.shape[3]
    _write_rows_paged(k_pool[li], k.transpose(1, 2), table, pos, block_size,
                      limit)
    _write_rows_paged(v_pool[li], v.transpose(1, 2), table, pos, block_size,
                      limit)
    k_view = _gather_lane_view(k_pool, table, li)
    v_view = _gather_lane_view(v_pool, table, li)

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


def _multi_forward_paged(cfg: LlamaConfig, params, toks: torch.Tensor,
                         cache: Dict[str, torch.Tensor],
                         table: torch.Tensor,
                         limit: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """[B, T] new tokens at per-lane ``cache['pos']`` over the paged
    pool -> ([B, T, vocab] f32 logits, cache with the pools written in
    place and ``pos + T``).  ``table`` [B, M] int32; ``limit`` [B]
    bounds the real rows per lane (pads beyond it write the trash
    block).  The JAX function's ``head=False`` (KV append only), int8
    pool, LoRA and TP variants are not ported yet."""
    pos = cache["pos"]
    x = params.tok_embed.embedding.to(cfg.dtype)[toks.long()]
    cos, sin = params.rope_cos, params.rope_sin
    for li, lp in enumerate(params.layers):
        x = _layer_multi_paged(cfg, lp, x, cos, sin, cache["k"], cache["v"],
                               li, table, pos, limit)
    new_cache = {"k": cache["k"], "v": cache["v"],
                 "pos": pos + toks.shape[1]}
    x = D._rms(x, params.final_norm.scale, cfg.norm_eps, cfg.dtype)
    logits = D._mm(x, params.lm_head.kernel, cfg.dtype).float()
    return logits, new_cache
