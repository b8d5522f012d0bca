"""Speculative decoding — the port of
``paddle_operator_tpu/infer/speculative.py``.

A small DRAFT model proposes K tokens one at a time (K+1 single-token
ticks of the contiguous ring's :func:`~paddle_operator_tpu_torch.infer.
executor._ring_forward`: kernel #1 on the card); the TARGET scores all
K+1 positions in one multi-row forward (:func:`_multi_forward` over a
contiguous cache, :func:`_multi_forward_paged` over the bf16 or int8
pool) and commits the longest prefix that agrees with it, then the
correction or bonus token (:func:`spec_accept`).  Greedy rounds are
token-identical to ``decode.generate``; sampled rounds run the textbook
rejection rule (accept d_i with probability min(1, p/q), else draw the
normalized residual max(0, p - q)), which keeps the target's
distribution.  A rejected row is rolled back by rewinding the write
index: it stays behind ``pos``, is never attended, and is overwritten.

The round (:func:`make_spec_round_fn`) and the N-round megastep
(:func:`make_spec_megastep`) are fixed-shape programs over device
state updated in place, with no host read and no branch on data, so
the ring replays each as a CUDA graph.  The multi-token forwards also
serve the chunked prefill's slices and the prefix-hit suffix insert
(``head=False`` appends KV only).  :func:`speculative_generate` is the
standalone host loop.

Sampling: ``jax.random`` cannot be reproduced, so the round draws from
the port's counter hash (infer/executor.py ``_uniform``/``_gumbel``) in
three streams keyed as JAX keys its ``fold_in`` streams: the draft's
draws (stream 1, at the draft position), the acceptance uniforms
(stream 2, at the round's target position) and the residual draws
(stream 3, the same position).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from paddle_operator_tpu_torch.infer import decode as D
from paddle_operator_tpu_torch.infer.qos import layer_lora
from paddle_operator_tpu_torch.models.llama import LlamaConfig


def check_draft_compat(cfg: LlamaConfig, draft_cfg: LlamaConfig) -> None:
    """The one hard compatibility invariant: only TOKEN IDS cross
    between draft and target, so they must share a tokenizer.  Depth,
    width and head counts may differ freely (``LlamaConfig.draft()``
    builds a compatible config)."""
    if cfg.vocab_size != draft_cfg.vocab_size:
        raise ValueError(
            f"draft/target vocab mismatch: draft vocab_size="
            f"{draft_cfg.vocab_size} vs target {cfg.vocab_size} — "
            "speculative decoding exchanges token ids between the two "
            "models, so they must share one tokenizer")


def _proj_qkv(cfg: LlamaConfig, lp, x: torch.Tensor, lora=None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Shared multi-token projection block: norm -> q/k/v (+ the
    per-row LoRA delta when ``lora=(adp_l, aid)``: qos.lora_qkv, the
    rule every other projection site applies), reshaped to
    [B, T, H, D] pre-RoPE."""
    b, t, _ = x.shape
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = D._rms(x, lp.attn_norm.scale, cfg.norm_eps, cfg.dtype)
    q, k, v = D._proj(cfg, lp, h, lora)
    return (q.reshape(b, t, hq, d), k.reshape(b, t, hkv, d),
            v.reshape(b, t, hkv, d))


def _write_rows(cache_l: torch.Tensor, kv: torch.Tensor,
                pos: torch.Tensor) -> None:
    """[B, H, S, D] cache layer <- [B, H, T, D] new rows at per-lane
    start positions ``pos``, in place.  A start that would run the T
    rows past the allocation is clamped back to ``S - T``, as the JAX
    function's ``dynamic_update_slice`` clamps (the chunked prefill's
    staging length keeps every slice in bounds, so it never fires
    there)."""
    b, _, t, _ = kv.shape
    start = torch.clamp(pos.long(), min=0, max=cache_l.shape[2] - t)
    rows = start[:, None] + torch.arange(t, device=kv.device)[None, :]
    cache_l[torch.arange(b, device=kv.device)[:, None], :, rows] = \
        kv.transpose(1, 2).to(cache_l.dtype)


def _layer_multi(cfg: LlamaConfig, lp, x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, pos: torch.Tensor,
                 lora=None) -> torch.Tensor:
    """One decoder layer over [B, T] new tokens starting at PER-LANE
    offsets ``pos`` [B] over a contiguous cache layer [B, H, S, D]:
    row (b, j) sits at absolute position pos[b]+j and attends cache
    columns [0, pos[b]+j].  Writes the layer's cache in place."""
    t = x.shape[1]
    q, k, v = _proj_qkv(cfg, lp, x, lora)
    abs_pos = pos[:, None].long() + torch.arange(t, device=x.device)[None]
    q, k = _rope_rows(q, cos, sin, abs_pos), _rope_rows(k, cos, sin, abs_pos)
    _write_rows(k_cache, k.transpose(1, 2), pos)
    _write_rows(v_cache, v.transpose(1, 2), pos)
    return D._finish_layer(cfg, lp, x,
                           _attend_rows(cfg, q, k_cache, v_cache, abs_pos))


def _rope_rows(u: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               abs_pos: torch.Tensor) -> torch.Tensor:
    """Split-halves RoPE of [B, T, H, D] rows at absolute positions
    ``abs_pos`` [B, T]; positions past the table read its last row, as
    the JAX gather clamps."""
    p = torch.clamp(abs_pos, max=cos.shape[0] - 1)
    cos_b = cos[p][:, :, None, :]                            # [B, T, 1, d/2]
    sin_b = sin[p][:, :, None, :]
    u1, u2 = u.float().chunk(2, dim=-1)
    return torch.cat([u1 * cos_b - u2 * sin_b, u2 * cos_b + u1 * sin_b],
                     dim=-1).to(u.dtype)


def _attend_rows(cfg: LlamaConfig, q: torch.Tensor, k_view: torch.Tensor,
                 v_view: torch.Tensor, abs_pos: torch.Tensor) -> torch.Tensor:
    """The multi-token einsum attention: q [B, T, Hq, D] over a
    [B, H, S, D] view, row (b, j) attending columns [0, abs_pos[b, j]];
    scores and softmax in f32, probabilities cast to the compute dtype
    for the value product.  -> [B, T, Hq*D] in the compute dtype."""
    b, t = q.shape[:2]
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = k_view.shape[2]
    qg = q.reshape(b, t, hkv, hq // hkv, d)
    scores = torch.einsum("bthrd,bhsd->bthrs", qg.float(),
                          k_view.float()) / (float(d) ** 0.5)
    mask = (torch.arange(s, device=q.device)[None, None, :]
            <= abs_pos[:, :, None])                          # [B, T, S]
    scores = scores.masked_fill(~mask[:, :, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bthrs,bhsd->bthrd", probs.to(cfg.dtype).float(),
                       v_view.float())
    return out.reshape(b, t, hq * d).to(cfg.dtype)


def _head(cfg: LlamaConfig, params, x: torch.Tensor) -> torch.Tensor:
    """Final norm and lm head: [B, T, dim] -> [B, T, vocab] f32."""
    x = D._rms(x, params.final_norm.scale, cfg.norm_eps, cfg.dtype)
    return D._mm(x, params.lm_head, cfg.dtype).float()


def _multi_forward(cfg: LlamaConfig, params, toks: torch.Tensor,
                   cache: Dict[str, torch.Tensor], head: bool = True,
                   lora=None
                   ) -> Tuple[Optional[torch.Tensor],
                              Dict[str, torch.Tensor]]:
    """[B, T] new tokens at per-lane ``cache['pos']`` over a contiguous
    cache (k/v [L, B, H, S, D]) -> ([B, T, vocab] f32 logits, cache with
    k/v written in place and ``pos + T``).  ``head=False`` skips the
    final norm and the lm head and returns ``(None, cache)``: an
    intermediate chunked-prefill slice (executor.make_prefill_chunk)
    only appends KV.  ``lora``: ``(stacks, aid [B])``, each row's
    adapter (the chunked prefill's slices; the speculative round stays
    base-only, adapters being refused on speculative rings).  The JAX
    function's TP variant is not ported yet."""
    pos = cache["pos"]
    x = params.tok_embed.embedding.to(cfg.dtype)[toks.long()]
    cos, sin = params.rope_cos, params.rope_sin
    for li, lp in enumerate(params.layers):
        x = _layer_multi(cfg, lp, x, cos, sin, cache["k"][li],
                         cache["v"][li], pos, layer_lora(lora, li))
    new_cache = dict(cache, pos=pos + toks.shape[1])
    return (_head(cfg, params, x) if head else None), new_cache


def _layer_multi_paged(cfg: LlamaConfig, lp, x: torch.Tensor,
                       cos: torch.Tensor, sin: torch.Tensor,
                       cache: Dict[str, torch.Tensor], li: int,
                       table: torch.Tensor, pos: torch.Tensor,
                       limit: Optional[torch.Tensor],
                       quant: bool,
                       lane_mask: Optional[torch.Tensor] = None,
                       lora=None, aligned: bool = False) -> torch.Tensor:
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
    function.  ``lane_mask`` [B] (int8 only): a masked lane's rows are
    written nowhere — its tail row goes to the trash tail (it may be
    live prefill state) and no block of it commits.  ``aligned`` (bf16
    only): whole-block writes (paged ``_write_rows_paged``)."""
    from paddle_operator_tpu_torch.infer.paged import (
        _gather_lane_view,
        _gather_view_quant,
        _write_rows_paged,
    )

    t = x.shape[1]
    q, k, v = _proj_qkv(cfg, lp, x, lora)
    abs_pos = pos[:, None].long() + torch.arange(t, device=x.device)[None]
    q, k = _rope_rows(q, cos, sin, abs_pos), _rope_rows(k, cos, sin, abs_pos)
    block_size = cache["k"].shape[3]
    if quant:
        end = pos.long() + t
        if limit is not None:
            end = torch.minimum(end, limit.long())
        n_real = torch.clamp(end - pos.long(), min=0)
        if lane_mask is not None:
            n_real = torch.where(lane_mask, n_real, torch.zeros_like(n_real))
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
                              pos, block_size, limit, aligned=aligned)
        k_view = _gather_lane_view(cache["k"], table, li)
        v_view = _gather_lane_view(cache["v"], table, li)
    return D._finish_layer(cfg, lp, x,
                           _attend_rows(cfg, q, k_view, v_view, abs_pos))


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
                         quant: bool = False, head: bool = True,
                         lane_mask: Optional[torch.Tensor] = None,
                         lora=None, aligned: bool = False
                         ) -> Tuple[Optional[torch.Tensor],
                                    Dict[str, torch.Tensor]]:
    """[B, T] new tokens at per-lane ``cache['pos']`` over the paged
    pool -> ([B, T, vocab] f32 logits, cache with the pools written in
    place and ``pos + T``).  ``table`` [B, M] int32; ``limit`` [B]
    bounds the real rows per lane (pads beyond it write the trash
    block).  ``quant=True``: the int8 pool's dict, with tails
    [B + 1, ...] (the last row the trash tail).  ``head=False``: KV
    append only, logits None (an intermediate chunked-prefill slice,
    paged.make_paged_prefill_chunk).  ``lane_mask`` [B] (with
    ``quant``: the spec round's ``active``) redirects masked lanes'
    writes to the trash tail — their tail rows may be live prefill
    state.  ``lora``: ``(stacks, aid [B])``, as :func:`_multi_forward`.
    ``aligned=True`` (bf16; block-aligned ``pos``, a block-multiple
    ``T``: the N-lane prefill engine's slices): whole-block writes, the
    pad rows of the straddling block included, as the JAX function
    writes them.  The JAX function's TP variant is not ported yet."""
    pos = cache["pos"]
    x = params.tok_embed.embedding.to(cfg.dtype)[toks.long()]
    cos, sin = params.rope_cos, params.rope_sin
    for li, lp in enumerate(params.layers):
        x = _layer_multi_paged(cfg, lp, x, cos, sin, cache, li, table, pos,
                               limit, quant, lane_mask,
                               layer_lora(lora, li), aligned=aligned)
    new_cache = dict(cache, pos=pos + toks.shape[1])
    return (_head(cfg, params, x) if head else None), new_cache


# ---------------------------------------------------------------------------
# The speculative round: propose K, verify K+1, commit a+1, rewind
# ---------------------------------------------------------------------------


def spec_accept(tlogits: torch.Tensor, dlogits: torch.Tensor,
                drafts: torch.Tensor, temp: torch.Tensor,
                seeds: torch.Tensor, tpos: torch.Tensor,
                active: torch.Tensor, top_k: Optional[int] = None,
                top_p: Optional[float] = None):
    """The acceptance of one round, on tensors: the target's verify
    logits ``tlogits`` [B, K+1, V] f32 (row j scores the token after
    ``seq[:, j]``), the draft's tick logits ``dlogits`` [B, K, V] f32,
    its proposals ``drafts`` [B, K], per-lane ``temp`` [B] and sampler
    ``seeds`` [B], the round's first target position ``tpos`` [B] (the
    key of the acceptance and residual streams) and ``active`` [B].

    Greedy lanes (temp 0) accept while the draft equals the target's
    argmax; sampled lanes accept d_i when ``u_i * q(d_i) < p(d_i)``
    (u from stream 2).  ``a`` is the longest accepted prefix, 0..K.  The
    token after it — the correction at a < K, the bonus at a == K — is
    the target's argmax (greedy) or a draw of the normalized residual
    max(0, p - q) (stream 3, Gumbel-max over its log: -inf where it is
    0; the target's own distribution where the residual is empty, and
    at the bonus row, where q is 0).  Returns ``(a [B], nxt [B],
    committed [K+1, B], n_commit [B])``: ``committed[:n_commit[b], b]``
    are lane b's new tokens, ``n_commit`` is 0 on inactive lanes."""
    from paddle_operator_tpu_torch.infer.executor import (
        _gumbel,
        _stream,
        _uniform,
    )

    b, kk = drafts.shape
    vocab = tlogits.shape[-1]
    d64 = drafts.long()
    tgt = tlogits.argmax(-1)                                  # [B, K+1]
    accept_g = d64 == tgt[:, :kk]
    t = torch.clamp(temp, min=1e-6)[:, None, None]
    pdist = torch.softmax(D._filter_logits(tlogits / t, top_k, top_p), -1)
    q = torch.softmax(D._filter_logits(dlogits / t, top_k, top_p), -1)
    p_tok = pdist[:, :kk].gather(-1, d64[..., None])[..., 0]   # [B, K]
    q_tok = q.gather(-1, d64[..., None])[..., 0]
    u = _uniform(_stream(seeds, 2), tpos, kk)
    accept_s = u * q_tok < p_tok
    sampled = temp > 0
    accept = torch.where(sampled[:, None], accept_s, accept_g)
    a = torch.cumprod(accept.long(), dim=1).sum(dim=1)       # [B], 0..K
    nxt_g = tgt.gather(1, a[:, None])[:, 0]
    q_pad = torch.cat([q, torch.zeros_like(q[:, :1])], dim=1)
    at = a[:, None, None].expand(b, 1, vocab)
    pd_a = pdist.gather(1, at)[:, 0]                          # [B, V]
    resid = torch.clamp(pd_a - q_pad.gather(1, at)[:, 0], min=0.0)
    resid = torch.where(resid.sum(-1, keepdim=True) > 0, resid, pd_a)
    nxt_s = (torch.log(resid)
             + _gumbel(_stream(seeds, 3), tpos, vocab)).argmax(-1)
    nxt = torch.where(sampled, nxt_s, nxt_g).to(torch.int32)
    n_commit = torch.where(active, a + 1, 0).to(torch.int32)
    drafts_pad = torch.cat([drafts, torch.zeros_like(drafts[:, :1])], dim=1)
    j = torch.arange(kk + 1, device=drafts.device)[None, :]
    committed = torch.where(
        j < a[:, None], drafts_pad,
        torch.where(j == a[:, None], nxt[:, None],
                    torch.zeros_like(drafts_pad)))
    return a, nxt, committed.T, n_commit


def _resync_tails(cache: Dict[str, torch.Tensor], table: torch.Tensor,
                  end: torch.Tensor, pos: torch.Tensor,
                  active: torch.Tensor) -> None:
    """The int8 pool's tail resync after a rewind, without a branch: the
    verify wrote rows through ``end`` [B] (the last row's position), so
    a lane whose rewound frontier block ``pos // bs`` lies below
    ``end // bs`` left its staging tail holding a NEWER block than its
    frontier, and that frontier block completed (and quantized) in the
    verify.  Such lanes (``need``) get the frontier block's dequantized
    rows in their tail — its rows below ``pos`` are the committed ones,
    those above sit behind the fill mask.  Every lane's block is
    dequantized, and the rows of lanes that do not need it go to the
    trash tail: at 7b (8 lanes, 32 layers, bs 256) one round reads 2 x
    268 MB of codes and writes 2 x 537 MB of tails, about 0.5 ms at the
    card's memory rate, where the JAX round ran the same work behind a
    ``lax.cond`` only when some lane needed it."""
    from paddle_operator_tpu_torch.infer.paged import dequantize_kv

    b = pos.shape[0]
    bs = cache["k"].shape[3]
    wb = (pos // bs).long()
    need = active & (wb < (end // bs).long())
    blks = table.long().gather(
        1, torch.clamp(wb, max=table.shape[1] - 1)[:, None])[:, 0]
    lanes = torch.arange(b, device=pos.device)
    rows = torch.where(need, lanes,
                       torch.full_like(lanes, cache["kt"].shape[1] - 1))
    for kind in ("k", "v"):
        tail = cache[kind + "t"]
        tail[:, rows] = dequantize_kv(cache[kind][:, blks],
                                      cache[kind + "s"][:, blks], tail.dtype)


def make_spec_round_fn(cfg: LlamaConfig, dcfg: LlamaConfig, spec_k: int,
                       top_k: Optional[int] = None,
                       top_p: Optional[float] = None, quant: bool = False):
    """One speculative round over ring-style caches (per-lane ``pos``
    vectors), both written in place:

    ``round(params, dparams, tcache, dcache, tok [B], temp [B], seeds
    [B], active [B], table=None) -> (tok', committed [K+1, B], n_commit
    [B])``

    ``tok`` is the per-lane carry token — committed but in neither cache
    yet.  ``committed[:n_commit[b], b]`` are lane b's new tokens
    (accepted drafts, then the correction or bonus token); inactive
    lanes commit nothing, keep their token and get position 0 in both
    caches, so one program serves every arrival and accept pattern.
    With a block ``table`` the TARGET cache is the block pool
    (``quant=True``: the int8 pool); the DRAFT cache is a contiguous
    ring either way.

    The draft ticks K+1 times through ``_ring_forward`` (kernel #1 on
    the card): K proposals, drawn from stream 1 at the draft position
    on sampled lanes, plus one feed whose logits are discarded but whose
    cache write appends d_K's KV, so a full acceptance leaves no gap.
    The target verifies ``[tok, d_1..d_K]`` in one multi-row forward;
    :func:`spec_accept` decides; the rewind sets both positions to
    ``pos0 + a + 1`` on active lanes and to 0 on the rest (retired-lane
    hygiene: their writes land at row 0, or the trash block and tail).
    Under int8 the tails are resynced (:func:`_resync_tails`)."""
    from paddle_operator_tpu_torch.infer.executor import (
        _ring_forward,
        _sample_tokens,
        _stream,
    )

    kk = int(spec_k)

    def round_fn(params, dparams, tcache, dcache, tok, temp, seeds, active,
                 table=None):
        tpos0, dpos0 = tcache["pos"], dcache["pos"]
        dseeds = _stream(seeds, 1)
        dc = dict(dcache)
        tk = tok
        drafts, dlogits = [], []
        for i in range(kk + 1):
            p0 = dc["pos"]
            logits, dc = _ring_forward(dcfg, dparams, tk, dc)
            if i < kk:
                tk = _sample_tokens(logits, temp, dseeds, p0, top_k, top_p)
                drafts.append(tk)
                dlogits.append(logits)
        drafts = torch.stack(drafts, dim=1)                  # [B, K]
        seq = torch.cat([tok[:, None], drafts], dim=1)       # [B, K+1]
        if table is not None:
            tlogits, _ = _multi_forward_paged(
                cfg, params, seq, dict(tcache), table, quant=quant,
                lane_mask=active if quant else None)
        else:
            tlogits, _ = _multi_forward(cfg, params, seq, dict(tcache))
        a, nxt, committed, n_commit = spec_accept(
            tlogits, torch.stack(dlogits, dim=1), drafts, temp, seeds, tpos0,
            active, top_k, top_p)
        zero = torch.zeros_like(tpos0)
        tpos = torch.where(active, (tpos0 + a + 1).to(tpos0.dtype), zero)
        dcache["pos"] = torch.where(active, (dpos0 + a + 1).to(dpos0.dtype),
                                    zero)
        if quant:
            _resync_tails(tcache, table, tpos0 + kk, tpos, active)
        tcache["pos"] = tpos
        return torch.where(active, nxt, tok), committed, n_commit

    return round_fn


def make_spec_megastep(cfg: LlamaConfig, dcfg: LlamaConfig, spec_k: int,
                       n_steps: int, top_k: Optional[int] = None,
                       top_p: Optional[float] = None, quant: bool = False):
    """N fused SPECULATIVE rounds in one dispatch: the round
    (:func:`make_spec_round_fn`) run ``n_steps`` times through the
    megastep's loop (executor._fused), the host's between-round
    decisions — eos inside a committed block, token budget, step budget
    — carried on the device (executor._mega_continue over each round's
    committed tokens).  A lane that finishes mid-megastep free-runs
    masked: under paging its verify writes go through an effective
    table whose row is the trash block (and the trash tail under int8),
    its draft writes land past its frozen draft frontier (rows a
    rollback leaves there anyway), and both positions are restored from
    the pre-round snapshot at each boundary — so a lane frozen by its
    STEP budget resumes bit for bit.

    ``mega(params, dparams, tcache, dcache, tok, temp, seeds, active,
    eos, left, steps, table=None) -> (tok', committed [n, K+1, B], raw
    [n, B], counts [n, B])``: ``raw[r, b]`` is round r's device commit
    count (the acceptance telemetry; 0 for rounds the lane sat out),
    ``counts[r, b]`` the rows of ``committed[r, :, b]`` the host
    consumes (eos/budget truncated)."""
    from paddle_operator_tpu_torch.infer.executor import _fused
    from paddle_operator_tpu_torch.infer.paged import TRASH_BLOCK

    round_fn = make_spec_round_fn(cfg, dcfg, spec_k, top_k, top_p, quant)

    def mega(params, dparams, tcache, dcache, tok, temp, seeds, active, eos,
             left, steps, table=None):
        def run_round(t, live):
            tbl = (torch.where(live[:, None], table,
                               torch.full_like(table, TRASH_BLOCK))
                   if table is not None else None)
            return round_fn(params, dparams, tcache, dcache, t, temp, seeds,
                            live, tbl)

        tok, toks, counts, raws = _fused(run_round, n_steps,
                                         (tcache, dcache), tok, active, eos,
                                         left, steps)
        return tok, toks, raws, counts

    return mega


# ---------------------------------------------------------------------------
# Host side: the standalone generate loop
# ---------------------------------------------------------------------------


@torch.inference_mode()
def speculative_generate(params, draft_params, cfg: LlamaConfig,
                         draft_cfg: LlamaConfig, prompt: torch.Tensor, *,
                         max_new_tokens: int, spec_k: int = 4,
                         temperature: float = 0.0,
                         top_k: Optional[int] = None,
                         top_p: Optional[float] = None, seed: int = 0,
                         max_len: Optional[int] = None,
                         eos_token: Optional[int] = None,
                         return_stats: bool = False):
    """Speculative counterpart of ``decode.generate``: prompt [B, S] (on
    the params' device) -> [B, S + max_new_tokens].  At temperature 0
    the output is token-identical to ``generate``; above it, rejection
    sampling keeps the target's distribution (the streams differ from
    ``generate``'s).  Lane i samples with seed ``seed + i``: its first
    token through the ring's rule at position S - 1, its rounds through
    the three streams of :func:`spec_accept` — so a sampled lane's
    tokens equal a ring lane's with the same seed.  Host-driven: a round
    commits 1..spec_k+1 tokens a lane, and lanes that finish freeze.

    ``return_stats``: also return {"accept_rate", "accepted",
    "drafted", "rounds", "spec_k"}."""
    from paddle_operator_tpu_torch.infer.executor import _sample_tokens

    check_draft_compat(cfg, draft_cfg)
    if spec_k < 1:
        raise ValueError(f"spec_k must be >= 1 (got {spec_k})")
    b, s = prompt.shape
    cache_len = max_len or cfg.max_seq_len
    need = s + max_new_tokens
    if need > cache_len:
        raise ValueError(f"prompt ({s}) + max_new_tokens "
                         f"({max_new_tokens}) = {need} exceeds the cache "
                         f"({cache_len} positions)")
    # a verify round may write spec_k rows past the last committed
    # token: grow the allocation within the RoPE table, or fail clearly
    alloc_len = min(cfg.max_seq_len, cache_len + spec_k)
    if need + spec_k - 1 > D.cache_alloc_len(alloc_len):
        raise ValueError(
            f"speculative decoding needs {spec_k - 1} positions of cache "
            f"headroom past prompt+max_new_tokens ({need}) but the RoPE "
            f"table caps the allocation at {alloc_len} "
            f"(cfg.max_seq_len={cfg.max_seq_len}); lower spec_k or "
            f"max_new_tokens")
    if alloc_len > draft_cfg.max_seq_len:
        raise ValueError(
            f"draft max_seq_len ({draft_cfg.max_seq_len}) is smaller than "
            f"the serving context ({alloc_len}); derive the draft with "
            f"cfg.draft() to inherit the target's RoPE table")
    dev = prompt.device
    logits, tc = D.prefill(params, cfg, prompt, alloc_len)
    _, dc = D.prefill(draft_params, draft_cfg, prompt, alloc_len)
    tcache = {"k": tc["k"], "v": tc["v"],
              "pos": torch.full((b,), s, dtype=torch.int32, device=dev)}
    dcache = {"k": dc["k"], "v": dc["v"],
              "pos": torch.full((b,), s, dtype=torch.int32, device=dev)}
    temp = torch.full((b,), float(temperature), device=dev)
    seeds = int(seed) + torch.arange(b, dtype=torch.int64, device=dev)
    tok = _sample_tokens(logits, temp, seeds,
                         torch.full((b,), s - 1, dtype=torch.int32,
                                    device=dev), top_k, top_p)
    out = [[int(t)] for t in tok.cpu()]
    done = [eos_token is not None and o[0] == eos_token for o in out]
    round_fn = make_spec_round_fn(cfg, draft_cfg, spec_k, top_k, top_p)
    accepted = drafted = rounds = 0
    while True:
        act = [not done[i] and len(out[i]) < max_new_tokens
               for i in range(b)]
        if not any(act):
            break
        tok, committed, n_commit = round_fn(
            params, draft_params, tcache, dcache, tok, temp, seeds,
            torch.as_tensor(act, device=dev))
        committed = committed.cpu().numpy()                # [K+1, B]
        n_commit = n_commit.cpu().numpy()
        rounds += 1
        for i in range(b):
            if not act[i]:
                continue
            n = int(n_commit[i])
            drafted += spec_k
            accepted += n - 1
            for t in committed[:n, i]:
                if len(out[i]) >= max_new_tokens:
                    break
                out[i].append(int(t))
                if eos_token is not None and int(t) == eos_token:
                    done[i] = True
                    break
    # finished lanes keep emitting eos for their remaining positions —
    # decode.generate's static-shape eos semantics
    pad = eos_token if eos_token is not None else 0
    res = np.full((b, s + max_new_tokens), pad, np.int64)
    res[:, :s] = prompt.cpu().numpy()
    for i in range(b):
        res[i, s:s + len(out[i])] = out[i]
    tokens = torch.as_tensor(res, dtype=prompt.dtype, device=dev)
    if return_stats:
        return tokens, {
            "accept_rate": round(accepted / drafted, 4) if drafted else 0.0,
            "accepted": accepted, "drafted": drafted, "rounds": rounds,
            "spec_k": spec_k}
    return tokens
