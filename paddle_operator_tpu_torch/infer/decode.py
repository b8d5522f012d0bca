"""Autoregressive KV-cache decoding for the LLaMA family — the port of
``paddle_operator_tpu/infer/decode.py``.

Same structure and layouts as the JAX module, in PyTorch's idiom:

- the KV cache is a fixed-size ``[L, B, H_kv, alloc, D]`` pair in the
  compute dtype (head-major, :func:`cache_alloc_len` padding), written
  IN PLACE at the fill position — slice assignment where the JAX
  module's pure functions returned a ``dynamic_update_slice`` copy;
- the fill position ``cache["pos"]`` is a host int (batch mode: every
  lane shares it), so no step reads a device scalar back;
- the generation loop is a Python loop of :func:`decode_step` calls
  (the JAX module's ``lax.scan``); the decode path's attention is the
  CUDA kernel of ops/decode_attention.py on a CUDA tensor, once per
  layer per step.

``params`` everywhere is the port's :class:`~paddle_operator_tpu_torch.
models.llama.Llama` module (its ``layers[i]`` is one layer's param
subtree).  :func:`paged_prefill` writes a prompt's KV into the paged
ring's block pool (infer/paged.py), bf16 or int8.  Not ported yet, and
refused when asked for: tensor-parallel meshes, LoRA adapters, MoE
layers and weight-only int8 leaves.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from paddle_operator_tpu_torch.models.llama import Llama, LlamaConfig
from paddle_operator_tpu_torch.ops.decode_attention import (
    DEFAULT_BLOCK_K,
    decode_attention,
)


def _refuse_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError(
            "tensor-parallel serving is not ported to the torch package "
            "yet (ROADMAP.md Queue A, 'Parallelism')")


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float,
         dtype) -> torch.Tensor:
    """models/llama.py RMSNorm math, f32 internals."""
    xf = x.float()
    norm = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (norm * scale.float()).to(dtype)


def _mm(x: torch.Tensor, kernel: torch.Tensor, dtype) -> torch.Tensor:
    """x @ kernel for a raw ``[in, out]`` kernel leaf, in ``dtype``.
    Weight-only int8 leaves come with the quantization slice."""
    if not isinstance(kernel, torch.Tensor):
        raise NotImplementedError(
            "weight-only int8 kernels are not ported to the torch "
            "package yet (ROADMAP.md Queue A, infer/quant.py)")
    return x @ kernel.to(dtype)


def _rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
          pos: int) -> torch.Tensor:
    """Split-halves RoPE at offset ``pos`` (models/llama.py apply_rope)."""
    t = x.shape[1]
    cos = cos[pos:pos + t][None, :, None, :]
    sin = sin[pos:pos + t][None, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def cache_alloc_len(max_len: int) -> int:
    """Allocation length for a KV cache of logical capacity ``max_len``:
    rounded up to a whole number of DEFAULT_BLOCK_K (256) rows, the
    JAX package's layout (lengths within one block stay exact).  The
    CUDA kernel itself takes any length; the padding keeps the two
    packages' caches shaped alike."""
    if max_len <= DEFAULT_BLOCK_K:
        return max_len
    return -(-max_len // DEFAULT_BLOCK_K) * DEFAULT_BLOCK_K


def init_cache(cfg: LlamaConfig, batch: int, max_len: Optional[int] = None,
               *, device="cuda", mesh=None) -> Dict[str, object]:
    """Fixed-size KV cache: k/v [L, B, H_kv, alloc, D] in the compute
    dtype on ``device``, plus the fill position (host int).  Positions
    past the LOGICAL ``max_len`` are never written or attended, so the
    RoPE bound checks the requested capacity, not the padded
    allocation."""
    _refuse_mesh(mesh)
    max_len = max_len or cfg.max_seq_len
    if max_len > cfg.max_seq_len:
        raise ValueError(f"cache max_len {max_len} exceeds the RoPE table "
                         f"(cfg.max_seq_len={cfg.max_seq_len})")
    alloc = cache_alloc_len(max_len)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, alloc, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "pos": 0,
    }


def _qkv(cfg: LlamaConfig, lp, x: torch.Tensor, cos: torch.Tensor,
         sin: torch.Tensor, pos: int
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pre-attention half of a decoder layer: RMSNorm -> q/k/v
    projections -> RoPE at offset ``pos``.  Shapes [B, T, H, D]."""
    b, t, _ = x.shape
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = _rms(x, lp.attn_norm.scale, cfg.norm_eps, cfg.dtype)
    q = _mm(h, lp.attn.wq.kernel, cfg.dtype).reshape(b, t, hq, d)
    k = _mm(h, lp.attn.wk.kernel, cfg.dtype).reshape(b, t, hkv, d)
    v = _mm(h, lp.attn.wv.kernel, cfg.dtype).reshape(b, t, hkv, d)
    return _rope(q, cos, sin, pos), _rope(k, cos, sin, pos), v


def _ffn_residual(cfg: LlamaConfig, lp, x: torch.Tensor) -> torch.Tensor:
    """The FFN half of a decoder layer: norm -> SwiGLU -> +x."""
    n = _rms(x, lp.mlp_norm.scale, cfg.norm_eps, cfg.dtype)
    gate = _mm(n, lp.mlp.w1.kernel, cfg.dtype)
    up = _mm(n, lp.mlp.w3.kernel, cfg.dtype)
    return x + _mm(torch.nn.functional.silu(gate) * up, lp.mlp.w2.kernel,
                   cfg.dtype)


def _finish_layer(cfg: LlamaConfig, lp, x: torch.Tensor,
                  out: torch.Tensor) -> torch.Tensor:
    """Post-attention half: output projection + residual, then the FFN
    + residual."""
    x = x + _mm(out, lp.attn.wo.kernel, cfg.dtype)
    return _ffn_residual(cfg, lp, x)


def _write_kv(k_cache: torch.Tensor, v_cache: torch.Tensor,
              k: torch.Tensor, v: torch.Tensor, pos: int) -> None:
    """[B, T, H, D] new rows -> head-major cache rows [pos, pos+T).
    In place: slice assignment where the JAX module returned a
    dynamic_update_slice copy of the whole cache."""
    t = k.shape[1]
    k_cache[:, :, pos:pos + t] = k.transpose(1, 2)
    v_cache[:, :, pos:pos + t] = v.transpose(1, 2)


def _layer(cfg: LlamaConfig, lp, x: torch.Tensor, cos: torch.Tensor,
           sin: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           pos: int) -> torch.Tensor:
    """One decoder layer over [B, T] new positions starting at ``pos``,
    attending to the cache's [0, pos+T) with plain einsum attention.
    Writes this layer's cache ([B, H_kv, S, D]) in place; returns y."""
    b, t, _ = x.shape
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _qkv(cfg, lp, x, cos, sin, pos)
    _write_kv(k_cache, v_cache, k, v, pos)

    # GQA: group query heads onto kv heads; rows attend cache columns up
    # to their own absolute position (causal + fill mask in one).  Only
    # the live prefix [0, pos+T) is read: the JAX module's einsum runs
    # over the whole allocation, where the masked columns contribute
    # exact zeros.  Scores in f32 (the preferred_element_type rule).
    n_rep = hq // hkv
    live = pos + t
    kc, vc = k_cache[:, :, :live], v_cache[:, :, :live]
    qg = q.reshape(b, t, hkv, n_rep, d)
    scores = torch.einsum("bthrd,bhsd->bthrs", qg.float(),
                          kc.float()) / (float(d) ** 0.5)
    cols = torch.arange(live, device=x.device)
    rows = pos + torch.arange(t, device=x.device)
    mask = cols[None, :] <= rows[:, None]                # [T, S]
    scores = scores.masked_fill(~mask[None, :, None, None, :], -1e30)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bthrs,bhsd->bthrd", probs.to(cfg.dtype).float(),
                       vc.float())
    out = out.reshape(b, t, hq * d).to(cfg.dtype)
    return _finish_layer(cfg, lp, x, out)


def _forward(cfg: LlamaConfig, params: Llama, tokens: torch.Tensor,
             cache: Dict[str, object], *, last_only: bool = False,
             mesh=None, lora=None
             ) -> Tuple[torch.Tensor, Dict[str, object]]:
    """[B, T] new tokens at cache['pos'] -> ([B, T, vocab] f32 logits,
    advanced cache).  The cache tensors are written in place; the
    returned dict carries the advanced position.

    T == 1 with the kernel selected (``cfg.resolved_decode_attn``) runs
    each layer's attention through ops/decode_attention.py on that
    layer's cache view ``k_cache[li]``; everything else (prefill, or
    the plain selection) runs :func:`_layer`'s einsums.

    ``last_only``: apply the norm + lm head to the final position only
    (logits [B, 1, vocab]) — prefill needs just the next-token logits."""
    _refuse_mesh(mesh)
    if lora is not None:
        raise NotImplementedError(
            "LoRA adapters are not ported to the torch package yet "
            "(ROADMAP.md Queue A, infer/qos.py)")
    pos = cache["pos"]
    k_cache, v_cache = cache["k"], cache["v"]
    x = params.tok_embed.embedding.to(cfg.dtype)[tokens]
    cos, sin = params.rope_cos, params.rope_sin
    b, t = tokens.shape

    if t == 1 and cfg.resolved_decode_attn(x.device) == "kernel":
        hq, d = cfg.n_heads, cfg.head_dim
        lengths = torch.full((b,), pos + 1, dtype=torch.int32,
                             device=x.device)
        for li, lp in enumerate(params.layers):
            q, k, v = _qkv(cfg, lp, x, cos, sin, pos)
            _write_kv(k_cache[li], v_cache[li], k, v, pos)
            out = decode_attention(q[:, 0].contiguous(), k_cache, v_cache,
                                   lengths, layer=li)
            out = out.reshape(b, 1, hq * d).to(cfg.dtype)
            x = _finish_layer(cfg, lp, x, out)
    else:
        for li, lp in enumerate(params.layers):
            x = _layer(cfg, lp, x, cos, sin, k_cache[li], v_cache[li], pos)
    if last_only:
        x = x[:, -1:]
    x = _rms(x, params.final_norm.scale, cfg.norm_eps, cfg.dtype)
    logits = _mm(x, params.lm_head.kernel, cfg.dtype).float()
    return logits, {"k": k_cache, "v": v_cache, "pos": pos + t}


def prefill(params: Llama, cfg: LlamaConfig, tokens: torch.Tensor,
            max_len: Optional[int] = None, mesh=None
            ) -> Tuple[torch.Tensor, Dict[str, object]]:
    """Process the whole prompt [B, S] in one pass.  Returns
    ([B, vocab] last-position logits, filled cache)."""
    cache_len = max_len or cfg.max_seq_len
    if tokens.shape[1] > cache_len:
        raise ValueError(f"prompt length {tokens.shape[1]} exceeds the "
                         f"cache ({cache_len} positions)")
    cache = init_cache(cfg, tokens.shape[0], max_len, device=tokens.device,
                       mesh=mesh)
    logits, cache = _forward(cfg, params, tokens, cache, last_only=True)
    return logits[:, 0], cache


def paged_prefill(params: Llama, cfg: LlamaConfig, tokens: torch.Tensor,
                  pool_cache: Dict[str, torch.Tensor],
                  table_row: torch.Tensor, *,
                  block_size: Optional[int] = None,
                  last_only: bool = False, quant: bool = False,
                  prompt_len: Optional[int] = None):
    """Prefill a whole [1, T] prompt and write its KV into the PAGED
    block pool (infer/paged.py) as whole-block writes at the lane's
    ``table_row`` entries — the cold-admission half of paged serving.
    The forward is exactly :func:`prefill`'s; only the destination
    changes: block ``j`` of the lane cache lands in pool block
    ``table_row[j]``.  The lane cache is rounded up to a whole number
    of blocks (zero rows past T), so every write is a whole block; pad
    rows land in the lane's last block, where decode overwrites them
    before they become attendable.

    Returns ([1, T, vocab] logits — ``[1, 1, vocab]`` for the last
    position with ``last_only`` — and the pool cache, written in place,
    with this lane's position untouched (the caller's insert sets it)).

    ``quant=True`` (the int8 pool; needs ``prompt_len``): whole blocks
    quantize once on the way in (ops/decode_attention.py
    ``scatter_prefill_blocks_quant``), and the rows of the prompt's
    write-frontier block, ``[(prompt_len // bs) * bs, + bs)`` of the
    lane cache, come back as exact tail tiles:
    ``(logits, cache, tail_k, tail_v)`` with tails [L, 1, H, bs, D].
    A start past the lane cache (a prompt of whole blocks) clamps back
    to its last block, as the JAX ``dynamic_slice`` does: decode then
    opens a fresh block and those rows sit behind the fill mask."""
    from paddle_operator_tpu_torch.ops.decode_attention import (
        scatter_prefill_blocks,
        scatter_prefill_blocks_quant,
    )

    bs = block_size or pool_cache["k"].shape[3]
    t = tokens.shape[1]
    rows = -(-t // bs) * bs
    lane = {
        "k": torch.zeros((cfg.n_layers, 1, cfg.n_kv_heads, rows,
                          cfg.head_dim), dtype=cfg.dtype,
                         device=tokens.device),
        "v": torch.zeros((cfg.n_layers, 1, cfg.n_kv_heads, rows,
                          cfg.head_dim), dtype=cfg.dtype,
                         device=tokens.device),
        "pos": 0,
    }
    logits, lane = _forward(cfg, params, tokens, lane, last_only=last_only)
    if not quant:
        scatter_prefill_blocks(pool_cache["k"], lane["k"], table_row, bs)
        scatter_prefill_blocks(pool_cache["v"], lane["v"], table_row, bs)
        return logits, pool_cache
    if prompt_len is None:
        raise ValueError("quant paged_prefill needs prompt_len for the "
                         "staging-tail slice")
    scatter_prefill_blocks_quant(pool_cache["k"], pool_cache["ks"],
                                 lane["k"], table_row, bs)
    scatter_prefill_blocks_quant(pool_cache["v"], pool_cache["vs"],
                                 lane["v"], table_row, bs)
    start = min((int(prompt_len) // bs) * bs, rows - bs)
    return (logits, pool_cache, lane["k"][:, :, :, start:start + bs],
            lane["v"][:, :, :, start:start + bs])


def decode_step(params: Llama, cfg: LlamaConfig, token: torch.Tensor,
                cache: Dict[str, object], mesh=None
                ) -> Tuple[torch.Tensor, Dict[str, object]]:
    """One token [B] -> next-position logits [B, vocab] + advanced cache
    (the cache tensors are updated in place)."""
    logits, cache = _forward(cfg, params, token[:, None], cache, mesh=mesh)
    return logits[:, 0], cache


def _filter_logits(logits: torch.Tensor, top_k: Optional[int],
                   top_p: Optional[float]) -> torch.Tensor:
    """Standard sampling filters: top-k keeps the k highest logits;
    top-p (nucleus) keeps the smallest set of tokens whose probability
    mass reaches p.  Filtered entries go to -inf."""
    if top_k is not None:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens until the cumulative mass FIRST exceeds p (the
        # token crossing the threshold is kept — standard nucleus rule)
        keep_sorted = cum - probs < top_p
        cutoff = torch.where(keep_sorted, sorted_logits,
                             torch.full_like(sorted_logits, float("inf"))
                             ).min(dim=-1, keepdim=True).values
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def generate(params: Llama, cfg: LlamaConfig, prompt: torch.Tensor, *,
             max_new_tokens: int, temperature: float = 0.0,
             top_k: Optional[int] = None, top_p: Optional[float] = None,
             generator: Optional[torch.Generator] = None,
             max_len: Optional[int] = None,
             eos_token: Optional[int] = None, mesh=None) -> torch.Tensor:
    """Greedy (temperature=0) or temperature sampling, with optional
    top-k / nucleus (top-p) filtering.  prompt [B, S] (on the params'
    device) -> [B, S + max_new_tokens].  With ``eos_token``, a sequence
    that emits it keeps emitting eos for its remaining positions.

    Sampling draws from ``generator`` (a ``torch.Generator`` on the
    prompt's device; seed 0 when not given).  It cannot reproduce
    ``jax.random`` bit for bit, so sampled tokens differ from the JAX
    package's for the same seed; greedy tokens are the same.

    The JAX module's scan runs max_new_tokens decode steps and drops
    the last step's logits; this loop skips that step, so a call runs
    max_new_tokens - 1 decode steps (n_layers kernel launches each)."""
    _refuse_mesh(mesh)
    if temperature > 0 and generator is None:
        generator = torch.Generator(device=prompt.device)
        generator.manual_seed(0)
    need = prompt.shape[1] + max_new_tokens
    cache_len = max_len or cfg.max_seq_len
    if need > cache_len:
        raise ValueError(f"prompt ({prompt.shape[1]}) + max_new_tokens "
                         f"({max_new_tokens}) = {need} exceeds the cache "
                         f"({cache_len} positions)")

    logits, cache = prefill(params, cfg, prompt, max_len)
    done = torch.zeros(prompt.shape[0], dtype=torch.bool,
                       device=prompt.device)

    def sample(logits: torch.Tensor) -> torch.Tensor:
        if temperature <= 0:
            return logits.argmax(-1).to(prompt.dtype)
        probs = torch.softmax(
            _filter_logits(logits / temperature, top_k, top_p), dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
            prompt.dtype)

    toks = []
    for i in range(max_new_tokens):
        tok = sample(logits)
        if eos_token is not None:
            tok = torch.where(done, torch.full_like(tok, eos_token), tok)
            done = done | (tok == eos_token)
        toks.append(tok)
        if i + 1 < max_new_tokens:
            logits, cache = decode_step(params, cfg, tok, cache)
    if not toks:
        return prompt
    return torch.cat([prompt, torch.stack(toks, dim=1)], dim=1)
