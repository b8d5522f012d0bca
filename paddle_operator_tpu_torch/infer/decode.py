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
ring's block pool (infer/paged.py), bf16 or int8.  Every projection
goes through :func:`_mm`, which also takes the weight-only int8/int4
projections of infer/quant.py.  ``lora=(stacks, aid)`` (infer/qos.py
``AdapterRegistry.arrays()`` and per-row adapter slots) adds each row's
low-rank delta to q, k and v before RoPE (``qos.lora_qkv``), so adapter
KV enters the cache as a merged-weight forward would write it.  An MoE
config's FFN is :func:`_moe_ffn` (exact, no capacity drop) on every
path.

Tensor-parallel serving (``mesh``: a ``parallel/mesh.py``
``make_serving_mesh`` mesh, one process a card): each rank holds its
cut of the model (:func:`shard_params_for_serving`, or
:func:`init_serving_shard` at boot) — wq/wk/wv and w1/w3 by columns,
wo and w2 by rows, the embedding and ``lm_head`` by vocab, every cut a
contiguous copy — marked with its :class:`ServingShard`, and runs the
forward with the rank's heads (``models/llama.py``
``serving_shard_config``) over a KV cache of its kv heads
(:func:`alloc_kv_buffer`).  Where the JAX package's GSPMD inserts its
collectives the port calls them (``parallel/collectives.py``): the
embedding's all-reduce, an all-reduce of wo's and of w2's partial
outputs before each residual add (the decode kernels' wo through
``ops/decode_attention.py`` ``sharded_decode_attention``), and the
all-gather of the vocab-sharded logits, so every rank samples the same
whole row.  A config whose kv heads do not split keeps its attention
whole on every rank, through the plain einsum attention (JAX's
fallback), with the FFN and the vocab still cut.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, Optional, Tuple

import torch
from torch import nn

from paddle_operator_tpu_torch.infer.qos import layer_lora, lora_qkv
from paddle_operator_tpu_torch.models.llama import (Dense, Llama,
                                                    LlamaConfig,
                                                    partition_patterns,
                                                    rope_frequencies,
                                                    serving_shard_config)
from paddle_operator_tpu_torch.ops.decode_attention import (
    DEFAULT_BLOCK_K,
    sharded_decode_attention,
)
from paddle_operator_tpu_torch.ops.quant_matmul import dense_mm as _mm
from paddle_operator_tpu_torch.ops.quant_matmul import quant_mm
from paddle_operator_tpu_torch.parallel import collectives as C
from paddle_operator_tpu_torch.parallel.mesh import (axis_group,
                                                     coordinates, mesh_tp)


# ---------------------------------------------------------------------------
# Mesh-sharded serving (tensor parallel over heads/ffn/vocab)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ServingShard:
    """What one rank of a tensor-parallel serving mesh holds of the
    model, kept on the model and on each of its layers as
    ``serving_tp``: the ``tp`` group its partial sums run over and its
    size, whether the attention heads (``attn``) and the FFN columns
    (``mlp``) are cut, its vocab rows ``[lo, hi)`` (None: the whole
    vocab), and its columns of wq, wk and wv (``lora_cols``, the LoRA
    delta's)."""

    group: Any
    tp: int
    attn: bool
    mlp: bool
    vocab: Optional[Tuple[int, int]]
    lora_cols: Optional[Dict[str, slice]]


def _shard_of(mod) -> Optional[ServingShard]:
    return getattr(mod, "serving_tp", None)


def _attn_group(shard: Optional[ServingShard]):
    """The group a decode kernel's wo partials are summed over (JAX
    ``_use_sharded_kernel``), shared by :func:`_forward` and the rings:
    a rank of a serving mesh whose heads split into whole GQA groups
    (``shard.attn``) runs the kernel on its heads and its rows of wo,
    then one all-reduce over ``shard.group``; one card sums nothing
    (None).  A config whose kv heads do not split never reaches the
    kernel: its ranks' config selects the plain einsum on whole heads
    (``models/llama.py`` ``serving_shard_config``, JAX's fallback)."""
    if shard is not None and shard.tp > 1 and shard.attn:
        return shard.group
    return None


def _local(cfg: LlamaConfig, params) -> LlamaConfig:
    """``cfg`` (the whole model's, or already a rank's) as the rank
    holding ``params`` runs it."""
    shard = _shard_of(params)
    return serving_shard_config(cfg, shard.tp) if shard else cfg


def alloc_kv_buffer(cfg: LlamaConfig, shape, mesh, *,
                    device="cuda", dtype=None) -> torch.Tensor:
    """One zeroed KV buffer of the whole model's ``shape`` (the decode
    cache ``[L, B, Hkv, S, D]`` or any buffer with the kv-head axis at
    dim 2): on a serving mesh whose tp divides the kv heads, this
    rank's kv heads only (``parallel/sharding.py``
    ``kv_cache_sharding``), so every cache shard lives with the wk/wv
    columns that fill it; indivisible kv heads leave it whole."""
    from paddle_operator_tpu_torch.parallel.sharding import (
        kv_cache_sharding,
    )

    shape = list(shape)
    if mesh is not None and mesh_tp(mesh) > 1:
        lo, hi = kv_cache_sharding(cfg.n_kv_heads, mesh)
        shape[2] = hi - lo
    return torch.zeros(shape, dtype=dtype or cfg.dtype, device=device)


def _require_shard(params, mesh) -> None:
    """A mesh of tp > 1 needs the rank's cut of the model (and no mesh
    a whole model)."""
    tp = mesh_tp(mesh)
    shard = _shard_of(params)
    if tp > 1 and (shard is None or shard.tp != tp):
        raise ValueError(
            f"a tp={tp} serving mesh needs this rank's cut of the model "
            "(shard_params_for_serving / init_serving_shard)")
    if tp <= 1 and shard is not None and shard.tp > 1:
        raise ValueError(f"the model is a rank's cut for tp={shard.tp}; "
                         "pass its serving mesh")


def _assign(model: nn.Module, name: str, t: torch.Tensor) -> None:
    """Put ``t`` at state-dict name ``name`` of ``model`` (a parameter
    without a gradient, or a buffer)."""
    mod_name, attr = name.rsplit(".", 1)
    mod = model.get_submodule(mod_name)
    if attr in mod._buffers:
        mod._buffers[attr] = t
    else:
        mod._parameters[attr] = nn.Parameter(t, requires_grad=False)


def _cut_model(cfg: LlamaConfig, mesh, items: Iterable[Tuple[str, Any]],
               device, passes=()) -> Llama:
    """Build this rank's cut of a model from ``items``: ``(state-dict
    name, whole tensor)`` pairs, any device, one at a time — or, for an
    already quantized projection, ``(name of its kernel, (q, s,
    mode))``.  A float kernel that ``passes`` (``infer/quant.py``
    ``quant_passes``) targets is quantized whole first (a row-parallel
    projection's scales need every row), then cut.  Every cut is a
    contiguous copy on ``device``; no whole tensor is kept."""
    from paddle_operator_tpu_torch.infer import quant as Q
    from paddle_operator_tpu_torch.parallel.sharding import (
        serving_region,
        serving_specs,
    )

    split = cfg.decode_tp_compatible(mesh_tp(mesh))
    pats = partition_patterns(cfg)
    device = torch.device(device)
    model = Llama(cfg, "meta")

    def region(name, t):
        spec = serving_specs({name: t.shape}, mesh, pats, split)[name]
        return serving_region(t.shape, spec, mesh)

    def copy(t):
        # one contiguous copy on the device, whatever t's strides
        return torch.empty(t.shape, dtype=t.dtype, device=device).copy_(t)

    for name, t in items:
        base, mode = name[:-len(".kernel")], None
        if name.endswith(".kernel"):
            if isinstance(t, tuple):
                q, s, mode = t
            else:
                mode = Q.leaf_quant_mode(base.replace(".", "/") + "/kernel",
                                         passes)
                if mode is not None:
                    leaf = Q.quantize_leaf(t.to(device), mode)
                    q, s = leaf["q"], leaf["s"]
        if mode is None:
            _assign(model, name, copy(t[region(name, t)]))
        else:
            ql, sl = Q.cut_quantized(q, s, *region(name, q))
            model.get_submodule(base).set_quantized(copy(ql), copy(sl), mode)
    cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq_len,
                                cfg.rope_theta, device)
    model.rope_cos, model.rope_sin = cos, sin
    left = [n for n, p in model.named_parameters() if p.is_meta]
    if left:
        raise ValueError(f"no tensor given for {left[:4]}")
    _mark(model, cfg, mesh)
    return model


def _mark(model: Llama, cfg: LlamaConfig, mesh) -> None:
    """Attach the rank's :class:`ServingShard` to the model and its
    layers."""
    tp = mesh_tp(mesh)
    rank = coordinates(mesh)["tp"]
    attn = cfg.decode_tp_compatible(tp)
    vocab = None
    if cfg.vocab_size % tp == 0:
        per = cfg.vocab_size // tp
        vocab = (rank * per, (rank + 1) * per)
    cols = None
    if attn:
        hd = cfg.head_dim
        q_per = cfg.n_heads // tp * hd
        kv_per = cfg.n_kv_heads // tp * hd
        cols = {"wq": slice(rank * q_per, (rank + 1) * q_per),
                "wk": slice(rank * kv_per, (rank + 1) * kv_per),
                "wv": slice(rank * kv_per, (rank + 1) * kv_per)}
    shard = ServingShard(axis_group(mesh, "tp"), tp, attn,
                         cfg.ffn_dim % tp == 0, vocab, cols)
    model.serving_tp = shard
    for lp in model.layers:
        lp.serving_tp = shard


def _check_servable(cfg: LlamaConfig, tp: int) -> None:
    if tp > 1 and cfg.n_experts > 0:
        raise NotImplementedError(
            f"MoE presets under SERVE_TP={tp}: expert-sharded serving is "
            "not ported to the torch package (ROADMAP.md Queue A item "
            "8.5b)")


@torch.no_grad()
def shard_params_for_serving(params: Llama, cfg: LlamaConfig, mesh, *,
                             device=None, passes=()) -> Llama:
    """This rank's cut of a whole serving model (JAX
    ``shard_params_for_serving``): the training partition table
    (``models/llama.py`` ``partition_patterns``; heads, kv heads, mlp
    and vocab over ``tp``) with indivisible axes replicated, on a raw
    or an ``infer/quant.py``-quantized model alike (a quantized
    projection's codes cut with its kernel, its scales by columns only).
    Returns a new model on ``device`` (default: ``params``'s) whose
    every tensor is a contiguous copy; ``params`` is left as it is.
    ``passes`` (``infer/quant.py`` ``quant_passes``) quantizes each
    whole float projection they target before it is cut.  A mesh of tp
    1 returns ``params``."""
    tp = mesh_tp(mesh)
    if tp <= 1:
        return params
    _check_servable(cfg, tp)
    device = device or params.tok_embed.embedding.device

    def items():
        for name, mod in params.named_modules():
            if isinstance(mod, Dense):
                if mod.mode == "none":
                    yield name + ".kernel", mod.kernel.detach()
                else:
                    yield name + ".kernel", (mod.q, mod.s, mod.mode)
            else:
                for pname, p in mod.named_parameters(recurse=False):
                    yield f"{name}.{pname}", p.detach()

    return _cut_model(cfg, mesh, items(), device, passes)


@torch.no_grad()
def init_serving_shard(cfg: LlamaConfig, mesh, *, seed: int = 0,
                       device="cuda", passes=()) -> Llama:
    """This rank's cut of the fresh init :func:`~paddle_operator_tpu_
    torch.models.llama.make_model` draws from ``seed`` (the
    ``torch.Generator`` draws of ``Llama.init_weights``, tensor by
    tensor in its order, each whole tensor made on ``device`` in
    ``cfg.param_dtype``, quantized under ``passes`` and cut before the
    next is drawn): the same numbers as the whole model's, without ever
    holding it.  A mesh of tp 1 returns the whole model."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if mesh_tp(mesh) <= 1:
        from paddle_operator_tpu_torch.infer import quant as Q

        model = Llama(cfg, device).init_weights(gen)
        for mode, skip in passes:
            Q.quantize_params(model, cfg, mode=mode, skip=skip)
        return model
    _check_servable(cfg, mesh_tp(mesh))

    def items():
        for name, p in Llama(cfg, "meta").named_parameters():
            t = torch.empty(p.shape, dtype=cfg.param_dtype, device=device)
            if name.endswith("scale"):
                t.fill_(1.0)
            else:
                t.normal_(0.0, 0.02, generator=gen)
            yield name, t

    return _cut_model(cfg, mesh, items(), device, passes)


def _embed(cfg: LlamaConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    """The token embedding in the compute dtype: a rank of a serving
    mesh looks up its vocab rows and all-reduces
    (``collectives.serving_embed``)."""
    w = params.tok_embed.embedding.to(cfg.dtype)
    shard = _shard_of(params)
    if shard is None or shard.vocab is None:
        return w[tokens.long()]
    return C.serving_embed(w, tokens, shard.vocab[0], shard.group)


def _logits(cfg: LlamaConfig, params, x: torch.Tensor) -> torch.Tensor:
    """The final norm and the LM head: [..., dim] -> [..., vocab] f32.
    On a rank of a serving mesh the vocab-sharded head's logits are
    all-gathered along the vocab in the compute dtype (every rank then
    samples the same whole row)."""
    x = _rms(x, params.final_norm.scale, cfg.norm_eps, cfg.dtype)
    out = _mm(x, params.lm_head, cfg.dtype)
    shard = _shard_of(params)
    if shard is not None and shard.vocab is not None:
        out = C.gather_logits(out, shard.group)
    return out.float()


def _rms(x: torch.Tensor, scale: torch.Tensor, eps: float,
         dtype) -> torch.Tensor:
    """models/llama.py RMSNorm math, f32 internals."""
    xf = x.float()
    norm = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + eps)
    return (norm * scale.float()).to(dtype)


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
    allocation.  ``cfg`` is the whole model's; on a serving ``mesh``
    the buffers hold this rank's kv heads (:func:`alloc_kv_buffer`)."""
    max_len = max_len or cfg.max_seq_len
    if max_len > cfg.max_seq_len:
        raise ValueError(f"cache max_len {max_len} exceeds the RoPE table "
                         f"(cfg.max_seq_len={cfg.max_seq_len})")
    alloc = cache_alloc_len(max_len)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads, alloc, cfg.head_dim)
    return {
        "k": alloc_kv_buffer(cfg, shape, mesh, device=device),
        "v": alloc_kv_buffer(cfg, shape, mesh, device=device),
        "pos": 0,
    }


def _proj(cfg: LlamaConfig, lp, h: torch.Tensor, lora=None
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The q/k/v projections of the post-norm ``h`` [B, T, dim], plus
    each row's LoRA delta when ``lora=(adp_l, aid)`` (one layer's
    stacks and the per-row adapter slots): [B, T, out] each, before the
    head reshape."""
    q = _mm(h, lp.attn.wq, cfg.dtype)
    k = _mm(h, lp.attn.wk, cfg.dtype)
    v = _mm(h, lp.attn.wv, cfg.dtype)
    if lora is not None:
        shard = _shard_of(lp)
        q, k, v = lora_qkv(h, lora[0], lora[1], q, k, v, cfg.dtype,
                           cols=shard.lora_cols if shard else None)
    return q, k, v


def _qkv(cfg: LlamaConfig, lp, x: torch.Tensor, cos: torch.Tensor,
         sin: torch.Tensor, pos: int, lora=None
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pre-attention half of a decoder layer: RMSNorm -> q/k/v
    projections (+ the LoRA delta, :func:`_proj`) -> RoPE at offset
    ``pos``.  Shapes [B, T, H, D]."""
    b, t, _ = x.shape
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    h = _rms(x, lp.attn_norm.scale, cfg.norm_eps, cfg.dtype)
    q, k, v = _proj(cfg, lp, h, lora)
    q = q.reshape(b, t, hq, d)
    k = k.reshape(b, t, hkv, d)
    v = v.reshape(b, t, hkv, d)
    return _rope(q, cos, sin, pos), _rope(k, cos, sin, pos), v


def _expert_mm(x: torch.Tensor, w, e: int, dtype) -> torch.Tensor:
    """x @ expert ``e``'s slice of the MoE weight ``w``: a raw ``[E, in,
    out]`` parameter, or its quantized form (models/moe.py
    ``ExpertCodes``: codes ``[E, in, out]``, scales ``[E, 1, out]``),
    whose slices take ``quant_mm`` as any quantized projection does."""
    if isinstance(w, torch.Tensor):
        return x @ w[e].to(dtype)
    return quant_mm(x.to(dtype), w.q[e], w.s[e])


def _moe_ffn(cfg: LlamaConfig, mp, n: torch.Tensor) -> torch.Tensor:
    """Top-k MoE FFN at inference (``mp``: one layer's
    models/moe.py ``MoELayer``): exact conditional computation with NO
    capacity drop (the training layer's capacity buffer is a
    static-shape device, its drops an approximation, not the model).
    The router runs in f32, :func:`models.moe.route_top_k` picks the
    experts (the training layer's rule), every expert's GELU FFN runs
    over every token — static shapes, as a CUDA graph needs — and the
    gates combine the outputs through a ``[T, E]`` selection built by
    comparison (no ``one_hot``: its host-side index check would break
    graph capture)."""
    from paddle_operator_tpu_torch.models.moe import (expert_selection,
                                                      route_top_k)

    b, t, d = n.shape
    tokens = n.reshape(b * t, d)
    probs = torch.softmax(tokens.float() @ mp.router.kernel.float(), dim=-1)
    gates, topi = route_top_k(probs, cfg.moe_top_k)         # [T, k]
    outs = torch.stack([
        _expert_mm(torch.nn.functional.gelu(
            _expert_mm(tokens, mp.w1, e, cfg.dtype), approximate="tanh"),
            mp.w2, e, cfg.dtype)
        for e in range(cfg.n_experts)])                     # [E, T, D]
    sel = (expert_selection(topi, cfg.n_experts).float()
           * gates[..., None]).sum(1)                       # [T, E]
    out = torch.einsum("te,etd->td", sel.to(cfg.dtype), outs)
    return out.reshape(b, t, d)


def _ffn_residual(cfg: LlamaConfig, lp, x: torch.Tensor) -> torch.Tensor:
    """The FFN half of a decoder layer: norm -> (SwiGLU or MoE) -> +x."""
    n = _rms(x, lp.mlp_norm.scale, cfg.norm_eps, cfg.dtype)
    if cfg.n_experts > 0:
        return x + _moe_ffn(cfg, lp.moe, n)
    gate = _mm(n, lp.mlp.w1, cfg.dtype)
    up = _mm(n, lp.mlp.w3, cfg.dtype)
    y = _mm(torch.nn.functional.silu(gate) * up, lp.mlp.w2, cfg.dtype)
    shard = _shard_of(lp)
    if shard is not None and shard.mlp:
        y = C.reduce_partials(y, shard.group)   # w2's rows: the sum
    return x + y


def _finish_layer(cfg: LlamaConfig, lp, x: torch.Tensor,
                  out: torch.Tensor) -> torch.Tensor:
    """Post-attention half: output projection + residual, then the
    (dense SwiGLU or MoE) FFN + residual.  On a rank of a serving mesh
    whose heads are cut, wo's partial outputs (the rank's rows) are
    summed over tp before the residual add."""
    y = _mm(out, lp.attn.wo, cfg.dtype)
    shard = _shard_of(lp)
    if shard is not None and shard.attn:
        y = C.reduce_partials(y, shard.group)
    return _ffn_residual(cfg, lp, x + y)


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
           pos: int, lora=None) -> torch.Tensor:
    """One decoder layer over [B, T] new positions starting at ``pos``,
    attending to the cache's [0, pos+T) with plain einsum attention.
    Writes this layer's cache ([B, H_kv, S, D]) in place; returns y."""
    b, t, _ = x.shape
    hq, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k, v = _qkv(cfg, lp, x, cos, sin, pos, lora)
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
    each layer's attention and wo through ops/decode_attention.py
    ``sharded_decode_attention`` on the stacked cache (kernel #1 at
    ``layer=li``, then wo; on a rank whose heads are cut, its heads and
    wo's rows, then one all-reduce in the compute dtype); everything
    else (prefill, or the plain selection) runs :func:`_layer`'s
    einsums.

    ``last_only``: apply the norm + lm head to the final position only
    (logits [B, 1, vocab]) — prefill needs just the next-token logits.

    ``lora``: ``(stacks, aid)`` — the registry's stacked [L, ...]
    adapter tensors and per-row adapter slots [B] (infer/qos.py); each
    layer reads its own slice of the stacks.

    ``mesh``: a serving mesh (``parallel/mesh.py`` ``make_serving_mesh``)
    makes the forward tensor-parallel: ``params`` is this rank's cut,
    ``cache`` holds its kv heads (``init_cache(mesh=...)``), ``cfg`` is
    the whole model's.  A config whose kv heads do not split keeps
    whole heads and wo on every rank (JAX's fallback, :func:`_attn_group`).
    """
    if mesh is not None:
        _require_shard(params, mesh)
    pos = cache["pos"]
    k_cache, v_cache = cache["k"], cache["v"]
    x = _embed(cfg, params, tokens)
    cos, sin = params.rope_cos, params.rope_sin
    b, t = tokens.shape
    cfg = _local(cfg, params)
    shard = _shard_of(params)

    if t == 1 and cfg.resolved_decode_attn(x.device) == "kernel":
        group = _attn_group(shard)
        lengths = torch.full((b,), pos + 1, dtype=torch.int32,
                             device=x.device)
        for li, lp in enumerate(params.layers):
            q, k, v = _qkv(cfg, lp, x, cos, sin, pos, layer_lora(lora, li))
            _write_kv(k_cache[li], v_cache[li], k, v, pos)
            proj = sharded_decode_attention(
                q[:, 0].contiguous(), k_cache, v_cache, lengths,
                lp.attn.wo, group=group, layer=li, compute_dtype=cfg.dtype)
            x = _ffn_residual(cfg, lp, x + proj[:, None].to(cfg.dtype))
    else:
        for li, lp in enumerate(params.layers):
            x = _layer(cfg, lp, x, cos, sin, k_cache[li], v_cache[li], pos,
                       layer_lora(lora, li))
    if last_only:
        x = x[:, -1:]
    logits = _logits(cfg, params, x)
    return logits, {"k": k_cache, "v": v_cache, "pos": pos + t}


def prefill(params: Llama, cfg: LlamaConfig, tokens: torch.Tensor,
            max_len: Optional[int] = None, mesh=None, lora=None
            ) -> Tuple[torch.Tensor, Dict[str, object]]:
    """Process the whole prompt [B, S] in one pass (``lora``: as
    :func:`_forward`).  Returns ([B, vocab] last-position logits, filled
    cache)."""
    cache_len = max_len or cfg.max_seq_len
    if tokens.shape[1] > cache_len:
        raise ValueError(f"prompt length {tokens.shape[1]} exceeds the "
                         f"cache ({cache_len} positions)")
    cache = init_cache(cfg, tokens.shape[0], max_len, device=tokens.device,
                       mesh=mesh)
    logits, cache = _forward(cfg, params, tokens, cache, last_only=True,
                             mesh=mesh, lora=lora)
    return logits[:, 0], cache


def paged_prefill(params: Llama, cfg: LlamaConfig, tokens: torch.Tensor,
                  pool_cache: Dict[str, torch.Tensor],
                  table_row: torch.Tensor, *,
                  block_size: Optional[int] = None,
                  last_only: bool = False, quant: bool = False,
                  prompt_len: Optional[int] = None, lora=None):
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
    opens a fresh block and those rows sit behind the fill mask.
    ``lora``: as :func:`_forward` (an adapter lane's KV)."""
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
    logits, lane = _forward(cfg, params, tokens, lane, last_only=last_only,
                            lora=lora)
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
                cache: Dict[str, object], mesh=None, lora=None
                ) -> Tuple[torch.Tensor, Dict[str, object]]:
    """One token [B] -> next-position logits [B, vocab] + advanced cache
    (the cache tensors are updated in place)."""
    logits, cache = _forward(cfg, params, token[:, None], cache, mesh=mesh,
                             lora=lora)
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
             eos_token: Optional[int] = None, mesh=None,
             lora=None) -> torch.Tensor:
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
    max_new_tokens - 1 decode steps (n_layers kernel launches each).

    ``lora``: ``(stacks, aid [B])`` — every row's prefill and decode
    steps add its adapter's delta (the ring's rule, infer/qos.py).

    ``mesh``: a serving mesh; ``params`` is then this rank's cut
    (:func:`shard_params_for_serving`) and every rank of the mesh calls
    this with the same arguments (a sampling ``generator`` seeded alike:
    each rank samples the same gathered logits)."""
    if temperature > 0 and generator is None:
        generator = torch.Generator(device=prompt.device)
        generator.manual_seed(0)
    need = prompt.shape[1] + max_new_tokens
    cache_len = max_len or cfg.max_seq_len
    if need > cache_len:
        raise ValueError(f"prompt ({prompt.shape[1]}) + max_new_tokens "
                         f"({max_new_tokens}) = {need} exceeds the cache "
                         f"({cache_len} positions)")

    logits, cache = prefill(params, cfg, prompt, max_len, mesh=mesh,
                            lora=lora)
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
            logits, cache = decode_step(params, cfg, tok, cache, mesh=mesh,
                                        lora=lora)
    if not toks:
        return prompt
    return torch.cat([prompt, torch.stack(toks, dim=1)], dim=1)
