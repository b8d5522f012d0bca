"""LLaMA-family decoder in PyTorch — the port of
``paddle_operator_tpu/models/llama.py``.

Same math as the flax model: RMSNorm with f32 internals, GQA attention
with the split-halves ("rotate-half") RoPE, SwiGLU, f32 logits.  Same
parameter names and orientations, so a flax param tree converts leaf
for leaf (``convert.params_from_jax``):

- every projection is a :class:`Dense` holding ``kernel`` as
  ``[in, out]`` (flax's DenseGeneral orientation, NOT ``nn.Linear``'s
  ``[out, in]``), applied as ``x @ kernel``;
- the scanned ``layers`` stack of the flax model is unstacked here into
  ``layers.<i>`` submodules (``nn.ModuleList``) — the state-dict key of
  a leaf is its flax path with ``/`` -> ``.`` and the layer index
  inserted after ``layers``.

Initialization mirrors flax: ``normal(0.02)`` for projections and the
embedding, ones for the norm scales, drawn from an explicit
``torch.Generator`` (the values differ from ``jax.random``'s — tests
convert the JAX init instead of comparing inits).

Training: :meth:`Llama.forward` takes packed-sequence ``segment_ids``
and runs attention through ``ops/attention.py`` ``attention`` (the flash
kernels on the card).  With ``remat`` (the JAX default) every decoder
layer runs under ``torch.utils.checkpoint.checkpoint(use_reentrant=False)``
while gradients are recorded, and ``remat_policy`` says what the
backward recomputes, as the JAX package's ``_layer_cls`` policies do:

- ``"full"`` (``nothing_saveable``): the whole layer, the flash forward
  included (it launches twice a layer a step);
- ``"save_attn"`` (``save_only_these_names("attn_out")``): everything but
  the attention: each operation inside the attention call is kept (on
  the card that is one operator, the flash forward, whose output and
  logsumexp are kept), so the flash forward launches once;
- ``"dots"`` (``dots_with_no_batch_dims_saveable``): everything but the
  outputs of matrix products without batch dimensions (``aten.mm``: the
  projections; attention's batched products and the flash forward are
  recomputed).

The last two run ``torch.utils.checkpoint``'s selective policy
(``create_selective_checkpoint_contexts``), which sees dispatcher
operations: that is why the flash forward is a ``torch.library``
operator (ops/flash_attention.py).  ``scan_layers`` is not a field
here, so a caller that sets it gets a ``TypeError`` (layers are always
separate modules).

MoE configs (``n_experts > 0``): each layer's FFN is a
:class:`models.moe.MoELayer` mounted as ``moe`` (no ``mlp``), and
:meth:`Llama.forward` returns ``(logits, aux)``, the layers' summed
load-balancing losses times ``moe_aux_weight`` — the pair the JAX
model returns; every layer returns ``(x, aux)`` (aux None for a dense
FFN), so the per-layer checkpoint carries the pair.

On a mesh (``train/trainer.py`` ``create_state(mesh=...)``) every
parameter is a DTensor shard laid out by :func:`partition_patterns`
(the JAX package's specs).  The modules gather a weight over fsdp where
they use it, and under tp run Megatron's pairs (``parallel/
collectives.py``): wq/wk/wv and w1/w3 are column shards, wo and w2 the
matching row shards, so attention runs on the rank's own heads through
the flash kernels (whole GQA groups: :func:`check_tp`), the embedding
looks up the rank's vocab rows and ``lm_head`` gives its vocab slice of
the logits.  Unsharded, each of these is the single-device operation.

Context parallelism (a mesh whose ``cp`` axis is above 1): each rank
holds a contiguous chunk of the sequence, RoPE takes the chunk's
absolute offset, and attention runs over the whole sequence as JAX's
``Attention`` dispatches it: ``cp_impl`` "ring"
(``parallel/ring_attention.py``) or "ulysses"
(``parallel/ulysses.py``, when ``cp`` divides ``n_heads`` and
``n_kv_heads``; ring otherwise); another ``cp_impl`` raises.

Pipeline parallelism (``pp`` above 1): a rank holds only its stage's
layers, a contiguous block; the others are :class:`OtherStage`
placeholders without parameters, so the state dict names the layers the
rank holds under their global indices.  The pipeline train step
(``train/trainer.py`` ``make_pp_train_step``) runs the stage through
:class:`LayerStack` (JAX's ``LayerStack``: the same per-layer remat as
:meth:`Llama.forward`) and the embedding and head through
:meth:`Llama.embed` and :meth:`Llama.head` (JAX's standalone
``embed_module``, ``final_norm_module`` and ``lm_head_module``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import re
import threading
from typing import Any, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from paddle_operator_tpu_torch.ops.attention import attention
from paddle_operator_tpu_torch.ops.quant_matmul import quant_mm
from paddle_operator_tpu_torch.parallel.ring_attention import ring_attention
from paddle_operator_tpu_torch.parallel.ulysses import (kv_repeat,
                                                        ulysses_attention)
from paddle_operator_tpu_torch.parallel.collectives import (
    copy_over, cp_group, gather_param, sum_over, tp_group,
    vocab_parallel_embed)

@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """The JAX package's LlamaConfig, own copy, with torch dtypes."""

    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    ffn_dim: int = 11008
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: Any = torch.bfloat16        # compute dtype
    param_dtype: Any = torch.float32   # storage dtype
    # recompute each decoder layer in the backward
    remat: bool = True
    # what the recompute may skip: "full" (nothing), "save_attn" (the
    # attention), "dots" (the projections' outputs); module docstring
    remat_policy: str = "full"
    # context-parallel attention when cp > 1: "ring" (K/V rotation,
    # parallel/ring_attention.py) or "ulysses" (head/seq all-to-all,
    # parallel/ulysses.py — needs n_heads and n_kv_heads divisible by
    # cp; ring otherwise)
    cp_impl: str = "ring"
    n_experts: int = 0
    moe_capacity_factor: float = 1.25
    moe_top_k: int = 1
    moe_aux_weight: float = 0.01
    # single-query attention for the DECODE path (infer/decode.py):
    # "auto" (the CUDA kernel on a CUDA tensor, the plain version on a
    # CPU tensor), "kernel" (ops/decode_attention.py decode_attention —
    # reads only the FILLED prefix), "plain" (the einsum over the cache,
    # infer/decode.py _layer; the JAX package's "xla")
    decode_attn: str = "auto"

    def resolved_decode_attn(self, device: torch.device) -> str:
        """Resolve "auto" for tensors on ``device``: the kernel on CUDA,
        the plain einsum elsewhere.  Unlike the TPU rule there is no
        head_dim gate — the 128-lane limit was Mosaic's; the CUDA
        kernel takes any head_dim that is a multiple of 8 up to 256."""
        if self.decode_attn == "auto":
            return "kernel" if torch.device(device).type == "cuda" \
                else "plain"
        if self.decode_attn not in ("kernel", "plain"):
            raise ValueError(f"unknown decode_attn {self.decode_attn!r} "
                             "(expected 'auto', 'kernel' or 'plain')")
        return self.decode_attn

    def draft(self, **overrides) -> "LlamaConfig":
        """The companion draft config for speculative decoding
        (infer/speculative.py): depth/4 and heads/2 at the SAME
        head_dim, the GQA grouping kept, sharing everything that couples
        draft to target — vocab, RoPE table, dtypes, decode-attention
        choice.  Only token ids cross between the two models, so the
        vocab is the one compatibility invariant
        (``speculative.check_draft_compat``).  ``overrides`` replace any
        field of the derived config."""
        n_heads = max(1, self.n_heads // 2)
        n_kv = max(1, self.n_kv_heads // 2)
        while n_heads % n_kv:       # the GQA grouping survives the halving
            n_kv -= 1
        kw = dict(n_layers=max(1, self.n_layers // 4), n_heads=n_heads,
                  n_kv_heads=n_kv, dim=self.head_dim * n_heads,
                  ffn_dim=max(self.head_dim, self.ffn_dim // 2))
        kw.update(overrides)
        return dataclasses.replace(self, **kw)

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def decode_tp_compatible(self, tp: int) -> bool:
        """Whether the decode kernels can run tensor-parallel over ``tp``
        shards (JAX ``LlamaConfig.decode_tp_compatible``): the kv-head
        axis must split evenly, so each shard contracts WHOLE GQA groups
        (the query heads then split with it).  A config that fails this
        serves sharded with its attention whole on every rank, through
        the plain einsum attention (the JAX package's GSPMD einsum
        fallback)."""
        return tp <= 1 or (self.n_kv_heads % tp == 0
                           and self.n_heads % tp == 0)

    def flops_per_token(self) -> float:
        """Approximate training FLOPs/token (fwd+bwd ~ 6 N_active +
        attention), for MFU."""
        attn = 12 * self.n_layers * self.dim * self.max_seq_len
        return 6 * self.active_params() + attn

    def active_params(self) -> int:
        """Params touched per token: num_params() for dense configs; for
        MoE the router plus the moe_top_k experts a token is routed
        to."""
        if self.n_experts <= 0:
            return self.num_params()
        d, f = self.dim, self.ffn_dim
        all_experts = self.n_experts * 2 * d * f
        active = self.moe_top_k * 2 * d * f
        return self.num_params() - self.n_layers * (all_experts - active)

    def num_params(self) -> int:
        d, f, v = self.dim, self.ffn_dim, self.vocab_size
        if self.n_experts > 0:
            ffn = d * self.n_experts + self.n_experts * 2 * d * f
        else:
            ffn = 3 * d * f                            # w1, w2, w3 (SwiGLU)
        per_layer = (
            d * self.n_heads * self.head_dim           # wq
            + 2 * d * self.n_kv_heads * self.head_dim  # wk, wv
            + self.n_heads * self.head_dim * d         # wo
            + ffn
            + 2 * d                                    # norms
        )
        return v * d + self.n_layers * per_layer + d + d * v


@dataclasses.dataclass(frozen=True)
class ServingShardConfig(LlamaConfig):
    """The config one rank of a tensor-parallel serving mesh runs the
    decode path with (:func:`serving_shard_config`): ``n_heads`` and
    ``n_kv_heads`` are the rank's own (the model's divided by ``tp``) at
    the model's ``head_dim`` (``full_heads`` keeps the model's query-head
    count); every other field is the model's.  The KV caches, the
    projections' reshapes and the decode kernels then work on the rank's
    heads as they work on a whole model's."""

    full_heads: int = 0
    tp: int = 1

    @property
    def head_dim(self) -> int:
        return self.dim // self.full_heads


def serving_shard_config(cfg: LlamaConfig, tp: int) -> LlamaConfig:
    """``cfg`` as one rank of a ``tp``-way serving mesh runs it: ``cfg``
    itself at tp 1; the rank's heads (:class:`ServingShardConfig`) when
    the kv heads split (``decode_tp_compatible``); else ``cfg`` with the
    plain einsum attention over the whole heads, which every rank then
    holds (the JAX package's fallback for indivisible kv heads)."""
    if tp <= 1 or isinstance(cfg, ServingShardConfig):
        return cfg
    if not cfg.decode_tp_compatible(tp):
        return dataclasses.replace(cfg, decode_attn="plain")
    fields = {f.name: getattr(cfg, f.name)
              for f in dataclasses.fields(LlamaConfig)}
    fields.update(n_heads=cfg.n_heads // tp,
                  n_kv_heads=cfg.n_kv_heads // tp)
    return ServingShardConfig(**fields, full_heads=cfg.n_heads, tp=tp)


# Presets: the JAX package's, same names and shapes.
CONFIGS = {
    "tiny": LlamaConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                        n_kv_heads=2, ffn_dim=128, max_seq_len=128),
    "tiny-moe": LlamaConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                            n_kv_heads=2, ffn_dim=128, max_seq_len=128,
                            n_experts=4),
    "tiny-moe2": LlamaConfig(vocab_size=256, dim=64, n_layers=2, n_heads=4,
                             n_kv_heads=2, ffn_dim=128, max_seq_len=128,
                             n_experts=4, moe_top_k=2),
    "1b": LlamaConfig(vocab_size=32000, dim=2048, n_layers=16, n_heads=16,
                      n_kv_heads=16, ffn_dim=5504),
    "7b": LlamaConfig(),
    "7b-moe": LlamaConfig(n_experts=8),
    "7b-moe2": LlamaConfig(n_experts=8, moe_top_k=2),
    "13b": LlamaConfig(dim=5120, n_layers=40, n_heads=40, n_kv_heads=40,
                       ffn_dim=13824),
}


REMAT_POLICIES = ("full", "save_attn", "dots")
# the matrix product with no batch dimensions (what "dots" keeps)
_DOT = torch.ops.aten.mm.default
_scope = threading.local()


@contextlib.contextmanager
def _attention_scope():
    """Marks the operations of one attention call for the "save_attn"
    policy (thread-local: the recompute may run on the backward's
    thread, and it passes through here again)."""
    _scope.on = True
    try:
        yield
    finally:
        _scope.on = False


def _save_attn(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if getattr(_scope, "on", False)
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op == _DOT
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_context(policy: str):
    """``checkpoint``'s ``context_fn`` for ``policy`` (None: "full")."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r} (expected one "
                         f"of {REMAT_POLICIES})")
    if policy == "full":
        return None
    return functools.partial(create_selective_checkpoint_contexts,
                             _save_attn if policy == "save_attn"
                             else _save_dots)


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def _param(shape, cfg: LlamaConfig, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype,
                                    device=device))


class Dense(nn.Module):
    """flax DenseGeneral without bias: ``kernel`` [in, out], computed in
    the compute dtype.

    Its weight-only quantized form (infer/quant.py ``quantize_params``)
    holds, instead of ``kernel``, the JAX package's ``{"q", "s"}`` leaf
    as two buffers — the codes ``q`` [in, out] int8 (int4 codes as int8
    values in [-7, 7]) and the scales ``s`` [1, out] f32 — and its
    ``mode`` ("int8" or "int4"; "none" unquantized).  As buffers they
    move with ``.to(device)`` and sit in the ``state_dict``; a CUDA graph
    captured afterwards reads them at their addresses."""

    def __init__(self, cfg: LlamaConfig, n_in: int, n_out: int,
                 device=None) -> None:
        super().__init__()
        self.dtype = cfg.dtype
        self.mode = "none"
        self.kernel = _param((n_in, n_out), cfg, device)

    def set_quantized(self, q: torch.Tensor, s: torch.Tensor,
                      mode: str) -> None:
        """Replace ``kernel`` by the codes ``q`` and scales ``s``,
        releasing the kernel's tensor."""
        del self.kernel
        self.register_buffer("q", q)
        self.register_buffer("s", s)
        self.mode = mode

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        if self.mode != "none":
            return quant_mm(x, self.q, self.s)
        return x @ gather_param(self.kernel).to(self.dtype)


def _tp_groups(dense: Dense) -> tuple:
    """The groups ``copy_over``/``sum_over`` take around ``dense``'s tp
    block: the ``tp`` group that shards its kernel, or none."""
    tp = tp_group(getattr(dense, "kernel", None))
    return () if tp is None else (tp[0],)


class Embed(nn.Module):
    """flax Embed: ``embedding`` [vocab, dim], gathered in the compute
    dtype."""

    def __init__(self, cfg: LlamaConfig, device=None) -> None:
        super().__init__()
        self.dtype = cfg.dtype
        self.embedding = _param((cfg.vocab_size, cfg.dim), cfg, device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        weight = gather_param(self.embedding).to(self.dtype)
        tp = tp_group(self.embedding)
        if tp is not None:
            return vocab_parallel_embed(weight, tokens, tp)
        return weight[tokens]


class RMSNorm(nn.Module):
    def __init__(self, cfg: LlamaConfig, dim: int, device=None) -> None:
        super().__init__()
        self.eps = cfg.norm_eps
        self.dtype = cfg.dtype
        self.scale = _param((dim,), cfg, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        norm = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + self.eps)
        return (norm * gather_param(self.scale).float()).to(self.dtype)


def rope_frequencies(head_dim: int, max_len: int, theta: float,
                     device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """[max_len, head_dim/2] f32 cos/sin tables."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    freqs = torch.outer(t, inv)          # [S, D/2]
    return torch.cos(freqs), torch.sin(freqs)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               offset: int = 0) -> torch.Tensor:
    """[B, S, H, D] rotary embedding, half-split formulation (the head
    dim splits into two contiguous halves, not interleaved pairs)."""
    seq = x.shape[1]
    cos = cos[offset:offset + seq][None, :, None, :]
    sin = sin[offset:offset + seq][None, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


class Attention(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        hd = cfg.head_dim
        self.wq = Dense(cfg, cfg.dim, cfg.n_heads * hd, device)
        self.wk = Dense(cfg, cfg.dim, cfg.n_kv_heads * hd, device)
        self.wv = Dense(cfg, cfg.dim, cfg.n_kv_heads * hd, device)
        self.wo = Dense(cfg, cfg.n_heads * hd, cfg.dim, device)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        cfg = self.cfg
        b, s, _ = x.shape
        # under tp the projections hold this rank's heads (column shards
        # of wq/wk/wv, row shard of wo): attention runs on local heads
        tp = _tp_groups(self.wq)
        x = copy_over(x, tp)
        q = self.wq(x).reshape(b, s, -1, cfg.head_dim)
        k = self.wk(x).reshape(b, s, -1, cfg.head_dim)
        v = self.wv(x).reshape(b, s, -1, cfg.head_dim)
        # under cp this rank holds chunk cp[1] of the sequence: RoPE
        # takes its absolute positions
        cp = cp_group(getattr(self.wq, "kernel", None))
        offset = 0 if cp is None else cp[1] * s
        q = apply_rope(q, cos, sin, offset)
        k = apply_rope(k, cos, sin, offset)
        with _attention_scope():
            if cp is None:
                out = attention(q, k, v, causal=True,
                                segment_ids=segment_ids)
            elif cp_attention(cfg, cp[2]) == "ulysses":
                out = ulysses_attention(q, k, v, segment_ids, cp=cp)
            else:
                out = ring_attention(q, k, v, segment_ids, cp=cp)
        return sum_over(self.wo(out.reshape(b, s, -1)), tp)


def cp_attention(cfg: LlamaConfig, cp: int) -> str:
    """The attention a layer runs over a ``cp`` axis of size ``cp`` > 1
    (JAX ``Attention``'s dispatch): "ulysses" when ``cfg.cp_impl`` asks
    for it and ``cp`` divides ``n_heads`` and ``n_kv_heads``, else
    "ring".  An unknown ``cp_impl`` raises ``ValueError``."""
    if cfg.cp_impl not in ("ring", "ulysses"):
        raise ValueError(f"unknown cp_impl {cfg.cp_impl!r} "
                         "(expected 'ring' or 'ulysses')")
    if (cfg.cp_impl == "ulysses" and cfg.n_heads % cp == 0
            and cfg.n_kv_heads % cp == 0):
        return "ulysses"
    return "ring"


class MLP(nn.Module):
    """SwiGLU feed-forward."""

    def __init__(self, cfg: LlamaConfig, device=None) -> None:
        super().__init__()
        self.w1 = Dense(cfg, cfg.dim, cfg.ffn_dim, device)
        self.w3 = Dense(cfg, cfg.dim, cfg.ffn_dim, device)
        self.w2 = Dense(cfg, cfg.ffn_dim, cfg.dim, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # under tp: w1/w3 column shards, w2 the matching row shard
        tp = _tp_groups(self.w1)
        x = copy_over(x, tp)
        return sum_over(
            self.w2(torch.nn.functional.silu(self.w1(x)) * self.w3(x)), tp)


class DecoderLayer(nn.Module):
    """Attention and FFN halves, each behind an RMSNorm and a residual.
    The FFN is SwiGLU (``mlp``) or, with ``n_experts > 0``, a
    :class:`models.moe.MoELayer` (``moe``)."""

    def __init__(self, cfg: LlamaConfig, device=None) -> None:
        super().__init__()
        self.attn_norm = RMSNorm(cfg, cfg.dim, device)
        self.attn = Attention(cfg, device)
        self.mlp_norm = RMSNorm(cfg, cfg.dim, device)
        if cfg.n_experts > 0:
            from paddle_operator_tpu_torch.models.moe import (MoEConfig,
                                                              MoELayer)

            self.moe = MoELayer(MoEConfig(
                dim=cfg.dim, ffn_dim=cfg.ffn_dim, n_experts=cfg.n_experts,
                capacity_factor=cfg.moe_capacity_factor,
                top_k=cfg.moe_top_k, dtype=cfg.dtype,
                param_dtype=cfg.param_dtype), device)
        else:
            self.mlp = MLP(cfg, device)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """-> ``(y, aux)``: aux is the MoE layer's load-balancing loss,
        None for a dense FFN."""
        h = x + self.attn(self.attn_norm(x), cos, sin, segment_ids)
        normed = self.mlp_norm(h)
        if hasattr(self, "moe"):
            ffn, aux = self.moe(normed)
        else:
            ffn, aux = self.mlp(normed), None
        return h + ffn, aux


class OtherStage(nn.Module):
    """The place of layer ``index`` on a rank of another pipeline stage
    (``stage``): no parameters, and running it raises."""

    def __init__(self, index: int, stage: int) -> None:
        super().__init__()
        self.index, self.stage = index, stage

    def forward(self, *args, **kwargs):
        raise RuntimeError(f"layer {self.index} lives on pp stage "
                           f"{self.stage}: a pp-sharded model runs through "
                           "the pipeline step (train/trainer.py "
                           "make_pp_train_step)")


def _run_layers(cfg: LlamaConfig, layers, x: torch.Tensor,
                cos: torch.Tensor, sin: torch.Tensor,
                segment_ids: Optional[torch.Tensor]):
    """``layers`` in turn, each under the per-layer checkpoint of
    ``cfg.remat`` while gradients are recorded -> ``(x, aux)``: the
    layers' summed MoE load-balancing losses, None for dense FFNs."""
    remat = cfg.remat and torch.is_grad_enabled()
    extra = {}
    context = _remat_context(cfg.remat_policy)
    if context is not None:
        extra["context_fn"] = context
    aux_sum = None
    for layer in layers:
        if remat:
            x, aux = checkpoint(layer, x, cos, sin, segment_ids,
                                use_reentrant=False, **extra)
        else:
            x, aux = layer(x, cos, sin, segment_ids)
        if aux is not None:
            aux_sum = aux if aux_sum is None else aux_sum + aux
    return x, aux_sum


class LayerStack(nn.Module):
    """The decoder trunk alone: a contiguous block of a model's
    :class:`DecoderLayer` s under the same per-layer remat as
    :meth:`Llama.forward` (JAX ``LayerStack``).  A pipeline stage runs
    its block through it; its parameters are the block's.  Returns
    ``(x, aux)`` as JAX's does (aux None for dense configs).  The RoPE
    tables are the caller's (:attr:`Llama.rope_cos`/``rope_sin``)."""

    def __init__(self, cfg: LlamaConfig, layers) -> None:
        super().__init__()
        self.cfg = cfg
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None):
        return _run_layers(self.cfg, self.layers, x, cos, sin, segment_ids)


class Llama(nn.Module):
    """``tokens [B, S]`` int -> ``[B, S, vocab]`` f32 logits (the
    training forward; decoding goes through infer/decode.py over the
    same parameters).  The RoPE tables ride as non-persistent f32
    buffers, so the decode path reads them without recomputing."""

    def __init__(self, cfg: LlamaConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        self.tok_embed = Embed(cfg, device)
        self.layers = nn.ModuleList(DecoderLayer(cfg, device)
                                    for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(cfg, cfg.dim, device)
        self.lm_head = Dense(cfg, cfg.dim, cfg.vocab_size, device)
        cos, sin = rope_frequencies(cfg.head_dim, cfg.max_seq_len,
                                    cfg.rope_theta, device)
        self.register_buffer("rope_cos", cos, persistent=False)
        self.register_buffer("rope_sin", sin, persistent=False)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "Llama":
        """flax's initializers: normal(0.02) kernels and embedding, ones
        for norm scales.  ``generator`` must live on the params'
        device."""
        for name, p in self.named_parameters():
            if name.endswith("scale"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, 0.02, generator=generator)
        return self

    def forward(self, tokens: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None):
        """``segment_ids`` [B, S]: packed documents; attention is masked
        across them, RoPE positions stay absolute.  Returns the logits,
        or for an MoE config ``(logits, aux)``: the layers' summed
        load-balancing losses times ``moe_aux_weight``, which the
        trainer adds to the task loss.  A model sharded over a mesh
        (``train/trainer.py`` ``create_state(mesh=...)``) takes this
        rank's rows and, under tp, returns its vocab slice of the
        logits."""
        x, aux_sum = _run_layers(self.cfg, self.layers, self.embed(tokens),
                                 self.rope_cos, self.rope_sin, segment_ids)
        logits = self.head(x)
        if self.cfg.n_experts > 0:
            return logits, aux_sum * self.cfg.moe_aux_weight
        return logits

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """The token embedding alone (JAX ``embed_module``)."""
        return self.tok_embed(tokens)

    def head(self, x: torch.Tensor) -> torch.Tensor:
        """The final norm and the LM head alone (JAX
        ``final_norm_module`` and ``lm_head_module``): f32 logits; under
        tp this rank's vocab slice, ``[..., V/tp]``."""
        x = self.final_norm(x)
        x = copy_over(x, _tp_groups(self.lm_head))
        return self.lm_head(x).float()

    def stage_layers(self) -> LayerStack:
        """The layers this rank holds (all of them unless pp-sharded),
        as a :class:`LayerStack`."""
        return LayerStack(self.cfg, [m for m in self.layers
                                     if not isinstance(m, OtherStage)])


def make_model(preset: str = "tiny", *, device="cuda", seed: int = 0,
               **overrides) -> Tuple[Llama, LlamaConfig]:
    """Build and initialize a preset on ``device`` (the card unless the
    caller asks otherwise) from ``torch.Generator`` seed ``seed``.
    ``overrides`` replace config fields (``dtype=torch.float32`` for
    f32 tests, ``param_dtype=torch.bfloat16`` to init straight into the
    serving dtype).  The JAX signature's ``mesh`` is not a parameter: a
    model is sharded over a mesh after its init (``train/trainer.py``
    ``create_state``), and its layers read the ``cp`` axis (context
    parallelism) from their parameters' mesh."""
    cfg = dataclasses.replace(CONFIGS[preset], **overrides)
    _remat_context(cfg.remat_policy)           # an unknown policy raises
    device = torch.device(device)
    model = Llama(cfg, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model.init_weights(gen)
    return model, cfg


# The JAX package's _LAYER_PATTERNS keyed on the port's state-dict names
# (its scanned "layers" axis is unstacked here, so no "layers" prefix)
_LAYER_PATTERNS = [
    (r"attn\.wq\.kernel", ("embed", "heads")),
    (r"attn\.wk\.kernel", ("embed", "heads")),
    (r"attn\.wv\.kernel", ("embed", "heads")),
    (r"attn\.wo\.kernel", ("heads", "embed")),
    (r"mlp\.w1\.kernel", ("embed", "mlp")),
    (r"mlp\.w3\.kernel", ("embed", "mlp")),
    (r"mlp\.w2\.kernel", ("mlp", "embed")),
    (r"attn_norm\.scale", ("embed",)),
    (r"mlp_norm\.scale", ("embed",)),
]


def partition_patterns(cfg: LlamaConfig):
    """(name-regex, logical spec) table for
    ``parallel/sharding.py`` ``tree_shardings``: the JAX package's
    specs on the port's names (a layer's leading ``layers`` dim, pp
    under pipeline parallelism, is its stage: :func:`layer_stage`).  An
    MoE config adds ``models/moe.py``'s rows under ``moe`` (the expert
    dim over ``ep``)."""
    layer_pats = list(_LAYER_PATTERNS)
    if cfg.n_experts > 0:
        from paddle_operator_tpu_torch.models.moe import (
            moe_partition_patterns)

        layer_pats += moe_partition_patterns()
    return [
        (r"tok_embed\.embedding", ("vocab", "embed")),
        (r"final_norm\.scale", ("embed",)),
        (r"lm_head\.kernel", ("embed", "vocab")),
    ] + layer_pats


def check_moe(cfg: LlamaConfig, cp: int) -> None:
    """Refuse an MoE config on a ``cp`` axis above 1 by name: the global
    token order interleaves each row's cp chunks, so the capacity
    positions need another prefix of the counts (ROADMAP.md Queue A
    item 8.6)."""
    if cfg.n_experts > 0 and cp > 1:
        raise NotImplementedError(
            f"MoE models with cp={cp}: the capacity positions over a "
            "sequence split into cp chunks are not ported to the torch "
            "package (ROADMAP.md Queue A item 8.6, 'Parallelism')")


def check_tp(cfg: LlamaConfig, tp: int) -> None:
    """Refuse a tp that splits a GQA group: with contiguous head shards,
    query head h of shard s reads kv head h // n_rep on the same shard
    only when tp divides both head counts."""
    if cfg.n_heads % tp or cfg.n_kv_heads % tp:
        raise ValueError(
            f"tp={tp} must divide n_heads={cfg.n_heads} and n_kv_heads="
            f"{cfg.n_kv_heads}: a shard's query heads must find their kv "
            "heads (whole GQA groups) on the same shard")


def layer_index(name: str) -> Optional[int]:
    """The layer a state-dict name belongs to (``layers.<i>.…``), or
    None for the embedding, the final norm and the head."""
    m = re.match(r"layers\.(\d+)\.", name)
    return None if m is None else int(m.group(1))


def layer_stage(cfg: LlamaConfig, index: int, pp: int) -> int:
    """The pipeline stage holding layer ``index``: stage *s* holds layers
    ``[s·L/pp, (s+1)·L/pp)`` (JAX's ``layers → pp`` sharding of the
    stacked axis).  ``n_layers`` not divisible by ``pp`` raises JAX's
    ``ValueError``."""
    if cfg.n_layers % pp:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by "
                         f"pp={pp}")
    return index // (cfg.n_layers // pp)


def check_cp(cfg: LlamaConfig, cp: int, tp: int) -> None:
    """Refuse, before any step, what the attention over a ``cp`` axis of
    size ``cp`` would refuse at its first call: an unknown ``cp_impl``,
    and Ulysses on ``H/tp`` query heads that ``cp`` does not divide
    (``parallel/ulysses.py`` ``kv_repeat``)."""
    if cp > 1 and cp_attention(cfg, cp) == "ulysses":
        kv_repeat(cfg.n_heads // tp, cfg.n_kv_heads // tp, cp)
