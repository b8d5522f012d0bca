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
while gradients are recorded, so the backward recomputes the layer (and
launches the flash forward again), as under the JAX package's default
policy ``"full"`` (``nothing_saveable``).  The JAX config's other remat
policies, ``scan_layers`` and ``cp_impl`` are not fields here, so a
caller that sets them gets a ``TypeError`` (ROADMAP.md Queue A items 13
and 14).

MoE configs (``n_experts > 0``) are not ported yet and raise
``NotImplementedError`` (ROADMAP.md Queue A, "MoE").
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from paddle_operator_tpu_torch.ops.attention import attention

_MOE_TODO = ("MoE configs (n_experts > 0) are not ported to the torch "
             "package yet (ROADMAP.md Queue A, 'MoE')")


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
    # recompute each decoder layer in the backward (the JAX default
    # policy "full")
    remat: bool = True
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

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

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


# ---------------------------------------------------------------------------
# Building blocks
# ---------------------------------------------------------------------------


def _param(shape, cfg: LlamaConfig, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=cfg.param_dtype,
                                    device=device))


class Dense(nn.Module):
    """flax DenseGeneral without bias: ``kernel`` [in, out], computed in
    the compute dtype."""

    def __init__(self, cfg: LlamaConfig, n_in: int, n_out: int,
                 device=None) -> None:
        super().__init__()
        self.dtype = cfg.dtype
        self.kernel = _param((n_in, n_out), cfg, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(self.dtype) @ self.kernel.to(self.dtype)


class Embed(nn.Module):
    """flax Embed: ``embedding`` [vocab, dim], gathered in the compute
    dtype."""

    def __init__(self, cfg: LlamaConfig, device=None) -> None:
        super().__init__()
        self.dtype = cfg.dtype
        self.embedding = _param((cfg.vocab_size, cfg.dim), cfg, device)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.embedding.to(self.dtype)[tokens]


class RMSNorm(nn.Module):
    def __init__(self, cfg: LlamaConfig, dim: int, device=None) -> None:
        super().__init__()
        self.eps = cfg.norm_eps
        self.dtype = cfg.dtype
        self.scale = _param((dim,), cfg, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        norm = xf * torch.rsqrt((xf * xf).mean(-1, keepdim=True) + self.eps)
        return (norm * self.scale.float()).to(self.dtype)


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
        q = self.wq(x).reshape(b, s, cfg.n_heads, cfg.head_dim)
        k = self.wk(x).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
        v = self.wv(x).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
        out = attention(q, k, v, causal=True, segment_ids=segment_ids)
        return self.wo(out.reshape(b, s, cfg.n_heads * cfg.head_dim))


class MLP(nn.Module):
    """SwiGLU feed-forward."""

    def __init__(self, cfg: LlamaConfig, device=None) -> None:
        super().__init__()
        self.w1 = Dense(cfg, cfg.dim, cfg.ffn_dim, device)
        self.w3 = Dense(cfg, cfg.dim, cfg.ffn_dim, device)
        self.w2 = Dense(cfg, cfg.ffn_dim, cfg.dim, device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w2(torch.nn.functional.silu(self.w1(x)) * self.w3(x))


class DecoderLayer(nn.Module):
    def __init__(self, cfg: LlamaConfig, device=None) -> None:
        super().__init__()
        if cfg.n_experts > 0:
            raise NotImplementedError(_MOE_TODO)
        self.attn_norm = RMSNorm(cfg, cfg.dim, device)
        self.attn = Attention(cfg, device)
        self.mlp_norm = RMSNorm(cfg, cfg.dim, device)
        self.mlp = MLP(cfg, device)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = x + self.attn(self.attn_norm(x), cos, sin, segment_ids)
        return h + self.mlp(self.mlp_norm(h))


class Llama(nn.Module):
    """``tokens [B, S]`` int -> ``[B, S, vocab]`` f32 logits (the
    training forward; decoding goes through infer/decode.py over the
    same parameters).  The RoPE tables ride as non-persistent f32
    buffers, so the decode path reads them without recomputing."""

    def __init__(self, cfg: LlamaConfig, device=None) -> None:
        super().__init__()
        if cfg.n_experts > 0:
            raise NotImplementedError(_MOE_TODO)
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
                segment_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``segment_ids`` [B, S]: packed documents; attention is masked
        across them, RoPE positions stay absolute."""
        x = self.tok_embed(tokens)
        remat = self.cfg.remat and torch.is_grad_enabled()
        for layer in self.layers:
            if remat:
                x = checkpoint(layer, x, self.rope_cos, self.rope_sin,
                               segment_ids, use_reentrant=False)
            else:
                x = layer(x, self.rope_cos, self.rope_sin, segment_ids)
        x = self.final_norm(x)
        return self.lm_head(x).float()


def make_model(preset: str = "tiny", *, device="cuda", seed: int = 0,
               **overrides) -> Tuple[Llama, LlamaConfig]:
    """Build and initialize a preset on ``device`` (the card unless the
    caller asks otherwise) from ``torch.Generator`` seed ``seed``.
    ``overrides`` replace config fields (``dtype=torch.float32`` for
    f32 tests, ``param_dtype=torch.bfloat16`` to init straight into the
    serving dtype).  The JAX signature's context-parallel ``mesh`` is
    not a parameter: meshes are not ported."""
    cfg = dataclasses.replace(CONFIGS[preset], **overrides)
    device = torch.device(device)
    model = Llama(cfg, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    model.init_weights(gen)
    return model, cfg
