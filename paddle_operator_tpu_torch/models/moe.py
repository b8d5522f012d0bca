"""Mixture-of-Experts feed-forward — the port of
``paddle_operator_tpu/models/moe.py``.

The same model: Switch-style top-1 or GShard-style top-k routing
(:func:`route_top_k`), a fixed **capacity** of ``max(1, int(cf * k * T
/ E))`` assignments an expert, claimed **choice-major** (every token's
first choice outranks any second choice), assignments past the capacity
dropped (their share of the output is zero), each expert a GELU FFN
(``w1 [E, D, F]``, tanh GELU — flax's ``nn.gelu`` default — then ``w2
[E, F, D]``), and the Switch load-balancing loss over the FIRST choice,
``E * sum_e(frac_routed_e * mean_prob_e)``.

Parameter names are flax's: ``router.kernel [D, E]`` (an f32
``Dense``), ``w1`` and ``w2``, so ``convert.params_from_jax`` maps
``moe/router/kernel``, ``moe/w1`` and ``moe/w2`` leaf for leaf.

Where the JAX layer dispatches and combines with one-hot einsums
(``[T, E, C]`` masks, a matrix product of ``T * E * C * D`` each way),
this one gathers: each kept assignment's slot ``e * C + position`` in the
``[E * C, D]`` expert buffer reads its token's row, and each token reads
its kept slots' outputs back.  The values are the einsums' (each output
of the dispatch is one token times 1.0, each of the combine a sum of at
most k gated rows, accumulated in f32 and rounded once, as the einsum
does); the work is ``E * C * D`` copies instead of a product.  The
expert products run as batched matrix products over the expert axis.

Expert parallelism (the ``ep`` mesh axis) waits for ROADMAP.md Queue A
item 8.1: every expert lives on the one card.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import torch
from torch import nn

from paddle_operator_tpu_torch.models.llama import Dense


def route_top_k(probs: torch.Tensor, k: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routing rule, shared by the training layer and the decode path
    (infer/decode.py ``_moe_ffn``): the top-k experts of each token, with
    the raw Switch gate at k = 1 and gates renormalized over the k
    chosen at k > 1.  probs [T, E] -> (gates [T, k], indices [T, k])."""
    topv, topi = torch.topk(probs, k, dim=-1)
    gates = topv if k == 1 else topv / topv.sum(-1, keepdim=True)
    return gates, topi


def expert_selection(topi: torch.Tensor, n_experts: int) -> torch.Tensor:
    """[T, k] expert indices -> [T, k, E] int32 one-hot, by comparison
    with ``arange(E)`` (``one_hot`` checks its indices on the host, a
    sync that a CUDA graph cannot capture)."""
    experts = torch.arange(n_experts, device=topi.device)
    return (topi[..., None] == experts).to(torch.int32)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    dim: int = 64
    ffn_dim: int = 128
    n_experts: int = 4
    capacity_factor: float = 1.25
    top_k: int = 1
    dtype: Any = torch.bfloat16
    param_dtype: Any = torch.float32


class ExpertCodes(nn.Module):
    """A weight-only quantized expert weight (infer/quant.py): the codes
    ``q [E, in, out]`` int8 (int4's in [-7, 7]) and the per-out-channel
    scales ``s [E, 1, out]`` f32 as buffers — the JAX package's
    ``{"q", "s"}`` leaf of ``quantize_leaf`` on ``[E, in, out]`` — and
    the ``mode`` ("int8" or "int4")."""

    def __init__(self, q: torch.Tensor, s: torch.Tensor, mode: str) -> None:
        super().__init__()
        self.register_buffer("q", q)
        self.register_buffer("s", s)
        self.mode = mode


class MoELayer(nn.Module):
    """``[B, S, D] -> ([B, S, D], aux_loss scalar)``."""

    def __init__(self, cfg: MoEConfig, device=None) -> None:
        super().__init__()
        self.cfg = cfg
        e, d, f = cfg.n_experts, cfg.dim, cfg.ffn_dim
        self.router = Dense(cfg, d, e, device)
        self.router.dtype = torch.float32
        self.w1 = nn.Parameter(torch.empty((e, d, f), dtype=cfg.param_dtype,
                                           device=device))
        self.w2 = nn.Parameter(torch.empty((e, f, d), dtype=cfg.param_dtype,
                                           device=device))

    def set_quantized(self, name: str, q: torch.Tensor, s: torch.Tensor,
                      mode: str) -> None:
        """Replace expert weight ``name`` ("w1" or "w2") by its codes and
        scales (:class:`ExpertCodes`), releasing the parameter.  The
        serving path reads them (infer/decode.py ``_expert_mm``); the
        training forward takes unquantized experts, as JAX's layer
        does."""
        delattr(self, name)
        self.add_module(name, ExpertCodes(q, s, mode))

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        b, s, d = x.shape
        t = b * s
        e, kk = cfg.n_experts, cfg.top_k
        if not 1 <= kk <= e:
            raise ValueError(f"top_k={kk} out of range for {e} experts")
        # capacity counts assignments (token-choices): k*T slots in all,
        # so at top-2 each expert's buffer doubles (GShard's convention)
        cap = max(1, int(cfg.capacity_factor * kk * t / e))
        tokens = x.reshape(t, d)
        probs = torch.softmax(self.router(tokens.float()), dim=-1)
        gates, topi = route_top_k(probs, kk)                  # [T, k]
        onehot = expert_selection(topi, e)                    # [T, k, E]
        # capacity positions, choice-major: every first choice is stacked
        # before any second choice, counted per expert, folded back
        oh_cm = onehot.transpose(0, 1).reshape(kk * t, e)
        pos_cm = (torch.cumsum(oh_cm, 0) * oh_cm - 1).amax(-1)
        pos_k = pos_cm.reshape(kk, t).T                       # [T, k]
        keep = pos_k < cap                                    # overflow drops
        # each kept assignment's row of the [E*C] expert buffer; dropped
        # ones point at one pad row past it, which reads zeros
        slot = torch.where(keep, topi * cap + pos_k,
                           torch.full_like(pos_k, e * cap))
        src = torch.full((e * cap + 1,), t, dtype=torch.long,
                         device=x.device)
        src.scatter_(0, slot.reshape(-1),
                     torch.arange(t, device=x.device).repeat_interleave(kk))
        rows = torch.cat([tokens.to(cfg.dtype),
                          tokens.new_zeros((1, d), dtype=cfg.dtype)])
        expert_in = rows[src[:e * cap]].reshape(e, cap, d)
        h = torch.bmm(expert_in, self.w1.to(cfg.dtype))
        h = torch.nn.functional.gelu(h, approximate="tanh")
        expert_out = torch.bmm(h, self.w2.to(cfg.dtype))
        outs = torch.cat([expert_out.reshape(e * cap, d),
                          expert_out.new_zeros((1, d))])[slot]  # [T, k, D]
        out = (outs.float() * gates.to(cfg.dtype).float()[..., None]
               ).sum(1).to(cfg.dtype)

        # Switch aux loss over the FIRST choice
        frac = onehot[:, 0].float().mean(0)
        aux = e * torch.sum(frac * probs.mean(0))
        return out.reshape(b, s, d).to(x.dtype), aux
