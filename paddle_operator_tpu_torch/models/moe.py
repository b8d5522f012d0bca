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

On a mesh (``train/trainer.py`` ``create_state(mesh=...)``) the layer
computes what the JAX layer computes over the GLOBAL batch under GSPMD
(the expert weights ``w1 [E, D, F]``/``w2 [E, F, D]`` sharded
``(ep, fsdp, tp)``/``(ep, tp, fsdp)``, :data:`MOE_PARAM_SPECS`; the
batch sharded over (dp, fsdp) and replicated over ``ep``, so there is
no token all-to-all):

- the capacity comes from the global token count, this rank's times the
  data blocks';
- an assignment's choice-major position is its position among its
  block's assignments of the same choice and expert, plus the counts of
  that expert in every block's earlier choices and in the earlier
  blocks' same choice (``parallel/collectives.py``
  ``all_gather_blocks`` of each block's ``[k, E]`` counts, no
  gradient): a second choice ranks behind every block's first choices;
- each rank runs only its ``E / ep`` local experts (gathered over
  ``fsdp``, its ``tp`` columns) on the kept assignments routed to them;
  the tokens and gates entering them go through ``copy_over`` and the
  gated f32 sum leaves through ``sum_over`` (both over ``ep`` and
  ``tp``), and is rounded once to the compute dtype, as on one card;
- the load-balancing loss takes global means: the first-choice counts
  from the gathered counts, the router probabilities' sums through
  ``sum_over`` the data axes (the gradient flows back to each rank's
  own probabilities).

``dropped`` holds the global count of assignments past the capacity
from the last forward (a device scalar, no gradient).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor, Shard

from paddle_operator_tpu_torch.models.llama import Dense
from paddle_operator_tpu_torch.parallel.collectives import (
    all_gather_blocks, copy_over, gather_param, sum_over)
from paddle_operator_tpu_torch.parallel.mesh import (DATA_AXES, coordinates,
                                                     mesh_axis_sizes)
from paddle_operator_tpu_torch.parallel.sharding import data_block


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


def capacity(cfg: MoEConfig, t: int) -> int:
    """An expert's buffer rows for ``t`` tokens of the GLOBAL batch.  It
    counts assignments (token-choices): k*T slots in all, so at top-2
    each expert's buffer doubles (GShard's convention).  JAX's expression
    term for term, so that the float rounds as there."""
    return max(1, int(cfg.capacity_factor * cfg.top_k * t / cfg.n_experts))


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
        self.dropped = None

    def set_quantized(self, name: str, q: torch.Tensor, s: torch.Tensor,
                      mode: str) -> None:
        """Replace expert weight ``name`` ("w1" or "w2") by its codes and
        scales (:class:`ExpertCodes`), releasing the parameter.  The
        serving path reads them (infer/decode.py ``_expert_mm``); the
        training forward takes unquantized experts, as JAX's layer
        does."""
        delattr(self, name)
        self.add_module(name, ExpertCodes(q, s, mode))

    def _groups(self) -> dict:
        """The mesh groups the layer works over, from its expert
        weight's placements (none off a mesh): ``experts`` the groups
        of ``ep`` and ``tp`` that split the experts' work, ``data`` the
        data axes' (dp, then fsdp) with this rank's block and the block
        count, ``ep`` (this rank's index, the axis size)."""
        out = {"experts": (), "data": (), "block": (0, 1), "ep": (0, 1)}
        w = self.w1
        if not isinstance(w, DTensor):
            return out
        mesh = w.device_mesh
        pl = dict(zip(mesh.mesh_dim_names, w.placements))
        sizes = mesh_axis_sizes(mesh)
        coords = coordinates(mesh)
        out["experts"] = tuple(mesh.get_group(a) for a in ("ep", "tp")
                               if isinstance(pl[a], Shard))
        out["data"] = tuple(mesh.get_group(a) for a in DATA_AXES
                            if sizes[a] > 1)
        out["block"] = data_block(mesh)
        if isinstance(pl["ep"], Shard):
            out["ep"] = (coords["ep"], sizes["ep"])
        return out

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        b, s, d = x.shape
        t = b * s
        e, kk = cfg.n_experts, cfg.top_k
        if not 1 <= kk <= e:
            raise ValueError(f"top_k={kk} out of range for {e} experts")
        g = self._groups()
        blk, n_blk = g["block"]
        cap = capacity(cfg, t * n_blk)
        tokens = x.reshape(t, d)
        probs = torch.softmax(self.router(tokens.float()), dim=-1)
        gates, topi = route_top_k(probs, kk)                  # [T, k]
        onehot = expert_selection(topi, e)                    # [T, k, E]
        # capacity positions, choice-major over the global token order:
        # every first choice before any second choice, blocks in order
        oh_cm = onehot.transpose(0, 1)                        # [k, T, E]
        counts = all_gather_blocks(oh_cm.sum(1), g["data"])   # [n, k, E]
        per_choice = counts.sum(0)                            # [k, E]
        offset = (torch.cumsum(per_choice, 0) - per_choice
                  + counts[:blk].sum(0))
        pos_cm = ((torch.cumsum(oh_cm, 1) + offset[:, None]) * oh_cm
                  - 1).amax(-1)                               # [k, T]
        pos_k = pos_cm.T                                      # [T, k]
        self.dropped = (per_choice.sum(0) - cap).clamp(min=0).sum()
        # this rank's experts [e0, e0 + el); each kept assignment routed to
        # one of them gets its row of the [el*C] expert buffer, the others
        # point at one pad row past it, which reads zeros
        r, n_ep = g["ep"]
        el = e // n_ep
        e0 = r * el
        mine = (pos_k < cap) & (topi >= e0) & (topi < e0 + el)
        slot = torch.where(mine, (topi - e0) * cap + pos_k,
                           torch.full_like(pos_k, el * cap))
        src = torch.full((el * cap + 1,), t, dtype=torch.long,
                         device=x.device)
        src.scatter_(0, slot.reshape(-1),
                     torch.arange(t, device=x.device).repeat_interleave(kk))
        rows = torch.cat([copy_over(tokens, g["experts"]).to(cfg.dtype),
                          tokens.new_zeros((1, d), dtype=cfg.dtype)])
        expert_in = rows[src[:el * cap]].reshape(el, cap, d)
        h = torch.bmm(expert_in, gather_param(self.w1).to(cfg.dtype))
        h = torch.nn.functional.gelu(h, approximate="tanh")
        expert_out = torch.bmm(h, gather_param(self.w2).to(cfg.dtype))
        outs = torch.cat([expert_out.reshape(el * cap, d),
                          expert_out.new_zeros((1, d))])[slot]  # [T, k, D]
        gated = copy_over(gates, g["experts"]).to(cfg.dtype).float()
        out = sum_over((outs.float() * gated[..., None]).sum(1),
                       g["experts"]).to(cfg.dtype)

        # Switch aux loss over the FIRST choice, from global means
        if g["data"]:
            frac = per_choice[0].float() / (t * n_blk)
            mean_prob = sum_over(probs.sum(0), g["data"]) / (t * n_blk)
        else:
            frac = onehot[:, 0].float().mean(0)
            mean_prob = probs.mean(0)
        aux = e * torch.sum(frac * mean_prob)
        return out.reshape(b, s, d).to(x.dtype), aux


# The logical specs of MoELayer's parameters, keyed by their names
# relative to the layer (the JAX package's MOE_PARAM_SPECS on the port's
# names): models/llama.py derives its rows from this table
MOE_PARAM_SPECS = {
    "router.kernel": ("embed", None),
    "w1": ("expert", "embed", "mlp"),
    "w2": ("expert", "mlp", "embed"),
}


def moe_partition_patterns():
    """(name-regex, logical spec) rows for ``parallel/sharding.py``,
    anchored under ``moe.``, where models/llama.py mounts the layer."""
    return [(rf"moe\.{re.escape(name)}$", spec)
            for name, spec in MOE_PARAM_SPECS.items()]
