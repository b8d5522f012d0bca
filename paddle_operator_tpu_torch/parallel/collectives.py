"""The collectives of the sharded train step, as autograd functions: what
XLA's SPMD partitioner inserts into the JAX package's jitted step, written
out for a ``dp × fsdp × tp`` mesh (``parallel/mesh.py``).

- :func:`gather_param` — FSDP: a parameter DTensor's local shard,
  all-gathered over every sharding axis but ``tp`` (in practice
  ``fsdp``) right where the layer uses it; its backward reduce-scatters
  the gradient (a sum over the ranks' batch rows) back to the shard.  So
  the full weight lives only while its layer runs (and again in the
  recompute), and a shard's gradient leaves the backward already summed
  over ``fsdp``.
- :func:`copy_to_tp` / :func:`reduce_from_tp` — Megatron's pair around
  a column-parallel then row-parallel block: identity forward and a
  ``tp`` all-reduce of the input's gradient backward; a ``tp``
  all-reduce of the partial output forward and identity backward.
- :func:`vocab_parallel_embed` — the embedding over this rank's vocab
  rows; tokens outside them give zeros, and the ``tp`` all-reduce sums
  the one row each token has.
- :func:`vocab_parallel_log_prob` — the target's log-probability from
  vocab-sharded logits: the max, the sum of exponentials and the target
  logit are all-reduced over ``tp`` (a few floats a position); the full
  ``[B, S, V]`` logits are never gathered.  Its backward is
  ``g * (onehot - softmax)`` on the local vocab slice.
- :func:`all_reduce_data` — a sum over the data axes (dp, then fsdp).
- :func:`full_tensor` — a DTensor gathered whole on every rank through
  the same c10d all-gathers (a checkpoint's parameters).  DTensor's own
  ``full_tensor`` goes through the functional collectives, which crash
  a process whose gloo group carries CUDA tensors (torch 2.11, phase 3s
  (b) of chip_smoke.py).

An axis of size 1 gets no collective: on a mesh whose axes are all 1 the
step runs the single-device operations and nothing else.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from paddle_operator_tpu_torch.parallel.mesh import DATA_AXES, axis_group

_gather_into = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_scatter_into = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def _all_gather_dim(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    xt = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xt.shape[0], *xt.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _gather_into(out, xt, group=group)
    return out.movedim(0, dim).contiguous()


def _reduce_scatter_dim(g: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    gt = g.movedim(dim, 0).contiguous()
    out = torch.empty((gt.shape[0] // n, *gt.shape[1:]), dtype=g.dtype,
                      device=g.device)
    _scatter_into(out, gt, group=group)
    # contiguous, as the shard is: a gradient of other strides than its
    # parameter's is copied into a new one at accumulation
    return out.movedim(0, dim).contiguous()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather_dim(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter_dim(g, ctx.dim, ctx.group), None, None


def _gather(p: DTensor, keep_tp: bool, gather) -> torch.Tensor:
    """``p``'s local shard gathered over its sharding axes (but ``tp``
    when ``keep_tp``), inner axes first so nested blocks land in
    order."""
    mesh = p.device_mesh
    local = p.to_local()
    for name, pl in reversed(list(zip(mesh.mesh_dim_names, p.placements))):
        if isinstance(pl, Shard) and not (keep_tp and name == "tp"):
            local = gather(local, pl.dim, mesh.get_group(name))
    return local


def gather_param(p: torch.Tensor) -> torch.Tensor:
    """The tensor a layer computes with: a plain tensor as it is; a
    DTensor's local shard all-gathered over its sharding axes other
    than ``tp``."""
    if not isinstance(p, DTensor):
        return p
    return _gather(p, True, _Gather.apply)


@torch.no_grad()
def full_tensor(p: torch.Tensor) -> torch.Tensor:
    """The whole of ``p`` on every rank (a plain tensor as it is)."""
    if not isinstance(p, DTensor):
        return p
    return _gather(p, False, _all_gather_dim)


def tp_group(p: torch.Tensor):
    """(group, rank, size) of the ``tp`` axis that shards parameter
    ``p``, or None when ``p`` is not sharded over ``tp``."""
    if not isinstance(p, DTensor):
        return None
    mesh = p.device_mesh
    i = list(mesh.mesh_dim_names).index("tp")
    if not isinstance(p.placements[i], Shard):
        return None
    group = mesh.get_group("tp")
    return group, dist.get_rank(group), dist.get_world_size(group)


class _CopyToTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_tp(x: torch.Tensor, tp) -> torch.Tensor:
    """``x`` (replicated over ``tp``) entering column-parallel weights."""
    return x if tp is None else _CopyToTP.apply(x, tp[0])


def reduce_from_tp(x: torch.Tensor, tp) -> torch.Tensor:
    """The sum over ``tp`` of a row-parallel block's partial outputs."""
    return x if tp is None else _ReduceFromTP.apply(x, tp[0])


def vocab_parallel_embed(weight: torch.Tensor, tokens: torch.Tensor,
                         tp) -> torch.Tensor:
    """``weight`` [V/tp, D] holds rows ``rank * V/tp ...`` of the
    embedding; the rows of ``tokens`` summed over ``tp``."""
    group, rank, _ = tp
    rows = weight.shape[0]
    local = tokens.long() - rank * rows
    miss = (local < 0) | (local >= rows)
    out = weight[local.clamp(0, rows - 1)].masked_fill(miss[..., None], 0)
    return reduce_from_tp(out, tp)


class _VocabParallelLogProb(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, targets, group, rank):
        rows = logits.shape[-1]
        top = logits.max(-1).values
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
        shifted = logits - top[..., None]
        e = torch.exp(shifted)
        total = e.sum(-1)
        dist.all_reduce(total, group=group)
        local = targets - rank * rows
        miss = (local < 0) | (local >= rows)
        idx = local.clamp(0, rows - 1)
        picked = shifted.gather(-1, idx[..., None])[..., 0] \
            .masked_fill(miss, 0)
        dist.all_reduce(picked, group=group)
        ctx.save_for_backward(e / total[..., None], idx, miss)
        return picked - torch.log(total)

    @staticmethod
    def backward(ctx, g):
        softmax, idx, miss = ctx.saved_tensors
        grad = softmax * (-g[..., None])
        grad.scatter_add_(-1, idx[..., None],
                          g.masked_fill(miss, 0)[..., None])
        return grad, None, None, None


def vocab_parallel_log_prob(logits: torch.Tensor, targets: torch.Tensor,
                            tp) -> torch.Tensor:
    """log softmax(logits)[target] per position, ``logits`` f32 [..., V/tp]
    this rank's vocab slice (``tp`` = (group, rank, size))."""
    group, rank, _ = tp
    return _VocabParallelLogProb.apply(logits, targets.long(), group, rank)


def all_reduce_data(t: torch.Tensor, mesh, op=dist.ReduceOp.SUM
                    ) -> torch.Tensor:
    """``t`` reduced in place over the data axes of ``mesh`` (dp, then
    fsdp; an axis of size 1 is skipped).  Every rank ends with the same
    bits."""
    for axis in DATA_AXES:
        group = axis_group(mesh, axis)
        if group is not None:
            dist.all_reduce(t, op=op, group=group)
    return t


def all_reduce_flat(tensors, group) -> None:
    """Sum ``tensors`` in place over ``group`` with one all-reduce a
    dtype (the tensors flattened into one buffer and back)."""
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for ts in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group)
        off = 0
        for t in ts:
            n = t.numel()
            t.copy_(flat[off:off + n].view_as(t))
            off += n


def group_of(mesh, axis: str) -> Optional[Tuple]:
    """(group, rank, size) along ``axis``, None when its size is 1."""
    group = axis_group(mesh, axis)
    if group is None:
        return None
    return group, dist.get_rank(group), dist.get_world_size(group)
