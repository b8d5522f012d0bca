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
- :func:`copy_over` / :func:`sum_over` — Megatron's pair around a
  column-parallel then row-parallel block, over any groups: identity
  forward and an all-reduce of the input's gradient backward; an
  all-reduce of the partial output forward and identity backward.  The
  tp blocks of ``models/llama.py`` run it over ``tp``, the MoE layer
  (``models/moe.py``) over ``ep`` and ``tp`` around its local experts,
  and the MoE layer sums its load-balancing statistics over the data
  axes with :func:`sum_over`.
- :func:`all_gather_blocks` — a small tensor of every data block, in
  block order, outside autograd (the MoE layer's expert counts, whose
  prefix gives each assignment its global capacity position).
- :func:`vocab_parallel_embed` — the embedding over this rank's vocab
  rows; tokens outside them give zeros, and the ``tp`` all-reduce sums
  the one row each token has.
- :func:`vocab_parallel_log_prob` — the target's log-probability from
  vocab-sharded logits: the max, the sum of exponentials and the target
  logit are all-reduced over ``tp`` (a few floats a position); the full
  ``[B, S, V]`` logits are never gathered.  Its backward is
  ``g * (onehot - softmax)`` on the local vocab slice.
- :func:`gather_along` — a tensor's shards along one dim gathered
  over the mesh axes that cut it, outside autograd (the int8 update's
  whole rows, ``train/trainer.py`` ``AdamW8bit``; Ulysses'
  ``segment_ids``).
- :func:`all_reduce_data` — a sum over the data axes (dp, then fsdp).
- :func:`full_tensor` — a DTensor gathered whole on every rank through
  the same c10d all-gathers (a checkpoint's parameters).  DTensor's own
  ``full_tensor`` goes through the functional collectives, which crash
  a process whose gloo group carries CUDA tensors (torch 2.11, phase 3s
  (b) of chip_smoke.py).

The exchanges of context and pipeline parallelism (JAX's ``ppermute``
and ``all_to_all``) all run on ONE c10d primitive,
``all_to_all_single`` with split sizes (:func:`exchange`): nccl runs it
on a pod, gloo on the CPU and (staging through the host) on CUDA tensors
of ranks that share a card, where gloo's ``send``/``recv`` would read a
device pointer as a host one.

- :func:`ring_shift` — tensors sent to the next rank of an axis and
  received from the previous one (a cyclic ``ppermute``); its backward
  is the reverse shift.  Ring attention rotates K and V with it, in one
  exchange a hop, so each hop's backward is one exchange too (two
  separate exchanges could be issued in different orders by ranks whose
  graphs differ).
- :func:`all_to_all` — each tensor split along one dim, the i-th piece
  sent to rank i, the received pieces concatenated along another dim in
  rank order (JAX's tiled ``all_to_all``); its backward is the inverse
  exchange (Ulysses).
- :func:`pipeline_hop` — the acyclic exchange of a pipeline round,
  outside autograd: an activation to the next stage, a cotangent to the
  previous one.

Every exchange counts the bytes it sends in :data:`EXCHANGE`.

The serving path's collectives (tensor-parallel decoding over a
``make_serving_mesh`` mesh, ``infer/decode.py``) run forward only, with
no autograd, and count their calls and bytes in :data:`SERVING`:

- :func:`reduce_partials` — the all-reduce of a row-parallel
  projection's partial outputs (wo, w2), in the compute dtype, as the
  JAX package's psum sums them;
- :func:`serving_embed` — the vocab-parallel embedding lookup: this
  rank's rows, zeros for the tokens outside them, then the all-reduce;
- :func:`gather_logits` — the vocab-sharded logits all-gathered along
  the vocab, so every rank samples the same whole row.

An axis of size 1 gets no collective: on a mesh whose axes are all 1 the
step runs the single-device operations and nothing else.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

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


def _gather(p: DTensor, keep: Sequence[str], gather) -> torch.Tensor:
    """``p``'s local shard gathered over its sharding axes but those of
    ``keep``, inner axes first so nested blocks land in order."""
    mesh = p.device_mesh
    local = p.to_local()
    for name, pl in reversed(list(zip(mesh.mesh_dim_names, p.placements))):
        if isinstance(pl, Shard) and name not in keep:
            local = gather(local, pl.dim, mesh.get_group(name))
    return local


def gather_param(p: torch.Tensor) -> torch.Tensor:
    """The tensor a layer computes with: a plain tensor as it is; a
    DTensor's local shard all-gathered over its sharding axes other
    than ``tp`` and ``ep`` (a rank computes with its own columns and
    its own experts)."""
    if not isinstance(p, DTensor):
        return p
    return _gather(p, ("tp", "ep"), _Gather.apply)


@torch.no_grad()
def full_tensor(p: torch.Tensor) -> torch.Tensor:
    """The whole of ``p`` on every rank (a plain tensor as it is)."""
    if not isinstance(p, DTensor):
        return p
    return _gather(p, (), _all_gather_dim)


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


def _all_reduce_groups(x: torch.Tensor, groups) -> torch.Tensor:
    out = x.clone(memory_format=torch.contiguous_format)
    for group in groups:
        dist.all_reduce(out, group=group)
    EXCHANGE["reduce"] += out.numel() * out.element_size() * len(groups)
    return out


class _CopyOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        ctx.groups = groups
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_groups(g, ctx.groups), None


class _SumOver(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, groups):
        return _all_reduce_groups(x, groups)

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_over(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """``x``, replicated over ``groups``, entering work that each rank of
    them does a part of: identity forward, the gradient's parts summed
    over every group of ``groups`` backward.  No groups: ``x``."""
    return _CopyOver.apply(x, tuple(groups)) if groups else x


def sum_over(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """The sum of ``x`` over every group of ``groups`` (one all-reduce a
    group, in order), with an identity backward: each rank's ``x`` is its
    part of the sum, and the gradient of the sum is its gradient.  No
    groups: ``x``."""
    return _SumOver.apply(x, tuple(groups)) if groups else x


@torch.no_grad()
def all_gather_blocks(x: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """``x`` of every rank of ``groups`` (outer axis first, as
    ``parallel/sharding.py`` ``data_block`` numbers the blocks) stacked
    on a new leading dim in block order, without a gradient.  No
    groups: ``x[None]``."""
    out = x[None]
    for group in reversed(tuple(groups)):
        out = _all_gather_dim(out, 0, group)
    return out


@torch.no_grad()
def gather_along(x: torch.Tensor, dim: int, groups: Sequence
                 ) -> torch.Tensor:
    """``x``'s shards along ``dim`` over ``groups`` (the axes that cut
    the dim, outer first) concatenated in rank order, contiguous and
    without a gradient: the inner axis first, so nested blocks land in
    order.  No groups: ``x``."""
    for group in reversed(tuple(groups)):
        x = _all_gather_dim(x, dim % x.dim(), group)
    return x


def vocab_parallel_embed(weight: torch.Tensor, tokens: torch.Tensor,
                         tp) -> torch.Tensor:
    """``weight`` [V/tp, D] holds rows ``rank * V/tp ...`` of the
    embedding; the rows of ``tokens`` summed over ``tp``."""
    group, rank, _ = tp
    rows = weight.shape[0]
    local = tokens.long() - rank * rows
    miss = (local < 0) | (local >= rows)
    out = weight[local.clamp(0, rows - 1)].masked_fill(miss[..., None], 0)
    return sum_over(out, (group,))


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


def all_reduce_data(t: torch.Tensor, mesh, op=dist.ReduceOp.SUM,
                    axes=DATA_AXES) -> torch.Tensor:
    """``t`` reduced in place over ``axes`` of ``mesh`` (the data axes,
    dp then fsdp, by default; an axis of size 1 is skipped).  Every rank
    ends with the same bits."""
    for axis in axes:
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


def cp_group(p: torch.Tensor):
    """(group, rank, size) of the ``cp`` axis of the mesh that parameter
    ``p`` is laid over, or None when that axis has size 1 (or ``p`` is
    not a DTensor): the ranks that split the sequence of ``p``'s
    layer."""
    if not isinstance(p, DTensor):
        return None
    mesh = p.device_mesh
    i = list(mesh.mesh_dim_names).index("cp")
    if mesh.mesh.shape[i] <= 1:
        return None
    group = mesh.get_group("cp")
    return group, dist.get_rank(group), dist.get_world_size(group)


# bytes each kind of exchange sent from this process ("shift", "a2a",
# "hop"), the bytes of the tensors the copy/sum pair all-reduced
# ("reduce", once a group: tp's and ep's), and the bytes the int8
# update's gathers brought to this process, by case ("q8_replicated",
# "q8_unaligned": train/trainer.py AdamW8bit); a caller zeroes and reads
# them around the work it measures
EXCHANGE: Dict[str, int] = {"shift": 0, "a2a": 0, "hop": 0, "reduce": 0,
                            "q8_replicated": 0, "q8_unaligned": 0}


def exchange(sends: Dict[int, torch.Tensor],
             recvs: Dict[int, Sequence[int]], group, *, like: torch.Tensor,
             kind: str = "hop") -> Dict[int, torch.Tensor]:
    """One ``all_to_all_single`` over ``group``: ``sends`` maps a group
    rank to the tensor sent to it, ``recvs`` a group rank to the shape
    of the tensor received from it (dtype and device of ``like``, as
    every sent tensor).  Returns the received tensors by source, each
    contiguous.  Every rank of ``group`` calls it, with matching sizes;
    a rank that neither sends nor receives passes two empty maps."""
    n = dist.get_world_size(group)
    size = like.element_size()
    in_splits, out_splits = [0] * n, [0] * n
    for dst, t in sends.items():
        in_splits[dst] = t.numel() * size
    for src, shape in recvs.items():
        out_splits[src] = math.prod(shape) * size
    # moved as bytes: the exchange copies, and every backend moves uint8
    parts = [sends[r].reshape(-1).view(torch.uint8) for r in sorted(sends)]
    inp = (torch.cat(parts) if parts
           else torch.empty(0, dtype=torch.uint8, device=like.device))
    out = torch.empty(sum(out_splits), dtype=torch.uint8, device=like.device)
    dist.all_to_all_single(out, inp, out_splits, in_splits, group=group)
    EXCHANGE[kind] += inp.numel()
    got, off = {}, 0
    for r in range(n):
        if r in recvs:
            got[r] = out[off:off + out_splits[r]].view(like.dtype) \
                .view(tuple(recvs[r]))
        off += out_splits[r]
    return got


def _shift(xs: Sequence[torch.Tensor], cp, step: int
           ) -> Tuple[torch.Tensor, ...]:
    """``xs`` (one dtype) sent ``step`` ranks on around the ring of
    ``cp`` and received from ``step`` ranks back, in one exchange."""
    group, rank, n = cp
    buf = torch.cat([x.reshape(-1) for x in xs])
    got = exchange({(rank + step) % n: buf},
                   {(rank - step) % n: buf.shape}, group, like=buf,
                   kind="shift")[(rank - step) % n]
    out, off = [], 0
    for x in xs:
        out.append(got[off:off + x.numel()].view(x.shape))
        off += x.numel()
    return tuple(out)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, cp, *xs):
        ctx.cp = cp
        return _shift(xs, cp, 1)

    @staticmethod
    def backward(ctx, *gs):
        return (None,) + _shift(gs, ctx.cp, -1)


def ring_shift(*xs: torch.Tensor, cp) -> Tuple[torch.Tensor, ...]:
    """``xs`` (one dtype) from the previous rank of the ``cp`` ring
    ((group, rank, size)), this rank's sent to the next: JAX's
    ``ppermute`` with ``perm [(i, (i + 1) % n)]``.  Differentiable: the
    backward shifts the gradients the other way.  Outside autograd
    (integer ``segment_ids``) it is the same exchange."""
    if not any(x.requires_grad for x in xs) or not torch.is_grad_enabled():
        with torch.no_grad():
            return _shift(xs, cp, 1)
    return _RingShift.apply(cp, *xs)


def _a2a(xs: Sequence[torch.Tensor], split_dim: int, concat_dim: int,
         group) -> Tuple[torch.Tensor, ...]:
    n = dist.get_world_size(group)
    pieces = [x.chunk(n, split_dim) for x in xs]
    sends = {r: torch.cat([p[r].reshape(-1) for p in pieces])
             for r in range(n)}
    got = exchange(sends, {r: sends[r].shape for r in range(n)}, group,
                   like=sends[0], kind="a2a")
    res, off = [], 0
    for p in pieces:
        shape, size = p[0].shape, p[0].numel()
        res.append(torch.cat([got[r][off:off + size].view(shape)
                              for r in range(n)], dim=concat_dim))
        off += size
    return tuple(res)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, split_dim, concat_dim, group, *xs):
        ctx.dims, ctx.group = (split_dim, concat_dim), group
        return _a2a(xs, split_dim, concat_dim, group)

    @staticmethod
    def backward(ctx, *gs):
        split_dim, concat_dim = ctx.dims
        return (None, None, None) + _a2a(gs, concat_dim, split_dim,
                                         ctx.group)


def all_to_all(*xs: torch.Tensor, split_dim: int, concat_dim: int,
               cp) -> Tuple[torch.Tensor, ...]:
    """Each of ``xs`` (one dtype) split along ``split_dim`` into the
    ``cp`` axis' size pieces, piece *i* to rank *i*, and what arrives
    concatenated along ``concat_dim`` in rank order (JAX's tiled
    ``all_to_all``), all in one exchange.  Its backward is the inverse
    exchange."""
    return _AllToAll.apply(split_dim, concat_dim, cp[0], *xs)


@torch.no_grad()
def pipeline_hop(pp, *, fwd: Optional[torch.Tensor] = None,
                 bwd: Optional[torch.Tensor] = None,
                 recv_fwd: Optional[Sequence[int]] = None,
                 recv_bwd: Optional[Sequence[int]] = None,
                 like: torch.Tensor
                 ) -> Tuple[Optional[torch.Tensor], Optional[torch.Tensor]]:
    """One round's exchange along the pipeline axis ``pp`` ((group,
    stage, size)), outside autograd: ``fwd`` to the next stage and
    ``bwd`` to the previous one; returns what arrives from the previous
    stage (shape ``recv_fwd``) and from the next (``recv_bwd``).  JAX's
    acyclic ``ppermute`` pair: the first stage receives no activation,
    the last sends none.  Every stage calls it every round, with the
    sizes that the schedule makes live."""
    group, stage, _ = pp
    sends, recvs = {}, {}
    if fwd is not None:
        sends[stage + 1] = fwd
    if bwd is not None:
        sends[stage - 1] = bwd
    if recv_fwd is not None:
        recvs[stage - 1] = recv_fwd
    if recv_bwd is not None:
        recvs[stage + 1] = recv_bwd
    got = exchange(sends, recvs, group, like=like)
    return got.get(stage - 1), got.get(stage + 1)


# ---------------------------------------------------------------------------
# Serving tensor parallelism: forward-only collectives
# ---------------------------------------------------------------------------

#: calls and bytes of the serving collectives on this rank (bytes: the
#: rank's own input, per call)
SERVING: Dict[str, int] = {"reduce_calls": 0, "reduce_bytes": 0,
                           "gather_calls": 0, "gather_bytes": 0}


@torch.no_grad()
def reduce_partials(x: torch.Tensor, group) -> torch.Tensor:
    """The sum over ``group`` of each rank's partial ``x`` (a
    row-parallel projection's output on its rows), in ``x``'s dtype: a
    new contiguous tensor, every rank with the same bits."""
    out = x.contiguous().clone()
    dist.all_reduce(out, group=group)
    SERVING["reduce_calls"] += 1
    SERVING["reduce_bytes"] += out.numel() * out.element_size()
    return out


@torch.no_grad()
def serving_embed(weight: torch.Tensor, tokens: torch.Tensor, start: int,
                  group) -> torch.Tensor:
    """The embedding rows of ``tokens`` from a vocab shard: ``weight``
    [V/tp, D] holds rows ``start ...`` of the table; a token outside
    them gives zeros, and the sum over ``group`` leaves each token its
    one row."""
    rows = weight.shape[0]
    local = tokens.long() - start
    miss = (local < 0) | (local >= rows)
    out = weight[local.clamp(0, rows - 1)].masked_fill(miss[..., None], 0)
    return reduce_partials(out, group)


@torch.no_grad()
def gather_logits(x: torch.Tensor, group) -> torch.Tensor:
    """Vocab-sharded logits ``[..., V/tp]`` gathered along the last dim
    over ``group`` in rank order: ``[..., V]`` on every rank."""
    out = _all_gather_dim(x, x.dim() - 1, group)
    SERVING["gather_calls"] += 1
    SERVING["gather_bytes"] += x.numel() * x.element_size()
    return out
