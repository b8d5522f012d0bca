"""Pipeline parallelism over the ``pp`` mesh axis — the port of
``paddle_operator_tpu/parallel/pipeline.py``: :func:`microbatch`, the
GPipe schedule (:func:`pipeline_apply`, :func:`make_pipeline_fn`) and
the 1F1B schedule (:func:`pipeline_1f1b_grads`,
:func:`make_pipeline_1f1b_fn`).

Stage *s* of ``P`` holds a contiguous block of layers.  Microbatches
stream through the stages; activations hop stage to stage, cotangents
back, through ``parallel/collectives.py`` ``pipeline_hop`` (one
``all_to_all_single`` a round, so nccl and gloo run the same code).
The schedules are JAX's:

- **GPipe**: stage *s* forwards microbatch *f* at tick ``f + s`` of
  ``M + P - 1``; the backward runs the ticks in reverse, each stage
  backpropagating microbatch *f* at the reverse of the tick it forwarded
  it, with the cotangent its successor sent the tick before.  The output
  is the last stage's, summed over pp from a one-hot (JAX's ``psum``),
  so every stage holds it and computes the loss alike; the input's
  gradient is stage 0's, summed over pp the same way.
- **1F1B** (PipeDream-flush): in round *r* of ``M + 2P - 2`` stage *s*
  forwards microbatch ``r - s`` and backwards microbatch
  ``r - (2P - 2 - s)``; it stashes only the stage INPUTS of the
  microbatches in flight (at most ``min(M, 2P - 1)``) and recomputes
  each stage forward at its backward slot.  The last stage forwards and
  backwards a microbatch in the same round, through the head's SUM-loss
  seeded with ``seed`` (``1/denom`` for a mean loss); it keeps that
  round's graph rather than recompute it (the same values).

What differs from the JAX module:

- explicit SPMD, eager: there is no masked bubble.  A stage runs a
  microbatch only in the slots where it is live, and every stage takes
  part in every round's exchange with the sizes the schedule makes live
  (none on a round where no stage sends).
- a stage function closes over its modules: ``stage_params`` (GPipe)
  and ``trunk_params``/``head_params`` (1F1B) are the tensors it reads,
  and the gradients are taken with ``torch.autograd.grad`` with respect
  to them, one microbatch at a time.  :func:`pipeline_apply` is an
  autograd function whose backward runs the reverse schedule;
  :func:`pipeline_1f1b_grads` returns the gradients, as JAX's does.
- ``pp`` is ``(group, stage, size)`` (``collectives.group_of``), or
  None for one stage.
- ``has_aux`` (MoE stages): a stage function returns ``(h, aux)``, its
  layers' load-balancing loss for one microbatch.  As in JAX, each stage
  sums its live microbatches' aux (the forward slots'), the sum over pp
  divided by ``M`` comes back beside the output, and the aux of every
  stage-microbatch gets the cotangent ``d total / d aux_out / M``
  (GPipe) or the constant ``aux_seed`` (1F1B: ``moe_aux_weight / M``).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor

from paddle_operator_tpu_torch.parallel.collectives import (all_reduce_flat,
                                                            group_of,
                                                            pipeline_hop)


def microbatch(x: torch.Tensor, num_microbatches: int) -> torch.Tensor:
    """[B, ...] -> [M, B/M, ...]."""
    b = x.shape[0]
    if b % num_microbatches:
        raise ValueError(f"batch {b} not divisible by M={num_microbatches}")
    return x.reshape(num_microbatches, b // num_microbatches, *x.shape[1:])


def _live(t: int, stage: int, m: int) -> bool:
    return 0 <= t - stage < m


def _zeros(p: torch.Tensor) -> torch.Tensor:
    """Zeros of ``p``'s local shape."""
    return torch.zeros_like(p.to_local() if isinstance(p, DTensor) else p)


def _local(g: Optional[torch.Tensor], p: torch.Tensor) -> torch.Tensor:
    if g is None:
        return _zeros(p)
    return g.to_local() if isinstance(g, DTensor) else g


def _as_param_grad(local: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """``local`` in the type of parameter ``p`` (a DTensor's gradient is
    a DTensor of its placements)."""
    if not isinstance(p, DTensor):
        return local
    return DTensor.from_local(local, p.device_mesh, p.placements,
                              run_check=False, shape=p.shape,
                              stride=p.stride())


def _extra(extras, f: int) -> tuple:
    return () if extras is None else (extras[f],)


def _sum_over(tensors: List[torch.Tensor], pp) -> None:
    """Sum ``tensors`` in place over the pp group (one stage holds each:
    the others' zeros make it a copy to every stage, JAX's one-hot
    ``psum``).  Half-precision tensors are summed in f32, as JAX's
    ``_psum_act`` does; a sum with zeros is exact either way."""
    if pp is None or pp[2] == 1:
        return
    wide = [t.float() if t.dtype in (torch.bfloat16, torch.float16) else t
            for t in tensors]
    all_reduce_flat(wide, pp[0])
    for t, w in zip(tensors, wide):
        if w is not t:
            t.copy_(w)


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, run, x, *params):
        ctx.run = run
        return run.forward(x, keep=True)

    @staticmethod
    def backward(ctx, g, g_aux=None):
        dx, dparams = ctx.run.backward(g, g_aux)
        ctx.run = None
        return (None, dx) + tuple(dparams)


class _GPipeRun:
    """One GPipe call: the forward schedule (keeping each live
    microbatch's stage graph when asked) and the reverse schedule."""

    def __init__(self, layer_fn, params, extras, pp, m,
                 has_aux=False) -> None:
        self.layer_fn, self.params, self.extras = layer_fn, params, extras
        self.pp, self.m, self.has_aux = pp, m, has_aux
        self.stage, self.n = (0, 1) if pp is None else (pp[1], pp[2])
        self.kept = {}

    def _hop(self, **kw):
        if self.pp is None:
            return None, None
        return pipeline_hop(self.pp, **kw)

    def _run(self, h, f):
        """``(out, aux)`` of this stage on microbatch ``f`` (aux None
        without ``has_aux``)."""
        res = self.layer_fn(h, *_extra(self.extras, f))
        return res if self.has_aux else (res, None)

    def forward(self, x: torch.Tensor, keep: bool):
        s, n, m = self.stage, self.n, self.m
        shape = tuple(x.shape[1:])
        outs = torch.zeros_like(x)
        aux = torch.zeros(1, dtype=torch.float32, device=x.device)
        recv = None
        for t in range(m + n - 1):
            out = None
            if _live(t, s, m):
                f = t - s
                inp = x[f] if s == 0 else recv
                if keep:
                    h = inp.detach().requires_grad_()
                    with torch.enable_grad():
                        o, a = self._run(h, f)
                    self.kept[f] = (h, o, a)
                    out = o.detach()
                else:
                    out, a = self._run(inp, f)
                if a is not None:
                    aux = aux + a.detach().float()
                if s == n - 1:
                    outs[f] = out
            # every stage takes part in a tick's exchange when any stage
            # but the last sends
            if any(_live(t, j, m) for j in range(n - 1)):
                recv, _ = self._hop(
                    fwd=out if s < n - 1 else None,
                    recv_fwd=shape if s > 0 and _live(t, s - 1, m) else None,
                    like=x)
        if not self.has_aux:
            _sum_over([outs], self.pp)
            return outs
        _sum_over([outs, aux], self.pp)
        return outs, aux[0] / m

    def backward(self, g: torch.Tensor, g_aux=None):
        s, n, m = self.stage, self.n, self.m
        shape = tuple(g.shape[1:])
        dx = torch.zeros_like(g)
        dparams = [_zeros(p) for p in self.params]
        recv = None
        for t in reversed(range(m + n - 1)):
            d_in = None
            if _live(t, s, m):
                f = t - s
                cot = g[f] if s == n - 1 else recv
                h, o, a = self.kept.pop(f)
                outputs, cots = [o], [cot]
                if a is not None:
                    outputs.append(a)
                    cots.append((g_aux / m).to(a.dtype))
                grads = torch.autograd.grad(outputs, [h] + list(self.params),
                                            cots, allow_unused=True)
                d_in = grads[0]
                for acc, gp, p in zip(dparams, grads[1:], self.params):
                    acc += _local(gp, p)
                if s == 0:
                    dx[f] = d_in
            if any(_live(t, j, m) for j in range(1, n)):
                _, recv = self._hop(
                    bwd=d_in if s > 0 else None,
                    recv_bwd=(shape if s < n - 1 and _live(t, s + 1, m)
                              else None),
                    like=g)
        _sum_over([dx], self.pp)
        return dx, [_as_param_grad(d, p)
                    for d, p in zip(dparams, self.params)]


def pipeline_apply(layer_fn: Callable, stage_params: Sequence[torch.Tensor],
                   x: torch.Tensor, extras: Optional[torch.Tensor] = None,
                   *, pp, num_microbatches: int, has_aux: bool = False):
    """GPipe over the pp axis ``pp`` ((group, stage, size), or None for
    one stage).

    ``layer_fn(h[, extra])`` applies THIS stage's layer block to one
    microbatch; ``stage_params`` are the tensors it reads (their
    gradients are this stage's).  ``x``: [M, Bm, ...] microbatched input
    (every stage passes the same shape; only stage 0 reads it).
    ``extras``: optional [M, ...] side input a stage needs for ITS
    current microbatch (packed-sequence ``segment_ids``).  Returns the
    last stage's outputs [M, Bm, ...], the same on every stage.
    Differentiable in ``x`` and ``stage_params`` (the backward is the
    reverse schedule; ``x``'s gradient is stage 0's, on every stage).
    With ``has_aux`` ``layer_fn`` returns ``(h, aux)`` and the result is
    ``(out, aux)``: the stages' aux summed over their live microbatches
    and over pp, divided by M, the same on every stage."""
    m = num_microbatches
    if x.shape[0] != m:
        raise ValueError(f"x has {x.shape[0]} microbatches, not M={m}")
    params = list(stage_params)
    run = _GPipeRun(layer_fn, params, extras, pp, m, has_aux)
    if torch.is_grad_enabled() and (x.requires_grad
                                    or any(p.requires_grad for p in params)):
        return _GPipe.apply(run, x, *params)
    return run.forward(x, keep=False)


def make_pipeline_fn(mesh, layer_fn: Callable, *, num_microbatches: int,
                     axis_name: str = "pp"):
    """:func:`pipeline_apply` over the ``axis_name`` axis of the
    DeviceMesh ``mesh``: ``call(stage_params, x, extras=None)``."""
    pp = group_of(mesh, axis_name)

    def call(stage_params, x, extras=None):
        return pipeline_apply(layer_fn, stage_params, x, extras, pp=pp,
                              num_microbatches=num_microbatches)

    return call


def pipeline_1f1b_grads(stage_fn: Callable, head_loss_fn: Callable,
                        trunk_params: Sequence[torch.Tensor],
                        head_params: Sequence[torch.Tensor],
                        xm: torch.Tensor, targets_m: torch.Tensor,
                        mask_m: torch.Tensor, seed,
                        extras: Optional[torch.Tensor] = None, *, pp,
                        has_aux: bool = False, aux_seed=0.0) -> tuple:
    """The 1F1B schedule's forward and backward over the pp axis ``pp``
    ((group, stage, size), or None for one stage), gradients computed
    explicitly (module docstring).

    ``stage_fn(h[, extra])`` -> h': this stage's layer block, reading
    ``trunk_params``.  ``head_loss_fn(h, targets, mask)`` -> scalar
    SUM-loss of one microbatch, reading ``head_params``; its gradient is
    seeded with ``seed`` (``1/denom`` gives the mean loss's
    gradients).  ``xm``, ``targets_m``, ``mask_m``, ``extras``:
    [M, Bm, ...].

    Returns ``(sum_loss, d_trunk, d_head, d_xm)``: ``sum_loss``,
    ``d_head`` and ``d_xm`` the same on every stage (the last stage's
    and stage 0's, summed over pp from a one-hot), ``d_trunk`` this
    stage's; the parameter gradients are local tensors (a DTensor's
    local shard).  With ``has_aux`` ``stage_fn`` returns ``(h', aux)``,
    each stage-microbatch's aux gets the cotangent ``aux_seed``, and a
    fifth item is the stages' forward-slot aux summed over pp, divided
    by M (unscaled)."""
    stage, n = (0, 1) if pp is None else (pp[1], pp[2])
    m = xm.shape[0]
    trunk, head = list(trunk_params), list(head_params)
    is_last = stage == n - 1
    seed = torch.as_tensor(seed, dtype=torch.float32, device=xm.device)
    aux_seed = torch.as_tensor(aux_seed, dtype=torch.float32,
                               device=xm.device)

    def run(h, f):
        res = stage_fn(h, *_extra(extras, f))
        return res if has_aux else (res, None)

    def grad(outputs, inputs, cots):
        """The gradients of ``outputs[0]`` (cotangent ``cots[0]``) and,
        with aux, of the aux (``aux_seed``)."""
        outputs, cots = list(outputs), list(cots)
        if outputs[-1] is None:
            outputs, cots = outputs[:-1], cots[:-1]
        return torch.autograd.grad(outputs, inputs, cots, allow_unused=True)

    aux_sum = torch.zeros(1, dtype=torch.float32, device=xm.device)
    shape = tuple(xm.shape[1:])
    stash = {}                       # microbatch -> its stage input
    kept = {}                        # the last stage's graph of the round
    d_trunk = [_zeros(p) for p in trunk]
    d_head = [_zeros(p) for p in head]
    d_xm = torch.zeros_like(xm)
    loss_sum = torch.zeros((), dtype=torch.float32, device=xm.device)
    act_in = cot_in = None
    for r in range(m + 2 * n - 2):
        # ---- forward slot: microbatch f = r - stage ----
        f = r - stage
        out = None
        if 0 <= f < m:
            inp = xm[f] if stage == 0 else act_in
            stash[f] = inp
            if is_last:
                h = inp.detach().requires_grad_()
                with torch.enable_grad():
                    o, a = run(h, f)
                    loss_f = head_loss_fn(o, targets_m[f], mask_m[f])
                kept[f] = (h, loss_f, a)
                loss_sum = loss_sum + loss_f.detach().float()
            else:
                with torch.no_grad():
                    out, a = run(inp, f)
            if a is not None:
                aux_sum = aux_sum + a.detach().float()
        if len(stash) > min(m, 2 * n - 1):
            raise AssertionError("1F1B stashed more than min(M, 2P-1) "
                                 "stage inputs")
        # ---- backward slot: microbatch b = r - (2n - 2 - stage) ----
        b = r - (2 * n - 2 - stage)
        d_in = None
        if 0 <= b < m:
            saved = stash.pop(b)
            if is_last:
                h, loss_b, a = kept.pop(b)
                grads = grad((loss_b, a), [h] + trunk + head,
                             (seed.to(loss_b.dtype), aux_seed))
                for acc, gp, p in zip(d_head, grads[1 + len(trunk):], head):
                    acc += _local(gp, p)
            else:
                h = saved.detach().requires_grad_()
                with torch.enable_grad():
                    o, a = run(h, b)
                grads = grad((o, a), [h] + trunk, (cot_in, aux_seed))
            d_in = grads[0]
            for acc, gp, p in zip(d_trunk, grads[1:1 + len(trunk)], trunk):
                acc += _local(gp, p)
            if stage == 0:
                d_xm[b] = d_in
        # ---- the round's exchange: activations on, cotangents back ----
        if pp is not None and n > 1:
            act_in, cot_in = pipeline_hop(
                pp, fwd=out if stage < n - 1 else None,
                bwd=d_in if stage > 0 else None,
                recv_fwd=(shape if stage > 0 and 0 <= r - (stage - 1) < m
                          else None),
                recv_bwd=(shape if stage < n - 1
                          and 0 <= r - (2 * n - 3 - stage) < m else None),
                like=xm)
    loss_sum = loss_sum.reshape(1)
    if not has_aux:
        _sum_over([loss_sum] + d_head + [d_xm], pp)
        return loss_sum[0], d_trunk, d_head, d_xm
    _sum_over([loss_sum, aux_sum] + d_head + [d_xm], pp)
    return loss_sum[0], d_trunk, d_head, d_xm, aux_sum[0] / m


def make_pipeline_1f1b_fn(mesh, stage_fn: Callable, head_loss_fn: Callable,
                          *, axis_name: str = "pp"):
    """:func:`pipeline_1f1b_grads` over the ``axis_name`` axis of the
    DeviceMesh ``mesh``: ``call(trunk_params, head_params, xm, targets_m,
    mask_m, seed, extras=None)``."""
    pp = group_of(mesh, axis_name)

    def call(trunk_params, head_params, xm, targets_m, mask_m, seed,
             extras=None):
        return pipeline_1f1b_grads(stage_fn, head_loss_fn, trunk_params,
                                   head_params, xm, targets_m, mask_m, seed,
                                   extras, pp=pp)

    return call
