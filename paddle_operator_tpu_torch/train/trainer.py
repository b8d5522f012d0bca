"""Single-device training loop core — the port of
``paddle_operator_tpu/train/trainer.py``: state creation, the optimizer,
the train step, the eval step and ``fit``.

What differs from the JAX trainer, and why:

- PyTorch runs eagerly, so there is no jit and no donation.  The step
  updates ``state.model``'s parameters and ``state.opt_state`` IN PLACE
  and returns the same :class:`TrainState` (its ``step`` advanced), with
  the metrics as device scalars (no host sync inside a step).
- The parameters live in the model (``nn.Parameter``s); the optimizer
  state is :class:`AdamWState`, keyed by the same parameter names.
- One device.  What the JAX trainer has beyond that is not here yet
  (ROADMAP.md Queue A items 6, 11 and 12): meshes and sharded state (no
  ``mesh`` parameter), host offload of the moments
  (``offload_opt_state``), int8 moments (``moments``), the
  pipeline-parallel step and the ERNIE/Wide&Deep/ResNet steps.  A
  caller that passes one of those parameters gets a ``TypeError``; the
  steps are not defined.
- ``make_train_step`` and ``make_eval_step`` take no model definition:
  the step runs ``state.model``, the eval function the module it is
  given.

The optimizer is optax's ``chain(clip_by_global_norm(grad_clip),
adamw(warmup_cosine_decay_schedule(...), b1=0.9, b2=0.95, eps=1e-8,
weight_decay, mu_dtype=f32))`` of the JAX package, written out as plain
tensor functions in optax's order of operations: the schedule starts at
count 0, so with ``warmup_steps >= 1`` the first update's learning rate
is 0; weight decay applies to every parameter (norm scales and the
embedding too); the clip divides by the global norm only when it
exceeds ``grad_clip`` (no epsilon).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from paddle_operator_tpu_torch.ft.preemption import drain_checkpoint


# ---------------------------------------------------------------------------
# State and optimizer
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AdamWState:
    """optax's AdamW state: ``count`` updates applied (the Adam count and
    the schedule count, which advance together), the first moment ``mu``
    in f32 and the second moment ``nu`` in the parameters' dtype, keyed
    by parameter name."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]


@dataclasses.dataclass
class TrainState:
    """``step``: updates applied; ``model``: the module whose parameters
    are trained (in place); ``opt_state``: its optimizer state."""

    step: int
    model: nn.Module
    opt_state: AdamWState


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """optax's schedule of the same name (exponent 1), evaluated in f32
    as optax evaluates it: a linear warmup from ``init_value`` over
    ``warmup_steps``, then a cosine decay to ``end_value`` over the
    remaining ``decay_steps - warmup_steps``."""
    f = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps
    if not cosine_steps > 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed "
                         f"warmup_steps {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            c = f(max(count, 0))
            frac = f(1) - c / f(warmup_steps)
            return float(f(init_value - peak_value) * frac + f(peak_value))
        c = f(min(count - warmup_steps, cosine_steps))
        cosine = f(0.5) * (f(1) + np.cos(f(np.pi) * c / f(cosine_steps)))
        decayed = f(1 - alpha) * cosine + f(alpha)
        return float(f(peak_value) * decayed)

    return schedule


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm),
    an f32 device scalar."""
    return torch.sqrt(sum(torch.sum(t.float() * t.float())
                          for t in tensors))


class AdamW:
    """Clip by global norm, then AdamW with a learning-rate schedule —
    :func:`make_optimizer` builds it."""

    def __init__(self, schedule: Callable[[int], float], *, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0) -> None:
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip

    def init(self, params: Dict[str, torch.Tensor]) -> AdamWState:
        return AdamWState(
            count=0,
            mu={n: torch.zeros_like(p, dtype=torch.float32)
                for n, p in params.items()},
            nu={n: torch.zeros_like(p) for n, p in params.items()})

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor],
               state: AdamWState) -> torch.Tensor:
        """One update, in place on ``params`` and ``state``.  Returns the
        global norm of the (unclipped) ``grads``."""
        norm = global_norm(grads.values())
        keep = norm < self.grad_clip
        lr = self.schedule(state.count)
        count = state.count + 1
        f = np.float32
        bc1 = float(f(1) - f(self.b1) ** f(count))
        bc2 = float(f(1) - f(self.b2) ** f(count))
        for name, p in params.items():
            g = grads[name]
            g = torch.where(keep, g, (g / norm.to(g.dtype)) * self.grad_clip)
            mu = (1 - self.b1) * g + self.b1 * state.mu[name]
            nu = (1 - self.b2) * (g * g) + self.b2 * state.nu[name]
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = u + self.weight_decay * p
            p.copy_(p + (-lr) * u)
            state.mu[name].copy_(mu)
            state.nu[name].copy_(nu)
        state.count = count
        return norm


def make_optimizer(learning_rate: float = 3e-4, warmup_steps: int = 100,
                   decay_steps: int = 10000, weight_decay: float = 0.1,
                   grad_clip: float = 1.0) -> AdamW:
    """AdamW + warmup-cosine schedule + global-norm clip (the LLaMA
    recipe of the JAX package), moments in f32."""
    schedule = warmup_cosine_decay_schedule(
        0.0, learning_rate, warmup_steps,
        max(decay_steps, warmup_steps + 1), end_value=learning_rate * 0.1)
    return AdamW(schedule, b1=0.9, b2=0.95, weight_decay=weight_decay,
                 grad_clip=grad_clip)


def create_state(model: nn.Module, optimizer: AdamW) -> TrainState:
    """A fresh :class:`TrainState` over ``model``'s parameters (the model
    is already initialized: ``models.llama.make_model``)."""
    return TrainState(step=0, model=model,
                      opt_state=optimizer.init(dict(
                          model.named_parameters())))


# ---------------------------------------------------------------------------
# Loss and steps
# ---------------------------------------------------------------------------


def cross_entropy_loss(logits: torch.Tensor, targets: torch.Tensor,
                       mask: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean next-token xent over masked positions, and its denominator
    ``max(mask.sum(), 1)``.  logits f32 [B, S, V]."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    ll = logp.gather(-1, targets.long()[..., None])[..., 0]
    mask = (torch.ones_like(ll) if mask is None else mask.float())
    denom = torch.clamp(mask.sum(), min=1.0)
    return -(ll * mask).sum() / denom, denom


def make_grads_train_step(compute_grads: Callable,
                          optimizer: AdamW) -> Callable:
    """Train step from an explicit-gradients function
    ``compute_grads(model, batch) -> (metrics, grads)`` (grads keyed by
    parameter name): the optimizer update, ``step`` + 1, and
    ``grad_norm`` (of the unclipped grads) added to the metrics."""

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]):
        metrics, grads = compute_grads(state.model, batch)
        metrics = dict(metrics)
        metrics["grad_norm"] = optimizer.update(
            dict(state.model.named_parameters()), grads, state.opt_state)
        state.step += 1
        return state, metrics

    return step_fn


def make_custom_train_step(batch_loss: Callable,
                           optimizer: AdamW) -> Callable:
    """The generic train step: backward through ``batch_loss(model,
    batch) -> (total_loss, metrics)`` (metrics must include "loss" and
    "tokens"), then the optimizer update."""

    def compute_grads(model: nn.Module, batch):
        for p in model.parameters():
            p.grad = None
        total, aux = batch_loss(model, batch)
        total.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in model.named_parameters()}
        return {k: v.detach() for k, v in aux.items()}, grads

    return make_grads_train_step(compute_grads, optimizer)


def _causal_lm_train_step(forward_loss: Callable,
                          optimizer: AdamW) -> Callable:
    """The JAX package's ``_jit_train_step``: slices the next-token
    (inputs, targets) pair out of ``batch["tokens"]`` (and ``mask[:,
    1:]``, ``segment_ids[:, :-1]``) for ``forward_loss(model, inputs,
    targets, mask, segment_ids)``."""

    def batch_loss(model: nn.Module, batch: Dict[str, torch.Tensor]):
        tokens = batch["tokens"]
        inputs, targets = tokens[:, :-1], tokens[:, 1:]
        mask = batch.get("mask")
        if mask is not None:
            mask = mask[:, 1:]
        seg = batch.get("segment_ids")
        if seg is not None:
            seg = seg[:, :-1]
        return forward_loss(model, inputs, targets, mask, seg)

    return make_custom_train_step(batch_loss, optimizer)


def make_train_step(optimizer: AdamW) -> Callable:
    """The causal-LM train step ``step(state, batch) -> (state,
    metrics)`` for a :class:`models.llama.Llama` (``state.model``).

    batch: {"tokens": int32 [B, S]} (optionally "mask" [B, S] and
    "segment_ids" [B, S] for packed sequences — attention then masks
    cross-document positions).  Computes the next-token loss on
    tokens[:, 1:] and updates the state in place.  Metrics: ``loss``,
    ``tokens`` (the loss denominator) and ``grad_norm``."""

    def forward_loss(m: nn.Module, inputs, targets, mask, segment_ids=None):
        logits = m(inputs, segment_ids)
        loss, denom = cross_entropy_loss(logits, targets, mask)
        return loss, {"loss": loss, "tokens": denom}

    return _causal_lm_train_step(forward_loss, optimizer)


def make_eval_step() -> Callable:
    """``eval_fn(model, batch) -> {"loss": ...}``: the next-token loss
    without gradients.  An optional ``mask`` [B, S] is sliced to the
    targets as in the train step (the JAX eval step expects it already
    [B, S - 1])."""

    @torch.no_grad()
    def eval_fn(m: nn.Module, batch: Dict[str, torch.Tensor]):
        tokens = batch["tokens"]
        mask = batch.get("mask")
        loss, _ = cross_entropy_loss(m(tokens[:, :-1]), tokens[:, 1:],
                                     None if mask is None else mask[:, 1:])
        return {"loss": loss}

    return eval_fn


def synthetic_batch(batch_size: int, seq_len: int, vocab: int,
                    seed: int = 0, device="cuda") -> Dict[str, torch.Tensor]:
    """Deterministic synthetic LM batch from a ``torch.Generator`` seeded
    with ``seed`` on ``device`` (the card unless the caller asks
    otherwise; the numbers differ from ``jax.random``'s)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return {"tokens": torch.randint(0, vocab, (batch_size, seq_len),
                                    generator=gen, dtype=torch.int32,
                                    device=device)}


# ---------------------------------------------------------------------------
# The loop
# ---------------------------------------------------------------------------


def fit(state: TrainState, step_fn: Callable, batches, *, steps: int,
        checkpoint=None, timer=None, logger=None, log_every: int = 0,
        eval_fn: Optional[Callable] = None, eval_every: int = 0,
        preemption=None, goodput=None
        ) -> Tuple[TrainState, List[Dict[str, float]]]:
    """Drive ``step_fn`` over ``batches`` (an iterator of device-ready
    batch dicts — typically a :class:`train.data.DevicePrefetcher`) for
    at most ``steps`` steps, saving through ``checkpoint``
    (:class:`train.checkpoint.CheckpointManager`, under its save
    interval) and ticking ``timer``
    (:class:`utils.observability.StepTimer`) and ``goodput``
    (:class:`ft.goodput.GoodputTracker`) once per step.

    ``eval_fn(state) -> metrics`` runs every ``eval_every`` steps; its
    metrics land in that step's history entry as ``eval_*``.
    ``preemption`` (:class:`ft.preemption.PreemptionWatcher`): once
    draining, the in-flight step finishes, a checkpoint of it is forced
    and made durable (``ft.preemption.drain_checkpoint``), the drain is
    logged (``checkpoint=saved``, or ``DISABLED`` with no manager) and
    the loop returns; the caller then exits ``EXIT_PREEMPTED``.  Returns
    the final state and the per-step float metrics (converted once, at
    the end)."""
    raw_history: List[Dict[str, Any]] = []
    start_step = state.step
    step_no = start_step
    it = iter(batches)
    if goodput is not None:
        # the gap since the tracker's last tick, and this segment's first
        # step (batch fetch, warm-up), are not productive
        goodput.pause()
    for i in range(steps):
        if preemption is not None and preemption.draining:
            break
        try:
            batch = next(it)
        except StopIteration:
            break
        state, metrics = step_fn(state, batch)
        if timer is not None:
            timer.tick()
        if goodput is not None:
            goodput.tick()
        step_no = start_step + i + 1
        if eval_fn is not None and eval_every and step_no % eval_every == 0:
            metrics = dict(metrics)
            metrics.update({f"eval_{k}": v
                            for k, v in eval_fn(state).items()})
            if goodput is not None:
                goodput.pause()   # eval gap is not productive step time
        raw_history.append(metrics)   # device scalars: no host sync
        if checkpoint is not None and checkpoint.enabled:
            checkpoint.save(step_no, state)
        if logger is not None and log_every and (i + 1) % log_every == 0:
            msg = (f"step={step_no} "
                   f"loss={float(metrics.get('loss', math.nan)):.4f}")
            if timer is not None:
                msg += " " + timer.report()
            logger.info(msg)
    if preemption is not None and preemption.draining:
        # the step in flight when the signal landed has completed above;
        # a durable checkpoint of it bounds the lost work by one save
        # interval, not one preemption interval
        device = next(state.model.parameters()).device
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        saved = drain_checkpoint(checkpoint, state, step_no)
        if logger is not None:
            logger.info(f"preemption drain ({preemption.reason}): "
                        f"step={step_no} "
                        f"checkpoint={'saved' if saved else 'DISABLED'}")
    history = [{k: float(v) for k, v in m.items()} for m in raw_history]
    return state, history
