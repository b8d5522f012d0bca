"""Single-device training loop core — the port of
``paddle_operator_tpu/train/trainer.py``: state creation, the optimizer,
the train step, the eval step and ``fit``.

What differs from the JAX trainer, and why:

- PyTorch runs eagerly, so there is no jit and no donation.  The step
  updates ``state.model``'s parameters and ``state.opt_state`` IN PLACE
  and returns the same :class:`TrainState` (its ``step`` advanced), with
  the metrics as device scalars (no host sync inside a step).
- The parameters live in the model (``nn.Parameter``s); the optimizer
  state (:class:`AdamWState`, or :class:`train.opt8bit.AdamW8bitState`
  under ``moments="int8"``) is keyed by the same parameter names.
- A mesh (``parallel/mesh.py``, a ``dp × pp × fsdp × cp × tp``
  DeviceMesh) is explicit SPMD, not a partitioner:
  ``create_state(mesh=...)`` replaces each parameter by a DTensor
  holding this rank's shard under the JAX layout
  (:func:`state_shardings`); f32 moments are local tensors of the same
  shape, laid out as their parameter, and int8 moments are the rank's
  region of the JAX package's global blocks (:class:`AdamW8bit`).  The step takes this rank's rows
  (the batch sharded over (dp, fsdp), replicated over the other axes);
  the model gathers each weight over fsdp where its layer runs and runs
  Megatron's column/row pairs over tp (``parallel/collectives.py``);
  the loss is this rank's share of the global mean (the denominator
  all-reduced, the vocab-sharded logits never gathered); the gradients
  leave the backward reduce-scattered over fsdp and are all-reduced
  over dp and cp (over any token axis a parameter is replicated on)
  BEFORE the clip, whose global norm sums every shard once; each rank
  then updates its shards.  Every metric is global and bit-equal on
  every rank.  On a mesh whose axes are all 1 the step runs exactly the
  single-device operations.
- ``cp`` above 1: the step cuts this rank's chunk of the sequence AFTER
  the next-token shift (inputs, targets, mask and segments alike), the
  layers attend over the whole sequence by ring or Ulysses attention
  (``models/llama.py``), and the loss's denominator counts every rank's
  tokens.  ``pp`` above 1: a rank holds its stage's layers
  (``parallel/mesh.py`` ``stage_mesh``) and :func:`make_pp_train_step`
  runs them through ``parallel/pipeline.py``'s GPipe or 1F1B schedule;
  the embedding, final norm and head are replicated over pp and every
  pp rank ends with the same gradient for them, as under JAX.
- ``ep`` above 1: an MoE layer runs its rank's experts
  (``models/moe.py``) on the tokens of the rank's data block, which
  every ``ep`` rank holds alike; ``ep`` is not a token axis, so an
  expert's gradient stays on its rank and a gradient replicated over
  ``ep`` is the same on every ``ep`` rank and is not summed over it.
  The MoE aux loss joins each rank's share whole: its gradient reaches
  only the rank's own router probabilities, and the sum over the data
  axes makes it the global one.
- int8 moments and moment offload run on every mesh (ROADMAP.md Queue
  A item 8.3): each rank updates, and offloads, its region of the
  moments.  Refused by name: MoE models with ``cp`` above 1 (item 8.6);
  the ERNIE/Wide&Deep/ResNet steps wait for item 9 and are not
  defined.
- ``make_train_step`` and ``make_eval_step`` take no model definition:
  the step runs ``state.model``, the eval function the module it is
  given; neither takes the JAX ``state_sharding`` (the placements ride
  on the parameters).
- Host offload of the moments (``create_state(offload_opt_state=True)``)
  is :class:`MomentOffload`, not a memory kind: between steps every
  moment tensor (f32, or the int8 codes and their scales) lives in
  pinned host memory, and the update streams each parameter's moments
  through a ring of device staging slots on two copy streams, ordered by
  events, with no host sync inside a step.  On the CPU the same staging
  code runs with CPU-to-CPU copies and no pinning.  On a mesh each rank
  pins its own regions of the moments in its own slab.

The optimizer is optax's ``chain(clip_by_global_norm(grad_clip),
adamw(warmup_cosine_decay_schedule(...), b1=0.9, b2=0.95, eps=1e-8,
weight_decay, mu_dtype=f32))`` of the JAX package, written out as plain
tensor functions in optax's order of operations: the schedule starts at
count 0, so with ``warmup_steps >= 1`` the first update's learning rate
is 0; weight decay applies to every parameter (norm scales and the
embedding too); the clip divides by the global norm only when it
exceeds ``grad_clip`` (no epsilon).  ``moments="int8"`` is the JAX
package's ``chain(clip_by_global_norm, scale_by_adam8bit(b1=0.9,
b2=0.95), add_decayed_weights, scale_by_learning_rate)``
(:class:`AdamW8bit`): one launch of ``ops/adam8bit.py``'s kernel per
parameter tensor on the card.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from paddle_operator_tpu_torch.ft.preemption import drain_checkpoint
from paddle_operator_tpu_torch.parallel import collectives as C
from paddle_operator_tpu_torch.parallel import mesh as M
from paddle_operator_tpu_torch.parallel.mesh import mesh_axis_sizes
from paddle_operator_tpu_torch.parallel.pipeline import (microbatch,
                                                         pipeline_1f1b_grads,
                                                         pipeline_apply)
from paddle_operator_tpu_torch.parallel.sharding import (data_block,
                                                         param_q8_layout,
                                                         placement_by_axis,
                                                         placements,
                                                         q8_spec, to_local,
                                                         tree_shardings,
                                                         tree_specs)
from paddle_operator_tpu_torch.train import opt8bit


# ---------------------------------------------------------------------------
# State and optimizer
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class AdamWState:
    """optax's AdamW state: ``count`` updates applied (the Adam count and
    the schedule count, which advance together), the first moment ``mu``
    in f32 and the second moment ``nu`` in the parameters' dtype, keyed
    by parameter name; ``offload`` (a :class:`MomentOffload`) when they
    live in host memory."""

    count: int
    mu: Dict[str, torch.Tensor]
    nu: Dict[str, torch.Tensor]
    offload: Optional["MomentOffload"] = None

    kind = "f32"
    FIELDS = ("mu", "nu")

    def leaves(self, name: str) -> List[torch.Tensor]:
        """The tensors of parameter ``name``, in :data:`FIELDS` order."""
        return [self.mu[name], self.nu[name]]

    def tensors(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """Field -> name -> tensor, what a checkpoint holds."""
        return {"mu": self.mu, "nu": self.nu}

    def replace(self, field: str, name: str, t: torch.Tensor) -> None:
        getattr(self, field)[name] = t


@dataclasses.dataclass
class TrainState:
    """``step``: updates applied; ``model``: the module whose parameters
    are trained (in place); ``opt_state``: its optimizer state;
    ``mesh``: the DeviceMesh its parameters are sharded over (None on
    one device)."""

    step: int
    model: nn.Module
    opt_state: Any
    mesh: Any = None


class MomentOffload:
    """The moments of an offloaded state: host tensors between steps,
    streamed through device staging slots inside the update.

    :meth:`run` walks the parameters in order.  Parameter *i*'s moments
    are copied into slot ``i % SLOTS`` on the H2D stream, updated on the
    current stream, and copied back on the D2H stream; events order the
    three (a slot is refilled only after its D2H, the update waits for
    its H2D, the D2H for the update), so parameter *i+1*'s H2D overlaps
    parameter *i*'s update and parameter *i-1*'s D2H, and the host never
    waits.  Each slot holds one staging tensor per moment field, sized
    by the largest of that field's host tensors at the first step and
    kept (on a mesh: this rank's regions; an int8 update that needs
    whole rows gathers them from the staged region, ``AdamW8bit``).  :meth:`wait`
    blocks the host until the last D2H has landed: a reader of the host
    tensors (the checkpoint snapshot, a restore) calls it first.

    The host tensors are views of ONE allocation (:meth:`adopt`),
    page-locked on the card with ``cudaHostRegister`` (as the serving
    host tier's ``HostSlab``), so the bytes pinned are the bytes the
    moments take (the caching host allocator would round each tensor up
    to a power of two); ``pin_s`` is what making it cost.  ``device``
    "cpu": the same walk with CPU-to-CPU copies, nothing pinned.
    ``timed``: each step records events around its copies;
    :meth:`copy_ms` reads them."""

    SLOTS = 3
    ALIGN = 256

    def __init__(self, device, *, timed: bool = False) -> None:
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._staging: Optional[List[List[torch.Tensor]]] = None
        self._fills: List[Tuple[torch.Tensor, Any]] = []
        self._slab: Optional[torch.Tensor] = None
        self._registered = False
        self.pin_s = 0.0              # seconds spent making host tensors
        self.bytes_each_way = 0       # of the last step
        self.timed = timed
        if self._cuda:
            self._h2d = torch.cuda.Stream(self.device)
            self._d2h = torch.cuda.Stream(self.device)
            event = torch.cuda.Event
            self._loaded = [event() for _ in range(self.SLOTS)]
            self._updated = [event() for _ in range(self.SLOTS)]
            self._free = [event() for _ in range(self.SLOTS)]
            self._flushed = event()
            self._marks = [event(enable_timing=True) for _ in range(4)]

    def new(self, shape, dtype, fill) -> torch.Tensor:
        """A placeholder (no memory) for a moment tensor of ``shape``
        filled with ``fill``: the optimizer's ``init`` makes its state
        with it, then :meth:`adopt` gives every tensor its place in the
        host slab."""
        t = torch.empty(tuple(shape), dtype=dtype, device="meta")
        self._fills.append((t, fill))
        return t

    def adopt(self, opt_state) -> None:
        """Allocate the host slab for ``opt_state``'s placeholders, fill
        each tensor's view and put it in the state.  On the card the
        slab is page-locked; a failed pin raises."""
        t0 = time.perf_counter()
        fills = {id(t): fill for t, fill in self._fills}
        layout, off = [], 0
        for field, tensors in opt_state.tensors().items():
            for name, t in tensors.items():
                nbytes = t.numel() * t.element_size()
                layout.append((field, name, t, off, nbytes))
                off += -(-nbytes // self.ALIGN) * self.ALIGN
        self._slab = torch.empty(max(off, 1), dtype=torch.uint8)
        if self._cuda:
            err = torch.cuda.cudart().cudaHostRegister(
                self._slab.data_ptr(), self._slab.numel(), 0)
            if int(err) != 0:
                raise RuntimeError(f"cudaHostRegister of the moments' "
                                   f"{self._slab.numel()} bytes failed "
                                   f"({err})")
            self._registered = True
        for field, name, t, o, nbytes in layout:
            view = self._slab[o:o + nbytes].view(t.dtype).view(t.shape)
            view.fill_(fills[id(t)])
            opt_state.replace(field, name, view)
        self._fills = []
        self.pin_s = time.perf_counter() - t0

    def close(self) -> None:
        """Unpin the slab (after the last copies over it)."""
        if self._registered:
            self.wait()
            torch.cuda.cudart().cudaHostUnregister(self._slab.data_ptr())
            self._registered = False

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:
            pass

    def _stage(self, slot: int, host: List[torch.Tensor]
               ) -> List[torch.Tensor]:
        return [self._staging[slot][j][:h.numel()].view(h.shape)
                for j, h in enumerate(host)]

    def _size(self, names, leaves_of) -> None:
        """Allocate the staging slots: per field the largest tensor.  On
        the card the copy streams then wait for the current stream: the
        allocator hands out memory that kernels queued there may still
        read, and a copy on another stream would overwrite it."""
        first = leaves_of(names[0])
        sizes = [0] * len(first)
        for name in names:
            for j, h in enumerate(leaves_of(name)):
                if h.dtype != first[j].dtype:
                    raise ValueError(f"moment field {j} of {name} is "
                                     f"{h.dtype}, of {names[0]} "
                                     f"{first[j].dtype}")
                sizes[j] = max(sizes[j], h.numel())
        self._staging = [[torch.empty(n, dtype=h.dtype, device=self.device)
                          for n, h in zip(sizes, first)]
                         for _ in range(self.SLOTS)]
        if self._cuda:
            for slot in self._staging:
                for t in slot:    # freed only after the copy streams
                    t.record_stream(self._h2d)
                    t.record_stream(self._d2h)
            compute = torch.cuda.current_stream(self.device)
            self._h2d.wait_stream(compute)
            self._d2h.wait_stream(compute)

    def run(self, names: List[str],
            leaves_of: Callable[[str], List[torch.Tensor]],
            fn: Callable[[str, List[torch.Tensor]], None]) -> None:
        """``fn(name, staged)`` for each name, on the moments of
        ``leaves_of(name)`` brought to the device and copied back."""
        if not names:
            return
        if self._staging is None:
            self._size(names, leaves_of)
        self.bytes_each_way = sum(h.numel() * h.element_size()
                                  for name in names
                                  for h in leaves_of(name))
        if not self._cuda:
            for name in names:
                host = leaves_of(name)
                staged = self._stage(0, host)
                for s, h in zip(staged, host):
                    s.copy_(h)
                fn(name, staged)
                for s, h in zip(staged, host):
                    h.copy_(s)
            return
        compute = torch.cuda.current_stream(self.device)
        # the host tensors were last written by the previous step's D2H
        self._h2d.wait_stream(self._d2h)
        if self.timed:
            self._marks[0].record(self._h2d)
        for i, name in enumerate(names):
            slot = i % self.SLOTS
            host = leaves_of(name)
            staged = self._stage(slot, host)
            with torch.cuda.stream(self._h2d):
                self._h2d.wait_event(self._free[slot])
                for s, h in zip(staged, host):
                    s.copy_(h, non_blocking=True)
                self._loaded[slot].record(self._h2d)
            compute.wait_event(self._loaded[slot])
            fn(name, staged)
            self._updated[slot].record(compute)
            with torch.cuda.stream(self._d2h):
                self._d2h.wait_event(self._updated[slot])
                if self.timed and i == 0:
                    self._marks[2].record(self._d2h)
                for s, h in zip(staged, host):
                    h.copy_(s, non_blocking=True)
                self._free[slot].record(self._d2h)
        if self.timed:
            self._marks[1].record(self._h2d)
            self._marks[3].record(self._d2h)
        self._flushed.record(self._d2h)

    def wait(self) -> None:
        """Block the host until every D2H copy issued so far is done."""
        if self._cuda:
            self._flushed.synchronize()

    def copy_ms(self) -> Tuple[float, float]:
        """(H2D, D2H) ms of the last timed step: each copy stream's span
        from its first copy to its last, waits for slots and updates
        included."""
        self.wait()
        return (self._marks[0].elapsed_time(self._marks[1]),
                self._marks[2].elapsed_time(self._marks[3]))


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


def _replicas(pl: Dict[str, Any], mesh) -> int:
    """How many ranks hold each shard of a tensor placed by ``pl``
    (placements by axis name, ``parallel/sharding.py``
    ``placement_by_axis``: a stage's layer is not on the pp axis)."""
    sizes = mesh_axis_sizes(mesh)
    n = 1
    for axis, p in pl.items():
        if p.is_replicate():
            n *= int(sizes[axis])
    return n


def sharded_global_norm(grads: Dict[str, torch.Tensor],
                        shardings: Dict[str, Any], mesh) -> torch.Tensor:
    """:func:`global_norm` of the global gradients from this rank's
    shards (``grads`` local tensors, ``shardings`` their placements, as
    :func:`_replicas` takes them): each shard's sum of squares divided
    by its replica count, the sum all-reduced over the mesh, so every
    element counts once (a stage's layers on its stage's ranks only, the
    replicated embedding and head once) and every rank reads the same
    bits.  One rank: :func:`global_norm`."""
    if M.is_trivial(mesh):
        return global_norm(grads.values())
    total = sum(torch.sum(g.float() * g.float())
                / _replicas(shardings[n], mesh) for n, g in grads.items())
    dist.all_reduce(total)
    return torch.sqrt(total)


class AdamW:
    """Clip by global norm, then AdamW with a learning-rate schedule, f32
    moments — :func:`make_optimizer` builds it."""

    def __init__(self, schedule: Callable[[int], float], *, b1: float = 0.9,
                 b2: float = 0.95, eps: float = 1e-8,
                 weight_decay: float = 0.1, grad_clip: float = 1.0) -> None:
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.grad_clip = grad_clip

    def init(self, params: Dict[str, torch.Tensor],
             offload: Optional[MomentOffload] = None) -> AdamWState:
        """Zero moments, on the parameters' devices or, with ``offload``,
        as its placeholders (``create_state`` puts them in host
        memory)."""
        if offload is None:
            return AdamWState(
                count=0,
                mu={n: torch.zeros_like(p, dtype=torch.float32)
                    for n, p in params.items()},
                nu={n: torch.zeros_like(p) for n, p in params.items()})
        return AdamWState(
            count=0,
            mu={n: offload.new(p.shape, torch.float32, 0)
                for n, p in params.items()},
            nu={n: offload.new(p.shape, p.dtype, 0)
                for n, p in params.items()},
            offload=offload)

    def _tensor_update(self, norm: torch.Tensor, lr: float, count: int,
                       state) -> Callable:
        """``fn(name, p, g, [mu, nu])``: one parameter's update, in
        place."""
        keep = norm < self.grad_clip
        f = np.float32
        bc1 = float(f(1) - f(self.b1) ** f(count))
        bc2 = float(f(1) - f(self.b2) ** f(count))

        def fn(name, p, g, leaves):
            mu_old, nu_old = leaves
            g = torch.where(keep, g, (g / norm.to(g.dtype)) * self.grad_clip)
            mu = (1 - self.b1) * g + self.b1 * mu_old
            nu = (1 - self.b2) * (g * g) + self.b2 * nu_old
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            u = u + self.weight_decay * p
            p.copy_(p + (-lr) * u)
            mu_old.copy_(mu)
            nu_old.copy_(nu)

        return fn

    @torch.no_grad()
    def update(self, params: Dict[str, torch.Tensor],
               grads: Dict[str, torch.Tensor], state,
               norm: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One update, in place on ``params`` and ``state``.  Returns the
        global norm of the (unclipped) ``grads`` — ``norm`` when given
        (a mesh step's norm over every shard), else computed here."""
        if norm is None:
            norm = global_norm(grads.values())
        count = state.count + 1
        fn = self._tensor_update(norm, self.schedule(state.count), count,
                                 state)
        if state.offload is None:
            for name, p in params.items():
                fn(name, p, grads[name], state.leaves(name))
        else:
            state.offload.run(
                list(params), state.leaves,
                lambda name, staged: fn(name, params[name], grads[name],
                                        staged))
        state.count = count
        return norm


def _nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class AdamW8bit(AdamW):
    """:class:`AdamW` with block-quantized int8 moments
    (train/opt8bit.py): the same interface and schedule, the update of
    each tensor one call of ``ops/adam8bit.py`` ``adam8bit_update`` (the
    kernel on the card, the plain version on the CPU).

    On a mesh each rank holds its region of the GLOBAL blocks
    (``parallel/sharding.py`` ``Q8Layout``), and a parameter's update
    follows its case:

    - ``ALIGNED``: the rank's blocks are its columns' blocks; one call
      on the local shard, as on one card;
    - ``REPLICATED``: every rank of the last axis's mesh axes holds
      every block of its rows; ``g`` and ``p`` are gathered over those
      axes, the call runs on the whole rows (every rank computes the
      same moments, which are not reduced afterwards), and the rank
      keeps its own parameter columns;
    - ``UNALIGNED``: ``g``, ``p`` and the codes and scales are gathered,
      the call runs on the whole rows, and the rank keeps its own
      blocks and its own columns.

    The kernel's arithmetic is elementwise with a max over each block,
    so the whole-row call gives every element the bits the one-card
    update gives it."""

    def init(self, params: Dict[str, torch.Tensor],
             offload: Optional[MomentOffload] = None,
             layout: Optional[Dict[str, Any]] = None
             ) -> opt8bit.AdamW8bitState:
        """Zero moments for ``params`` (``layout``: name -> ``Q8Layout``
        of a state on a mesh; the tensors are the rank's regions)."""
        state = opt8bit.init_state(
            params, None if offload is None else offload.new, layout)
        state.offload = offload
        return state

    def _tensor_update(self, norm: torch.Tensor, lr: float, count: int,
                       state) -> Callable:
        from paddle_operator_tpu_torch.ops.adam8bit import (Adam8bitConsts,
                                                            adam8bit_update)
        from paddle_operator_tpu_torch.parallel.sharding import (ALIGNED,
                                                                 UNALIGNED)

        consts = Adam8bitConsts.make(
            b1=self.b1, b2=self.b2, eps=self.eps,
            weight_decay=self.weight_decay, lr=lr, clip=self.grad_clip,
            count=count)
        layout = state.layout or {}

        def fn(name, p, g, leaves):
            lay = layout.get(name)
            if lay is None or lay.case == ALIGNED:
                mc, ms, nc, ns = leaves
                adam8bit_update(p, g.contiguous(), opt8bit.Q8(mc, ms),
                                opt8bit.Q8(nc, ns), norm, consts)
                return
            # the rows along the last axis (p, g; unaligned: the codes
            # and scales too, along their block-count dim)
            cut = [(p, -1), (g, -1)]
            if lay.case == UNALIGNED:
                cut += [(t, -2) for t in leaves]
            whole = [C.gather_along(t, d, lay.groups) for t, d in cut]
            C.EXCHANGE["q8_" + lay.case] += \
                _nbytes(whole) - _nbytes(t for t, _ in cut)
            pw, gw, *moments = whole
            mc, ms, nc, ns = moments or leaves
            adam8bit_update(pw, gw, opt8bit.Q8(mc, ms), opt8bit.Q8(nc, ns),
                            norm, consts)
            p.copy_(pw[..., lay.columns])
            for t, w in zip(leaves, moments):
                t.copy_(w[..., lay.blocks, :])

        return fn


def make_optimizer(learning_rate: float = 3e-4, warmup_steps: int = 100,
                   decay_steps: int = 10000, weight_decay: float = 0.1,
                   grad_clip: float = 1.0, moments: str = "f32") -> AdamW:
    """AdamW + warmup-cosine schedule + global-norm clip (the LLaMA
    recipe of the JAX package).  ``moments="int8"`` stores both moments
    block-quantized (:class:`AdamW8bit`, ~3.9x smaller than f32: the
    single-card depth recipe at 7b width, alone or with the host
    offload, which then moves a quarter of the bytes)."""
    schedule = warmup_cosine_decay_schedule(
        0.0, learning_rate, warmup_steps,
        max(decay_steps, warmup_steps + 1), end_value=learning_rate * 0.1)
    if moments not in ("f32", "int8"):
        raise ValueError(f"unknown moments dtype {moments!r} "
                         "(expected 'f32' or 'int8')")
    cls = AdamW8bit if moments == "int8" else AdamW
    return cls(schedule, b1=0.9, b2=0.95, weight_decay=weight_decay,
               grad_clip=grad_clip)


@dataclasses.dataclass
class StateShardings:
    """The placements of a sharded :class:`TrainState`: ``params`` maps
    each parameter name to its DTensor placements (one a mesh axis, in
    ``parallel.mesh.AXIS_ORDER``; under pp a layer's are over the
    stage's axes, ``parallel.mesh.STAGE_AXES``), ``opt_state`` each
    moment field (``opt_state.tensors()``'s keys) to such a map: an f32
    moment takes its parameter's placements, int8 codes and scales
    JAX's q8 leaf placements (``parallel/sharding.py`` ``q8_spec``).
    ``stages`` maps each layer's names to the pp stage that holds it
    (empty without pp)."""

    params: Dict[str, tuple]
    opt_state: Dict[str, Dict[str, tuple]]
    stages: Dict[str, int] = dataclasses.field(default_factory=dict)

    def spec(self, name: str, ndim: int) -> tuple:
        """JAX's PartitionSpec tuple of parameter ``name`` (of ``ndim``
        dims): its placements' mesh axes, after ``"pp"`` for a stage's
        layer (JAX's stacked ``layers`` dim, sharded over pp)."""
        from paddle_operator_tpu_torch.parallel.sharding import spec_of

        if name not in self.stages:
            return spec_of(self.params[name], M.AXIS_ORDER, ndim)
        return ("pp",) + spec_of(self.params[name], M.STAGE_AXES, ndim)


def state_shardings(model: nn.Module, optimizer: AdamW, mesh, *,
                    offload_opt_state: bool = False) -> StateShardings:
    """Plan the placements of ``model``'s training state on ``mesh``
    without moving anything: the JAX package's ``tree_shardings`` over
    ``models.llama.partition_patterns(model.cfg)`` (the JAX signature's
    ``partition_patterns`` and ``example_inputs`` are not parameters:
    the model is a LLaMA, already built).  Under pp each layer goes to
    its stage (``models.llama.layer_stage``) with the placements of the
    rest of its spec over the stage's sub-mesh.  Refused by name: an MoE
    model with ``cp`` above 1 (ROADMAP.md Queue A item 8.6), a tp that
    splits a GQA group, ``n_layers`` indivisible by pp, an unknown
    ``cp_impl`` and Ulysses that cannot split a rank's heads.  int8
    moments and ``offload_opt_state`` are accepted on every mesh (item
    8.3; where the moments live does not change their placements, as
    JAX's memory kind does not change its shardings' specs)."""
    from paddle_operator_tpu_torch.models import llama

    M.require_mesh(mesh)
    cfg = model.cfg
    sizes = mesh_axis_sizes(mesh)
    patterns = llama.partition_patterns(cfg)
    llama.check_tp(cfg, sizes["tp"])
    llama.check_cp(cfg, sizes["cp"], sizes["tp"])
    llama.check_moe(cfg, sizes["cp"])
    named = dict(model.named_parameters())
    stages = {}
    if sizes["pp"] > 1:
        # every layer's stage, whether or not this rank still holds it
        idx = {n: llama.layer_index(n) for n in named}
        stages = {n: llama.layer_stage(cfg, i, sizes["pp"])
                  for n, i in idx.items() if i is not None}
    params = tree_shardings(named, mesh, patterns, stage_names=stages)
    if not isinstance(optimizer, AdamW8bit):
        return StateShardings(
            params=params,
            opt_state={f: dict(params) for f in AdamWState.FIELDS},
            stages=stages)
    specs = tree_specs(named, mesh, patterns)
    q8 = {n: placements(q8_spec(p.shape, specs[n], sizes),
                        M.STAGE_AXES if n in stages else mesh)
          for n, p in named.items()}
    return StateShardings(
        params=params,
        opt_state={f: dict(q8) for f in opt8bit.AdamW8bitState.FIELDS},
        stages=stages)


def _shard_parameters(model: nn.Module, mesh,
                      shardings: StateShardings) -> None:
    """Replace each parameter of ``model`` by a DTensor Parameter holding
    this rank's shard of it (the full tensor is released); under pp a
    layer of another stage is replaced by a placeholder
    (``models.llama.OtherStage``) and a layer of this rank's stage is
    laid over the stage's sub-mesh."""
    from paddle_operator_tpu_torch.models.llama import (OtherStage,
                                                        layer_index)
    from paddle_operator_tpu_torch.parallel.sharding import shard_tensor

    mine = M.coordinates(mesh)["pp"]
    sub = M.stage_mesh(mesh) if shardings.stages else None
    for name, p in list(model.named_parameters()):
        stage = shardings.stages.get(name)
        if stage is not None and stage != mine:
            i = layer_index(name)
            if not isinstance(model.layers[i], OtherStage):
                model.layers[i] = OtherStage(i, stage)
            continue
        owner, _, leaf = name.rpartition(".")
        module = model.get_submodule(owner) if owner else model
        setattr(module, leaf, nn.Parameter(
            shard_tensor(p.detach(), mesh if stage is None else sub,
                         shardings.params[name]),
            requires_grad=p.requires_grad))


def create_state(model: nn.Module, optimizer: AdamW, *,
                 offload_opt_state: bool = False,
                 mesh=None) -> TrainState:
    """A fresh :class:`TrainState` over ``model``'s parameters (the model
    is already initialized: ``models.llama.make_model``).
    ``offload_opt_state``: the moments are made in host memory (pinned
    on the card) and stay there between steps (:class:`MomentOffload`);
    the device then holds only the staging slots.

    ``mesh``: the parameters are sharded over it by
    :func:`state_shardings` (the same values as the single-device init,
    then cut: every rank built the whole model from the same seed), and
    the moments are made for the local shards (int8: the rank's regions
    of the global blocks, each parameter's ``Q8Layout`` kept in the
    state)."""
    M.require_mesh(mesh)
    kw = {}
    if mesh is not None:
        shardings = state_shardings(model, optimizer, mesh,
                                    offload_opt_state=offload_opt_state)
        _shard_parameters(model, mesh, shardings)
        if isinstance(optimizer, AdamW8bit) and not M.is_trivial(mesh):
            kw["layout"] = {n: param_q8_layout(p)
                            for n, p in model.named_parameters()}
    with torch.no_grad():
        params = {n: to_local(p) for n, p in model.named_parameters()}
    if not offload_opt_state:
        return TrainState(step=0, model=model,
                          opt_state=optimizer.init(params, **kw), mesh=mesh)
    offload = MomentOffload(next(iter(params.values())).device)
    opt_state = optimizer.init(params, offload, **kw)
    offload.adopt(opt_state)
    return TrainState(step=0, model=model, opt_state=opt_state, mesh=mesh)


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


def _reduce_grads(grads: Dict[str, torch.Tensor],
                  shardings: Dict[str, Any], mesh) -> None:
    """Sum each local gradient over the token axes (dp, fsdp, cp) its
    parameter is replicated on (one flat all-reduce an axis); over an
    axis that shards it the gradient was reduce-scattered in the
    backward.  Under cp every gradient is a partial sum over the
    sequence's chunks.  ``shardings``: placements as :func:`_replicas`
    takes them."""
    for axis in M.TOKEN_AXES:
        group = M.axis_group(mesh, axis)
        if group is None:
            continue
        todo = [g for n, g in grads.items()
                if shardings[n][axis].is_replicate()]
        if todo:
            C.all_reduce_flat(todo, group)


def make_grads_train_step(compute_grads: Callable, optimizer: AdamW,
                          mesh=None) -> Callable:
    """Train step from an explicit-gradients function
    ``compute_grads(model, batch) -> (metrics, grads)`` (grads keyed by
    parameter name): the optimizer update, ``step`` + 1, and
    ``grad_norm`` (of the unclipped grads) added to the metrics.

    ``mesh``: the state's parameters are sharded over it.  The batch's
    tensors are this rank's rows (DTensors from
    ``train/data.py`` ``DevicePrefetcher(mesh=...)`` or
    ``parallel/sharding.py`` ``shard_batch``, or their local tensors);
    ``compute_grads`` gets the local rows and returns global metrics and
    each parameter's gradient for this rank's shard, which is reduced
    over the data axes (:func:`_reduce_grads`) before the clip reads the
    global norm (:func:`sharded_global_norm`)."""
    M.require_mesh(mesh)

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]):
        if mesh is not None:
            batch = {k: to_local(v) for k, v in batch.items()}
        metrics, grads = compute_grads(state.model, batch)
        metrics = dict(metrics)
        named = dict(state.model.named_parameters())
        if mesh is None:
            metrics["grad_norm"] = optimizer.update(named, grads,
                                                    state.opt_state)
        else:
            shardings = {n: placement_by_axis(p) for n, p in named.items()}
            with torch.no_grad():
                named = {n: to_local(p) for n, p in named.items()}
                grads = {n: to_local(g) for n, g in grads.items()}
                _reduce_grads(grads, shardings, mesh)
                norm = sharded_global_norm(grads, shardings, mesh)
            metrics["grad_norm"] = optimizer.update(
                named, grads, state.opt_state, norm=norm)
        state.step += 1
        return state, metrics

    return step_fn


def _cp_chunk(t: Optional[torch.Tensor], mesh) -> Optional[torch.Tensor]:
    """This rank's contiguous chunk of dim 1 of ``t`` (a [B, S, ...]
    slice of the batch) on a mesh whose cp axis is above 1."""
    cp = C.group_of(mesh, "cp") if mesh is not None else None
    if t is None or cp is None:
        return t
    _, rank, n = cp
    if t.shape[1] % n:
        raise ValueError(f"sequence length {t.shape[1]} (tokens - 1) is not "
                         f"divisible by cp={n}")
    per = t.shape[1] // n
    return t[:, rank * per:(rank + 1) * per]


def make_custom_train_step(batch_loss: Callable, optimizer: AdamW,
                           mesh=None) -> Callable:
    """The generic train step: backward through ``batch_loss(model,
    batch) -> (total_loss, metrics)`` (metrics must include "loss" and
    "tokens"), then the optimizer update.  On a ``mesh`` ``batch_loss``
    gets this rank's rows and returns its share of the total (the
    gradients are summed over the data axes) and metrics that are
    already global."""

    def compute_grads(model: nn.Module, batch):
        for p in model.parameters():
            p.grad = None
        total, aux = batch_loss(model, batch)
        total.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in model.named_parameters()}
        return {k: v.detach() for k, v in aux.items()}, grads

    return make_grads_train_step(compute_grads, optimizer, mesh)


def _next_token(batch: Dict[str, torch.Tensor], mesh=None) -> tuple:
    """(inputs, targets, mask, segment_ids) of a causal-LM batch:
    ``tokens[:, :-1]``, ``tokens[:, 1:]``, ``mask[:, 1:]`` and
    ``segment_ids[:, :-1]`` (None when absent), each cut to this rank's
    cp chunk after the shift."""
    tokens = batch["tokens"]
    mask, seg = batch.get("mask"), batch.get("segment_ids")
    return tuple(_cp_chunk(t, mesh) for t in (
        tokens[:, :-1], tokens[:, 1:],
        None if mask is None else mask[:, 1:],
        None if seg is None else seg[:, :-1]))


def _causal_lm_train_step(forward_loss: Callable, optimizer: AdamW,
                          mesh=None) -> Callable:
    """The JAX package's ``_jit_train_step``: slices the next-token
    (inputs, targets) pair out of ``batch["tokens"]`` (and ``mask[:,
    1:]``, ``segment_ids[:, :-1]``; under cp this rank's chunk of each,
    :func:`_next_token`) for ``forward_loss(model, inputs, targets, mask,
    segment_ids)``."""

    def batch_loss(model: nn.Module, batch: Dict[str, torch.Tensor]):
        return forward_loss(model, *_next_token(batch, mesh))

    return make_custom_train_step(batch_loss, optimizer, mesh)


def _token_log_prob(logits: torch.Tensor, targets: torch.Tensor,
                    mesh) -> torch.Tensor:
    """log softmax(logits)[target] per position; under tp from this
    rank's vocab slice (``parallel/collectives.py``
    ``vocab_parallel_log_prob``: nothing gathers the logits)."""
    tp = C.group_of(mesh, "tp")
    if tp is None:
        logp = torch.log_softmax(logits.float(), dim=-1)
        return logp.gather(-1, targets.long()[..., None])[..., 0]
    return C.vocab_parallel_log_prob(logits.float(), targets, tp)


def _all_reduce_tokens(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t`` summed in place over the token axes (dp, fsdp, cp)."""
    return C.all_reduce_data(t, mesh, axes=M.TOKEN_AXES)


def _mesh_loss(logits: torch.Tensor, targets: torch.Tensor,
               mask: Optional[torch.Tensor], mesh
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """This rank's share of the global mean next-token xent, the global
    loss and the global denominator ``max(sum of every rank's mask,
    1)``.  ``logits``: this rank's rows (under cp its chunk of them)
    and, under tp, its vocab slice.  With every axis of size 1 these are
    the operations of :func:`cross_entropy_loss`."""
    ll = _token_log_prob(logits, targets, mesh)
    mask = (torch.ones_like(ll) if mask is None else mask.float())
    denom = torch.clamp(_all_reduce_tokens(mask.sum().detach(), mesh),
                        min=1.0)
    share = -(ll * mask).sum() / denom
    return share, _all_reduce_tokens(share.detach().clone(), mesh), denom


def _logits_aux(out) -> tuple:
    """(logits, aux) of a forward's output: an MoE model's pair, or the
    logits and None."""
    return out if isinstance(out, tuple) else (out, None)


def _add_aux(loss: torch.Tensor, metrics: Dict[str, torch.Tensor],
             aux: Optional[torch.Tensor]) -> tuple:
    """(the optimized total, metrics): ``loss`` alone, or with an MoE
    model's scaled aux added and reported as ``aux_loss``."""
    if aux is None:
        return loss, metrics
    metrics["aux_loss"] = aux
    return loss + aux, metrics


def _microbatch_rows(m: nn.Module, batch: Dict[str, torch.Tensor], mesh,
                     nm: int) -> Dict[str, torch.Tensor]:
    """This rank's rows for a pipeline step of ``nm`` microbatches.  JAX
    cuts the GLOBAL batch into microbatches (microbatch *j* is rows
    ``[j·B/M, (j+1)·B/M)``), and an MoE layer routes over a
    microbatch's tokens; so for an MoE model on more than one data block
    the global batch is gathered over the data axes (tokens only, no
    gradient) and this rank keeps, for each microbatch, its block's share
    of it, in order.  A dense model, one microbatch or one block: the
    batch as it is."""
    groups = [M.axis_group(mesh, a) for a in M.DATA_AXES]
    groups = [g for g in groups if g is not None]
    if m.cfg.n_experts == 0 or nm == 1 or not groups:
        return batch
    index, count = data_block(mesh)
    out = {}
    for k, v in batch.items():
        whole = C.all_gather_blocks(v, groups)
        whole = whole.reshape(-1, *v.shape[1:])
        if whole.shape[0] % (nm * count):
            raise ValueError(f"global batch {whole.shape[0]} is not "
                             f"divisible by {nm} microbatches of "
                             f"{count} data blocks")
        out[k] = whole.reshape(nm, count, -1, *v.shape[1:])[:, index] \
            .reshape(v.shape)
    return out


def make_train_step(optimizer: AdamW, mesh=None) -> Callable:
    """The causal-LM train step ``step(state, batch) -> (state,
    metrics)`` for a :class:`models.llama.Llama` (``state.model``).

    batch: {"tokens": int32 [B, S]} (optionally "mask" [B, S] and
    "segment_ids" [B, S] for packed sequences — attention then masks
    cross-document positions).  Computes the next-token loss on
    tokens[:, 1:] and updates the state in place.  Metrics: ``loss``,
    ``tokens`` (the loss denominator) and ``grad_norm``; for an MoE
    model (its forward returns ``(logits, aux)``, aux already scaled by
    ``moe_aux_weight``) also ``aux_loss``, which joins the optimized
    total while ``loss`` stays the task loss.

    ``mesh``: the step of a state sharded over it
    (:func:`make_grads_train_step`); ``loss`` and ``tokens`` are the
    global batch's, on every rank."""

    M.require_mesh(mesh)
    if mesh is not None:
        if mesh_axis_sizes(mesh)["pp"] > 1:
            raise ValueError("a mesh with pp > 1 needs the pipeline step "
                             "(make_pp_train_step, or make_step_for_mesh)")

        def mesh_loss(m: nn.Module, inputs, targets, mask, segment_ids=None):
            logits, aux = _logits_aux(m(inputs, segment_ids))
            share, loss, denom = _mesh_loss(logits, targets, mask, mesh)
            return _add_aux(share, {"loss": loss, "tokens": denom}, aux)

        return _causal_lm_train_step(mesh_loss, optimizer, mesh)

    def forward_loss(m: nn.Module, inputs, targets, mask, segment_ids=None):
        logits, aux = _logits_aux(m(inputs, segment_ids))
        loss, denom = cross_entropy_loss(logits, targets, mask)
        return _add_aux(loss, {"loss": loss, "tokens": denom}, aux)

    return _causal_lm_train_step(forward_loss, optimizer)


def make_eval_step(mesh=None) -> Callable:
    """``eval_fn(model, batch) -> {"loss": ...}``: the next-token loss
    without gradients.  An optional ``mask`` [B, S] is sliced to the
    targets as in the train step (the JAX eval step expects it already
    [B, S - 1]).  An MoE model's logits come out of its ``(logits,
    aux)`` pair.  ``mesh``: the model is sharded over it, the batch is
    this rank's rows (as the train step takes them) and the loss is the
    global batch's, on every rank."""
    M.require_mesh(mesh)
    pp = None if mesh is None else C.group_of(mesh, "pp")

    @torch.no_grad()
    def eval_fn(m: nn.Module, batch: Dict[str, torch.Tensor]):
        if mesh is None:
            tokens = batch["tokens"]
            mask = batch.get("mask")
            mask = None if mask is None else mask[:, 1:]
            out = m(tokens[:, :-1])
            logits = out[0] if isinstance(out, tuple) else out
            loss, _ = cross_entropy_loss(logits, tokens[:, 1:], mask)
            return {"loss": loss}
        inputs, targets, mask, _ = _next_token(
            {k: to_local(v) for k, v in batch.items()
             if k in ("tokens", "mask")}, mesh)
        if pp is None:
            out = m(inputs)
            logits = out[0] if isinstance(out, tuple) else out
        else:
            stack = m.stage_layers()
            x = m.embed(inputs)
            y = pipeline_apply(
                lambda h: stack(h, m.rope_cos, m.rope_sin)[0],
                list(stack.parameters()), x[None], pp=pp,
                num_microbatches=1)[0]
            logits = m.head(y)
        return {"loss": _mesh_loss(logits, targets, mask, mesh)[1]}

    return eval_fn


def make_pp_train_step(optimizer: AdamW, mesh, *, num_microbatches: int,
                       schedule: str = "gpipe") -> Callable:
    """Pipeline-parallel LLaMA train step over the ``pp`` mesh axis (JAX
    ``make_pp_train_step``), composing with dp, fsdp, cp and tp.

    Each rank runs its stage's layers (``models.llama.Llama
    .stage_layers``, the same per-layer remat as the step without pp)
    over ``num_microbatches`` microbatches of its rows through
    ``parallel/pipeline.py``; the embedding and the head are replicated
    over pp.

    - ``schedule="gpipe"``: every pp rank embeds the inputs,
      ``pipeline_apply`` returns the last stage's output on every rank,
      and every rank computes the head and the loss alike; the backward
      runs the reverse schedule, and the embedding's gradient is stage
      0's input gradient on every rank.
    - ``schedule="1f1b"``: ``pipeline_1f1b_grads`` runs the
      PipeDream-flush schedule, the last stage computes each
      microbatch's head SUM-loss seeded with ``1/denom`` (the global
      token count), and the loss and the head's gradients reach every
      pp rank from it; the embedding backpropagates stage 0's input
      gradient on every rank.

    An MoE model routes each microbatch over its global tokens, as JAX
    does: the rows are regrouped first (:func:`_microbatch_rows`) so
    that a rank's microbatch *m* is its data block's share of JAX's
    microbatch *m*; each stage sums its layers' aux over its live
    microbatches, the sum over pp divided by M times ``moe_aux_weight``
    joins the loss (GPipe) or seeds each stage-microbatch's aux with
    ``moe_aux_weight / M`` (1F1B), and ``aux_loss`` is reported.

    Refused as JAX refuses: pp <= 1, an unknown schedule, and (at
    ``create_state``) ``n_layers`` not divisible by pp.  JAX's
    ``scan_layers`` check has no counterpart (the port's layers are
    always separate modules)."""
    M.require_mesh(mesh)
    pp = C.group_of(mesh, "pp")
    if pp is None:
        raise ValueError("make_pp_train_step needs a mesh with pp > 1")
    if schedule not in ("gpipe", "1f1b"):
        raise ValueError(f"unknown pipeline schedule {schedule!r}")
    nm = num_microbatches

    def stage_fn_of(m: nn.Module):
        stack = m.stage_layers()
        moe = m.cfg.n_experts > 0

        def stage_fn(h, seg=None):
            y, aux = stack(h, m.rope_cos, m.rope_sin, seg)
            return (y, aux) if moe else y

        return stack, stage_fn

    def inputs_of(m: nn.Module, batch):
        return _next_token(_microbatch_rows(m, batch, mesh, nm), mesh)

    if schedule == "gpipe":
        def batch_loss(m: nn.Module, batch):
            inputs, targets, mask, segment_ids = inputs_of(m, batch)
            stack, stage_fn = stage_fn_of(m)
            moe = m.cfg.n_experts > 0
            x = m.embed(inputs)
            sm = (None if segment_ids is None
                  else microbatch(segment_ids, nm))
            out = pipeline_apply(stage_fn, list(stack.parameters()),
                                 microbatch(x, nm), sm, pp=pp,
                                 num_microbatches=nm, has_aux=moe)
            ym, aux = out if moe else (out, None)
            logits = m.head(ym.reshape(x.shape))
            share, loss, denom = _mesh_loss(logits, targets, mask, mesh)
            return _add_aux(share, {"loss": loss, "tokens": denom},
                            None if aux is None
                            else aux * m.cfg.moe_aux_weight)

        return make_custom_train_step(batch_loss, optimizer, mesh)

    def compute_grads(m: nn.Module, batch):
        inputs, targets, mask, seg = inputs_of(m, batch)
        stack, stage_fn = stage_fn_of(m)
        moe = m.cfg.n_experts > 0
        msk = (torch.ones(targets.shape, dtype=torch.float32,
                          device=targets.device)
               if mask is None else mask.float())
        denom = torch.clamp(_all_reduce_tokens(msk.sum(), mesh), min=1.0)

        def head_loss(h, tgt, mk):
            # SUM-loss of one microbatch: the schedule seeds its
            # gradient with 1/denom
            return -(_token_log_prob(m.head(h), tgt, mesh) * mk).sum()

        for p in m.parameters():
            p.grad = None
        x = m.embed(inputs)
        trunk = list(stack.parameters())
        head = list(m.final_norm.parameters()) \
            + list(m.lm_head.parameters())
        res = pipeline_1f1b_grads(
            stage_fn, head_loss, trunk, head, microbatch(x.detach(), nm),
            microbatch(targets, nm), microbatch(msk, nm), 1.0 / denom,
            None if seg is None else microbatch(seg, nm), pp=pp,
            has_aux=moe, aux_seed=m.cfg.moe_aux_weight / nm if moe else 0.0)
        loss_sum, d_trunk, d_head, d_xm = res[:4]
        x.backward(d_xm.reshape(x.shape))
        grads = {n: p.grad for n, p in m.tok_embed.named_parameters(
            prefix="tok_embed")}
        by_id = {id(p): n for n, p in m.named_parameters()}
        for p, g in zip(trunk + head, d_trunk + d_head):
            grads[by_id[id(p)]] = g
        loss = _all_reduce_tokens((loss_sum / denom).reshape(1), mesh)[0]
        metrics = {"loss": loss, "tokens": denom}
        if moe:
            metrics["aux_loss"] = res[4] * m.cfg.moe_aux_weight
        return metrics, grads

    return make_grads_train_step(compute_grads, optimizer, mesh)


def make_step_for_mesh(optimizer: AdamW, mesh, *, num_microbatches: int = 4,
                       schedule: str = "gpipe") -> Callable:
    """The train step for ``mesh``: :func:`make_pp_train_step` (the
    ``schedule``, over ``num_microbatches``) when pp > 1, else
    :func:`make_train_step` on it (JAX ``make_step_for_mesh``)."""
    M.require_mesh(mesh)
    if mesh_axis_sizes(mesh)["pp"] > 1:
        return make_pp_train_step(optimizer, mesh,
                                  num_microbatches=num_microbatches,
                                  schedule=schedule)
    return make_train_step(optimizer, mesh=mesh)


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
    the end).

    A state on a mesh of more than one rank: every rank runs the loop
    (the metrics are global), only rank 0 logs and ticks ``timer``, and
    the ranks agree before each step whether any of them is draining
    (a host-side all-reduce over the mesh's gloo group), so they stop
    after the same step and drain together."""
    mesh = None if M.is_trivial(state.mesh) else state.mesh
    if mesh is not None and dist.get_rank() != 0:
        logger = timer = None
    raw_history: List[Dict[str, Any]] = []
    start_step = state.step
    step_no = start_step
    it = iter(batches)
    if goodput is not None:
        # the gap since the tracker's last tick, and this segment's first
        # step (batch fetch, warm-up), are not productive
        goodput.pause()
    draining = False
    for i in range(steps):
        draining = _draining(preemption, mesh)
        if draining:
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
    if not draining:
        # a signal during the last step
        draining = _draining(preemption, mesh)
    if draining:
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


def _draining(preemption, mesh) -> bool:
    """Whether the loop drains now: this process's watcher, or on a mesh
    any rank's (every rank reads the same answer; a rank drained by a
    peer's signal has its own watcher triggered, so its process exits
    ``EXIT_PREEMPTED`` too)."""
    if preemption is None:
        return False
    flag = preemption.draining
    if mesh is None:
        return flag
    t = torch.tensor([int(flag)], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=M.control_group(mesh))
    if t.item() and not flag:
        preemption.trigger("a peer rank is draining")
    return bool(t.item())
