"""Block-wise 8-bit Adam moments — the port of
``paddle_operator_tpu/train/opt8bit.py``.

At 7b width the f32 Adam moments are twice the parameters: with f32
params and grads they are what keeps full depth off one card.  Each
moment tensor is stored instead as int8 codes plus one f32 absmax scale
per 256-value block (~3.9x smaller) and dequantized and requantized
inside the update, so the f32 moments exist only in registers: the
update is one hand-written kernel on the card (``ops/adam8bit.py``,
``csrc/adam8bit.cu``), the plain tensor version on the CPU.

The encoding is the JAX package's, value for value:

- ``mu`` (signed): linear absmax per block, codes in [-127, 127].
- ``nu`` (nonnegative, wide range): linear absmax on **sqrt(nu)**, the
  quantity the Adam denominator reads; its codes use the full [0, 254]
  range, offset by -127 to ride int8.
- Blocks lie along the LAST axis only: a tensor ``[..., n]`` stores
  codes ``[..., ceil(n/256), 256]`` and scales ``[..., ceil(n/256), 1]``,
  each row zero-padded.  The JAX package stacks the layers ``[L, ...]``;
  the port holds one tensor a layer, and with last-axis blocking layer
  *l*'s codes are JAX's ``codes[l]`` (``convert.opt_state_from_jax``).

On a mesh the codes and scales are the JAX package's GLOBAL blocks:
each rank holds its region of them (``parallel/sharding.py``
``q8_layout``), never a blocking of its own shard (that would pad every
shard and make blocks JAX does not have); :func:`init_state` takes the
regions' shapes.

The JAX module's migration of r4 flat-layout orbax checkpoints
(``legacy_flat_template``, ``reblock_restored``) is not here: it reads
orbax trees that no torch-format checkpoint of the port holds.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F

BLOCK = 256
# the plain update runs over leading-axis chunks of a tensor whose f32
# image exceeds this, so its f32 temporaries stay bounded
SCAN_BYTES = 64 * 1024 * 1024


def _f32(value: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim f32 tensor on ``like``'s device: dividing by it divides
    (a CUDA tensor divided by a Python number is multiplied by the
    number's reciprocal instead, which rounds differently)."""
    return torch.full((), value, dtype=torch.float32, device=like.device)


def _requant_blocks(x: torch.Tensor):
    """Signed absmax requantization of f32 blocks ``[..., BLOCK]``: the
    one implementation of the persistent encoding (quantize_q8 and the
    plain update share it)."""
    s = x.abs().amax(-1, keepdim=True) / _f32(127.0, x)
    s = torch.where(s == 0.0, 1.0, s)
    return torch.round(x / s).to(torch.int8), s


def _requant_blocks_u(x: torch.Tensor):
    """Unsigned [0, 254] requantization of nonnegative blocks
    (sqrt(nu)); the codes ride int8 through the -127 offset."""
    s = x.amax(-1, keepdim=True) / _f32(254.0, x)
    s = torch.where(s == 0.0, 1.0, s)
    return (torch.round(x / s) - 127.0).to(torch.int8), s


class Q8(NamedTuple):
    """One block-quantized tensor: ``codes`` [..., n_blocks, BLOCK]
    int8 and ``scales`` [..., n_blocks, 1] f32 (JAX ``_Q8``'s
    ``q8_codes`` and ``q8_scale``)."""

    codes: torch.Tensor
    scales: torch.Tensor


def blocked_shape(shape) -> tuple:
    """The codes' shape of a tensor of ``shape``."""
    shape = tuple(shape) or (1,)
    return (*shape[:-1], -(-shape[-1] // BLOCK), BLOCK)


def _to_blocks(x: torch.Tensor) -> torch.Tensor:
    """[..., n] -> [..., ceil(n/BLOCK), BLOCK] f32, zero-padded on the
    last axis only."""
    x = x.float()
    if x.dim() == 0:
        x = x.reshape(1)
    pad = (-x.shape[-1]) % BLOCK
    if pad:
        x = F.pad(x, (0, pad))
    return x.reshape(*x.shape[:-1], -1, BLOCK)


def _from_blocks(blocks: torch.Tensor, shape, dtype) -> torch.Tensor:
    """Inverse of :func:`_to_blocks`: strip the padding, restore the
    shape."""
    last = shape[-1] if len(shape) else 1
    flat = blocks.reshape(*blocks.shape[:-2], -1)[..., :last]
    return flat.reshape(shape).to(dtype)


def quantize_q8(x: torch.Tensor) -> Q8:
    """Signed symmetric absmax encoding (mu)."""
    return Q8(*_requant_blocks(_to_blocks(x)))


def quantize_q8u(x: torch.Tensor) -> Q8:
    """Unsigned encoding of NONNEGATIVE values (sqrt(nu))."""
    return Q8(*_requant_blocks_u(_to_blocks(x)))


def dequantize_q8(qt: Q8, shape, dtype=torch.float32) -> torch.Tensor:
    return _from_blocks(qt.codes.float() * qt.scales, shape, dtype)


def dequantize_q8u(qt: Q8, shape, dtype=torch.float32) -> torch.Tensor:
    return _from_blocks((qt.codes.float() + 127.0) * qt.scales, shape,
                        dtype)


def _zeros_q8(codes, new: Callable, fill: int) -> Q8:
    """The encoding of zeros (``quantize_q8(0)`` with ``fill`` 0,
    ``quantize_q8u(0)`` with -127: every scale 1.0) in codes of shape
    ``codes``, made by ``new(shape, dtype, fill)``."""
    return Q8(new(codes, torch.int8, fill),
              new((*codes[:-1], 1), torch.float32, 1.0))


@dataclasses.dataclass
class AdamW8bitState:
    """``scale_by_adam8bit``'s state: ``count`` updates applied, ``mu``
    and ``nu`` (sqrt domain) as :class:`Q8` keyed by parameter name;
    ``offload`` streams them from host memory (train/trainer.py
    ``MomentOffload``) when they live there; ``layout`` (on a mesh of
    more than one rank) maps each name to its
    ``parallel.sharding.Q8Layout``: the tensors are this rank's region
    of the global codes and scales."""

    count: int
    mu: Dict[str, Q8]
    nu: Dict[str, Q8]
    offload: Optional[object] = None
    layout: Optional[Dict[str, object]] = None

    kind = "int8"
    FIELDS = ("mu_codes", "mu_scales", "nu_codes", "nu_scales")

    def leaves(self, name: str) -> List[torch.Tensor]:
        """The tensors of parameter ``name``, in :data:`FIELDS` order."""
        mu, nu = self.mu[name], self.nu[name]
        return [mu.codes, mu.scales, nu.codes, nu.scales]

    def tensors(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """Field -> name -> tensor, what a checkpoint holds."""
        return {field: {n: self.leaves(n)[i] for n in self.mu}
                for i, field in enumerate(self.FIELDS)}

    def replace(self, field: str, name: str, t: torch.Tensor) -> None:
        moment, part = field.split("_")
        table = getattr(self, moment)
        table[name] = table[name]._replace(
            **{"codes" if part == "codes" else "scales": t})


def init_state(params: Dict[str, torch.Tensor],
               new: Optional[Callable] = None,
               layout: Optional[Dict[str, object]] = None
               ) -> AdamW8bitState:
    """Zero moments for ``params`` (``scale_by_adam8bit``'s ``init_fn``).
    ``new(shape, dtype, fill)`` makes each tensor (default: on its
    parameter's device).  ``layout``: name -> ``Q8Layout`` of a state
    on a mesh; each tensor is then the rank's region of the global
    encoding of zeros (the same values everywhere, so nothing is
    communicated)."""

    def on(p):
        return new or (lambda shape, dtype, fill: torch.full(
            shape, fill, dtype=dtype, device=p.device))

    def codes(n, p):
        return (blocked_shape(p.shape) if layout is None
                else layout[n].local_shape)

    return AdamW8bitState(
        count=0,
        mu={n: _zeros_q8(codes(n, p), on(p), 0) for n, p in params.items()},
        nu={n: _zeros_q8(codes(n, p), on(p), -127)
            for n, p in params.items()},
        layout=layout)
