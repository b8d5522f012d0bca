"""Serving-side parameter preparation and weight-only int8/int4
quantization — the port of ``paddle_operator_tpu/infer/quant.py``.

Decode streams every weight every step, so storing the matmul kernels
as integer codes with per-output-channel f32 scales cuts the bytes a
step moves (activations and accumulation stay in the compute dtype —
"weight-only" quantization).  Norm scales and the embedding table stay
full precision.

:func:`quantize_params` turns each targeted projection of the port's
``Llama`` (a ``models.llama.Dense``) into its quantized form, in place:
the ``kernel`` parameter is replaced by two buffers, the codes ``q``
``[in, out]`` int8 and the scales ``s`` ``[1, out]`` f32 — the layout of
the JAX package's ``{"q", "s"}`` leaf — and the module records its
``mode``.  An MoE layer's expert weights (``moe/w1`` ``[E, D, F]``,
``moe/w2`` ``[E, F, D]``) become ``models.moe.ExpertCodes``: codes
``[E, in, out]`` and per-out-channel scales ``[E, 1, out]``, the JAX
``quantize_leaf`` of the ``[..., in, out]`` leaf.  Every projection goes
through ``infer/decode.py`` ``_mm`` or ``_expert_mm`` (and
``Dense.forward``), which read either form, so every decode entry point
(prefill, decode_step, generate, the rings, the server) serves a
quantized model unchanged.

Torch has no int4 dtype to compute with, so **int4 codes are stored as
int8 values in [-7, 7]**: the mode cannot be read off the dtype, and
each quantized ``Dense`` carries it (:func:`weight_quant_mode` reads
it).  :func:`param_bytes` counts an int4 code as one byte, as the JAX
package's does (it reports the unpacked resident size).

Rounding is round-half-even (``torch.round``, like ``jnp.round``) on
f32 math, so codes and scales equal the JAX package's bit for bit, and
quantize -> dequantize -> quantize is a fixed point.

**Skip list.**  The serving path (``skip=SERVING_SKIP``) keeps the
embedding (gather-shaped), ``lm_head`` (its error lands on the sampling
distribution directly) and the norm scales (tiny) unquantized; the
legacy no-kwargs call (``QUANTIZE=int8``) keeps the original target
set, ``lm_head`` included.
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn

from paddle_operator_tpu_torch.models.llama import Dense
from paddle_operator_tpu_torch.models.moe import ExpertCodes, MoELayer

# matmul kernels worth quantizing: attention + (dense or MoE) FFN + head,
# matched against the JAX package's '/'-joined leaf paths
_TARGETS = re.compile(
    r"(attn/(wq|wk|wv|wo)/kernel"
    r"|mlp/w[123]/kernel"
    r"|moe/w[12]"
    r"|lm_head/kernel)$")

# leaves that stay unquantized when quantizing for the serving fleet,
# matched as patterns of the '/'-joined leaf path
SERVING_SKIP = ("embed", "lm_head", "norm")

#: Recognized quantization modes -> max code magnitude (codes are int8
#: in both: int4's lie in [-7, 7]).
_MODES = {"int8": 127.0, "int4": 7.0}


@torch.no_grad()
def serving_params(model: nn.Module, dtype) -> nn.Module:
    """Cast the floating-point parameters to the serving/compute dtype
    (normally bf16), in place, and return the module.

    Training keeps f32 master params; serving them directly would stream
    4 bytes/param in the decode hot loop (decode._mm converts at use, so
    the storage dtype IS the streamed dtype).  Buffers (the f32 RoPE
    tables, a quantized projection's codes and f32 scales) keep their
    dtype."""
    for p in model.parameters():
        if p.is_floating_point() and p.dtype != dtype:
            p.data = p.data.to(dtype)
    return model


def quantize_leaf(w: torch.Tensor, mode: str = "int8"
                  ) -> Dict[str, torch.Tensor]:
    """``[..., in, out]`` kernel -> ``{"q": int8 codes, "s": f32 scales
    [..., 1, out]}`` (absmax over the contraction dim, scale 1.0 for an
    all-zero column).  The math runs in f32 for any input dtype;
    ``torch.round`` rounds half to even."""
    qmax = _MODES[mode]
    w = w.float()
    s = w.abs().amax(dim=-2, keepdim=True) / qmax
    s = torch.where(s == 0, torch.ones_like(s), s)
    q = torch.clamp(torch.round(w / s), -qmax, qmax).to(torch.int8)
    return {"q": q, "s": s}


def dequantize_leaf(leaf, dtype) -> torch.Tensor:
    """A ``{"q", "s"}`` leaf (or a plain tensor) in ``dtype``: both
    operands cast to ``dtype`` before the product, as the JAX
    package's."""
    if isinstance(leaf, dict) and "q" in leaf:
        return leaf["q"].to(dtype) * leaf["s"].to(dtype)
    return leaf.to(dtype)


class _Leaf:
    """One quantizable weight: a ``Dense``'s kernel, or an MoE layer's
    expert weight ``w1`` / ``w2``."""

    def __init__(self, mod: nn.Module, name: Optional[str] = None) -> None:
        self.mod, self.name = mod, name

    @property
    def mode(self) -> str:
        if self.name is None:
            return self.mod.mode
        w = getattr(self.mod, self.name)
        return w.mode if isinstance(w, ExpertCodes) else "none"

    def weight(self) -> torch.Tensor:
        return (self.mod.kernel if self.name is None
                else getattr(self.mod, self.name))

    def set_quantized(self, q: torch.Tensor, s: torch.Tensor,
                      mode: str) -> None:
        if self.name is None:
            self.mod.set_quantized(q, s, mode)
        else:
            self.mod.set_quantized(self.name, q, s, mode)


def _leaf_paths(model: nn.Module):
    """(the JAX package's '/'-joined leaf path, :class:`_Leaf`) of every
    ``Dense`` kernel and MoE expert weight of ``model``:
    ``layers.0.attn.wq`` -> ``layers/0/attn/wq/kernel``,
    ``layers.0.moe``'s ``w1`` -> ``layers/0/moe/w1``."""
    for name, mod in model.named_modules():
        path = name.replace(".", "/")
        if isinstance(mod, Dense):
            yield path + "/kernel", _Leaf(mod)
        elif isinstance(mod, MoELayer):
            for w in ("w1", "w2"):
                yield f"{path}/{w}", _Leaf(mod, w)


@torch.no_grad()
def quantize_params(model: nn.Module, cfg=None, *, mode: str = "int8",
                    skip: Optional[Iterable[str]] = None) -> nn.Module:
    """Quantize the decode-relevant projections of ``model`` in place
    (one at a time: each unquantized kernel, or expert weight, is
    released as its codes are made) and return it.

    ``quantize_params(model)`` is the legacy form (``QUANTIZE=int8``):
    int8, the original target set, ``lm_head`` included.  The serving
    path (``SERVE_WEIGHT_QUANT``) passes ``cfg`` (unused, as in the JAX
    package) and ``skip=SERVING_SKIP``.  ``mode`` is ``"int8"`` or
    ``"int4"``; another raises ``ValueError`` naming it.  A projection
    that is already quantized is left as it is.  Quantize before a ring
    captures its CUDA graphs: they hold the addresses they read."""
    del cfg
    if mode not in _MODES:
        raise ValueError(f"unknown weight quant mode {mode!r} (want one of "
                         f"{sorted(_MODES)})")
    skip_pats = tuple(skip) if skip is not None else ()
    for path, target in list(_leaf_paths(model)):
        if target.mode != "none" or not _TARGETS.search(path):
            continue
        if any(re.search(pat, path) for pat in skip_pats):
            continue
        leaf = quantize_leaf(target.weight(), mode)
        target.set_quantized(leaf["q"], leaf["s"], mode)
        del leaf
    return model


def quant_passes(environ) -> List[Tuple[str, Optional[Tuple[str, ...]]]]:
    """The ``(mode, skip)`` passes the serving env asks for, in the
    order ``serve.quantize_from_env`` runs them: ``QUANTIZE=int8`` (the
    legacy set, ``lm_head`` included), then ``SERVE_WEIGHT_QUANT=
    int8|int4`` with :data:`SERVING_SKIP`.  A mode other than those
    raises ``ValueError`` naming it."""
    passes: List[Tuple[str, Optional[Tuple[str, ...]]]] = []
    if environ.get("QUANTIZE", "") == "int8":
        passes.append(("int8", None))
    wq = environ.get("SERVE_WEIGHT_QUANT", "none") or "none"
    if wq != "none":
        if wq not in _MODES:
            raise ValueError(f"unknown weight quant mode {wq!r} (want one "
                             f"of {sorted(_MODES)})")
        passes.append((wq, SERVING_SKIP))
    return passes


def leaf_quant_mode(path: str, passes) -> Optional[str]:
    """The mode the first of ``passes`` (:func:`quant_passes`) that
    targets the '/'-joined leaf ``path`` quantizes it in, or None: what
    :func:`quantize_params` run pass by pass leaves that leaf as (a
    quantized leaf is left as it is by later passes)."""
    if not _TARGETS.search(path):
        return None
    for mode, skip in passes:
        if not any(re.search(pat, path) for pat in (skip or ())):
            return mode
    return None


def cut_quantized(q: torch.Tensor, s: torch.Tensor, rows: slice,
                  cols: slice) -> Tuple[torch.Tensor, torch.Tensor]:
    """One rank's piece of a quantized projection ``{"q": [in, out],
    "s": [1, out]}`` for a tensor-parallel serving mesh: the codes'
    ``rows`` x ``cols`` block and the scales' ``cols``.  A
    column-parallel projection (wq, wk, wv, w1, w3, lm_head) cuts both
    by its columns; a row-parallel one (wo, w2) cuts the codes by rows
    and keeps every scale (``cols`` whole): the scale is per output
    column, constant along the contraction, so it commutes with the sum
    of the ranks' partial products (views: the caller copies them)."""
    return q[rows, cols], s[:, cols]


def weight_quant_mode(model: nn.Module) -> str:
    """The quantization mode of the served model: "int4" when any
    projection holds int4 codes, else "int8" when any holds int8 codes,
    else "none" — read from the modules (not a threaded flag), so
    ``/statusz`` reports the model actually dispatched."""
    mode = "none"
    for _, target in _leaf_paths(model):
        if target.mode == "int4":
            return "int4"
        if target.mode == "int8":
            mode = "int8"
    return mode


def param_bytes(model: nn.Module) -> int:
    """Device bytes of the model's parameter tree, by shape arithmetic:
    every parameter and persistent buffer (a quantized projection's
    codes and scales; int4 codes one byte each), not the RoPE tables,
    which the JAX package's tree does not hold — so the number equals
    the JAX package's ``param_bytes`` of the same model."""
    return sum(t.numel() * t.element_size()
               for t in model.state_dict().values())
