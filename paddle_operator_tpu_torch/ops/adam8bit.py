"""The 8-bit AdamW update of one tensor, in place.

The JAX package has no Pallas kernel here: its ``train/opt8bit.py:169``
``blocked_update`` and the chain around it (``clip_by_global_norm``
before, ``add_decayed_weights`` and ``scale_by_learning_rate`` after)
are plain jnp, and XLA fuses the dequantize, the Adam math, both
per-block absmax reductions and the requantize into one pass, keeping
the f32 moments as fusion-local temporaries.  Written op by op in eager
PyTorch the same update is about 25 passes with f32 temporaries the size
of the tensor.  So the card gets a kernel of its own,
``csrc/adam8bit.cu``; see the note at its head for what bounds it and
what its design does about that.

Three parts, as in ops/quant_matmul.py:

- the wrapper :func:`adam8bit_update`: on CUDA tensors it launches the
  hand-written kernel (built for sm_90a at first use, bound through
  ``ctypes``) on the current stream; on CPU tensors it uses the plain
  version.  There is no fallback: a CUDA tensor the kernel does not
  take, a failed build or a failed launch raises.
- the plain version :func:`adam8bit_update_reference`: the same function
  as tensor ops in the JAX package's order of operations, chunked over
  the leading axis (``SCAN_BYTES``) so its temporaries stay bounded.
- a ``launches`` counter on the wrapper.

What one call computes, for p and g f32 ``[..., n]`` and the moments as
:class:`train.opt8bit.Q8` (codes ``[..., ceil(n/256), 256]`` int8,
scales ``[..., ceil(n/256), 1]`` f32), with ``norm`` the global norm of
all grads (a device scalar, so nothing syncs with the host)::

    g  = g if norm < clip else (g / norm) * clip
    mu = b1 * (mu_codes * mu_scale) + (1 - b1) * g
    r  = (nu_codes + 127) * nu_scale                 # sqrt(nu), stored
    nu = b2 * (r * r) + (1 - b2) * (g * g)
    u  = (mu / bc1) / (sqrt(nu / bc2) + eps)
    mu -> codes, scale: signed absmax over each block of 256
    sqrt(nu) -> codes, scale: unsigned absmax, codes - 127
    p  = p + (-lr) * (u + wd * p)

Every constant is the f32 value that the Python float rounds to
(:class:`Adam8bitConsts`): both versions compute in f32 with IEEE
rounding at every step and round half to even, so they agree bit for
bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from paddle_operator_tpu_torch.train.opt8bit import (BLOCK, SCAN_BYTES, Q8,
                                                     _from_blocks,
                                                     _requant_blocks,
                                                     _requant_blocks_u,
                                                     _to_blocks,
                                                     blocked_shape)

_lib = None


@dataclasses.dataclass(frozen=True)
class Adam8bitConsts:
    """One update's constants, each the f32 value of its Python float
    (``float(np.float32(x))``): ``b1``, ``omb1`` = 1 - b1, ``b2``,
    ``omb2`` = 1 - b2, the bias corrections ``bc1`` = 1 - b1^count and
    ``bc2``, ``eps``, ``wd``, ``neg_lr`` = -lr and ``clip``."""

    b1: float
    omb1: float
    b2: float
    omb2: float
    bc1: float
    bc2: float
    eps: float
    wd: float
    neg_lr: float
    clip: float

    @classmethod
    def make(cls, *, b1: float, b2: float, eps: float, weight_decay: float,
             lr: float, clip: float, count: int) -> "Adam8bitConsts":
        """The constants of update number ``count`` (1 for the first):
        ``1 - b`` in Python, the bias corrections in f32 (as the port's
        AdamW computes them)."""
        f = np.float32
        return cls(*(float(f(x)) for x in (
            b1, 1 - b1, b2, 1 - b2, f(1) - f(b1) ** f(count),
            f(1) - f(b2) ** f(count), eps, weight_decay, -lr, clip)))

    def tensors(self, like: torch.Tensor) -> Dict[str, torch.Tensor]:
        """The constants as 0-dim f32 tensors on ``like``'s device (a
        CUDA tensor divided by a Python number is multiplied by its
        reciprocal instead)."""
        return {k: torch.full((), v, dtype=torch.float32, device=like.device)
                for k, v in dataclasses.asdict(self).items()}


def bytes_moved(shape) -> int:
    """The bytes one update of a tensor of ``shape`` must move: p read
    and written, g read (f32), both moments' codes and scales read and
    written."""
    n = int(np.prod(shape)) if len(shape) else 1
    blocks = int(np.prod(blocked_shape(shape)[:-1]))
    return 12 * n + 2 * 2 * (blocks * BLOCK + 4 * blocks)


# ---------------------------------------------------------------------------
# Plain version
# ---------------------------------------------------------------------------


def _blocked_update(gb, mc, ms, nc, ns, k):
    """JAX ``blocked_update``: the Adam math in the blocked domain."""
    mu = k["b1"] * (mc.float() * ms) + k["omb1"] * gb
    root = (nc.float() + 127.0) * ns
    nu = k["b2"] * (root * root) + k["omb2"] * (gb * gb)
    upd = (mu / k["bc1"]) / (torch.sqrt(nu / k["bc2"]) + k["eps"])
    mc2, ms2 = _requant_blocks(mu)
    nc2, ns2 = _requant_blocks_u(torch.sqrt(nu))
    return upd, mc2, ms2, nc2, ns2


def _chunks(p: torch.Tensor) -> Tuple[int, int]:
    """(rows, rows a chunk) over p's leading axis: JAX's chunk count,
    ``min(lead, ceil(f32 bytes / SCAN_BYTES))``."""
    if p.dim() < 2:
        return 1, 1
    lead = p.shape[0]
    blocks = int(np.prod(blocked_shape(p.shape)))
    n_chunks = max(1, min(lead, -(-4 * blocks // SCAN_BYTES)))
    return lead, -(-lead // n_chunks)


@torch.no_grad()
def adam8bit_update_reference(p: torch.Tensor, g: torch.Tensor, mu: Q8,
                              nu: Q8, norm: torch.Tensor,
                              consts: Adam8bitConsts) -> None:
    """The plain version, in place on ``p`` and the moments' tensors."""
    k = consts.tensors(p)
    g = torch.where(norm < k["clip"], g, (g / norm) * k["clip"])
    lead, per = _chunks(p)
    for r0 in range(0, lead, per):
        sl = slice(r0, r0 + per) if p.dim() >= 2 else slice(None)
        pc, gc = p[sl], g[sl]
        parts = (mu.codes[sl], mu.scales[sl], nu.codes[sl], nu.scales[sl])
        upd, *new = _blocked_update(_to_blocks(gc), *parts, k)
        u = _from_blocks(upd, pc.shape, gc.dtype)
        u = u + k["wd"] * pc
        pc.copy_(pc + k["neg_lr"] * u)
        for dst, src in zip(parts, new):
            dst.copy_(src)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------


def _library():
    """The kernel library with its C signature declared (built at first
    use; ops/_build.py)."""
    global _lib
    if _lib is None:
        from paddle_operator_tpu_torch.ops import _build

        lib = _build.load("adam8bit")
        fn = lib.adam8bit_launch
        fn.argtypes = ([ctypes.c_void_p] * 7
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
                       + [ctypes.c_float] * 10 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(p, g, mu: Q8, nu: Q8, norm) -> None:
    """Everything the kernel does not take raises here."""
    fn = "adam8bit_update"
    if p.device.type != "cuda":
        raise ValueError(f"{fn}: the kernel runs on CUDA tensors only "
                         f"(got {p.device})")
    codes = blocked_shape(p.shape)
    want = (("p", p, torch.float32, tuple(p.shape)),
            ("g", g, torch.float32, tuple(p.shape)),
            ("mu codes", mu.codes, torch.int8, codes),
            ("mu scales", mu.scales, torch.float32, (*codes[:-1], 1)),
            ("nu codes", nu.codes, torch.int8, codes),
            ("nu scales", nu.scales, torch.float32, (*codes[:-1], 1)),
            ("norm", norm, torch.float32, ()))
    for name, t, dtype, shape in want:
        if t.device != p.device:
            raise ValueError(f"{fn}: {name} on {t.device}, p on {p.device}")
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{fn}: {name} is {t.dtype} "
                             f"{tuple(t.shape)}, not {dtype} {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    if mu.codes.data_ptr() % 8 or nu.codes.data_ptr() % 8:
        raise ValueError(f"{fn}: the codes must be 8-byte aligned")
    n = p.shape[-1] if p.dim() else 1
    if n >= 2 ** 31:
        raise ValueError(f"{fn}: last axis {n} too long")


def vector_path(p: torch.Tensor, g: torch.Tensor) -> bool:
    """Whether the kernel loads p and g 16 bytes a lane (each lane's 8
    values of a row all inside the row, both bases aligned) or value by
    value."""
    n = p.shape[-1] if p.dim() else 1
    return n % 8 == 0 and p.data_ptr() % 16 == 0 and g.data_ptr() % 16 == 0


def adam8bit_update(p: torch.Tensor, g: torch.Tensor, mu: Q8, nu: Q8,
                    norm: torch.Tensor, consts: Adam8bitConsts) -> None:
    """One 8-bit AdamW update of ``p`` with grad ``g``, in place on ``p``
    and on ``mu``'s and ``nu``'s tensors; ``norm`` is the global norm of
    the unclipped grads (a 0-dim f32 tensor on p's device).  The kernel
    on CUDA tensors, the plain version on CPU tensors."""
    if p.device.type == "cpu":
        adam8bit_update_reference(p, g, mu, nu, norm, consts)
        return
    _check(p, g, mu, nu, norm)
    rows = p.numel() // p.shape[-1] if p.dim() else 1
    n = p.shape[-1] if p.dim() else 1
    if rows == 0 or n == 0:
        return
    rc = _library().adam8bit_launch(
        p.data_ptr(), g.data_ptr(), mu.codes.data_ptr(),
        mu.scales.data_ptr(), nu.codes.data_ptr(), nu.scales.data_ptr(),
        norm.data_ptr(), rows, n, int(vector_path(p, g)),
        *dataclasses.astuple(consts),
        torch.cuda.current_stream(p.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"adam8bit_update kernel launch failed: CUDA "
                           f"error {rc}")
    adam8bit_update.launches += 1


adam8bit_update.launches = 0
