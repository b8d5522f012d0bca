"""The weight-only int8/int4 matmul of decode: ``x @ dequant(q, s)``.

The JAX package has no Pallas kernel here: its ``infer/decode.py``
``_mm`` computes ``x @ q.astype(dtype)`` and then ``* s``, and XLA fuses
the convert into the dot's weight stream, so a decode step reads one
byte a weight.  Eager PyTorch would write the bf16 copy of every weight
and read it back (five bytes a weight, more than the bf16 model's two),
and no library call takes int8 weights with bf16 activations
(``torch._int_mm`` is int8 x int8).  So the decode rows get a kernel of
their own, ``csrc/quant_matmul.cu``; see the note at its head for what
bounds it and what its design does about that.

Three parts, as in ops/decode_attention.py:

- the wrapper :func:`quant_matmul`: on CUDA tensors it launches the
  hand-written kernel (built for sm_90a at first use, bound through
  ``ctypes``) on the current stream; on CPU tensors it uses the plain
  version.  There is no fallback: a CUDA tensor the kernel does not
  take, a failed build or a failed launch raises.
- the plain version :func:`quant_matmul_reference`: the JAX package's
  formula in its rounding order.
- a ``launches`` counter on the wrapper.

:func:`quant_mm` is the route every quantized projection takes (through
``infer/decode.py`` ``_mm`` and ``models/llama.py`` ``Dense``): the
kernel for a few rows, the formula for many.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Tuple

import torch

# rows (tokens) a kernel launch takes; more go to the formula
KERNEL_MAX_ROWS = 16
# csrc/quant_matmul.cu: output columns a block owns, the K rows its
# threads load in one batch (a split is a whole number of batches), and
# the most K rows one block stages
TILE_N = 128
BATCH_ROWS = 128
MAX_SPLIT_ROWS = 2048
# the least K rows a split takes (fewer: the partials cost more than
# the parallelism buys)
MIN_SPLIT_ROWS = 256

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None
# split-K scratch per device: (f32 partials, int32 tickets); replaced
# buffers stay referenced, since a CUDA graph captured earlier still
# holds their addresses
_SCRATCH: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}
_RETIRED: List[Tuple[torch.Tensor, torch.Tensor]] = []
_SMS: Dict[torch.device, int] = {}


def quant_mm(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor
             ) -> torch.Tensor:
    """``x [..., K] @ dequant(q [K, N] int8, s [1, N] f32)`` in x's dtype,
    routed by the number of rows R (the product of x's leading dims):

    - R <= :data:`KERNEL_MAX_ROWS` (16): :func:`quant_matmul`, the
      kernel on the card.  These are the decode rows — the ring's lanes
      (8 by default), a batch step, a prefix hit's short suffix — where
      the product is bound by streaming the codes: the kernel reads one
      byte a weight, where dequantize-then-matmul moves five.  16 is the
      largest row count the kernel was measured at on the card
      (``chip_smoke.py`` phase 2e), and it keeps the f32 accumulators of
      all rows in one thread's registers.
    - more rows (a prefill): :func:`quant_matmul_reference`, the JAX
      package's formula.  Many rows make the product bound by its
      operations, where the tensor cores' GEMM over the bf16 copy beats
      a kernel of CUDA-core multiply-adds.

    A route by shape only: nothing falls back on a failure."""
    rows = x.numel() // x.shape[-1] if x.shape[-1] else 0
    if rows <= KERNEL_MAX_ROWS:
        return quant_matmul(x, q, s)
    return quant_matmul_reference(x, q, s)


def quant_matmul_reference(x: torch.Tensor, q: torch.Tensor,
                           s: torch.Tensor) -> torch.Tensor:
    """The plain version, the JAX package's ``_mm`` on a ``{"q", "s"}``
    leaf in its rounding order: ``x @ q`` in x's dtype, rounded to it,
    then times the scales cast to x's dtype."""
    return (x @ q.to(x.dtype)) * s.reshape(-1).to(x.dtype)


def _library():
    """The kernel library with its C signature declared (built at first
    use; ops/_build.py)."""
    global _lib
    if _lib is None:
        from paddle_operator_tpu_torch.ops import _build

        lib = _build.load("quant_matmul")
        fn = lib.quant_matmul_launch
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def split_plan(k: int, n: int, sms: int) -> Tuple[int, int]:
    """``(splits, split_rows)`` of a launch over K x N codes on a card
    of ``sms`` multiprocessors: the column tiles of :data:`TILE_N` times
    the splits of K make at most two blocks an SM where K allows, a
    split holds :data:`MIN_SPLIT_ROWS` to :data:`MAX_SPLIT_ROWS` rows of
    K (fewer when K is smaller), a multiple of :data:`BATCH_ROWS`.  Host
    shapes only, so a launch reads nothing back."""
    tiles = -(-n // TILE_N)
    splits = max(1, min(2 * sms // tiles, -(-k // MIN_SPLIT_ROWS)))
    splits = max(splits, -(-k // MAX_SPLIT_ROWS))
    rows = -(-k // splits)
    rows = -(-rows // BATCH_ROWS) * BATCH_ROWS
    return -(-k // rows), rows


def _scratch(device: torch.device, need: int, tiles: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split-K scratch on ``device``: f32 partials (at least
    ``need`` elements: splits x rows x N) and int32 tickets (at least one
    per column tile, zero between launches: the tile's last split to
    finish takes the ticket and resets it).  Taken from torch's
    allocator at first use and grown (never per call); a call under
    CUDA-graph capture that needs more raises — the first call outside
    capture sizes it, as the ring's warm-up run does.  Launches that
    overlap on two streams of one device would share it; the port runs
    its decode on one stream."""
    got = _SCRATCH.get(device)
    if got is None or got[0].numel() < need or got[1].numel() < tiles:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("quant_matmul: the split-K scratch must be "
                               "allocated by a call outside CUDA-graph "
                               "capture first")
        if got is not None:
            _RETIRED.append(got)
            need = max(need, got[0].numel())
            tiles = max(tiles, got[1].numel())
        got = (torch.empty(need, dtype=torch.float32, device=device),
               torch.zeros(tiles, dtype=torch.int32, device=device))
        _SCRATCH[device] = got
    return got


def _sms(device: torch.device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def _check_kernel_inputs(x: torch.Tensor, q: torch.Tensor,
                         s: torch.Tensor) -> None:
    """Everything the CUDA kernel does not take raises here."""
    for name, t in (("q", q), ("s", s)):
        if t.device != x.device:
            raise ValueError(f"quant_matmul: {name} on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"quant_matmul: {name} must be contiguous")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"quant_matmul: dtype {x.dtype} not supported "
                         "(float32 or bfloat16)")
    if q.dtype != torch.int8 or s.dtype != torch.float32:
        raise ValueError("quant_matmul: the codes must be int8 and the "
                         "scales float32")


def quant_matmul(x: torch.Tensor, q: torch.Tensor,
                 s: torch.Tensor) -> torch.Tensor:
    """``out[m, n] = (sum_k x[m, k] * q[k, n]) * s[n]`` over the rows of
    ``x [..., K]`` (float32 or bfloat16), the codes ``q [K, N]`` int8
    and the scales ``s [1, N]`` float32, accumulated in f32 and returned
    in x's dtype, shape ``[..., N]``.  On a CUDA tensor at most
    :data:`KERNEL_MAX_ROWS` rows and any K and N >= 1; another shape
    raises.  On a CUDA tensor it launches
    ``csrc/quant_matmul.cu`` (the scales apply to the f32 sum, where the
    plain version rounds ``x @ q`` to x's dtype first: one rounding
    apart at bf16); on a CPU tensor it is :func:`quant_matmul_reference`."""
    if q.dim() != 2 or x.shape[-1] != q.shape[0] \
            or s.numel() != q.shape[1]:
        raise ValueError(f"quant_matmul: x {tuple(x.shape)}, codes "
                         f"{tuple(q.shape)} and scales {tuple(s.shape)} do "
                         "not match as [..., K], [K, N], [1, N]")
    if x.device.type == "cpu":
        return quant_matmul_reference(x, q, s)
    _check_kernel_inputs(x, q, s)
    k, n = q.shape
    lead = x.shape[:-1]
    x2 = x.reshape(-1, k).contiguous()
    m = x2.shape[0]
    if m > KERNEL_MAX_ROWS:
        raise ValueError(f"quant_matmul: {m} rows; the kernel takes at "
                         f"most {KERNEL_MAX_ROWS}")
    if k == 0 or n == 0:
        raise ValueError(f"quant_matmul: empty codes {tuple(q.shape)}")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return out.reshape(*lead, n)
    splits, rows = split_plan(k, n, _sms(x.device))
    ws, tickets = _scratch(x.device, splits * m * n if splits > 1 else 1,
                           -(-n // TILE_N))
    # 16-byte loads: of the codes' rows, and of x's rows
    vec = int(n % 16 == 0 and q.data_ptr() % 16 == 0)
    xvec = int((k * x2.element_size()) % 16 == 0
               and x2.data_ptr() % 16 == 0)
    rc = _library().quant_matmul_launch(
        x2.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
        ws.data_ptr(), tickets.data_ptr(), m, k, n, splits, rows, vec, xvec,
        _DTYPE_CODE[x.dtype], torch.cuda.current_stream(x.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"quant_matmul kernel launch failed: CUDA error "
                           f"{rc}")
    quant_matmul.launches += 1
    return out.reshape(*lead, n)


quant_matmul.launches = 0
