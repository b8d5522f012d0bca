"""The weight-only int8/int4 matmul of serving: ``x @ dequant(q, s)``.

The JAX package has no Pallas kernel here: its ``infer/decode.py``
``_mm`` computes ``x @ q.astype(dtype)`` and then ``* s``, and XLA fuses
the convert into the dot's weight stream, so a product reads one byte a
weight.  Eager PyTorch would write the bf16 copy of every weight and
read it back (five bytes a weight, more than the bf16 model's two), and
no library call takes int8 weights with bf16 activations
(``torch._int_mm`` is int8 x int8).  So the port has two kernels of its
own in ``csrc/quant_matmul.cu``; see the note at its head for what
bounds each and what its design does about that:

- kernel A, :func:`quant_matmul`: the decode rows (at most
  :data:`KERNEL_MAX_ROWS`), streaming the codes once;
- kernel B, :func:`quant_gemm`: any number of rows, tiled for the tensor
  cores — the prefills.

Three parts each, as in ops/decode_attention.py:

- the wrapper: on CUDA tensors it launches the hand-written kernel
  (built for sm_90a at first use, bound through ``ctypes``) on the
  current stream; on CPU tensors it uses the plain version.  There is
  no fallback: a CUDA tensor the kernel does not take, a failed build or
  a failed launch raises.
- the plain version :func:`quant_matmul_reference`: the JAX package's
  formula in its rounding order.
- a ``launches`` counter on the wrapper.

:func:`quant_mm` is the route every quantized projection takes (through
``infer/decode.py`` ``_mm`` and ``models/llama.py`` ``Dense``): kernel A
for a few rows, kernel B for more.
"""

from __future__ import annotations

import ctypes
from typing import Dict, List, Optional, Tuple

import torch

# rows (tokens) kernel A takes; more go to kernel B
KERNEL_MAX_ROWS = 64
# csrc/quant_matmul.cu: output columns a block owns, the K rows a split
# is a whole number of, and the most K rows one block of kernel A's f32
# body stages
TILE_N = 128
BATCH_ROWS = 128
MAX_SPLIT_ROWS = 2048
# the least K rows a split takes (fewer: the partials cost more than
# the parallelism buys)
MIN_SPLIT_ROWS = 256
# x rows a block: kernel A's f32 body (a row group), kernel B's bf16
# body (a row block of GEMM_TILE_N columns, one block an SM) and its f32
# body (a 64 x 64 output tile)
F32_GROUP_ROWS = 16
GEMM_BLOCK_ROWS = 128
GEMM_TILE_N = 256
GEMM_F32_TILE = 64

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_lib = None
# split-K scratch per device, shared by both kernels: (f32 partials,
# int32 tickets); replaced buffers stay referenced, since a CUDA graph
# captured earlier still holds their addresses
_SCRATCH: Dict[torch.device, Tuple[torch.Tensor, torch.Tensor]] = {}
_RETIRED: List[Tuple[torch.Tensor, torch.Tensor]] = []
_SMS: Dict[torch.device, int] = {}


def _stream(device: torch.device) -> int:
    """The raw handle of ``device``'s current stream: the private getter
    costs a fraction of building a torch.cuda.Stream, and a ring tick
    makes 224 calls."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def quant_mm(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor
             ) -> torch.Tensor:
    """``x [..., K] @ dequant(q [K, N] int8, s [1, N] f32)`` in x's dtype,
    routed by the number of rows R (the product of x's leading dims):

    - R <= :data:`KERNEL_MAX_ROWS`: :func:`quant_matmul`, kernel A —
      the ring's lanes (8 by default), a batch step, a prefix hit's
      suffix, the speculative verify's 8 x (K + 1) rows, a 64-row
      prefill slice.  There the product is bound by streaming the codes,
      and kernel A reads them once.  The limit is kernel A's widest row
      tile: ``chip_smoke.py`` phase 2e times both kernels at 16, 24, 40
      and 64 rows, and kernel A was the faster at each (PERF.md).
    - more rows (a prompt's prefill, a long suffix, a wider slice):
      :func:`quant_gemm`, kernel B, tiled for the tensor cores.

    On a CUDA tensor every row count launches one of the two kernels
    (the plain formula never runs there); on a CPU tensor both wrappers
    are the plain version.  A route by shape only: nothing falls back on
    a failure."""
    rows = x.numel() // x.shape[-1] if x.shape[-1] else 0
    if rows <= KERNEL_MAX_ROWS:
        return quant_matmul(x, q, s)
    return quant_gemm(x, q, s)


def dense_mm(x: torch.Tensor, w, dtype) -> torch.Tensor:
    """x @ W for the projection ``w`` (a ``models.llama.Dense``, or any
    object with its ``mode``, ``kernel`` or ``q``/``s``), in ``dtype``.

    A raw ``[in, out]`` kernel: ``x @ kernel.to(dtype)``.  A weight-only
    int8/int4 one (infer/quant.py: codes ``q`` [in, out], f32 scales
    ``s`` [1, out]) goes through :func:`quant_mm`, routed
    by the number of rows: up to ``KERNEL_MAX_ROWS`` rows — the ring's
    lanes, a batch step, a prefix hit's suffix, the speculative verify,
    a 64-row prefill slice — take kernel A on the card, which streams
    one byte a weight where dequantize-then-matmul would move five; more
    rows — a prompt's prefill, bound by its operations — take kernel B,
    the same function tiled for the tensor cores.  The JAX package's
    formula, ``(x @ q.to(dtype)) * s.to(dtype)``, is the plain version:
    it runs on CPU tensors only.  A route by shape: nothing falls back on
    a failure."""
    if w.mode == "none":
        return x @ w.kernel.to(dtype)
    return quant_mm(x.to(dtype), w.q, w.s)


def quant_matmul_reference(x: torch.Tensor, q: torch.Tensor,
                           s: torch.Tensor) -> torch.Tensor:
    """The plain version, the JAX package's ``_mm`` on a ``{"q", "s"}``
    leaf in its rounding order: ``x @ q`` in x's dtype, rounded to it,
    then times the scales cast to x's dtype."""
    return (x @ q.to(x.dtype)) * s.reshape(-1).to(x.dtype)


def declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    """``lib`` (a build of ``csrc/quant_matmul.cu``) with the two
    kernels' C signatures declared."""
    for fn in (lib.quant_matmul_launch, lib.quant_gemm_launch):
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib


def _library():
    """The kernel library, built at first use (ops/_build.py)."""
    global _lib
    if _lib is None:
        from paddle_operator_tpu_torch.ops import _build

        _lib = declare(_build.load("quant_matmul"))
    return _lib


def split_plan(k: int, n: int, sms: int, blocks: int = 1,
               max_rows: Optional[int] = MAX_SPLIT_ROWS, per_sm: int = 2,
               tile_n: int = TILE_N) -> Tuple[int, int]:
    """``(splits, split_rows)`` of a launch over K x N codes and
    ``blocks`` row blocks on a card of ``sms`` multiprocessors: the
    column tiles of ``tile_n`` times the row blocks times the splits of
    K make at most ``per_sm`` blocks an SM where K allows, a split holds
    at least :data:`MIN_SPLIT_ROWS` rows of K (fewer when K is smaller)
    and at most ``max_rows`` (None: no cap), a multiple of
    :data:`BATCH_ROWS`.  Host shapes only, so a launch reads nothing
    back."""
    units = -(-n // tile_n) * blocks
    splits = max(1, min(per_sm * sms // units, -(-k // MIN_SPLIT_ROWS)))
    if max_rows is not None:
        splits = max(splits, -(-k // max_rows))
    rows = -(-k // splits)
    rows = -(-rows // BATCH_ROWS) * BATCH_ROWS
    return -(-k // rows), rows


def matmul_plan(m: int, k: int, n: int, dtype: torch.dtype,
                sms: int) -> Tuple[int, int, int, int]:
    """Kernel A's grid ``(row blocks, column tiles, splits, split_rows)``:
    all rows in one block at bf16 (the product's N is the rows, padded to
    8, 16, 32 or 64), groups of :data:`F32_GROUP_ROWS` at f32, whose
    split stages x whole (at most :data:`MAX_SPLIT_ROWS` rows of K)."""
    f32 = dtype == torch.float32
    blocks = -(-m // F32_GROUP_ROWS) if f32 else 1
    splits, rows = split_plan(k, n, sms, blocks,
                              MAX_SPLIT_ROWS if f32 else None)
    return blocks, -(-n // TILE_N), splits, rows


def gemm_plan(m: int, k: int, n: int, dtype: torch.dtype,
              sms: int) -> Tuple[int, int, int, int]:
    """Kernel B's grid ``(row blocks, column tiles, splits,
    split_rows)``: blocks of :data:`GEMM_BLOCK_ROWS` rows and
    :data:`GEMM_TILE_N` columns at bf16 (one an SM), split over K only
    while the blocks do not fill the card; at f32 one pass over tiles of
    :data:`GEMM_F32_TILE` x :data:`GEMM_F32_TILE` (split_rows: all of
    K)."""
    if dtype == torch.float32:
        return (-(-m // GEMM_F32_TILE), -(-n // GEMM_F32_TILE), 1,
                -(-k // BATCH_ROWS) * BATCH_ROWS)
    blocks = -(-m // GEMM_BLOCK_ROWS)
    splits, rows = split_plan(k, n, sms, blocks, None, 1, GEMM_TILE_N)
    return blocks, -(-n // GEMM_TILE_N), splits, rows


def _scratch(device: torch.device, need: int, tickets: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split-K scratch on ``device``: f32 partials (at least
    ``need`` elements: splits x rows x N) and int32 tickets (at least one
    per row block and column tile, zero between launches: the tile's
    last split to finish takes the ticket and resets it).  Taken from
    torch's allocator at first use and grown (never per call); a call
    under CUDA-graph capture that needs more raises — the first call
    outside capture sizes it, as the ring's warm-up run does.  Launches
    that overlap on two streams of one device would share it; the port
    runs its serving on one stream."""
    got = _SCRATCH.get(device)
    if got is None or got[0].numel() < need or got[1].numel() < tickets:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("quant_matmul: the split-K scratch must be "
                               "allocated by a call outside CUDA-graph "
                               "capture first")
        if got is not None:
            _RETIRED.append(got)
            need = max(need, got[0].numel())
            tickets = max(tickets, got[1].numel())
        got = (torch.empty(need, dtype=torch.float32, device=device),
               torch.zeros(tickets, dtype=torch.int32, device=device))
        _SCRATCH[device] = got
    return got


def _sms(device: torch.device) -> int:
    if device not in _SMS:
        _SMS[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SMS[device]


def _check_shapes(name: str, x: torch.Tensor, q: torch.Tensor,
                  s: torch.Tensor) -> None:
    if q.dim() != 2 or x.shape[-1] != q.shape[0] \
            or s.numel() != q.shape[1]:
        raise ValueError(f"{name}: x {tuple(x.shape)}, codes "
                         f"{tuple(q.shape)} and scales {tuple(s.shape)} do "
                         "not match as [..., K], [K, N], [1, N]")


def _check_kernel_inputs(x: torch.Tensor, q: torch.Tensor,
                         s: torch.Tensor, name: str = "quant_matmul"
                         ) -> None:
    """Everything the CUDA kernels do not take raises here."""
    for arg, t in (("q", q), ("s", s)):
        if t.device != x.device:
            raise ValueError(f"{name}: {arg} on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"{name}: dtype {x.dtype} not supported "
                         "(float32 or bfloat16)")
    if q.dtype != torch.int8 or s.dtype != torch.float32:
        raise ValueError(f"{name}: the codes must be int8 and the "
                         "scales float32")
    if q.shape[0] == 0 or q.shape[1] == 0:
        raise ValueError(f"{name}: empty codes {tuple(q.shape)}")


def _operands(x: torch.Tensor, q: torch.Tensor):
    """x as [M, K] contiguous, the output [M, N], and the 16-byte load
    flags of the codes' rows (``vec``) and of x's rows (``xvec``)."""
    k, n = q.shape
    x2 = x.view(-1, k) if x.is_contiguous() else x.reshape(-1, k).contiguous()
    out = torch.empty((x2.shape[0], n), dtype=x.dtype, device=x.device)
    vec = int(n % 16 == 0 and q.data_ptr() % 16 == 0)
    xvec = int((k * x2.element_size()) % 16 == 0
               and x2.data_ptr() % 16 == 0)
    return x2, out, vec, xvec


def _launch(name: str, x2, q, s, out, vec, xvec, plan,
            lib: Optional[ctypes.CDLL] = None) -> None:
    """One launch of kernel ``name`` ("quant_matmul": A, "quant_gemm": B)
    on ``plan`` (:func:`matmul_plan`'s or :func:`gemm_plan`'s), from
    ``lib`` (default: the library the wrappers use)."""
    m, k = x2.shape
    n = q.shape[1]
    blocks, tiles, splits, rows = plan
    ws, tickets = _scratch(x2.device, splits * m * n if splits > 1 else 1,
                           blocks * tiles)
    rc = getattr(lib or _library(), name + "_launch")(
        x2.data_ptr(), q.data_ptr(), s.data_ptr(), out.data_ptr(),
        ws.data_ptr(), tickets.data_ptr(), m, k, n, splits, rows, vec, xvec,
        _DTYPE_CODE[x2.dtype], _stream(x2.device))
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def quant_matmul(x: torch.Tensor, q: torch.Tensor,
                 s: torch.Tensor) -> torch.Tensor:
    """Kernel A: ``out[m, n] = (sum_k x[m, k] * q[k, n]) * s[n]`` over
    the rows of ``x [..., K]`` (float32 or bfloat16), the codes ``q [K,
    N]`` int8 and the scales ``s [1, N]`` float32, accumulated in f32 and
    returned in x's dtype, shape ``[..., N]``.  On a CUDA tensor at most
    :data:`KERNEL_MAX_ROWS` rows and any K and N >= 1; another shape
    raises.  On a CUDA tensor it launches ``csrc/quant_matmul.cu``'s
    kernel A (the scales apply to the f32 sum, where the plain version
    rounds ``x @ q`` to x's dtype first: one rounding apart at bf16); on
    a CPU tensor it is :func:`quant_matmul_reference`."""
    _check_shapes("quant_matmul", x, q, s)
    if x.device.type == "cpu":
        return quant_matmul_reference(x, q, s)
    _check_kernel_inputs(x, q, s)
    m = x.numel() // x.shape[-1]
    if m > KERNEL_MAX_ROWS:
        raise ValueError(f"quant_matmul: {m} rows; the kernel takes at "
                         f"most {KERNEL_MAX_ROWS}")
    x2, out, vec, xvec = _operands(x, q)
    if m:
        _launch("quant_matmul", x2, q, s, out, vec, xvec,
                matmul_plan(m, *q.shape, x.dtype, _sms(x.device)))
        quant_matmul.launches += 1
    return out.reshape(*x.shape[:-1], q.shape[1])


quant_matmul.launches = 0


def quant_gemm(x: torch.Tensor, q: torch.Tensor,
               s: torch.Tensor) -> torch.Tensor:
    """Kernel B: the function of :func:`quant_matmul` at any number of
    rows, tiled for the tensor cores (bf16: blocks of
    :data:`GEMM_BLOCK_ROWS` rows on wgmma; f32: a plain tiled product on
    the CUDA cores).  On a CUDA tensor it launches ``csrc/
    quant_matmul.cu``'s kernel B, for any K and N >= 1; on a CPU tensor it
    is :func:`quant_matmul_reference`."""
    _check_shapes("quant_gemm", x, q, s)
    if x.device.type == "cpu":
        return quant_matmul_reference(x, q, s)
    _check_kernel_inputs(x, q, s, "quant_gemm")
    x2, out, vec, xvec = _operands(x, q)
    if x2.shape[0]:
        _launch("quant_gemm", x2, q, s, out, vec, xvec,
                gemm_plan(x2.shape[0], *q.shape, x.dtype, _sms(x.device)))
        quant_gemm.launches += 1
    return out.reshape(*x.shape[:-1], q.shape[1])


quant_gemm.launches = 0
