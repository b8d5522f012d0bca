"""Data input pipeline — the port of ``paddle_operator_tpu/train/data.py``
for one card.

The numpy sources (:func:`synthetic_lm_batches`,
:func:`deterministic_lm_batches`, :func:`process_slice`,
:func:`mmap_token_batches`) are copies: they yield the same arrays as
the JAX package's for the same arguments.  :class:`NativeTokenFile` binds
the C++ gather of ``native/dataio.cpp``, which the port builds with
``g++`` at first use into ``build/native_torch/`` (its own library; the
JAX package's ``native/build/`` is left alone).  The process index and count
come from ``torch.distributed`` when it is initialized (0 and 1
otherwise).  :class:`DevicePrefetcher` replaces the JAX placement onto a
mesh: a thread pins host batches and copies them to the card ahead of
the consumer, and with a ``mesh`` hands them out as this rank's rows of
the global batch (DTensors sharded over (dp, fsdp)).  On a mesh the row
block comes from the rank's mesh coordinates (``process_slice(...,
mesh=...)``): ranks that differ only off the data axes (tp, cp, pp,
ep) read the same rows.  A pod of several cards runs one rank a card,
numbered pod-major (``launch/launcher.py``), so the rows its cards read
together are JAX's ``process_slice`` for that pod.  After an elastic
resize the gang's blocks are
those of its new mesh: ``deterministic_lm_batches(..., start_step=
plan["data_start_step"])`` (``ft/elastic.py``) cut by ``process_slice``
hands each new rank its rows of the batch where the old gang stopped.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import queue
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterator, Optional

import numpy as np
import torch

_ROOT = Path(__file__).resolve().parents[2]
NATIVE_SRC = _ROOT / "native" / "dataio.cpp"
NATIVE_DIR = _ROOT / "build" / "native_torch"
CXX_FLAGS = ["-O2", "-fPIC", "-std=c++17", "-shared"]
_native_lock = threading.Lock()


def _process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_available() and \
        dist.is_initialized() else 0


def _process_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def synthetic_lm_batches(batch_size: int, seq_len: int, vocab: int,
                         seed: int = 0) -> Iterator[Dict[str, np.ndarray]]:
    """Deterministic infinite synthetic stream (per-process seed offset so
    data-parallel shards differ)."""
    rng = np.random.default_rng(seed + 1315423911 * _process_index())
    while True:
        yield {"tokens": rng.integers(
            0, vocab, (batch_size, seq_len), dtype=np.int32)}


def deterministic_lm_batches(global_batch: int, seq_len: int, vocab: int,
                             *, seed: int = 0, start_step: int = 0
                             ) -> Iterator[Dict[str, np.ndarray]]:
    """Elastic-resume data source: the batch for global step *k* is a pure
    function of ``(seed, k)``, so a resumed run replays the same global
    batch sequence; ``start_step`` fast-forwards to step *s*'s batch."""
    step = start_step
    while True:
        rng = np.random.default_rng(np.random.SeedSequence([seed, step]))
        yield {"tokens": rng.integers(
            0, vocab, (global_batch, seq_len), dtype=np.int32)}
        step += 1


def process_slice(batch: Dict[str, np.ndarray],
                  process_index: Optional[int] = None,
                  process_count: Optional[int] = None, *,
                  mesh=None) -> Dict[str, np.ndarray]:
    """This process's contiguous row block of a *global* batch.  With a
    ``mesh`` the block is the rank's (dp, fsdp) block
    (``parallel/sharding.py`` ``data_block``), not its rank."""
    if mesh is not None:
        from paddle_operator_tpu_torch.parallel.sharding import data_block

        process_index, process_count = data_block(mesh)
    pi = _process_index() if process_index is None else process_index
    pc = _process_count() if process_count is None else process_count
    if pc == 1:
        return batch
    out = {}
    for k, v in batch.items():
        if v.shape[0] % pc:
            raise ValueError(
                f"global batch {v.shape[0]} not divisible by "
                f"{pc} processes for key {k!r}")
        per = v.shape[0] // pc
        out[k] = v[pi * per:(pi + 1) * per]
    return out


def _native_lib_path() -> Path:
    h = hashlib.sha256(NATIVE_SRC.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return NATIVE_DIR / f"libdataio-{h.hexdigest()[:16]}.so"


def _find_native_lib() -> Optional[str]:
    """The port's built gather library, or None (its copy of the JAX
    package's ``controller/hostport.py`` lookup, over its own build
    directory)."""
    path = _native_lib_path()
    return str(path) if path.exists() else None


def build_native_lib() -> str:
    """Compile ``native/dataio.cpp`` with ``g++`` into
    ``build/native_torch/`` unless it is there (keyed by a hash of the
    source and the flags); returns the library's path.  Raises with the
    compiler's output when the build fails."""
    with _native_lock:
        found = _find_native_lib()
        if found:
            return found
        out = _native_lib_path()
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run(
            ["g++", *CXX_FLAGS, "-o", str(tmp),
             str(NATIVE_SRC)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {NATIVE_SRC} failed (exit "
                               f"{proc.returncode}):\n{proc.stdout}"
                               f"{proc.stderr}")
        os.replace(tmp, out)
        return str(out)


class NativeTokenFile:
    """ctypes binding to the native mmap gather (native/dataio.cpp): one
    C call assembles a whole [B, win] int32 batch from a flat token
    file.  ``lib_path`` defaults to the port's library, built here if it
    is missing."""

    def __init__(self, path: str, dtype=np.uint16,
                 lib_path: Optional[str] = None) -> None:
        width = np.dtype(dtype).itemsize
        if width not in (2, 4):
            raise ValueError(f"unsupported token dtype {dtype}")
        lib = ctypes.CDLL(lib_path or build_native_lib())
        lib.dio_open.restype = ctypes.c_void_p
        lib.dio_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.dio_len.restype = ctypes.c_int64
        lib.dio_len.argtypes = [ctypes.c_void_p]
        lib.dio_gather.restype = ctypes.c_int
        lib.dio_gather.argtypes = [
            ctypes.c_void_p,
            np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS"),
            ctypes.c_int64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")]
        lib.dio_close.argtypes = [ctypes.c_void_p]
        self._lib = lib
        self._h = lib.dio_open(path.encode(), width)
        if not self._h:
            raise FileNotFoundError(f"dio_open failed for {path}")

    def __len__(self) -> int:
        return int(self._lib.dio_len(self._h))

    def gather(self, starts: np.ndarray, win: int) -> np.ndarray:
        starts = np.ascontiguousarray(starts, np.int64)
        out = np.empty((len(starts), win), np.int32)
        rc = self._lib.dio_gather(self._h, starts, len(starts), win, out)
        if rc != 0:
            raise IndexError("window out of bounds")
        return out

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.dio_close(self._h)
            self._h = None

    def __del__(self) -> None:
        self.close()


def mmap_token_batches(path: str, batch_size: int, seq_len: int,
                       *, dtype=np.uint16, seed: int = 0,
                       loop: bool = True,
                       native: Optional[bool] = None
                       ) -> Iterator[Dict[str, np.ndarray]]:
    """Sample [batch, seq+1] windows from a flat token file (memory-mapped;
    zero-copy until batch assembly), per-process seeds.

    ``native``: gather with :class:`NativeTokenFile` (one C call a
    batch instead of a per-row python slice loop).  Default: native when
    the port's library is built, python otherwise; True builds it if
    needed (and raises if it cannot), False keeps to python.  Both give
    the same batches."""
    reader = None
    if native or (native is None and _find_native_lib() is not None):
        try:
            reader = NativeTokenFile(path, dtype)
        except (FileNotFoundError, ValueError):
            if native:
                raise
    if reader is not None:
        n = len(reader) - seq_len - 1
    else:
        data = np.memmap(path, dtype=dtype, mode="r")
        n = len(data) - seq_len - 1
    if n <= 0:
        raise ValueError(f"{path}: too short for seq_len={seq_len}")
    rng = np.random.default_rng(seed + 2654435761 * _process_index())
    while True:
        starts = rng.integers(0, n, batch_size)
        if reader is not None:
            batch = reader.gather(starts, seq_len + 1)
        else:
            batch = np.stack([np.asarray(data[s:s + seq_len + 1])
                              for s in starts]).astype(np.int32)
        yield {"tokens": batch}
        if not loop:
            break


class DevicePrefetcher:
    """Wrap a host-batch iterator (dicts of numpy arrays): a background
    thread keeps ``depth`` batches in flight on ``device`` (the card
    unless the caller asks otherwise).

    On CUDA each batch is pinned and copied with ``non_blocking=True``
    on a side stream; ``__next__`` makes the consumer's current stream
    wait on that copy's event (and records the tensors on it for the
    caching allocator), so a batch is never read while it is being
    written.  On the CPU the arrays become tensors as they are.

    ``mesh``: the iterator yields this rank's rows (its (dp, fsdp)
    block, ``process_slice(..., mesh=mesh)``), placed on the mesh's
    device type and handed out as DTensors of the global batch, sharded
    over (dp, fsdp) and replicated over the other axes (whole rows over
    cp: the causal-LM train step cuts a rank's cp chunk itself, after
    the next-token shift)."""

    def __init__(self, it: Iterator[Dict[str, np.ndarray]], *,
                 device=None, depth: int = 2, mesh=None) -> None:
        from paddle_operator_tpu_torch.parallel.mesh import require_mesh

        require_mesh(mesh)
        self.it = it
        self.mesh = mesh
        if device is None:
            device = "cuda" if mesh is None else mesh.device_type
        elif mesh is not None and torch.device(device).type \
                != mesh.device_type:
            raise ValueError(f"DevicePrefetcher: device {device!r} is not "
                             f"the mesh's {mesh.device_type!r}")
        self.device = torch.device(device)
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._t = threading.Thread(target=self._fill, daemon=True,
                                   name="device-prefetch")
        self._t.start()

    def _place(self, batch: Dict[str, np.ndarray]):
        if not self._cuda:
            return {k: torch.as_tensor(np.asarray(v), device=self.device)
                    for k, v in batch.items()}, None
        with torch.cuda.stream(self._stream):
            out = {k: torch.from_numpy(np.ascontiguousarray(v)).pin_memory()
                   .to(self.device, non_blocking=True)
                   for k, v in batch.items()}
            ready = torch.cuda.Event()
            ready.record(self._stream)
        return out, ready

    def _fill(self) -> None:
        try:
            for batch in self.it:
                self._q.put(self._place(batch))
        except BaseException as e:  # surfaced on next()
            self._err = e
        self._q.put(None)

    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, torch.Tensor]:
        item = self._q.get()
        if item is None:
            self._q.put(None)        # later calls stop too
            if self._err is not None:
                raise self._err
            raise StopIteration
        batch, ready = item
        if ready is not None:
            consumer = torch.cuda.current_stream(self.device)
            consumer.wait_event(ready)
            for t in batch.values():
                t.record_stream(consumer)
        if self.mesh is not None:
            from paddle_operator_tpu_torch.parallel.sharding import (
                local_batch)

            batch = local_batch(batch, self.mesh, self.device)
        return batch
