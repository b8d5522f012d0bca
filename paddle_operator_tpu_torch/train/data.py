"""Data input pipeline — the port of ``paddle_operator_tpu/train/data.py``
for one card.

The numpy sources (:func:`synthetic_lm_batches`,
:func:`deterministic_lm_batches`, :func:`process_slice`,
:func:`mmap_token_batches`) are copies: they yield the same arrays as
the JAX package's for the same arguments.  The process index and count
come from ``torch.distributed`` when it is initialized (0 and 1
otherwise).  :class:`DevicePrefetcher` replaces the JAX placement onto a
mesh: a thread pins host batches and copies them to the card ahead of
the consumer.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np
import torch


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
                  process_count: Optional[int] = None
                  ) -> Dict[str, np.ndarray]:
    """This process's contiguous row block of a *global* batch."""
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


def mmap_token_batches(path: str, batch_size: int, seq_len: int,
                       *, dtype=np.uint16, seed: int = 0,
                       loop: bool = True
                       ) -> Iterator[Dict[str, np.ndarray]]:
    """Sample [batch, seq+1] windows from a flat token file
    (memory-mapped; zero-copy until batch assembly), per-process seeds.
    The python gather only: the JAX package's ``native`` option (the C++
    gather of native/dataio.cpp) waits for its binding (ROADMAP.md Queue
    A item 13)."""
    data = np.memmap(path, dtype=dtype, mode="r")
    n = len(data) - seq_len - 1
    if n <= 0:
        raise ValueError(f"{path}: too short for seq_len={seq_len}")
    rng = np.random.default_rng(seed + 2654435761 * _process_index())
    while True:
        starts = rng.integers(0, n, batch_size)
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
    written.  On the CPU the arrays become tensors as they are."""

    def __init__(self, it: Iterator[Dict[str, np.ndarray]], *,
                 device="cuda", depth: int = 2) -> None:
        self.it = it
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
        return batch
