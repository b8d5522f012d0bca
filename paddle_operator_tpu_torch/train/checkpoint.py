"""Checkpoint / resume — the port of ``paddle_operator_tpu/train/
checkpoint.py``.

The operator carries ``spec.checkpointPath`` into every pod as
``TPUJOB_CHECKPOINT_PATH``; a restarted gang comes back with the same
ranks and path, ``latest_step`` finds the newest complete checkpoint and
training resumes, and a serving pod boots from it.  The JAX package does
this through orbax, which imports jax, so the port writes torch's own
format:

- each step is a directory ``<path>/<step>/`` holding ``params.pt`` (the
  model's state dict, in the parameters' own dtype), ``opt.pt`` (``step``
  and the AdamW ``count``, ``mu`` and ``nu``) and, written last,
  ``torch_checkpoint.json`` (the format and the step).  A server reads
  ``params.pt`` alone.  The files hold only tensors, ints and plain dicts,
  and load with ``torch.load(weights_only=True, mmap=True)``;
- a step is committed by writing it into a temporary sibling directory
  (``.<step>.tmp-*``), flushing every file and the directory, and
  renaming it to ``<path>/<step>``.  Only committed steps are steps: a
  temporary directory that a killed writer left behind is not one;
- a directory ``<path>/<digits>`` without ``torch_checkpoint.json`` was
  not written by this package (an orbax checkpoint of the JAX package,
  say).  Every listing refuses the path with an error naming it: it is
  neither skipped in silence nor overwritten by a fresh start.

Saves are asynchronous.  ``save`` copies the state to host memory before
it returns — the train step updates parameters and moments IN PLACE, so
a writer that read the live tensors would write a later step's numbers —
and one background thread writes the copy.  ``wait`` joins it and raises
what it raised.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time
import uuid
from typing import Any, Dict, Optional

import torch
from torch import nn

FORMAT = 1
PARAMS_FILE = "params.pt"
OPT_FILE = "opt.pt"
MARKER = "torch_checkpoint.json"


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _write_file(path: str, obj: Any) -> None:
    with open(path, "wb") as f:
        if isinstance(obj, bytes):
            f.write(obj)
        else:
            torch.save(obj, f)
        f.flush()
        os.fsync(f.fileno())


def _load(path: str) -> Any:
    return torch.load(path, weights_only=True, map_location="cpu",
                      mmap=True)


def _check_like(saved: Dict[str, torch.Tensor], like: Dict[str, Any],
                what: str, where: str) -> None:
    """Raise unless ``saved`` has exactly ``like``'s keys and shapes."""
    missing = sorted(set(like) - set(saved))
    unexpected = sorted(set(saved) - set(like))
    if missing or unexpected:
        raise ValueError(f"{where}: {what} do not match the model: missing "
                         f"{missing}, unexpected {unexpected}")
    bad = [f"{k} {tuple(saved[k].shape)} != {tuple(like[k].shape)}"
           for k in sorted(like) if saved[k].shape != like[k].shape]
    if bad:
        raise ValueError(f"{where}: {what} shapes differ: {bad}")


class CheckpointManager:
    """Save and restore a :class:`train.trainer.TrainState` under
    ``path`` (default ``$TPUJOB_CHECKPOINT_PATH``; no path, disabled).

    ``save_interval_steps`` is orbax's default policy: an unforced save
    of ``step`` happens when ``step % save_interval_steps == 0`` and
    ``step`` is past every saved or pending step.  After each commit the
    oldest steps beyond ``max_to_keep`` are deleted.  ``last_save`` holds
    the newest save's ``step``, ``bytes`` on disk, ``snapshot_s`` (the
    copy to host memory: how long ``save`` held the caller) and
    ``write_s`` (the background write); its last two keys appear once
    the write has committed."""

    def __init__(self, path: Optional[str] = None, *, max_to_keep: int = 3,
                 save_interval_steps: int = 1000) -> None:
        self.path = path or os.environ.get("TPUJOB_CHECKPOINT_PATH", "")
        if max_to_keep < 1 or save_interval_steps < 1:
            raise ValueError(f"max_to_keep {max_to_keep} and "
                             f"save_interval_steps {save_interval_steps} "
                             "must be at least 1")
        self.max_to_keep = max_to_keep
        self.save_interval_steps = save_interval_steps
        self.last_save: Dict[str, float] = {}
        self._thread: Optional[threading.Thread] = None
        self._pending: Optional[int] = None
        self._error: Optional[BaseException] = None

    @property
    def enabled(self) -> bool:
        return bool(self.path)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.path, str(step))

    def all_steps(self) -> list:
        """Committed steps, ascending (the restore fallback walks this
        backwards when the newest step turns out corrupt).  Raises
        ``ValueError`` on a step directory this package did not
        write."""
        if not self.enabled or not os.path.isdir(self.path):
            return []
        steps = []
        for name in os.listdir(self.path):
            d = os.path.join(self.path, name)
            if not (name.isascii() and name.isdigit() and os.path.isdir(d)):
                continue          # temporary directories, other files
            if not os.path.exists(os.path.join(d, MARKER)):
                raise ValueError(
                    f"{d} is a checkpoint step that paddle_operator_tpu_torch"
                    f" did not write (no {MARKER}; an orbax checkpoint of "
                    "the JAX package?): the torch package neither reads "
                    "nor replaces it; give it a checkpoint path of its own")
            steps.append(int(name))
        return sorted(steps)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def should_save(self, step: int) -> bool:
        """The unforced policy (class docstring).  The directory is
        listed only on the interval's steps."""
        if step % self.save_interval_steps:
            return False
        known = self.all_steps()
        if self._pending is not None:
            known.append(self._pending)
        return not known or max(known) < step

    def save(self, step: int, state: Any, *, force: bool = False) -> bool:
        """Save ``state`` (a TrainState) as ``step`` in the background.
        Returns True when a save was scheduled.  A write still in flight
        is waited for first; a step already committed raises
        ``ValueError``."""
        if not self.enabled or not (force or self.should_save(step)):
            return False
        self.wait()
        if step in self.all_steps():
            raise ValueError(f"checkpoint step {step} already exists under "
                             f"{self.path}")
        t0 = time.perf_counter()
        # copy=True: on the CPU .to("cpu") would hand back the live
        # tensor itself
        params = {k: v.detach().to("cpu", copy=True)
                  for k, v in state.model.state_dict().items()}
        opt = state.opt_state
        rest = {"step": int(state.step), "count": int(opt.count),
                "mu": {k: v.detach().to("cpu", copy=True)
                       for k, v in opt.mu.items()},
                "nu": {k: v.detach().to("cpu", copy=True)
                       for k, v in opt.nu.items()}}
        self.last_save = {"step": step,
                          "snapshot_s": time.perf_counter() - t0}
        self._pending = step
        self._thread = threading.Thread(
            target=self._write, args=(step, params, rest),
            name=f"checkpoint-{step}")
        self._thread.start()
        return True

    def _write(self, step: int, params: dict, rest: dict) -> None:
        try:
            t0 = time.perf_counter()
            os.makedirs(self.path, exist_ok=True)
            tmp = os.path.join(self.path,
                               f".{step}.tmp-{uuid.uuid4().hex[:12]}")
            os.mkdir(tmp)
            try:
                _write_file(os.path.join(tmp, PARAMS_FILE), params)
                _write_file(os.path.join(tmp, OPT_FILE), rest)
                _write_file(os.path.join(tmp, MARKER), json.dumps(
                    {"format": FORMAT, "step": step}).encode())
                _fsync_dir(tmp)
                nbytes = sum(os.path.getsize(os.path.join(tmp, f))
                             for f in (PARAMS_FILE, OPT_FILE, MARKER))
                os.rename(tmp, self._step_dir(step))
            except BaseException:
                shutil.rmtree(tmp, ignore_errors=True)
                raise
            _fsync_dir(self.path)
            self.last_save.update(bytes=nbytes,
                                  write_s=time.perf_counter() - t0)
            for old in self.all_steps()[:-self.max_to_keep]:
                # renamed out of the step namespace first: a kill
                # mid-delete leaves a temporary directory, not a torn step
                doomed = os.path.join(
                    self.path, f".{old}.tmp-{uuid.uuid4().hex[:12]}")
                os.rename(self._step_dir(old), doomed)
                shutil.rmtree(doomed)
        except BaseException as err:   # raised by wait()
            self._error = err

    def restore(self, state_like: Any, step: Optional[int] = None) -> Any:
        """Load ``step`` (default: the newest) into ``state_like`` in place
        and return it.  ``state_like`` is a TrainState — parameters
        (through ``load_state_dict``, which keeps the ``Parameter``
        objects the optimizer state is keyed by), ``mu`` and ``nu`` (on
        their parameters' devices, in their saved dtypes), ``count`` and
        ``step`` — or a model, whose parameters alone are loaded, cast to
        the model's own dtypes (the serving restore: ``opt.pt`` is not
        read).  A missing or unexpected key or a shape mismatch raises
        before anything is changed."""
        if not self.enabled:
            raise RuntimeError("checkpointing disabled (no path)")
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {self.path}")
        d = self._step_dir(step)
        with open(os.path.join(d, MARKER)) as f:
            meta = json.load(f)
        if meta != {"format": FORMAT, "step": step}:
            raise ValueError(f"{d}: unexpected {MARKER} {meta}")
        model = state_like if isinstance(state_like, nn.Module) \
            else state_like.model
        params = _load(os.path.join(d, PARAMS_FILE))
        _check_like(params, model.state_dict(), "parameters", d)
        if isinstance(state_like, nn.Module):
            model.load_state_dict(params)
            return state_like
        rest = _load(os.path.join(d, OPT_FILE))
        named = dict(model.named_parameters())
        _check_like(rest["mu"], named, "first moments", d)
        _check_like(rest["nu"], named, "second moments", d)
        model.load_state_dict(params)
        opt = state_like.opt_state
        for moments, saved in ((opt.mu, rest["mu"]), (opt.nu, rest["nu"])):
            for k, v in saved.items():
                # copy=True: nothing stays backed by the mapped file
                moments[k] = v.to(named[k].device, copy=True)
        opt.count = int(rest["count"])
        state_like.step = int(rest["step"])
        return state_like

    def wait(self) -> None:
        """Block until the pending save is durable; raise what its
        writer raised."""
        t, self._thread = self._thread, None
        if t is not None:
            t.join()
        self._pending = None
        err, self._error = self._error, None
        if err is not None:
            raise err

    def close(self) -> None:
        """Flush the pending save (an exiting trainer that saved and
        closed must not drop its newest checkpoint: the step a
        preemption drain forced)."""
        self.wait()


def resume_or_init(ckpt: CheckpointManager, init_fn, state_like=None, *,
                   logger=None):
    """The restart-recovery entry: restore the latest checkpoint if one
    exists, else initialize fresh.  ``init_fn()`` builds a fresh state
    (or model); ``state_like`` (default: ``init_fn()``) is what the
    checkpoint is restored into.  Returns ``(state, resumed)``.

    A corrupt or partial newest step (a torn write during the kill that
    caused this very restart) falls back to the previous complete step
    with a logged warning; only when every step fails does the newest
    step's error surface."""
    if ckpt.enabled and ckpt.latest_step() is not None:
        if logger is None:
            # the fallback is never silent, even for callers that pass
            # no logger
            from paddle_operator_tpu_torch.utils.observability import (
                get_logger)

            logger = get_logger()
        like = state_like if state_like is not None else init_fn()
        first_err: Optional[Exception] = None
        for step in reversed(ckpt.all_steps()):
            try:
                return ckpt.restore(like, step=step), True
            except Exception as err:
                if first_err is None:
                    first_err = err
                logger.warning(
                    f"checkpoint step {step} failed to restore "
                    f"({type(err).__name__}: {err}); trying the "
                    f"previous complete step")
        raise first_err
    return init_fn(), False
