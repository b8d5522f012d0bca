"""Elastic resume — the port of ``paddle_operator_tpu/ft/elastic.py``.

A checkpoint holds global tensors (``params.pt`` whole, the moments in
shard files that carry their global shapes and mesh axes;
``train/checkpoint.py``), so a restarted gang may resume on another
mesh: the production case is the operator's elastic slice drop, after
which the ConfigMap's ``TPUJOB_MESH`` has a smaller ``dp``
(``controller/builders.py`` of the JAX package) and the gang builds
that mesh (``launch/launcher.py`` ``job_mesh``; a multi-card job keeps
its cards a pod, so the smaller gang has fewer pods of as many cards).
int8 moments resume the same way: their shard files hold global blocks,
which a restore onto another mesh reassembles and recuts.  :func:`elastic_resume`
restores into a template built against the CURRENT mesh (``init_fn``:
``create_state(..., mesh=mesh)``), which cuts each rank's region out of
the saved tensors (an fsdp, tp or ep reshape reassembles and recuts the
moments), or onto one card.  Two things do not come for free and are
handled here:

- **data continuity**: the batch at global step *k* must be the same
  data whatever the batch size, or a resume repeats or skips data.
  :func:`resume_step_for` maps the progress kept (global step x global
  batch = samples) to the iterator's fast-forward offset; the
  deterministic source of train/data.py takes ``start_step``.
- **LR-schedule continuity**: when the global batch changes, a
  per-step schedule would replay or skip decay.  :func:`scale_schedule`
  re-parameterizes it to the sample-equivalent position (plus the
  linear-scaling LR rule).
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Tuple

from paddle_operator_tpu_torch.train.checkpoint import (CheckpointManager,
                                                        resume_or_init)


def resume_step_for(tokens_consumed: int, global_batch: int) -> int:
    """Iterator fast-forward offset: the number of *new-batch* steps
    whose data has already been consumed.  Floor: a partly consumed
    batch is read again rather than skipped."""
    if global_batch <= 0:
        raise ValueError(f"global_batch must be positive, got {global_batch}")
    return tokens_consumed // global_batch


def scale_schedule(base_schedule: Callable, ref_global_batch: int,
                   global_batch: int, *, scale_lr: bool = True) -> Callable:
    """Wrap a per-step LR schedule defined for ``ref_global_batch`` so a
    run at ``global_batch`` walks it at the same samples-per-unit rate:
    ``schedule(count)`` is evaluated at ``count * global_batch /
    ref_global_batch``, and ``scale_lr`` multiplies by the same ratio
    (the linear scaling rule).  Equal batches return ``base_schedule``
    itself."""
    if ref_global_batch <= 0 or global_batch <= 0:
        raise ValueError("global batch sizes must be positive")
    ratio = global_batch / ref_global_batch

    def sched(count):
        lr = base_schedule(count * ratio)
        return lr * ratio if scale_lr else lr

    return sched if ratio != 1.0 else base_schedule


def elastic_resume(ckpt: CheckpointManager, init_fn: Callable,
                   state_like: Any = None, *,
                   saved_global_batch: Optional[int] = None,
                   global_batch: Optional[int] = None,
                   goodput=None,
                   logger=None) -> Tuple[Any, bool, Dict[str, Any]]:
    """The restart entry of a resized job: restore the newest complete
    checkpoint into ``state_like`` (default ``init_fn()``, a state built
    against the current mesh), falling back over corrupt steps like
    :func:`train.checkpoint.resume_or_init`.  On a mesh every rank calls
    it together (the restore reads the same step on every rank).

    Returns ``(state, resumed, plan)``; ``plan`` holds ``step`` (the
    restored step, 0 when fresh), ``tokens_consumed`` (step x
    ``saved_global_batch``) and ``data_start_step`` (the fast-forward
    offset at the new ``global_batch``: ``deterministic_lm_batches(...,
    start_step=plan["data_start_step"])`` through ``train/data.py``
    ``process_slice(..., mesh=mesh)`` gives each rank of the new mesh
    its rows, none repeated or skipped).  ``goodput`` (an
    :class:`ft.goodput.GoodputTracker`) books the restore's wall time
    under ``restore``."""
    phase = (goodput.phase("restore") if goodput is not None
             else contextlib.nullcontext())
    with phase:
        state, resumed = resume_or_init(ckpt, init_fn, state_like,
                                        logger=logger)
    step = int(state.step) if resumed else 0
    sgb = saved_global_batch or global_batch or 0
    ngb = global_batch or saved_global_batch or 0
    tokens = step * sgb
    plan: Dict[str, Any] = {
        "step": step,
        "tokens_consumed": tokens,
        "data_start_step": (resume_step_for(tokens, ngb) if ngb else step),
    }
    if resumed and logger is not None:
        logger.info(
            f"elastic resume: step={step} tokens={tokens} "
            f"global_batch {sgb}->{ngb} "
            f"data_start_step={plan['data_start_step']}")
    return state, resumed, plan
