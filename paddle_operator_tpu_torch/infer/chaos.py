"""Deterministic fault injection for the serving ring — the port of
``paddle_operator_tpu/infer/chaos.py`` (its schedule grammar, its
seeded victim pick and its dispatch clock, unchanged).

Faults fire at **dispatch indices**, not wall-clock times: the ring's
dispatch counter is the injector's clock, so a schedule means the same
thing on a fast card and a slow CPU.  The only randomness (the victim
lane when the schedule names none) comes from a seeded
``random.Random``.

Schedule syntax (also the ``TPUJOB_CHAOS`` env var, seed
``TPUJOB_CHAOS_SEED``)::

    kind@index[:arg][,kind@index[:arg]...]

    dispatch_fail@5          raise from dispatch #5
    dispatch_hang@9:2.5      sleep 2.5s inside dispatch #9 (a stall)
    nan_lane@12:1            poison lane 1's KV with NaN before #12
    client_drop@7            cancel a resident request before #7
    pool_oom@3:2             the next 2 pool allocations raise NoFreeBlocks

:meth:`ChaosInjector.install` wraps the executor's plan replayer
(``RingExecutor.replay``, the one call every resident dispatch makes,
1-step or fused, graph replay or eager), so admission, the consume and
the self-healing rebuild all run their own code and only the dispatch
lies.  One replay is one dispatch index at any megastep.

The port's poison differs from the JAX one in one way, by necessity: the
captured CUDA graphs read the cache at fixed addresses, so the NaN is
written INTO the cache tensors, in place, queued on the ring's stream
ahead of the replay it precedes (the JAX harness rebinds the arrays,
which under a graph would poison nothing a replay reads).  Every
injected fault is recorded in the ring's flight recorder, which is then
dumped with the fault named.
"""

from __future__ import annotations

import os
import random
import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional

CHAOS_ENV = "TPUJOB_CHAOS"
CHAOS_SEED_ENV = "TPUJOB_CHAOS_SEED"

KINDS = ("dispatch_fail", "dispatch_hang", "nan_lane", "client_drop",
         "pool_oom")


@dataclass
class ChaosEvent:
    kind: str
    at: int                        # dispatch index the event fires before
    arg: Optional[float] = None    # hang seconds / lane / alloc count


def parse_schedule(spec: str) -> List[ChaosEvent]:
    """``"dispatch_fail@5,nan_lane@12:1"`` -> events.  Raises ValueError
    on unknown kinds or malformed entries — a mistyped schedule that
    silently injected nothing would fake a green run."""
    events: List[ChaosEvent] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "@" not in part:
            raise ValueError(f"chaos entry {part!r}: expected kind@index")
        kind, rest = part.split("@", 1)
        if kind not in KINDS:
            raise ValueError(f"chaos kind {kind!r} not in {KINDS}")
        arg: Optional[float] = None
        if ":" in rest:
            rest, argstr = rest.split(":", 1)
            arg = float(argstr)
        events.append(ChaosEvent(kind, int(rest), arg))
    return events


class ChaosInjector:
    """Wraps a ContinuousBatcher's resident dispatch with a seeded fault
    schedule.  ``fired`` records ``(kind, dispatch_index)`` in firing
    order."""

    def __init__(self, schedule, seed: int = 0) -> None:
        if isinstance(schedule, str):
            schedule = parse_schedule(schedule)
        self.events: Dict[int, List[ChaosEvent]] = {}
        for ev in schedule:
            self.events.setdefault(ev.at, []).append(ev)
        self.rng = random.Random(seed)
        self.dispatches = 0
        self.fired: List[tuple] = []
        self.batcher: Any = None

    def install(self, batcher) -> "ChaosInjector":
        """Replace the executor's plan replayer with the faulting
        wrapper.  Call before submitting work; the wrapper survives a
        self-healing rebuild and a weight swap (both keep the executor
        object)."""
        self.batcher = batcher
        batcher.executor.replay = self._wrap(batcher.executor.replay)
        return self

    def _wrap(self, real):
        def replay(*args):
            idx = self.dispatches
            self.dispatches += 1
            for ev in self.events.get(idx, ()):
                self._apply(ev, idx)
            return real(*args)

        return replay

    def _apply(self, ev: ChaosEvent, idx: int) -> None:
        self.fired.append((ev.kind, idx))
        # recorded and dumped BEFORE the fault fires (dispatch_fail
        # raises out of this frame): the dump names the fault
        fr = getattr(self.batcher, "flightrec", None)
        if fr is not None:
            fr.record("chaos_injected", fault=ev.kind, dispatch=idx,
                      arg=ev.arg)
            fr.dump_file(f"chaos:{ev.kind}")
        if ev.kind == "dispatch_fail":
            raise RuntimeError(
                f"chaos: injected dispatch failure @ dispatch {idx}")
        if ev.kind == "dispatch_hang":
            time.sleep(ev.arg if ev.arg is not None else 1.0)
            return
        if ev.kind == "pool_oom":
            pool = getattr(self.batcher, "pool", None)
            if pool is not None:
                pool.chaos_fail_allocs += int(ev.arg or 1)
            return
        if ev.kind == "client_drop":
            slot = self._victim(ev)
            if slot is not None:
                req = self.batcher.lane[slot]
                if req is not None:
                    req.cancel()
            return
        if ev.kind == "nan_lane":
            slot = self._victim(ev)
            if slot is not None:
                self._poison(slot)

    def _victim(self, ev: ChaosEvent) -> Optional[int]:
        """The schedule's lane, or a seeded pick among resident lanes
        (None when the ring is idle: the event is recorded, the fault a
        no-op)."""
        if ev.arg is not None:
            return int(ev.arg)
        active = [i for i, r in enumerate(self.batcher.lane)
                  if r is not None]
        if not active:
            return None
        return self.rng.choice(active)

    def _poison(self, slot: int) -> None:
        """Write NaN into lane ``slot``'s K so its next logits go
        non-finite.  Lanes are attention-independent, so only this
        lane's stream is poisoned.  Runs on the ring thread inside the
        wrapped dispatch: the in-place writes are queued on the ring's
        stream ahead of the replay.

        - contiguous ring: the lane's whole K;
        - bf16 pool: one private block's K (all layers; a shared prefix
          block would poison other lanes);
        - int8 pool: int8 codes cannot hold a NaN, so the lane's bf16
          staging tail (the write-frontier rows every read of the lane
          takes) and the scales of every private block (a NaN scale
          makes each read of a committed block non-finite; the tail alone
          would wash out when injected at a block boundary)."""
        import torch

        b = self.batcher
        cache = b.executor.cache
        nan = float("nan")
        with torch.inference_mode():
            if not getattr(b, "paged", False):
                cache["k"][:, slot].fill_(nan)
                return
            blocks = b.pool.private_blocks(slot)
            if b.executor.quant:
                cache["kt"][:, slot].fill_(nan)
                for blk in blocks:
                    cache["ks"][:, blk].fill_(nan)
                return
            if blocks:
                cache["k"][:, blocks[0]].fill_(nan)


def maybe_install_from_env(batcher, env=None) -> Optional[ChaosInjector]:
    """serve.py hook: ``TPUJOB_CHAOS`` set -> install the injector on the
    live server's ring (smoke-testing a deployment's resilience end to
    end); unset -> no-op."""
    env = os.environ if env is None else env
    spec = env.get(CHAOS_ENV, "")
    if not spec:
        return None
    seed = int(env.get(CHAOS_SEED_ENV, "0"))
    return ChaosInjector(spec, seed=seed).install(batcher)
