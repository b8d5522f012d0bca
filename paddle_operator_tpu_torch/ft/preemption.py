"""Preemption drain: turn SIGTERM / maintenance notices into a clean exit.

Own copy of ``paddle_operator_tpu/ft/preemption.py``: the exit-code
contract, :class:`PreemptionWatcher`, :func:`inject_preemption` and
:func:`drain_checkpoint`.

    0               clean completion
    EXIT_PREEMPTED  drain completed; checkpoint durable; restart me
    anything else   program failure; consumes the restart budget

The training loop (train/trainer.py ``fit``) drains by finishing the
in-flight step and forcing a durable checkpoint of it
(:func:`drain_checkpoint`); on a mesh every rank agrees to stop after
the same step.  A pod of several cards gets the signal on every card's
process (``launch/launcher.py`` ``run_pod`` forwards it), they drain
together, and the pod exits ``EXIT_PREEMPTED``.  Serving pods drain by "stop admissions
(503 + Retry-After), finish in-flight work within the budget"
(infer/resilience.py ServingDrain); the exit code, and the reconciler's
preempted-not-failed accounting, are the trainer's.
"""

from __future__ import annotations

import os
import signal
import threading
from typing import Callable, Iterable, Optional

# the cross-layer contract constant (api/types.py of the JAX package);
# tests pin the two packages' values together
EXIT_PREEMPTED = 83

# Env var naming the maintenance-notice file a node agent touches ahead
# of maintenance / spot reclaim.
NOTICE_FILE_ENV = "TPUJOB_PREEMPTION_NOTICE_FILE"


class PreemptionWatcher:
    """One flag, two sources: unix signals and a maintenance-notice file.

    ``install()`` must run on the main thread (CPython delivers signals
    there).  The watcher chains any previously-installed handler so it
    composes with frameworks that hook SIGTERM themselves.
    """

    def __init__(self) -> None:
        self._event = threading.Event()
        self.reason: str = ""
        self._prev: dict = {}
        self._poll_thread: Optional[threading.Thread] = None
        self._poll_stop = threading.Event()
        self._callbacks: list = []

    @property
    def draining(self) -> bool:
        """True once a preemption notice arrived."""
        return self._event.is_set()

    def trigger(self, reason: str = "manual") -> None:
        """Mark the process as draining (also the test hook)."""
        if not self._event.is_set():
            self.reason = reason
            self._event.set()
            for cb in self._callbacks:
                try:
                    cb(reason)
                except Exception:
                    pass

    def on_drain(self, cb: Callable[[str], None]) -> None:
        """Register a callback fired once when the drain starts."""
        self._callbacks.append(cb)

    @classmethod
    def install(cls, signals: Iterable[int] = (signal.SIGTERM,),
                notice_file: Optional[str] = None,
                poll_interval: float = 1.0) -> "PreemptionWatcher":
        """Install handlers and (when a notice file is configured) start
        the poll thread.  ``notice_file`` defaults to
        ``$TPUJOB_PREEMPTION_NOTICE_FILE``; no file, no poller."""
        w = cls()
        for sig in signals:
            prev = signal.signal(sig, w._make_handler(sig))
            w._prev[sig] = prev
        notice_file = notice_file or os.environ.get(NOTICE_FILE_ENV, "")
        if notice_file:
            w.watch_file(notice_file, poll_interval)
        return w

    def _make_handler(self, sig: int):
        def handler(signum, frame):
            self.trigger(f"signal:{signal.Signals(signum).name}")
            prev = self._prev.get(sig)
            if callable(prev):
                prev(signum, frame)
        return handler

    def watch_file(self, path: str, poll_interval: float = 1.0) -> None:
        """Poll ``path``; its appearance (or pre-existence) triggers the
        drain with the file's first line as the reason."""

        def read_line() -> str:
            try:
                with open(path) as f:
                    return f.readline().strip()
            except OSError:
                return ""

        def poll() -> None:
            while not self._poll_stop.is_set():
                if os.path.exists(path):
                    line = read_line()
                    if not line:
                        # create->write is not atomic: give the writer
                        # one poll tick before triggering bare
                        self._poll_stop.wait(poll_interval)
                        line = read_line()
                    self.trigger(f"notice-file:{line}" if line
                                 else "notice-file")
                    return
                self._poll_stop.wait(poll_interval)

        self._poll_thread = threading.Thread(target=poll, daemon=True,
                                             name="preemption-notice")
        self._poll_thread.start()

    def uninstall(self) -> None:
        """Restore the previous signal handlers and stop the file poller
        (test hygiene; production processes exit instead)."""
        self._poll_stop.set()
        for sig, prev in self._prev.items():
            try:
                signal.signal(sig, prev if prev is not None
                              else signal.SIG_DFL)
            except (ValueError, TypeError):
                pass  # not on the main thread / handler not restorable
        self._prev.clear()


def inject_preemption(batches, at_step: int, watcher: PreemptionWatcher,
                      *, signal_self: bool = False):
    """Test harness: pass ``batches`` through, raising the preemption
    flag just before yielding batch index ``at_step`` — so the step
    consuming that batch is the in-flight step the drain must finish.
    ``signal_self`` delivers a real SIGTERM to this process (the watcher
    must be installed) instead of flipping the flag directly."""
    for k, b in enumerate(batches):
        if k == at_step:
            if signal_self:
                os.kill(os.getpid(), signal.SIGTERM)
            else:
                watcher.trigger("injected")
        yield b


def drain_checkpoint(checkpoint, state, step: int) -> bool:
    """The durable-checkpoint half of the drain: force a save of
    ``state`` at ``step`` and block until it is on storage.  Returns
    True when a checkpoint manager was active (the exit code should then
    be ``EXIT_PREEMPTED``; without one the work is lost)."""
    if checkpoint is None or not getattr(checkpoint, "enabled", False):
        return False
    if step not in checkpoint.all_steps():
        try:
            checkpoint.save(step, state, force=True)
        except ValueError:
            # the loop's interval save of this very step was in flight
            # and has committed meanwhile
            pass
    checkpoint.wait()
    return True
