"""Observability helpers — own copies of parts of
``paddle_operator_tpu/utils/observability.py``:

- :func:`get_logger` and :class:`StepTimer` for the training loop
  (structured logging with a rank prefix; rolling step time, tokens/s
  and MFU);
- the replica half of ``serving_gauges`` and ``histogram_exposition``
  for the serving pod's ``/metrics``, so a port replica renders the same
  gauge names (docs/serving.md, docs/observability.md) the fleet router
  and manager scrape.  A batch-mode server publishes an empty status
  block: every gauge then reads its zero default.
"""

from __future__ import annotations

import logging
import os
import time
from collections import deque
from typing import Optional

_FMT = "%(asctime)s %(levelname).1s %(name)s %(message)s"


def get_logger(name: str = "tpujob") -> logging.Logger:
    """Structured logger with a rank prefix derived from the environment
    at call time (``TPUJOB_RANK``, ``TPUJOB_LOG_LEVEL``).  Exactly one
    handler of ours per logger however often this is called; a logger
    the application configured itself is left alone."""
    logger = logging.getLogger(name)
    rank = os.environ.get("TPUJOB_RANK", "0")
    level = os.environ.get("TPUJOB_LOG_LEVEL", "INFO")
    h = next((h for h in logger.handlers
              if getattr(h, "_tpujob_rank", None) is not None), None)
    if h is None:
        if logger.handlers:
            return logger
        h = logging.StreamHandler()
        h._tpujob_rank = ""          # marks OUR handler; set below
        logger.addHandler(h)
    if h._tpujob_rank != rank:
        h.setFormatter(logging.Formatter(f"[rank {rank}] {_FMT}"))
        h._tpujob_rank = rank
    if logging.getLevelName(logger.level) != level:
        logger.setLevel(level)
    return logger


class StepTimer:
    """Rolling window of step times -> tokens/s and MFU.  ``clock`` is
    read at each :meth:`tick`; a clock that synchronizes the card first
    makes the intervals device-complete step times."""

    def __init__(self, tokens_per_step: int,
                 flops_per_token: Optional[float] = None,
                 peak_flops: Optional[float] = None,
                 window: int = 20,
                 clock=time.perf_counter) -> None:
        self.tokens_per_step = tokens_per_step
        self.flops_per_token = flops_per_token
        self.peak_flops = peak_flops
        self.times: deque = deque(maxlen=window)
        self._last: Optional[float] = None
        self._clock = clock

    def tick(self) -> None:
        now = self._clock()
        if self._last is not None:
            self.times.append(now - self._last)
        self._last = now

    @property
    def step_time(self) -> float:
        return sum(self.times) / len(self.times) if self.times else 0.0

    @property
    def tokens_per_sec(self) -> float:
        st = self.step_time
        return self.tokens_per_step / st if st else 0.0

    @property
    def mfu(self) -> Optional[float]:
        if not (self.flops_per_token and self.peak_flops):
            return None
        return self.tokens_per_sec * self.flops_per_token / self.peak_flops

    def report(self) -> str:
        s = f"step_time={self.step_time:.3f}s tok/s={self.tokens_per_sec:.0f}"
        if self.mfu is not None:
            s += f" mfu={self.mfu:.3f}"
        return s

# the latency histogram families (utils/tracing.py HIST_FAMILIES of the
# JAX package)
HIST_FAMILIES = {
    "ttft": "tpujob_serve_ttft_ms",
    "itl": "tpujob_serve_itl_ms",
    "e2e": "tpujob_serve_e2e_ms",
    "queueWait": "tpujob_serve_queue_wait_ms",
}


def serving_gauges(status_serving: dict, job: str,
                   replica: str = None) -> dict:
    """Prometheus gauge lines for one pod's ``status.serving`` block;
    with ``replica`` set every gauge carries a ``replica`` label.  (The
    operator-aggregated ``replicas``/``fleet`` blocks the JAX function
    also renders are the manager's, not a replica's.)"""
    out = _serving_gauges_one(status_serving, job, replica)
    _qos_gauges(out, status_serving, job, replica)
    return out


def _qos_gauges(out: dict, status_serving: dict, job: str,
                replica: str = None) -> None:
    """Multi-tenant QoS gauges: per-class queue depth, lane preemption
    spills, loaded-adapter count and one marker per adapter name."""
    rep = f',replica="{replica}"' if replica else ""
    depths = status_serving.get("priorityQueueDepth") or [0.0]
    for prio, depth in enumerate(depths):
        out[("tpujob_serve_priority_queue_depth"
             f'{{job="{job}"{rep},prio="{prio}"}}')] = float(depth)
    out[f'tpujob_serve_lane_preemptions_total{{job="{job}"{rep}}}'] = \
        float(status_serving.get("preemptedLanes", 0.0))
    out[f'tpujob_serve_active_adapters{{job="{job}"{rep}}}'] = \
        float(status_serving.get("activeAdapters", 0.0))
    for name in status_serving.get("adapterNames") or ():
        out[("tpujob_serve_adapter_loaded"
             f'{{job="{job}"{rep},adapter="{name}"}}')] = 1.0


# (gauge name, status key) of the plain unlabeled-by-mode gauges, in the
# JAX package's order
_PLAIN = (
    ("tpujob_serve_tokens_per_sec", "tokensPerSec"),
    ("tpujob_serve_accept_rate", "acceptRate"),
    ("tpujob_serve_queue_depth", "queueDepth"),
    ("tpujob_serve_prefix_hit_rate", "prefixHitRate"),
    ("tpujob_serve_kv_blocks_free", "kvBlocksFree"),
    ("tpujob_serve_chunked_prefill_token_share",
     "chunkedPrefillTokenShare"),
    ("tpujob_serve_prefill_lanes", "prefillLanes"),
    ("tpujob_serve_prefill_batch_occupancy", "prefillBatchOccupancy"),
    ("tpujob_serve_prefill_hol_wait_ms", "prefillHolWaitMs"),
    ("tpujob_serve_param_bytes", "paramBytes"),
    ("tpujob_serve_host_cache_blocks", "hostCacheBlocks"),
    ("tpujob_serve_host_hit_rate", "hostHitRate"),
    ("tpujob_serve_promoted_blocks_total", "promotedBlocks"),
    ("tpujob_serve_host_cache_evictions_total", "hostCacheEvictions"),
    ("tpujob_serve_kv_store_blocks", "kvStoreBlocks"),
    ("tpujob_serve_kv_store_bytes", "kvStoreBytes"),
    ("tpujob_serve_kv_store_hit_rate", "kvStoreHitRate"),
    ("tpujob_serve_kv_store_evictions_total", "kvStoreEvictions"),
    ("tpujob_serve_lane_migrations_total", "laneMigrations"),
    ("tpujob_serve_adopted_lanes_total", "adoptedLanes"),
    ("tpujob_serve_peer_prefix_fetches_total", "peerPrefixFetches"),
    ("tpujob_serve_parked_lanes", "parkedLanes"),
    ("tpujob_serve_remote_prefills_total", "remotePrefills"),
    ("tpujob_serve_megastep_n", "megastepN"),
    ("tpujob_serve_dispatches_per_token", "dispatchesPerToken"),
    ("tpujob_serve_deadline_exceeded", "deadlineExceeded"),
    ("tpujob_serve_watchdog_restarts", "watchdogRestarts"),
    ("tpujob_serve_quarantined_lanes", "quarantinedLanes"),
    ("tpujob_serve_generation", "weightGeneration"),
    ("tpujob_serve_tp", "servingTp"),
    ("tpujob_serve_weight_swaps_total", "weightSwaps"),
)


def _serving_gauges_one(status_serving: dict, job: str,
                        replica: str = None) -> dict:
    """One pod's (or one replica's) gauge set."""
    st = status_serving
    rep = f',replica="{replica}"' if replica else ""
    lbl = f'{{job="{job}"{rep}}}'
    out = {f"{name}{lbl}": float(st.get(key, 0.0)) for name, key in _PLAIN}
    out[("tpujob_serve_prefill_queue_depth"
         f'{{job="{job}"{rep},mode="{st.get("prefillMode", "inline")}"}}')] \
        = float(st.get("prefillQueueDepth", 0.0))
    out[("tpujob_serve_kv_pool_bytes"
         f'{{job="{job}"{rep},mode="{st.get("kvQuantMode", "none")}"}}')] \
        = float(st.get("kvPoolBytes", 0.0))
    out[("tpujob_serve_weight_quant_mode"
         f'{{job="{job}"{rep}'
         f',mode="{st.get("weightQuantMode", "none")}"'
         f',draft="{st.get("draftQuantMode", "none")}"}}')] = float(
        st.get("weightQuantMode", "none") != "none"
        or st.get("draftQuantMode", "none") != "none")
    out[f"tpujob_serve_draining{lbl}"] = 1.0 if st.get("draining") else 0.0
    return out


def histogram_exposition(latency_hist: Optional[dict], job: str,
                         replica: str = None) -> str:
    """Prometheus ``_bucket``/``_sum``/``_count`` exposition for one
    pod's ``latencyHist`` block, families in sorted order.  Empty for a
    server that keeps no histograms (batch mode)."""
    if not isinstance(latency_hist, dict) or not latency_hist:
        return ""
    rep = f',replica="{replica}"' if replica else ""
    labels = f'{{job="{job}"{rep}}}'
    lines = []
    for fam, name in sorted(HIST_FAMILIES.items()):
        entry = latency_hist.get(fam)
        if isinstance(entry, dict):
            lines.extend(render_histogram_lines(name, entry, labels))
    return "\n".join(lines) + "\n" if lines else ""


def render_histogram_lines(name: str, entry: dict,
                           labels: str = "") -> list:
    """One histogram snapshot entry -> cumulative ``_bucket`` lines in
    bound order, then +Inf, ``_sum`` and ``_count``."""
    bounds = entry.get("buckets") or []
    counts = entry.get("counts") or []
    base = labels[:-1] + "," if labels else "{"
    lines, cum = [], 0
    for b, c in zip(bounds, counts):
        cum += int(c)
        le = int(b) if float(b).is_integer() else b
        lines.append(f'{name}_bucket{base}le="{le}"}} {cum}')
    lines.append(f'{name}_bucket{base}le="+Inf"}} '
                 f'{int(entry.get("count", 0))}')
    lines.append(f'{name}_sum{labels} '
                 f'{round(float(entry.get("sum", 0.0)), 3)}')
    lines.append(f'{name}_count{labels} '
                 f'{int(entry.get("count", 0))}')
    return lines
