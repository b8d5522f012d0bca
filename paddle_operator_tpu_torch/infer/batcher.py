"""Continuous-batching decode ring — re-exporting facade, as
``paddle_operator_tpu/infer/batcher.py``: the host scheduler lives in
``infer/scheduler.py`` and the device half in ``infer/executor.py``;
this module keeps one import surface for both."""

from paddle_operator_tpu_torch.infer.executor import (  # noqa: F401
    DispatchResult,
    ExecPlan,
    RingExecutor,
    _default_buckets,
    _layer_step,
    _qkv_ring,
    _ring_forward,
    _sample_tokens,
    _splice_lane,
    _write_lane,
    init_ring_cache,
    make_chunk_step,
    make_prefill_insert,
)
from paddle_operator_tpu_torch.infer.scheduler import (  # noqa: F401
    PREFILL_MODES,
    ContinuousBatcher,
    QueueFull,
)
