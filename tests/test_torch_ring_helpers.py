"""The continuous ring's host helpers in the torch package — own copies of
jax-free code of the JAX package — held against the originals on the
same seeded inputs: the QoS config and queue (infer/qos.py), the
restart/watchdog arithmetic and knobs (infer/resilience.py), and the
always-on latency histograms and flight recorder (utils/tracing.py).
"""

import dataclasses

import numpy as np
import pytest

from paddle_operator_tpu.infer import qos as JQ
from paddle_operator_tpu.infer import resilience as JR
from paddle_operator_tpu.utils import tracing as JT
from paddle_operator_tpu_torch.infer import qos as TQ
from paddle_operator_tpu_torch.infer import resilience as TR
from paddle_operator_tpu_torch.utils import tracing as TT


class FakeClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


QOS_ENVS = [
    {},
    {"SERVE_PRIORITIES": "3"},
    {"SERVE_PRIORITIES": "2", "SERVE_PREEMPT": "0",
     "SERVE_PREEMPT_MAX_PER_REQ": "5", "SERVE_PREEMPT_BUDGET": "9",
     "SERVE_PREEMPT_WINDOW_S": "2.5"},
]


@pytest.mark.parametrize("env", QOS_ENVS)
def test_qos_config_from_env_equal(monkeypatch, env):
    for k in ("SERVE_PRIORITIES", "SERVE_PREEMPT",
              "SERVE_PREEMPT_MAX_PER_REQ", "SERVE_PREEMPT_BUDGET",
              "SERVE_PREEMPT_WINDOW_S"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    # every field of the JAX config, preemption and its budgets too
    want = dataclasses.asdict(JQ.QoSConfig.from_env())
    names = [f.name for f in dataclasses.fields(TQ.QoSConfig)]
    assert names == ["priorities", "default_priority", "preempt",
                     "max_preempts_per_request", "preempt_budget",
                     "preempt_window_s"]
    assert names == [f.name for f in dataclasses.fields(JQ.QoSConfig)]
    for got in (TQ.QoSConfig.from_env(), TQ.QoSConfig.from_env(env)):
        assert dataclasses.asdict(got) == want


@pytest.mark.parametrize("n_classes,maxsize,seed",
                         [(1, 0, 0), (3, 2, 1), (4, 3, 2)])
def test_multi_class_queue_same_order(n_classes, maxsize, seed):
    """One seeded sequence of puts and gets: the same pops, sizes and
    Full/Empty outcomes."""
    import queue

    rng = np.random.default_rng(seed)
    qs = [JQ.MultiClassQueue(n_classes, maxsize=maxsize),
          TQ.MultiClassQueue(n_classes, maxsize=maxsize)]
    logs = [[], []]
    for step in range(200):
        op = rng.integers(0, 3)
        prio = int(rng.integers(0, n_classes))
        for q, log in zip(qs, logs):
            try:
                if op < 2:
                    q.put_nowait(step, prio)
                    log.append(("put", step))
                else:
                    log.append(("get", q.get_nowait()))
            except queue.Full:
                log.append(("full", prio))
            except queue.Empty:
                log.append(("empty",))
            log.append((q.qsize(), q.qsize_by_class(), q.empty(),
                        q.full(prio), q.peek_class()))
    assert logs[0] == logs[1]
    assert qs[0].items() == qs[1].items()


RESILIENCE_ENVS = [
    {},
    {"SERVE_WATCHDOG": "0", "SERVE_WATCHDOG_FACTOR": "3",
     "SERVE_WATCHDOG_FLOOR_S": "7.5", "SERVE_MAX_RESTARTS": "5",
     "SERVE_RESTART_WINDOW_S": "60", "SERVE_NAN_CHECK": "1"},
]


@pytest.mark.parametrize("env", RESILIENCE_ENVS)
def test_ring_resilience_from_env_equal(env):
    want = JR.RingResilience.from_env(env)
    got = TR.RingResilience.from_env(env)
    for f in dataclasses.fields(got):
        assert getattr(got, f.name) == getattr(want, f.name), f.name


def test_rolling_quantile_equal():
    rng = np.random.default_rng(7)
    a, b = JR.RollingQuantile(0.95, window=16), TR.RollingQuantile(0.95,
                                                                   16)
    assert a.value() is None and b.value() is None
    for x in rng.exponential(1.0, 50):
        a.add(x)
        b.add(x)
        assert a.value() == b.value()


def test_restart_budget_same_backoffs():
    cfg_j = JR.RingResilience(max_restarts=3, restart_window_s=30.0)
    cfg_t = TR.RingResilience(max_restarts=3, restart_window_s=30.0)
    clocks = [FakeClock(), FakeClock()]
    budgets = [JR.RestartBudget(cfg_j, clock=clocks[0]),
               TR.RestartBudget(cfg_t, clock=clocks[1])]
    for dt in [0, 1, 1, 1, 40, 2, 2, 2, 2, 31, 0]:
        outs = []
        for c, b in zip(clocks, budgets):
            c.t += dt
            outs.append((b.exhausted, None if b.exhausted else b.spend(),
                         b.used))
        assert outs[0] == outs[1]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hist_quantile_equal(seed):
    rng = np.random.default_rng(seed)
    bounds = JT.BUCKETS_MS
    counts = rng.integers(0, 5, len(bounds) + 1).tolist()
    for q in (0.0, 0.5, 0.95, 0.99, 1.0):
        assert TT.hist_quantile(bounds, counts, q) == \
            JT.hist_quantile(bounds, counts, q)
    assert TT.hist_quantile(bounds, [0] * len(counts), 0.5) is None


def test_serve_histograms_same_snapshot():
    clocks = [FakeClock(), FakeClock()]
    hs = [JT.ServeHistograms(clock=clocks[0]),
          TT.ServeHistograms(clock=clocks[1])]
    rng = np.random.default_rng(3)
    for v, dt in zip(rng.exponential(300.0, 120), rng.uniform(0, 2, 120)):
        fam = ["ttft", "itl", "e2e", "queueWait"][int(v) % 4]
        for c, h in zip(clocks, hs):
            c.t += float(dt)
            h.families()[fam].observe(float(v))
    assert TT.HIST_FAMILIES == JT.HIST_FAMILIES
    assert hs[0].snapshot() == hs[1].snapshot()
    assert hs[0].ttft.p95() == hs[1].ttft.p95()


def test_flight_recorder_same_dump_shape():
    recs = [JT.FlightRecorder(capacity=4, pod="r0"),
            TT.FlightRecorder(capacity=4, pod="r0")]
    for r in recs:
        for i in range(6):
            r.record("admit", rid=f"q{i}", slot=i % 2)
    dumps = [r.dump("test") for r in recs]
    assert set(dumps[0]) == set(dumps[1])
    strip = [[{k: v for k, v in e.items() if k not in ("t", "ts", "wall")}
              for e in d["events"]] for d in dumps]
    assert strip[0] == strip[1] and len(strip[1]) == 4
