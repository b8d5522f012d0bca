"""The ring operations under CUDA graphs, on the card (``-m cuda``; the
CPU tests of tests/test_torch_swap.py, test_torch_resilience.py and
test_torch_tracing.py hold the same paths against the JAX package): a
live weight swap captures the graphs again over the new weights and a
mid-flight swap to identical weights leaves every stream bit-identical;
a swap to int8 weights routes the ring's projections through the
int8-weight kernels; a NaN lane is quarantined while the other lanes
stream as without the fault; tracing leaves the streams unchanged.
This file imports no JAX: the card's machine has no flax.
"""

import copy
import time

import numpy as np
import pytest
import torch

from paddle_operator_tpu_torch.infer import chaos as CH
from paddle_operator_tpu_torch.infer import quant as Q
from paddle_operator_tpu_torch.infer.batcher import ContinuousBatcher
from paddle_operator_tpu_torch.infer.resilience import (
    LaneQuarantined,
    RingResilience,
)
from paddle_operator_tpu_torch.models.llama import make_model
from paddle_operator_tpu_torch.ops import quant_matmul as QM

PROMPTS = [np.random.default_rng(i).integers(0, 256, n).tolist()
           for i, n in enumerate((30, 6, 20, 4))]
TEMPS, SEEDS, NEW = [0.0, 0.0, 0.8, 0.8], [0, 0, 11, 12], 80


@pytest.mark.cuda
class TestRingOpsUnderGraphs:
    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")

    def _ring(self, model, cfg, **kw):
        return ContinuousBatcher(model, cfg, slots=4, max_len=128,
                                 chunk_tokens=8,
                                 **{"paged": True, "block_size": 16, **kw})

    def _serve(self, b):
        return [b.submit(p, max_new_tokens=NEW, temperature=t, seed=s)
                for p, t, s in zip(PROMPTS, TEMPS, SEEDS)]

    def _model(self, seed=0):
        return make_model("tiny", device="cuda", seed=seed,
                          dtype=torch.float32)

    @pytest.mark.parametrize("kw", [{}, {"megastep": 4},
                                    {"kv_quant": "int8"}])
    def test_mid_flight_swap_recaptures_and_matches(self, kw):
        model, cfg = self._model()
        plain = self._ring(model, cfg, **kw)
        try:
            want = [h.result(timeout=300) for h in self._serve(plain)]
        finally:
            plain.close()
        b = self._ring(model, cfg, **kw)
        ex = b.executor
        replay = ex.replay
        ex.replay = lambda plan: (time.sleep(0.02), replay(plan))[1]
        try:
            hs = self._serve(b)
            while b.stats["chunks"] < 1:
                time.sleep(0.001)
            graphs = ex._graphs
            res = b.swap_weights(copy.deepcopy(model))
            assert [h.result(timeout=300) for h in hs] == want
            assert res["parkedLanes"] >= 1
            assert ex._graphs is not graphs and not ex.needs_capture
            assert ex.graph_replays == b.stats["chunks"]
            b.pool.check_invariant()
        finally:
            b.close()

    def test_swap_to_int8_weights_routes_through_kernel_a(self):
        model, cfg = self._model()
        qmodel = Q.quantize_params(self._model(seed=1)[0], cfg, mode="int8",
                                   skip=Q.SERVING_SKIP)
        fresh = self._ring(qmodel, cfg)
        try:
            want = [h.result(timeout=300) for h in self._serve(fresh)]
        finally:
            fresh.close()
        b = self._ring(model, cfg)
        try:
            b.submit(PROMPTS[0], max_new_tokens=4).result(timeout=300)
            res = b.swap_weights(qmodel)
            assert res["weightQuantMode"] == "int8"
            before = QM.quant_matmul.launches
            assert [h.result(timeout=300) for h in self._serve(b)] == want
            assert QM.quant_matmul.launches > before
        finally:
            b.close()

    @pytest.mark.parametrize("kw", [{}, {"megastep": 4},
                                    {"kv_quant": "int8"},
                                    {"paged": False}])
    def test_nan_lane_quarantined_under_graphs(self, kw):
        model, cfg = self._model()
        plain = self._ring(model, cfg, **kw)
        try:
            want = [h.result(timeout=300) for h in self._serve(plain)]
        finally:
            plain.close()
        b = self._ring(model, cfg, trace=True, resilience=RingResilience(
            watchdog=False, nan_check=True), **kw)
        try:
            hs = self._serve(b)
            assert [h.result(timeout=300) for h in hs] == want
            assert all(h.trace is not None for h in hs)
            # again: the prompts' full blocks now hit the radix, the path
            # of the run under the fault (int8: a hit reads the quantized
            # prefix, so its tokens may differ from the cold run's)
            want = [h.result(timeout=300) for h in self._serve(b)]
            inj = CH.ChaosInjector("").install(b)
            inj.events[inj.dispatches] = [
                CH.ChaosEvent("nan_lane", inj.dispatches, 1)]
            outs = []
            for h in self._serve(b):
                try:
                    outs.append(h.result(timeout=300))
                except LaneQuarantined:
                    outs.append(None)
            assert sum(o is None for o in outs) == 1
            assert all(o == w for o, w in zip(outs, want) if o is not None)
            assert b.stats["quarantined_lanes"] == 1
            assert [h.result(timeout=300) for h in self._serve(b)] == want
            assert b.executor.graph_replays == b.stats["chunks"]
        finally:
            b.close()
