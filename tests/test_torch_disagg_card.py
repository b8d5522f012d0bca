"""Disaggregated prefill on the card (``-m cuda``; the CPU tests of
tests/test_torch_disagg.py and test_torch_prefill_pool.py hold the same
paths against the JAX package): the engine's stream issues a slice while
the ring thread captures its graphs again after a heal (graph capture
in ``thread_local`` mode, so another thread's launches do not break
it), and the healed ring's streams equal ``generate``; a weight swap
re-stamps the engine and its capture finds the engine's lanes released;
the engine's work and the ring's copies are ordered by events alone.
This file imports no JAX: the card's machine has no flax.
"""

import threading

import numpy as np
import pytest
import torch

from paddle_operator_tpu_torch.infer import chaos as CH
from paddle_operator_tpu_torch.infer import decode as D
from paddle_operator_tpu_torch.infer.batcher import ContinuousBatcher
from paddle_operator_tpu_torch.infer.resilience import (
    RetriableError,
    RingResilience,
)
from paddle_operator_tpu_torch.models.llama import make_model

PROMPTS = [np.random.default_rng(30 + i).integers(0, 256, n).tolist()
           for i, n in enumerate((45, 6, 20, 33))]
NEW = 12


@pytest.mark.cuda
class TestDisaggUnderGraphs:
    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")

    def _ref(self, model, cfg, prompts):
        with torch.inference_mode():
            return [D.generate(model, cfg, torch.tensor(
                [p], dtype=torch.int32, device="cuda"), max_new_tokens=NEW,
                max_len=128)[0].tolist() for p in prompts]

    @pytest.mark.parametrize("kv_quant", ["none", "int8"])
    def test_engine_runs_during_a_heal_capture(self, kv_quant):
        model, cfg = make_model("tiny", device="cuda", dtype=torch.float32)
        b = ContinuousBatcher(
            model, cfg, slots=2, max_len=128, chunk_tokens=4, paged=True,
            block_size=16, prefill_mode="disagg", prefill_lanes=2,
            prefill_chunk=8, kv_quant=kv_quant, prewarm=True,
            resilience=RingResilience(watchdog=False, max_restarts=3,
                                      backoff_base_s=0.05))
        ex = b.executor
        pe = ex.prefill_exec
        go = threading.Event()
        during = []
        real_slice, real_program = pe._slice_prog, ex._program

        def slice_(*a, **k):
            # a job's slices wait for the ring's capture to start, then
            # launch on the engine's stream while it runs
            go.wait(30)
            during.append(torch.cuda.is_current_stream_capturing())
            return real_slice(*a, **k)

        def program(n):
            if torch.cuda.is_current_stream_capturing() and not go.is_set():
                go.set()
                threading.Event().wait(0.05)
            return real_program(n)

        try:
            assert b.prewarmed.wait(300) and not ex.needs_capture
            want = self._ref(model, cfg, PROMPTS)
            if kv_quant == "none":
                assert b.submit(PROMPTS[1], max_new_tokens=NEW).result(
                    timeout=120) == want[1]
            pe._slice_prog = slice_
            ex._program = program
            inj = CH.ChaosInjector("").install(b)
            resident = b.submit(PROMPTS[1], max_new_tokens=100)
            while not any(r is not None and i not in b._disagg_waiting
                          for i, r in enumerate(b.lane)):
                threading.Event().wait(0.002)
            away = b.submit(PROMPTS[0], max_new_tokens=NEW)   # 3 slices
            while not b._disagg_waiting:
                threading.Event().wait(0.002)
            nxt = inj.dispatches
            inj.events[nxt] = [CH.ChaosEvent("dispatch_fail", nxt)]
            for h in (resident, away):
                with pytest.raises(RetriableError):
                    h.result(timeout=120)
            assert go.wait(60), "no capture after the heal"
            got = [h.result(timeout=120) for h in [
                b.submit(p, max_new_tokens=NEW) for p in PROMPTS]]
            assert during and not any(during)    # the engine's own stream
            assert b.stats["watchdog_restarts"] == 1
            assert ex._graphs is not None
            if kv_quant == "none":
                assert got == want
            assert all(len(g) == len(p) + NEW and g[:len(p)] == p
                       for g, p in zip(got, PROMPTS))
            b.pool.check_invariant()
            # a swap to the same weights: quiesced handoffs, the engine
            # re-stamped, graphs captured again, the same streams
            b.swap_weights(model)
            assert pe.params is model
            assert [h.result(timeout=120) for h in [
                b.submit(p, max_new_tokens=NEW) for p in PROMPTS]] == got
            assert not pe._held
        finally:
            go.set()
            b.close()
