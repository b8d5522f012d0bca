"""The torch package's continuous serving ring (paddle_operator_tpu_torch/
infer/scheduler.py ``ContinuousBatcher`` over infer/executor.py) held
against the JAX package: the cases of tests/test_paged.py
TestPagedRingParity, each for the paged ring (block pool + radix prefix
cache) and for the contiguous ring (its parity oracle), with greedy
tokens equal to JAX ``decode.generate`` on the same converted ``tiny``
params — which the JAX suite pins equal to the JAX ring.  Also
deadlines (504-style partials), drain, EOS inside a chunk, self-healing
after a raising dispatch, and the ``serving_status()`` key set.
"""

import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_operator_tpu.infer import decode as JD
from paddle_operator_tpu.models.llama import make_model as jax_make_model
from paddle_operator_tpu_torch.convert import params_from_jax
from paddle_operator_tpu_torch.infer.batcher import ContinuousBatcher
from paddle_operator_tpu_torch.infer.paged import NoFreeBlocks
from paddle_operator_tpu_torch.infer.resilience import (
    RetriableError,
    RingResilience,
    ShuttingDown,
)
from paddle_operator_tpu_torch.models.llama import make_model

MAX_LEN = 64
BS = 8
RINGS = [pytest.param(True, id="paged"), pytest.param(False, id="contig")]


@pytest.fixture(scope="module")
def setup():
    jmodel, jcfg = jax_make_model("tiny", dtype=jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, 8), jnp.int32))["params"]
    model, cfg = make_model("tiny", device="cpu", dtype=torch.float32)
    model.load_state_dict(params_from_jax(jax.device_get(jparams)))
    refs = {}

    def ref(prompt, new):
        """JAX decode.generate, memoized per (prompt, budget)."""
        key = (tuple(int(t) for t in prompt), new)
        if key not in refs:
            refs[key] = np.asarray(JD.generate(
                jparams, jcfg, jnp.asarray([prompt], jnp.int32),
                max_new_tokens=new, max_len=MAX_LEN)[0]).tolist()
        return refs[key]

    return model, cfg, ref, jparams, jcfg


def _prompt(s, seed):
    return np.random.default_rng(seed).integers(0, 256, s).astype(
        np.int32).tolist()


def _batcher(model, cfg, paged, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("chunk_tokens", 4)
    kw.setdefault("prefill_buckets", (8, 16, 32, MAX_LEN))
    if paged:
        kw.setdefault("block_size", BS)
    return ContinuousBatcher(model, cfg, paged=paged, **kw)


def _paced(b, secs=0.05):
    orig = b._step

    def paced(*a):
        time.sleep(secs)
        return orig(*a)

    b._step = paced


@pytest.mark.parametrize("paged", RINGS)
class TestRingMatchesGenerate:
    def test_cold_admissions_more_requests_than_slots(self, setup, paged):
        model, cfg, ref, _, _ = setup
        b = _batcher(model, cfg, paged)
        try:
            lens, new = [5, 11, 8, 13, 24], 9
            prompts = [_prompt(n, 10 + i) for i, n in enumerate(lens)]
            reqs = [b.submit(p, max_new_tokens=new) for p in prompts]
            outs = [r.result(timeout=120) for r in reqs]
            for p, out in zip(prompts, outs):
                assert out == ref(p, new)
            assert b.stats["admitted"] == 5 and b.stats["evicted"] == 5
            assert b.stats["max_active"] == 2
            if paged:
                b.pool.check_invariant()
        finally:
            b.close()

    def test_prefix_hit_prefills_only_the_suffix(self, setup, paged):
        model, cfg, ref, _, _ = setup
        b = _batcher(model, cfg, paged)
        try:
            new = 6
            leader = _prompt(24, 40)                   # 3 full blocks
            want = ref(leader, new)
            assert b.submit(leader, max_new_tokens=new).result(
                timeout=120) == want
            calls0 = b.stats["prefill_calls"]
            toks0 = b.stats["prefill_tokens"]
            # full hit: ONE 1-token forward; CoW keeps the cache intact
            assert b.submit(leader, max_new_tokens=new).result(
                timeout=120) == want
            assert b.stats["prefill_calls"] - calls0 == 1
            assert b.stats["prefill_tokens"] - toks0 == (1 if paged
                                                         else 24)
            # divergent suffix behind a shared 16-token prefix
            toks1 = b.stats["prefill_tokens"]
            div = leader[:16] + _prompt(9, 41)
            assert b.submit(div, max_new_tokens=new).result(
                timeout=120) == ref(div, new)
            assert b.stats["prefill_tokens"] - toks1 == (9 if paged else 25)
            # the leader's cached blocks survived both
            assert b.submit(leader, max_new_tokens=new).result(
                timeout=120) == want
            if paged:
                assert b.stats["cow_copies"] >= 1
                assert b.pool.hit_rate() > 0
                b.pool.check_invariant()
            else:
                assert b.pool is None and b.stats["cow_copies"] == 0
        finally:
            b.close()

    def test_cancel_returns_lane_and_blocks(self, setup, paged):
        model, cfg, ref, _, _ = setup
        b = _batcher(model, cfg, paged, slots=1)
        _paced(b)
        try:
            free0 = (b.pool.blocks_free() + b.pool.blocks_cached()
                     if paged else None)
            p = _prompt(24, 50)
            h = b.submit(p, max_new_tokens=30, stream=True)
            first = next(h.stream(timeout=60))
            h.cancel()
            out = h.result(timeout=60)
            assert out[:len(p) + 1] == ref(p, 30)[:len(p) + 1]
            assert out[len(p)] == first and len(out) < len(p) + 30
            deadline = time.monotonic() + 30
            while b.lane[0] is not None or (
                    paged and b.pool.blocks_free()
                    + b.pool.blocks_cached() < free0):
                assert time.monotonic() < deadline, "lane never returned"
                time.sleep(0.02)
            if paged:
                b.pool.check_invariant()
            # the freed lane serves the next request exactly
            p2 = _prompt(8, 51)
            assert b.submit(p2, max_new_tokens=4).result(
                timeout=60) == ref(p2, 4)
        finally:
            b.close()

    def test_undersized_pool_starves_one_lane_not_the_ring(self, setup,
                                                           paged):
        model, cfg, ref, _, _ = setup
        # paged: 8 blocks of 8 = one worst-case lane, so two growing
        # lanes collide; the contiguous ring reserves every lane whole
        kw = {"num_blocks": 8, "prefix_cache": False} if paged else {}
        b = _batcher(model, cfg, paged, **kw)
        try:
            p1, p2 = _prompt(24, 60), _prompt(24, 61)
            r1 = b.submit(p1, max_new_tokens=30)
            r2 = b.submit(p2, max_new_tokens=30)
            results, errors = [], []
            for p, r in ((p1, r1), (p2, r2)):
                try:
                    results.append((p, r.result(timeout=120)))
                except NoFreeBlocks as e:
                    errors.append(e)
            assert len(errors) == (1 if paged else 0)
            for p, out in results:
                assert out == ref(p, 30)
            p3 = _prompt(8, 62)
            assert b.submit(p3, max_new_tokens=4).result(
                timeout=60) == ref(p3, 4)
            if paged:
                b.pool.check_invariant()
        finally:
            b.close()

    def test_sampling_per_seed_independent_of_co_residents(self, setup,
                                                           paged):
        model, cfg, _, _, _ = setup
        b = _batcher(model, cfg, paged)
        try:
            p = _prompt(6, 4)
            kw = dict(max_new_tokens=8, temperature=0.8)
            a = b.submit(p, seed=5, **kw).result(timeout=60)
            # same seed beside a co-resident lane, admitted second
            other = b.submit(_prompt(9, 5), seed=1, **kw)
            c = b.submit(p, seed=5, **kw)
            assert c.result(timeout=60) == a
            other.result(timeout=60)
            d = b.submit(p, seed=6, **kw).result(timeout=60)
            assert a != d
            assert all(0 <= t < cfg.vocab_size for t in a)
        finally:
            b.close()


def test_sampled_streams_equal_across_rings(setup):
    model, cfg, _, _, _ = setup
    outs = []
    for paged in (True, False):
        b = _batcher(model, cfg, paged)
        try:
            outs.append(b.submit(_prompt(11, 6), max_new_tokens=7,
                                 temperature=1.0, seed=9).result(timeout=60))
        finally:
            b.close()
    assert outs[0] == outs[1]


@pytest.mark.parametrize("paged", RINGS)
class TestLifecycle:
    def test_eos_inside_a_chunk(self, setup, paged):
        model, cfg, ref, _, _ = setup
        p = _prompt(7, 70)
        full = ref(p, 9)
        eos = full[len(p) + 2]           # the third token: mid-chunk
        first = full[len(p):].index(eos)
        b = _batcher(model, cfg, paged)
        try:
            out = b.submit(p, max_new_tokens=9, eos_token=eos).result(
                timeout=60)
            assert out == full[:len(p) + first + 1]
        finally:
            b.close()

    def test_deadline_gives_a_partial(self, setup, paged):
        model, cfg, ref, _, _ = setup
        b = _batcher(model, cfg, paged, slots=1)
        _paced(b, 0.1)
        try:
            p = _prompt(8, 71)
            h = b.submit(p, max_new_tokens=40, deadline_s=0.25)
            out = h.result(timeout=60)
            assert h.deadline_exceeded
            assert len(p) < len(out) < len(p) + 40
            assert out == ref(p, 40)[:len(out)]
            assert b.stats["deadline_exceeded"] == 1
            # queued past its deadline: prompt only
            blocker = b.submit(_prompt(8, 72), max_new_tokens=20)
            q = b.submit(p, max_new_tokens=4, deadline_s=0.05)
            assert q.result(timeout=60) == p and q.deadline_exceeded
            blocker.result(timeout=60)
            with pytest.raises(ValueError, match="deadline_s"):
                b.submit(p, max_new_tokens=4, deadline_s=0)
        finally:
            b.close()

    def test_drain_finishes_residents_and_sheds_the_queue(self, setup,
                                                          paged):
        model, cfg, ref, _, _ = setup
        b = _batcher(model, cfg, paged, slots=1)
        _paced(b, 0.02)
        p = _prompt(8, 73)
        resident = b.submit(p, max_new_tokens=12)
        queued = b.submit(_prompt(8, 74), max_new_tokens=12)
        deadline = time.monotonic() + 30
        while b.lane[0] is not resident:
            assert time.monotonic() < deadline
            time.sleep(0.01)
        b.drain(budget_s=30)
        assert resident.result(timeout=5) == ref(p, 12)
        with pytest.raises(ShuttingDown):
            queued.result(timeout=5)
        with pytest.raises(ShuttingDown):
            b.submit(p, max_new_tokens=2)
        assert not b.accepting
        if paged:
            b.pool.check_invariant()

    def test_raising_dispatch_heals_the_ring(self, setup, paged):
        model, cfg, ref, _, _ = setup
        res = RingResilience(watchdog=False, backoff_base_s=0.01)
        b = _batcher(model, cfg, paged, resilience=res)
        orig, calls = b._step, []

        def faulty(*a):
            calls.append(1)
            if len(calls) == 2:
                raise RuntimeError("CUDA error: an illegal memory access")
            return orig(*a)

        b._step = faulty
        try:
            p = _prompt(8, 75)
            with pytest.raises(RetriableError, match="illegal"):
                b.submit(p, max_new_tokens=20).result(timeout=60)
            assert b.stats["watchdog_restarts"] == 1 and b.healthy
            # the rebuilt ring serves exactly
            assert b.submit(p, max_new_tokens=6).result(
                timeout=60) == ref(p, 6)
            if paged:
                b.pool.check_invariant()
        finally:
            b.close()


class TestSubmit:
    def test_validation_names_the_request(self, setup):
        model, cfg, _, _, _ = setup
        b = _batcher(model, cfg, True)
        try:
            with pytest.raises(ValueError, match=r"\[request r1\]"):
                b.submit([1] * 60, max_new_tokens=9, request_id="r1")
            with pytest.raises(ValueError, match="empty"):
                b.submit([], max_new_tokens=2)
            with pytest.raises(ValueError, match="priority"):
                b.submit([1, 2], max_new_tokens=2, priority=5)
            with pytest.raises(ValueError, match="vocab|token ids"):
                b.submit([1, 999], max_new_tokens=2)
            # adapters are served (tests/test_torch_adapters.py); a ring
            # built without a registry refuses one with JAX's message
            with pytest.raises(ValueError, match="no adapter registry"):
                b.submit([1, 2], max_new_tokens=2, adapter="acme")
        finally:
            b.close()

    @pytest.mark.parametrize("kw", [{"mesh": "tp2"}, {"kv_quant": "int4"},
                                    {"prefill_mode": "disagg",
                                     "paged": True, "mesh": "tp2"},
                                    {"megastep": 4, "mesh": "tp2"},
                                    {"adapters": "acme", "mesh": "tp2"},
                                    {"trace": True, "mesh": "tp2"}])
    def test_unported_options_refused(self, setup, kw):
        model, cfg, _, _, _ = setup
        # kv_quant="int8" is ported (tests/test_torch_kvquant.py); a
        # mode the JAX package lacks too is refused by name.  The
        # megastep is ported (tests/test_torch_megastep.py): beside an
        # unported option it is that option that is refused.  Chunked
        # prefill is ported (tests/test_torch_chunked_prefill.py), and
        # so is disaggregated prefill (tests/test_torch_disagg.py):
        # beside an unported option it is that option that is refused.
        # Speculative decoding is ported (tests/test_torch_spec_ring.py):
        # tensor-parallel serving (mesh) stands where spec_k stood.  LoRA
        # adapters are ported (tests/test_torch_adapters.py), and so is
        # span tracing (tests/test_torch_tracing.py): beside an unported
        # option it is that option that is refused
        # tensor-parallel serving is ported too
        # (tests/test_torch_serving_tp_rings.py): a mesh that is not a
        # serving DeviceMesh is refused
        exc, match = ((ValueError, "kv_quant") if "kv_quant" in kw
                      else (TypeError, "DeviceMesh"))
        with pytest.raises(exc, match=match) as e:
            ContinuousBatcher(model, cfg, slots=1, max_len=MAX_LEN,
                              **{"paged": True, "block_size": BS, **kw})
        assert "megastep" not in str(e.value)


def test_serving_status_keys_equal_jax_ring(setup):
    from paddle_operator_tpu.infer.batcher import (
        ContinuousBatcher as JaxBatcher,
    )

    model, cfg, _, jparams, jcfg = setup
    jb = JaxBatcher(jparams, jcfg, slots=2, max_len=MAX_LEN, chunk_tokens=4,
                    prefill_buckets=(8, 16, 32, MAX_LEN), paged=True,
                    block_size=BS)
    b = _batcher(model, cfg, True)
    try:
        p = _prompt(9, 80)
        jb.submit(p, max_new_tokens=3).result(timeout=120)
        b.submit(p, max_new_tokens=3).result(timeout=60)
        want, got = jb.serving_status(), b.serving_status()
        assert set(got) == set(want)
        assert set(got["latencyHist"]) == set(want["latencyHist"])
        for key in ("kvBlocksFree", "kvBlocksHwm", "prefixHitRate",
                    "tokensTotal", "activeLanes", "priorityQueueDepth",
                    "prefillMode", "kvQuantMode", "megastepN"):
            assert got[key] == want[key], key
    finally:
        b.close()
        jb.close()
