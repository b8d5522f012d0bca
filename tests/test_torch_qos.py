"""The torch package's preemptive lane spill held against the JAX package
(tests/test_qos.py TestPriorityScheduling, tests/test_hostcache.py
TestSpillRestore), on converted ``tiny`` f32 params (the JAX
``PRNGKey(0)`` tree) and prompts seeded from numpy:

- ``PreemptionBudget``: the same ``ok()``/``spend()`` answers as JAX's
  under one fake clock;
- ``RingExecutor.spill_lane``/``restore_lane`` on the bf16 and int8
  pools: the resumed stream equals the uninterrupted one bit for bit,
  and the spill equals the JAX executor's (pos, tok, n_blocks exactly;
  K/V within 1e-5; int8 codes within one step and scales within rtol
  1e-5, the int8 pool's documented difference); a restore into a
  mapped slot raises;
- through ``ContinuousBatcher`` (the ring throttled by wrapping
  ``executor.replay`` with a gate): class-0 requests jump the queue
  with preemption off, preempt a full paged ring with it on, and the
  victim resumes bit-identically (greedy equal to JAX
  ``decode.generate``; sampled equal to its unpreempted port run; under
  ``megastep=4``; with the int8 frontier mid-block); a budget of 0
  disables spill; a parked lane's deadline, cancel, drain and heal; the
  contiguous ring never preempts; ``serving_status()`` and the
  preemption gauge; one HTTP case against the JAX replica;
- on the card (``cuda``-marked, skipped here): restores under CUDA graph
  replay keep the captured addresses and resume bit-identically.  The
  JAX package is imported only inside the fixtures and tests that need
  it, so the card's machine (JAX, no flax) can run those tests.
"""

import dataclasses
import json
import threading
import time
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_operator_tpu_torch.convert import params_from_jax
from paddle_operator_tpu_torch.infer import executor as X
from paddle_operator_tpu_torch.infer import qos as TQ
from paddle_operator_tpu_torch.infer import serve as S
from paddle_operator_tpu_torch.infer.batcher import ContinuousBatcher
from paddle_operator_tpu_torch.infer.resilience import (
    RetriableError,
    RingResilience,
)
from paddle_operator_tpu_torch.models.llama import make_model

MAX_LEN = 64
BS = 8
CH = 4
TOL = 1e-5        # f32 rows of the same inputs, summation order aside
QUANTS = ["none", "int8"]


@pytest.fixture(scope="module")
def setup():
    from paddle_operator_tpu.infer import decode as JD
    from paddle_operator_tpu.infer.batcher import (
        ContinuousBatcher as JaxBatcher,
    )
    from paddle_operator_tpu.models.llama import make_model as jmake

    jmodel, jcfg = jmake("tiny", dtype=jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, 8), jnp.int32))["params"]
    model, cfg = make_model("tiny", device="cpu", dtype=torch.float32)
    model.load_state_dict(params_from_jax(jax.device_get(jparams)))
    refs = {}

    def ref(prompt, new, kv_quant="none"):
        """The JAX package's greedy tokens, memoized: ``decode.generate``
        for the exact pool, the JAX int8 ring for the int8 pool (int8
        tokens need not equal the exact pool's)."""
        key = (tuple(prompt), new, kv_quant)
        if key not in refs:
            if kv_quant == "none":
                refs[key] = np.asarray(JD.generate(
                    jparams, jcfg, jnp.asarray([prompt], jnp.int32),
                    max_new_tokens=new, max_len=MAX_LEN)[0]).tolist()
            else:
                b = JaxBatcher(jparams, jcfg, **_ring_kw(
                    kv_quant=kv_quant))
                try:
                    refs[key] = b.submit(prompt, max_new_tokens=new).result(
                        timeout=300)
                finally:
                    b.close()
        return refs[key]

    return model, cfg, ref, jparams, jcfg


def _ring_kw(**kw):
    kw.setdefault("slots", 1)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("chunk_tokens", CH)
    kw.setdefault("prefill_buckets", (16, MAX_LEN))
    kw.setdefault("paged", True)
    kw.setdefault("block_size", BS)
    kw.setdefault("num_blocks", 16)
    return kw


def _batcher(model, cfg, **kw):
    return ContinuousBatcher(model, cfg, **_ring_kw(**kw))


def _prompt(s, seed):
    return np.random.default_rng(seed).integers(0, 256, s).astype(
        np.int32).tolist()


def _throttle(b, delay=0.03):
    """Slow every ring dispatch and return a pause gate: a test clears
    the gate to freeze the ring at its next dispatch, submits against
    the frozen resident state, then sets it to resume — a deterministic
    preemption at any machine speed (tests/test_qos.py ``_throttle``,
    on the port's dispatch seam)."""
    real = b.executor.replay
    gate = threading.Event()
    gate.set()

    def slow(plan):
        gate.wait(timeout=120)
        time.sleep(delay)
        return real(plan)

    b.executor.replay = slow
    return gate


def _wait(pred, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.001)


def _completion_times(handles):
    times = [None] * len(handles)

    def watch(i, h):
        h.done.wait(timeout=300)
        times[i] = time.monotonic()

    ts = [threading.Thread(target=watch, args=(i, h))
          for i, h in enumerate(handles)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=300)
    assert all(x is not None for x in times)
    return times


def _check_every_spill_and_restore(b):
    """Hold the pool's invariant after every spill (the victim retired)
    and every restore; returns the list of failures (read by the test
    thread)."""
    failures = []
    for name in ("_preempt", "_try_restore"):
        real = getattr(b, name)

        def spy(*a, _real=real, _name=name):
            out = _real(*a)
            try:
                b.pool.check_invariant()
            except AssertionError as e:
                failures.append(f"{_name}: {e}")
            return out

        setattr(b, name, spy)
    return failures


def _preempt_once(b, victim_prompt, new, *, p0_new=4, delay=0.03,
                  temperature=0.0, seed=0, deadline_s=None, p0_seed=5):
    """Warm the ring, then run the victim (class 1), freeze the ring
    while it is resident, submit a class-0 request and resume.  Returns
    (victim handle, class-0 handle)."""
    b.submit(victim_prompt, max_new_tokens=2).result(timeout=300)
    gate = _throttle(b, delay)
    n0 = b.stats["admitted"]
    h_long = b.submit(victim_prompt, max_new_tokens=new,
                      temperature=temperature, seed=seed,
                      deadline_s=deadline_s)
    _wait(lambda: b.stats["admitted"] > n0, "the victim was never admitted")
    gate.clear()                # freeze: the class-0 request finds a full ring
    h0 = b.submit(_prompt(7, p0_seed), max_new_tokens=p0_new, priority=0)
    gate.set()
    return h_long, h0


# ---------------------------------------------------------------------------
# Units: the budget
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("budget,window,seed", [(0, 10.0, 0), (3, 2.5, 1),
                                                (16, 10.0, 2)])
def test_preemption_budget_equals_jax(budget, window, seed):
    """One seeded sequence of clock steps, ok() and spend() calls under
    one fake clock: the same answers."""
    from paddle_operator_tpu.infer import qos as JQ

    now = [1000.0]
    clock = lambda: now[0]            # noqa: E731
    jb = JQ.PreemptionBudget(budget, window, clock=clock)
    tb = TQ.PreemptionBudget(budget, window, clock=clock)
    rng = np.random.default_rng(seed)
    log = []
    for _ in range(300):
        op = rng.integers(0, 3)
        if op == 0:
            now[0] += float(rng.uniform(0, window / 3))
        elif op == 1:
            log.append((jb.ok(), tb.ok()))
        else:
            jb.spend()
            tb.spend()
    assert all(a == b for a, b in log)
    assert any(a for a, _ in log) == (budget > 0)


def test_qos_defaults_equal_jax_policy():
    from paddle_operator_tpu.infer import qos as JQ

    j, t = JQ.QoSConfig(), TQ.QoSConfig()
    assert (t.priorities, t.preempt, t.max_preempts_per_request,
            t.preempt_budget, t.preempt_window_s) == \
        (j.priorities, j.preempt, j.max_preempts_per_request,
         j.preempt_budget, j.preempt_window_s) == (2, True, 2, 16, 10.0)


# ---------------------------------------------------------------------------
# The executor primitive: spill_lane / restore_lane
# ---------------------------------------------------------------------------


class TestSpillRestore:
    def _executor(self, model, cfg, kv_quant):
        return X.RingExecutor(model, cfg, slots=2, max_len=MAX_LEN,
                              chunk_tokens=CH, prefill_buckets=(16, MAX_LEN),
                              paged=True, block_size=BS, kv_quant=kv_quant)

    def _admit(self, ex, slot, p, temp=0.0, seed=0):
        ex.pool.admit(slot, p)
        row = X.to_device(ex.pool.table[slot], ex.device, torch.int32)
        first = ex.inserts[16](ex.params, ex.cache, row, ex.tok, ex.temp,
                               ex.seeds, torch.tensor([p], dtype=torch.int32),
                               len(p), slot, temp, seed)
        ex.pool.publish(slot, p)
        return int(first)

    def _chunk(self, ex, slot, pos):
        ex.pool.ensure(slot, pos + CH)
        toks, _ = ex.run(X.ExecPlan(1, [i == slot for i in range(2)],
                                    table=ex.pool.table))
        return [int(t) for t in toks[:, slot]]

    @pytest.mark.parametrize("kv_quant", QUANTS)
    @pytest.mark.parametrize("temp", [0.0, 0.8], ids=["greedy", "sampled"])
    def test_spill_restore_bit_identical(self, setup, kv_quant, temp):
        """Spill after one chunk, serve another lane, restore into the
        OTHER slot: the continuation equals the uninterrupted stream."""
        model, cfg, _, _, _ = setup
        ex = self._executor(model, cfg, kv_quant)
        p = _prompt(13, 3)
        with torch.inference_mode():
            ref = [self._admit(ex, 0, p, temp, 11)]
            pos = len(p)
            for _ in range(3):
                ref += self._chunk(ex, 0, pos)
                pos += CH
            ex.reset_state()
            got = [self._admit(ex, 0, p, temp, 11)]
            pos = len(p)
            got += self._chunk(ex, 0, pos)
            pos += CH
            spill = ex.spill_lane(0)
            assert spill["pos"] == pos and spill["n_blocks"] == 3
            ex.pool.retire(0)
            ex.pool.check_invariant()
            q = _prompt(11, 9)
            self._admit(ex, 0, q, 0.0, 9)     # other traffic in the slot
            self._chunk(ex, 0, len(q))
            before = ex._state_ptrs()
            ex.restore_lane(1, spill)
            assert ex._state_ptrs() == before
            ex.pool.check_invariant()
            got += self._chunk(ex, 1, pos)
            pos += CH
            got += self._chunk(ex, 1, pos)
        assert got == ref, f"spilled lane resumed differently ({kv_quant})"

    @pytest.mark.parametrize("kv_quant", QUANTS)
    def test_spill_equals_jax(self, setup, kv_quant):
        """The port's spill of a lane against the JAX executor's spill of
        the same lane at the same position: same keys (``seed`` for
        JAX's ``key``) and layouts, pos/tok/n_blocks exactly, bytes
        within the tolerances of the two pools."""
        from paddle_operator_tpu.infer.executor import (
            RingExecutor as JaxExecutor,
        )

        model, cfg, _, jparams, jcfg = setup
        jex = JaxExecutor(jparams, jcfg, slots=2, max_len=MAX_LEN,
                          chunk_tokens=CH, prefill_buckets=(16, MAX_LEN),
                          paged=True, block_size=BS, kv_quant=kv_quant)
        p = _prompt(13, 3)
        n = len(p)
        jex.pool.admit(0, p)
        padded = np.zeros((1, 16), np.int32)
        padded[0, :n] = p
        jex.cache, jex.tok, jex.temp, jex.keys, _ = jex.inserts[16](
            jex.params, jex.cache, jnp.asarray(jex.pool.table[0]), jex.tok,
            jex.temp, jex.keys, jnp.asarray(padded), n, 0, 0.0, 0)
        jex.pool.ensure(0, n + CH)
        jex.cache, jex.tok, _ = jex.step(
            jex.params, jex.cache, jnp.asarray(jex.pool.table), jex.tok,
            jex.temp, jex.keys, jnp.asarray([True, False]))
        want = jex.spill_lane(0)

        ex = self._executor(model, cfg, kv_quant)
        with torch.inference_mode():
            self._admit(ex, 0, p)
            self._chunk(ex, 0, n)
            got = ex.spill_lane(0)
        assert set(got) == set(want) - {"key"} | {"seed"}
        for key in ("n_blocks", "pos", "tok"):
            assert got[key] == want[key], key
        assert got["temp"] == want["temp"] == 0.0
        for key in ("k", "v", "kt", "vt") if kv_quant == "int8" \
                else ("k", "v"):
            if kv_quant == "int8" and key in ("k", "v"):
                # int8 codes: an f32 last bit may move a value across a
                # code midpoint (ROADMAP.md Queue C, known differences)
                d = got[key].numpy().astype(np.int32) \
                    - np.asarray(want[key]).astype(np.int32)
                assert got[key].shape == want[key].shape
                assert np.abs(d).max() <= 1, key
            else:
                np.testing.assert_allclose(got[key].numpy(),
                                           np.asarray(want[key]),
                                           atol=TOL, err_msg=key)
        if kv_quant == "int8":
            # the scales of the blocks committed below the frontier; the
            # frontier block was never committed (its rows are read from
            # the staging tail), so its scale is each pool's initial
            # value, 1.0 here and 0.0 in the JAX pool
            done = got["pos"] // BS
            assert got["ks"].shape == want["ks"].shape
            for key in ("ks", "vs"):
                np.testing.assert_allclose(got[key].numpy()[:, :done],
                                           np.asarray(want[key])[:, :done],
                                           rtol=1e-5, err_msg=key)

    @pytest.mark.parametrize("kv_quant", QUANTS)
    def test_dispatch_promotions_copies_blocks_verbatim(self, setup,
                                                        kv_quant):
        """Host payloads of one block each land in their reserved pool
        blocks as they are — codes and scales verbatim under int8 — and
        the pool tensors keep their addresses."""
        model, cfg, _, _, _ = setup
        ex = self._executor(model, cfg, kv_quant)
        with torch.inference_mode():
            self._admit(ex, 0, _prompt(13, 3))
            self._chunk(ex, 0, 13)
            spill = ex.spill_lane(0)
            ex.pool.retire(0)
            dst = [ex.pool._alloc_one() for _ in range(spill["n_blocks"])]
            keys = ("k", "v", "ks", "vs") if kv_quant == "int8" \
                else ("k", "v")
            promotes = [(blk, {key: spill[key][:, j:j + 1] for key in keys},
                         None) for j, blk in enumerate(dst)]
            before = ex._state_ptrs()
            ex.dispatch_promotions(promotes[::-1])      # any order
            assert ex._state_ptrs() == before
            for key in keys:
                assert torch.equal(ex.cache[key][:, dst], spill[key]), key

    def test_restore_requires_empty_slot(self, setup):
        model, cfg, _, _, _ = setup
        ex = self._executor(model, cfg, "none")
        with torch.inference_mode():
            self._admit(ex, 0, _prompt(13, 3))
            spill = ex.spill_lane(0)
            with pytest.raises(AssertionError, match="still holds blocks"):
                ex.restore_lane(0, spill)        # lane not retired yet

    def test_restore_rolls_back_on_no_free_blocks(self, setup):
        """A pool that cannot map the lane raises NoFreeBlocks and leaves
        the ring's state as it was once the slot is retired."""
        from paddle_operator_tpu_torch.infer.paged import NoFreeBlocks

        model, cfg, _, _, _ = setup
        ex = X.RingExecutor(model, cfg, slots=2, max_len=MAX_LEN,
                            chunk_tokens=CH, prefill_buckets=(16, MAX_LEN),
                            paged=True, block_size=BS, num_blocks=8,
                            prefix_cache=False)
        with torch.inference_mode():
            self._admit(ex, 0, _prompt(13, 3))
            self._chunk(ex, 0, 13)
            spill = ex.spill_lane(0)
            ex.pool.retire(0)
            self._admit(ex, 0, _prompt(48, 4))     # 6 of the 8 blocks
            with pytest.raises(NoFreeBlocks):
                ex.restore_lane(1, spill)          # needs 3
            ex.pool.retire(1)
            ex.pool.check_invariant()
            assert ex.pool.blocks_free() == 2


# ---------------------------------------------------------------------------
# The scheduler: priority admission and preemption on the live ring
# ---------------------------------------------------------------------------


class TestPriorityScheduling:
    def test_priority_zero_jumps_the_queue(self, setup):
        """slots=1, preemption OFF: the class-0 request still overtakes
        an earlier-queued class-1 one at admission."""
        model, cfg, _, _, _ = setup
        b = _batcher(model, cfg, qos=TQ.QoSConfig(preempt=False))
        try:
            p = _prompt(9, 3)
            b.submit(p, max_new_tokens=8).result(timeout=300)
            gate = _throttle(b)
            n0 = b.stats["admitted"]
            h_a = b.submit(p, max_new_tokens=12)
            _wait(lambda: b.stats["admitted"] > n0, "no admission")
            gate.clear()
            h_b = b.submit(_prompt(7, 4), max_new_tokens=4)
            h_c = b.submit(_prompt(7, 5), max_new_tokens=4, priority=0)
            gate.set()
            times = _completion_times([h_a, h_b, h_c])
            assert times[0] < times[2] < times[1]
            assert b.stats["preempted_lanes"] == 0
        finally:
            b.close()

    @pytest.mark.parametrize("kv_quant", QUANTS)
    def test_preemption_resumes_bit_identical(self, setup, kv_quant):
        """A class-0 arrival preempts the resident class-1 lane (spill,
        retire, re-admit), finishes while the victim is parked, and the
        victim's stream equals its unpreempted run and the JAX package's
        tokens; the pool's invariant holds after every spill and
        restore."""
        model, cfg, ref, _, _ = setup
        p = _prompt(9, 3)
        b = _batcher(model, cfg, kv_quant=kv_quant)
        try:
            want = b.submit(p, max_new_tokens=40).result(timeout=300)
            failures = _check_every_spill_and_restore(b)
            h_long, h0 = _preempt_once(b, p, 40)
            times = _completion_times([h_long, h0])
            assert h_long.result(timeout=5) == want == ref(p, 40, kv_quant)
            assert times[1] < times[0], "class 0 waited for the class-1 lane"
            assert b.stats["preempted_lanes"] == b.stats["restored_lanes"] \
                >= 1
            assert h_long.preempts == b.stats["preempted_lanes"]
            assert not failures, failures
            b.pool.check_invariant()
            st = b.serving_status()
            assert st["preemptedLanes"] == b.stats["preempted_lanes"]
            assert st["parkedLanes"] == 0
            assert st["kvBlocksFree"] + b.pool.blocks_cached() == 16
            kinds = [e["kind"] for e in b.flightrec.events()]
            assert "preempt" in kinds
        finally:
            b.close()

    def test_sampled_victim_resumes_same_tokens(self, setup):
        """Temperature 0.8 with a fixed seed: the preempted victim draws
        the tokens of its unpreempted port run (the draw is a function of
        (seed, position), whichever slot the lane resumes in)."""
        model, cfg, _, _, _ = setup
        p = _prompt(9, 3)
        b = _batcher(model, cfg, slots=2)
        try:
            # the reference and the victim both admit through the prefix
            # hit of the warm-up's blocks
            b.submit(p, max_new_tokens=2).result(timeout=300)
            want = b.submit(p, max_new_tokens=32, temperature=0.8,
                            seed=1234).result(timeout=300)
            # two class-1 lanes fill the ring; the victim is the shorter
            gate = _throttle(b)
            n0 = b.stats["admitted"]
            h_other = b.submit(_prompt(20, 8), max_new_tokens=24)
            h_long = b.submit(p, max_new_tokens=32, temperature=0.8,
                              seed=1234)
            _wait(lambda: b.stats["admitted"] >= n0 + 2, "no admission")
            gate.clear()
            h0 = b.submit(_prompt(7, 5), max_new_tokens=8, priority=0)
            gate.set()
            h0.result(timeout=300)
            h_other.result(timeout=300)
            assert h_long.result(timeout=300) == want
            assert h_long.preempts == 1 and b.stats["restored_lanes"] == 1
            b.pool.check_invariant()
        finally:
            b.close()

    @pytest.mark.parametrize("kv_quant", QUANTS)
    def test_preemption_under_megastep(self, setup, kv_quant):
        """megastep=4: the spill lands at a megastep boundary and the
        victim's stream equals its unpreempted run."""
        model, cfg, ref, _, _ = setup
        p = _prompt(9, 3)
        b = _batcher(model, cfg, megastep=4, kv_quant=kv_quant)
        try:
            want = b.submit(p, max_new_tokens=40).result(timeout=300)
            failures = _check_every_spill_and_restore(b)
            h_long, h0 = _preempt_once(b, p, 40, delay=0.05)
            h0.result(timeout=300)
            assert h_long.result(timeout=300) == want == ref(p, 40, kv_quant)
            assert b.stats["preempted_lanes"] >= 1
            assert not failures, failures
        finally:
            b.close()

    def test_preempt_int8_mid_staging_tail(self, setup):
        """The int8 victim's write frontier is mid-block at the spill
        (prompt 9, chunk 4, block 8): the staging tail crosses the spill
        byte for byte, so the block's eventual quantize commits the tile
        the uninterrupted run commits."""
        model, cfg, ref, _, _ = setup
        p = _prompt(9, 3)
        b = _batcher(model, cfg, kv_quant="int8")
        try:
            want = b.submit(p, max_new_tokens=24).result(timeout=300)
            pos_at_spill = []
            real = b.executor.spill_lane

            def spy(slot):
                spill = real(slot)
                pos_at_spill.append(spill["pos"])
                return spill

            b.executor.spill_lane = spy
            h_long, h0 = _preempt_once(b, p, 24)
            h0.result(timeout=300)
            assert h_long.result(timeout=300) == want == ref(p, 24, "int8")
            assert pos_at_spill and all(q % BS for q in pos_at_spill)
            b.pool.check_invariant()
        finally:
            b.close()

    def test_preempt_budget_zero_disables_spill(self, setup):
        model, cfg, _, _, _ = setup
        b = _batcher(model, cfg, qos=TQ.QoSConfig(preempt_budget=0))
        try:
            p = _prompt(9, 3)
            h_long, h0 = _preempt_once(b, p, 16)
            times = _completion_times([h_long, h0])
            assert times[0] < times[1]
            assert b.stats["preempted_lanes"] == 0
        finally:
            b.close()

    def test_max_preempts_per_request_caps_bounces(self, setup):
        """A victim already bounced ``max_preempts_per_request`` times is
        not spilled again: the class-0 request waits for it."""
        model, cfg, _, _, _ = setup
        b = _batcher(model, cfg,
                     qos=TQ.QoSConfig(max_preempts_per_request=0))
        try:
            h_long, h0 = _preempt_once(b, _prompt(9, 3), 16)
            times = _completion_times([h_long, h0])
            assert times[0] < times[1]
            assert b.stats["preempted_lanes"] == 0
        finally:
            b.close()

    def test_parked_lane_deadline_resolves_partial(self, setup):
        """A parked victim whose deadline expires resolves with the
        tokens it had at the spill boundary, while the class-0 request
        still decodes."""
        model, cfg, _, _, _ = setup
        b = _batcher(model, cfg)
        try:
            p = _prompt(9, 3)
            h_long, h0 = _preempt_once(b, p, 40, p0_new=24, delay=0.05,
                                       deadline_s=60.0)
            _wait(lambda: b.stats["preempted_lanes"], "no preemption")
            h_long.deadline = time.monotonic() - 0.001
            times = _completion_times([h_long, h0])
            assert h_long.deadline_exceeded
            out = h_long.result(timeout=5)
            assert out[:len(p)] == p and len(out) < len(p) + 40
            assert times[0] < times[1], \
                "the parked expiry waited for the class-0 lane"
            h0.result(timeout=5)
            assert b.stats["restored_lanes"] == 0
            b.pool.check_invariant()
            assert b.serving_status()["parkedLanes"] == 0
        finally:
            b.close()

    def test_parked_lane_cancel_resolves_partial(self, setup):
        model, cfg, _, _, _ = setup
        b = _batcher(model, cfg)
        try:
            p = _prompt(9, 3)
            h_long, h0 = _preempt_once(b, p, 40, p0_new=24, delay=0.05)
            _wait(lambda: b.stats["preempted_lanes"], "no preemption")
            h_long.cancel()
            times = _completion_times([h_long, h0])
            out = h_long.result(timeout=5)
            assert out[:len(p)] == p and len(out) < len(p) + 40
            assert times[0] < times[1]
            h0.result(timeout=5)
            b.pool.check_invariant()
        finally:
            b.close()

    def test_drain_finishes_a_parked_lane(self, setup):
        """A drain with a lane parked waits for it: the victim resumes
        once the class-0 lane frees (restores run while draining) and
        returns its whole stream."""
        model, cfg, ref, _, _ = setup
        b = _batcher(model, cfg)
        p = _prompt(9, 3)
        h_long, h0 = _preempt_once(b, p, 40, p0_new=16, delay=0.05)
        _wait(lambda: b.stats["preempted_lanes"], "no preemption")
        assert b.serving_status()["parkedLanes"] == 1 or \
            b.stats["restored_lanes"]
        b.drain(budget_s=60.0)
        assert h0.result(timeout=5)[:7] == _prompt(7, 5)
        assert h_long.result(timeout=5) == ref(p, 40)
        assert b.stats["restored_lanes"] == 1
        assert not b.accepting

    def test_heal_fails_a_parked_lane_retriable(self, setup):
        """A raising dispatch while a lane is parked: the rebuild fails
        the resident AND the parked request with the retriable error,
        and the rebuilt ring serves the victim's tokens afresh."""
        model, cfg, ref, _, _ = setup
        b = _batcher(model, cfg, resilience=RingResilience(
            watchdog=False, backoff_base_s=0.01))
        try:
            p = _prompt(9, 3)
            h_long, h0 = _preempt_once(b, p, 40, p0_new=24, delay=0.05)
            _wait(lambda: b.stats["preempted_lanes"], "no preemption")
            real = b.executor.replay

            def faulty(plan):
                b.executor.replay = real
                raise RuntimeError("injected dispatch fault")

            b.executor.replay = faulty
            for h in (h_long, h0):
                with pytest.raises(RetriableError):
                    h.result(timeout=300)
            assert b.stats["watchdog_restarts"] == 1
            _wait(lambda: b.accepting, "the ring was not rebuilt")
            assert b.serving_status()["parkedLanes"] == 0
            assert b.submit(p, max_new_tokens=12).result(timeout=300) == \
                ref(p, 12)
            b.pool.check_invariant()
        finally:
            b.close()

    def test_contiguous_ring_never_preempts(self, setup):
        model, cfg, ref, _, _ = setup
        b = _batcher(model, cfg, paged=False)
        try:
            p = _prompt(9, 3)
            h_long, h0 = _preempt_once(b, p, 24)
            times = _completion_times([h_long, h0])
            assert times[0] < times[1]
            assert h_long.result(timeout=5) == ref(p, 24)
            assert b.stats["preempted_lanes"] == 0
            assert b.serving_status()["preemptedLanes"] == 0
        finally:
            b.close()

    def test_status_and_preemption_gauge(self, setup):
        """While the victim is parked ``parkedLanes`` is 1; afterwards the
        ``tpujob_serve_lane_preemptions_total`` gauge reads the count."""
        from paddle_operator_tpu_torch.utils.observability import (
            serving_gauges,
        )

        model, cfg, _, _, _ = setup
        b = _batcher(model, cfg)
        try:
            parked = []
            real = b._preempt

            def spy(slot):
                real(slot)
                parked.append(b.serving_status()["parkedLanes"])

            b._preempt = spy
            h_long, h0 = _preempt_once(b, _prompt(9, 3), 24)
            h0.result(timeout=300)
            h_long.result(timeout=300)
            assert parked == [1]
            st = b.serving_status()
            assert (st["preemptedLanes"], st["parkedLanes"]) == (1, 0)
            g = serving_gauges(st, "j", "r0")
            assert g['tpujob_serve_lane_preemptions_total'
                     '{job="j",replica="r0"}'] == 1.0
        finally:
            b.close()


def test_status_answers_while_the_pool_is_released(setup):
    """A rebuild (``reset_state``) releases the old pool before it
    allocates the new one; a status read in that window still answers,
    with the pool's bytes (the JAX ring's status never lacks a pool)."""
    model, cfg, _, _, _ = setup
    b = _batcher(model, cfg)
    try:
        want = b.serving_status()["kvPoolBytes"]
        ex = b.executor
        cache, ex.cache = ex.cache, None
        try:
            assert b.serving_status()["kvPoolBytes"] == want > 0
        finally:
            ex.cache = cache
    finally:
        b.close()


# ---------------------------------------------------------------------------
# Over HTTP, against the JAX replica
# ---------------------------------------------------------------------------


def _post(url, body, headers=None):
    req = urllib.request.Request(url + "/v1/generate",
                                 data=json.dumps(body).encode(),
                                 headers=headers or {}, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return json.loads(r.read())["tokens"][0]


def test_http_priority_zero_preempts_like_jax(setup):
    """``X-Request-Priority: 0`` on a full port replica (one lane, the
    SERVE_* env of a deployed replica, preemption at its default)
    preempts the class-1 request, whose tokens equal the JAX replica's
    for the same pair of requests."""
    from paddle_operator_tpu.infer.qos import QoSConfig as JaxQoSConfig
    from paddle_operator_tpu.infer.serve import make_server as jax_server

    model, cfg, _, jparams, jcfg = setup
    env = {"SERVE_CONTINUOUS": "1", "SERVE_PAGED": "1", "SERVE_SLOTS": "1",
           "SERVE_CHUNK": str(CH), "SERVE_MAX_LEN": str(MAX_LEN),
           "SERVE_BLOCK_SIZE": str(BS), "SERVE_PREWARM": "0",
           "SERVE_PRIORITIES": "2"}
    S.refuse_unported(env)
    kw = S.ring_kw_from_env(env)
    kw.pop("resilience")
    assert kw["qos"].preempt
    jkw = dict(kw, qos=JaxQoSConfig(**dataclasses.asdict(kw["qos"])))
    srvs = {"port": S.make_server("127.0.0.1", 0, model, cfg,
                                  continuous=True, **kw),
            "jax": jax_server("127.0.0.1", 0, jparams, jcfg,
                              continuous=True, **jkw)}
    p, q = _prompt(9, 3), _prompt(7, 5)
    outs = {}
    try:
        for name, srv in srvs.items():
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            url = f"http://127.0.0.1:{srv.server_address[1]}"
            b = srv.generator.batcher
            _post(url, {"tokens": [p], "max_new_tokens": 2})   # warm
            if name == "port":
                gate = _throttle(b)
            else:
                real, gate = b._step, threading.Event()
                gate.set()

                def slow(*a, _real=real, _gate=gate):
                    _gate.wait(timeout=120)
                    time.sleep(0.03)
                    return _real(*a)

                b._step = slow
            n0 = b.stats["admitted"]
            res = {}
            t1 = threading.Thread(target=lambda: res.__setitem__(
                1, _post(url, {"tokens": [p], "max_new_tokens": 40})))
            t1.start()
            _wait(lambda: b.stats["admitted"] > n0, "no admission")
            gate.clear()
            t0 = threading.Thread(target=lambda: res.__setitem__(
                0, _post(url, {"tokens": [q], "max_new_tokens": 4},
                         {"X-Request-Priority": "0"})))
            t0.start()
            _wait(lambda: b._pending.qsize() or b.stats["admitted"] > n0 + 1,
                  "the class-0 request never queued")
            gate.set()
            t0.join(timeout=300)
            t1.join(timeout=300)
            assert b.stats["preempted_lanes"] >= 1, name
            status = json.loads(urllib.request.urlopen(
                url + "/statusz", timeout=60).read())
            assert status["preemptedLanes"] == b.stats["preempted_lanes"]
            outs[name] = res
    finally:
        for srv in srvs.values():
            srv.shutdown()
            srv.server_close()
            srv.generator.close()
    assert outs["port"] == outs["jax"]


# ---------------------------------------------------------------------------
# On the card: restores under CUDA graph replay
# ---------------------------------------------------------------------------


@pytest.mark.cuda
class TestRestoreOnCard:
    @pytest.fixture(scope="class")
    def card_model(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")
        return make_model("tiny", device="cuda", seed=0,
                          dtype=torch.float32)

    @pytest.mark.parametrize("kv_quant,megastep", [("none", 1), ("none", 4),
                                                   ("int8", 1)])
    def test_restore_keeps_graph_addresses(self, card_model, kv_quant,
                                           megastep):
        """Every dispatch a graph replay: the preempted lane resumes
        bit-identically, the restore rebinds none of the captured
        tensors and nothing is captured again."""
        model, cfg = card_model
        p = _prompt(9, 3)
        b = _batcher(model, cfg, kv_quant=kv_quant, megastep=megastep,
                     prewarm=True)
        try:
            assert b.prewarmed.wait(300) and not b.executor.needs_capture
            graphs = b.executor._graphs
            ptrs = b.executor._state_ptrs()
            want = b.submit(p, max_new_tokens=40).result(timeout=300)
            h_long, h0 = _preempt_once(b, p, 40)
            h0.result(timeout=300)
            assert h_long.result(timeout=300) == want
            assert b.stats["restored_lanes"] >= 1
            assert b.executor._graphs is graphs
            assert b.executor._state_ptrs() == ptrs
            b.pool.check_invariant()
        finally:
            b.close()

    def test_int8_mid_staging_tail_on_card(self, card_model):
        model, cfg = card_model
        p = _prompt(9, 3)
        b = _batcher(model, cfg, kv_quant="int8", prewarm=True)
        try:
            assert b.prewarmed.wait(300)
            want = b.submit(p, max_new_tokens=24).result(timeout=300)
            h_long, h0 = _preempt_once(b, p, 24)
            h0.result(timeout=300)
            assert h_long.result(timeout=300) == want
            assert b.stats["preempted_lanes"] >= 1
        finally:
            b.close()
