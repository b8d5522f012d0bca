"""The torch package's megastep (SERVE_MEGASTEP) held against the JAX
package's (tests/test_megastep.py), on converted ``tiny`` f32 params and
inputs seeded from numpy:

- the device-side continuation, ``_mega_advance`` and
  ``_mega_continue``, equal to JAX's exactly on random boundaries;
- the fused programs, ``make_megastep`` (contiguous) and
  ``make_paged_megastep`` (bf16 and int8 pools), against JAX's from the
  same state and table at temperature 0: tokens, counts, positions
  equal; live lanes' pool rows within 1e-5; dead lanes' real blocks
  untouched, exactly;
- through ``ContinuousBatcher`` on each of the three rings (contiguous,
  paged, int8 paged): the cases of TestParity, TestPlanReplayer and
  ``test_deadline_expires_at_boundary_with_partial`` — N = 4 tokens
  equal the 1-step port's and the JAX ring's; the sampled stream at
  N = 4 equals N = 1's; the sampler's frequencies against
  softmax(filtered logits / T); the watchdog's megastep scale; the
  ``SERVE_MEGASTEP`` mapping and one HTTP request;
- on the card (``cuda``-marked, skipped here): every dispatch is a CUDA
  graph replay equal to the eager program bit for bit, graphs are
  captured again after ``reset_state``, the launch counts stay exact,
  and nothing runs eagerly when a graph is missing.  This file imports
  the JAX package only inside the fixtures that need it, so the card's
  machine (JAX, no flax) can run those tests.
"""

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
from paddle_operator_tpu_torch.infer import paged as PG
from paddle_operator_tpu_torch.infer import resilience as TR
from paddle_operator_tpu_torch.infer import serve as S
from paddle_operator_tpu_torch.infer.batcher import ContinuousBatcher
from paddle_operator_tpu_torch.models.llama import make_model
from paddle_operator_tpu_torch.ops import decode_attention as DA

MAX_LEN = 64
BS = 8
CHUNK = 4
TOL = 1e-5        # f32 rows of the same inputs, summation order aside
RINGS = [pytest.param({"paged": True}, id="paged"),
         pytest.param({"paged": False}, id="contig"),
         pytest.param({"paged": True, "kv_quant": "int8"}, id="int8")]


@pytest.fixture(scope="module")
def setup():
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

    def jax_ring(ring, prompts, megastep, new, eos=None):
        """The JAX ring's greedy outputs, memoized."""
        key = (tuple(sorted(ring.items())), tuple(map(tuple, prompts)),
               megastep, new, eos)
        if key not in refs:
            b = JaxBatcher(jparams, jcfg, megastep=megastep,
                           **_ring_kw(ring))
            try:
                refs[key] = [h.result(timeout=300) for h in [
                    b.submit(p, max_new_tokens=new, eos_token=eos)
                    for p in prompts]]
            finally:
                b.close()
        return refs[key]

    return model, cfg, jax_ring, jparams, jcfg


def _ring_kw(ring, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("chunk_tokens", CHUNK)
    kw.setdefault("prefill_buckets", (16, MAX_LEN))
    kw.setdefault("block_size", BS)
    return dict(ring, **kw)


def _prompt(s, seed):
    return np.random.default_rng(seed).integers(0, 256, s).astype(
        np.int32).tolist()


def _batcher(model, cfg, ring, megastep, **kw):
    return ContinuousBatcher(model, cfg, megastep=megastep,
                             **_ring_kw(ring, **kw))


def _run(model, cfg, ring, prompts, megastep, new=10, eos=None, **kw):
    b = _batcher(model, cfg, ring, megastep, **kw)
    try:
        hs = [b.submit(p, max_new_tokens=new, eos_token=eos)
              for p in prompts]
        outs = [h.result(timeout=120) for h in hs]
        if b.pool is not None:
            b.pool.check_invariant()
        return outs, dict(b.stats), b.serving_status()
    finally:
        b.close()


def _throttle_replay(b, delay):
    """Pace the plan replayer (the one resident dispatch seam) so
    boundary-timing tests see several dispatches at any host speed."""
    real = b.executor.replay

    def slow(plan):
        time.sleep(delay)
        return real(plan)

    b.executor.replay = slow


# ---------------------------------------------------------------------------
# The device-side continuation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_mega_advance_and_continue_match_jax(seed):
    from paddle_operator_tpu.infer import executor as JX

    rng = np.random.default_rng(seed)
    t, b = int(rng.integers(1, 9)), 7
    toks = rng.integers(0, 5, (t, b)).astype(np.int32)
    raw = np.where(rng.random(b) < 0.7, t, 0).astype(np.int32)
    live = rng.random(b) < 0.7
    left = rng.integers(0, 2 * t + 2, b).astype(np.int32)
    steps = rng.integers(0, 3, b).astype(np.int32)
    eos = rng.integers(-1, 5, b).astype(np.int32)
    want = JX._mega_continue(*map(jnp.asarray, (toks, raw, live, left,
                                                steps, eos)))
    got = X._mega_continue(*map(torch.as_tensor, (toks, raw, live, left,
                                                  steps, eos)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    want = JX._mega_advance(*map(jnp.asarray, (toks, raw, live, left, eos)))
    got = X._mega_advance(*map(torch.as_tensor, (toks, raw, live, left,
                                                 eos)))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ---------------------------------------------------------------------------
# The fused programs against JAX's, from one state
# ---------------------------------------------------------------------------

N_STEPS = 3
# lane roles: 0 long budget; 1 an eos inside a fused iteration; 2 a
# budget that ends mid-megastep; 3 inactive, holding real blocks; 4
# frozen by its step budget after one iteration (paged only)
LANES = 5


def _lane_plan(paged):
    active = np.asarray([True, True, True, False, True])
    left = np.asarray([40, 40, 6, 40, 40], np.int32)
    steps = np.full(LANES, N_STEPS, np.int32)
    if paged:
        steps[4] = 1
    pos = np.asarray([9, 20, 3, 17, 12], np.int32)
    return active, left, steps, pos


def _mega_pair(jcfg, jparams, cfg, model, jcache, tcache, table, tok,
               active, left, steps, eos, quant=None):
    """Run JAX's and the port's megastep from one state; returns their
    (tok, toks, counts, cache) as numpy."""
    from paddle_operator_tpu.infer import executor as JX
    from paddle_operator_tpu.infer import paged as JPG

    b = tok.shape[0]
    keys = jnp.zeros((b, 2), jnp.uint32)
    temp = np.zeros(b, np.float32)
    ops = (active, eos, left, steps)
    if table is None:
        jprog = JX.make_megastep(jcfg, CHUNK, N_STEPS)
        tprog = X.make_megastep(cfg, CHUNK, N_STEPS)
        jlead, tlead = (), ()
    else:
        jprog = JPG.make_paged_megastep(jcfg, CHUNK, N_STEPS,
                                        quant=quant is not None)
        tprog = PG.make_paged_megastep(cfg, CHUNK, N_STEPS,
                                       quant=quant is not None)
        jlead, tlead = (jnp.asarray(table),), (torch.as_tensor(table),)
    jc, jtok, jtoks, jcounts = jprog(
        jparams, {k: jnp.asarray(v) for k, v in jcache.items()}, *jlead,
        jnp.asarray(tok), jnp.asarray(temp), keys,
        *map(jnp.asarray, ops))
    with torch.inference_mode():
        ttok, ttoks, tcounts = tprog(
            model, tcache, *tlead, torch.as_tensor(tok),
            torch.as_tensor(temp), torch.zeros(b, dtype=torch.int64),
            *map(torch.as_tensor, ops))
    return ((np.asarray(jtok), np.asarray(jtoks), np.asarray(jcounts),
             {k: np.asarray(v) for k, v in jc.items()}),
            (ttok.numpy(), ttoks.numpy(), tcounts.numpy(),
             {k: v.numpy() for k, v in tcache.items()}))


def _with_mid_eos(run, eos_lane=1, at=5):
    """Run once without eos, then again with lane ``eos_lane``'s eos set
    to the token it emitted at flat index ``at`` (iteration 1 of a
    4-tick chunk): the eos lands inside a fused iteration."""
    eos = np.full(LANES, -1, np.int32)
    (_, jtoks, _, _), _ = run(eos)
    flat = jtoks[:, :, eos_lane].reshape(-1)
    eos[eos_lane] = int(flat[at])
    return run(eos), eos


def _check_outputs(j, t):
    jtok, jtoks, jcounts, jc = j
    ttok, ttoks, tcounts, tc = t
    np.testing.assert_array_equal(ttoks, jtoks)
    np.testing.assert_array_equal(tcounts, jcounts)
    np.testing.assert_array_equal(ttok, jtok)
    np.testing.assert_array_equal(tc["pos"], jc["pos"])


class TestProgramsMatchJax:
    def test_contiguous_megastep(self, setup):
        model, cfg, _, jparams, jcfg = setup
        rng = np.random.default_rng(11)
        active, left, steps, pos = _lane_plan(paged=False)
        pos[3] = 0          # an inactive lane's position, zeroed
        alloc = 256
        shape = (jcfg.n_layers, LANES, jcfg.n_kv_heads, alloc, jcfg.head_dim)
        k0 = rng.standard_normal(shape).astype(np.float32)
        v0 = rng.standard_normal(shape).astype(np.float32)
        tok = rng.integers(0, 256, LANES).astype(np.int32)

        def run(eos):
            cache = {"k": k0, "v": v0, "pos": pos}
            tcache = {k: torch.as_tensor(np.array(v)) for k, v in
                      cache.items()}
            return _mega_pair(jcfg, jparams, cfg, model, cache, tcache,
                              None, tok, active, left, steps, eos)

        (j, t), eos = _with_mid_eos(run)
        _check_outputs(j, t)
        assert j[2][:, 1].sum() < N_STEPS * CHUNK      # eos truncated
        assert j[2][:, 2].sum() == 6                   # budget spent
        assert (j[2][:, 3] == 0).all()                 # inactive
        for key in ("k", "v"):
            np.testing.assert_allclose(t[3][key], j[3][key], rtol=TOL,
                                       atol=TOL)
            # the inactive lane writes only its own row 0
            np.testing.assert_array_equal(t[3][key][:, 3, :, 1:],
                                          (k0 if key == "k" else v0)
                                          [:, 3, :, 1:])

    @pytest.mark.parametrize("quant", [None, "int8"])
    def test_paged_megastep(self, setup, quant):
        model, cfg, _, jparams, jcfg = setup
        rng = np.random.default_rng(12)
        active, left, steps, pos = _lane_plan(paged=True)
        m = MAX_LEN // BS
        total = LANES * m + 1
        ids = rng.permutation(np.arange(1, total))
        table = ids.reshape(LANES, m).astype(np.int32)
        tok = rng.integers(0, 256, LANES).astype(np.int32)
        L, H, D = jcfg.n_layers, jcfg.n_kv_heads, jcfg.head_dim
        shape = (L, total, H, BS, D)
        if quant is None:
            state = {"k": rng.standard_normal(shape).astype(np.float32),
                     "v": rng.standard_normal(shape).astype(np.float32)}
        else:
            state = {}
            for kind in ("k", "v"):
                state[kind] = rng.integers(-127, 128, shape).astype(np.int8)
                state[kind + "s"] = rng.uniform(
                    0.005, 0.02, shape[:3]).astype(np.float32)
                state[kind + "t"] = rng.standard_normal(
                    (L, LANES + 1, H, BS, D)).astype(np.float32)
        state["pos"] = pos

        def run(eos):
            tcache = {k: torch.as_tensor(np.array(v)) for k, v in
                      state.items()}
            return _mega_pair(jcfg, jparams, cfg, model, state, tcache,
                              table, tok, active, left, steps, eos, quant)

        (j, t), eos = _with_mid_eos(run)
        _check_outputs(j, t)
        counts = j[2]
        assert counts[:, 1].sum() < N_STEPS * CHUNK
        assert counts[:, 2].sum() == 6 and (counts[:, 3] == 0).all()
        # the step-frozen lane ran one iteration and kept its position
        assert counts[0, 4] == CHUNK and (counts[1:, 4] == 0).all()
        assert t[3]["pos"][4] == pos[4] + CHUNK
        fin = t[3]["pos"]
        for key in ("k", "v"):
            got, want, init = t[3][key], j[3][key], state[key]
            if quant is None:
                np.testing.assert_allclose(got[:, 1:], want[:, 1:],
                                           rtol=TOL, atol=TOL)
            else:
                diff = np.abs(got[:, 1:].astype(np.int32)
                              - want[:, 1:].astype(np.int32))
                assert diff.max() <= 1, f"{key}: codes differ by {diff.max()}"
                np.testing.assert_allclose(t[3][key + "s"][:, 1:],
                                           j[3][key + "s"][:, 1:],
                                           rtol=TOL, atol=0)
                np.testing.assert_allclose(t[3][key + "t"][:, :LANES],
                                           j[3][key + "t"][:, :LANES],
                                           rtol=TOL, atol=TOL)
            for lane in range(LANES):
                # nothing at or past a lane's final position changed
                # (the inactive lane 3: nothing at all): dead lanes
                # wrote only the trash block and the trash tail
                end = 0 if lane == 3 else fin[lane]
                first = end // BS + (0 if quant is None or lane == 3
                                     else 1)
                for col in range(first, m):
                    blk = table[lane, col]
                    lo = max(end - col * BS, 0) if quant is None else 0
                    np.testing.assert_array_equal(
                        got[:, blk, :, lo:], init[:, blk, :, lo:],
                        err_msg=f"lane {lane} block {col}")
            if quant is not None:
                np.testing.assert_array_equal(t[3][key + "t"][:, 3],
                                              state[key + "t"][:, 3])


# ---------------------------------------------------------------------------
# Through ContinuousBatcher, on each ring
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ring", RINGS)
class TestParity:
    def test_megastep_bit_identical(self, setup, ring):
        """N=4 fused dispatches emit the 1-step stream and the JAX ring's
        — mixed prompt lengths, budgets that end mid-megastep, a second
        wave reusing freed lanes — in fewer dispatches."""
        model, cfg, jax_ring, _, _ = setup
        prompts = [_prompt(n, 50 + n) for n in (13, 33, 7)]
        ref, s1, _ = _run(model, cfg, ring, prompts, 1)
        got, s4, _ = _run(model, cfg, ring, prompts, 4)
        assert got == ref == jax_ring(ring, prompts, 4, 10)
        assert s4["chunks"] < s1["chunks"]

    def test_mid_megastep_eos(self, setup, ring):
        model, cfg, jax_ring, _, _ = setup
        p = _prompt(9, 3)
        base = jax_ring(ring, [p], 1, 12)
        eos = int(base[0][len(p) + 5])       # fires mid-second-iteration
        ref = jax_ring(ring, [p], 1, 12, eos)
        got, _, _ = _run(model, cfg, ring, [p], 4, new=12, eos=eos)
        assert got == ref == jax_ring(ring, [p], 4, 12, eos)
        assert got[0][-1] == eos and len(got[0]) < len(p) + 12

    def test_megastep_serving_status_gauges(self, setup, ring):
        model, cfg, _, _, _ = setup
        p = [_prompt(8, 1)]
        _, _, st1 = _run(model, cfg, ring, p, 1, new=16)
        _, _, st4 = _run(model, cfg, ring, p, 4, new=16)
        assert st1["megastepN"] == 1 and st4["megastepN"] == 4
        assert 0 < st4["dispatchesPerToken"] < st1["dispatchesPerToken"]

    def test_sampled_stream_equals_single_step(self, setup, ring):
        """Sampling noise depends only on (seed, position), so fusing
        iterations cannot change a sampled stream."""
        model, cfg, _, _, _ = setup
        outs = []
        for mega in (1, 4):
            b = _batcher(model, cfg, ring, mega, top_k=20)
            try:
                hs = [b.submit(_prompt(n, 60 + n), max_new_tokens=11,
                               temperature=0.9, seed=n) for n in (6, 17)]
                outs.append([h.result(timeout=120) for h in hs])
            finally:
                b.close()
        assert outs[0] == outs[1]


class TestPlanReplayer:
    @pytest.mark.parametrize("ring", RINGS)
    def test_n1_dispatches_the_legacy_program(self, setup, ring):
        """The 1-step replay goes through ``executor.step`` — the seam
        the pacing and fault wrappers install on."""
        model, cfg, _, _, _ = setup
        b = _batcher(model, cfg, ring, 1)
        calls = []
        real = b._step

        def spy(*a):
            calls.append(len(a))
            return real(*a)

        b._step = spy
        try:
            b.submit(_prompt(8, 2), max_new_tokens=8).result(timeout=120)
            assert calls, "replay did not route through executor.step"
        finally:
            b.close()

    def test_megastep_zero_rejected(self, setup):
        model, cfg, _, _, _ = setup
        with pytest.raises(ValueError, match="megastep"):
            ContinuousBatcher(model, cfg, slots=1, max_len=32,
                              chunk_tokens=2, prefill_buckets=(16, 32),
                              megastep=0)
        with pytest.raises(ValueError, match="megastep"):
            X.RingExecutor(model, cfg, slots=1, max_len=32, chunk_tokens=2,
                           megastep=0)

    @pytest.mark.parametrize("ring", RINGS)
    def test_step_budget_freeze_resumes_bit_identical(self, setup, ring):
        """A huge per-iteration estimate gives every lane a step budget
        of 1 of 4 fused iterations, so paged lanes FREEZE mid-megastep
        and resume in the next dispatch — the stream stays the 1-step
        one, bit for bit.  The contiguous ring is never handed a budget
        below n_steps (its dead lanes write their own row 0)."""
        model, cfg, jax_ring, _, _ = setup
        prompts = [_prompt(n, 90 + n) for n in (11, 26)]
        ref = jax_ring(ring, prompts, 1, 12)
        b = _batcher(model, cfg, ring, 4)
        b._step_s_est = 3000.0
        budgets = []
        real = b.executor.replay

        def spy(plan):
            budgets.append(plan.steps[np.asarray(plan.active, bool)])
            return real(plan)

        b.executor.replay = spy
        try:
            hs = [b.submit(p, max_new_tokens=12, deadline_s=3000.0)
                  for p in prompts]
            got = [h.result(timeout=120) for h in hs]
            assert not any(h.deadline_exceeded for h in hs)
            if b.pool is not None:
                b.pool.check_invariant()
        finally:
            b.close()
        assert got == ref
        least = min(int(s.min()) for s in budgets)
        assert least == (1 if ring["paged"] else 4)


@pytest.mark.parametrize("ring", RINGS)
def test_deadline_expires_at_boundary_with_partial(setup, ring):
    model, cfg, jax_ring, _, _ = setup
    b = _batcher(model, cfg, ring, 4, slots=1)
    _throttle_replay(b, 0.08)
    try:
        p = _prompt(8, 7)
        h = b.submit(p, max_new_tokens=40, deadline_s=0.3)
        out = h.result(timeout=120)
        assert h.deadline_exceeded
        assert len(p) <= len(out) < len(p) + 40
        assert out == jax_ring(ring, [p], 1, 40)[0][:len(out)]
        assert b.stats["deadline_exceeded"] == 1
        if b.pool is not None:
            b.pool.check_invariant()
        # the freed lane serves the next request normally
        assert b.submit(p, max_new_tokens=4).result(timeout=120) \
            == jax_ring(ring, [p], 1, 4)[0]
    finally:
        b.close()


# ---------------------------------------------------------------------------
# Sampling, the watchdog's scale, the serve entry
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("temp,top_k,top_p", [(1.0, None, None),
                                              (0.7, None, None),
                                              (1.3, 5, None),
                                              (0.9, None, 0.8),
                                              (1.1, 6, 0.9)])
def test_sample_tokens_frequencies(temp, top_k, top_p):
    """The counter-hash Gumbel-max draw is a categorical sample of
    softmax(filtered logits / T): over 20,000 draws (one a lane, seeds
    and positions distinct) every token's frequency lies within 0.015
    (over 4 standard deviations at the largest variance) of its
    probability, and filtered tokens never appear."""
    n, v = 20_000, 12
    logits = torch.as_tensor(np.random.default_rng(5).normal(0, 1.5, v),
                             dtype=torch.float32)
    draws = X._sample_tokens(
        logits.expand(n, v), torch.full((n,), temp),
        torch.arange(n, dtype=torch.int64),
        torch.arange(n, dtype=torch.int32) % 97, top_k, top_p)
    freq = np.bincount(draws.numpy(), minlength=v) / n
    from paddle_operator_tpu_torch.infer import decode as D

    want = torch.softmax(D._filter_logits(logits[None] / temp, top_k,
                                          top_p), dim=-1)[0].numpy()
    assert np.abs(freq - want).max() < 0.015, (freq, want)
    assert (freq[want == 0] == 0).all()


def test_watchdog_scale_matches_jax(monkeypatch):
    """Per-iteration samples and a threshold scaled by the in-flight
    region's fused iteration count — the JAX watchdog's, on one clock."""
    from paddle_operator_tpu.infer import resilience as JR

    clock = [100.0]
    monkeypatch.setattr(time, "monotonic", lambda: clock[0])
    cfg_j = JR.RingResilience(stall_floor_s=0.5, poll_s=60.0)
    cfg_t = TR.RingResilience(stall_floor_s=0.5, poll_s=60.0)
    dogs = [JR.DispatchWatchdog(cfg_j, lambda e: None),
            TR.DispatchWatchdog(cfg_t, lambda e: None)]
    try:
        rng = np.random.default_rng(3)
        for _ in range(40):
            scale, dur = int(rng.integers(1, 9)), float(rng.uniform(.1, 2))
            for d in dogs:
                d.begin(scale=scale)
            clock[0] += dur
            got = [d.threshold() for d in dogs]
            assert got[0] == got[1]
            for d in dogs:
                d.end()
    finally:
        for d in dogs:
            d.close()


@pytest.mark.parametrize("env,want", [({"SERVE_MEGASTEP": "4"}, 4),
                                      ({"SERVE_MEGASTEP": "0"}, None),
                                      ({"SERVE_MEGASTEP": ""}, None),
                                      ({}, None)])
def test_ring_kw_from_env_megastep(env, want):
    env = {"SERVE_CONTINUOUS": "1", "SERVE_PAGED": "1", **env}
    S.refuse_unported(env)
    assert S.ring_kw_from_env(env).get("megastep") == want


def _kv_client(b):
    """The ``FleetKVClient`` ``wire_fleet_kv_from_env`` gave ring ``b``:
    the peer fetch's owner, else the one the migration hook closes
    over."""
    from paddle_operator_tpu_torch.utils.fleetkv import FleetKVClient

    if b.peer_fetch is not None:
        return b.peer_fetch.__self__
    return next(c.cell_contents for c in b.migrate_out.__closure__
                if isinstance(c.cell_contents, FleetKVClient))


@pytest.mark.parametrize("knob", [
    # fleet-level KV is served (tests/test_torch_fleetkv.py): beside the
    # megastep each knob passes and reaches a megastep ring, as
    # serve.wire_fleet_kv_from_env wires it
    pytest.param({"SERVE_KV_MIGRATE": "1"}, id="knob0"),
    # SERVE_ADAPTERS is served (tests/test_torch_adapters.py), and so is
    # SERVE_PREFILL=disagg (tests/test_torch_disagg.py)
    pytest.param({"SERVE_TP": "2"}, id="knob1"),
    # SERVE_NAN_CHECK and TPUJOB_CHAOS are served
    # (tests/test_torch_resilience.py)
    pytest.param({"SERVE_KV_PEER_FETCH": "1",
                  "SERVE_HOST_CACHE_BLOCKS": "8"}, id="knob2"),
    pytest.param({"SERVE_KV_BROKER": "127.0.0.1:9100",
                  "SERVE_KV_MIGRATE": "1"}, id="knob3")])
def test_megastep_with_unported_knob_refused_by_its_name(setup, knob):
    """No knob is refused beside SERVE_MEGASTEP: SERVE_TP > 1 passes the
    start checks on a pod of as many cards (the tp ring at megastep 4:
    tests/test_torch_serving_tp_rings.py), and the fleet-KV knobs boot a
    megastep ring and reach it."""
    env = {"SERVE_CONTINUOUS": "1", "SERVE_PAGED": "1",
           "SERVE_MEGASTEP": "4", **knob}
    name = next(iter(knob))
    if name == "SERVE_TP":
        assert S.check_start(env, cards=2) == 2
        with pytest.raises(ValueError, match=name) as e:
            S.check_start(env, cards=1)
        assert "SERVE_MEGASTEP" not in str(e.value)
        return
    S.refuse_unported(env)
    model, cfg = setup[:2]
    kw = S.ring_kw_from_env(dict(env, SERVE_BLOCK_SIZE=str(BS),
                                 SERVE_MAX_LEN=str(MAX_LEN),
                                 SERVE_SLOTS="2",
                                 SERVE_CHUNK=str(CHUNK)), cfg)
    assert kw["megastep"] == 4
    b = ContinuousBatcher(model, cfg, prefill_buckets=(16, MAX_LEN), **kw)
    try:
        S.wire_fleet_kv_from_env(b, 9101, environ=dict(env,
                                                       POD_IP="127.0.0.1"))
        migrate = env.get("SERVE_KV_MIGRATE") == "1"
        assert (b.migrate_out is not None) == migrate == b._migrate_on_drain
        assert (b.peer_fetch is not None) == (
            env.get("SERVE_KV_PEER_FETCH") == "1")
        client = _kv_client(b)
        assert client.broker == env.get("SERVE_KV_BROKER", "")
        assert client.origin == "127.0.0.1:9101"
        assert b.serving_status()["megastepN"] == 4
    finally:
        b.close()


def test_http_megastep_server_equals_jax_ring(setup):
    """``SERVE_MEGASTEP=4`` through the env mapping and ``make_server``:
    one HTTP request's greedy rows equal the JAX ring's."""
    model, cfg, jax_ring, _, _ = setup
    env = {"SERVE_CONTINUOUS": "1", "SERVE_PAGED": "1",
           "SERVE_BLOCK_SIZE": str(BS), "SERVE_MAX_LEN": str(MAX_LEN),
           "SERVE_SLOTS": "2", "SERVE_CHUNK": str(CHUNK),
           "SERVE_MEGASTEP": "4", "SERVE_PREWARM": "0"}
    srv = S.make_server("127.0.0.1", 0, model, cfg, continuous=True,
                        **S.ring_kw_from_env(env))
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    rows = [_prompt(13, 80), _prompt(13, 81)]
    try:
        req = urllib.request.Request(
            f"http://127.0.0.1:{srv.server_address[1]}/v1/generate",
            data=json.dumps({"tokens": rows, "max_new_tokens": 9}).encode(),
            method="POST")
        with urllib.request.urlopen(req, timeout=120) as r:
            got = json.loads(r.read())["tokens"]
        assert srv.generator.batcher.serving_status()["megastepN"] == 4
    finally:
        srv.shutdown()
        srv.server_close()
        srv.generator.close()
    assert got == jax_ring({"paged": True}, rows, 4, 9)


# ---------------------------------------------------------------------------
# On the card: CUDA graphs
# ---------------------------------------------------------------------------


def _admit(ex, slot, prompt):
    """A cold admission, as the scheduler makes it: map the lane's
    blocks (paged) and run the bucket's insert."""
    n = len(prompt)
    bucket = next(b for b in ex.buckets if n <= b)
    dev_prompt = X.to_device(np.asarray([prompt], np.int32), ex.device)
    if ex.paged:
        ex.pool.admit(slot, prompt)
        row = X.to_device(ex.pool.table[slot], ex.device, torch.int32)
        ex.inserts[bucket](ex.params, ex.cache, row, ex.tok, ex.temp,
                           ex.seeds, dev_prompt, n, slot, 0.0, 0)
    else:
        ex.inserts[bucket](ex.params, ex.cache, ex.tok, ex.temp, ex.seeds,
                           dev_prompt, n, slot, 0.0, 0)


@pytest.mark.cuda
class TestGraphsOnCard:
    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")

    @pytest.fixture(scope="class")
    def card_model(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")
        return make_model("tiny", device="cuda", seed=0,
                          dtype=torch.float32)

    def _executor(self, card_model, ring, megastep=4, slots=3):
        model, cfg = card_model
        kw = _ring_kw(ring, slots=slots)
        kw.pop("prefill_buckets")
        return X.RingExecutor(model, cfg, prefill_buckets=(16, MAX_LEN),
                              megastep=megastep, **kw)

    @pytest.mark.parametrize("ring", RINGS)
    def test_replay_equals_eager(self, card_model, ring):
        """Over six dispatches (1-step and 4-step, with an eos, budgets
        and a step-frozen lane), each graph replay's toks, counts,
        positions and tokens equal the eager program's bit for bit, on
        two executors driven from the same admissions."""
        graph = self._executor(card_model, ring)
        eager = self._executor(card_model, ring)
        graph.prewarm()
        assert graph._graphs and eager._graphs is None
        prompts = [_prompt(n, 30 + n) for n in (5, 19, 11)]
        with torch.inference_mode():
            for ex in (graph, eager):
                for slot, p in enumerate(prompts):
                    _admit(ex, slot, p)
            for k in range(6):
                n = 4 if k % 2 else 1
                for ex in (graph, eager):
                    if ex.paged:
                        for slot in range(3):
                            ex.pool.ensure(slot, len(prompts[slot])
                                           + (k + 1) * 4 * CHUNK)
                plan = X.ExecPlan(
                    n, [True, True, k < 4],
                    table=graph.pool.table if graph.paged else None,
                    eos=np.asarray([-1, 7, -1], np.int32),
                    left=np.asarray([40, 40, 9], np.int32),
                    steps=np.asarray([4, 4 if not graph.paged else 2, 4],
                                     np.int32))
                gt, gc = graph.replay(plan).host()
                et, ec = eager.run(plan)
                np.testing.assert_array_equal(gt, et.cpu().numpy())
                if n > 1:
                    np.testing.assert_array_equal(gc, ec.cpu().numpy())
                for key in ("pos",):
                    assert torch.equal(graph.cache[key], eager.cache[key])
                assert torch.equal(graph.tok, eager.tok)

    def test_reset_state_recaptures_and_heal_decodes(self, card_model):
        """A raising dispatch heals through ``reset_state``: the graphs
        are dropped and captured again, and the rebuilt ring decodes the
        tokens of a fresh ring."""
        model, cfg = card_model
        p = _prompt(9, 5)
        fresh, _, _ = _run(model, cfg, {"paged": True}, [p], 4, new=12)
        b = _batcher(model, cfg, {"paged": True}, 4, prewarm=True,
                     resilience=TR.RingResilience(watchdog=False,
                                                  backoff_base_s=0.01))
        b.prewarmed.wait(timeout=300)
        first = b.executor._graphs
        real, calls = b.executor.replay, []

        def faulty(plan):
            calls.append(1)
            if len(calls) == 2:
                raise RuntimeError("injected dispatch fault")
            return real(plan)

        b.executor.replay = faulty
        try:
            with pytest.raises(TR.RetriableError):
                b.submit(p, max_new_tokens=40).result(timeout=300)
            assert b.submit(p, max_new_tokens=12).result(
                timeout=300) == fresh[0]
            assert b.stats["watchdog_restarts"] == 1
            assert b.executor._graphs is not None \
                and b.executor._graphs is not first
        finally:
            b.close()

    def test_launch_counts_per_replay(self, card_model):
        """Each replay adds the launches its graph recorded: n_layers x
        chunk x N per dispatch, and nothing for the capture."""
        model, cfg = card_model
        b = _batcher(model, cfg, {"paged": True}, 4, prewarm=True)
        try:
            b.prewarmed.wait(timeout=300)
            DA.paged_decode_attention.launches = 0
            DA.decode_attention.launches = 0
            c0 = b.stats["chunks"]
            b.submit(_prompt(7, 6), max_new_tokens=20).result(timeout=300)
        finally:
            b.close()     # the ring's last (overshoot) dispatch included
        chunks = b.stats["chunks"] - c0
        assert DA.paged_decode_attention.launches \
            == cfg.n_layers * CHUNK * 4 * chunks
        assert DA.decode_attention.launches == 0

    def test_capture_survives_collecting_an_old_ring(self, card_model):
        """An unreachable ring still holding its graphs (in a reference
        cycle) must not be collected during a later capture: destroying
        a graph mid-capture invalidates the capture."""
        import gc

        old = self._executor(card_model, {"paged": True, "kv_quant": "int8"})
        old.prewarm()
        old.cycle = old                       # reachable only by the cycle
        del old
        threshold = gc.get_threshold()
        gc.set_threshold(1)                   # collect at any allocation
        try:
            new = self._executor(card_model,
                                 {"paged": True, "kv_quant": "int8"})
            new.prewarm()
        finally:
            gc.set_threshold(*threshold)
        assert new._graphs and gc.isenabled()

    def test_no_eager_run_without_a_graph(self, card_model):
        ex = self._executor(card_model, {"paged": True})
        plan = X.ExecPlan(1, [False] * 3, table=ex.pool.table)
        with pytest.raises(RuntimeError, match="CUDA graph"):
            ex.replay(plan)

    def test_capture_refused_while_a_lane_is_resident(self, card_model):
        ex = self._executor(card_model, {"paged": False})
        with torch.inference_mode():
            _admit(ex, 0, _prompt(6, 8))
        with pytest.raises(RuntimeError, match="resident"):
            ex.capture_graphs()
