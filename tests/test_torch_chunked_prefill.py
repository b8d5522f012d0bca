"""The torch package's chunked prefill (SERVE_PREFILL=chunked,
SERVE_PREFILL_CHUNK) held against the JAX package, on the same
numpy-seeded inputs and converted ``tiny`` params in float32:

- the multi-token forwards (infer/speculative.py): ``_multi_forward``
  over a contiguous cache with ``head`` True and False, and the
  ``head=False`` leg of ``_multi_forward_paged`` on the bf16 and int8
  pools, against JAX's;
- one intermediate slice and one final insert of each ring — the
  contiguous staging lane (``make_prefill_chunk``,
  ``make_chunked_final_insert``) and the pools
  (``make_paged_prefill_chunk``, then the suffix insert) — against
  JAX's on the same pool and table;
- the ring: ``ContinuousBatcher(prefill_mode="chunked")`` greedy
  streams equal JAX ``decode.generate`` on the contiguous and bf16
  paged rings, and JAX's own chunked int8 batcher on the int8 ring, at
  slice widths 8, 5 and 12 (block 8), megastep 1 and 4, with a
  mid-block radix hit and a hit followed by several slices; one
  ``SERVE_WEIGHT_QUANT=int8`` case;
- the lifecycle of a lane mid-prefill (after
  tests/test_prefill_modes.py ``TestLifecycle``): cancel, deadline,
  drain, watchdog rebuild, preemption, and the trash-block mask of its
  table rows in every dispatch;
- ``/statusz`` and ``/metrics``: ``prefillMode``, ``prefillQueueDepth``
  and ``chunkedPrefillTokenShare`` (and their gauges) equal the JAX
  replica's on the same traffic; ``ring_kw_from_env`` reads the two
  knobs as the JAX entry point does;
- on the card (``cuda``-marked, skipped here): chunked prefill under
  graph replay gives the eager ring's tokens.
"""

import copy
import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

try:
    from paddle_operator_tpu.infer import decode as JD
    from paddle_operator_tpu.infer import executor as JX
    from paddle_operator_tpu.infer import paged as JPG
    from paddle_operator_tpu.infer import quant as JQ
    from paddle_operator_tpu.infer import speculative as JSP
    from paddle_operator_tpu.infer.batcher import (
        ContinuousBatcher as JaxBatcher,
    )
    from paddle_operator_tpu.models.llama import (
        make_model as jax_make_model,
    )
    NO_FLAX = None
except ModuleNotFoundError as e:
    # the card's machine has JAX but not flax, which the JAX package's
    # models import: there the JAX-held tests skip (``setup``) and the
    # ``cuda`` case, which needs only the port, runs
    if e.name != "flax":
        raise
    NO_FLAX = e
from paddle_operator_tpu_torch.convert import params_from_jax
from paddle_operator_tpu_torch.infer import executor as X
from paddle_operator_tpu_torch.infer import paged as PG
from paddle_operator_tpu_torch.infer import quant as Q
from paddle_operator_tpu_torch.infer import serve as S
from paddle_operator_tpu_torch.infer import speculative as SP
from paddle_operator_tpu_torch.infer.batcher import ContinuousBatcher
from paddle_operator_tpu_torch.infer.qos import QoSConfig
from paddle_operator_tpu_torch.infer.resilience import (
    RetriableError,
    RingResilience,
    ShuttingDown,
)
from paddle_operator_tpu_torch.models.llama import make_model

MAX_LEN = 64
BS = 8
TOL = 1e-5         # f32 logits and K/V rows, same products, summation aside
RINGS = {"contig": {"paged": False},
         "paged": {"paged": True, "block_size": BS},
         "int8": {"paged": True, "block_size": BS, "kv_quant": "int8"}}
# slice widths: the block size, and two that do not divide it
SLICES = (8, 5, 12)


@pytest.fixture(scope="module")
def setup():
    if NO_FLAX is not None:
        pytest.skip(f"the JAX package cannot be imported here: {NO_FLAX}")
    jmodel, jcfg = jax_make_model("tiny", dtype=jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, 8), jnp.int32))["params"]
    model, cfg = make_model("tiny", device="cpu", dtype=torch.float32)
    model.load_state_dict(params_from_jax(jax.device_get(jparams)))
    model.requires_grad_(False)
    refs = {}

    def ref(prompt, new, params=None):
        """JAX decode.generate (memoized per prompt, budget and tree)."""
        key = (tuple(int(t) for t in prompt), new, params is None)
        if key not in refs:
            refs[key] = np.asarray(JD.generate(
                jparams if params is None else params, jcfg,
                jnp.asarray([prompt], jnp.int32), max_new_tokens=new,
                max_len=MAX_LEN)[0]).tolist()
        return refs[key]

    return jcfg, jparams, model, cfg, ref


def _prompt(s, seed):
    return np.random.default_rng(seed).integers(0, 256, s).astype(
        np.int32).tolist()


def _batcher(model, cfg, ring="paged", **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("chunk_tokens", 4)
    kw.setdefault("prefill_buckets", (8, 16, 32, MAX_LEN))
    kw.setdefault("prefill_mode", "chunked")
    kw.setdefault("prefill_chunk", 8)
    return ContinuousBatcher(model, cfg, **RINGS[ring], **kw)


def _paced_dispatches(b, secs):
    """Slow every ring dispatch down, so a decoding lane outlasts the
    test's reaction time."""
    real = b.executor.replay

    def paced(plan):
        time.sleep(secs)
        return real(plan)

    b.executor.replay = paced


def _decoding_beside_prefill(b):
    """A lane decodes while another is mid-prefill."""
    return b._prefilling and any(
        r is not None and i not in b._prefilling
        for i, r in enumerate(b.lane))


def _paced_slices(b, secs=0.05):
    """Slow every slice down, so a test can act while a lane is
    mid-prefill."""
    real = b._advance_prefill

    def paced(slot):
        time.sleep(secs)
        return real(slot)

    b._advance_prefill = paced


def _wait(cond, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.002)


def _assert_codes_close(got, want, what):
    """int8 codes within ±1: an f32 last bit may move a value across a
    code midpoint (ROADMAP.md Queue C, known differences)."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, f"{what}: codes differ by {diff.max()}"


def _pools(cfg, jcfg, kv_quant, total, seed):
    """The same random pool for both packages: (JAX dict, port dict)."""
    rng = np.random.default_rng(seed)
    jc = JPG.init_paged_cache(jcfg, 2, total, BS, quant=kv_quant)
    cache = {k: np.array(v) for k, v in jc.items()}
    for key in ("k", "v"):
        if kv_quant == "int8":
            cache[key] = rng.integers(-127, 128, cache[key].shape).astype(
                np.int8)
            cache[key + "s"] = (rng.random(cache[key + "s"].shape) * 0.02
                                + 0.005).astype(np.float32)
            cache[key + "t"] = (rng.standard_normal(cache[key + "t"].shape)
                                * 0.5).astype(np.float32)
        else:
            cache[key] = (rng.standard_normal(cache[key].shape)
                          * 0.5).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in cache.items()},
            {k: torch.as_tensor(v.copy()) for k, v in cache.items()})


def _assert_pool_equal(tc, jc, kv_quant, blocks=None):
    """Port pool == JAX pool: bf16 (here f32) rows within TOL; int8
    codes within ±1, scales and tails within TOL."""
    sel = slice(None) if blocks is None else blocks
    for key in ("k", "v"):
        got = tc[key][:, sel].numpy()
        want = np.asarray(jc[key])[:, sel]
        if kv_quant == "int8":
            _assert_codes_close(got, want, key)
            np.testing.assert_allclose(
                tc[key + "s"][:, sel].numpy(),
                np.asarray(jc[key + "s"])[:, sel], rtol=TOL, atol=0)
        else:
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the multi-token forwards
# ---------------------------------------------------------------------------


class TestMultiForward:
    @pytest.mark.parametrize("head", [True, False])
    def test_contiguous_equals_jax(self, setup, head):
        """[2, 5] tokens at per-lane offsets 3 and 10 over a random
        contiguous cache: logits (head) within 1e-5, caches equal
        within 1e-5, positions advanced by 5; ``head=False`` returns no
        logits."""
        jcfg, jparams, model, cfg, _ = setup
        rng = np.random.default_rng(1)
        shape = (cfg.n_layers, 2, cfg.n_kv_heads, 24, cfg.head_dim)
        k = (rng.standard_normal(shape) * 0.5).astype(np.float32)
        v = (rng.standard_normal(shape) * 0.5).astype(np.float32)
        pos = np.asarray([3, 10], np.int32)
        toks = rng.integers(0, 256, (2, 5)).astype(np.int32)
        jl, jc = JSP._multi_forward(
            jcfg, jparams, jnp.asarray(toks),
            {"k": jnp.asarray(k), "v": jnp.asarray(v),
             "pos": jnp.asarray(pos)}, head=head)
        cache = {"k": torch.as_tensor(k.copy()), "v": torch.as_tensor(v.copy()),
                 "pos": torch.as_tensor(pos)}
        with torch.inference_mode():
            tl, tc = SP._multi_forward(cfg, model, torch.as_tensor(toks),
                                       cache, head=head)
        if head:
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       rtol=TOL, atol=TOL)
        else:
            assert tl is None and jl is None
        for key in ("k", "v"):
            assert tc[key] is cache[key]            # written in place
            np.testing.assert_allclose(tc[key].numpy(), np.asarray(jc[key]),
                                       rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jc["pos"]))

    @pytest.mark.parametrize("kv_quant", ["none", "int8"])
    def test_paged_head_false_equals_jax(self, setup, kv_quant):
        """The KV-append-only paged forward: no logits, the same pool
        writes as JAX's (rows past ``limit`` to trash), the int8 leg's
        completed blocks within ±1 code and its tails' live rows."""
        jcfg, jparams, model, cfg, _ = setup
        m = 4
        total = 2 * m + 1
        table = np.asarray([[3, 7, 1, 5], [2, 8, 4, 6]], np.int32)
        jcache, tcache = _pools(cfg, jcfg, kv_quant, total, seed=2)
        rng = np.random.default_rng(3)
        toks = rng.integers(0, 256, (2, 12)).astype(np.int32)
        pos = np.asarray([11, 3], np.int32)
        limit = np.asarray([20, 9], np.int32)   # lane 1: 6 real rows
        quant = kv_quant == "int8"
        jl, jc = JSP._multi_forward_paged(
            jcfg, jparams, jnp.asarray(toks), dict(jcache,
                                                   pos=jnp.asarray(pos)),
            jnp.asarray(table), limit=jnp.asarray(limit), head=False,
            quant=quant)
        with torch.inference_mode():
            tl, tc = SP._multi_forward_paged(
                cfg, model, torch.as_tensor(toks),
                dict(tcache, pos=torch.as_tensor(pos)),
                torch.as_tensor(table), limit=torch.as_tensor(limit),
                quant=quant, head=False)
        assert tl is None and jl is None
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jc["pos"]))
        if not quant:
            # block 0 is trash: pads land there in both, in any order
            _assert_pool_equal(tc, jc, kv_quant, list(range(1, total)))
            return
        done = [table[0, 1], table[1, 0]]       # the completed blocks
        _assert_pool_equal(tc, jc, kv_quant, done)
        for key in ("k", "v"):
            jt = np.asarray(jc[key + "t"])
            np.testing.assert_allclose(tc[key + "t"][:, 0, :, :4].numpy(),
                                       jt[:, 0, :, :4], rtol=TOL, atol=TOL)
            np.testing.assert_allclose(tc[key + "t"][:, 1, :, :1].numpy(),
                                       jt[:, 1, :, :1], rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# the slice programs
# ---------------------------------------------------------------------------


class TestSlicePrograms:
    def test_contiguous_slice_and_final_insert(self, setup):
        """An 11-token prompt in slices of 8 on the contiguous ring: one
        intermediate slice into the staging lane, then the final insert
        (3 real rows of 8) splices it into ring slot 1 and samples the
        first token — staging, ring lane, position and token equal
        JAX's."""
        jcfg, jparams, model, cfg, _ = setup
        sb, bucket, n, slot = 8, 16, 11, 1
        prompt = np.asarray(_prompt(n, 4), np.int32)
        sl = -(-bucket // sb) * sb
        toks1 = prompt[None, :sb]
        toks2 = np.zeros((1, sb), np.int32)
        toks2[0, :n - sb] = prompt[sb:]
        # JAX
        jcache = JX.init_ring_cache(jcfg, 2, MAX_LEN)
        shape = (cfg.n_layers, 1, cfg.n_kv_heads, sl, cfg.head_dim)
        jk, jv = jnp.zeros(shape), jnp.zeros(shape)
        jk, jv = JX.make_prefill_chunk(jcfg, sb, sl)(
            jparams, jk, jv, jnp.asarray(toks1), 0)
        jstage_k = np.asarray(jk)
        tok = jnp.zeros((2,), jnp.int32)
        temp = jnp.zeros((2,), jnp.float32)
        keys = jnp.zeros((2, 2), jnp.uint32)
        jcache, jtok, _, _, jfirst = JX.make_chunked_final_insert(
            jcfg, sb, sl)(jparams, jcache, jk, jv, tok, temp, keys,
                          jnp.asarray(toks2), n - sb, sb, n, slot, 0.0, 0)
        # port
        ex = X.RingExecutor(model, cfg, slots=2, max_len=MAX_LEN,
                            chunk_tokens=4, prefill_chunk=sb)
        assert ex.staging_len(bucket) == sl
        with torch.inference_mode():
            lk, lv = ex.make_staging(bucket)
            assert tuple(lk.shape) == shape
            ex.chunk_prog(sl)(model, lk, lv, torch.as_tensor(toks1), 0)
            np.testing.assert_allclose(lk.numpy(), jstage_k, rtol=TOL,
                                       atol=TOL)
            ptrs = ex._state_ptrs()
            first = ex.final_insert(sl)(
                model, ex.cache, lk, lv, ex.tok, ex.temp, ex.seeds,
                torch.as_tensor(toks2), n - sb, sb, n, slot, 0.0, 0)
            assert ex._state_ptrs() == ptrs     # every write in place
        assert int(first) == int(jfirst) == int(ex.tok[slot])
        np.testing.assert_array_equal(ex.tok.numpy(), np.asarray(jtok))
        np.testing.assert_array_equal(ex.cache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))
        for key in ("k", "v"):
            np.testing.assert_allclose(ex.cache[key].numpy(),
                                       np.asarray(jcache[key]), rtol=TOL,
                                       atol=TOL)

    @pytest.mark.parametrize("kv_quant", ["none", "int8"])
    def test_paged_slice_and_final_insert(self, setup, kv_quant):
        """A 19-token prompt in slices of 12 (not a divisor of the block)
        on the pools: one intermediate slice through the lane's table
        (ending mid-block: on the int8 pool its rows ride the lane's
        staging tail), then the suffix insert at the slice width as the
        final slice — pools, tails, position and first token equal
        JAX's."""
        jcfg, jparams, model, cfg, _ = setup
        sb, n, slot = 12, 19, 1
        quant = kv_quant == "int8"
        total = 2 * (MAX_LEN // BS) + 1
        row = np.asarray([5, 9, 2, 14, 0, 0, 0, 0], np.int32)
        prompt = np.asarray(_prompt(n, 5), np.int32)
        toks1 = prompt[None, :sb]
        toks2 = np.zeros((1, sb), np.int32)
        toks2[0, :n - sb] = prompt[sb:]
        jcache = JPG.init_paged_cache(jcfg, 2, total, BS, quant=kv_quant)
        jchunk = JPG.make_paged_prefill_chunk(jcfg, sb, BS, quant=quant)
        jargs = (jparams, jcache, jnp.asarray(row), jnp.asarray(toks1), 0,
                 sb) + ((slot,) if quant else ())
        jcache = jchunk(*jargs)
        jmid = {k: np.asarray(v) for k, v in jcache.items()}
        tok = jnp.zeros((2,), jnp.int32)
        temp = jnp.zeros((2,), jnp.float32)
        keys = jnp.zeros((2, 2), jnp.uint32)
        jcache, jtok, _, _, jfirst = JPG.make_paged_suffix_insert(
            jcfg, sb, BS, quant=quant)(
            jparams, jcache, jnp.asarray(row), tok, temp, keys,
            jnp.asarray(toks2), n - sb, sb, slot, 0.0, 0)
        ex = X.RingExecutor(model, cfg, slots=2, max_len=MAX_LEN,
                            chunk_tokens=4, paged=True, block_size=BS,
                            kv_quant=kv_quant, prefill_chunk=sb)
        trow = torch.as_tensor(row)
        with torch.inference_mode():
            ptrs = ex._state_ptrs()
            args = (model, ex.cache, trow, torch.as_tensor(toks1), 0, sb)
            ex.chunk_prog(None)(*args + ((slot,) if quant else ()))
            mid = {k: v.clone() for k, v in ex.cache.items()}
            assert ex.final_insert(None) is ex.suffix_insert(sb)
            first = ex.final_insert(None)(
                model, ex.cache, trow, ex.tok, ex.temp, ex.seeds,
                torch.as_tensor(toks2), n - sb, sb, slot, 0.0, 0)
            assert ex._state_ptrs() == ptrs     # every write in place
        blocks = [int(b) for b in row[:-(-n // BS)]]
        if quant:
            # the intermediate slice completed block 0; rows 8..11 sit
            # in the lane's tail, the other lane's tail untouched
            _assert_pool_equal(mid, jmid, kv_quant, blocks[:1])
            for key in ("kt", "vt"):
                np.testing.assert_allclose(mid[key][:, slot, :, :4].numpy(),
                                           jmid[key][:, slot, :, :4],
                                           rtol=TOL, atol=TOL)
                assert not mid[key][:, 0].any()
            # the final slice completed block 1; row 16..18 in the tail
            _assert_pool_equal(ex.cache, jcache, kv_quant, blocks[:2])
            for key in ("kt", "vt"):
                np.testing.assert_allclose(
                    ex.cache[key][:, slot, :, :3].numpy(),
                    np.asarray(jcache[key])[:, slot, :, :3], rtol=TOL,
                    atol=TOL)
        else:
            _assert_pool_equal(mid, jmid, kv_quant, blocks)
            _assert_pool_equal(ex.cache, jcache, kv_quant, blocks)
        assert int(first) == int(jfirst)
        np.testing.assert_array_equal(ex.tok.numpy(), np.asarray(jtok))
        np.testing.assert_array_equal(ex.cache["pos"].numpy(),
                                      np.asarray(jcache["pos"]))


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------

LENS = (5, 16, 33)


def _traffic():
    """Prompts of 5, 16 and 33 tokens served together; then the 16-token
    prompt again (a full hit capped at 15 rows: a MID-BLOCK hit, CoW'd,
    one slice) and a follower of the 33-token prompt's first two blocks
    with a 17-token suffix (a block-aligned hit, then several
    slices)."""
    first = [_prompt(n, 10 + i) for i, n in enumerate(LENS)]
    return first, [first[1], first[2][:16] + _prompt(17, 20)]


def _serve_traffic(b, new=8):
    first, then = _traffic()
    out = [h.result(timeout=300)
           for h in [b.submit(p, max_new_tokens=new) for p in first]]
    out += [b.submit(p, max_new_tokens=new).result(timeout=300)
            for p in then]
    return out


@pytest.fixture(scope="module")
def jax_int8_streams(setup):
    """JAX's own chunked int8 batcher on the traffic, per slice width
    (the int8 pool's tokens need not equal the exact cache's)."""
    jcfg, jparams = setup[0], setup[1]
    out = {}

    def get(sb):
        if sb not in out:
            jb = JaxBatcher(jparams, jcfg, slots=2, max_len=MAX_LEN,
                            chunk_tokens=4,
                            prefill_buckets=(8, 16, 32, MAX_LEN),
                            paged=True, block_size=BS, kv_quant="int8",
                            prefill_mode="chunked", prefill_chunk=sb)
            try:
                out[sb] = _serve_traffic(jb)
            finally:
                jb.close()
        return out[sb]

    return get


class TestChunkedRing:
    @pytest.mark.parametrize("megastep", [1, 4])
    @pytest.mark.parametrize("sb", SLICES)
    @pytest.mark.parametrize("ring", list(RINGS))
    def test_streams_equal_jax(self, setup, jax_int8_streams, ring, sb,
                               megastep):
        jcfg, jparams, model, cfg, ref = setup
        first, then = _traffic()
        b = _batcher(model, cfg, ring, prefill_chunk=sb, megastep=megastep)
        try:
            got = _serve_traffic(b)
            if b.pool is not None:
                b.pool.check_invariant()
                hits = b.pool.stats["prefix_hit_tokens"]
                assert hits == 15 + 16
                assert b.stats["cow_copies"] >= 1
            st = b.serving_status()
            assert st["prefillQueueDepth"] == 0
            assert st["chunkedPrefillTokenShare"] == 1.0
            assert b.stats["chunked_prefill_tokens"] \
                == b.stats["prefill_tokens"] \
                == sum(LENS) + 16 + 33 - (hits if b.pool is not None else 0)
        finally:
            b.close()
        want = (jax_int8_streams(sb) if ring == "int8"
                else [ref(p, 8) for p in first + then])
        assert got == want

    @pytest.mark.parametrize("ring", ["contig", "paged"])
    def test_weight_quant_int8_equals_jax(self, setup, ring):
        """SERVE_WEIGHT_QUANT=int8 (the serving skip list) on a chunked
        ring: the greedy tokens of JAX ``generate`` over the quantized
        tree."""
        jcfg, jparams, model, cfg, ref = setup
        jq = JQ.quantize_params(jparams, jcfg, mode="int8",
                                skip=JQ.SERVING_SKIP)
        tq = Q.quantize_params(copy.deepcopy(model), cfg, mode="int8",
                               skip=Q.SERVING_SKIP)
        first, then = _traffic()
        b = _batcher(tq, cfg, ring, prefill_chunk=5)
        try:
            got = _serve_traffic(b)
            assert b.serving_status()["weightQuantMode"] == "int8"
        finally:
            b.close()
        assert got == [ref(p, 8, jq) for p in first + then]


# ---------------------------------------------------------------------------
# the lifecycle of a lane mid-prefill
# ---------------------------------------------------------------------------


class TestLifecycle:
    @pytest.mark.parametrize("ring", ["contig", "paged"])
    def test_cancel_mid_prefill_leaks_no_prior_tokens(self, setup, ring):
        """slots=1: A decodes to completion, then B (multi-slice) is
        cancelled while its slices run — it resolves with its own prompt
        and a clean prefix of its own continuation, never A's tokens."""
        _, _, model, cfg, ref = setup
        b = _batcher(model, cfg, ring, slots=1, prefill_chunk=5)
        try:
            pa = _prompt(6, 80)
            assert b.submit(pa, max_new_tokens=6).result(
                timeout=60) == ref(pa, 6)
            _paced_slices(b)
            pb = _prompt(33, 81)
            h = b.submit(pb, max_new_tokens=8)
            _wait(lambda: b._prefilling, "B mid-prefill")
            h.cancel()
            out = h.result(timeout=60)
            assert out == pb                    # cancelled mid-prefill
            assert out == ref(pb, 8)[:len(out)]
            _wait(lambda: b.lane[0] is None, "the lane to free")
            assert not b._prefilling
            if b.pool is not None:
                b.pool.check_invariant()
        finally:
            b.close()

    def test_deadline_mid_prefill_gives_partial(self, setup):
        _, _, model, cfg, ref = setup
        b = _batcher(model, cfg, "paged", prefill_chunk=5)
        try:
            _paced_slices(b, 0.1)
            p = _prompt(33, 40)
            h = b.submit(p, max_new_tokens=8, deadline_s=0.25)
            out = h.result(timeout=60)
            assert h.deadline_exceeded and out == p
            assert b.stats["deadline_exceeded"] == 1
            _wait(lambda: not b._prefilling, "the slice state to drop")
            b.pool.check_invariant()
            # the freed lane serves the next request normally
            p2 = _prompt(12, 41)
            assert b.submit(p2, max_new_tokens=4).result(
                timeout=60) == ref(p2, 4)
        finally:
            b.close()

    def test_drain_finishes_mid_prefill_lane(self, setup):
        """drain(): a lane still PREFILLING at the drain edge finishes,
        new work is refused, blocks return."""
        _, _, model, cfg, ref = setup
        b = _batcher(model, cfg, "paged", prefill_chunk=5)
        _paced_slices(b, 0.02)
        p = _prompt(33, 60)
        h = b.submit(p, max_new_tokens=6)
        _wait(lambda: b._prefilling, "the lane mid-prefill")
        b.drain(budget_s=60.0)
        assert h.result(timeout=10) == ref(p, 6)
        with pytest.raises((ShuttingDown, RuntimeError)):
            b.submit(p, max_new_tokens=2)
        assert b.pool.blocks_free() + b.pool.blocks_cached() \
            == b.pool.num_blocks

    @pytest.mark.parametrize("ring", ["contig", "int8"])
    def test_watchdog_rebuild_then_identical_output(self, setup, ring):
        """A raising dispatch while a lane is mid-prefill fails the
        residents retriably and self-heals with the slice state reset;
        the rebuilt ring serves bit-identically."""
        _, _, model, cfg, _ = setup
        b = _batcher(model, cfg, ring, prefill_chunk=5,
                     resilience=RingResilience(watchdog=False,
                                               max_restarts=3,
                                               backoff_base_s=0.05))
        try:
            p = _prompt(12, 70)
            want = b.submit(p, max_new_tokens=8).result(timeout=60)
            real, calls = b.executor.replay, []

            def faulty(plan):
                calls.append(1)
                if len(calls) == 2:
                    raise RuntimeError("injected dispatch fault")
                return real(plan)

            b.executor.replay = faulty
            _paced_slices(b, 0.02)
            h1 = b.submit(p, max_new_tokens=8)
            h2 = b.submit(_prompt(40, 71), max_new_tokens=8)
            for h in (h1, h2):
                with pytest.raises(RetriableError):
                    h.result(timeout=60)
            # the requests fail first; the rebuild then resets the rest
            _wait(lambda: not b._rebuilding, "the rebuild to finish")
            assert b.stats["watchdog_restarts"] == 1 and b.healthy
            assert not b._prefilling
            assert b.submit(p, max_new_tokens=8).result(timeout=60) == want
            if b.pool is not None:
                b.pool.check_invariant()
        finally:
            b.close()

    def test_mid_prefill_lane_never_a_preemption_victim(self, setup):
        """Two class-1 lanes, one decoding and one mid-prefill, when a
        class-0 request arrives: the decoding lane spills (and resumes
        bit-identically), the prefilling one never."""
        _, _, model, cfg, ref = setup
        b = _batcher(model, cfg, "paged", prefill_chunk=5,
                     qos=QoSConfig(priorities=2))
        victims = []
        real = b._preempt

        def spy(slot):
            victims.append((slot, slot in b._prefilling))
            return real(slot)

        b._preempt = spy
        _paced_slices(b, 0.05)
        _paced_dispatches(b, 0.03)
        try:
            pa, pb, pc = _prompt(7, 90), _prompt(40, 91), _prompt(6, 92)
            # A (one slice) admits first and decodes while B's eight
            # slices run, one an iteration
            ha = b.submit(pa, max_new_tokens=48, priority=1)
            hb = b.submit(pb, max_new_tokens=6, priority=1)
            _wait(lambda: _decoding_beside_prefill(b),
                  "A decoding beside B mid-prefill")
            assert b._pending_prefill_slots() == set(b._prefilling)
            hc = b.submit(pc, max_new_tokens=4, priority=0)
            assert hc.result(timeout=60) == ref(pc, 4)
            assert ha.result(timeout=60) == ref(pa, 48)
            assert hb.result(timeout=60) == ref(pb, 6)
            assert victims and not any(pre for _, pre in victims)
            assert b.stats["preempted_lanes"] >= 1
            b.pool.check_invariant()
        finally:
            b.close()

    @pytest.mark.parametrize("megastep", [1, 4])
    @pytest.mark.parametrize("ring", ["paged", "int8"])
    def test_plan_trashes_prefilling_rows(self, setup, ring, megastep):
        """Every dispatch while a lane is mid-prefill leaves it out of
        ``active`` and points its table rows — in the plan and in the
        uploaded static table — at the trash block; its stream then
        equals the reference (without the mask, the chunk step's
        ignored write at the lane's zeroed position lands in row 0 of
        the first block its slices fill)."""
        jcfg, jparams, model, cfg, ref = setup
        b = _batcher(model, cfg, ring, prefill_chunk=5, megastep=megastep)
        ex = b.executor
        seen, bad = [], []
        real = ex.replay

        def spy(plan):
            time.sleep(0.02)        # A decodes while B's slices run
            pre = sorted(b._prefilling)
            res = real(plan)
            table = ex._plan_views()[4].numpy()
            for slot in pre:
                seen.append(slot)
                if (plan.active[slot] or (plan.table[slot] != 0).any()
                        or (table[slot] != PG.TRASH_BLOCK).any()
                        or not b.pool.table[slot].any()):
                    bad.append(slot)
            return res

        ex.replay = spy
        try:
            # A (one slice) admits first and decodes while B's seven
            # slices run, one an iteration
            pa, pb = _prompt(5, 95), _prompt(33, 96)
            ha = b.submit(pa, max_new_tokens=40)
            hb = b.submit(pb, max_new_tokens=8)
            got = [ha.result(timeout=60), hb.result(timeout=60)]
            b.pool.check_invariant()
        finally:
            b.close()
        assert seen and not bad
        if ring == "paged":
            assert got == [ref(pa, 40), ref(pb, 8)]


# ---------------------------------------------------------------------------
# status, gauges and the env
# ---------------------------------------------------------------------------


class TestStatus:
    @pytest.mark.parametrize("mode", ["inline", "chunked"])
    def test_status_and_gauges_equal_jax(self, setup, mode):
        """The same traffic through the JAX ring and the port's:
        ``prefillMode``, ``prefillQueueDepth`` and
        ``chunkedPrefillTokenShare`` equal, and so do their /metrics
        gauge lines."""
        from paddle_operator_tpu.utils import observability as JO
        from paddle_operator_tpu_torch.utils import observability as TO

        jcfg, jparams, model, cfg, _ = setup
        kw = dict(slots=2, max_len=MAX_LEN, chunk_tokens=4,
                  prefill_buckets=(8, 16, 32, MAX_LEN), paged=True,
                  block_size=BS, prefill_mode=mode, prefill_chunk=5)
        jb = JaxBatcher(jparams, jcfg, **kw)
        b = ContinuousBatcher(model, cfg, **kw)
        try:
            p = _prompt(20, 120)
            for ring in (jb, b):
                ring.submit(p, max_new_tokens=4).result(timeout=300)
                ring.submit(p[:16] + _prompt(9, 121),
                            max_new_tokens=4).result(timeout=300)
            want, got = jb.serving_status(), b.serving_status()
        finally:
            b.close()
            jb.close()
        for key in ("prefillMode", "prefillQueueDepth",
                    "chunkedPrefillTokenShare"):
            assert got[key] == want[key], key
        assert got["chunkedPrefillTokenShare"] == (
            1.0 if mode == "chunked" else 0.0)
        tg, jg = (TO.serving_gauges(got, "ns/j", "r0"),
                  JO.serving_gauges(want, "ns/j", "r0"))
        for name in ("tpujob_serve_prefill_queue_depth",
                     "tpujob_serve_chunked_prefill_token_share"):
            lines = {k: v for k, v in tg.items() if k.startswith(name)}
            assert lines and lines == {k: v for k, v in jg.items()
                                       if k.startswith(name)}

    def test_queue_depth_counts_lanes_mid_prefill(self, setup):
        _, _, model, cfg, _ = setup
        b = _batcher(model, cfg, "paged", prefill_chunk=5)
        try:
            _paced_slices(b)
            h = b.submit(_prompt(33, 130), max_new_tokens=4)
            _wait(lambda: b._prefilling, "the lane mid-prefill")
            st = b.serving_status()
            assert st["prefillQueueDepth"] == 1
            assert st["activeLanes"] == 1
            h.result(timeout=60)
            assert b.serving_status()["prefillQueueDepth"] == 0
        finally:
            b.close()

    @pytest.mark.parametrize("env", [
        {"SERVE_PREFILL": "chunked"},
        {"SERVE_PREFILL": "chunked", "SERVE_PREFILL_CHUNK": "12"},
        {"SERVE_PREFILL": "inline", "SERVE_PREFILL_CHUNK": "5"},
        {"SERVE_PREFILL_CHUNK": "0"}],
        ids=lambda e: "-".join(f"{k}={v}" for k, v in e.items()))
    def test_ring_kw_from_env_as_jax_reads_it(self, setup, env):
        """The two knobs pass ``refuse_unported`` and parse as the JAX
        entry point parses them (``serve.main``): the mode when not
        inline, the slice width when set; both rings then carry the
        same mode and width, or both refuse a width below 1."""
        jcfg, jparams, model, cfg, _ = setup
        environ = {"SERVE_CONTINUOUS": "1", "SERVE_PAGED": "1",
                   "SERVE_BLOCK_SIZE": "8", "SERVE_SLOTS": "1",
                   "SERVE_MAX_LEN": str(MAX_LEN), "SERVE_PREWARM": "0",
                   **env}
        S.refuse_unported(environ)
        kw = S.ring_kw_from_env(environ)
        want = {}
        if env.get("SERVE_PREFILL", "inline") != "inline":
            want["prefill_mode"] = env["SERVE_PREFILL"]
        if env.get("SERVE_PREFILL_CHUNK"):
            want["prefill_chunk"] = int(env["SERVE_PREFILL_CHUNK"])
        assert {k: kw[k] for k in ("prefill_mode", "prefill_chunk")
                if k in kw} == want
        ring = dict(slots=1, max_len=MAX_LEN, chunk_tokens=4, paged=True,
                    block_size=BS, **want)
        if want.get("prefill_chunk") == 0:
            for make in (lambda: JaxBatcher(jparams, jcfg, **ring),
                         lambda: ContinuousBatcher(model, cfg, **ring)):
                with pytest.raises(ValueError, match="prefill_chunk"):
                    make()
            return
        jb = JaxBatcher(jparams, jcfg, **ring)
        b = ContinuousBatcher(model, cfg, **ring)
        try:
            assert b.prefill_mode == jb.prefill_mode
            assert b.executor.prefill_chunk == jb.executor.prefill_chunk
        finally:
            b.close()
            jb.close()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("ring", list(RINGS))
def test_chunked_under_graphs_equals_eager(ring):
    """On the card every dispatch is a CUDA graph replay while the
    slices run eagerly between them: the chunked ring's greedy tokens
    equal the same ring's with every dispatch run eagerly
    (``RingExecutor.run``), at megastep 1 and 4, and every dispatch of
    the graph run was a replay of the prewarm graphs at their
    addresses."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    model, cfg = make_model("tiny", device="cuda", seed=0,
                            dtype=torch.float32)
    for megastep in (1, 4):
        outs = {}
        for graphs in (True, False):
            b = _batcher(model, cfg, ring, prefill_chunk=5,
                         megastep=megastep, prewarm=True)
            ex = b.executor
            try:
                assert b.prewarmed.wait(300) and not ex.needs_capture
                captured, ptrs = ex._graphs, ex._state_ptrs()
                if not graphs:
                    ex.replay = lambda plan, ex=ex: X.DispatchResult(
                        *ex.run(plan), plan.n_steps)
                outs[graphs] = _serve_traffic(b)
                if graphs:
                    assert ex.graph_replays == b.stats["chunks"] > 0
                    assert ex._graphs is captured
                    assert ex._state_ptrs() == ptrs
                    assert b.stats["chunked_prefill_tokens"] > 0
            finally:
                b.close()
        assert outs[True] == outs[False], (ring, megastep)


