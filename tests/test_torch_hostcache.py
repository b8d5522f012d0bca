"""The torch package's host spill tier held against the JAX package
(tests/test_hostcache.py), on converted ``tiny`` f32 params (the JAX
``PRNGKey(0)`` tree) and prompts seeded from numpy:

- ``HostCacheTier``: the same answers as JAX's for the same operation
  sequence; ``PagedCacheManager`` with the tier: the same tables,
  promotions, tier keys and stats as JAX's manager over the same
  admit/publish/retire traffic (host-only payload stubs), including the
  pinned-chain case of tests/test_hostcache.py;
- through ``ContinuousBatcher`` on the exact and the int8 pools: cold,
  HBM hit and host hit give the same greedy tokens, equal to JAX
  ``decode.generate`` (exact pool) or the JAX int8 ring with its tier
  (int8 pool); every demoted payload equals the JAX ring's for the same
  chain key (K/V within 1e-5; int8 codes within one step and scales
  within rtol 1e-5, the int8 pool's documented difference) and every
  promoted block's pool bytes equal the payload bit for bit; the tier
  off is the tierless ring; the tier stays bounded and retires the
  radix nodes it drops; a heal drops the tier and gives back every slab
  slot; ``check_invariant`` holds after every case.
"""

import time

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_operator_tpu_torch.convert import params_from_jax
from paddle_operator_tpu_torch.infer.batcher import ContinuousBatcher
from paddle_operator_tpu_torch.infer.paged import (
    HostCacheTier,
    PagedCacheManager,
    host_block_bytes,
)
from paddle_operator_tpu_torch.infer.resilience import (
    RetriableError,
    RingResilience,
)
from paddle_operator_tpu_torch.models.llama import make_model

MAX_LEN = 64
BS = 8
TOL = 1e-5        # f32 rows of the same inputs, summation order aside
QUANTS = ["none", "int8"]


@pytest.fixture(scope="module")
def setup():
    from paddle_operator_tpu.infer import decode as JD
    from paddle_operator_tpu.models.llama import make_model as jmake

    jmodel, jcfg = jmake("tiny", dtype=jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, 8), jnp.int32))["params"]
    model, cfg = make_model("tiny", device="cpu", dtype=torch.float32)
    model.load_state_dict(params_from_jax(jax.device_get(jparams)))

    def generate(prompt, new):
        return np.asarray(JD.generate(
            jparams, jcfg, jnp.asarray([prompt], jnp.int32),
            max_new_tokens=new, max_len=MAX_LEN)[0]).tolist()

    return model, cfg, jparams, jcfg, generate


def _ring_kw(**kw):
    kw.setdefault("slots", 1)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("chunk_tokens", 4)
    kw.setdefault("prefill_buckets", (32, MAX_LEN))
    kw.setdefault("paged", True)
    kw.setdefault("block_size", BS)
    kw.setdefault("num_blocks", 8)          # one worst-case lane
    kw.setdefault("host_cache_blocks", 16)
    return kw


def _prompt(s, seed):
    return np.random.default_rng(seed).integers(0, 256, s).astype(
        np.int32).tolist()


# ---------------------------------------------------------------------------
# The tier and the manager against JAX's, host-only
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_tier_answers_equal_jax(seed):
    """A seeded sequence of put (with pinned sets) / trim / pop / peek /
    drop on a capacity-3 tier: every return value, the key order and
    the stats equal the JAX tier's."""
    from paddle_operator_tpu.infer.paged import HostCacheTier as JaxTier

    rng = np.random.default_rng(seed)
    mine, theirs = HostCacheTier(3), JaxTier(3)
    spilled = ([], [])
    mine.on_spill = lambda k, p: spilled[0].append(k)
    theirs.on_spill = lambda k, p: spilled[1].append(k)
    for step in range(200):
        op = rng.integers(0, 5)
        key = int(rng.integers(0, 8))
        if op <= 1:
            pinned = frozenset(int(k) for k in rng.integers(0, 8, 3))
            payload = {"x": step}
            assert mine.put(key, payload, pinned=pinned) == \
                theirs.put(key, payload, pinned=pinned)
        elif op == 2:
            assert mine.trim() == theirs.trim()
        elif op == 3 and key in theirs:
            assert mine.pop(key) == theirs.pop(key)
        else:
            assert mine.peek(key) == theirs.peek(key)
            mine.drop(key)
            theirs.drop(key)
        assert list(mine.keys()) == list(theirs.keys())
        assert mine.stats == theirs.stats
    assert spilled[0] == spilled[1]


def test_capacity_must_be_positive():
    with pytest.raises(ValueError, match="host_cache_blocks=0"):
        HostCacheTier(0)


def _stub_fetch(mgr):
    mgr.demote_fetch = lambda blk: {"blk": blk}


def test_promotion_survives_tier_overflow_pressure():
    """tests/test_hostcache.py's pinned-chain case on the port: a host-hit
    admission whose own allocations demote into a FULL tier keeps the
    chain it is about to pop (the tier exceeds its bound until the
    admit's finally trims it), with JAX's answers throughout."""
    from paddle_operator_tpu.infer.paged import (
        PagedCacheManager as JaxManager,
    )

    mgrs = [cls(slots=2, max_len=32, block_size=8, num_blocks=4,
                host_cache_blocks=2) for cls in (PagedCacheManager,
                                                 JaxManager)]
    answers = []
    for mgr in mgrs:
        _stub_fetch(mgr)
        A = list(range(16))                              # 2 blocks
        mgr.admit(0, A)
        mgr.publish(0, A)
        mgr.retire(0)
        C = [50 + i for i in range(32)]                  # 4 blocks
        mgr.admit(0, C)          # demotes A's chain; tier now FULL
        mgr.publish(0, C)
        mgr.retire(0)
        assert mgr.host_blocks() == 2 and mgr.blocks_free() == 0
        hit_len, cow = mgr.admit(1, A)
        assert hit_len == 15 and len(cow) == 1
        assert mgr.stats["host_promotions"] == 2
        promotes = mgr.take_promotions()
        assert len(promotes) == 2
        assert len(mgr.host) <= mgr.host.capacity        # trimmed back
        mgr.check_invariant()
        mgr.retire(1)
        mgr.check_invariant()
        answers.append((cow, [(d, p["blk"]) for d, p, _ in promotes],
                        list(mgr.host.keys()), mgr.table.tolist(),
                        mgr.stats))
    assert answers[0] == answers[1]


@pytest.mark.parametrize("host_blocks", [0, 2, 5])
def test_manager_traffic_equals_jax(host_blocks):
    """Seeded admit/publish/retire traffic over shared prefixes on a
    tight pool: the port's manager makes JAX's decisions — hit lengths,
    CoW pairs, promotion targets, tables, tier keys in LRU order, the
    free list and every stat — with the invariant after every step."""
    from paddle_operator_tpu.infer.paged import (
        PagedCacheManager as JaxManager,
    )

    rng = np.random.default_rng(host_blocks)
    heads = [list(rng.integers(0, 50, 24)) for _ in range(4)]
    mgrs = [cls(slots=2, max_len=48, block_size=8, num_blocks=10,
                host_cache_blocks=host_blocks)
            for cls in (PagedCacheManager, JaxManager)]
    for mgr in mgrs:
        _stub_fetch(mgr)
    live = {}
    for _ in range(60):
        slot = int(rng.integers(0, 2))
        if slot in live:
            outs = []
            for mgr in mgrs:
                mgr.retire(slot)
                mgr.check_invariant()
            del live[slot]
            continue
        head = heads[int(rng.integers(0, 4))]
        prompt = [int(t) for t in head[:int(rng.integers(9, 25))]]
        prompt += [int(t) for t in rng.integers(50, 99,
                                                int(rng.integers(1, 9)))]
        outs = []
        for mgr in mgrs:
            try:
                hit, cow = mgr.admit(slot, prompt)
            except Exception as e:
                outs.append(type(e).__name__)
                continue
            promotes = [(d, p["blk"], k)
                        for d, p, k in mgr.take_promotions()]
            mgr.publish(slot, prompt)
            outs.append((hit, cow, promotes))
        assert outs[0] == outs[1]
        if not isinstance(outs[0], str):
            live[slot] = prompt
        for mgr in mgrs:
            mgr.check_invariant()
        assert mgrs[0].table.tolist() == mgrs[1].table.tolist()
        assert mgrs[0].free == mgrs[1].free
        assert mgrs[0].stats == {k: v for k, v in mgrs[1].stats.items()
                                 if k in mgrs[0].stats}
        assert (list(mgrs[0].host.keys()) if mgrs[0].host else []) == \
            (list(mgrs[1].host.keys()) if mgrs[1].host else [])


def test_host_block_bytes_equals_jax(setup):
    from paddle_operator_tpu.infer.paged import (
        host_block_bytes as jax_bytes,
    )
    from paddle_operator_tpu.models.llama import CONFIGS as JAX_CONFIGS

    from paddle_operator_tpu_torch.models.llama import CONFIGS

    for name in ("tiny", "7b"):
        for quant in QUANTS:
            for bs in (8, 256):
                assert host_block_bytes(CONFIGS[name], bs, quant) == \
                    jax_bytes(JAX_CONFIGS[name], bs, quant)


# ---------------------------------------------------------------------------
# The ring: demote, host hit, promote — against the JAX ring
# ---------------------------------------------------------------------------


def _record_demotions(pool, copy):
    """Wrap ``pool.demote_fetch`` to keep each block's FIRST demoted
    payload by its chain key (``copy`` snapshots it: a slab slot is
    reused once the payload leaves the tier)."""
    orig = pool.demote_fetch
    recorded = {}

    def rec(blk):
        key = pool.by_block[blk]
        payload = orig(blk)
        recorded.setdefault(key, copy(payload))
        return payload

    pool.demote_fetch = rec
    return recorded


def _host_traffic(b, new=6):
    """Cold A, HBM hit, a pool-filling B (demotes A's chain), host hit:
    the three A streams."""
    A = _prompt(24, 1)                      # 3 full blocks
    cold = b.submit(A, max_new_tokens=new).result(timeout=300)
    hbm = b.submit(A, max_new_tokens=new).result(timeout=300)
    b.pool.check_invariant()
    b.submit(_prompt(56, 2), max_new_tokens=6).result(timeout=300)
    b.pool.check_invariant()
    host = b.submit(A, max_new_tokens=new).result(timeout=300)
    b.pool.check_invariant()
    return A, cold, hbm, host


@pytest.mark.parametrize("megastep", [1, 4])
@pytest.mark.parametrize("kv_quant", QUANTS)
def test_host_hit_bit_identical_and_payload_equals_jax(setup, kv_quant,
                                                       megastep):
    from paddle_operator_tpu.infer.batcher import (
        ContinuousBatcher as JaxBatcher,
    )

    model, cfg, jparams, jcfg, generate = setup
    jb = JaxBatcher(jparams, jcfg, **_ring_kw(kv_quant=kv_quant,
                                              megastep=megastep))
    try:
        jrec = _record_demotions(
            jb.pool, lambda p: {k: np.asarray(v) for k, v in p.items()})
        _, jcold, _, jhost = _host_traffic(jb)
    finally:
        jb.close()
    b = ContinuousBatcher(model, cfg, **_ring_kw(kv_quant=kv_quant,
                                                 megastep=megastep))
    try:
        rec = _record_demotions(
            b.pool, lambda p: {k: v.clone() for k, v in p.items()})
        A, cold, hbm, host = _host_traffic(b)
        assert cold == hbm == host, "host hit diverged from cold/HBM"
        assert cold == jcold == jhost
        if kv_quant == "none":
            assert cold == generate(A, 6)
        assert b.pool.stats["host_demotions"] >= 3
        assert b.pool.stats["host_promotions"] >= 3
        assert b.stats["promoted_blocks"] >= 3
        st = b.serving_status()
        assert st["promotedBlocks"] == b.stats["promoted_blocks"]
        assert st["hostHitRate"] == b.pool.host_hit_rate() > 0
        assert st["hostCacheBlocks"] == b.pool.host_blocks()
        # every demoted payload equals the JAX ring's for its chain key
        assert set(rec) == set(jrec) and len(rec) >= 3
        for key, got in rec.items():
            want = jrec[key]
            assert set(got) == set(want)
            for name in got:
                g, w = got[name].numpy(), want[name]
                assert g.shape == w.shape
                if name in ("ks", "vs"):
                    np.testing.assert_allclose(g, w, rtol=1e-5)
                elif kv_quant == "int8":
                    assert np.abs(g.astype(np.int32)
                                  - w.astype(np.int32)).max() <= 1
                else:
                    np.testing.assert_allclose(g, w, atol=TOL, rtol=0)
        # every recorded block is either promoted (its pool bytes are the
        # payload, bit for bit) or back in the tier (re-demoted after its
        # promotion: host -> device -> host is a byte identity)
        checked = 0
        for key, payload in rec.items():
            e = b.pool.entries.get(key)
            if e is None:
                continue
            for name, want in payload.items():
                got = (b.cache[name][:, e.block:e.block + 1]
                       if e.block is not None
                       else b.pool.host.peek(key)[name])
                assert torch.equal(got, want), name
            checked += 1
        assert checked >= 3
        b.pool.check_invariant()
    finally:
        b.close()


def test_tier_off_default_is_tierless(setup):
    """host_cache_blocks=0: no tier and no slab, eviction discards, the
    re-admission is cold, the status reports zeros — and the tokens are
    JAX's."""
    model, cfg, _, _, generate = setup
    b = ContinuousBatcher(model, cfg, **_ring_kw(host_cache_blocks=0))
    try:
        assert b.pool.host is None and b.executor._slab is None
        A = _prompt(24, 1)
        want = generate(A, 6)
        assert b.submit(A, max_new_tokens=6).result(timeout=300) == want
        b.submit(_prompt(56, 2), max_new_tokens=6).result(timeout=300)
        assert b.pool.stats["host_demotions"] == 0
        assert b.pool.stats["cache_evictions"] >= 3   # discarded
        toks0 = b.stats["prefill_tokens"]
        assert b.submit(A, max_new_tokens=6).result(timeout=300) == want
        assert b.stats["prefill_tokens"] - toks0 == 24
        st = b.serving_status()
        assert (st["hostCacheBlocks"], st["hostHitRate"],
                st["promotedBlocks"], st["hostCacheEvictions"]) == \
            (0, 0.0, 0, 0)
        b.pool.check_invariant()
    finally:
        b.close()


def test_tier_on_equals_tier_off_streams(setup):
    """The same request stream through a ring with the tier and one
    without: the same tokens, request by request."""
    model, cfg, _, _, _ = setup
    prompts = [_prompt(24, 1), _prompt(40, 3), _prompt(24, 1),
               _prompt(56, 2), _prompt(24, 1), _prompt(40, 3),
               _prompt(17, 4)]
    outs = []
    for host_blocks in (0, 16):
        b = ContinuousBatcher(model, cfg,
                              **_ring_kw(host_cache_blocks=host_blocks))
        try:
            outs.append([b.submit(p, max_new_tokens=5).result(timeout=300)
                         for p in prompts])
            b.pool.check_invariant()
            if host_blocks:
                assert b.pool.stats["host_promotions"] >= 1
        finally:
            b.close()
    assert outs[0] == outs[1]


def test_host_tier_bounded_with_radix_retirement(setup):
    """Tier overflow drops the OLDEST payload and retires its radix
    node: the tier stays within its bound, the dropped prefix is cold
    again, and the slab's slots come back."""
    model, cfg, _, _, _ = setup
    b = ContinuousBatcher(model, cfg, **_ring_kw(host_cache_blocks=2))
    try:
        A = _prompt(24, 1)
        b.submit(A, max_new_tokens=6).result(timeout=300)
        b.submit(_prompt(56, 2), max_new_tokens=6).result(timeout=300)
        assert b.pool.host_blocks() <= 2
        assert b.pool.host.stats["overflow_drops"] >= 1
        assert b.serving_status()["hostCacheEvictions"] == \
            b.pool.host_evictions() >= 1
        assert not any(e.stored for e in b.pool.entries.values())
        slab = b.executor._slab
        assert sum(slab.refs) == b.pool.host_blocks()
        b.pool.check_invariant()
    finally:
        b.close()


@pytest.mark.parametrize("kv_quant", QUANTS)
def test_heal_drops_the_tier(setup, kv_quant):
    """A ring fault heals through reset_state: the tier is rebuilt empty
    with the pool, every slab slot comes back, and the prefix serves
    cold and exact again."""
    model, cfg, _, _, _ = setup
    b = ContinuousBatcher(model, cfg, **_ring_kw(
        kv_quant=kv_quant, resilience=RingResilience(
            watchdog=False, max_restarts=4, backoff_base_s=0.01)))
    try:
        A, cold, _, _ = _host_traffic(b)
        b.submit(_prompt(56, 2), max_new_tokens=6).result(timeout=300)
        assert b.pool.host_blocks() >= 3
        slab = b.executor._slab
        real = b.executor.replay
        fired = []

        def fail_once(plan):
            if not fired:
                fired.append(1)
                raise RuntimeError("injected dispatch fault")
            return real(plan)

        b.executor.replay = fail_once
        with pytest.raises(RetriableError):
            b.submit(A, max_new_tokens=6).result(timeout=300)
        # the residents fail first, then the ring rebuilds
        deadline = time.monotonic() + 60
        while not b.accepting:
            assert time.monotonic() < deadline, "the ring never healed"
            time.sleep(0.01)
        assert b.stats["watchdog_restarts"] == 1
        assert b.pool.host_blocks() == 0
        assert sum(slab.refs) == 0 and len(slab.free) == slab.n_slots
        toks0 = b.stats["prefill_tokens"]
        assert b.submit(A, max_new_tokens=6).result(timeout=300) == cold
        assert b.stats["prefill_tokens"] - toks0 == 24
        b.pool.check_invariant()
    finally:
        b.close()


def test_close_gives_the_slab_back(setup):
    model, cfg, _, _, _ = setup
    b = ContinuousBatcher(model, cfg, **_ring_kw())
    slab = b.executor._slab
    _host_traffic(b)
    b.close()
    assert slab.buf is None and b.pool.host_blocks() == 0
    assert sum(slab.refs) == 0
