"""The torch package's paged KV cache (paddle_operator_tpu_torch/infer/
paged.py) held against the JAX package's infer/paged.py:

- the host block manager (``PagedCacheManager``) driven through one
  seeded admit/publish/ensure/retire sequence beside the JAX original —
  tables, hit lengths, CoW lists, free and cached counts, refcounts and
  hit rate equal after every step, across CoW, LRU eviction and
  ``NoFreeBlocks`` rollback; the heap victim selector against its scan
  oracle;
- the radix chain keys (utils/radixkey.py), which the fleet router keys
  its affinity on;
- the device half on the same converted ``tiny`` params: one tick of
  ``paged_ring_forward``, ``paged_prefill`` and the prefix-hit suffix
  forward ``_multi_forward_paged`` — logits within 1e-5, pools equal.
"""

import random

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_operator_tpu.infer import decode as JD
from paddle_operator_tpu.infer import paged as JPG
from paddle_operator_tpu.infer import speculative as JSP
from paddle_operator_tpu.models.llama import make_model as jax_make_model
from paddle_operator_tpu_torch.convert import params_from_jax
from paddle_operator_tpu_torch.infer import decode as D
from paddle_operator_tpu_torch.infer import paged as PG
from paddle_operator_tpu_torch.infer import speculative as SP
from paddle_operator_tpu_torch.models.llama import make_model

TOL = 1e-5


@pytest.fixture(scope="module")
def setup():
    jmodel, jcfg = jax_make_model("tiny", dtype=jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, 8), jnp.int32))["params"]
    model, cfg = make_model("tiny", device="cpu", dtype=torch.float32)
    model.load_state_dict(params_from_jax(jax.device_get(jparams)))
    return jcfg, jparams, model, cfg


# ---------------------------------------------------------------------------
# Host side: the block manager against the JAX original
# ---------------------------------------------------------------------------


def _state(mgr):
    return {"table": mgr.table.tolist(), "ref": mgr.ref.tolist(),
            "free": list(mgr.free), "mapped": list(mgr.mapped_count),
            "blocks_free": mgr.blocks_free(),
            "blocks_cached": mgr.blocks_cached(),
            "hit_rate": mgr.hit_rate(),
            "stats": {k: mgr.stats[k] for k in (
                "prefix_lookup_tokens", "prefix_hit_tokens",
                "prefix_lookups", "prefix_full_hits", "cow_copies",
                "cache_evictions", "blocks_hwm")}}


def _drive(mgr, nofree, log, seed=42):
    """One seeded lifecycle: admissions of overlapping prompts (full
    hits, partial tails, divergent suffixes), on-demand growth and
    retirement on a pool small enough to evict and to run dry."""
    rng = random.Random(seed)
    base = [rng.randrange(50) for _ in range(40)]
    prompts = [base[:n] for n in (8, 16, 17, 20, 24, 33)]
    prompts += [[rng.randrange(50) for _ in range(rng.choice(
        (8, 16, 17, 24, 33)))] for _ in range(8)]
    for it in range(60):
        slot = rng.randrange(3)
        op = rng.random()
        if mgr.mapped_count[slot] and op < 0.4:
            mgr.retire(slot)
            log.append(("retire", slot, _state(mgr)))
        elif mgr.mapped_count[slot] and op < 0.6:
            try:
                mgr.ensure(slot, rng.choice((24, 40, 64)))
                log.append(("ensure", slot, _state(mgr)))
            except nofree:
                log.append(("ensure-nofree", slot, _state(mgr)))
        else:
            if mgr.mapped_count[slot]:
                mgr.retire(slot)
            p = prompts[rng.randrange(len(prompts))]
            max_suffix = rng.choice((None, 10))
            try:
                hit, cow = mgr.admit(slot, p, max_suffix=max_suffix)
                mgr.publish(slot, p)
                log.append(("admit", slot, hit, cow, _state(mgr)))
            except nofree:
                log.append(("admit-nofree", slot, _state(mgr)))
        mgr.check_invariant()


class TestManagerMatchesJax:
    @pytest.mark.parametrize("num_blocks,seed", [(10, 42), (14, 7),
                                                 (None, 3)])
    def test_seeded_lifecycle(self, num_blocks, seed):
        port_log, jax_log = [], []
        _drive(PG.PagedCacheManager(3, 64, 8, num_blocks),
               PG.NoFreeBlocks, port_log, seed)
        _drive(JPG.PagedCacheManager(3, 64, 8, num_blocks),
               JPG.NoFreeBlocks, jax_log, seed)
        assert port_log == jax_log
        kinds = {e[0] for e in port_log}
        assert "admit" in kinds and "retire" in kinds
        if num_blocks == 10:       # the small pool evicts and runs dry
            assert port_log[-1][-1]["stats"]["cache_evictions"] > 0
            assert {"admit-nofree", "ensure-nofree"} & kinds
        assert any(e[0] == "admit" and e[3] for e in port_log), \
            "no copy-on-write in the sequence"

    def test_heap_victims_match_scan(self):
        def victims(use_scan):
            mgr = PG.PagedCacheManager(3, 64, 8, num_blocks=10)
            if use_scan:
                mgr._select_victim = mgr._select_victim_scan
            log, sel = [], mgr._select_victim

            def wrapped():
                v = sel()
                if v is not None:
                    log.append((v.key, v.chunk))
                return v
            mgr._select_victim = wrapped
            _drive(mgr, PG.NoFreeBlocks, [], seed=11)
            return log

        fast = victims(False)
        assert fast and fast == victims(True)

    def test_constants_and_errors(self):
        assert PG.TRASH_BLOCK == JPG.TRASH_BLOCK == 0
        mgr = PG.PagedCacheManager(2, 64, 8, num_blocks=8)
        mgr.admit(0, list(range(64)))
        with pytest.raises(PG.NoFreeBlocks):
            mgr.admit(1, list(range(10)))
        assert mgr.mapped_count[1] == 0
        mgr.check_invariant()
        with pytest.raises(ValueError):
            PG.PagedCacheManager(2, 64, 8, num_blocks=4)


class TestRadixKey:
    @pytest.mark.parametrize("block_size,max_blocks", [(8, 2), (4, 3),
                                                       (16, 1)])
    def test_chain_keys_equal_jax(self, block_size, max_blocks):
        from paddle_operator_tpu.utils import radixkey as JR
        from paddle_operator_tpu_torch.utils import radixkey as TR

        rng = np.random.default_rng(block_size)
        for n in (3, 8, 17, 40):
            toks = rng.integers(0, 32000, n).tolist()
            assert TR.prefix_chain_key(toks, block_size, max_blocks) == \
                JR.prefix_chain_key(toks, block_size, max_blocks)
            chunk = tuple(toks[:block_size])
            assert TR.chain_key(None, chunk) == JR.chain_key(None, chunk)
            assert TR.chain_key(7, chunk) == JR.chain_key(7, chunk)
        # the manager's namespaced roots agree too
        assert PG.PagedCacheManager._root_key(3) == \
            JPG.PagedCacheManager._root_key(3)


# ---------------------------------------------------------------------------
# Device side: forwards over the pool, same params, same pool
# ---------------------------------------------------------------------------


def _pool(cfg, n_blocks, bs, seed):
    shape = (cfg.n_layers, n_blocks, cfg.n_kv_heads, bs, cfg.head_dim)
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _scrambled_table(b, m, n_blocks, seed):
    ids = np.random.default_rng(seed).permutation(np.arange(1, n_blocks))
    return ids[:b * m].reshape(b, m).astype(np.int32)


class TestForwardsMatchJax:
    def test_init_paged_cache_layout(self, setup):
        jcfg, _, _, cfg = setup
        c = PG.init_paged_cache(cfg, 3, 17, 8, device="cpu")
        j = JPG.init_paged_cache(jcfg, 3, 17, 8)
        for key in ("k", "v", "pos"):
            assert tuple(c[key].shape) == j[key].shape
        assert c["pos"].dtype == torch.int32

    @pytest.mark.parametrize("pos", [[5, 13, 0], [7, 8, 31]])
    def test_ring_tick(self, setup, pos):
        jcfg, jparams, model, cfg = setup
        bs, m = 8, 4
        kp, vp = _pool(cfg, 3 * m + 1, bs, seed=1)
        table = _scrambled_table(3, m, 3 * m + 1, seed=2)
        tok = np.asarray([3, 77, 200], np.int32)
        pos = np.asarray(pos, np.int32)
        jl, jc = JPG.paged_ring_forward(
            jcfg, jparams, jnp.asarray(tok),
            {"k": jnp.asarray(kp), "v": jnp.asarray(vp),
             "pos": jnp.asarray(pos)}, jnp.asarray(table))
        cache = {"k": torch.as_tensor(kp.copy()),
                 "v": torch.as_tensor(vp.copy()),
                 "pos": torch.as_tensor(pos)}
        with torch.inference_mode():
            tl, tc = PG.paged_ring_forward(cfg, model, torch.as_tensor(tok),
                                           cache, torch.as_tensor(table))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tc["k"].numpy(), np.asarray(jc["k"]),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tc["v"].numpy(), np.asarray(jc["v"]),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jc["pos"]))

    @pytest.mark.parametrize("t", [16, 13])
    def test_paged_prefill(self, setup, t):
        jcfg, jparams, model, cfg = setup
        bs, m = 8, 4
        kp, vp = _pool(cfg, 2 * m + 1, bs, seed=3)
        row = _scrambled_table(1, m, 2 * m + 1, seed=4)[0]
        toks = np.random.default_rng(5).integers(0, 256, (1, t)).astype(
            np.int32)
        # the JAX insert forwards the prompt padded to its (block
        # multiple) bucket; the port forwards it at its own length
        padded = np.zeros((1, -(-t // bs) * bs), np.int32)
        padded[:, :t] = toks
        jl, jc = JD.paged_prefill(
            jparams, jcfg, jnp.asarray(padded),
            {"k": jnp.asarray(kp), "v": jnp.asarray(vp),
             "pos": jnp.zeros((2,), jnp.int32)}, jnp.asarray(row),
            block_size=bs)
        cache = {"k": torch.as_tensor(kp.copy()),
                 "v": torch.as_tensor(vp.copy()),
                 "pos": torch.zeros((2,), dtype=torch.int32)}
        with torch.inference_mode():
            tl, tc = D.paged_prefill(model, cfg, torch.as_tensor(toks),
                                     cache, torch.as_tensor(row),
                                     block_size=bs)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl)[:, :t],
                                   rtol=1e-4, atol=1e-4)
        # every real row landed where the JAX scatter put it; the other
        # blocks of the pool are untouched
        jk = np.asarray(jc["k"])
        for p in range(t):
            blk, off = row[p // bs], p % bs
            np.testing.assert_allclose(tc["k"][:, blk, :, off].numpy(),
                                       jk[:, blk, :, off],
                                       rtol=1e-5, atol=1e-5)
        untouched = sorted(set(range(2 * m + 1)) - set(row[:-(-t // bs)]))
        np.testing.assert_array_equal(tc["k"][:, untouched].numpy(),
                                      kp[:, untouched])

    def test_suffix_forward(self, setup):
        jcfg, jparams, model, cfg = setup
        bs, m = 8, 4
        kp, vp = _pool(cfg, 2 * m + 1, bs, seed=6)
        table = _scrambled_table(2, m, 2 * m + 1, seed=7)
        toks = np.random.default_rng(8).integers(0, 256, (2, 8)).astype(
            np.int32)
        pos = np.asarray([11, 3], np.int32)
        limit = np.asarray([16, 9], np.int32)   # lane 1: 6 real rows
        jl, jc = JSP._multi_forward_paged(
            jcfg, jparams, jnp.asarray(toks),
            {"k": jnp.asarray(kp), "v": jnp.asarray(vp),
             "pos": jnp.asarray(pos)}, jnp.asarray(table),
            limit=jnp.asarray(limit))
        cache = {"k": torch.as_tensor(kp.copy()),
                 "v": torch.as_tensor(vp.copy()),
                 "pos": torch.as_tensor(pos)}
        with torch.inference_mode():
            tl, tc = SP._multi_forward_paged(
                cfg, model, torch.as_tensor(toks), cache,
                torch.as_tensor(table), limit=torch.as_tensor(limit))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tc["k"][:, 1:].numpy(),
                                   np.asarray(jc["k"])[:, 1:],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tc["v"][:, 1:].numpy(),
                                   np.asarray(jc["v"])[:, 1:],
                                   rtol=TOL, atol=TOL)
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jc["pos"]))

    def test_block_copier_and_trash_writes(self, setup):
        _, _, _, cfg = setup
        k = torch.randn((2, 5, 2, 4, 16))
        v = torch.randn((2, 5, 2, 4, 16))
        PG.make_block_copier()({"k": k, "v": v}, 3, 1)
        assert torch.equal(k[:, 1], k[:, 3]) and torch.equal(v[:, 1],
                                                             v[:, 3])
        # inactive lanes (zeroed table row and position) all write block
        # 0 at offset 0 — the trash block; real blocks stay untouched
        before = k.clone()
        table = torch.tensor([[2, 4], [0, 0], [0, 0]], dtype=torch.int32)
        pos = torch.tensor([5, 0, 0], dtype=torch.int32)
        PG._write_token_paged(k[0], torch.randn((3, 2, 16)), table, pos, 4)
        changed = (k != before).flatten(2).any(-1)[0]
        assert changed.tolist() == [True, False, False, False, True]
        assert torch.equal(k[0, 4, :, 0], before[0, 4, :, 0])
        assert not torch.equal(k[0, 4, :, 1], before[0, 4, :, 1])
