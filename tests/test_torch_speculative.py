"""The torch package's speculative decoding (paddle_operator_tpu_torch/
infer/speculative.py) held against the JAX package's, on converted
``tiny`` params (target from seed 0, a random draft from seed 1, as the
JAX tests build them) and numpy-seeded inputs, in float32:

- ``LlamaConfig.draft()`` and ``check_draft_compat`` against JAX's; a
  draft tree from JAX converts through ``params_from_jax``;
- the ``lane_mask`` leg of ``_multi_forward_paged`` on both pools;
- one round (``make_spec_round_fn``) on the contiguous, paged and int8
  targets, a self-draft that accepts every draft and a random one that
  rejects: committed tokens, counts, both positions and the written
  caches equal JAX's, with a block-crossing rewind on the int8 pool
  (the tail resync) and an inactive lane; one megastep likewise;
- the cases of tests/test_speculative.py TestDraftConfig,
  TestGreedyParity and TestSampled;
- the sampled acceptance rule's distribution: the first committed
  token's frequencies over 4,000 seeds match the target's softmax by a
  chi-square test, and the draft's softmax is rejected by it.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

try:
    from paddle_operator_tpu.infer import decode as JD
    from paddle_operator_tpu.infer import paged as JPG
    from paddle_operator_tpu.infer import speculative as JSP
    from paddle_operator_tpu.models.llama import CONFIGS as JAX_CONFIGS
    from paddle_operator_tpu.models.llama import Llama as JaxLlama
    from paddle_operator_tpu.models.llama import (
        make_model as jax_make_model,
    )
    NO_FLAX = None
except ModuleNotFoundError as e:
    if e.name != "flax":
        raise
    NO_FLAX = e
from paddle_operator_tpu_torch.convert import params_from_jax
from paddle_operator_tpu_torch.infer import executor as X
from paddle_operator_tpu_torch.infer import speculative as SP
from paddle_operator_tpu_torch.models.llama import CONFIGS, Llama, make_model
from paddle_operator_tpu_torch.ops.decode_attention import (
    gather_lane_view,
    gather_lane_view_quant,
)

MAX_LEN = 64
BS = 8
TOL = 1e-5         # f32 logits and K/V rows, same products, summation aside


@pytest.fixture(scope="module")
def setup():
    if NO_FLAX is not None:
        pytest.skip(f"the JAX package cannot be imported here: {NO_FLAX}")
    jmodel, jcfg = jax_make_model("tiny", dtype=jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, 8), jnp.int32))["params"]
    jdcfg = jcfg.draft()
    jdparams = JaxLlama(jdcfg).init(jax.random.PRNGKey(1),
                                    jnp.zeros((1, 8), jnp.int32))["params"]
    model, cfg = make_model("tiny", device="cpu", dtype=torch.float32)
    model.load_state_dict(params_from_jax(jax.device_get(jparams)))
    model.requires_grad_(False)
    dcfg = cfg.draft()
    dmodel = Llama(dcfg, "cpu")
    dmodel.load_state_dict(params_from_jax(jax.device_get(jdparams)))
    dmodel.requires_grad_(False)
    return {"jcfg": jcfg, "jparams": jparams, "jdcfg": jdcfg,
            "jdparams": jdparams, "cfg": cfg, "model": model, "dcfg": dcfg,
            "dmodel": dmodel}


def _prompt(s, seed, batch=1):
    return np.random.default_rng(seed).integers(0, 256, (batch, s)).astype(
        np.int32)


def _jax_generate(st, p, new, **kw):
    return np.asarray(JD.generate(st["jparams"], st["jcfg"], jnp.asarray(p),
                                  max_new_tokens=new, max_len=MAX_LEN, **kw))


def _spec(st, p, new, draft="random", **kw):
    dm, dc = ((st["dmodel"], st["dcfg"]) if draft == "random"
              else (st["model"], st["cfg"]))
    return SP.speculative_generate(st["model"], dm, st["cfg"], dc,
                                   torch.as_tensor(p), max_new_tokens=new,
                                   max_len=MAX_LEN, **kw)


# ---------------------------------------------------------------------------
# the draft config, the compatibility check and the draft tree
# ---------------------------------------------------------------------------


class TestDraftConfig:
    @pytest.mark.parametrize("preset", ["tiny", "1b", "7b", "13b"])
    def test_draft_equals_jax(self, setup, preset):
        got = CONFIGS[preset].draft()
        want = JAX_CONFIGS[preset].draft()
        for f in ("vocab_size", "dim", "n_layers", "n_heads", "n_kv_heads",
                  "ffn_dim", "max_seq_len", "rope_theta", "norm_eps",
                  "decode_attn"):
            assert getattr(got, f) == getattr(want, f), f
        assert got.dtype == CONFIGS[preset].dtype
        if preset == "7b":      # the draft the 7b serving phases run
            assert (got.n_layers, got.n_heads, got.n_kv_heads, got.dim,
                    got.ffn_dim) == (8, 16, 16, 2048, 5504)

    def test_draft_shares_vocab_and_rope_at_same_head_dim(self, setup):
        cfg, dcfg = setup["cfg"], setup["dcfg"]
        assert dcfg.vocab_size == cfg.vocab_size
        assert dcfg.max_seq_len == cfg.max_seq_len
        assert dcfg.head_dim == cfg.head_dim
        assert dcfg.n_layers < cfg.n_layers or cfg.n_layers == 1
        assert dcfg.dim < cfg.dim
        assert dcfg.n_heads % dcfg.n_kv_heads == 0
        # the GQA grouping survives the halving (3 kv heads of 12 -> 6/1)
        odd = dataclasses.replace(cfg, n_heads=12, n_kv_heads=3, dim=96)
        assert odd.draft().n_heads % odd.draft().n_kv_heads == 0
        assert odd.draft().n_kv_heads == \
            dataclasses.replace(setup["jcfg"], n_heads=12, n_kv_heads=3,
                                dim=96).draft().n_kv_heads

    def test_draft_overrides(self, setup):
        d = setup["cfg"].draft(n_layers=2)
        assert d.n_layers == 2 and d.vocab_size == setup["cfg"].vocab_size

    def test_vocab_mismatch_raises_clear_error(self, setup):
        cfg, dcfg = setup["cfg"], setup["dcfg"]
        bad = dataclasses.replace(dcfg, vocab_size=cfg.vocab_size + 1)
        jbad = dataclasses.replace(setup["jdcfg"],
                                   vocab_size=cfg.vocab_size + 1)
        with pytest.raises(ValueError, match="vocab mismatch") as e:
            SP.check_draft_compat(cfg, bad)
        with pytest.raises(ValueError, match="vocab mismatch") as je:
            JSP.check_draft_compat(setup["jcfg"], jbad)
        assert str(e.value) == str(je.value)
        SP.check_draft_compat(cfg, dcfg)
        with pytest.raises(ValueError, match="vocab mismatch"):
            SP.speculative_generate(
                setup["model"], setup["dmodel"], cfg, bad,
                torch.as_tensor(_prompt(5, 1)), max_new_tokens=2,
                max_len=MAX_LEN)

    def test_draft_tree_converts_from_jax(self, setup):
        """A draft tree from JAX goes through ``params_from_jax`` as the
        target's does: every leaf lands (strict load), and the draft's
        prefill logits equal the JAX draft's."""
        dcfg = setup["dcfg"]
        sd = params_from_jax(jax.device_get(setup["jdparams"]))
        m = Llama(dcfg, "cpu")
        m.load_state_dict(sd, strict=True)
        p = _prompt(7, 3)
        want, _ = JD.prefill(setup["jdparams"], setup["jdcfg"],
                             jnp.asarray(p), MAX_LEN)
        from paddle_operator_tpu_torch.infer import decode as D

        with torch.inference_mode():
            got, _ = D.prefill(m, dcfg, torch.as_tensor(p), MAX_LEN)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)


# ---------------------------------------------------------------------------
# the lane_mask leg, and one round against JAX's
# ---------------------------------------------------------------------------


def _target_cache(cfg, jcfg, kind, b, m, rng):
    """A random target cache of ``kind`` for ``b`` lanes (paged: a pool
    of ``b * m + 1`` blocks, lane i's table a scramble of its own
    blocks) as numpy arrays, with the table (None contiguous)."""
    s = m * BS
    if kind == "contig":
        shape = (cfg.n_layers, b, cfg.n_kv_heads, s, cfg.head_dim)
        return ({k: (rng.standard_normal(shape) * 0.5).astype(np.float32)
                 for k in ("k", "v")}, None)
    total = b * m + 1
    table = np.stack([1 + i * m + rng.permutation(m)
                      for i in range(b)]).astype(np.int32)
    jc = JPG.init_paged_cache(jcfg, b, total, BS,
                              quant="int8" if kind == "int8" else "none")
    cache = {k: np.array(v) for k, v in jc.items() if k != "pos"}
    for key in ("k", "v"):
        if kind == "int8":
            cache[key] = rng.integers(-127, 128, cache[key].shape).astype(
                np.int8)
            cache[key + "s"] = (rng.random(cache[key + "s"].shape) * 0.02
                                + 0.005).astype(np.float32)
            cache[key + "t"] = (rng.standard_normal(cache[key + "t"].shape)
                                * 0.5).astype(np.float32)
        else:
            cache[key] = (rng.standard_normal(cache[key].shape)
                          * 0.5).astype(np.float32)
    return cache, table


def _lane_views(cache, table, kind, pos):
    """Each lane's attended view [L, B, H, S, D] of a target cache (the
    contiguous rows, the gathered pool, or the dequantizing int8 view
    with the frontier block ``pos // bs`` from the tail)."""
    if kind == "contig":
        return cache["k"], cache["v"]
    tbl = torch.as_tensor(table)
    wb = torch.as_tensor(pos) // BS
    out = []
    for key in ("k", "v"):
        per_layer = []
        for li in range(cache[key].shape[0]):
            pool = torch.as_tensor(cache[key][li])
            if kind == "int8":
                per_layer.append(gather_lane_view_quant(
                    pool, torch.as_tensor(cache[key + "s"][li]),
                    torch.as_tensor(cache[key + "t"][li]), tbl, wb))
            else:
                per_layer.append(gather_lane_view(pool, tbl))
        out.append(torch.stack(per_layer).numpy())
    return out


# lane 0 accepts (its draft cache is its target view, the draft the
# target), lane 1 rejects (a random draft cache), lane 2 is inactive.
# pos: lane 1's verify rows 6..9 cross block 0's end, so a rejection
# rewinds to 7 inside a block the verify completed (the int8 resync).
ROUND_POS = np.asarray([13, 6, 4], np.int32)
ROUND_ACTIVE = np.asarray([True, True, False])
K = 3


def _round_inputs(st, kind, draft, seed):
    cfg, jcfg = st["cfg"], st["jcfg"]
    rng = np.random.default_rng(seed)
    b, m = 3, 4
    tcache, table = _target_cache(cfg, jcfg, kind, b, m, rng)
    dcfg = cfg if draft == "self" else st["dcfg"]
    dshape = (dcfg.n_layers, b, dcfg.n_kv_heads, m * BS, dcfg.head_dim)
    dcache = {k: (rng.standard_normal(dshape) * 0.5).astype(np.float32)
              for k in ("k", "v")}
    if draft == "self":
        vk, vv = _lane_views(tcache, table, kind, ROUND_POS)
        dcache["k"][:, 0], dcache["v"][:, 0] = vk[:, 0], vv[:, 0]
    tok = rng.integers(0, 256, b).astype(np.int32)
    return tcache, table, dcache, tok


def _run_jax_round(st, kind, draft, tcache, table, dcache, tok):
    jdp, jdc = ((st["jparams"], st["jcfg"]) if draft == "self"
                else (st["jdparams"], st["jdcfg"]))
    fn = JSP.make_spec_round_fn(st["jcfg"], jdc, K, paged=kind != "contig",
                                quant=kind == "int8")
    tc = {k: jnp.asarray(v) for k, v in tcache.items()}
    tc["pos"] = jnp.asarray(ROUND_POS)
    dc = {k: jnp.asarray(v) for k, v in dcache.items()}
    dc["pos"] = jnp.asarray(ROUND_POS)
    lead = (jnp.asarray(table),) if table is not None else ()
    b = len(tok)
    out = fn(st["jparams"], jdp, tc, dc, *lead, jnp.asarray(tok),
             jnp.zeros((b,), jnp.float32), jnp.zeros((b, 2), jnp.uint32),
             jnp.asarray(ROUND_ACTIVE))
    return jax.device_get(out)


def _run_port_round(st, kind, draft, tcache, table, dcache, tok):
    dm, dc_cfg = ((st["model"], st["cfg"]) if draft == "self"
                  else (st["dmodel"], st["dcfg"]))
    fn = SP.make_spec_round_fn(st["cfg"], dc_cfg, K, quant=kind == "int8")
    tc = {k: torch.as_tensor(v.copy()) for k, v in tcache.items()}
    tc["pos"] = torch.as_tensor(ROUND_POS)
    dc = {k: torch.as_tensor(v.copy()) for k, v in dcache.items()}
    dc["pos"] = torch.as_tensor(ROUND_POS)
    b = len(tok)
    with torch.inference_mode():
        tok2, committed, n_commit = fn(
            st["model"], dm, tc, dc, torch.as_tensor(tok),
            torch.zeros(b), torch.arange(b, dtype=torch.int64),
            torch.as_tensor(ROUND_ACTIVE),
            table=torch.as_tensor(table) if table is not None else None)
    return tc, dc, tok2, committed, n_commit


def _assert_codes_close(got, want, what):
    """int8 codes within ±1: an f32 last bit may move a value across a
    code midpoint (ROADMAP.md Queue C, known differences)."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, f"{what}: codes differ by {diff.max()}"


class TestLaneMask:
    @pytest.mark.parametrize("kv_quant", ["none", "int8"])
    def test_lane_mask_equals_jax(self, setup, kv_quant):
        """[3, 4] rows with lane 1 masked: the logits and pools equal
        JAX's; on the int8 pool the masked lane's tail row is untouched
        and no block of it commits (its rows went to the trash tail),
        while the bf16 pool, as JAX's, has no mask to honour."""
        st = setup
        rng = np.random.default_rng(5)
        kind = "int8" if kv_quant == "int8" else "paged"
        cache, table = _target_cache(st["cfg"], st["jcfg"], kind, 3, 4, rng)
        toks = rng.integers(0, 256, (3, 4)).astype(np.int32)
        pos = np.asarray([5, 6, 9], np.int32)     # lane 1 would complete
        mask = np.asarray([True, False, True])
        quant = kv_quant == "int8"
        jl, jc = JSP._multi_forward_paged(
            st["jcfg"], st["jparams"], jnp.asarray(toks),
            dict({k: jnp.asarray(v) for k, v in cache.items()},
                 pos=jnp.asarray(pos)), jnp.asarray(table), quant=quant,
            lane_mask=jnp.asarray(mask))
        tcache = {k: torch.as_tensor(v.copy()) for k, v in cache.items()}
        with torch.inference_mode():
            tl, tc = SP._multi_forward_paged(
                st["cfg"], st["model"], torch.as_tensor(toks),
                dict(tcache, pos=torch.as_tensor(pos)),
                torch.as_tensor(table), quant=quant,
                lane_mask=torch.as_tensor(mask))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_array_equal(tc["pos"].numpy(),
                                      np.asarray(jc["pos"]))
        if not quant:
            for key in ("k", "v"):
                np.testing.assert_allclose(tc[key].numpy(),
                                           np.asarray(jc[key]), rtol=TOL,
                                           atol=TOL)
            return
        done = [table[0, 0], table[2, 1]]        # lanes 0 and 2 complete
        for key in ("k", "v"):
            _assert_codes_close(tc[key][:, done].numpy(),
                                np.asarray(jc[key])[:, done], key)
            # the masked lane committed nothing: its blocks as they were
            np.testing.assert_array_equal(tc[key][:, table[1]].numpy(),
                                          cache[key][:, table[1]])
            np.testing.assert_array_equal(tc[key + "t"][:, 1].numpy(),
                                          cache[key + "t"][:, 1])
            np.testing.assert_array_equal(np.asarray(jc[key + "t"])[:, 1],
                                          cache[key + "t"][:, 1])
            # lane 0's and lane 2's live tail rows
            jt = np.asarray(jc[key + "t"])
            np.testing.assert_allclose(tc[key + "t"][:, 0, :, :1].numpy(),
                                       jt[:, 0, :, :1], rtol=TOL, atol=TOL)
            np.testing.assert_allclose(tc[key + "t"][:, 2, :, :5].numpy(),
                                       jt[:, 2, :, :5], rtol=TOL, atol=TOL)


class TestSpecRound:
    @pytest.mark.parametrize("draft", ["self", "random"])
    @pytest.mark.parametrize("kind", ["contig", "paged", "int8"])
    def test_round_equals_jax(self, setup, kind, draft):
        """One greedy round: tokens, committed rows, counts and both
        positions exactly; the caches' written rows within 1e-5 (int8:
        completed blocks' codes within ±1, their scales, and the tails'
        rows below each lane's new position)."""
        st = setup
        tcache, table, dcache, tok = _round_inputs(st, kind, draft, seed=11)
        jtc, jdc, jtok, jcom, jn = _run_jax_round(st, kind, draft, tcache,
                                                  table, dcache, tok)
        tc, dc, ttok, tcom, tn = _run_port_round(st, kind, draft, tcache,
                                                 table, dcache, tok)
        np.testing.assert_array_equal(tn.numpy(), jn)
        np.testing.assert_array_equal(tcom.numpy(), jcom)
        np.testing.assert_array_equal(ttok.numpy(), jtok)
        np.testing.assert_array_equal(tc["pos"].numpy(), jtc["pos"])
        np.testing.assert_array_equal(dc["pos"].numpy(), jdc["pos"])
        if draft == "self":
            assert int(tn[0]) == K + 1       # every draft accepted
        else:
            assert list(tn.numpy()[:2]) == [1, 1]
        assert int(tn[2]) == 0 and int(tc["pos"][2]) == 0
        # the draft ring: every row the ticks wrote, all lanes
        for key in ("k", "v"):
            np.testing.assert_allclose(dc[key].numpy(), jdc[key], rtol=TOL,
                                       atol=TOL)
        if kind == "contig":
            for key in ("k", "v"):
                np.testing.assert_allclose(tc[key].numpy(), jtc[key],
                                           rtol=TOL, atol=TOL)
            return
        if kind == "paged":
            real = list(range(1, tc["k"].shape[1]))    # block 0 is trash
            for key in ("k", "v"):
                np.testing.assert_allclose(tc[key][:, real].numpy(),
                                           jtc[key][:, real], rtol=TOL,
                                           atol=TOL)
            return
        real = list(range(1, tc["k"].shape[1]))
        for key in ("k", "v"):
            _assert_codes_close(tc[key][:, real].numpy(), jtc[key][:, real],
                                key)
            np.testing.assert_allclose(tc[key + "s"][:, real].numpy(),
                                       jtc[key + "s"][:, real], rtol=TOL,
                                       atol=0)
            for lane in range(3):
                p = int(tc["pos"][lane])
                if not ROUND_ACTIVE[lane]:
                    # an inactive lane's tail is untouched in both
                    np.testing.assert_array_equal(
                        tc[key + "t"][:, lane].numpy(),
                        tcache[key + "t"][:, lane])
                    continue
                rows = slice(0, p % BS)
                scale = float(jtc[key + "s"].max())
                np.testing.assert_allclose(
                    tc[key + "t"][:, lane, :, rows].numpy(),
                    jtc[key + "t"][:, lane, :, rows], rtol=TOL,
                    atol=1.01 * scale)
        if draft == "random":
            # lane 1 rewound to 7 inside block 0, which the verify
            # completed: its tail is the block's dequantized codes
            blk = table[1, 0]
            for key in ("k", "v"):
                deq = (tc[key][:, blk].float()
                       * tc[key + "s"][:, blk][..., None, None])
                np.testing.assert_array_equal(tc[key + "t"][:, 1].numpy(),
                                              deq.numpy())

    @pytest.mark.parametrize("kind", ["contig", "int8"])
    def test_megastep_equals_jax(self, setup, kind):
        """Three fused greedy rounds (``make_spec_megastep``) against
        JAX's: lane 0 self-drafts under a budget that runs out in the
        second round, lane 1 rejects every round with an eos it emits,
        lane 2 sits out — tokens, raw and consumed counts, positions and
        the lane tokens equal."""
        st = setup
        tcache, table, dcache, tok = _round_inputs(st, kind, "self", seed=13)
        b, n = 3, 3
        paged = kind != "contig"
        jfn = JSP.make_spec_megastep(st["jcfg"], st["jcfg"], K, n,
                                     paged=paged, quant=kind == "int8")
        tc = {k: jnp.asarray(v) for k, v in tcache.items()}
        tc["pos"] = jnp.asarray(ROUND_POS)
        dc = {k: jnp.asarray(v) for k, v in dcache.items()}
        dc["pos"] = jnp.asarray(ROUND_POS)
        lead = (jnp.asarray(table),) if paged else ()
        eos = np.asarray([-1, -1, -1], np.int32)
        left = np.asarray([6, 40, 40], np.int32)
        steps = np.asarray([n, n, n], np.int32)
        jout = jax.device_get(jfn(
            st["jparams"], st["jparams"], tc, dc, *lead, jnp.asarray(tok),
            jnp.zeros((b,), jnp.float32), jnp.zeros((b, 2), jnp.uint32),
            jnp.asarray(ROUND_ACTIVE), jnp.asarray(eos), jnp.asarray(left),
            jnp.asarray(steps)))
        jtc, jdc, jtok, jcom, jraw, jcounts = jout
        # an eos lane 1 emits in round 2: the JAX run's own token
        eos[1] = int(jcom[1, 0, 1])
        jout = jax.device_get(jfn(
            st["jparams"], st["jparams"],
            dict({k: jnp.asarray(v) for k, v in tcache.items()},
                 pos=jnp.asarray(ROUND_POS)),
            dict({k: jnp.asarray(v) for k, v in dcache.items()},
                 pos=jnp.asarray(ROUND_POS)), *lead, jnp.asarray(tok),
            jnp.zeros((b,), jnp.float32), jnp.zeros((b, 2), jnp.uint32),
            jnp.asarray(ROUND_ACTIVE), jnp.asarray(eos), jnp.asarray(left),
            jnp.asarray(steps)))
        jtc, jdc, jtok, jcom, jraw, jcounts = jout
        fn = SP.make_spec_megastep(st["cfg"], st["cfg"], K, n,
                                   quant=kind == "int8")
        ttc = {k: torch.as_tensor(v.copy()) for k, v in tcache.items()}
        ttc["pos"] = torch.as_tensor(ROUND_POS)
        tdc = {k: torch.as_tensor(v.copy()) for k, v in dcache.items()}
        tdc["pos"] = torch.as_tensor(ROUND_POS)
        with torch.inference_mode():
            ttok, tcom, traw, tcounts = fn(
                st["model"], st["model"], ttc, tdc, torch.as_tensor(tok),
                torch.zeros(b), torch.arange(b, dtype=torch.int64),
                torch.as_tensor(ROUND_ACTIVE), torch.as_tensor(eos),
                torch.as_tensor(left), torch.as_tensor(steps),
                table=torch.as_tensor(table) if paged else None)
        np.testing.assert_array_equal(traw.numpy(), jraw)
        # the rows each round committed (a dead lane's free-running rows
        # are garbage nobody reads, in either package)
        rows = np.arange(K + 1)[None, :, None] < jraw[:, None, :]
        np.testing.assert_array_equal(np.where(rows, tcom.numpy(), -1),
                                      np.where(rows, jcom, -1))
        np.testing.assert_array_equal(tcounts.numpy(), jcounts)
        np.testing.assert_array_equal(ttok.numpy(), jtok)
        np.testing.assert_array_equal(ttc["pos"].numpy(), jtc["pos"])
        np.testing.assert_array_equal(tdc["pos"].numpy(), jdc["pos"])
        # lane 0 accepts every draft until its budget runs out; lane 1's
        # consumed tokens end at its eos; lane 2 never commits
        assert int(traw[0, 0]) == K + 1 and int(tcounts[:, 0].sum()) == 6
        got = [int(t) for r in range(n)
               for t in tcom[r, :int(tcounts[r, 1]), 1]]
        assert got[-1] == eos[1] and eos[1] not in got[:-1]
        assert int(traw[:, 2].sum()) == 0


# ---------------------------------------------------------------------------
# tests/test_speculative.py TestGreedyParity and TestSampled
# ---------------------------------------------------------------------------


class TestGreedyParity:
    @pytest.mark.parametrize("batch,k", [(1, 2), (2, 3), (2, 8)])
    def test_greedy_token_identical_to_generate(self, setup, batch, k):
        """A random draft rejects nearly everything, yet the output
        equals JAX ``generate`` token for token; its acceptance
        statistics equal JAX ``speculative_generate``'s."""
        st = setup
        p = _prompt(9, 7, batch)
        ref = _jax_generate(st, p, 12)
        out, stats = _spec(st, p, 12, spec_k=k, return_stats=True)
        np.testing.assert_array_equal(out.numpy(), ref)
        _, jstats = JSP.speculative_generate(
            st["jparams"], st["jdparams"], st["jcfg"], st["jdcfg"],
            jnp.asarray(p), max_new_tokens=12, spec_k=k, max_len=MAX_LEN,
            return_stats=True)
        assert stats == jstats

    def test_all_accept_rounds_self_draft(self, setup):
        st = setup
        p = _prompt(9, 7, 2)
        out, stats = _spec(st, p, 12, draft="self", spec_k=4,
                           return_stats=True)
        assert stats["accept_rate"] == 1.0
        assert stats["rounds"] == -(-(12 - 1) // 5)
        np.testing.assert_array_equal(out.numpy(), _jax_generate(st, p, 12))

    def test_all_reject_rounds_still_exact(self, setup):
        st = setup
        p = _prompt(9, 3)
        out, stats = _spec(st, p, 10, spec_k=3, return_stats=True)
        np.testing.assert_array_equal(out.numpy(), _jax_generate(st, p, 10))
        assert stats["accept_rate"] < 0.5
        assert stats["rounds"] >= 5

    def test_eos_mid_speculated_block(self, setup):
        st = setup
        p = _prompt(7, 3)
        ref = _jax_generate(st, p, 12)[0].tolist()
        eos = ref[7 + 6]
        want = _jax_generate(st, p, 12, eos_token=eos)
        out = _spec(st, p, 12, draft="self", spec_k=8, eos_token=eos)
        np.testing.assert_array_equal(out.numpy(), want)
        got = out[0].tolist()
        cut = got.index(eos, 7)
        assert all(t == eos for t in got[cut:])

    def test_max_new_one_and_capacity_validation(self, setup):
        st = setup
        p = _prompt(5, 2)
        out = _spec(st, p, 1, spec_k=4)
        np.testing.assert_array_equal(out.numpy(), _jax_generate(st, p, 1))
        with pytest.raises(ValueError, match="exceeds the cache"):
            _spec(st, p, MAX_LEN, spec_k=4)
        with pytest.raises(ValueError, match="spec_k"):
            _spec(st, p, 2, spec_k=0)
        # a RoPE table too short for the headroom fails clearly
        short = dataclasses.replace(st["cfg"], max_seq_len=MAX_LEN)
        with pytest.raises(ValueError, match="headroom"):
            SP.speculative_generate(
                st["model"], st["dmodel"], short, short.draft(),
                torch.as_tensor(p), max_new_tokens=MAX_LEN - 5, spec_k=4,
                max_len=MAX_LEN)


class TestSampled:
    def test_sampled_deterministic_per_seed_and_in_vocab(self, setup):
        st = setup
        p = _prompt(6, 4)
        kw = dict(spec_k=3, temperature=0.8)
        a = _spec(st, p, 8, seed=5, **kw)
        b = _spec(st, p, 8, seed=5, **kw)
        c = _spec(st, p, 8, seed=6, **kw)
        assert torch.equal(a, b)
        assert not torch.equal(a, c)        # overwhelmingly likely
        assert 0 <= int(a.min()) and int(a.max()) < st["cfg"].vocab_size

    def test_sampled_self_draft_accepts_everything(self, setup):
        """p == q makes min(1, p/q) = 1: every draft is accepted when
        draft and target are the same model."""
        _, stats = _spec(setup, _prompt(6, 4), 10, draft="self", spec_k=4,
                         temperature=0.7, seed=8, return_stats=True)
        assert stats["accept_rate"] == 1.0

    def test_streams_are_independent(self, setup):
        """The three round streams and stream 0 give different draws for
        the same (seed, position), and a stream's draws depend on the
        seed only through the lane's own seed."""
        seeds = torch.arange(6, dtype=torch.int64)
        pos = torch.full((6,), 9, dtype=torch.int32)
        draws = [X._uniform(X._stream(seeds, s) if s else seeds, pos, 16)
                 for s in range(4)]
        for i in range(4):
            for j in range(i + 1, 4):
                assert not torch.equal(draws[i], draws[j])
        # one lane's draws do not depend on its co-residents
        lone = X._uniform(X._stream(seeds[3:4], 2), pos[3:4], 16)
        assert torch.equal(lone[0], draws[2][3])


# ---------------------------------------------------------------------------
# the sampled rule's distribution
# ---------------------------------------------------------------------------


# chi-square at p = 1e-3: the target's softmax must not be rejected, the
# draft's must be (its p-value is below 1e-12 on these logits)
CHI2_P = 1e-3


@pytest.mark.parametrize("k", [1, 2])
def test_sampled_rule_keeps_the_target_distribution(k):
    """Fixed target and draft logits over a 12-token vocab, 4,000 lanes
    with seeds 0..3,999 at temperature 1: drafts drawn from the draft's
    stream, then :func:`spec_accept`.  The first committed token's
    frequencies match the target's softmax by a chi-square test at
    p = 1e-3, and the same test rejects the draft's softmax."""
    from scipy.stats import chisquare

    vocab, n = 12, 4000
    rng = np.random.default_rng(21)
    tl = torch.as_tensor(rng.standard_normal((k + 1, vocab)) * 1.5,
                         dtype=torch.float32)
    dl = torch.as_tensor(rng.standard_normal((k, vocab)) * 1.5,
                         dtype=torch.float32)
    seeds = torch.arange(n, dtype=torch.int64)
    temp = torch.ones(n)
    dpos = torch.full((n,), 30, dtype=torch.int32)
    drafts = []
    for i in range(k):
        drafts.append(X._sample_tokens(dl[i].expand(n, vocab), temp,
                                       X._stream(seeds, 1), dpos + i, None,
                                       None))
    drafts = torch.stack(drafts, dim=1)
    a, nxt, committed, n_commit = SP.spec_accept(
        tl.expand(n, k + 1, vocab), dl.expand(n, k, vocab), drafts, temp,
        seeds, dpos - 1, torch.ones(n, dtype=torch.bool))
    assert int(n_commit.min()) >= 1 and int(n_commit.max()) <= k + 1
    first = committed[0].numpy()
    counts = np.bincount(first, minlength=vocab)
    p = torch.softmax(tl[0].double(), -1).numpy()
    q = torch.softmax(dl[0].double(), -1).numpy()
    assert chisquare(counts, p * n).pvalue > CHI2_P
    assert chisquare(counts, q * n).pvalue < CHI2_P
    # the drafts themselves follow q (the draft's stream is a sampler)
    dcounts = np.bincount(drafts[:, 0].numpy(), minlength=vocab)
    assert chisquare(dcounts, q * n).pvalue > CHI2_P
