"""The torch package's int8 KV pool (SERVE_KV_QUANT=int8) held against
the JAX package's, on the same numpy inputs — the classes of
tests/test_kvquant.py:

- ``quantize_kv``/``dequantize_kv`` (infer/paged.py): codes and scales
  bit-equal to JAX, half-even ties and all-zero blocks included; the
  quantize -> dequantize -> quantize fixed point; error <= scale / 2;
- the int8 pool's paged attention (ops/decode_attention.py, its plain
  version on CPU tensors) against the JAX pallas kernel
  ``_paged_kernel_quant`` in interpret mode (the CUDA kernel against
  its plain version on the card is in tests/test_torch_paged_attention.py,
  which the card's machine can import: it has no flax);
- the device half on the same converted ``tiny`` params:
  ``scatter_prefill_blocks_quant``, ``paged_prefill(quant=True)``, the
  block-crossing suffix forward and 24 ring ticks of
  ``paged_ring_forward(quant=True, active=...)``; the logit bound
  against the bf16 pool;
- the ring (``ContinuousBatcher(kv_quant="int8")``: cold, full-prefix
  and mid-block CoW admissions equal JAX ``decode.generate``) and the
  server (``SERVE_KV_QUANT`` mapping, one HTTP request).
"""

import json
import threading
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_operator_tpu.infer import decode as JD
from paddle_operator_tpu.infer import paged as JPG
from paddle_operator_tpu.infer import speculative as JSP
from paddle_operator_tpu.models.llama import make_model as jax_make_model
from paddle_operator_tpu.ops import decode_attention as JDA
from paddle_operator_tpu_torch.convert import params_from_jax
from paddle_operator_tpu_torch.infer import decode as D
from paddle_operator_tpu_torch.infer import paged as PG
from paddle_operator_tpu_torch.infer import serve as S
from paddle_operator_tpu_torch.infer import speculative as SP
from paddle_operator_tpu_torch.infer.batcher import ContinuousBatcher
from paddle_operator_tpu_torch.models.llama import make_model
from paddle_operator_tpu_torch.ops import decode_attention as TDA

MAX_LEN = 64
BS = 8
TOL = 1e-5        # f32, same inputs, same op order up to summation
LOGIT_TOL = 1e-4  # f32 logits after a few layers of matmuls


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

    return jcfg, jparams, model, cfg, ref


def _prompt(s, seed):
    return np.random.default_rng(seed).integers(0, 256, s).astype(
        np.int32).tolist()


def _scrambled_table(b, m, n, seed):
    ids = np.random.default_rng(seed).permutation(np.arange(1, n))[:b * m]
    return ids.reshape(b, m).astype(np.int32)


def _tie_block(d=16):
    """A [BS, D] block whose absmax is 127 (scale exactly 1.0) holding
    values at code midpoints: round-half-even decides their codes."""
    x = np.zeros((BS, d), np.float32)
    x[0, 0] = 127.0
    ties = np.asarray([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5],
                      np.float32)
    x[1, :8] = ties
    x[2, :6] = ties[:6] + 2.0
    return x


# ---------------------------------------------------------------------------
# quantize_kv / dequantize_kv
# ---------------------------------------------------------------------------


class TestQuantizeKV:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_codes_and_scales_bit_equal_to_jax(self, dtype):
        x = np.random.default_rng(3).standard_normal(
            (2, 1, 3, BS, 16)).astype(np.float32) * 3
        x[0, 0, 1] = 0.0                       # an all-zero block
        x[1, 0, 2] = _tie_block()
        jx = jnp.asarray(x, getattr(jnp, dtype))
        tx = torch.as_tensor(x).to(getattr(torch, dtype))
        jc, js = JPG.quantize_kv(jx)
        tc, ts = PG.quantize_kv(tx)
        assert tc.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        assert ts[0, 0, 1] == 1.0 and not tc[0, 0, 1].any()
        # the ties round half to even
        assert tc[1, 0, 2, 1, :8].tolist() == [0, 2, 2, 0, -2, -2, 126, -126]
        assert tc[1, 0, 2, 2, :6].tolist() == [2, 4, 4, 2, 0, 0]
        for out in ("float32", "bfloat16"):
            np.testing.assert_array_equal(
                PG.dequantize_kv(tc, ts, getattr(torch, out)).float().numpy(),
                np.asarray(JPG.dequantize_kv(jc, js, getattr(jnp, out)),
                           np.float32))

    def test_quantize_dequantize_fixed_point(self):
        x = torch.as_tensor(np.random.default_rng(4).standard_normal(
            (2, 1, 2, BS, 16)).astype(np.float32))
        codes, scale = PG.quantize_kv(x)
        deq = PG.dequantize_kv(codes, scale, torch.float32)
        codes2, scale2 = PG.quantize_kv(deq)
        assert torch.equal(codes, codes2) and torch.equal(scale, scale2)
        assert torch.equal(deq, PG.dequantize_kv(codes2, scale2,
                                                 torch.float32))

    def test_error_within_half_a_step(self):
        x = torch.as_tensor(np.random.default_rng(5).standard_normal(
            (1, 1, 2, BS, 16)).astype(np.float32))
        codes, scale = PG.quantize_kv(x)
        err = (PG.dequantize_kv(codes, scale, torch.float32) - x).abs()
        assert bool((err <= scale[..., None, None] / 2 + 1e-7).all())


# ---------------------------------------------------------------------------
# The int8 pool's paged attention
# ---------------------------------------------------------------------------

# lengths {0, 1, bs-1, bs, bs+1, full, a non-multiple}
LENS = [0, 1, BS - 1, BS, BS + 1, 4 * BS, 19]


def _quant_case(b, hq, hkv, d, m, seed, layers=None):
    """Random int8 codes, positive scales and staging tails under a
    scrambled block map.  The pool's frontier blocks hold codes
    unrelated to the tails, so reading the pool there changes the
    output."""
    rng = np.random.default_rng(seed)
    n = b * m + 3
    lead = (layers,) if layers else ()
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    kp = rng.integers(-127, 128, lead + (n, hkv, BS, d)).astype(np.int8)
    vp = rng.integers(-127, 128, lead + (n, hkv, BS, d)).astype(np.int8)
    ks = (rng.random(lead + (n, hkv)) * 0.05 + 0.01).astype(np.float32)
    vs = (rng.random(lead + (n, hkv)) * 0.05 + 0.01).astype(np.float32)
    kt = rng.standard_normal(lead + (b + 1, hkv, BS, d)).astype(np.float32)
    vt = rng.standard_normal(lead + (b + 1, hkv, BS, d)).astype(np.float32)
    table = _scrambled_table(b, m, n, seed + 1)
    return q, kp, vp, ks, vs, kt, vt, table


def _jax_quant(q, kp, vp, ks, vs, kt, vt, table, lens, layer=None):
    kw = {} if layer is None else {"layer": jnp.asarray(layer)}
    return np.asarray(JDA.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(lens, jnp.int32), interpret=True,
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs),
        k_tail=jnp.asarray(kt), v_tail=jnp.asarray(vt), **kw))


def _port_quant(q, kp, vp, ks, vs, kt, vt, table, lens, layer=None):
    t = torch.as_tensor
    return TDA.paged_decode_attention(
        t(q), t(kp), t(vp), t(table), t(np.asarray(lens, np.int32)),
        layer=layer, k_scale=t(ks), v_scale=t(vs), k_tail=t(kt),
        v_tail=t(vt)).numpy()


class TestQuantKernel:
    @pytest.mark.parametrize("n_rep", [1, 2])
    def test_plain_matches_jax_interpret_kernel(self, n_rep):
        q, kp, vp, ks, vs, kt, vt, table = _quant_case(
            len(LENS), 2 * n_rep, 2, 16, 4, seed=10 + n_rep)
        got = _port_quant(q, kp, vp, ks, vs, kt, vt, table, LENS)
        want = _jax_quant(q, kp, vp, ks, vs, kt, vt, table, LENS)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        assert not got[0].any()                # length 0: zeros
        # the frontier block comes from the tail: a reader of the
        # pool's codes there would give another answer
        lanes = [i for i, n in enumerate(LENS) if n]
        kt_pool, vt_pool = kt.copy(), vt.copy()
        for i in lanes:
            blk = table[i, (LENS[i] - 1) // BS]
            kt_pool[i] = kp[blk].astype(np.float32) * ks[blk][:, None, None]
            vt_pool[i] = vp[blk].astype(np.float32) * vs[blk][:, None, None]
        wrong = _port_quant(q, kp, vp, ks, vs, kt_pool, vt_pool, table,
                            LENS)
        assert np.abs(wrong[lanes] - got[lanes]).max(axis=(1, 2)).min() \
            > 1e-3

    def test_stacked_layers_with_their_own_scales_and_tails(self):
        q, kp, vp, ks, vs, kt, vt, table = _quant_case(
            len(LENS), 4, 2, 16, 4, seed=20, layers=2)
        ks[1] *= 2.0
        vs[1] *= 0.5
        kt[1] = -kt[1]
        outs = []
        for li in range(2):
            got = _port_quant(q, kp, vp, ks, vs, kt, vt, table, LENS,
                              layer=li)
            want = _jax_quant(q, kp, vp, ks, vs, kt, vt, table, LENS,
                              layer=li)
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                       err_msg=f"layer {li}")
            unstacked = _port_quant(q, kp[li], vp[li], ks[li], vs[li],
                                    kt[li], vt[li], table, LENS)
            np.testing.assert_array_equal(got, unstacked)
            outs.append(got)
        assert np.abs(outs[0] - outs[1]).max() > 1e-3

    def test_partial_operands_raise(self):
        q, kp, vp, ks, vs, kt, vt, table = _quant_case(2, 2, 2, 16, 2, 30)
        t = torch.as_tensor
        for drop in ("k_scale", "v_scale", "k_tail", "v_tail"):
            kw = {"k_scale": t(ks), "v_scale": t(vs), "k_tail": t(kt),
                  "v_tail": t(vt)}
            kw.pop(drop)
            with pytest.raises(ValueError, match="together"):
                TDA.paged_decode_attention(t(q), t(kp), t(vp), t(table),
                                           t(np.asarray([3, 9], np.int32)),
                                           **kw)

    def test_operand_shapes_checked(self):
        q, kp, vp, ks, vs, kt, vt, table = _quant_case(2, 2, 2, 16, 2, 31)
        t = torch.as_tensor
        lens = t(np.asarray([3, 9], np.int32))
        with pytest.raises(ValueError, match="scales"):
            TDA.paged_decode_attention(t(q), t(kp), t(vp), t(table), lens,
                                       k_scale=t(ks[:-1]), v_scale=t(vs),
                                       k_tail=t(kt), v_tail=t(vt))
        with pytest.raises(ValueError, match="tails"):
            TDA.paged_decode_attention(t(q), t(kp), t(vp), t(table), lens,
                                       k_scale=t(ks), v_scale=t(vs),
                                       k_tail=t(kt[:1]), v_tail=t(vt[:1]))

    def test_cuda_tensor_never_falls_back(self, monkeypatch):
        """The kernel input checks run for a CUDA tensor (here: faked
        device) and nothing reaches the plain version."""
        q, kp, vp, ks, vs, kt, vt, table = _quant_case(2, 2, 2, 16, 2, 32)
        t = torch.as_tensor
        monkeypatch.setattr(TDA, "paged_decode_attention_quant_reference",
                            lambda *a, **k: pytest.fail("plain version"))
        with pytest.raises(ValueError, match="CUDA tensors only"):
            TDA._check_kernel_inputs(
                t(q), t(kp), t(vp), t(np.asarray([3, 9], np.int32)),
                table=t(table), quant=(t(ks), t(vs), t(kt), t(vt)),
                fn="paged_decode_attention")


# ---------------------------------------------------------------------------
# Device half: prefill, suffix forward, ring ticks
# ---------------------------------------------------------------------------


def _jax_cache(cache):
    return {k: jnp.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in cache.items()}


def _port_cache(cache):
    return {k: torch.as_tensor(np.array(v)) for k, v in cache.items()}


def _assert_codes_close(got, want, what):
    """Codes within ±1: upstream f32 rounding may move one value across
    a code midpoint."""
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, f"{what}: codes differ by {diff.max()}"


class TestQuantDevice:
    def test_scatter_prefill_blocks_quant(self):
        rng = np.random.default_rng(50)
        rows = rng.standard_normal((2, 1, 2, 3 * BS, 16)).astype(np.float32)
        n = 7
        pool = np.zeros((2, n, 2, BS, 16), np.int8)
        scales = np.ones((2, n, 2), np.float32)
        row = np.asarray([5, 2, 6, 0], np.int32)
        jp, js = JDA.scatter_prefill_blocks_quant(
            jnp.asarray(pool), jnp.asarray(scales), jnp.asarray(rows),
            jnp.asarray(row), BS)
        tp, ts = TDA.scatter_prefill_blocks_quant(
            torch.as_tensor(pool.copy()), torch.as_tensor(scales.copy()),
            torch.as_tensor(rows), torch.as_tensor(row), BS)
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))

    @pytest.mark.parametrize("n", [16, 19])
    def test_paged_prefill_quant(self, setup, n):
        """Whole blocks quantize into the pool, the frontier block's
        rows come back as tails — a 16-token prompt (two whole blocks)
        clamps the tail slice back to its last block, as JAX does."""
        jcfg, jparams, model, cfg, _ = setup
        m = 4
        total = 2 * m + 1
        row = _scrambled_table(1, m, total, seed=51)[0]
        toks = np.asarray([_prompt(n, 52)], np.int32)
        padded = np.zeros((1, -(-n // BS) * BS), np.int32)
        padded[:, :n] = toks
        jcache = JPG.init_paged_cache(jcfg, 2, total, BS, quant="int8")
        jl, jc, jtk, jtv = JD.paged_prefill(
            jparams, jcfg, jnp.asarray(padded), jcache, jnp.asarray(row),
            block_size=BS, quant=True, prompt_len=n)
        cache = PG.init_paged_cache(cfg, 2, total, BS, device="cpu",
                                    quant="int8")
        with torch.inference_mode():
            tl, tc, ttk, ttv = D.paged_prefill(
                model, cfg, torch.as_tensor(toks), cache,
                torch.as_tensor(row), block_size=BS, quant=True,
                prompt_len=n)
        np.testing.assert_allclose(tl[0, n - 1].numpy(),
                                   np.asarray(jl)[0, n - 1],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        full = row[:n // BS]
        for key in ("k", "v"):
            _assert_codes_close(tc[key][:, full].numpy(),
                                np.asarray(jc[key])[:, full], key)
            np.testing.assert_allclose(tc[key + "s"][:, full].numpy(),
                                       np.asarray(jc[key + "s"])[:, full],
                                       rtol=TOL, atol=0)
        # the tail's live rows: the frontier block's prompt rows (a whole
        # block when the slice clamped back)
        live = BS if n % BS == 0 else n % BS
        for got, want in ((ttk, jtk), (ttv, jtv)):
            assert tuple(got.shape) == tuple(want.shape)
            np.testing.assert_allclose(got[:, :, :, :live].numpy(),
                                       np.asarray(want)[:, :, :, :live],
                                       rtol=TOL, atol=TOL)

    def test_suffix_forward_crosses_blocks(self, setup):
        """The prefix-hit suffix forward over the int8 pool: spans that
        complete a block commit it (codes + scale) before the next
        block's rows reuse the tail, pads write nothing, and the
        attention reads the committed blocks as codes."""
        jcfg, jparams, model, cfg, _ = setup
        m = 4
        total = 2 * m + 1
        rng = np.random.default_rng(53)
        table = _scrambled_table(2, m, total, seed=54)
        jcache = JPG.init_paged_cache(jcfg, 2, total, BS, quant="int8")
        cache = {k: np.array(v) for k, v in jcache.items()}
        for key in ("k", "v"):
            cache[key] = rng.integers(-127, 128, cache[key].shape).astype(
                np.int8)
            cache[key + "s"] = (rng.random(cache[key + "s"].shape) * 0.02
                                + 0.005).astype(np.float32)
            cache[key + "t"] = (rng.standard_normal(cache[key + "t"].shape)
                                * 0.5).astype(np.float32)
        toks = rng.integers(0, 256, (2, 12)).astype(np.int32)
        pos = np.asarray([11, 3], np.int32)
        limit = np.asarray([20, 9], np.int32)   # lane 1: 6 real rows
        jcache = dict(_jax_cache(cache), pos=jnp.asarray(pos))
        jl, jc = JSP._multi_forward_paged(
            jcfg, jparams, jnp.asarray(toks), jcache, jnp.asarray(table),
            limit=jnp.asarray(limit), quant=True)
        tcache = dict(_port_cache(cache), pos=torch.as_tensor(pos))
        with torch.inference_mode():
            tl, tc = SP._multi_forward_paged(
                cfg, model, torch.as_tensor(toks), tcache,
                torch.as_tensor(table), limit=torch.as_tensor(limit),
                quant=True)
        # real rows' logits (pad rows attend stale rows that differ)
        for lane, n_real in ((0, 9), (1, 6)):
            np.testing.assert_allclose(tl[lane, :n_real].numpy(),
                                       np.asarray(jl)[lane, :n_real],
                                       rtol=LOGIT_TOL, atol=LOGIT_TOL)
        # committed blocks: lane 0 block 1 (rows 8..15), lane 1 block 0
        done = [table[0, 1], table[1, 0]]
        for key in ("k", "v"):
            _assert_codes_close(tc[key][:, done].numpy(),
                                np.asarray(jc[key])[:, done], key)
            np.testing.assert_allclose(tc[key + "s"][:, done].numpy(),
                                       np.asarray(jc[key + "s"])[:, done],
                                       rtol=TOL, atol=0)
            untouched = sorted(set(range(1, total)) - set(done))
            np.testing.assert_array_equal(tc[key][:, untouched].numpy(),
                                          cache[key][:, untouched])
            # the tails' live rows: lane 0 rows 16..19, lane 1 row 8
            jt = np.asarray(jc[key + "t"])
            np.testing.assert_allclose(tc[key + "t"][:, 0, :, :4].numpy(),
                                       jt[:, 0, :, :4], rtol=TOL, atol=TOL)
            np.testing.assert_allclose(tc[key + "t"][:, 1, :, :1].numpy(),
                                       jt[:, 1, :, :1], rtol=TOL, atol=TOL)

    def test_ring_ticks_match_jax(self, setup):
        """24 ticks of the int8 ring step (three block completions) from
        one prefilled lane, beside an inactive lane whose tail holds
        live rows: per-tick logits equal JAX's, the completed blocks'
        codes and scales too, and the inactive lane's tail is never
        touched (its rows go to the trash tail)."""
        jcfg, jparams, model, cfg, _ = setup
        m = MAX_LEN // BS
        total = 2 * m + 1
        table = np.zeros((2, m), np.int32)
        table[0] = _scrambled_table(1, m, total, seed=55)[0]
        n = 19
        toks = np.asarray([_prompt(n, 56)], np.int32)
        padded = np.zeros((1, 24), np.int32)
        padded[:, :n] = toks
        jcache = JPG.init_paged_cache(jcfg, 2, total, BS, quant="int8")
        jl, jcache, tk, tv = JD.paged_prefill(
            jparams, jcfg, jnp.asarray(padded), jcache,
            jnp.asarray(table[0]), block_size=BS, quant=True, prompt_len=n)
        live = np.random.default_rng(57).standard_normal(
            (jcfg.n_layers, jcfg.n_kv_heads, BS, jcfg.head_dim)).astype(
            np.float32)
        jcache["kt"] = jcache["kt"].at[:, 0].set(tk[:, 0]).at[:, 1].set(live)
        jcache["vt"] = jcache["vt"].at[:, 0].set(tv[:, 0]).at[:, 1].set(live)
        jcache["pos"] = jnp.asarray([n, 0], jnp.int32)
        tcache = _port_cache(jcache)
        active = np.asarray([True, False])
        jstep = jax.jit(lambda c, t: JPG.paged_ring_forward(
            jcfg, jparams, t, c, jnp.asarray(table), quant=True,
            active=jnp.asarray(active)))
        tok = int(np.asarray(jl)[0, n - 1].argmax())
        for step in range(24):
            tt = np.asarray([tok, 0], np.int32)
            jlog, jcache = jstep(jcache, jnp.asarray(tt))
            jcache["pos"] = jnp.where(jnp.asarray(active), jcache["pos"], 0)
            with torch.inference_mode():
                tlog, tcache = PG.paged_ring_forward(
                    cfg, model, torch.as_tensor(tt), tcache,
                    torch.as_tensor(table), quant=True,
                    active=torch.as_tensor(active))
            tcache["pos"] = torch.where(torch.as_tensor(active),
                                        tcache["pos"], 0)
            np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                                       rtol=LOGIT_TOL, atol=LOGIT_TOL,
                                       err_msg=f"tick {step}")
            tok = int(np.asarray(jlog)[0].argmax())
        assert tcache["pos"].tolist() == [n + 24, 0]
        done = table[0, 2:5]                   # blocks 2, 3, 4 completed
        for key in ("k", "v"):
            _assert_codes_close(tcache[key][:, done].numpy(),
                                np.asarray(jcache[key])[:, done], key)
            np.testing.assert_allclose(
                tcache[key + "s"][:, done].numpy(),
                np.asarray(jcache[key + "s"])[:, done], rtol=TOL, atol=0)
            np.testing.assert_array_equal(tcache[key + "t"][:, 1].numpy(),
                                          live)
            # lane 0's tail: rows 40..42 of block 5
            np.testing.assert_allclose(
                tcache[key + "t"][:, 0, :, :3].numpy(),
                np.asarray(jcache[key + "t"])[:, 0, :, :3],
                rtol=TOL, atol=TOL)

    def test_logits_within_bound_of_bf16_pool(self, setup):
        """Mirrors tests/test_kvquant.py TestLogitBound on the port:
        per-step logits of the int8 pool against the port's bf16 pool,
        same prompt, over three block completions."""
        _, _, model, cfg, _ = setup
        n = 19
        total = MAX_LEN // BS + 1
        table = torch.arange(1, total, dtype=torch.int32)[None, :]
        prompt = torch.as_tensor([_prompt(n, 58)], dtype=torch.int32)
        caches, first = {}, {}
        with torch.inference_mode():
            for quant in ("none", "int8"):
                cache = PG.init_paged_cache(cfg, 1, total, BS, device="cpu",
                                            quant=quant)
                if quant == "int8":
                    logits, cache, tk, tv = D.paged_prefill(
                        model, cfg, prompt, cache, table[0], block_size=BS,
                        quant=True, prompt_len=n)
                    cache["kt"][:, 0], cache["vt"][:, 0] = tk[:, 0], tv[:, 0]
                else:
                    logits, cache = D.paged_prefill(model, cfg, prompt,
                                                    cache, table[0],
                                                    block_size=BS)
                cache["pos"] = torch.tensor([n], dtype=torch.int32)
                caches[quant], first[quant] = cache, logits[0, n - 1]
            worst = float((first["int8"] - first["none"]).abs().max())
            tok = torch.tensor([int(first["none"].argmax())],
                               dtype=torch.int32)
            for _ in range(24):
                out = {}
                for quant in caches:
                    out[quant], caches[quant] = PG.paged_ring_forward(
                        cfg, model, tok, caches[quant], table,
                        quant=quant == "int8")
                worst = max(worst, float((out["int8"] - out["none"])
                                         .abs().max()))
                tok = out["none"].argmax(-1).to(torch.int32)
        assert 0 < worst <= 0.15, worst

    def test_block_copier_and_tail_init(self):
        rng = np.random.default_rng(59)
        k = torch.as_tensor(rng.integers(-127, 128, (2, 5, 2, BS, 16))
                            .astype(np.int8))
        v = k.flip(0).clone()
        ks = torch.rand((2, 5, 2)) + 0.1
        vs = torch.rand((2, 5, 2)) + 0.1
        PG.make_block_copier()({"k": k, "v": v, "ks": ks, "vs": vs}, 3, 1)
        assert torch.equal(k[:, 1], k[:, 3]) and torch.equal(v[:, 1], v[:, 3])
        assert torch.equal(ks[:, 1], ks[:, 3]) and torch.equal(vs[:, 1],
                                                               vs[:, 3])
        kt = torch.zeros((2, 3, 2, BS, 16))
        vt = torch.zeros((2, 3, 2, BS, 16))
        PG.make_tail_init()({"k": k, "v": v, "ks": ks, "vs": vs, "kt": kt,
                             "vt": vt}, 2, 1)
        jkt, jvt = JPG.make_tail_init()(
            jnp.zeros((2, 3, 2, BS, 16)), jnp.zeros((2, 3, 2, BS, 16)),
            jnp.asarray(k.numpy()), jnp.asarray(ks.numpy()),
            jnp.asarray(v.numpy()), jnp.asarray(vs.numpy()), 2, 1)
        np.testing.assert_array_equal(kt.numpy(), np.asarray(jkt))
        np.testing.assert_array_equal(vt.numpy(), np.asarray(jvt))
        assert not kt[:, :2].any()


# ---------------------------------------------------------------------------
# The ring and the server
# ---------------------------------------------------------------------------


def _batcher(model, cfg, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("chunk_tokens", 4)
    kw.setdefault("prefill_buckets", (16, 32, MAX_LEN))
    kw.setdefault("paged", True)
    kw.setdefault("block_size", BS)
    kw.setdefault("kv_quant", "int8")
    return ContinuousBatcher(model, cfg, **kw)


class TestQuantRing:
    def test_quant_requires_paged(self, setup):
        _, _, model, cfg, _ = setup
        with pytest.raises(ValueError, match="paged"):
            _batcher(model, cfg, paged=False)

    def test_unknown_mode_refused(self, setup):
        _, _, model, cfg, _ = setup
        with pytest.raises(ValueError, match="kv_quant"):
            _batcher(model, cfg, kv_quant="int4")

    def test_bf16_pool_is_default(self, setup):
        _, _, model, cfg, _ = setup
        b = _batcher(model, cfg, kv_quant="none")
        try:
            assert b.kv_quant == "none" and "ks" not in b.cache
            assert b.cache["k"].dtype == cfg.dtype
            assert b.serving_status()["kvQuantMode"] == "none"
        finally:
            b.close()

    def test_cold_full_hit_and_mid_block_hit_match_jax(self, setup):
        """Cold admission, a full-prefix resubmission (a 1-token suffix)
        and a mid-block CoW hit (the tail seeded from the dequantized
        copy) all give JAX decode.generate's greedy tokens."""
        from paddle_operator_tpu.infer.executor import (
            RingExecutor as JaxExecutor,
        )

        jcfg, jparams, model, cfg, ref = setup
        # prompts on which int8 does not flip an argmax against the
        # exact pool (see test_ring_equals_jax_int8_ring_where_a_token_
        # flips for one where it does)
        b = _batcher(model, cfg)
        try:
            p = _prompt(16, 60)                 # two full blocks publish
            want = ref(p, 8)
            assert b.submit(p, max_new_tokens=8).result(timeout=120) == want
            cold_tokens = b.stats["prefill_tokens"]
            assert b.submit(p, max_new_tokens=8).result(timeout=120) == want
            assert b.stats["prefill_tokens"] - cold_tokens == 1
            shared = _prompt(24, 63)            # three full blocks
            assert b.submit(shared, max_new_tokens=8).result(
                timeout=120) == ref(shared, 8)
            cow = b.stats["cow_copies"]
            sub = shared[:20]                   # hit 19: mid-block
            assert b.submit(sub, max_new_tokens=8).result(
                timeout=120) == ref(sub, 8)
            assert b.stats["cow_copies"] > cow >= 1
            b.pool.check_invariant()
            st = b.serving_status()
            assert st["kvQuantMode"] == "int8"
            jex = JaxExecutor(jparams, jcfg, slots=2, max_len=MAX_LEN,
                              chunk_tokens=4,
                              prefill_buckets=(16, 32, MAX_LEN), paged=True,
                              block_size=BS, kv_quant="int8")
            assert st["kvPoolBytes"] == jex.pool_bytes()
        finally:
            b.close()


def test_ring_equals_jax_int8_ring_where_a_token_flips(setup):
    """int8-vs-exact token equality is not an invariant: on this prompt
    the quantization error flips a close argmax (in the JAX package's
    int8 ring as well).  The port's int8 ring still gives the JAX int8
    ring's tokens, cold and on a prefix hit."""
    from paddle_operator_tpu.infer.batcher import (
        ContinuousBatcher as JaxBatcher,
    )

    jcfg, jparams, model, cfg, ref = setup
    kw = dict(slots=2, max_len=MAX_LEN, chunk_tokens=4,
              prefill_buckets=(16, 32, MAX_LEN), paged=True, block_size=BS,
              kv_quant="int8")
    jb = JaxBatcher(jparams, jcfg, **kw)
    b = ContinuousBatcher(model, cfg, **kw)
    try:
        p = _prompt(24, 61)
        want = jb.submit(p, max_new_tokens=8).result(timeout=300)
        assert want != ref(p, 8)
        for _ in range(2):                     # cold, then a prefix hit
            assert b.submit(p, max_new_tokens=8).result(timeout=120) == want
    finally:
        b.close()
        jb.close()


def _post(url, body):
    req = urllib.request.Request(url + "/v1/generate",
                                 data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"},
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return r.status, json.loads(r.read())


class TestQuantServe:
    def test_env_implies_paged(self, capsys):
        kw = S.ring_kw_from_env({"SERVE_CONTINUOUS": "1",
                                 "SERVE_KV_QUANT": "int8",
                                 "SERVE_BLOCK_SIZE": "16",
                                 "SERVE_NUM_BLOCKS": "40",
                                 "SERVE_PREFIX_CACHE": "0"})
        assert kw["kv_quant"] == "int8" and kw["paged"]
        assert (kw["block_size"], kw["num_blocks"], kw["prefix_cache"]) \
            == (16, 40, False)
        assert "implies SERVE_PAGED=1" in capsys.readouterr().out
        kw = S.ring_kw_from_env({"SERVE_CONTINUOUS": "1",
                                 "SERVE_KV_QUANT": "none"})
        assert "kv_quant" not in kw and "paged" not in kw

    def test_http_request_matches_jax(self, setup):
        _, _, model, cfg, ref = setup
        srv = S.make_server("127.0.0.1", 0, model, cfg, continuous=True,
                            paged=True, kv_quant="int8", slots=2,
                            chunk_tokens=4, max_len=MAX_LEN, block_size=BS,
                            prefill_buckets=(16, 32, MAX_LEN))
        th = threading.Thread(target=srv.serve_forever, daemon=True)
        th.start()
        try:
            p = _prompt(19, 62)
            code, body = _post(f"http://127.0.0.1:{srv.server_address[1]}",
                               {"tokens": [p], "max_new_tokens": 6})
            assert code == 200 and body["tokens"] == [ref(p, 6)]
        finally:
            srv.shutdown()
            srv.server_close()
            srv.generator.close()
            th.join(timeout=30)
