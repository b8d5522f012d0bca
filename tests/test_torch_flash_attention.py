"""The torch package's flash attention (paddle_operator_tpu_torch/ops/
flash_attention.py) held against the JAX package's Pallas kernels
(ops/pallas_attention.py, interpret mode, block 128 — as
tests/test_pallas_attention.py runs them): the plain forward's O and
lse, the plain backward, and ``flash_attention``'s autograd gradients on
CPU tensors, for causal and non-causal attention, n_rep 1 and 2, with
and without three packed documents, S 256, D 64, float32.  The CUDA
kernels themselves run only on the card (``-m cuda``); the no-fallback
rule is pinned here with a mocked launch.

Tolerances: 1e-5 on O and lse, 1e-4 on gradients (f32; the Pallas
kernels accumulate tile by tile, the plain versions in one einsum).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_operator_tpu.ops import attention as JA
from paddle_operator_tpu.ops import pallas_attention as PA
from paddle_operator_tpu_torch.ops import attention as TA
from paddle_operator_tpu_torch.ops import flash_attention as FA

TOL_OUT = 1e-5
TOL_GRAD = 1e-4
S, D = 256, 64
CASES = [(causal, hq, hkv, seg) for causal in (True, False)
         for hq, hkv in ((2, 2), (2, 1)) for seg in (False, True)]


def _ids(cuts, s):
    """[1, s] int32 document ids with documents starting at ``cuts``."""
    return (np.searchsorted(np.asarray(cuts), np.arange(s), side="right")
            - 1).astype(np.int32)[None]


def _inputs(hq, hkv, seed, sq=S, sk=S):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((1, sq, hq, D)).astype(np.float32)
    k = rng.standard_normal((1, sk, hkv, D)).astype(np.float32)
    v = rng.standard_normal((1, sk, hkv, D)).astype(np.float32)
    do = rng.standard_normal((1, sq, hq, D)).astype(np.float32)
    return q, k, v, do


def _bhsd(x):
    return jnp.asarray(x).transpose(0, 2, 1, 3)


def _bshd(x):
    return np.asarray(x).transpose(0, 2, 1, 3)


def _jax_case(causal, hq, hkv, seg, seg_k=None, sk=S):
    """The JAX kernels on one case: O, lse [B, H, S] and (dq, dk, dv),
    all [B, S, H, D] numpy."""
    q, k, v, do = _inputs(hq, hkv, seed=hq + 2 * hkv + 10 * causal, sk=sk)
    jseg = None if seg is None else jnp.asarray(seg)
    o, lse = PA._fwd(_bhsd(q), _bhsd(k), _bhsd(v), jseg, scale=D ** -0.5,
                     causal=causal, block_q=128, block_k=128,
                     n_rep=hq // hkv, interpret=True)
    grads = PA._bwd_impl(_bhsd(q), _bhsd(k), _bhsd(v), jseg, o, lse,
                         _bhsd(do), causal=causal, block_q=128, block_k=128,
                         n_rep=hq // hkv, interpret=True)
    return ((q, k, v, do), _bshd(o), np.asarray(lse)[..., 0],
            tuple(_bshd(g) for g in grads))


@pytest.fixture(scope="module")
def jax_results():
    out = {}
    for causal, hq, hkv, seg in CASES:
        ids = _ids([0, 100, 190], S) if seg else None
        out[causal, hq, hkv, seg] = (ids,) + _jax_case(causal, hq, hkv, ids)
    return out


def _t(x):
    return None if x is None else torch.as_tensor(np.asarray(x))


@pytest.mark.parametrize("causal,hq,hkv,seg", CASES)
class TestAgainstPallas:
    def test_forward_reference(self, jax_results, causal, hq, hkv, seg):
        ids, (q, k, v, _), o, lse, _ = jax_results[causal, hq, hkv, seg]
        po, plse = FA.flash_forward_reference(_t(q), _t(k), _t(v), _t(ids),
                                              causal=causal)
        np.testing.assert_allclose(po.numpy(), o, rtol=TOL_OUT,
                                   atol=TOL_OUT)
        np.testing.assert_allclose(plse.numpy(), lse, rtol=TOL_OUT,
                                   atol=TOL_OUT)

    def test_backward_reference(self, jax_results, causal, hq, hkv, seg):
        ids, (q, k, v, do), _, _, grads = jax_results[causal, hq, hkv, seg]
        po, plse = FA.flash_forward_reference(_t(q), _t(k), _t(v), _t(ids),
                                              causal=causal)
        got = FA.flash_backward_reference(_t(q), _t(k), _t(v), _t(ids), po,
                                          plse, _t(do), causal=causal)
        for g, want in zip(got, grads):
            np.testing.assert_allclose(g.numpy(), want, rtol=TOL_GRAD,
                                       atol=TOL_GRAD)

    def test_autograd_on_cpu(self, jax_results, causal, hq, hkv, seg):
        ids, (q, k, v, do), o, _, grads = jax_results[causal, hq, hkv, seg]
        leaves = [_t(x).requires_grad_() for x in (q, k, v)]
        out = FA.flash_attention(*leaves, causal=causal,
                                 segment_ids=_t(ids))
        np.testing.assert_allclose(out.detach().numpy(), o, rtol=TOL_OUT,
                                   atol=TOL_OUT)
        out.backward(_t(do))
        for leaf, want in zip(leaves, grads):
            np.testing.assert_allclose(leaf.grad.numpy(), want,
                                       rtol=TOL_GRAD, atol=TOL_GRAD)

    def test_public_entry_matches_jax(self, jax_results, causal, hq, hkv,
                                      seg):
        """The JAX public wrapper (``[B, S, H, D]``, its custom_vjp) gives
        what the internal functions gave."""
        ids, (q, k, v, _), o, _, _ = jax_results[causal, hq, hkv, seg]
        want = PA.flash_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            segment_ids=None if ids is None else jnp.asarray(ids),
            block_q=128, block_k=128, interpret=True)
        np.testing.assert_allclose(np.asarray(want), o, rtol=TOL_OUT,
                                   atol=TOL_OUT)


class TestMaskedRows:
    """A query row whose id no key carries has no unmasked score: o = 0
    and lse = 0, and it adds nothing to the gradients.  Through the
    public entry every row sees itself; the JAX ``_fwd`` reaches such
    rows with more query rows than keys (its k tiles read the first Sk
    ids), the port's wrappers with separate q and k ids."""

    @pytest.fixture(scope="class")
    def case(self):
        ids = _ids([0, 50], S)
        ids[:, 128:] = 7                        # no key carries id 7
        return (ids,) + _jax_case(False, 2, 1, ids, sk=128)

    def test_forward(self, case):
        ids, (q, k, v, _), o, lse, _ = case
        assert not o[:, 128:].any() and not lse[:, :, 128:].any()
        got_o, got_lse = FA.flash_forward(_t(q), _t(k), _t(v), _t(ids),
                                          _t(ids[:, :128]), causal=False)
        np.testing.assert_allclose(got_o.numpy(), o, rtol=TOL_OUT,
                                   atol=TOL_OUT)
        np.testing.assert_allclose(got_lse.numpy(), lse, rtol=TOL_OUT,
                                   atol=TOL_OUT)

    def test_backward(self, case):
        ids, (q, k, v, do), _, _, grads = case
        sq, sk = _t(ids), _t(ids[:, :128])
        o, lse = FA.flash_forward(_t(q), _t(k), _t(v), sq, sk, causal=False)
        delta = FA.attention_delta(o, _t(do))
        dk, dv = FA.flash_backward_dkv(_t(q), _t(k), _t(v), _t(do), lse,
                                       delta, sq, sk, causal=False)
        dq = FA.flash_backward_dq(_t(q), _t(k), _t(v), _t(do), lse, delta,
                                  sq, sk, causal=False)
        assert not dq[:, 128:].any()
        for g, want in zip((dq, dk, dv), grads):
            np.testing.assert_allclose(g.numpy(), want, rtol=TOL_GRAD,
                                       atol=TOL_GRAD)


class TestDispatcher:
    @pytest.mark.parametrize("seg", [False, True])
    def test_reference_attention_matches_jax(self, seg):
        q, k, v, _ = _inputs(4, 2, seed=3, sq=40, sk=40)
        ids = _ids([0, 11, 30], 40) if seg else None
        want = JA.reference_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
            segment_ids=None if ids is None else jnp.asarray(ids))
        got = TA.attention(_t(q), _t(k), _t(v), causal=True,
                           segment_ids=_t(ids))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=TOL_OUT, atol=TOL_OUT)

    def test_cpu_runs_the_plain_version(self):
        q, k, v, _ = _inputs(2, 2, seed=4, sq=16, sk=16)
        before = FA.flash_forward.launches
        TA.attention(_t(q), _t(k), _t(v))
        assert FA.flash_forward.launches == before

    def test_non_cpu_tensor_goes_to_the_kernel(self):
        q = torch.empty((1, 8, 2, 64), device="meta")
        with pytest.raises(ValueError, match="CUDA"):
            TA.attention(q, q, q)


class TestNoFallback:
    def _operands(self):
        q, k, v, do = (_t(x) for x in _inputs(2, 1, seed=5, sq=32, sk=32))
        o, lse = FA.flash_forward(q, k, v)
        return q, k, v, do, lse, FA.attention_delta(o, do)

    @pytest.mark.parametrize("kern", ["flash_forward", "flash_backward_dkv",
                                      "flash_backward_dq"])
    def test_meta_tensor_raises(self, kern):
        q = torch.empty((1, 8, 2, 64), device="meta")
        k = torch.empty((1, 8, 1, 64), device="meta")
        rows = torch.empty((1, 2, 8), device="meta")
        fn = getattr(FA, kern)
        before = fn.launches
        with pytest.raises(ValueError, match="CUDA"):
            if kern == "flash_forward":
                fn(q, k, k)
            else:
                fn(q, k, k, q, rows, rows)
        assert fn.launches == before

    @pytest.mark.parametrize("entry", ["flash_fwd_launch",
                                       "flash_bwd_dkv_launch",
                                       "flash_bwd_dq_launch"])
    def test_failed_launch_raises(self, entry):
        class FailingLib:
            def __getattr__(self, name):
                return lambda *args: 700      # cudaErrorIllegalAddress

        counts = (FA.flash_forward.launches, FA.flash_backward_dkv.launches,
                  FA.flash_backward_dq.launches)
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            FA._launch(FailingLib(), entry, "flash", 0, 0)
        assert counts == (FA.flash_forward.launches,
                          FA.flash_backward_dkv.launches,
                          FA.flash_backward_dq.launches)

    def test_shape_errors_raise(self):
        q, k, v, do, lse, delta = self._operands()
        with pytest.raises(ValueError, match="multiple"):
            FA.flash_forward(q[:, :, :1].contiguous(),
                             k.repeat(1, 1, 2, 1), v.repeat(1, 1, 2, 1))
        with pytest.raises(ValueError, match="both"):
            FA.flash_forward(q, k, v, torch.zeros((1, 32), dtype=torch.int32))
        with pytest.raises(ValueError, match="segment ids"):
            FA.flash_forward(q, k, v, torch.zeros((1, 31), dtype=torch.int32),
                             torch.zeros((1, 32), dtype=torch.int32))
        with pytest.raises(ValueError, match="lse"):
            FA.flash_backward_dq(q, k, v, do, lse[:, :, :3], delta)


@pytest.mark.cuda
class TestKernelsOnCard:
    """Each CUDA kernel against its plain version on the card (built from
    csrc/ at first use), f32 at 1e-4."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")

    @pytest.mark.parametrize("causal,hq,hkv,seg", CASES)
    @pytest.mark.parametrize("s", [1, 300])
    def test_kernels_match_plain(self, causal, hq, hkv, seg, s):
        torch.backends.cuda.matmul.allow_tf32 = False
        q, k, v, do = (torch.as_tensor(x, device="cuda")
                       for x in _inputs(hq, hkv, seed=6, sq=s, sk=s))
        ids = (torch.as_tensor(_ids([0, s // 3, 2 * s // 3], s),
                               device="cuda") if seg else None)
        o, lse = FA.flash_forward(q, k, v, ids, ids, causal=causal)
        po, plse = FA.flash_forward_reference(q, k, v, ids, causal=causal)
        delta = FA.attention_delta(po, do)
        dk, dv = FA.flash_backward_dkv(q, k, v, do, plse, delta, ids, ids,
                                       causal=causal)
        dq = FA.flash_backward_dq(q, k, v, do, plse, delta, ids, ids,
                                  causal=causal)
        pdk, pdv = FA.flash_backward_dkv_reference(q, k, v, do, plse, delta,
                                                   ids, ids, causal=causal)
        pdq = FA.flash_backward_dq_reference(q, k, v, do, plse, delta, ids,
                                             ids, causal=causal)
        torch.cuda.synchronize()
        for got, want in ((o, po), (lse, plse), (dq, pdq), (dk, pdk),
                          (dv, pdv)):
            torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)

    @pytest.mark.parametrize(
        "d,n_rep,causal,seg,sq,sk",
        [(d, n_rep, causal, seg, s, s) for d in (64, 128)
         for n_rep in (1, 2, 4) for causal in (True, False)
         for seg in (False, True)
         for s in (1, 63, 64, 65, 127, 128, 129, 300, 2048)]
        + [(128, 2, causal, seg, 300, 700) for causal in (True, False)
           for seg in (False, True)])
    def test_bf16_kernels_match_plain(self, d, n_rep, causal, seg, sq, sk):
        """The bf16 bodies (wgmma, register accumulators, TMA rings at D
        64 and 128) at the tile edges of their 64- and 128-row tiles and
        with Sq != Sk, against the plain version in f32 on the same bf16
        inputs, under phase 2c's limits of chip_smoke.py."""
        from chip_smoke import (FLASH_BF16_ATOL, FLASH_BF16_REL,
                                FLASH_BF16_RTOL)

        rng = np.random.default_rng(sq + 7 * sk + d + n_rep)
        hq = 4
        q, do = (torch.as_tensor(rng.standard_normal((2, sq, hq, d)),
                                 dtype=torch.bfloat16, device="cuda")
                 for _ in range(2))
        k, v = (torch.as_tensor(rng.standard_normal((2, sk, hq // n_rep, d)),
                                dtype=torch.bfloat16, device="cuda")
                for _ in range(2))
        ids_q = ids_k = None
        if seg:
            ids_q, ids_k = (torch.as_tensor(
                np.repeat(_ids([0, s // 3, 2 * s // 3 + 1], s), 2, 0),
                device="cuda") for s in (sq, sk))
        qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
        po, plse = FA.flash_forward_reference(qf, kf, vf, ids_q,
                                              causal=causal, seg_k=ids_k)
        delta = FA.attention_delta(po, dof)
        o, lse = FA.flash_forward(q, k, v, ids_q, ids_k, causal=causal)
        dk, dv = FA.flash_backward_dkv(q, k, v, do, plse, delta, ids_q,
                                       ids_k, causal=causal)
        dq = FA.flash_backward_dq(q, k, v, do, plse, delta, ids_q, ids_k,
                                  causal=causal)
        pdk, pdv = FA.flash_backward_dkv_reference(
            qf, kf, vf, dof, plse, delta, ids_q, ids_k, causal=causal)
        pdq = FA.flash_backward_dq_reference(qf, kf, vf, dof, plse, delta,
                                             ids_q, ids_k, causal=causal)
        torch.cuda.synchronize()
        for kern, name, got, want in (
                ("flash_forward", "o", o, po),
                ("flash_forward", "lse", lse, plse),
                ("flash_backward_dkv", "dk", dk, pdk),
                ("flash_backward_dkv", "dv", dv, pdv),
                ("flash_backward_dq", "dq", dq, pdq)):
            diff = (got.float() - want).abs()
            limit = FLASH_BF16_ATOL[kern] + FLASH_BF16_RTOL * want.abs()
            assert bool((diff <= limit).all()), (
                f"{name}: max |err| {float(diff.max())}")
            if min(sq, sk) == 1 and name in ("dk", "dq"):
                continue  # one key a row: only rounding residue on both
            rel = float(diff.norm()) / float(want.norm())
            assert rel <= FLASH_BF16_REL, f"{name}: relative error {rel}"

    def test_bf16_dkv_runs_bit_identical(self):
        """No atomics: two runs of the bf16 dK/dV kernel (GQA sum inside
        the block, segment ids, ragged S) give the same bits."""
        rng = np.random.default_rng(3)
        b, s, hq, hkv, d = 2, 1000, 8, 2, 128
        q, do = (torch.as_tensor(rng.standard_normal((b, s, hq, d)),
                                 dtype=torch.bfloat16, device="cuda")
                 for _ in range(2))
        k, v = (torch.as_tensor(rng.standard_normal((b, s, hkv, d)),
                                dtype=torch.bfloat16, device="cuda")
                for _ in range(2))
        ids = torch.as_tensor(np.repeat(_ids([0, 333, 700], s), b, 0),
                              device="cuda")
        o, lse = FA.flash_forward(q, k, v, ids, ids)
        delta = FA.attention_delta(o, do)
        first = FA.flash_backward_dkv(q, k, v, do, lse, delta, ids, ids)
        again = FA.flash_backward_dkv(q, k, v, do, lse, delta, ids, ids)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(first, again))

    def test_bf16_dq_runs_bit_identical(self):
        """No atomics: two runs of the bf16 dQ kernel (GQA, segment ids,
        ragged S) give the same bits."""
        rng = np.random.default_rng(4)
        b, s, hq, hkv, d = 2, 1000, 8, 2, 128
        q, do = (torch.as_tensor(rng.standard_normal((b, s, hq, d)),
                                 dtype=torch.bfloat16, device="cuda")
                 for _ in range(2))
        k, v = (torch.as_tensor(rng.standard_normal((b, s, hkv, d)),
                                dtype=torch.bfloat16, device="cuda")
                for _ in range(2))
        ids = torch.as_tensor(np.repeat(_ids([0, 333, 700], s), b, 0),
                              device="cuda")
        o, lse = FA.flash_forward(q, k, v, ids, ids)
        delta = FA.attention_delta(o, do)
        first = FA.flash_backward_dq(q, k, v, do, lse, delta, ids, ids)
        again = FA.flash_backward_dq(q, k, v, do, lse, delta, ids, ids)
        torch.cuda.synchronize()
        assert torch.equal(first, again)
