"""The torch package's decode attention (paddle_operator_tpu_torch/ops/
decode_attention.py) held against the JAX package's: the same numpy
inputs through the JAX pallas kernel (interpret mode), the JAX einsum
reference, and the port's wrapper on CPU tensors (its plain version) —
the cases of tests/test_decode_attention.py TestKernelEquivalence.  The
CUDA kernel itself runs only on the card (``-m cuda``), and the
no-fallback rule is pinned here with a mocked launch.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_operator_tpu.ops import decode_attention as JDA
from paddle_operator_tpu_torch.ops import decode_attention as TDA

TOL = 2e-5


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _case(b, s, hq, hkv, d, lens, seed=0):
    q = _rand((b, hq, d), seed + 1)
    k = _rand((b, hkv, s, d), seed + 2)
    v = _rand((b, hkv, s, d), seed + 3)
    return q, k, v, np.asarray(lens, np.int32)


def _port(q, k, v, lens, **kw):
    return TDA.decode_attention(torch.as_tensor(q), torch.as_tensor(k),
                                torch.as_tensor(v), torch.as_tensor(lens),
                                **kw).numpy()


def _jax_kernel(q, k, v, lens, **kw):
    return np.asarray(JDA.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens),
        interpret=True, **kw))


def _jax_ref(q, k, v, lens):
    return np.asarray(JDA.decode_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens)))


class TestPlainMatchesJax:
    @pytest.mark.parametrize("lens", [[5, 64, 17, 33], [1, 1, 1, 1],
                                      [0, 10, 64, 3], [64, 64, 64, 64]])
    def test_ragged_lengths(self, lens):
        q, k, v, L = _case(4, 64, 8, 4, 32, lens)
        got = _port(q, k, v, L)
        np.testing.assert_allclose(got, _jax_kernel(q, k, v, L, block_k=16),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got, _jax_ref(q, k, v, L),
                                   rtol=TOL, atol=TOL)

    def test_length_zero_lane_is_zeros(self):
        q, k, v, L = _case(2, 32, 4, 2, 16, [0, 7], seed=3)
        got = _port(q, k, v, L)
        assert not got[0].any()

    def test_mha_no_grouping(self):
        q, k, v, L = _case(2, 32, 4, 4, 16, [7, 32], seed=4)
        got = _port(q, k, v, L)
        np.testing.assert_allclose(got, _jax_kernel(q, k, v, L, block_k=16),
                                   rtol=TOL, atol=TOL)

    @pytest.mark.parametrize("n_rep", [2, 4])
    def test_gqa_groups(self, n_rep):
        q, k, v, L = _case(2, 64, 2 * n_rep, 2, 32, [9, 64], seed=5)
        np.testing.assert_allclose(_port(q, k, v, L), _jax_ref(q, k, v, L),
                                   rtol=TOL, atol=TOL)

    def test_odd_cache_length(self):
        # S=48: the TPU wrapper shrinks its key block; the port takes
        # any S as it is
        q, k, v, L = _case(1, 48, 2, 2, 8, [29], seed=6)
        np.testing.assert_allclose(_port(q, k, v, L),
                                   _jax_kernel(q, k, v, L),
                                   rtol=TOL, atol=TOL)

    def test_stacked_layer_selects_the_view(self):
        rng = np.random.default_rng(7)
        q = rng.standard_normal((2, 4, 16)).astype(np.float32)
        k = rng.standard_normal((3, 2, 2, 32, 16)).astype(np.float32)
        v = rng.standard_normal((3, 2, 2, 32, 16)).astype(np.float32)
        L = np.asarray([5, 32], np.int32)
        got = _port(q, k, v, L, layer=1)
        want = np.asarray(JDA.decode_attention(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(L),
            layer=jnp.asarray(1, jnp.int32), block_k=16, interpret=True))
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)

    def test_explicit_scale(self):
        q, k, v, L = _case(2, 32, 4, 2, 16, [11, 20], seed=8)
        got = _port(q, k, v, L, scale=0.1)
        want = _jax_kernel(q, k, v, L, scale=0.1, block_k=16)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


class TestNoFallback:
    def test_non_cpu_non_cuda_tensor_raises(self):
        q = torch.empty((1, 2, 16), device="meta")
        k = torch.empty((1, 2, 8, 16), device="meta")
        L = torch.empty((1,), dtype=torch.int32, device="meta")
        before = TDA.decode_attention.launches
        with pytest.raises(ValueError, match="CUDA"):
            TDA.decode_attention(q, k, k, L)
        assert TDA.decode_attention.launches == before

    def test_failed_launch_raises(self):
        class FailingLib:
            def decode_attention_launch(self, *args):
                return 700      # cudaErrorIllegalAddress

        q, k, v, L = (torch.as_tensor(a)
                      for a in _case(1, 16, 2, 2, 16, [4]))
        before = TDA.decode_attention.launches
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            TDA._launch(FailingLib(), q, k, v, L, torch.empty_like(q),
                        0.25, 0)
        assert TDA.decode_attention.launches == before

    def test_shape_errors_raise(self):
        q, k, v, L = (torch.as_tensor(a)
                      for a in _case(2, 16, 3, 2, 16, [4, 4]))
        with pytest.raises(ValueError, match="multiple"):
            TDA.decode_attention(q, k, v, L)
        with pytest.raises(ValueError, match="lengths"):
            TDA.decode_attention(q[:, :2].contiguous(), k, v, L[:1])


class TestSplitHostLogic:
    """The contiguous kernel's split as the wrapper sets it up: the chunk
    count follows the cache's capacity S alone, and the workspace holds
    one partial (accumulator, row max, row sum) per chunk."""

    @pytest.mark.parametrize("s,chunks", [
        (0, 1), (1, 1), (TDA.CHUNK_ROWS - 1, 1), (TDA.CHUNK_ROWS, 1),
        (TDA.CHUNK_ROWS + 1, 2), (2048, 2048 // TDA.CHUNK_ROWS),
        (3 * TDA.CHUNK_ROWS + 45, 4)])
    def test_chunk_count(self, s, chunks):
        assert TDA.split_chunks(s) == chunks
        assert TDA.split_chunks(s, chunk_rows=64) == max(1, -(-s // 64))

    @pytest.mark.parametrize("s", [1, TDA.CHUNK_ROWS, 2048, 1000])
    def test_workspace_shape(self, s):
        """B * Hq * chunks * (D + 2) f32 partials and B * Hq zeroed int32
        tickets; kept for the device, grown when a call needs more."""
        dev = torch.device("cpu")
        TDA._SCRATCH.pop(dev, None)
        ws, tickets = TDA.split_scratch(dev, 3, 8, 64, s)
        chunks = TDA.split_chunks(s)
        if chunks == 1:
            assert ws is None and tickets is None
            return
        assert ws.dtype == torch.float32 and ws.numel() == 3 * 8 * chunks * 66
        assert tickets.dtype == torch.int32 and tickets.numel() >= 3 * 8
        assert not tickets.any()
        again = TDA.split_scratch(dev, 2, 8, 64, s)
        assert again[0] is ws and again[1] is tickets
        bigger = TDA.split_scratch(dev, 6, 8, 64, s)
        assert bigger[0].numel() == 6 * 8 * chunks * 66
        TDA._SCRATCH.pop(dev, None)


@pytest.mark.cuda
class TestKernelOnCard:
    """The CUDA kernel against its plain version on the card (built
    from csrc/ at first use)."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")

    @pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                            (torch.bfloat16, 2e-2)])
    @pytest.mark.parametrize("hq,hkv,d", [(4, 4, 64), (8, 4, 128),
                                          (8, 2, 64), (32, 32, 128)])
    def test_matches_plain(self, dtype, atol, hq, hkv, d):
        torch.backends.cuda.matmul.allow_tf32 = False
        q, k, v, L = _case(4, 300, hq, hkv, d, [0, 1, 300, 129], seed=9)
        dev = torch.device("cuda")
        qt, kt, vt = (torch.as_tensor(a, device=dev).to(dtype)
                      for a in (q, k, v))
        Lt = torch.as_tensor(L, device=dev)
        got = TDA.decode_attention(qt, kt, vt, Lt).float()
        want = TDA.decode_attention_reference(qt.float(), kt.float(),
                                              vt.float(), Lt)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=atol, rtol=atol)

    @pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                            (torch.bfloat16, 2e-2)])
    @pytest.mark.parametrize("hq,hkv", [(8, 8), (8, 4), (16, 4)])
    @pytest.mark.parametrize("d", [64, 128])
    def test_chunk_edges(self, dtype, atol, hq, hkv, d):
        """Lengths at the split's chunk edges (0, 1, chunk - 1, chunk,
        chunk + 1, the whole cache) with R = 1, 2 and 4 query heads a
        block; a length-0 lane gives zeros."""
        torch.backends.cuda.matmul.allow_tf32 = False
        c = TDA.CHUNK_ROWS
        s = 3 * c + 45
        lens = [0, 1, c - 1, c, c + 1, s]
        q, k, v, L = _case(len(lens), s, hq, hkv, d, lens, seed=d + hq)
        dev = torch.device("cuda")
        qt, kt, vt = (torch.as_tensor(a, device=dev).to(dtype)
                      for a in (q, k, v))
        Lt = torch.as_tensor(L, device=dev)
        got = TDA.decode_attention(qt, kt, vt, Lt).float()
        want = TDA.decode_attention_reference(qt.float(), kt.float(),
                                              vt.float(), Lt)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=atol, rtol=atol)
        assert not got[0].any()

    def test_stacked_layer_view(self):
        """Layer 1 of stacked [L, B, Hkv, S, D] caches: the view's offset
        reaches the split kernel."""
        c = TDA.CHUNK_ROWS
        s = 2 * c + 7
        rng = np.random.default_rng(11)
        dev = torch.device("cuda")
        q = torch.as_tensor(rng.standard_normal((3, 8, 128)),
                            dtype=torch.float32, device=dev)
        k, v = (torch.as_tensor(rng.standard_normal((3, 3, 4, s, 128)),
                                dtype=torch.float32, device=dev)
                for _ in range(2))
        L = torch.as_tensor([c, s, 5], dtype=torch.int32, device=dev)
        got = TDA.decode_attention(q, k, v, L, layer=1)
        want = TDA.decode_attention_reference(q, k[1], v[1], L)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)

    def test_runs_bit_identical(self):
        """The partials merge in chunk order: two runs give the same
        bits."""
        c = TDA.CHUNK_ROWS
        s = 8 * c
        q, k, v, L = _case(4, s, 32, 8, 128, [s, c + 1, 0, 3 * c], seed=12)
        dev = torch.device("cuda")
        qt, kt, vt = (torch.as_tensor(a, device=dev).to(torch.bfloat16)
                      for a in (q, k, v))
        Lt = torch.as_tensor(L, device=dev)
        first = TDA.decode_attention(qt, kt, vt, Lt)
        again = TDA.decode_attention(qt, kt, vt, Lt)
        torch.cuda.synchronize()
        assert torch.equal(first, again)
