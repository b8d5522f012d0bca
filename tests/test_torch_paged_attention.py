"""The torch package's paged decode attention (paddle_operator_tpu_torch/
ops/decode_attention.py ``paged_decode_attention``) held against the
JAX package's: the same numpy inputs through the JAX pallas kernel
(interpret mode), the JAX einsum reference, and the port's wrapper on
CPU tensors (its plain version) — the cases of tests/test_paged.py
TestPagedKernel, over block sizes, GQA groupings and stacked layers.
Also ``scatter_prefill_blocks`` against the JAX scatter, the
no-fallback rule with a mocked launch, the host logic of the kernels'
split over chunks of the table (chunk count, chunk rows, the scratch
shared with the contiguous kernel), and the CUDA kernels (bf16 pool and
int8 pool) against their plain versions on the card (``-m cuda``: the
chunk edges, block sizes 16 and 256, 1, 2 and 4 query heads a block,
stacked layers, bit-identical reruns; the int8 pool's CPU tests are in
tests/test_torch_kvquant.py).
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_operator_tpu.ops import decode_attention as JDA
from paddle_operator_tpu_torch.ops import decode_attention as TDA

TOL = 1e-5


def _paged_case(b, hq, hkv, s, d, bs, lens, seed=0, layers=None):
    """Contiguous K/V [B, Hkv, S, D] scattered into a pool under a
    SCRAMBLED block map (block 0 stays the trash block)."""
    rng = np.random.default_rng(seed)
    m = s // bs
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    q = rng.standard_normal((b, hq, d)).astype(np.float32)
    n = b * m + 1
    pool_k = np.zeros((n, hkv, bs, d), np.float32)
    pool_v = np.zeros((n, hkv, bs, d), np.float32)
    ids = rng.permutation(np.arange(1, n))
    table = np.zeros((b, m), np.int32)
    for lane in range(b):
        for j in range(m):
            blk = int(ids[lane * m + j])
            table[lane, j] = blk
            pool_k[blk] = k[lane, :, j * bs:(j + 1) * bs]
            pool_v[blk] = v[lane, :, j * bs:(j + 1) * bs]
    return q, k, v, pool_k, pool_v, table, np.asarray(lens, np.int32)


def _port(q, pk, pv, table, lens, **kw):
    return TDA.paged_decode_attention(
        torch.as_tensor(q), torch.as_tensor(pk), torch.as_tensor(pv),
        torch.as_tensor(table), torch.as_tensor(lens), **kw).numpy()


def _jax_kernel(q, pk, pv, table, lens, **kw):
    return np.asarray(JDA.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(table), jnp.asarray(lens), interpret=True, **kw))


def _jax_ref(q, k, v, lens):
    return np.asarray(JDA.decode_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens)))


class TestPlainMatchesJax:
    @pytest.mark.parametrize("bs", [4, 8, 16])
    @pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 2)])
    def test_scrambled_block_map(self, bs, hq, hkv):
        # lengths: sparse (5), full (64), idle (0)
        q, k, v, pk, pv, table, L = _paged_case(3, hq, hkv, 64, 16, bs,
                                                [5, 64, 0], seed=bs + hq)
        got = _port(q, pk, pv, table, L)
        np.testing.assert_allclose(got, _jax_kernel(q, pk, pv, table, L),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(got, _jax_ref(q, k, v, L),
                                   rtol=TOL, atol=TOL)
        assert not got[2].any()          # a length-0 lane gives zeros

    def test_stacked_layers(self):
        q, k, v, pk, pv, table, L = _paged_case(3, 4, 2, 64, 16, 16,
                                                [5, 64, 0], seed=1)
        spk, spv = np.stack([pk, pk * 2]), np.stack([pv, pv * 2])
        for li in range(2):
            got = _port(q, spk, spv, table, L, layer=li)
            want = _jax_kernel(q, spk, spv, table, L,
                               layer=jnp.asarray(li, jnp.int32))
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
            np.testing.assert_allclose(
                got, _jax_ref(q, k * (li + 1), v * (li + 1), L),
                rtol=TOL, atol=TOL)

    def test_length_not_a_block_multiple_and_explicit_scale(self):
        q, k, v, pk, pv, table, L = _paged_case(2, 4, 2, 48, 8, 8,
                                                [13, 47], seed=2)
        got = _port(q, pk, pv, table, L, scale=0.2)
        np.testing.assert_allclose(
            got, _jax_kernel(q, pk, pv, table, L, scale=0.2),
            rtol=TOL, atol=TOL)

    def test_entries_past_the_fill_are_never_read(self):
        # a retired lane's tail entries point at the trash block: poison
        # every block past each lane's fill and the output must not move
        q, k, v, pk, pv, table, L = _paged_case(2, 4, 2, 64, 16, 16,
                                                [17, 3], seed=3)
        want = _port(q, pk, pv, table, L)
        for lane, n in enumerate(L):
            for j in range(-(-int(n) // 16), table.shape[1]):
                pk[table[lane, j]] = np.nan
                pv[table[lane, j]] = np.nan
                table[lane, j] = 0
        pk[0] = pv[0] = 1e6                 # the trash block
        np.testing.assert_allclose(_port(q, pk, pv, table, L), want,
                                   rtol=TOL, atol=TOL)

    def test_inactive_lane_reads_one_trash_row(self):
        # the ring zeroes an inactive lane's position and table row, so
        # it attends lengths pos+1 = 1 row of block 0 — finite, and
        # equal to that row's V for every query head
        rng = np.random.default_rng(4)
        pk = rng.standard_normal((3, 2, 8, 16)).astype(np.float32)
        pv = rng.standard_normal((3, 2, 8, 16)).astype(np.float32)
        q = rng.standard_normal((1, 4, 16)).astype(np.float32)
        got = _port(q, pk, pv, np.zeros((1, 4), np.int32),
                    np.asarray([1], np.int32))
        np.testing.assert_allclose(got[0], np.repeat(pv[0, :, 0], 2, 0),
                                   rtol=TOL, atol=TOL)


class TestScatterPrefillBlocks:
    @pytest.mark.parametrize("start_block", [0, 1])
    def test_matches_jax(self, start_block):
        rng = np.random.default_rng(5)
        pool = rng.standard_normal((2, 9, 2, 4, 8)).astype(np.float32)
        rows = rng.standard_normal((2, 1, 2, 12, 8)).astype(np.float32)
        table = np.asarray([3, 7, 1, 5, 0], np.int32)
        want = np.asarray(JDA.scatter_prefill_blocks(
            jnp.asarray(pool), jnp.asarray(rows), jnp.asarray(table), 4,
            start_block))
        got = TDA.scatter_prefill_blocks(
            torch.as_tensor(pool.copy()), torch.as_tensor(rows),
            torch.as_tensor(table), 4, start_block).numpy()
        np.testing.assert_array_equal(got, want)

    def test_partial_block_refused(self):
        with pytest.raises(ValueError, match="multiple"):
            TDA.scatter_prefill_blocks(torch.zeros((1, 4, 1, 4, 8)),
                                       torch.zeros((1, 1, 1, 6, 8)),
                                       torch.arange(4), 4)


class TestNoFallback:
    def test_non_cpu_non_cuda_tensor_raises(self):
        q = torch.empty((1, 2, 16), device="meta")
        pool = torch.empty((3, 2, 8, 16), device="meta")
        table = torch.empty((1, 2), dtype=torch.int32, device="meta")
        L = torch.empty((1,), dtype=torch.int32, device="meta")
        before = TDA.paged_decode_attention.launches
        with pytest.raises(ValueError, match="CUDA"):
            TDA.paged_decode_attention(q, pool, pool, table, L)
        assert TDA.paged_decode_attention.launches == before

    def test_failed_launch_raises(self):
        class FailingLib:
            def paged_decode_attention_launch(self, *args):
                return 700      # cudaErrorIllegalAddress

        q, _, _, pk, pv, table, L = (
            torch.as_tensor(a)
            for a in _paged_case(1, 2, 2, 16, 16, 8, [4]))
        before = TDA.paged_decode_attention.launches
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            TDA._paged_launch(FailingLib(), q, pk, pv, table, L,
                              torch.empty_like(q), 0.25, 0)
        assert TDA.paged_decode_attention.launches == before

    def test_shape_errors_raise(self):
        q, _, _, pk, pv, table, L = (
            torch.as_tensor(a)
            for a in _paged_case(2, 4, 2, 16, 16, 8, [4, 9]))
        with pytest.raises(ValueError, match="multiple"):
            TDA.paged_decode_attention(q[:, :3].contiguous(), pk, pv,
                                       table, L)
        with pytest.raises(ValueError, match="block_table"):
            TDA.paged_decode_attention(q, pk, pv, table[:1], L)
        with pytest.raises(ValueError, match="lengths"):
            TDA.paged_decode_attention(q, pk, pv, table, L[:1])

    def test_quant_operands_not_ported(self):
        """The int8 pool's operands are ported now
        (tests/test_torch_kvquant.py); given only in part they raise,
        as in the JAX package."""
        q, _, _, pk, pv, table, L = (
            torch.as_tensor(a)
            for a in _paged_case(1, 2, 2, 16, 16, 8, [4]))
        with pytest.raises(ValueError, match="together"):
            TDA.paged_decode_attention(q, pk, pv, table, L,
                                       k_scale=torch.ones(3, 2))


class FakeLib:
    """Records each launch's arguments and reports success."""

    def __init__(self):
        self.calls = []

    def paged_decode_attention_launch(self, *args):
        self.calls.append(args)
        return 0

    def paged_decode_attention_quant_launch(self, *args):
        self.calls.append(args)
        return 0


class TestSplitHostLogic:
    """The paged kernels' split as the wrapper sets it up: chunks of the
    table's reach M * bs, chunk rows that divide bs or are a multiple of
    it, and the scratch shared with the contiguous kernel."""

    @pytest.mark.parametrize("m,bs,rows,chunks", [
        (8, 256, None, 8), (8, 256, 256, 8), (8, 256, 128, 16),
        (8, 256, 64, 32), (8, 256, 512, 4), (3, 256, 512, 2),
        (1, 256, None, 1), (4, 16, None, 1), (16, 16, None, 1),
        (17, 16, None, 2), (40, 16, None, 3), (40, 16, 32, 20),
        (40, 16, 8, 80), (51, 16, None, 4)])
    def test_chunk_count(self, m, bs, rows, chunks):
        assert TDA.paged_split_chunks(m, bs, rows) == chunks

    @pytest.mark.parametrize("bs,rows", [
        (1, 256), (4, 256), (16, 256), (24, 240), (100, 200), (256, 256),
        (300, 300), (512, 256), (1024, 256)])
    def test_default_chunk_rows(self, bs, rows):
        """CHUNK_ROWS where bs allows it, else a multiple of bs: no tile
        of a chunk crosses a pool block."""
        got = TDA.paged_chunk_rows(bs)
        assert got == rows
        assert got % bs == 0 or bs % got == 0

    @pytest.mark.parametrize("bs,rows", [(16, 24), (256, 96), (256, 384),
                                         (24, 16), (16, 0)])
    def test_chunk_rows_refused(self, bs, rows):
        with pytest.raises(ValueError, match="chunk rows"):
            TDA.paged_split_chunks(4, bs, rows)
        q, _, _, pk, pv, table, L = (
            torch.as_tensor(a) for a in _paged_case(1, 2, 2, 2 * bs, 8, bs,
                                                    [4]))
        with pytest.raises(ValueError, match="chunk rows"):
            TDA._paged_launch(FakeLib(), q, pk, pv, table, L,
                              torch.empty_like(q), 0.25, 0,
                              chunk_rows=rows)

    def test_scratch_shared_with_contiguous_kernel(self):
        """One (partials, tickets) pair per device for all three
        kernels: a paged launch that needs no more than kernel #1 took
        reuses its buffers, one that needs more grows both to the larger
        need, and later smaller calls keep the same objects."""
        dev = torch.device("cpu")
        TDA._SCRATCH.pop(dev, None)
        try:
            ws1, tk1 = TDA.split_scratch(dev, 4, 8, 64, 1000)  # 4 chunks
            assert ws1.numel() == 4 * 8 * 4 * 66
            lib = FakeLib()
            # 2 lanes, Hq 4, D 16, M 40 of bs 16: 3 chunks, a smaller need
            q, _, _, pk, pv, table, L = (
                torch.as_tensor(a) for a in _paged_case(
                    2, 4, 2, 640, 16, 16, [600, 5]))
            TDA._paged_launch(lib, q, pk, pv, table, L,
                              torch.empty_like(q), 0.25, 0)
            assert lib.calls[-1][6] == ws1.data_ptr()
            assert lib.calls[-1][7] == tk1.data_ptr()
            # 64 chunks of 10 rows: more partials than kernel #1's call
            TDA._paged_launch(lib, q, pk, pv, table, L,
                              torch.empty_like(q), 0.25, 0, chunk_rows=8)
            ws2, tk2 = TDA._SCRATCH[dev]
            assert ws2.numel() == max(2 * 4 * 80 * 18, ws1.numel())
            assert tk2.numel() >= 4 * 8 and not tk2.any()
            assert lib.calls[-1][6] == ws2.data_ptr()
            again = TDA.split_scratch(dev, 4, 8, 64, 1000)
            assert again[0] is ws2 and again[1] is tk2
            TDA._paged_launch(lib, q, pk, pv, table, L,
                              torch.empty_like(q), 0.25, 0)
            assert TDA._SCRATCH[dev][0] is ws2
        finally:
            TDA._SCRATCH.pop(dev, None)

    def test_one_chunk_needs_no_scratch(self):
        q, _, _, pk, pv, table, L = (
            torch.as_tensor(a) for a in _paged_case(2, 4, 2, 256, 16, 16,
                                                    [200, 5]))
        lib = FakeLib()
        TDA._paged_launch(lib, q, pk, pv, table, L, torch.empty_like(q),
                          0.25, 0)
        assert lib.calls[-1][6] is None and lib.calls[-1][7] is None

    @pytest.mark.parametrize("quant", [False, True])
    def test_launch_arguments(self, quant):
        """The C entry gets the table's width, the pool's block size and
        the chunk rows (the default, or what the caller passes)."""
        q, _, _, pk, pv, table, L = (
            torch.as_tensor(a) for a in _paged_case(1, 2, 2, 64, 16, 16,
                                                    [40]))
        lib, out = FakeLib(), torch.empty_like(q)
        if quant:
            ks = vs = torch.ones(pk.shape[:2])
            TDA._paged_quant_launch(lib, q, pk, pv, ks, vs, pk, pv, table,
                                    L, out, 0.25, 0)
            TDA._paged_quant_launch(lib, q, pk, pv, ks, vs, pk, pv, table,
                                    L, out, 0.25, 0, chunk_rows=32)
            ints = slice(12, 21)
        else:
            TDA._paged_launch(lib, q, pk, pv, table, L, out, 0.25, 0)
            TDA._paged_launch(lib, q, pk, pv, table, L, out, 0.25, 0,
                              chunk_rows=32)
            ints = slice(8, 16)
        first, second = (c[ints] for c in lib.calls)
        assert first[5] == table.shape[1] == 4 and first[4] == 16
        assert first[-1] == 256 and second[-1] == 32

@pytest.mark.cuda
class TestKernelOnCard:
    """The paged CUDA kernel against its plain version on the card
    (built from csrc/ at first use)."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")

    @pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                            (torch.bfloat16, 2e-2)])
    @pytest.mark.parametrize("hq,hkv,d,bs", [(4, 4, 64, 16),
                                             (8, 4, 128, 16),
                                             (8, 2, 64, 256),
                                             (32, 32, 128, 256)])
    def test_matches_plain(self, dtype, atol, hq, hkv, d, bs):
        q, _, _, pk, pv, table, L = _paged_case(
            4, hq, hkv, 512, d, bs, [0, 1, 512, 300], seed=9)
        dev = torch.device("cuda")
        qt, pkt, pvt = (torch.as_tensor(a, device=dev).to(dtype)
                        for a in (q, pk, pv))
        tt = torch.as_tensor(table, device=dev)
        Lt = torch.as_tensor(L, device=dev)
        before = TDA.paged_decode_attention.launches
        got = TDA.paged_decode_attention(qt, pkt, pvt, tt, Lt).float()
        assert TDA.paged_decode_attention.launches == before + 1
        want = TDA.paged_decode_attention_reference(
            qt.float(), pkt.float(), pvt.float(), tt, Lt)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=atol, rtol=atol)

    @pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                            (torch.bfloat16, 2e-2)])
    @pytest.mark.parametrize("hq,hkv", [(8, 8), (8, 4), (16, 4)])
    @pytest.mark.parametrize("d", [64, 128])
    @pytest.mark.parametrize("bs", [16, 256])
    def test_chunk_edges(self, dtype, atol, hq, hkv, d, bs):
        """Lengths at the split's chunk and block edges (0, 1, chunk - 1,
        chunk, chunk + 1, bs - 1, bs + 1, M * bs) with R = 1, 2 and 4
        query heads a block; a length-0 lane gives zeros."""
        lens, s = _edges(bs)
        q, _, _, pk, pv, table, L = _paged_case(len(lens), hq, hkv, s, d,
                                                bs, lens, seed=d + hq + bs)
        qt, pkt, pvt, tt, Lt = _on_card(dtype, q, pk, pv, table, L)
        got = TDA.paged_decode_attention(qt, pkt, pvt, tt, Lt).float()
        want = TDA.paged_decode_attention_reference(
            qt.float(), pkt.float(), pvt.float(), tt, Lt)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=atol, rtol=atol)
        assert not got[0].any()

    @pytest.mark.parametrize("bs,rows", [(256, 64), (256, 128), (256, 512),
                                         (16, 16), (16, 32), (16, 128),
                                         (512, 256)])
    def test_chunk_rows(self, bs, rows):
        """Chunks smaller than a pool block (several a block, each at an
        offset) and larger (several blocks a chunk)."""
        lens, s = _edges(bs)
        q, _, _, pk, pv, table, L = _paged_case(len(lens), 8, 4, s, 128,
                                                bs, lens, seed=rows)
        qt, pkt, pvt, tt, Lt = _on_card(torch.float32, q, pk, pv, table, L)
        got = torch.empty_like(qt)
        TDA._paged_launch(TDA._library(), qt, pkt, pvt, tt, Lt, got,
                          128 ** -0.5,
                          torch.cuda.current_stream().cuda_stream,
                          chunk_rows=rows)
        want = TDA.paged_decode_attention_reference(qt, pkt, pvt, tt, Lt)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)

    def test_stacked_layer_view(self):
        """Layer 1 of a stacked [L, N, Hkv, bs, D] pool: the view's offset
        reaches the split kernel."""
        lens, s = _edges(16)
        q, _, _, pk, pv, table, L = _paged_case(len(lens), 8, 4, s, 128,
                                                16, lens, seed=5)
        qt, pkt, pvt, tt, Lt = _on_card(torch.float32, q, pk, pv, table, L)
        spk = torch.stack([pkt * 3, pkt, pkt * 2])
        spv = torch.stack([pvt * 3, pvt, pvt * 2])
        got = TDA.paged_decode_attention(qt, spk, spv, tt, Lt, layer=1)
        want = TDA.paged_decode_attention_reference(qt, pkt, pvt, tt, Lt)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)

    def test_runs_bit_identical(self):
        """The partials merge in chunk order: two runs give the same
        bits."""
        lens, s = _edges(256)
        q, _, _, pk, pv, table, L = _paged_case(len(lens), 32, 32, s, 128,
                                                256, lens, seed=12)
        qt, pkt, pvt, tt, Lt = _on_card(torch.bfloat16, q, pk, pv, table,
                                        L)
        first = TDA.paged_decode_attention(qt, pkt, pvt, tt, Lt)
        again = TDA.paged_decode_attention(qt, pkt, pvt, tt, Lt)
        torch.cuda.synchronize()
        assert torch.equal(first, again)


def _edges(bs):
    """The chunk and block edges of a lane at pool block size ``bs``,
    and a table reach of M * bs rows (four chunks or more) holding
    them."""
    c = TDA.paged_chunk_rows(bs)
    s = bs * -(-(3 * c + 45) // bs)
    return [0, 1, c - 1, c, c + 1, bs - 1, bs + 1, s], s


def _on_card(dtype, q, pk, pv, table, lens):
    dev = torch.device("cuda")
    return (*(torch.as_tensor(a, device=dev).to(dtype) for a in (q, pk, pv)),
            torch.as_tensor(table, device=dev),
            torch.as_tensor(lens, device=dev))


def _quant_pool(rng, lens, hq, hkv, d, bs, m, dtype, layers=0):
    """Random int8 pool operands on the card under a scrambled block
    map: q, codes, scales and tails (unrelated to the codes, so the
    frontier block must come from the tail), the table and lengths;
    stacked over ``layers`` when given."""
    b = len(lens)
    n = b * m + 3
    lead = (layers,) if layers else ()
    dev = torch.device("cuda")
    q = torch.as_tensor(rng.standard_normal((b, hq, d)), device=dev)
    kp, vp = (torch.as_tensor(rng.integers(-127, 128, lead + (n, hkv, bs, d)),
                              device=dev).to(torch.int8) for _ in range(2))
    ks, vs = (torch.as_tensor(rng.random(lead + (n, hkv)) * 0.008 + 0.004,
                              device=dev).float() for _ in range(2))
    kt, vt = (torch.as_tensor(rng.standard_normal(lead + (b + 1, hkv, bs, d)),
                              device=dev).to(dtype) for _ in range(2))
    table = torch.as_tensor(
        rng.permutation(np.arange(1, n))[:b * m].reshape(b, m)
        .astype(np.int32), device=dev)
    L = torch.as_tensor(np.asarray(lens, np.int32), device=dev)
    return q.to(dtype), kp, vp, ks, vs, kt, vt, table, L


@pytest.mark.cuda
class TestQuantKernelOnCard:
    """The int8 pool's CUDA kernel against its plain version on the
    card: lengths {0, 1, bs-1, bs, bs+1, full, a non-multiple} under a
    scrambled block map, codes and tails unrelated so the frontier
    block must come from the tail."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")

    @pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                            (torch.bfloat16, 1e-2)])
    @pytest.mark.parametrize("hq,hkv,d,bs", [(2, 2, 16, 8), (4, 2, 64, 16),
                                             (16, 4, 128, 256),
                                             (2, 2, 8, 8), (4, 2, 24, 16)])
    def test_matches_plain(self, dtype, atol, hq, hkv, d, bs):
        """D 8 and 24: code rows that are not a multiple of 16 bytes go
        by 8-byte copies, not bulk copies."""
        rng = np.random.default_rng(40)
        lens = [0, 1, bs - 1, bs, bs + 1, 4 * bs, 2 * bs + 3]
        b, m = len(lens), 4
        n = b * m + 3
        dev = torch.device("cuda")
        q = torch.as_tensor(rng.standard_normal((b, hq, d)), device=dev)
        kp, vp = (torch.as_tensor(rng.integers(-127, 128, (n, hkv, bs, d)),
                                  device=dev).to(torch.int8)
                  for _ in range(2))
        ks, vs = (torch.as_tensor(rng.random((n, hkv)) * 0.008 + 0.004,
                                  device=dev).float() for _ in range(2))
        kt, vt = (torch.as_tensor(rng.standard_normal((b + 1, hkv, bs, d)),
                                  device=dev).to(dtype) for _ in range(2))
        table = torch.as_tensor(
            rng.permutation(np.arange(1, n))[:b * m].reshape(b, m)
            .astype(np.int32), device=dev)
        L = torch.as_tensor(np.asarray(lens, np.int32), device=dev)
        q = q.to(dtype)
        before = TDA.paged_decode_attention.quant_launches
        got = TDA.paged_decode_attention(q, kp, vp, table, L, k_scale=ks,
                                         v_scale=vs, k_tail=kt,
                                         v_tail=vt).float()
        assert TDA.paged_decode_attention.quant_launches == before + 1
        # f32 q; the tails in the kernel's dtype, so the plain view
        # rounds code x scale to it as the kernel must
        want = TDA.paged_decode_attention_quant_reference(
            q.float(), kp, vp, table, L, ks, vs, kt, vt)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=atol, rtol=atol)
        # as a whole too: |out| is a few times the bf16 atol at long fills
        assert float((got - want).norm() / want.norm()) <= 1e-2

    @pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                            (torch.bfloat16, 1e-2)])
    @pytest.mark.parametrize("hq,hkv", [(8, 8), (8, 4), (16, 4)])
    @pytest.mark.parametrize("d", [64, 128])
    @pytest.mark.parametrize("bs", [16, 256])
    def test_chunk_edges(self, dtype, atol, hq, hkv, d, bs):
        """The split's chunk and block edges over the int8 pool, with R =
        1, 2 and 4 query heads a block; a length-0 lane gives zeros."""
        lens, s = _edges(bs)
        q, kp, vp, ks, vs, kt, vt, table, L = _quant_pool(
            np.random.default_rng(d + hq + bs), lens, hq, hkv, d, bs,
            s // bs, dtype)
        got = TDA.paged_decode_attention(q, kp, vp, table, L, k_scale=ks,
                                         v_scale=vs, k_tail=kt,
                                         v_tail=vt).float()
        want = TDA.paged_decode_attention_quant_reference(
            q.float(), kp, vp, table, L, ks, vs, kt, vt)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=atol, rtol=atol)
        assert float((got - want).norm() / want.norm()) <= 1e-2
        assert not got[0].any()

    @pytest.mark.parametrize("rows", [64, 512])
    def test_chunk_rows_and_stacked_layer(self, rows):
        """Chunks of a quarter block and of two blocks, on layer 1 of a
        stacked pool: the view's offset reaches the kernel, and each
        tile still takes its tail-or-codes choice."""
        lens, s = _edges(256)
        q, kp, vp, ks, vs, kt, vt, table, L = _quant_pool(
            np.random.default_rng(rows), lens, 8, 4, 128, 256, s // 256,
            torch.float32, layers=3)
        got = torch.empty_like(q)
        TDA._paged_quant_launch(TDA._library(), q, kp[1], vp[1], ks[1],
                                vs[1], kt[1], vt[1], table, L, got,
                                128 ** -0.5,
                                torch.cuda.current_stream().cuda_stream,
                                chunk_rows=rows)
        want = TDA.paged_decode_attention_quant_reference(
            q, kp[1], vp[1], table, L, ks[1], vs[1], kt[1], vt[1])
        stacked = TDA.paged_decode_attention(q, kp, vp, table, L, layer=1,
                                             k_scale=ks, v_scale=vs,
                                             k_tail=kt, v_tail=vt)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=1e-4, rtol=1e-4)
        torch.testing.assert_close(stacked, want, atol=1e-4, rtol=1e-4)

    def test_runs_bit_identical(self):
        lens, s = _edges(256)
        q, kp, vp, ks, vs, kt, vt, table, L = _quant_pool(
            np.random.default_rng(13), lens, 32, 32, 128, 256, s // 256,
            torch.bfloat16)
        kw = dict(k_scale=ks, v_scale=vs, k_tail=kt, v_tail=vt)
        first = TDA.paged_decode_attention(q, kp, vp, table, L, **kw)
        again = TDA.paged_decode_attention(q, kp, vp, table, L, **kw)
        torch.cuda.synchronize()
        assert torch.equal(first, again)

    @pytest.mark.parametrize("bs,m", [(16, 4), (16, 40), (256, 5)])
    def test_equals_bf16_pool_kernel(self, bs, m):
        """On the rows dequantized and rounded to bf16, laid out as a bf16
        pool (each lane's frontier block from its tail), the int8 kernel
        and the bf16 paged kernel give the same bits — also where a
        lane's fill spans several chunks."""
        rng = np.random.default_rng(41)
        b, hq, hkv, d = 4, 8, 4, 128
        n = b * m + 1
        dev = torch.device("cuda")
        q = torch.as_tensor(rng.standard_normal((b, hq, d)),
                            device=dev).to(torch.bfloat16)
        kp, vp = (torch.as_tensor(rng.integers(-127, 128, (n, hkv, bs, d)),
                                  device=dev).to(torch.int8)
                  for _ in range(2))
        ks, vs = (torch.as_tensor(rng.random((n, hkv)) * 0.008 + 0.004,
                                  device=dev).float() for _ in range(2))
        kt, vt = (torch.as_tensor(rng.standard_normal((b + 1, hkv, bs, d)),
                                  device=dev).to(torch.bfloat16)
                  for _ in range(2))
        table = torch.as_tensor(
            rng.permutation(np.arange(1, n))[:b * m].reshape(b, m)
            .astype(np.int32), device=dev)
        L = torch.as_tensor(np.asarray([1, bs, 2 * bs + 5, m * bs],
                                       np.int32), device=dev)
        wb = (torch.clamp(L.long() - 1, min=0) // bs)
        front = table[torch.arange(b, device=dev), wb].long()
        kb = (kp.float() * ks[..., None, None]).to(torch.bfloat16)
        vb = (vp.float() * vs[..., None, None]).to(torch.bfloat16)
        kb[front], vb[front] = kt[:b], vt[:b]
        got = TDA.paged_decode_attention(q, kp, vp, table, L, k_scale=ks,
                                         v_scale=vs, k_tail=kt, v_tail=vt)
        want = TDA.paged_decode_attention(q, kb, vb, table, L)
        assert torch.equal(got, want)
