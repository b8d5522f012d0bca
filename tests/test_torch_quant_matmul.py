"""The torch package's int8-weight matmul (paddle_operator_tpu_torch/
ops/quant_matmul.py): its plain version against the JAX package's
formula (``infer/decode.py`` ``_mm`` on a ``{"q", "s"}`` leaf, written
out with ``jnp`` on leaves from the JAX ``infer/quant.py``, and ``_mm``
itself at prefill row counts), the route by rows between kernel A
(``quant_matmul``) and kernel B (``quant_gemm``), the wrappers' checks
and the host plans of both kernels — and, ``-m cuda``, both CUDA kernels
against their plain version on the card: the 7b shapes over each
kernel's rows, int8 and int4 codes, bf16 and f32 activations, K and N
off the tile, an all-zero column, bit-identical reruns and CUDA-graph
replays.  This file imports no module of the JAX package that needs
flax at import (``_mm`` is imported inside its test), so the card's
machine can run it.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_operator_tpu.infer import quant as JQ
from paddle_operator_tpu_torch.infer import quant as Q
from paddle_operator_tpu_torch.ops import quant_matmul as QM

TOL = 1e-5     # f32, the same products, summation order aside
LIMIT = QM.KERNEL_MAX_ROWS


def _case(m, k, n, mode, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((k, n)).astype(np.float32) * 0.02
    w[:, n // 2] = 0.0                    # an all-zero column: scale 1.0
    return x, w, JQ.quantize_leaf(jnp.asarray(w), mode)


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("lead", [(3,), (2, 5), (1, 1)])
def test_reference_matches_jax_formula(mode, lead):
    x, _, leaf = _case(int(np.prod(lead)), 40, 24, mode)
    x = x.reshape(*lead, 40)
    want = np.asarray((jnp.asarray(x) @ leaf["q"].astype(jnp.float32))
                      * leaf["s"][..., 0, :].astype(jnp.float32))
    q = torch.as_tensor(np.array(leaf["q"], np.int8))
    s = torch.as_tensor(np.array(leaf["s"]))
    got = QM.quant_matmul_reference(torch.as_tensor(x), q, s)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    # on a CPU tensor both wrappers are the plain version, at any row count
    assert torch.equal(QM.quant_matmul(torch.as_tensor(x), q, s), got)
    assert torch.equal(QM.quant_gemm(torch.as_tensor(x), q, s), got)


@pytest.mark.parametrize("mode", ["int8", "int4"])
@pytest.mark.parametrize("rows", [17, 40, 256])
def test_reference_matches_jax_mm_at_prefill_rows(mode, rows):
    """The plain version against the JAX package's own ``_mm`` at the row
    counts a verify (40) and prefills (17, 256) send, in f32 and bf16."""
    from paddle_operator_tpu.infer.decode import _mm

    x, _, leaf = _case(rows, 96, 72, mode, seed=rows)
    q = torch.as_tensor(np.array(leaf["q"], np.int8))
    s = torch.as_tensor(np.array(leaf["s"]))
    want = np.asarray(_mm(jnp.asarray(x), leaf, jnp.float32))
    got = QM.quant_mm(torch.as_tensor(x), q, s)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    want = np.asarray(_mm(xb, leaf, jnp.bfloat16).astype(jnp.float32))
    got = QM.quant_mm(torch.as_tensor(x).bfloat16(), q, s)
    # one bf16 rounding of the product and one of the scale apart at most
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -7,
                               atol=1e-6)


def _route(rows):
    return "A" if rows <= LIMIT else "B"


@pytest.mark.parametrize("rows,route", [
    (r, _route(r)) for r in (1, 8, 16, 17, 512, 40, 64, 256, 2048,
                             LIMIT - 1, LIMIT, LIMIT + 1)])
def test_route_by_rows(monkeypatch, rows, route):
    taken = []
    monkeypatch.setattr(QM, "quant_matmul",
                        lambda x, q, s: taken.append("A") or x)
    monkeypatch.setattr(QM, "quant_gemm",
                        lambda x, q, s: taken.append("B") or x)
    monkeypatch.setattr(QM, "quant_matmul_reference",
                        lambda x, q, s: taken.append("formula") or x)
    QM.quant_mm(torch.zeros(1, rows, 8), torch.zeros(8, 4, dtype=torch.int8),
                torch.ones(1, 4))
    assert taken == [route]


@pytest.mark.parametrize("k,n", [(4096, 4096), (4096, 11008), (11008, 4096),
                                 (4096, 32000), (5, 3), (64, 256),
                                 (300, 7), (100000, 8)])
def test_split_plan_covers_k(k, n):
    splits, rows = QM.split_plan(k, n, 132)
    assert rows % QM.BATCH_ROWS == 0 and 0 < rows <= QM.MAX_SPLIT_ROWS
    assert (splits - 1) * rows < k <= splits * rows
    tiles = -(-n // QM.TILE_N)
    if k >= 2 * QM.MIN_SPLIT_ROWS and tiles < 132:
        assert splits > 1          # the card gets more than a tile's blocks


SHAPES_PLAN = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000),
               (4100, 4104), (77, 1001), (3, 5), (100000, 8)]


def _covers(plan, m, k, n, block_rows, tile_cols):
    blocks, tiles, splits, rows = plan
    assert (blocks - 1) * block_rows < m <= blocks * block_rows
    assert (tiles - 1) * tile_cols < n <= tiles * tile_cols
    assert rows % QM.BATCH_ROWS == 0 and splits >= 1
    assert (splits - 1) * rows < k <= splits * rows


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, 8, 16, 17, 40, LIMIT])
@pytest.mark.parametrize("k,n", SHAPES_PLAN)
def test_matmul_plan_covers_rows_k_and_n(k, n, m, dtype):
    """Kernel A's grid covers M, K and N from host shapes alone: one row
    block at bf16, blocks of 16 rows at f32, whose splits stage at most
    MAX_SPLIT_ROWS rows of K."""
    plan = QM.matmul_plan(m, k, n, dtype, 132)
    f32 = dtype == torch.float32
    _covers(plan, m, k, n, QM.F32_GROUP_ROWS if f32 else LIMIT, QM.TILE_N)
    if f32:
        assert plan[3] <= QM.MAX_SPLIT_ROWS
    else:
        assert plan[0] == 1
    if k >= 2 * QM.MIN_SPLIT_ROWS and plan[0] * plan[1] < 132:
        assert plan[2] > 1


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("m", [1, LIMIT + 1, 256, 512, 2048, 5000])
@pytest.mark.parametrize("k,n", SHAPES_PLAN)
def test_gemm_plan_covers_rows_k_and_n(k, n, m, dtype):
    """Kernel B's grid covers M, K and N from host shapes alone: blocks of
    GEMM_BLOCK_ROWS x GEMM_TILE_N at bf16, one an SM, split over K only
    while the blocks leave half the card idle; one pass of 64 x 64 tiles
    at f32."""
    plan = QM.gemm_plan(m, k, n, dtype, 132)
    if dtype == torch.float32:
        _covers(plan, m, k, n, QM.GEMM_F32_TILE, QM.GEMM_F32_TILE)
        assert plan[2] == 1
        return
    _covers(plan, m, k, n, QM.GEMM_BLOCK_ROWS, QM.GEMM_TILE_N)
    units = plan[0] * plan[1]
    if 2 * units > 132:
        assert plan[2] == 1        # a second split would overfill the card
    elif k >= 2 * QM.MIN_SPLIT_ROWS:
        assert plan[2] > 1


def test_shapes_checked():
    codes = torch.zeros(8, 4, dtype=torch.int8)
    for fn in (QM.quant_matmul, QM.quant_gemm):
        with pytest.raises(ValueError, match="do not match"):
            fn(torch.zeros(2, 7), codes, torch.ones(1, 4))
        with pytest.raises(ValueError, match="do not match"):
            fn(torch.zeros(2, 8), codes, torch.ones(1, 5))
        with pytest.raises(ValueError, match="do not match"):
            fn(torch.zeros(2, 8), torch.zeros(8, dtype=torch.int8),
               torch.ones(1, 8))


def test_cuda_tensor_never_falls_back(monkeypatch):
    """The kernels' input checks run for a CUDA tensor (here: a faked
    device) and nothing reaches the plain version."""
    monkeypatch.setattr(QM, "quant_matmul_reference",
                        lambda *a: pytest.fail("plain version"))
    x = torch.zeros(2, 8, dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        QM._check_kernel_inputs(x, torch.zeros(8, 4, dtype=torch.int8),
                                torch.ones(1, 4))
    with pytest.raises(ValueError, match="int8"):
        QM._check_kernel_inputs(torch.zeros(2, 8),
                                torch.zeros(8, 4, dtype=torch.int16),
                                torch.ones(1, 4))


def test_kernel_b_checks(monkeypatch):
    """Kernel B's wrapper checks what its kernel does not take before any
    launch, and names itself."""
    monkeypatch.setattr(QM, "_library",
                        lambda: pytest.fail("launched an unchecked input"))
    codes = torch.zeros(8, 4, dtype=torch.int8)
    with pytest.raises(ValueError, match="quant_gemm: dtype"):
        QM._check_kernel_inputs(torch.zeros(80, 8, dtype=torch.float16),
                                codes, torch.ones(1, 4), "quant_gemm")
    with pytest.raises(ValueError, match="quant_gemm: the codes"):
        QM._check_kernel_inputs(torch.zeros(80, 8), codes.to(torch.uint8),
                                torch.ones(1, 4), "quant_gemm")
    with pytest.raises(ValueError, match="quant_gemm: the codes"):
        QM._check_kernel_inputs(torch.zeros(80, 8), codes,
                                torch.ones(1, 4, dtype=torch.float64),
                                "quant_gemm")
    with pytest.raises(ValueError, match="quant_gemm: q must be contiguous"):
        QM._check_kernel_inputs(torch.zeros(80, 8),
                                torch.zeros(4, 8, dtype=torch.int8).t(),
                                torch.ones(1, 4), "quant_gemm")
    with pytest.raises(ValueError, match="quant_gemm: empty codes"):
        QM._check_kernel_inputs(torch.zeros(80, 0),
                                torch.zeros(0, 4, dtype=torch.int8),
                                torch.ones(1, 4), "quant_gemm")


# the 7b projections (K x N) and the legacy lm_head
SHAPES_7B = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)]
# off the tile: K not a multiple of 128 or of a split; N not a multiple
# of 128 (4112: the copies' path, a 16-column last tile) or of 16 (the
# bytewise path)
TAIL_SHAPES = [(4100, 4112), (4100, 4104), (1000, 130), (77, 1001), (3, 5)]
ROWS_A = [1, 4, 8, 16, 24, 40, LIMIT]
ROWS_B = [17, 40, 64, 256, 512, 2048]


@pytest.mark.cuda
class TestKernelOnCard:
    """The CUDA kernels against their plain version on the card, in f32
    (the plain version's arithmetic up to summation order) and bf16
    (against the plain version in f32 on the same bf16 inputs: the
    kernels round once, after the scale)."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")

    @staticmethod
    def _operands(m, k, n, mode, dtype, seed=0):
        g = torch.Generator(device="cuda")
        g.manual_seed(seed)
        # |out| about 0.25: bf16's rounding of the output stays well
        # inside the tolerance
        w = torch.randn(k, n, generator=g, device="cuda") * (0.25 / k ** 0.5)
        w[:, n // 2] = 0.0
        leaf = Q.quantize_leaf(w, mode)
        x = torch.randn(m, k, generator=g, device="cuda").to(dtype)
        return x, leaf["q"], leaf["s"]

    def _check(self, fn, k, n, m, dtype, atol, mode):
        x, q, s = self._operands(m, k, n, mode, dtype)
        n0 = fn.launches
        got = fn(x, q, s)
        torch.cuda.synchronize()
        assert fn.launches == n0 + 1
        assert got.dtype == dtype and got.shape == (m, n)
        want = QM.quant_matmul_reference(x.float(), q, s)
        err = (got.float() - want).abs().max().item()
        assert err <= atol, err
        assert not got[:, n // 2].any()        # the all-zero column

    @pytest.mark.parametrize("mode", ["int8", "int4"])
    @pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                            (torch.bfloat16, 1e-2)])
    @pytest.mark.parametrize("m", ROWS_A)
    @pytest.mark.parametrize("k,n", SHAPES_7B + TAIL_SHAPES)
    def test_kernel_matches_plain(self, k, n, m, dtype, atol, mode):
        self._check(QM.quant_matmul, k, n, m, dtype, atol, mode)

    @pytest.mark.parametrize("mode", ["int8", "int4"])
    @pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                            (torch.bfloat16, 1e-2)])
    @pytest.mark.parametrize("m", ROWS_B)
    @pytest.mark.parametrize("k,n", SHAPES_7B + TAIL_SHAPES)
    def test_kernel_b_matches_plain(self, k, n, m, dtype, atol, mode):
        self._check(QM.quant_gemm, k, n, m, dtype, atol, mode)

    @pytest.mark.parametrize("fn,m", [(QM.quant_matmul, 3),
                                      (QM.quant_matmul, 8),
                                      (QM.quant_matmul, 40),
                                      (QM.quant_gemm, LIMIT + 1),
                                      (QM.quant_gemm, 512)])
    def test_rerun_bit_identical_and_graph_replay(self, fn, m):
        x, q, s = self._operands(m, 11008, 4096, "int8", torch.bfloat16, 1)
        a = fn(x, q, s)
        b = fn(x, q, s)
        assert torch.equal(a, b)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            c = fn(x, q, s)
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(a, c)

    def test_route_on_card(self, monkeypatch):
        """Decode rows launch kernel A; 40 rows launch the kernel the route
        names for them; a prefill's rows launch kernel B; the formula is
        never called."""
        monkeypatch.setattr(QM, "quant_matmul_reference",
                            lambda *a: pytest.fail("the plain formula ran"))
        x, q, s = self._operands(16, 4096, 4096, "int8", torch.bfloat16)
        a0, b0 = QM.quant_matmul.launches, QM.quant_gemm.launches
        QM.quant_mm(x[None], q, s)
        assert (QM.quant_matmul.launches, QM.quant_gemm.launches) == \
            (a0 + 1, b0)
        verify = torch.randn(1, 40, 4096, device="cuda").bfloat16()
        QM.quant_mm(verify, q, s)
        a_rows = 40 <= LIMIT
        assert (QM.quant_matmul.launches, QM.quant_gemm.launches) == \
            (a0 + 1 + a_rows, b0 + (not a_rows))
        long = torch.randn(1, 300, 4096, device="cuda").bfloat16()
        QM.quant_mm(long, q, s)
        assert QM.quant_gemm.launches == b0 + 1 + (not a_rows)

    def test_too_many_rows_raises(self):
        x, q, s = self._operands(LIMIT + 1, 64, 64, "int8", torch.float32)
        with pytest.raises(ValueError, match=f"at most {LIMIT}"):
            QM.quant_matmul(x, q, s)
