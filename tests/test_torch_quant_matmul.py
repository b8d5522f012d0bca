"""The torch package's int8-weight decode matmul (paddle_operator_tpu_torch/
ops/quant_matmul.py): its plain version against the JAX package's
formula (``infer/decode.py`` ``_mm`` on a ``{"q", "s"}`` leaf, written
out with ``jnp`` on leaves from the JAX ``infer/quant.py``), the route by
rows, the wrapper's checks and the host plan of the split over K — and,
``-m cuda``, the CUDA kernel against its plain version on the card: the
7b shapes at 1, 4, 8 and 16 rows, int8 and int4 codes, bf16 and f32
activations, K and N off the tile, an all-zero column, a bit-identical
rerun and a CUDA-graph replay.  This file imports no module of the JAX
package that needs flax, so the card's machine can run it.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_operator_tpu.infer import quant as JQ
from paddle_operator_tpu_torch.infer import quant as Q
from paddle_operator_tpu_torch.ops import quant_matmul as QM

TOL = 1e-5     # f32, the same products, summation order aside


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
    # on a CPU tensor the wrapper is the plain version, at any row count
    assert torch.equal(QM.quant_matmul(torch.as_tensor(x), q, s), got)


@pytest.mark.parametrize("rows,route", [(1, "kernel"), (8, "kernel"),
                                        (16, "kernel"), (17, "formula"),
                                        (512, "formula")])
def test_route_by_rows(monkeypatch, rows, route):
    taken = []
    monkeypatch.setattr(QM, "quant_matmul",
                        lambda x, q, s: taken.append("kernel") or x)
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


def test_shapes_checked():
    codes = torch.zeros(8, 4, dtype=torch.int8)
    with pytest.raises(ValueError, match="do not match"):
        QM.quant_matmul(torch.zeros(2, 7), codes, torch.ones(1, 4))
    with pytest.raises(ValueError, match="do not match"):
        QM.quant_matmul(torch.zeros(2, 8), codes, torch.ones(1, 5))


def test_cuda_tensor_never_falls_back(monkeypatch):
    """The kernel's input checks run for a CUDA tensor (here: a faked
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


# the 7b projections (K x N) and the legacy lm_head
SHAPES_7B = [(4096, 4096), (4096, 11008), (11008, 4096), (4096, 32000)]
# off the tile: K not a multiple of 128 or of a split; N not a multiple
# of 128 (4112: the copies' path, a 16-column last tile) or of 16 (the
# bytewise path)
TAIL_SHAPES = [(4100, 4112), (4100, 4104), (1000, 130), (77, 1001), (3, 5)]


@pytest.mark.cuda
class TestKernelOnCard:
    """The CUDA kernel against its plain version on the card, in f32
    (the plain version's arithmetic up to summation order) and bf16
    (against the plain version in f32 on the same bf16 inputs: the
    kernel rounds once, after the scale)."""

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

    @pytest.mark.parametrize("mode", ["int8", "int4"])
    @pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-4),
                                            (torch.bfloat16, 1e-2)])
    @pytest.mark.parametrize("m", [1, 4, 8, 16])
    @pytest.mark.parametrize("k,n", SHAPES_7B + TAIL_SHAPES)
    def test_kernel_matches_plain(self, k, n, m, dtype, atol, mode):
        x, q, s = self._operands(m, k, n, mode, dtype)
        n0 = QM.quant_matmul.launches
        got = QM.quant_matmul(x, q, s)
        torch.cuda.synchronize()
        assert QM.quant_matmul.launches == n0 + 1
        assert got.dtype == dtype and got.shape == (m, n)
        want = QM.quant_matmul_reference(x.float(), q, s)
        err = (got.float() - want).abs().max().item()
        assert err <= atol, err
        assert not got[:, n // 2].any()        # the all-zero column

    @pytest.mark.parametrize("m", [3, 8])
    def test_rerun_bit_identical_and_graph_replay(self, m):
        x, q, s = self._operands(m, 11008, 4096, "int8", torch.bfloat16, 1)
        a = QM.quant_matmul(x, q, s)
        b = QM.quant_matmul(x, q, s)
        assert torch.equal(a, b)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            c = QM.quant_matmul(x, q, s)
        g.replay()
        torch.cuda.synchronize()
        assert torch.equal(a, c)

    def test_route_on_card(self):
        """Decode rows launch the kernel; a prefill's rows take the
        formula and launch nothing."""
        x, q, s = self._operands(16, 4096, 4096, "int8", torch.bfloat16)
        n0 = QM.quant_matmul.launches
        QM.quant_mm(x[None], q, s)
        assert QM.quant_matmul.launches == n0 + 1
        long = torch.randn(1, 40, 4096, device="cuda").bfloat16()
        out = QM.quant_mm(long, q, s)
        assert QM.quant_matmul.launches == n0 + 1
        assert torch.equal(out, QM.quant_matmul_reference(long, q, s))

    def test_too_many_rows_raises(self):
        x, q, s = self._operands(17, 64, 64, "int8", torch.float32)
        with pytest.raises(ValueError, match="at most 16"):
            QM.quant_matmul(x, q, s)
