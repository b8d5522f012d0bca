"""The torch package's 8-bit AdamW update (paddle_operator_tpu_torch/ops/
adam8bit.py): on the CPU the wrapper's contract (CPU tensors take the
plain version and count no launch), the constants and the byte count;
``-m cuda``, the CUDA kernel of ``csrc/adam8bit.cu`` against its plain
version on the card, bit for bit in p, the codes and the scales over
three updates: the 7b shapes' last axes, a last axis that is not a
multiple of 256 (16-byte path), rows of odd length (value-by-value
path), a clip that bites and one that does not.  The plain version
itself is held against the JAX package in tests/test_torch_opt8bit.py;
this file imports nothing of the JAX package, so the card's machine runs
it.
"""

import numpy as np
import pytest
import torch

from paddle_operator_tpu_torch.ops import adam8bit as A8
from paddle_operator_tpu_torch.train import opt8bit as Q8


def _consts(count, lr=1e-3):
    return A8.Adam8bitConsts.make(b1=0.9, b2=0.95, eps=1e-8,
                                  weight_decay=0.1, lr=lr, clip=1.0,
                                  count=count)


def _state(shape, device, seed=0):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    p = torch.randn(shape, generator=g, device=device) * 0.02
    mu = Q8.quantize_q8(torch.zeros(shape, device=device))
    nu = Q8.quantize_q8u(torch.zeros(shape, device=device))
    return p, mu, nu, g


def test_constants_are_f32_values():
    k = _consts(3, lr=3e-4)
    for v in (k.b1, k.omb1, k.b2, k.omb2, k.bc1, k.bc2, k.eps, k.wd,
              k.neg_lr, k.clip):
        assert float(np.float32(v)) == v
    assert k.neg_lr == float(np.float32(-3e-4))
    assert k.bc1 == float(np.float32(1) - np.float32(0.9) ** 3)
    t = k.tensors(torch.zeros(1))
    assert all(x.dtype == torch.float32 and x.dim() == 0 for x in t.values())


@pytest.mark.parametrize("shape,blocks", [((4096, 4096), 4096 * 16),
                                          ((4096,), 16), ((3, 1000), 12)])
def test_bytes_moved(shape, blocks):
    n = int(np.prod(shape))
    assert A8.bytes_moved(shape) == 12 * n + 4 * (blocks * 256 + 4 * blocks)


def test_cpu_tensors_take_the_plain_version():
    p, mu, nu, _ = _state((3, 300), "cpu")
    g = torch.randn(3, 300)
    want = [t.clone() for t in (p, *mu, *nu)]
    A8.adam8bit_update_reference(want[0], g, Q8.Q8(*want[1:3]),
                                 Q8.Q8(*want[3:5]), torch.tensor(0.5),
                                 _consts(1))
    n0 = A8.adam8bit_update.launches
    A8.adam8bit_update(p, g, mu, nu, torch.tensor(0.5), _consts(1))
    assert A8.adam8bit_update.launches == n0
    for a, b in zip((p, *mu, *nu), want):
        assert torch.equal(a, b)


# the 7b update's tensors (wq/wk/wv/wo, w1/w3, w2, the embedding and
# lm_head, a norm scale), a last axis off 256, and odd rows
SHAPES_7B = [(4096, 4096), (4096, 11008), (11008, 4096), (32000, 4096),
             (4096, 32000), (4096,)]
TAIL_SHAPES = [(3, 1000), (5, 77), (7,), (2, 3, 300), (1, 257)]


@pytest.mark.cuda
class TestKernelOnCard:
    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")

    @pytest.mark.parametrize("norm", [0.5, 3.0])
    @pytest.mark.parametrize("shape", SHAPES_7B + TAIL_SHAPES)
    def test_kernel_equals_plain_bit_for_bit(self, shape, norm):
        p, mu, nu, gen = _state(shape, "cuda")
        ref = [t.clone() for t in (p, *mu, *nu)]
        n0 = A8.adam8bit_update.launches
        for count in (1, 2, 3):
            g = torch.randn(shape, generator=gen, device="cuda") * 0.1
            nrm = torch.tensor(norm, device="cuda")
            A8.adam8bit_update(p, g, mu, nu, nrm, _consts(count))
            A8.adam8bit_update_reference(ref[0], g, Q8.Q8(*ref[1:3]),
                                         Q8.Q8(*ref[3:5]), nrm,
                                         _consts(count))
            torch.cuda.synchronize()
            for name, a, b in zip(("p", "mu codes", "mu scales",
                                   "nu codes", "nu scales"),
                                  (p, *mu, *nu), ref):
                assert torch.equal(a, b), (name, count,
                                           int((a != b).sum()))
        assert A8.adam8bit_update.launches == n0 + 3
        assert (mu.codes != 0).any() and (nu.codes != -127).any()

    def test_unaligned_view_takes_the_scalar_path(self):
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1)
        flat = torch.randn(4097, generator=gen, device="cuda")
        p = flat[1:].view(1, 4096)            # 4-byte aligned only
        g = torch.randn(1, 4096, generator=gen, device="cuda")
        assert not A8.vector_path(p, g)
        mu = Q8.quantize_q8(torch.zeros(1, 4096, device="cuda"))
        nu = Q8.quantize_q8u(torch.zeros(1, 4096, device="cuda"))
        ref = [t.clone() for t in (p, *mu, *nu)]
        nrm = torch.tensor(2.0, device="cuda")
        A8.adam8bit_update(p, g, mu, nu, nrm, _consts(1))
        A8.adam8bit_update_reference(ref[0], g, Q8.Q8(*ref[1:3]),
                                     Q8.Q8(*ref[3:5]), nrm, _consts(1))
        for a, b in zip((p, *mu, *nu), ref):
            assert torch.equal(a, b)

    def test_refuses_what_it_does_not_take(self):
        p, mu, nu, _ = _state((4, 512), "cuda")
        g = torch.zeros(4, 512, device="cuda")
        nrm = torch.tensor(1.0, device="cuda")
        with pytest.raises(ValueError, match="not torch.float32"):
            A8.adam8bit_update(p, g.double(), mu, nu, nrm, _consts(1))
        with pytest.raises(ValueError, match="contiguous"):
            A8.adam8bit_update(p.t().contiguous().t(), g, mu, nu, nrm,
                               _consts(1))
        with pytest.raises(ValueError, match="norm on cpu"):
            A8.adam8bit_update(p, g, mu, nu, torch.tensor(1.0), _consts(1))
