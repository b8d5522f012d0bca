"""Non-finite K/V rows through the decode kernels #1-#3
(paddle_operator_tpu_torch/ops/decode_attention.py): the NaN-lane
quarantine (SERVE_NAN_CHECK) only fires if a NaN row reaches the
logits, as the JAX package's kernels and reference let it through.

Each case poisons some lanes with NaN only in rows the lane attends:
(a) one all-NaN chunk of a kv head among finite ones, (b) every visible
row of a lane NaN (one chunk, and several), a NaN V row, and for the
int8 pool (c) a NaN scale on one block and NaN staging-tail rows.  On
the CPU the port's plain versions are held against the JAX reference:
non-finite exactly where it is, equal elsewhere.  On the card (``-m
cuda``) each kernel is held against its plain version the same way,
and every value that is finite — every head of an unpoisoned lane, and
the unpoisoned heads of a poisoned one — must equal, bit for bit, the
kernel's output on the same inputs without the NaNs.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_operator_tpu.ops import decode_attention as JDA
from paddle_operator_tpu_torch.ops import decode_attention as TDA

C = TDA.CHUNK_ROWS
NAN = np.float32("nan")
HQ, HKV = 8, 4


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def contiguous_case(d, seed=0):
    """Kernel #1's operands (q, k, v, lengths) clean and poisoned, as
    numpy.  Lanes: 0 finite, full cache; 1 (a) rows [C, 2C) NaN in kv
    head 0; 2 (b) every visible row NaN in kv head 1, one chunk; 3 (b)
    every visible row NaN, every head, three chunks; 4 length 0; 5
    finite; 6 one NaN V row in kv head 2."""
    rng = np.random.default_rng(seed)
    s = 3 * C + 45
    lens = np.asarray([s, 2 * C + 10, 100, 2 * C + 10, 0, C + 1, 3 * C],
                      np.int32)
    b = len(lens)
    q = _rand(rng, (b, HQ, d))
    k = _rand(rng, (b, HKV, s, d))
    v = _rand(rng, (b, HKV, s, d))
    kp, vp = k.copy(), v.copy()
    kp[1, 0, C:2 * C] = vp[1, 0, C:2 * C] = NAN
    kp[2, 1, :100] = vp[2, 1, :100] = NAN
    kp[3, :, :2 * C + 10] = vp[3, :, :2 * C + 10] = NAN
    vp[6, 2, 5] = NAN
    return (q, k, v, lens), (q, kp, vp, lens)


def _scatter(rng, k, bs):
    """Contiguous K or V [B, Hkv, S, D] into a pool under a scrambled
    block map (block 0 the trash block): (pool, table); the same ``rng``
    state gives the same map."""
    b, hkv, s, d = k.shape
    m = s // bs
    ids = rng.permutation(np.arange(1, b * m + 1))
    table = ids.reshape(b, m).astype(np.int32)
    pool = np.zeros((b * m + 1, hkv, bs, d), np.float32)
    for lane in range(b):
        for j in range(m):
            pool[table[lane, j]] = k[lane, :, j * bs:(j + 1) * bs]
    return pool, table


def paged_case(d, bs, seed=0):
    """Kernel #2's operands (q, k_pool, v_pool, table, lengths) clean
    and poisoned, from :func:`contiguous_case`'s lanes over 4 chunks of
    rows: at bs 256 the all-NaN chunk of lane 1 is one pool block, at
    bs 16 sixteen.  Also returns the contiguous views for the JAX
    reference."""
    (q, k, v, lens), (_, kp, vp, _) = contiguous_case(d, seed)
    s = 4 * C
    pad = ((0, 0), (0, 0), (0, s - k.shape[2]), (0, 0))
    k, v, kp, vp = (np.pad(a, pad) for a in (k, v, kp, vp))
    out = []
    for kk, vv in ((k, v), (kp, vp)):
        pk, table = _scatter(np.random.default_rng(seed + 1), kk, bs)
        pv, _ = _scatter(np.random.default_rng(seed + 1), vv, bs)
        out.append((q, pk, pv, table, lens))
    return out[0], out[1], (k, v, kp, vp)


def quant_case(d, bs, seed=0):
    """Kernel #3's operands (q, codes K and V, scales K and V, tails K
    and V, table, lengths) clean and poisoned, over 4 chunks of rows: lane
    1 (a, c) a NaN K scale on the fully visible block holding row 300,
    in kv head 0; lane 2 (b) length 100, every visible row NaN in kv
    head 1 (the scales of its full blocks, its tail's rows); lane 3 (b)
    length 600, the same in every head; lane 6 one NaN V tail row inside
    its fill in kv head 2.  A NaN scale poisons its whole block, which
    lies wholly inside the lane's fill."""
    rng = np.random.default_rng(seed)
    lens = np.asarray([4 * C, 700, 100, 600, 0, C + 1, 900], np.int32)
    b, m = len(lens), 4 * C // bs
    n = b * m + 3
    q = _rand(rng, (b, HQ, d))
    codes = [rng.integers(-127, 128, (n, HKV, bs, d)).astype(np.int8)
             for _ in range(2)]
    scales = [(rng.random((n, HKV)) * 0.008 + 0.004).astype(np.float32)
              for _ in range(2)]
    tails = [_rand(rng, (b + 1, HKV, bs, d)) for _ in range(2)]
    table = rng.permutation(np.arange(1, n))[:b * m].reshape(b, m).astype(
        np.int32)
    clean = (q, *codes, *scales, *tails, table, lens)
    ks, vs = (a.copy() for a in scales)
    kt, vt = (a.copy() for a in tails)
    ks[table[1, 300 // bs], 0] = NAN
    for lane, heads in ((2, slice(1, 2)), (3, slice(None))):
        wb = (int(lens[lane]) - 1) // bs
        for j in range(wb):
            ks[table[lane, j], heads] = vs[table[lane, j], heads] = NAN
        rows = int(lens[lane]) - wb * bs
        kt[lane, heads, :rows] = vt[lane, heads, :rows] = NAN
    vt[6, 2, 1] = NAN
    poisoned = (q, *codes, ks, vs, kt, vt, table, lens)
    return clean, poisoned


def _quant_view(codes, scales, tail, table, lens):
    """The int8 pool's logical [B, Hkv, M*bs, D] rows in numpy: code x
    scale of each mapped block, the frontier block from the tail."""
    b, m = table.shape
    bs = codes.shape[2]
    out = codes[table].astype(np.float32) * scales[table][..., None, None]
    wb = np.maximum(lens.astype(np.int64) - 1, 0) // bs
    out[np.arange(b), wb] = tail[:b]
    return out.transpose(0, 2, 1, 3, 4).reshape(b, -1, m * bs,
                                                codes.shape[3])


def _jax_ref(q, k, v, lens):
    return np.asarray(JDA.decode_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens)))


def _t(arrays, device="cpu", dtype=None):
    """numpy operands -> tensors on ``device``; with ``dtype`` the
    activations (q, K, V, tails: 3-d and up) in it, the scales f32."""
    out = []
    for a in arrays:
        t = torch.as_tensor(a, device=device)
        if dtype is not None and t.is_floating_point() and a.ndim >= 3:
            t = t.to(dtype)
        out.append(t)
    return out


def _run_contiguous(args):
    return TDA.decode_attention(*args)


def _run_paged(args):
    return TDA.paged_decode_attention(*args)


def _run_quant(args):
    q, kc, vc, ks, vs, kt, vt, table, lens = args
    return TDA.paged_decode_attention(q, kc, vc, table, lens, k_scale=ks,
                                      v_scale=vs, k_tail=kt, v_tail=vt)


def _assert_same_nonfinite(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    bad = np.isfinite(got) != np.isfinite(want)
    assert not bad.any(), (
        f"{what}: non-finite at different places; (lane, head) pairs "
        f"{sorted({(int(i), int(j)) for i, j, _ in np.argwhere(bad)})}")


def _nonfinite_heads(out):
    """(lane, head) pairs with a non-finite value."""
    return sorted({(int(i), int(j)) for i, j, _ in
                   np.argwhere(~np.isfinite(np.asarray(out, np.float32)))})


WANT_HEADS = ([(1, 0), (1, 1), (2, 2), (2, 3)]
              + [(3, h) for h in range(HQ)] + [(6, 4), (6, 5)])


class TestPlainMatchesJax:
    """The port's plain versions (CPU tensors) against the JAX
    reference on the same poisoned inputs."""

    @pytest.mark.parametrize("d", [16, 64])
    def test_contiguous(self, d):
        _, poisoned = contiguous_case(d, seed=d)
        got = _run_contiguous(_t(poisoned)).numpy()
        want = _jax_ref(*poisoned)
        _assert_same_nonfinite(got, want, "decode_attention plain")
        assert _nonfinite_heads(got) == WANT_HEADS
        ok = np.isfinite(want)
        np.testing.assert_allclose(got[ok], want[ok], atol=2e-5, rtol=2e-5)

    @pytest.mark.parametrize("bs", [16, 256])
    def test_paged(self, bs):
        _, poisoned, (_, _, kp, vp) = paged_case(16, bs, seed=bs)
        got = _run_paged(_t(poisoned)).numpy()
        want = _jax_ref(poisoned[0], kp, vp, poisoned[4])
        _assert_same_nonfinite(got, want, "paged_decode_attention plain")
        assert _nonfinite_heads(got) == WANT_HEADS
        ok = np.isfinite(want)
        np.testing.assert_allclose(got[ok], want[ok], atol=2e-5, rtol=2e-5)

    @pytest.mark.parametrize("bs", [16, 256])
    def test_quant(self, bs):
        _, poisoned = quant_case(16, bs, seed=bs)
        q, kc, vc, ks, vs, kt, vt, table, lens = poisoned
        got = _run_quant(_t(poisoned)).numpy()
        want = _jax_ref(q, _quant_view(kc, ks, kt, table, lens),
                        _quant_view(vc, vs, vt, table, lens), lens)
        _assert_same_nonfinite(got, want, "int8 paged attention plain")
        assert _nonfinite_heads(got) == WANT_HEADS
        ok = np.isfinite(want)
        np.testing.assert_allclose(got[ok], want[ok], atol=2e-5, rtol=2e-5)


CASES = {
    "contiguous": (lambda d, bs: contiguous_case(d, seed=d), _run_contiguous),
    "paged": (lambda d, bs: paged_case(d, bs, seed=d + bs)[:2], _run_paged),
    "quant": (lambda d, bs: quant_case(d, bs, seed=d + bs), _run_quant),
}


@pytest.mark.cuda
class TestKernelsOnCard:
    """Kernels #1-#3 on the card: non-finite exactly where their plain
    versions are, and every finite value bit-identical to the kernel's
    run without the NaNs."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")

    @pytest.mark.parametrize("kernel", sorted(CASES))
    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    @pytest.mark.parametrize("d,bs", [(64, 16), (128, 256)])
    def test_nan_rows_reach_the_output(self, kernel, dtype, d, bs):
        torch.backends.cuda.matmul.allow_tf32 = False
        build, run = CASES[kernel]
        clean, poisoned = build(d, bs)
        args = _t(poisoned, "cuda", dtype)
        got = run(args).float()
        base = run(_t(clean, "cuda", dtype)).float()
        # the plain version in f32 on the kernel's inputs (the int8
        # pool's tails in the kernel's dtype: its view rounds to it)
        if kernel == "quant":
            q, kc, vc, ks, vs, kt, vt, table, lens = args
            plain = TDA.paged_decode_attention_quant_reference(
                q.float(), kc, vc, table, lens, ks, vs, kt, vt)
        else:
            f32 = [a.float() if a.is_floating_point() else a for a in args]
            plain = (TDA.decode_attention_reference(*f32)
                     if kernel == "contiguous"
                     else TDA.paged_decode_attention_reference(*f32))
        torch.cuda.synchronize()
        got, base, plain = (t.cpu().numpy() for t in (got, base, plain))
        _assert_same_nonfinite(got, plain, f"kernel {kernel}")
        assert _nonfinite_heads(got) == WANT_HEADS
        ok = np.isfinite(got)
        np.testing.assert_array_equal(got[ok], base[ok])
