"""The torch package's 8-bit Adam moments (paddle_operator_tpu_torch/
train/opt8bit.py, ops/adam8bit.py's plain version, trainer
``make_optimizer(moments="int8")``, convert.py's int8 optimizer state)
held against the JAX package's train/opt8bit.py and
``make_optimizer(moments="int8")``, and the cases of
tests/test_opt8bit.py run on the port.

Tolerances:
- the quantizer (``quantize_q8``/``q8u``) on the same f32 inputs: codes
  and scales equal JAX's exactly (the same f32 divisions and round half
  to even);
- a 3-step trajectory of the tiny preset at f32 from the same init and
  batches (as tests/test_torch_train.py): losses and grad norms rtol
  1e-5; every moment code within +-1 of JAX's and at least 99.9% of
  them equal (a last-bit difference in an f32 moment moves a value
  across a code midpoint: jitted XLA rounds the update otherwise than
  its eager formula, so JAX's own eager and jitted updates differ so
  too); scales rtol 1e-5, the grads' own agreement (a scale is its
  block's largest moment, and the two sides' grads differ in their
  last bits; one update on the same grads holds the scales to
  SCALE_RTOL 1e-6); params atol 1e-5, except the elements under a
  moment code that differed from JAX's at some step (at most 0.1% of
  them), held to FLIP_ATOL 1e-4: one code step of mu is 1/127 of its
  block's largest moment, and at lr 1e-3 it moved such an element by
  up to 1.25e-5 (read on the CPU);
- the JAX file's own cases keep their tolerances.
"""

import itertools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from paddle_operator_tpu.models import llama as JL
from paddle_operator_tpu.parallel.mesh import single_device_mesh
from paddle_operator_tpu.train import data as JD
from paddle_operator_tpu.train import opt8bit as JQ
from paddle_operator_tpu.train import trainer as JT
from paddle_operator_tpu_torch.convert import (opt_state_from_jax,
                                               params_from_jax)
from paddle_operator_tpu_torch.models import llama as TL
from paddle_operator_tpu_torch.ops import adam8bit as A8
from paddle_operator_tpu_torch.train import opt8bit as Q8
from paddle_operator_tpu_torch.train import trainer as TT

RTOL = 1e-5
ATOL_PARAMS = 1e-5
SCALE_RTOL = 1e-6
TRAJ_SCALE_RTOL = 1e-5
FLIP_ATOL = 1e-4
CODES_EQUAL = 0.999
B, S, STEPS = 4, 33, 3
SHAPES = [(7,), (256,), (3, 5), (1, 257), (2, 3, 11), (4, 1000), (64, 512)]


def _jax_q8(x, unsigned):
    q = (JQ.quantize_q8u if unsigned else JQ.quantize_q8)(jnp.asarray(x))
    return np.asarray(q.q8_codes), np.asarray(q.q8_scale)


class TestQuantizer:
    @pytest.mark.parametrize("unsigned", [False, True])
    @pytest.mark.parametrize("shape", SHAPES)
    def test_codes_and_scales_equal_jax(self, shape, unsigned):
        rng = np.random.default_rng(len(shape) * 7 + shape[-1])
        x = rng.standard_normal(shape).astype(np.float32)
        x = np.abs(x) if unsigned else x
        x[..., 0] = 0.0                                 # exact zeros too
        want_c, want_s = _jax_q8(x, unsigned)
        fn = Q8.quantize_q8u if unsigned else Q8.quantize_q8
        got = fn(torch.as_tensor(x))
        assert tuple(got.codes.shape) == Q8.blocked_shape(shape)
        np.testing.assert_array_equal(got.codes.numpy(), want_c)
        np.testing.assert_array_equal(got.scales.numpy(), want_s)
        deq = Q8.dequantize_q8u if unsigned else Q8.dequantize_q8
        jdeq = JQ.dequantize_q8u if unsigned else JQ.dequantize_q8
        back = deq(got, shape)
        want = jdeq(JQ._Q8(jnp.asarray(want_c), jnp.asarray(want_s)), shape)
        np.testing.assert_array_equal(back.numpy(), np.asarray(want))

    def test_roundtrip_error_bounded_per_block(self):
        """tests/test_opt8bit.py:25 on the port."""
        rng = np.random.default_rng(0)
        x = np.concatenate([rng.standard_normal(Q8.BLOCK) * 10.0 ** e
                            for e in (-6, -2, 0, 3)]).astype(np.float32)
        back = Q8.dequantize_q8(Q8.quantize_q8(torch.as_tensor(x)),
                                x.shape).numpy()
        for i, e in enumerate((-6, -2, 0, 3)):
            blk = slice(i * Q8.BLOCK, (i + 1) * Q8.BLOCK)
            err = np.abs(back[blk] - x[blk]).max()
            assert err <= 10.0 ** e * 10 / 127 + 1e-12, (e, err)

    def test_odd_sizes_and_shapes(self):
        """tests/test_opt8bit.py:38 on the port."""
        rng = np.random.default_rng(1)
        for shape in ((7,), (3, 5), (1, Q8.BLOCK + 1), (2, 3, 11)):
            x = torch.as_tensor(rng.standard_normal(shape),
                                dtype=torch.float32)
            back = Q8.dequantize_q8(Q8.quantize_q8(x), shape)
            assert tuple(back.shape) == shape
            np.testing.assert_allclose(back.numpy(), x.numpy(),
                                       atol=float(x.abs().max()) / 100)

    def test_zeros_stay_zero(self):
        """tests/test_opt8bit.py:47 on the port."""
        z = torch.zeros(Q8.BLOCK * 2)
        assert not Q8.dequantize_q8(Q8.quantize_q8(z), z.shape).any()

    def test_init_is_the_encoding_of_zeros(self):
        params = {"a": torch.zeros(3, 300), "b": torch.zeros(7)}
        st = Q8.init_state(params)
        assert st.count == 0 and st.kind == "int8"
        for name, p in params.items():
            for q, want in ((st.mu[name], Q8.quantize_q8(p)),
                            (st.nu[name], Q8.quantize_q8u(p))):
                assert torch.equal(q.codes, want.codes)
                assert torch.equal(q.scales, want.scales)


def _port_opt(opt_cls, lr, b1, b2, wd):
    return opt_cls(lambda count: lr, b1=b1, b2=b2, weight_decay=wd,
                   grad_clip=float("inf"))


class TestUpdateRule:
    def test_single_step_matches_f32_adamw(self):
        """tests/test_opt8bit.py:54 on the port: from zero moments the
        first update has no quantization history."""
        rng = np.random.default_rng(2)
        p0 = rng.standard_normal((4, 8)).astype(np.float32)
        g = {"w": torch.as_tensor(rng.standard_normal((4, 8)),
                                  dtype=torch.float32)}
        upd = []
        for cls in (TT.AdamW, TT.AdamW8bit):
            opt = _port_opt(cls, 1e-2, 0.9, 0.999, 1e-4)
            params = {"w": torch.as_tensor(p0.copy())}
            opt.update(params, g, opt.init(params))
            upd.append(params["w"].numpy() - p0)
        np.testing.assert_allclose(upd[1], upd[0], rtol=0.05, atol=1e-6)

    def test_trajectory_tracks_f32(self):
        """tests/test_opt8bit.py:69 on the port: a quadratic bowl."""
        target = torch.as_tensor(
            np.random.default_rng(3).standard_normal(64), dtype=torch.float32)

        def run(cls):
            opt = _port_opt(cls, 5e-2, 0.9, 0.999, 0.0)
            params = {"p": torch.zeros(64)}
            state = opt.init(params)
            for _ in range(200):
                opt.update(params, {"p": 2 * (params["p"] - target)}, state)
            return params["p"].numpy()

        np.testing.assert_allclose(run(TT.AdamW8bit), run(TT.AdamW),
                                   rtol=0.02, atol=0.02)

    def test_unknown_moments_rejected(self):
        """tests/test_opt8bit.py:186 on the port."""
        with pytest.raises(ValueError, match="unknown moments"):
            TT.make_optimizer(1e-3, moments="Int8")

    @pytest.mark.parametrize("shape", [(5, 300), (9,), (3, 4, 10)])
    def test_plain_update_equals_jax_chain(self, shape):
        """One tensor, three updates with a clip that bites: the plain
        version against ``clip_by_global_norm`` + ``adamw8bit``."""
        rng = np.random.default_rng(5)
        p0 = rng.standard_normal(shape).astype(np.float32)
        grads = [rng.standard_normal(shape).astype(np.float32) * 3
                 for _ in range(3)]
        sched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 1, 100,
                                                   end_value=1e-3)
        jopt = optax.chain(optax.clip_by_global_norm(1.0),
                           JQ.adamw8bit(sched, b1=0.9, b2=0.95,
                                        weight_decay=0.1))
        jp = jnp.asarray(p0)
        jst = jopt.init(jp)
        opt = TT.make_optimizer(1e-2, warmup_steps=1, decay_steps=100,
                                moments="int8")
        params = {"w": torch.as_tensor(p0.copy())}
        st = opt.init(params)
        for g in grads:
            u, jst = jopt.update(jnp.asarray(g), jst, jp)
            jp = optax.apply_updates(jp, u)
            opt.update(params, {"w": torch.as_tensor(g)}, st)
        np.testing.assert_allclose(params["w"].numpy(), np.asarray(jp),
                                   rtol=0, atol=ATOL_PARAMS)
        jadam = jst[1][0]
        for mine, theirs in ((st.mu["w"], jadam.mu), (st.nu["w"], jadam.nu)):
            _assert_codes(mine.codes.numpy(), np.asarray(theirs.q8_codes))
            np.testing.assert_allclose(mine.scales.numpy(),
                                       np.asarray(theirs.q8_scale),
                                       rtol=SCALE_RTOL)


def _assert_codes(got, want, ok=None):
    assert got.shape == want.shape and got.dtype == want.dtype == np.int8
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    if ok is not None:
        ok.append((int((diff == 0).sum()), diff.size))
    else:
        assert (diff == 0).mean() >= CODES_EQUAL


def _batches():
    return [b for b in itertools.islice(
        JD.deterministic_lm_batches(B, S, 256, seed=11), STEPS)]


@pytest.fixture(scope="module")
def jax_int8_run():
    """The JAX int8-moment trajectory of the tiny preset: init params,
    per-step metrics and (params, opt_state) after each step."""
    model, cfg = JL.make_model("tiny", dtype=jnp.float32)
    mesh = single_device_mesh()
    opt = JT.make_optimizer(1e-3, warmup_steps=1, decay_steps=100,
                            moments="int8")
    pats = JL.partition_patterns(cfg)
    ex = (jnp.zeros((B, S - 1), jnp.int32),)
    shardings, _ = JT.state_shardings(model, opt, mesh, pats, ex)
    state = JT.create_state(model, opt, mesh, pats, ex)
    step = JT.make_train_step(model, opt, mesh, shardings)
    out = {"init": jax.device_get(state.params), "metrics": [],
           "states": []}
    for b in _batches():
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["states"].append(jax.device_get((state.params,
                                             state.opt_state)))
    return out


def _port_state(params_tree):
    model, _ = TL.make_model("tiny", device="cpu", dtype=torch.float32)
    model.load_state_dict(params_from_jax(params_tree))
    opt = TT.make_optimizer(1e-3, warmup_steps=1, decay_steps=100,
                            moments="int8")
    return TT.create_state(model, opt), TT.make_train_step(opt)


def _run(state, step, batches):
    got = []
    for b in batches:
        state, m = step(state, {k: torch.as_tensor(v) for k, v in b.items()})
        got.append({k: float(v) for k, v in m.items()})
    return got


def _run_like_jax(state, step, batches, want, states):
    """Step the port through ``batches``, holding each step to JAX's
    metrics ``want`` and its (params, opt_state) ``states`` (module
    docstring)."""
    counts, flipped = [], {}
    for b, w, (jparams, jopt) in zip(batches, want, states):
        state, m = step(state, {k: torch.as_tensor(v) for k, v in b.items()})
        np.testing.assert_allclose(float(m["loss"]), w["loss"], rtol=RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), w["grad_norm"],
                                   rtol=RTOL)
        theirs = opt_state_from_jax(jopt)
        mine = state.opt_state
        assert mine.count == theirs.count == state.step
        for field, tensors in theirs.tensors().items():
            for name, t in tensors.items():
                got = mine.tensors()[field][name]
                if field.endswith("scales"):
                    np.testing.assert_allclose(got.numpy(), t.numpy(),
                                               rtol=TRAJ_SCALE_RTOL,
                                               err_msg=name)
                    continue
                _assert_codes(got.numpy(), t.numpy(), counts)
                shape = state.model.get_parameter(name).shape
                flip = Q8._from_blocks((got != t).float(), shape,
                                       torch.float32) > 0
                flipped[name] = flipped.get(name, flip) | flip
        for name, v in params_from_jax(jparams).items():
            diff = (state.model.get_parameter(name).detach() - v).abs()
            assert float(diff[~flipped[name]].max()) <= ATOL_PARAMS, name
            if flipped[name].any():
                assert float(diff[flipped[name]].max()) <= FLIP_ATOL, name
    equal, total = map(sum, zip(*counts))
    assert equal / total >= CODES_EQUAL, (equal, total)


class TestTrainStep:
    def test_three_steps_match_jax(self, jax_int8_run):
        state, step = _port_state(jax_int8_run["init"])
        assert isinstance(state.opt_state, Q8.AdamW8bitState)
        _run_like_jax(state, step, _batches(), jax_int8_run["metrics"],
                      jax_int8_run["states"])

    def test_continues_a_jax_state(self, jax_int8_run):
        """Two JAX steps, then the port's third from the converted params
        and int8 moments."""
        params, opt_state = jax_int8_run["states"][1]
        state, step = _port_state(params)
        state.opt_state = opt_state_from_jax(opt_state)
        state.step = state.opt_state.count
        assert state.step == 2
        assert isinstance(state.opt_state, Q8.AdamW8bitState)
        _run_like_jax(state, step, _batches()[2:],
                      jax_int8_run["metrics"][2:],
                      jax_int8_run["states"][2:])

    def test_converted_state_is_the_jax_state(self, jax_int8_run):
        """The unstacking is exact: layer l's codes are JAX's codes[l]."""
        _, opt_state = jax_int8_run["states"][-1]
        got = opt_state_from_jax(opt_state)
        adam = opt_state[1][0]
        assert type(adam).__name__ == "ScaleByAdam8bitState"
        stacked = adam.mu["layers"]["attn"]["wq"]["kernel"]
        for layer in range(2):
            q = got.mu[f"layers.{layer}.attn.wq.kernel"]
            np.testing.assert_array_equal(
                q.codes.numpy(), np.asarray(stacked.q8_codes)[layer])
            np.testing.assert_array_equal(
                q.scales.numpy(), np.asarray(stacked.q8_scale)[layer])
        assert set(got.mu) == set(got.nu) == set(
            params_from_jax(jax_int8_run["init"]))

    def test_moments_are_int8_and_the_loss_falls(self):
        """tests/test_opt8bit.py:117 on the port: eight steps of int8
        moments track the f32 trajectory."""
        losses = {}
        for moments in ("f32", "int8"):
            model, cfg = TL.make_model("tiny", device="cpu",
                                       dtype=torch.float32)
            opt = TT.make_optimizer(1e-3, warmup_steps=2, decay_steps=20,
                                    moments=moments)
            state, step = TT.create_state(model, opt), TT.make_train_step(opt)
            losses[moments] = [h["loss"] for h in _run(
                state, step, [{"tokens": b["tokens"]} for b in
                              itertools.islice(JD.deterministic_lm_batches(
                                  8, 17, cfg.vocab_size, seed=3), 8)])]
        got = losses["int8"]
        assert all(np.isfinite(got)) and got[-1] < got[0]
        np.testing.assert_allclose(got, losses["f32"], rtol=0.02)
        assert {t.dtype for t in state.opt_state.tensors()["mu_codes"]
                .values()} == {torch.int8}


def test_plain_update_chunks_like_scan_bytes(monkeypatch):
    """Chunking over the leading axis changes nothing."""
    rng = np.random.default_rng(8)
    shape = (12, 600)
    p0 = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
    g = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32)
    consts = A8.Adam8bitConsts.make(b1=0.9, b2=0.95, eps=1e-8,
                                    weight_decay=0.1, lr=1e-2, clip=1.0,
                                    count=1)
    assert A8._chunks(p0) == (12, 12)
    outs = []
    for scan in (A8.SCAN_BYTES, 4096):
        monkeypatch.setattr(A8, "SCAN_BYTES", scan)
        p = p0.clone()
        mu = Q8.quantize_q8(torch.zeros(shape))
        nu = Q8.quantize_q8u(torch.zeros(shape))
        A8.adam8bit_update(p, g, mu, nu, torch.tensor(2.0), consts)
        outs.append((p, *mu, *nu))
    assert A8._chunks(p0) == (12, 2)
    for a, b in zip(*outs):
        assert torch.equal(a, b)
