"""The torch package's training slice (paddle_operator_tpu_torch/train/,
models/llama.py's training forward, convert.py's optimizer state, the
copied ft/ and utils/ helpers) held against the JAX package's: the tiny
preset at f32 on both sides from the same init (the JAX init through
``params_from_jax``) and the same numpy batches from
``deterministic_lm_batches``, stepped by JAX ``make_train_step``
(single-device mesh, ``make_optimizer(1e-3, warmup_steps=1,
decay_steps=100)``) and by the port's.

Tolerances: per step, loss and grad_norm agree to rtol 1e-5; the final
params to atol 1e-5 (f32 on both sides; the two sides sum in different
orders).
"""

import itertools
import logging

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from paddle_operator_tpu.ft import goodput as JG
from paddle_operator_tpu.models import llama as JL
from paddle_operator_tpu.parallel.mesh import single_device_mesh
from paddle_operator_tpu.train import data as JD
from paddle_operator_tpu.train import trainer as JT
from paddle_operator_tpu.utils import observability as JO
from paddle_operator_tpu_torch.convert import (opt_state_from_jax,
                                               params_from_jax)
from paddle_operator_tpu_torch.ft import goodput as TG
from paddle_operator_tpu_torch.ft.preemption import PreemptionWatcher
from paddle_operator_tpu_torch.models import llama as TL
from paddle_operator_tpu_torch.train import data as TD
from paddle_operator_tpu_torch.train import trainer as TT
from paddle_operator_tpu_torch.utils import observability as TO

RTOL = 1e-5
ATOL_PARAMS = 1e-5
B, S = 4, 33                      # rows of S tokens: 32 inputs each
STEPS = 3


def _batches(variant):
    """STEPS numpy batches of the variant: plain tokens, + a 0/1 loss
    mask, or + three packed documents per row."""
    out = []
    rng = np.random.default_rng(9)
    for b in itertools.islice(JD.deterministic_lm_batches(B, S, 256, seed=11),
                              STEPS):
        if variant == "mask":
            b["mask"] = (rng.random((B, S)) > 0.25).astype(np.float32)
        elif variant == "segments":
            cuts = np.sort(rng.choice(np.arange(2, S - 2), (B, 2),
                                      replace=False), axis=1)
            b["segment_ids"] = (np.arange(S)[None, None, :]
                                >= cuts[:, :, None]).sum(1).astype(np.int32)
        out.append(b)
    return out


def _jax_setup():
    model, cfg = JL.make_model("tiny", dtype=jnp.float32)
    mesh = single_device_mesh()
    opt = JT.make_optimizer(1e-3, warmup_steps=1, decay_steps=100)
    pats = JL.partition_patterns(cfg)
    ex = (jnp.zeros((B, S - 1), jnp.int32),)
    shardings, _ = JT.state_shardings(model, opt, mesh, pats, ex)
    state = JT.create_state(model, opt, mesh, pats, ex)
    step = JT.make_train_step(model, opt, mesh, shardings)
    return model, mesh, state, step


def _floats(metrics):
    return {k: float(v) for k, v in metrics.items()}


@pytest.fixture(scope="module")
def jax_runs():
    """Per variant: the JAX metrics of each step and the final params;
    plus the init params and the state after two plain steps."""
    model, mesh, state, step = _jax_setup()
    init = jax.device_get(state.params)
    runs = {"init": init}
    for variant in ("plain", "mask", "segments"):
        state = JT.create_state(model, JT.make_optimizer(
            1e-3, warmup_steps=1, decay_steps=100), mesh,
            JL.partition_patterns(model.cfg),
            (jnp.zeros((B, S - 1), jnp.int32),))
        metrics = []
        for i, b in enumerate(_batches(variant)):
            if variant == "plain" and i == 2:
                runs["after_two"] = jax.device_get(
                    (state.params, state.opt_state))
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            metrics.append(_floats(m))
        runs[variant] = (metrics, jax.device_get(state.params))
    return runs


def _port(init, remat=True):
    model, cfg = TL.make_model("tiny", device="cpu", dtype=torch.float32,
                               remat=remat)
    model.load_state_dict(params_from_jax(init))
    opt = TT.make_optimizer(1e-3, warmup_steps=1, decay_steps=100)
    return TT.create_state(model, opt), TT.make_train_step(opt)


def _run_port(state, step, batches):
    metrics = []
    for b in batches:
        state, m = step(state, {k: torch.as_tensor(v) for k, v in b.items()})
        metrics.append(_floats(m))
    return state, metrics


def _assert_metrics(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["tokens"] == w["tokens"]
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=RTOL)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=RTOL)


def _assert_params(model, tree):
    want = params_from_jax(tree)
    got = model.state_dict()
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                   atol=ATOL_PARAMS, err_msg=k)


class TestTrainStep:
    @pytest.mark.parametrize("variant", ["plain", "mask", "segments"])
    def test_three_steps_match_jax(self, jax_runs, variant):
        want, final = jax_runs[variant]
        state, step = _port(jax_runs["init"])
        state, got = _run_port(state, step, _batches(variant))
        _assert_metrics(got, want)
        assert state.step == STEPS and state.opt_state.count == STEPS
        _assert_params(state.model, final)

    def test_masks_and_segments_change_the_loss(self, jax_runs):
        losses = {v: jax_runs[v][0][0]["loss"]
                  for v in ("plain", "mask", "segments")}
        assert len(set(losses.values())) == 3

    def test_remat_on_and_off_give_the_same_losses(self, jax_runs):
        losses = []
        for remat in (True, False):
            state, step = _port(jax_runs["init"], remat=remat)
            _, m = _run_port(state, step, _batches("segments"))
            losses.append([x["loss"] for x in m])
        np.testing.assert_allclose(losses[0], losses[1], rtol=1e-6)

    def test_resume_from_jax_opt_state(self, jax_runs):
        """Two JAX steps, then the port's third from the converted params
        and optimizer state matches JAX's third."""
        params, opt_state = jax_runs["after_two"]
        state, step = _port(params)
        state.opt_state = opt_state_from_jax(opt_state)
        state.step = state.opt_state.count
        assert state.step == 2
        state, got = _run_port(state, step, _batches("plain")[2:])
        want, final = jax_runs["plain"]
        _assert_metrics(got, want[2:])
        _assert_params(state.model, final)


class TestOptimizer:
    @pytest.mark.parametrize("lr,warmup,decay", [(1e-3, 1, 100),
                                                 (3e-4, 100, 10000),
                                                 (2e-3, 10, 60)])
    def test_schedule_matches_optax(self, lr, warmup, decay):
        # the schedule JT.make_optimizer builds
        sched = optax.warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=lr, warmup_steps=warmup,
            decay_steps=max(decay, warmup + 1), end_value=lr * 0.1)
        got = TT.make_optimizer(lr, warmup_steps=warmup,
                                decay_steps=decay).schedule
        for step in range(121):
            np.testing.assert_allclose(got(step), float(sched(step)),
                                       rtol=1e-6, atol=0, err_msg=str(step))
        assert got(0) == 0.0

    def test_opt_state_converts_exactly(self, jax_runs):
        _, opt_state = jax_runs["after_two"]
        got = opt_state_from_jax(opt_state)
        adam = opt_state[1][0]
        assert got.count == int(adam.count) == 2
        for name, mu in params_from_jax(adam.mu).items():
            assert torch.equal(got.mu[name], mu)
        for name, nu in params_from_jax(adam.nu).items():
            assert torch.equal(got.nu[name], nu)

    def test_global_norm_matches_optax(self):
        rng = np.random.default_rng(3)
        leaves = [rng.standard_normal(s).astype(np.float32)
                  for s in ((3, 4), (7,), (2, 2, 2))]
        want = float(optax.global_norm([jnp.asarray(x) for x in leaves]))
        got = float(TT.global_norm([torch.as_tensor(x) for x in leaves]))
        np.testing.assert_allclose(got, want, rtol=1e-6)


class TestLoss:
    """The cases of tests/test_llama_train.py TestLoss, and random logits
    with a mask, through both cross_entropy_loss functions."""

    def _both(self, logits, targets, mask=None):
        want = JT.cross_entropy_loss(
            jnp.asarray(logits), jnp.asarray(targets),
            None if mask is None else jnp.asarray(mask))
        got = TT.cross_entropy_loss(
            torch.as_tensor(logits), torch.as_tensor(targets),
            None if mask is None else torch.as_tensor(mask))
        return [float(x) for x in got], [float(x) for x in want]

    def test_perfect_prediction_zero_loss(self):
        logits = np.full((1, 4, 8), -1e9, np.float32)
        logits[0, :, 3] = 1e9
        got, want = self._both(logits, np.full((1, 4), 3, np.int32))
        assert got[0] < 1e-5 and got[1] == 4
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-6)

    def test_mask(self):
        got, want = self._both(np.zeros((1, 4, 8), np.float32),
                               np.zeros((1, 4), np.int32),
                               np.asarray([[1, 1, 0, 0]], np.float32))
        assert got[1] == 2
        np.testing.assert_allclose(got, want, rtol=RTOL)

    @pytest.mark.parametrize("all_masked", [False, True])
    def test_random_logits(self, all_masked):
        rng = np.random.default_rng(4)
        logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
        targets = rng.integers(0, 11, (2, 5)).astype(np.int32)
        mask = (np.zeros((2, 5)) if all_masked
                else rng.random((2, 5)) > 0.3).astype(np.float32)
        got, want = self._both(logits, targets, mask)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)


class TestData:
    @pytest.mark.parametrize("seed,start", [(0, 0), (7, 3), (123, 1000)])
    def test_deterministic_batches_bit_identical(self, seed, start):
        a = JD.deterministic_lm_batches(3, 17, 1000, seed=seed,
                                        start_step=start)
        b = TD.deterministic_lm_batches(3, 17, 1000, seed=seed,
                                        start_step=start)
        for x, y in itertools.islice(zip(a, b), 4):
            assert x["tokens"].dtype == y["tokens"].dtype == np.int32
            np.testing.assert_array_equal(x["tokens"], y["tokens"])

    def test_synthetic_batches_bit_identical(self):
        for x, y in itertools.islice(zip(
                JD.synthetic_lm_batches(2, 9, 50, seed=4),
                TD.synthetic_lm_batches(2, 9, 50, seed=4)), 3):
            np.testing.assert_array_equal(x["tokens"], y["tokens"])

    def test_process_slice_matches(self):
        batch = {"tokens": np.arange(24).reshape(6, 4)}
        for pi in range(3):
            np.testing.assert_array_equal(
                JD.process_slice(batch, pi, 3)["tokens"],
                TD.process_slice(batch, pi, 3)["tokens"])
        with pytest.raises(ValueError):
            TD.process_slice(batch, 0, 4)

    def test_mmap_batches_match_python_path(self, tmp_path):
        path = tmp_path / "tokens.bin"
        np.arange(500, dtype=np.uint16).tofile(path)
        a = JD.mmap_token_batches(str(path), 3, 16, seed=2, native=False)
        b = TD.mmap_token_batches(str(path), 3, 16, seed=2)
        for x, y in itertools.islice(zip(a, b), 3):
            np.testing.assert_array_equal(x["tokens"], y["tokens"])

    def test_synthetic_batch_is_seeded(self):
        a = TT.synthetic_batch(3, 7, 50, seed=2, device="cpu")["tokens"]
        b = TT.synthetic_batch(3, 7, 50, seed=2, device="cpu")["tokens"]
        c = TT.synthetic_batch(3, 7, 50, seed=3, device="cpu")["tokens"]
        assert a.shape == (3, 7) and a.dtype == torch.int32
        assert torch.equal(a, b) and not torch.equal(a, c)
        assert int(a.min()) >= 0 and int(a.max()) < 50

    def test_prefetcher_on_cpu(self):
        src = list(itertools.islice(TD.deterministic_lm_batches(2, 5, 9), 3))
        it = TD.DevicePrefetcher(iter(src), device="cpu")
        got = list(it)
        assert len(got) == 3
        for g, w in zip(got, src):
            np.testing.assert_array_equal(g["tokens"].numpy(), w["tokens"])
        with pytest.raises(StopIteration):     # exhausted stays exhausted
            next(it)

    def test_prefetcher_surfaces_errors(self):
        def broken():
            yield {"tokens": np.zeros((1, 2), np.int32)}
            raise OSError("disk gone")

        it = TD.DevicePrefetcher(broken(), device="cpu")
        next(it)
        with pytest.raises(OSError, match="disk gone"):
            next(it)


class TestFit:
    def test_history_matches_jax(self, jax_runs):
        batches = _batches("plain") + _batches("mask")[:1]
        held_out = {"tokens": batches[0]["tokens"][:2]}
        model, mesh, state, step = _jax_setup()
        jeval = JT.make_eval_step(model, mesh)
        _, want = JT.fit(
            state, step, [{k: jnp.asarray(v) for k, v in b.items()}
                          for b in batches], steps=10,
            eval_fn=lambda st: jeval(st.params,
                                     {"tokens": jnp.asarray(
                                         held_out["tokens"])}),
            eval_every=2)
        tstate, tstep = _port(jax_runs["init"])
        teval = TT.make_eval_step()
        tstate, got = TT.fit(
            tstate, tstep, TD.DevicePrefetcher(iter(batches), device="cpu"),
            steps=10,
            eval_fn=lambda st: teval(st.model, {"tokens": torch.as_tensor(
                held_out["tokens"])}),
            eval_every=2)
        assert len(got) == len(want) == len(batches) and tstate.step == 4
        assert [sorted(g) for g in got] == [sorted(w) for w in want]
        _assert_metrics(got, want)
        for g, w in zip(got, want):
            if "eval_loss" in w:
                np.testing.assert_allclose(g["eval_loss"], w["eval_loss"],
                                           rtol=RTOL)

    def test_drain_stops_and_logs_disabled(self, jax_runs):
        records = []

        class Keep(logging.Handler):
            def emit(self, record):
                records.append(record.getMessage())

        log = logging.getLogger("test_torch_train.drain")
        log.addHandler(Keep())
        log.setLevel(logging.INFO)
        watcher = PreemptionWatcher()

        def batches():
            for i, b in enumerate(_batches("plain")):
                if i == 2:
                    watcher.trigger("injected")
                yield {k: torch.as_tensor(v) for k, v in b.items()}

        state, step = _port(jax_runs["init"])
        state, hist = TT.fit(state, step, batches(), steps=3, logger=log,
                             preemption=watcher)
        assert len(hist) == 3 and state.step == 3  # the in-flight step ends
        assert any("preemption drain (injected)" in r
                   and "checkpoint=DISABLED" in r for r in records)


class TestUnportedKnobs:
    """What the JAX trainer and config take beyond one device and remat
    "full" is not a parameter of the port: passing it raises TypeError
    (no silent no-op), and the unported steps are not defined."""

    @pytest.mark.parametrize("call", [
        lambda: TT.make_optimizer(moments="int8"),
        lambda: TT.create_state(TL.make_model("tiny", device="cpu")[0],
                                TT.make_optimizer(), offload_opt_state=True),
        lambda: TT.make_train_step(TT.make_optimizer(), mesh=object()),
        lambda: TT.make_eval_step(mesh=object()),
        lambda: TD.mmap_token_batches("tokens.bin", 3, 16, native=True),
        lambda: TL.make_model("tiny", device="cpu", remat_policy="dots"),
        lambda: TL.make_model("tiny", device="cpu", scan_layers=False),
        lambda: TL.make_model("tiny", device="cpu", cp_impl="ulysses"),
        lambda: TL.make_model("tiny", device="cpu", mesh=object()),
    ])
    def test_knob_is_not_accepted(self, call):
        with pytest.raises(TypeError):
            call()

    @pytest.mark.parametrize("name", ["make_pp_train_step",
                                      "make_ernie_train_step",
                                      "make_wide_deep_train_step",
                                      "make_resnet_train_step"])
    def test_unported_step_is_not_defined(self, name):
        assert hasattr(JT, name) and not hasattr(TT, name)

    def test_moe_is_refused(self):
        with pytest.raises(NotImplementedError, match="MoE"):
            TL.make_model("tiny-moe", device="cpu")


class TestCopiedHelpers:
    def _clock(self, times):
        it = iter(times)
        return lambda: next(it)

    def test_goodput_tracker_matches_original(self):
        times = [0.0, 1.0, 3.0, 3.5, 4.0, 5.0, 5.5, 7.0, 9.0, 10.0, 12.0,
                 12.5, 13.0, 13.0, 13.0, 13.0, 13.0, 13.0]
        out = []
        for mod in (JG, TG):
            t = mod.GoodputTracker(clock=self._clock(times))
            with t.phase("init"):
                pass
            t.tick()
            t.tick()
            t.pause()
            t.tick()
            t.tick()
            t.record_lost_steps(2, 0.5)
            t.tick()
            out.append(t.to_status())
        assert out[0] == out[1]

    def test_step_timer_matches_original(self):
        times = [0.0, 0.5, 1.25, 1.5, 2.5]
        out = []
        for mod in (JO, TO):
            t = mod.StepTimer(1024, flops_per_token=6e9, peak_flops=1e15,
                              window=3, clock=self._clock(times))
            for _ in times:
                t.tick()
            out.append((list(t.times), t.step_time, t.tokens_per_sec, t.mfu,
                        t.report()))
        assert out[0] == out[1]

    def test_get_logger_keeps_one_handler(self, monkeypatch):
        monkeypatch.setenv("TPUJOB_RANK", "3")
        log = TO.get_logger("test_torch_train.rank")
        again = TO.get_logger("test_torch_train.rank")
        assert log is again and len(log.handlers) == 1
        assert "[rank 3]" in log.handlers[0].formatter._fmt
