"""The torch package's checkpointing (paddle_operator_tpu_torch/train/
checkpoint.py, ft/preemption.py's ``drain_checkpoint`` and
``inject_preemption``, ``fit(checkpoint=...)`` and serve's
``load_serving_params``) held against the JAX package's
train/checkpoint.py, ft/preemption.py, trainer ``fit`` and serve
``main()``, mirroring tests/test_checkpoint.py, tests/test_ft_preemption.py
and tests/test_preemption_recovery.py: the tiny preset at f32 on the CPU,
batches from ``deterministic_lm_batches``.

Tolerances: the port against itself (a round trip, a resumed ``fit``
against an unbroken one, a restore against the state in memory) is bit
for bit; the port continuing a JAX state against JAX's own continuation
agrees to atol 1e-5 in the params and rtol 1e-5 in the losses (as
tests/test_torch_train.py: f32 on both sides, summed in different
orders); greedy tokens and the bf16 cast are exact.

The JAX package's modules that need flax are imported inside the
fixtures, so that the ``cuda``-marked cases also run where flax is not
installed: ``python -m pytest tests/test_torch_checkpoint.py -m cuda``.
"""

import dataclasses
import itertools
import json
import logging
import os
import signal
import threading
import urllib.request

import numpy as np
import pytest
import torch

from paddle_operator_tpu_torch.convert import (opt_state_from_jax,
                                               params_from_jax)
from paddle_operator_tpu_torch.ft import preemption as TP
from paddle_operator_tpu_torch.infer import serve as S
from paddle_operator_tpu_torch.models import llama as TL
from paddle_operator_tpu_torch.train import data as TD
from paddle_operator_tpu_torch.train import trainer as TT
from paddle_operator_tpu_torch.train.checkpoint import (MARKER,
                                                        CheckpointManager,
                                                        resume_or_init)

B, S_LEN, VOCAB, SEED = 4, 33, 256, 11
ATOL_PARAMS = 1e-5
RTOL = 1e-5
# what a serving restore may add to the allocated device memory beyond
# the serving-dtype parameter bytes: the f32 RoPE tables (1 MiB at
# max_seq_len 2048, head_dim 128) and the allocator's 512-byte rounding
SERVE_LOAD_MARGIN = 16 << 20


def _port(seed=0, device="cpu", preset="tiny", **overrides):
    model, _ = TL.make_model(preset, device=device, seed=seed,
                             dtype=torch.float32, **overrides)
    opt = TT.make_optimizer(1e-3, warmup_steps=1, decay_steps=100)
    return TT.create_state(model, opt), TT.make_train_step(opt)


def _batches(start=0, device="cpu"):
    for b in TD.deterministic_lm_batches(B, S_LEN, VOCAB, seed=SEED,
                                         start_step=start):
        yield {k: torch.as_tensor(v, device=device) for k, v in b.items()}


def _copy(state):
    """A detached copy of what a checkpoint holds."""
    opt = state.opt_state
    return {"step": state.step, "count": opt.count,
            "params": {k: v.clone() for k, v in
                       state.model.state_dict().items()},
            "mu": {k: v.clone() for k, v in opt.mu.items()},
            "nu": {k: v.clone() for k, v in opt.nu.items()}}


def _assert_same(state, want):
    got = _copy(state)
    assert (got["step"], got["count"]) == (want["step"], want["count"])
    for part in ("params", "mu", "nu"):
        assert set(got[part]) == set(want[part]), part
        for k, v in want[part].items():
            assert got[part][k].dtype == v.dtype, (part, k)
            assert torch.equal(got[part][k], v), (part, k)


def _trained(steps, seed=0):
    state, step = _port(seed)
    state, hist = TT.fit(state, step, _batches(), steps=steps)
    return state, hist


class _Records(logging.Handler):
    def __init__(self, name):
        super().__init__()
        self.messages = []
        self.logger = logging.getLogger(name)
        self.logger.addHandler(self)
        self.logger.setLevel(logging.INFO)

    def emit(self, record):
        self.messages.append(record.getMessage())


@pytest.fixture()
def gate(monkeypatch):
    """Hold every checkpoint write until ``gate.set()``: the writer
    thread blocks in ``torch.save``."""
    event = threading.Event()
    real = torch.save

    def held(*a, **kw):
        assert event.wait(30), "the gate was never opened"
        return real(*a, **kw)

    monkeypatch.setattr(torch, "save", held)
    yield event
    event.set()


# ---------------------------------------------------------------------------
# Save and restore
# ---------------------------------------------------------------------------


class TestRoundTrip:
    def test_restore_is_bit_exact(self, tmp_path):
        state, _ = _trained(3)
        ckpt = CheckpointManager(str(tmp_path))
        assert ckpt.save(3, state, force=True)
        ckpt.wait()
        fresh = _port(seed=1)[0]
        assert not torch.equal(fresh.model.tok_embed.embedding,
                               state.model.tok_embed.embedding)
        restored, resumed = resume_or_init(CheckpointManager(str(tmp_path)),
                                           lambda: fresh)
        assert resumed and restored is fresh
        assert restored.step == 3 and restored.opt_state.count == 3
        _assert_same(restored, _copy(state))

    def test_files_load_weights_only(self, tmp_path):
        state, _ = _trained(1)
        ckpt = CheckpointManager(str(tmp_path))
        ckpt.save(1, state, force=True)
        ckpt.wait()
        d = tmp_path / "1"
        assert sorted(os.listdir(d)) == sorted(
            ["params.pt", "opt.pt", MARKER])
        params = torch.load(d / "params.pt", weights_only=True)
        rest = torch.load(d / "opt.pt", weights_only=True)
        assert set(params) == set(state.model.state_dict())
        assert (rest["step"], rest["count"]) == (1, 1)
        assert set(rest["mu"]) == set(rest["nu"]) == set(params)
        assert json.loads((d / MARKER).read_text()) == {"format": 1,
                                                         "step": 1}
        assert ckpt.last_save["bytes"] == sum(
            os.path.getsize(d / f) for f in os.listdir(d))

    def test_resume_equals_unbroken(self, tmp_path):
        """6 unbroken steps (saving at 3 and 6 under the interval) against
        a restore of step 3 into a model from another seed and 3 more
        steps: losses and the whole state are bit-equal."""
        state_u, step_u = _port()
        ckpt = CheckpointManager(str(tmp_path), save_interval_steps=3)
        state_u, hist_u = TT.fit(state_u, step_u, _batches(), steps=6,
                                 checkpoint=ckpt)
        ckpt.wait()
        assert ckpt.all_steps() == [3, 6]
        state_r, step_r = _port(seed=1)
        CheckpointManager(str(tmp_path)).restore(state_r, step=3)
        assert state_r.step == 3
        state_r, hist_r = TT.fit(state_r, step_r, _batches(start=3),
                                 steps=3)
        assert [h["loss"] for h in hist_r] == \
            [h["loss"] for h in hist_u[3:]]
        _assert_same(state_r, _copy(state_u))

    def test_mismatched_model_raises_before_changing_it(self, tmp_path):
        state, _ = _trained(1)
        ckpt = CheckpointManager(str(tmp_path))
        ckpt.save(1, state, force=True)
        ckpt.wait()
        other = _port(ffn_dim=64)[0]
        before = _copy(other)
        with pytest.raises(ValueError, match="shapes differ"):
            ckpt.restore(other)
        fewer = _port(n_layers=1)[0]
        with pytest.raises(ValueError, match="unexpected"):
            ckpt.restore(fewer)
        _assert_same(other, before)


class TestAgainstJax:
    @pytest.fixture(scope="class")
    def jax_run(self):
        """JAX tiny f32 TrainState: the state after 3 steps (numpy), the
        per-step losses and the params after 6 steps."""
        import jax
        import jax.numpy as jnp

        from paddle_operator_tpu.models import llama as JL
        from paddle_operator_tpu.parallel.mesh import single_device_mesh
        from paddle_operator_tpu.train import data as JD
        from paddle_operator_tpu.train import trainer as JT

        model, cfg = JL.make_model("tiny", dtype=jnp.float32)
        mesh = single_device_mesh()
        opt = JT.make_optimizer(1e-3, warmup_steps=1, decay_steps=100)
        pats = JL.partition_patterns(cfg)
        ex = (jnp.zeros((B, S_LEN - 1), jnp.int32),)
        shardings, _ = JT.state_shardings(model, opt, mesh, pats, ex)
        state = JT.create_state(model, opt, mesh, pats, ex)
        step = JT.make_train_step(model, opt, mesh, shardings)
        losses, after3 = [], None
        for i, b in enumerate(itertools.islice(
                JD.deterministic_lm_batches(B, S_LEN, VOCAB, seed=SEED), 6)):
            if i == 3:
                after3 = jax.device_get((state.params, state.opt_state))
            state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            losses.append(float(m["loss"]))
        return {"after3": after3, "losses": losses,
                "final": jax.device_get(state.params), "cfg": cfg}

    def _saved_jax_state(self, jax_run, path):
        """The JAX state after 3 steps, brought over and saved by the
        port."""
        params, opt_state = jax_run["after3"]
        state, _ = _port()
        state.model.load_state_dict(params_from_jax(params))
        state.opt_state = opt_state_from_jax(opt_state)
        state.step = state.opt_state.count
        ckpt = CheckpointManager(path)
        assert ckpt.save(state.step, state, force=True)
        ckpt.close()
        return state

    def test_continuation_equals_jax(self, jax_run, tmp_path):
        saved = self._saved_jax_state(jax_run, str(tmp_path))
        assert saved.step == 3
        state, step = _port(seed=1)
        state, resumed = resume_or_init(CheckpointManager(str(tmp_path)),
                                        lambda: state)
        assert resumed
        _assert_same(state, _copy(saved))
        state, hist = TT.fit(state, step, _batches(start=3), steps=3)
        np.testing.assert_allclose([h["loss"] for h in hist],
                                   jax_run["losses"][3:], rtol=RTOL)
        want = params_from_jax(jax_run["final"])
        got = state.model.state_dict()
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), rtol=0,
                                       atol=ATOL_PARAMS, err_msg=k)

    def test_served_tokens_equal_jax(self, jax_run, tmp_path):
        """The port's batch server over the restored checkpoint answers
        with the JAX package's greedy generation on ``serving_params(
        params, float32)``."""
        import jax
        import jax.numpy as jnp

        from paddle_operator_tpu.infer import decode as JDec
        from paddle_operator_tpu.infer.quant import serving_params

        self._saved_jax_state(jax_run, str(tmp_path))
        cfg = TL.CONFIGS["tiny"]
        model, scfg, resumed = S.load_serving_params(
            str(tmp_path), dataclasses.replace(cfg, dtype=torch.float32),
            device="cpu")
        assert resumed and scfg.param_dtype == torch.float32
        srv = S.make_server("127.0.0.1", 0, model, scfg)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        prompt = [[3, 1, 4, 1, 5, 9, 2, 6], [7, 7, 200, 3, 0, 1, 2, 9]]
        try:
            req = urllib.request.Request(
                f"http://127.0.0.1:{srv.server_address[1]}/v1/generate",
                data=json.dumps({"tokens": prompt,
                                 "max_new_tokens": 12}).encode(),
                method="POST")
            with urllib.request.urlopen(req, timeout=60) as r:
                got = json.loads(r.read())["tokens"]
        finally:
            srv.shutdown()
            srv.server_close()
        params = serving_params(jax.tree.map(jnp.asarray,
                                             jax_run["after3"][0]),
                                jnp.float32)
        want = JDec.generate(params, jax_run["cfg"],
                             jnp.asarray(prompt, jnp.int32),
                             max_new_tokens=12)
        assert got == np.asarray(want).tolist()

    def test_bf16_cast_equals_jax_serving_params(self, jax_run, tmp_path):
        import jax
        import jax.numpy as jnp

        from paddle_operator_tpu.infer.quant import serving_params

        self._saved_jax_state(jax_run, str(tmp_path))
        model, cfg, resumed = S.load_serving_params(
            str(tmp_path), TL.CONFIGS["tiny"], device="cpu")
        assert resumed and cfg.param_dtype == torch.bfloat16
        want = params_from_jax(jax.device_get(serving_params(
            jax.tree.map(jnp.asarray, jax_run["after3"][0]), jnp.bfloat16)))
        got = model.state_dict()
        assert set(got) == set(want)
        for k, v in want.items():
            assert v.dtype == got[k].dtype == torch.bfloat16, k
            assert torch.equal(got[k], v), k


class TestServingRestore:
    @pytest.mark.parametrize("where", ["no path", "empty dir"])
    def test_no_step_is_a_fresh_init(self, tmp_path, monkeypatch, where):
        monkeypatch.delenv("TPUJOB_CHECKPOINT_PATH", raising=False)
        path = "" if where == "no path" else str(tmp_path)
        model, cfg, resumed = S.load_serving_params(
            path, TL.CONFIGS["tiny"], device="cpu")
        want, _ = TL.make_model("tiny", device="cpu", seed=0,
                                param_dtype=torch.bfloat16)
        assert not resumed and cfg.param_dtype == torch.bfloat16
        for k, v in want.state_dict().items():
            assert torch.equal(model.state_dict()[k], v), k

    def test_serves_the_newest_step(self, tmp_path):
        ckpt = CheckpointManager(str(tmp_path), save_interval_steps=1)
        state, step = _port()
        state, _ = TT.fit(state, step, _batches(), steps=2,
                          checkpoint=ckpt)
        ckpt.wait()
        cfg = dataclasses.replace(TL.CONFIGS["tiny"], dtype=torch.float32)
        model, _, resumed = S.load_serving_params(str(tmp_path), cfg,
                                                  device="cpu")
        assert resumed
        for k, v in state.model.state_dict().items():
            assert torch.equal(model.state_dict()[k], v), k


# ---------------------------------------------------------------------------
# The save policy and the write
# ---------------------------------------------------------------------------


class TestPolicy:
    def test_interval_and_retention(self, tmp_path):
        state, _ = _trained(1)
        ckpt = CheckpointManager(str(tmp_path), save_interval_steps=2,
                                 max_to_keep=2)
        saved = [s for s in range(1, 7) if ckpt.save(s, state)]
        ckpt.wait()
        assert saved == [2, 4, 6]
        assert ckpt.all_steps() == [4, 6] and ckpt.latest_step() == 6
        # orbax's policy: a step not past the newest is not saved, and a
        # forced save of a committed step raises
        assert not ckpt.save(4, state)
        with pytest.raises(ValueError, match="already exists"):
            ckpt.save(6, state, force=True)
        assert ckpt.save(5, state, force=True)
        ckpt.wait()
        assert ckpt.all_steps() == [5, 6]

    def test_pending_step_counts_as_saved(self, tmp_path, gate):
        state, _ = _trained(1)
        ckpt = CheckpointManager(str(tmp_path), save_interval_steps=2)
        assert ckpt.save(2, state)
        assert ckpt.all_steps() == [] and not ckpt.should_save(2)
        gate.set()
        ckpt.wait()
        assert ckpt.all_steps() == [2]

    def test_snapshot_is_taken_before_in_place_updates(self, tmp_path,
                                                       gate):
        """The train step updates parameters and moments in place: what
        is saved is the state when ``save`` returned."""
        state, step = _port()
        state, _ = TT.fit(state, step, _batches(), steps=2)
        ckpt = CheckpointManager(str(tmp_path))
        assert ckpt.save(2, state, force=True)
        want = _copy(state)
        state, _ = TT.fit(state, step, _batches(start=2), steps=1)
        with torch.no_grad():
            state.model.tok_embed.embedding.add_(1.0)
        gate.set()
        ckpt.wait()
        restored = CheckpointManager(str(tmp_path)).restore(_port(1)[0])
        _assert_same(restored, want)

    def test_close_flushes_a_pending_save(self, tmp_path, gate):
        state, _ = _trained(1)
        ckpt = CheckpointManager(str(tmp_path))
        assert ckpt.save(1, state, force=True)
        assert ckpt.all_steps() == []
        threading.Timer(0.2, gate.set).start()
        ckpt.close()
        assert ckpt.all_steps() == [1]

    def test_writer_error_surfaces_in_wait(self, tmp_path, monkeypatch):
        state, _ = _trained(1)
        ckpt = CheckpointManager(str(tmp_path))

        def full(*a, **kw):
            raise OSError("no space left on device")

        monkeypatch.setattr(torch, "save", full)
        assert ckpt.save(1, state, force=True)
        with pytest.raises(OSError, match="no space"):
            ckpt.wait()
        assert ckpt.all_steps() == [] and os.listdir(tmp_path) == []

    def test_disabled_manager(self, monkeypatch):
        monkeypatch.delenv("TPUJOB_CHECKPOINT_PATH", raising=False)
        state, _ = _port()
        ckpt = CheckpointManager()
        assert not ckpt.enabled
        assert not ckpt.save(1000, state, force=True)
        assert ckpt.latest_step() is None and ckpt.all_steps() == []
        assert TP.drain_checkpoint(None, state, 1) is False
        assert TP.drain_checkpoint(ckpt, state, 1) is False
        with pytest.raises(RuntimeError, match="disabled"):
            ckpt.restore(state)
        fresh = _port(seed=1)[0]
        assert resume_or_init(ckpt, lambda: fresh) == (fresh, False)

    def test_path_defaults_to_the_operator_env(self, tmp_path, monkeypatch):
        monkeypatch.setenv("TPUJOB_CHECKPOINT_PATH", str(tmp_path))
        ckpt = CheckpointManager()
        assert ckpt.enabled and ckpt.path == str(tmp_path)


class TestTornWrites:
    """tests/test_ft_preemption.py TestCheckpointSatellites' torn-write
    cases, and what the port's commit adds."""

    def _two_steps(self, path):
        ckpt = CheckpointManager(path, save_interval_steps=1)
        state, step = _port()
        copies = {}
        for s in (1, 2):
            state, _ = TT.fit(state, step, _batches(start=s - 1), steps=1,
                              checkpoint=ckpt)
            ckpt.wait()
            copies[s] = _copy(state)
        assert ckpt.all_steps() == [1, 2]
        return copies

    @staticmethod
    def _truncate(step_dir, name=None):
        for f in sorted(os.listdir(step_dir)):
            if name in (None, f):
                p = os.path.join(step_dir, f)
                with open(p, "r+b") as fh:
                    fh.truncate(os.path.getsize(p) // 2 if name else 0)

    @pytest.mark.parametrize("torn", [None, "params.pt", "opt.pt"],
                             ids=["every-file-emptied", "params-halved",
                                  "opt-halved"])
    def test_torn_newest_falls_back_with_a_warning(self, tmp_path, torn):
        copies = self._two_steps(str(tmp_path))
        self._truncate(tmp_path / "2", torn)
        log = _Records(f"test_torch_checkpoint.torn.{torn}")
        state, resumed = resume_or_init(CheckpointManager(str(tmp_path)),
                                        lambda: _port(seed=1)[0],
                                        logger=log.logger)
        assert resumed
        _assert_same(state, copies[1])
        assert len(log.messages) == 1
        assert "checkpoint step 2 failed to restore" in log.messages[0]

    def test_every_step_torn_raises(self, tmp_path):
        self._two_steps(str(tmp_path))
        for s in ("1", "2"):
            self._truncate(tmp_path / s)
        log = _Records("test_torch_checkpoint.torn.all")
        with pytest.raises(Exception):
            resume_or_init(CheckpointManager(str(tmp_path)),
                           lambda: _port(seed=1)[0], logger=log.logger)
        assert len(log.messages) == 2

    def test_leftover_temporary_directory_is_not_a_step(self, tmp_path):
        copies = self._two_steps(str(tmp_path))
        # what a writer killed before its rename leaves behind
        tmp = tmp_path / ".3.tmp-0123456789ab"
        tmp.mkdir()
        (tmp / "params.pt").write_bytes(b"PK\x03\x04 torn")
        ckpt = CheckpointManager(str(tmp_path))
        assert ckpt.all_steps() == [1, 2] and ckpt.latest_step() == 2
        state, resumed = resume_or_init(ckpt, lambda: _port(seed=1)[0])
        assert resumed
        _assert_same(state, copies[2])

    def test_foreign_step_directory_is_refused_by_name(self, tmp_path):
        """An orbax checkpoint of the JAX package at the same path: never
        read, never passed over, never replaced by a fresh init."""
        import jax.numpy as jnp

        from paddle_operator_tpu.train.checkpoint import (
            CheckpointManager as JaxManager)

        jm = JaxManager(str(tmp_path), save_interval_steps=1)
        jm.save(5, {"w": jnp.zeros(2)}, force=True)
        jm.close()
        assert (tmp_path / "5").is_dir()
        ckpt = CheckpointManager(str(tmp_path))
        where = str(tmp_path / "5")
        for call in (ckpt.all_steps, ckpt.latest_step,
                     lambda: resume_or_init(ckpt, lambda: _port()[0]),
                     lambda: S.load_serving_params(
                         str(tmp_path), TL.CONFIGS["tiny"], device="cpu")):
            with pytest.raises(ValueError, match="did not write") as err:
                call()
            assert where in str(err.value)
        state, _ = _trained(1)
        with pytest.raises(ValueError, match="did not write"):
            ckpt.save(6, state, force=True)
        assert not (tmp_path / "6").exists() and (tmp_path / "5").is_dir()


# ---------------------------------------------------------------------------
# The drain and the operator's restart loop
# ---------------------------------------------------------------------------


class TestDrain:
    def test_sigterm_in_fit_leaves_a_durable_checkpoint(self, tmp_path):
        """tests/test_ft_preemption.py TestDrainInFit on the port: the
        signal lands while step 4 is in flight, the step completes, a
        checkpoint of it is forced (the interval is longer than the run)
        and durable, and the loop returns."""
        state, step = _port()
        ckpt = CheckpointManager(str(tmp_path), save_interval_steps=1000)
        log = _Records("test_torch_checkpoint.drain")
        watcher = TP.PreemptionWatcher.install(signals=(signal.SIGTERM,))
        try:
            batches = TP.inject_preemption(_batches(), 3, watcher,
                                           signal_self=True)
            state, hist = TT.fit(state, step, batches, steps=50,
                                 checkpoint=ckpt, logger=log.logger,
                                 preemption=watcher)
        finally:
            watcher.uninstall()
        assert watcher.draining and watcher.reason == "signal:SIGTERM"
        assert state.step == 4 and len(hist) == 4
        assert ckpt.latest_step() == 4
        assert any("preemption drain (signal:SIGTERM): step=4 "
                   "checkpoint=saved" in m for m in log.messages)
        restored = CheckpointManager(str(tmp_path)).restore(_port(1)[0])
        _assert_same(restored, _copy(state))

    def test_drain_while_the_interval_save_is_in_flight(self, tmp_path,
                                                        gate):
        """The loop's own interval save of the drained step is still
        being written: the drain waits for it instead of saving
        twice."""
        state, step = _port()
        ckpt = CheckpointManager(str(tmp_path), save_interval_steps=2)
        watcher = TP.PreemptionWatcher()
        threading.Timer(0.3, gate.set).start()
        state, hist = TT.fit(
            state, step, TP.inject_preemption(_batches(), 1, watcher),
            steps=5, checkpoint=ckpt, preemption=watcher)
        assert state.step == 2 and ckpt.all_steps() == [2]

    def test_inject_preemption_matches_jax(self):
        from paddle_operator_tpu.ft import preemption as JP

        for at in (0, 2, 5):
            seen = []
            for mod in (JP, TP):
                w = mod.PreemptionWatcher()
                seen.append([w.draining for _ in mod.inject_preemption(
                    range(8), at, w)])
            assert seen[0] == seen[1]
            assert seen[1].index(True) == at


def test_operator_restart_resumes_on_the_port(tmp_path):
    """tests/test_preemption_recovery.py on the port's workload: the JAX
    control plane injects TPUJOB_CHECKPOINT_PATH, a failed pod restarts
    the gang, and the port resumes at the checkpointed step."""
    from paddle_operator_tpu.api import ResourceSpec, TPUJob, TPUJobSpec
    from paddle_operator_tpu.api.types import Phase
    from paddle_operator_tpu.controller.fake_api import FakeAPI, FakeFleet
    from paddle_operator_tpu.controller.reconciler import (
        KIND_CM, KIND_JOB, TPUJobReconciler, run_to_settled)

    ns, tmpl = "default", {"spec": {"containers": [{"name": "m",
                                                    "image": "torch"}]}}
    ckpt_path = str(tmp_path / "ckpt")
    api = FakeAPI()
    rec = TPUJobReconciler(api)
    fleet = FakeFleet(api, ns)
    api.create(KIND_JOB, TPUJob(name="pj", namespace=ns, spec=TPUJobSpec(
        worker=ResourceSpec(replicas=2, template=tmpl), max_restarts=2,
        checkpoint_path=ckpt_path)).to_dict())
    run_to_settled(rec, ns, "pj")
    fleet.run_all()
    run_to_settled(rec, ns, "pj")
    env = api.get(KIND_CM, ns, "pj")["data"]
    assert env["TPUJOB_CHECKPOINT_PATH"] == ckpt_path

    # epoch 1: a worker launched with the injected env trains 3 steps
    ckpt = CheckpointManager(env["TPUJOB_CHECKPOINT_PATH"],
                             save_interval_steps=1)
    state, resumed = resume_or_init(ckpt, lambda: _port()[0])
    assert not resumed
    step = TT.make_train_step(TT.make_optimizer(1e-3, warmup_steps=1,
                                                decay_steps=100))
    state, hist = TT.fit(state, step, _batches(), steps=3, checkpoint=ckpt)
    ckpt.close()
    before = _copy(state)

    # a worker pod fails: one restart, same ranks and checkpoint path
    fleet.fail("pj-worker-1")
    run_to_settled(rec, ns, "pj")
    fleet.run_all()
    run_to_settled(rec, ns, "pj")
    job = TPUJob.from_dict(api.get(KIND_JOB, ns, "pj"))
    assert job.status.phase == Phase.RUNNING
    assert job.status.restart_count == 1
    env2 = api.get(KIND_CM, ns, "pj")["data"]
    assert env2["TPUJOB_CHECKPOINT_PATH"] == ckpt_path

    # epoch 2: the restarted worker resumes and continues
    ckpt2 = CheckpointManager(env2["TPUJOB_CHECKPOINT_PATH"],
                              save_interval_steps=1)
    state2, resumed = resume_or_init(ckpt2, lambda: _port(seed=1)[0])
    assert resumed and state2.step == 3
    _assert_same(state2, before)
    state2, hist2 = TT.fit(state2, step, _batches(start=3), steps=1,
                           checkpoint=ckpt2)
    ckpt2.close()
    assert state2.step == 4 and ckpt2.all_steps() == [2, 3, 4]
    assert np.isfinite(hist2[0]["loss"])
    assert abs(hist2[0]["loss"] - hist[-1]["loss"]) < 1.0


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
class TestOnCard:
    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("no CUDA card")

    def test_save_restore_on_the_card_is_bit_exact(self, tmp_path):
        state, step = _port(device="cuda", preset="1b", n_layers=1)
        state, _ = TT.fit(state, step, _batches(device="cuda"), steps=2)
        ckpt = CheckpointManager(str(tmp_path))
        ckpt.save(2, state, force=True)
        want = _copy(state)
        ckpt.close()
        restored = ckpt.restore(_port(seed=1, device="cuda", preset="1b",
                                      n_layers=1)[0])
        assert all(v.is_cuda for v in restored.opt_state.mu.values())
        _assert_same(restored, want)

    def test_serving_restore_adds_only_the_bf16_params(self, tmp_path):
        state, _ = _port(device="cuda", preset="1b", n_layers=1)
        ckpt = CheckpointManager(str(tmp_path))
        ckpt.save(1, state, force=True)
        ckpt.close()
        want = {k: v.to(torch.bfloat16) for k, v in
                state.model.state_dict().items()}
        del state
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(TL.CONFIGS["1b"], n_layers=1)
        base = torch.cuda.memory_allocated()
        model, scfg, resumed = S.load_serving_params(str(tmp_path), cfg,
                                                     device="cuda")
        added = torch.cuda.memory_allocated() - base
        bf16_bytes = 2 * scfg.num_params()
        assert resumed and added <= bf16_bytes + SERVE_LOAD_MARGIN, \
            (added, bf16_bytes)
        for k, v in want.items():
            assert torch.equal(model.state_dict()[k], v), k
