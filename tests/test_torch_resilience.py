"""The NaN-lane quarantine (SERVE_NAN_CHECK) and the deterministic fault
harness (TPUJOB_CHAOS, paddle_operator_tpu_torch/infer/chaos.py) on the
torch package's serving ring, held against the JAX package: the cases
of tests/test_resilience.py TestNanQuarantine and TestChaosHarness on
the contiguous, paged and int8 rings (megastep 1 and 4), with every
surviving stream equal to JAX ``decode.generate`` on the same converted
``tiny`` params (the int8 pool's to its own chaos-free run: int8 is not
token-equal to the exact pool), ``parse_schedule`` equal to the JAX
package's on the whole grammar, and the flight-recorder dump naming
each injected fault.
"""

import json
import threading
import urllib.error
import urllib.request
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_operator_tpu.infer import chaos as JC
from paddle_operator_tpu.infer import decode as JD
from paddle_operator_tpu.models.llama import make_model as jax_make_model
from paddle_operator_tpu_torch.convert import params_from_jax
from paddle_operator_tpu_torch.infer import chaos as PC
from paddle_operator_tpu_torch.infer import executor as X
from paddle_operator_tpu_torch.infer import serve as S
from paddle_operator_tpu_torch.infer.batcher import ContinuousBatcher
from paddle_operator_tpu_torch.infer.paged import NoFreeBlocks
from paddle_operator_tpu_torch.infer.resilience import (
    LaneQuarantined,
    RetriableError,
    RingResilience,
)
from paddle_operator_tpu_torch.models.llama import make_model
from paddle_operator_tpu_torch.utils import tracing as TR

MAX_LEN = 64
RINGS = [pytest.param(dict(paged=True, block_size=8), id="paged"),
         pytest.param(dict(paged=False), id="contig"),
         pytest.param(dict(paged=True, block_size=8, kv_quant="int8"),
                      id="int8"),
         pytest.param(dict(paged=True, block_size=8, megastep=4),
                      id="paged-megastep4"),
         pytest.param(dict(paged=False, megastep=4), id="contig-megastep4")]


@pytest.fixture(scope="module")
def setup():
    jmodel, jcfg = jax_make_model("tiny", dtype=jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, 8), jnp.int32))["params"]
    model, cfg = make_model("tiny", device="cpu", dtype=torch.float32)
    model.load_state_dict(params_from_jax(jax.device_get(jparams)))
    refs = {}

    def ref(prompt, new):
        key = (tuple(prompt), new)
        if key not in refs:
            refs[key] = np.asarray(JD.generate(
                jparams, jcfg, jnp.asarray([prompt], jnp.int32),
                max_new_tokens=new, max_len=MAX_LEN)[0]).tolist()
        return refs[key]

    return model, cfg, ref


def _prompt(s, seed):
    return np.random.default_rng(seed).integers(0, 256, s).tolist()


def _batcher(model, cfg, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("chunk_tokens", 4)
    kw.setdefault("prefill_buckets", (16, MAX_LEN))
    return ContinuousBatcher(model, cfg, **kw)


def _nan_at_next(b, lane):
    inj = PC.ChaosInjector("").install(b)
    nxt = inj.dispatches
    inj.events[nxt] = [PC.ChaosEvent("nan_lane", nxt, lane)]
    return inj


class TestNanQuarantine:
    @pytest.mark.parametrize("kw", RINGS)
    def test_nan_lane_fails_one_request_not_the_ring(self, setup, kw,
                                                     tmp_path, monkeypatch):
        """The poisoned lane's request fails with LaneQuarantined; the
        other resident lane's stream equals the chaos-free one (JAX's on
        the exact pools), the ring stays healthy, the lane serves the
        next request exactly, and the flight recorder names both the
        injected fault and the quarantine."""
        monkeypatch.setenv(TR.FLIGHTREC_DIR_ENV, str(tmp_path))
        model, cfg, ref = setup
        ps = [_prompt(6, 10), _prompt(13, 11)]
        quant = kw.get("kv_quant") == "int8"
        b = _batcher(model, cfg, resilience=RingResilience(
            watchdog=False, nan_check=True), **kw)
        try:
            # the prompts once, so the run under the fault takes the same
            # path (the 13-token prompt's full block hits the radix)
            cold = [b.submit(p, max_new_tokens=12).result(timeout=120)
                    for p in ps]
            # the int8 pool's own chaos-free streams on that path are the
            # oracle (a hit reads the quantized prefix); the exact pools'
            # equal JAX generate's
            want = ([b.submit(p, max_new_tokens=12).result(timeout=120)
                     for p in ps] if quant else [ref(p, 12) for p in ps])
            if not quant:
                assert cold == want
            inj = _nan_at_next(b, 0)
            hs = [b.submit(p, max_new_tokens=12) for p in ps]
            outcomes = []
            for h, w in zip(hs, want):
                try:
                    outcomes.append(("ok", h.result(timeout=120) == w))
                except LaneQuarantined:
                    outcomes.append(("quarantined", True))
            assert sorted(k for k, _ in outcomes) == \
                ["ok", "quarantined"], outcomes
            assert all(good for _, good in outcomes), outcomes
            assert b.stats["quarantined_lanes"] == 1
            assert b.serving_status()["quarantinedLanes"] == 1
            assert b.healthy and [k for k, _ in inj.fired] == ["nan_lane"]
            kinds = [e["kind"] for e in b.flightrec.events()]
            assert "chaos_injected" in kinds and "nan_quarantine" in kinds
            dump = json.loads(Path(b.flightrec.last_dump_path).read_text())
            assert dump["reason"] == "chaos:nan_lane"
            # the quarantined lane serves the next request exactly
            assert b.submit(ps[0], max_new_tokens=12).result(
                timeout=120) == want[0]
            if b.pool is not None:
                b.pool.check_invariant()
        finally:
            b.close()

    @pytest.mark.parametrize("kv_quant", ["none", "int8"])
    def test_paged_nan_blocks_scrubbed_before_reuse(self, setup, kv_quant):
        """A quarantined paged lane's private blocks (and, int8, its
        scales and staging tail) are scrubbed before they are reused:
        with one lane, the re-mapped blocks serve the same prompt again
        bit for bit, twice, and the pool invariant holds."""
        model, cfg, ref = setup
        b = _batcher(model, cfg, slots=1, paged=True, block_size=8,
                      kv_quant=kv_quant, resilience=RingResilience(
                          watchdog=False, nan_check=True))
        try:
            p = _prompt(13, 12)     # an unaligned prompt: a private tail
            want = b.submit(p, max_new_tokens=10).result(timeout=120)
            if kv_quant == "none":
                assert want == ref(p, 10)
            _nan_at_next(b, 0)
            with pytest.raises(LaneQuarantined):
                b.submit(p, max_new_tokens=10).result(timeout=120)
            b.pool.check_invariant()
            for _ in range(2):
                assert b.submit(p, max_new_tokens=10).result(
                    timeout=120) == want
            b.pool.check_invariant()
        finally:
            b.close()

    def test_nan_check_rejected_with_speculation(self, setup):
        model, cfg, _ = setup
        with pytest.raises(ValueError, match="nan_check"):
            _batcher(model, cfg, spec_k=2, draft_params=model,
                     draft_cfg=cfg,
                     resilience=RingResilience(nan_check=True))

    @pytest.mark.parametrize("megastep", [1, 3])
    @pytest.mark.parametrize("paged", [True, False])
    def test_ok_is_a_dispatch_output_only_with_the_check(self, setup,
                                                         megastep, paged):
        """``check_finite`` adds ``ok`` to every dispatch ([B] at one
        step, [n, B] fused), True for lanes that did not step; without
        it the dispatch carries none."""
        model, cfg, _ = setup
        for check in (False, True):
            ex = X.RingExecutor(model, cfg, slots=2, max_len=32,
                                chunk_tokens=2, paged=paged, block_size=8,
                                megastep=megastep, check_finite=check)
            table = np.zeros((2, ex.pool.max_blocks), np.int32) \
                if paged else None
            with torch.inference_mode():
                res = ex.replay(X.ExecPlan(
                    megastep, [False, False], table=table,
                    eos=np.full(2, -1, np.int32),
                    left=np.full(2, 4, np.int32),
                    steps=np.full(2, megastep, np.int32)))
            res.host()
            ok = res.ok_host()
            if not check:
                assert ok is None
                continue
            assert ok.dtype == np.bool_ and ok.all()
            assert ok.shape == ((2,) if megastep == 1 else (megastep, 2))

    def test_http_quarantine_is_a_retriable_503(self, setup, tmp_path,
                                                monkeypatch):
        """Through the server built from SERVE_NAN_CHECK=1 (and the
        SERVE_TRACE / TPUJOB_CHAOS knobs, which main() no longer
        refuses): the quarantined request answers 503 + Retry-After, the
        next one 200 with JAX's tokens."""
        monkeypatch.setenv(TR.FLIGHTREC_DIR_ENV, str(tmp_path))
        model, cfg, ref = setup
        env = {"SERVE_CONTINUOUS": "1", "SERVE_PAGED": "1",
               "SERVE_BLOCK_SIZE": "8", "SERVE_MAX_LEN": str(MAX_LEN),
               "SERVE_SLOTS": "1", "SERVE_CHUNK": "4", "SERVE_WATCHDOG": "0",
               "SERVE_NAN_CHECK": "1", "SERVE_TRACE": "1",
               "TPUJOB_CHAOS": "nan_lane@0:0", "SERVE_PREWARM": "0"}
        S.refuse_unported(env)
        kw = S.ring_kw_from_env(env)
        assert kw["resilience"].nan_check and kw["trace"]
        srv = S.make_server("127.0.0.1", 0, model, cfg, continuous=True,
                            **kw)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{srv.server_address[1]}/v1/generate"
        p = _prompt(13, 13)

        def post():
            req = urllib.request.Request(
                url, data=json.dumps({"tokens": [p],
                                      "max_new_tokens": 12}).encode(),
                method="POST")
            try:
                with urllib.request.urlopen(req, timeout=60) as r:
                    return r.status, json.loads(r.read()), r.headers
            except urllib.error.HTTPError as e:
                return e.code, json.loads(e.read()), e.headers

        try:
            code, body, _ = post()
            assert code == 200 and body["tokens"] == [ref(p, 12)]
            assert body["trace"][0]["spans"][0]["name"] == "request"
            # the hook serve.main() runs: its clock starts at install
            inj = PC.maybe_install_from_env(srv.generator.batcher, env)
            code, body, hdrs = post()
            assert code == 503 and "quarantined" in body["error"]
            assert hdrs.get("Retry-After") is not None
            assert inj.fired == [("nan_lane", 0)]
            code, body, _ = post()
            assert code == 200 and body["tokens"] == [ref(p, 12)]
        finally:
            srv.shutdown()
            srv.server_close()
            srv.generator.close()


SCHEDULES = ["dispatch_fail@5,dispatch_hang@9:2.5,nan_lane@12:1,"
             "client_drop@7,pool_oom@3:2", "", " , nan_lane@0 ,",
             "dispatch_hang@4", "pool_oom@1:0.5,pool_oom@1",
             "explode@3", "dispatch_fail", "nan_lane@x", "nan_lane@2:y"]


class TestChaosHarness:
    @pytest.mark.parametrize("spec", SCHEDULES)
    def test_parse_schedule_equals_jax(self, spec):
        """The grammar, its errors included, as the JAX package parses
        it."""
        def parse(mod):
            try:
                return [(e.kind, e.at, e.arg)
                        for e in mod.parse_schedule(spec)]
            except ValueError as e:
                return ("ValueError", str(e))

        assert parse(PC) == parse(JC)
        assert PC.KINDS == JC.KINDS
        assert (PC.CHAOS_ENV, PC.CHAOS_SEED_ENV) == \
            (JC.CHAOS_ENV, JC.CHAOS_SEED_ENV)

    def test_schedule_fires_deterministically(self, setup):
        """Same schedule, same requests -> the same (kind, dispatch)
        firing log run over run; the failed dispatch heals the ring."""
        model, cfg, ref = setup

        def run():
            b = _batcher(model, cfg, slots=1, resilience=RingResilience(
                watchdog=False, backoff_base_s=0.02))
            try:
                p = _prompt(6, 13)
                b.submit(p, max_new_tokens=4).result(timeout=120)
                inj = PC.ChaosInjector("dispatch_fail@2",
                                       seed=3).install(b)
                with pytest.raises(RetriableError):
                    b.submit(p, max_new_tokens=16).result(timeout=60)
                assert b.submit(p, max_new_tokens=4).result(
                    timeout=120) == ref(p, 4)
                assert b.stats["watchdog_restarts"] == 1
                return list(inj.fired)
            finally:
                b.close()

        assert run() == run() == [("dispatch_fail", 2)]

    def test_pool_oom_fails_one_request_ring_survives(self, setup):
        model, cfg, ref = setup
        b = _batcher(model, cfg, paged=True, block_size=8)
        try:
            p = _prompt(6, 14)
            assert b.submit(p, max_new_tokens=8).result(
                timeout=120) == ref(p, 8)
            inj = PC.ChaosInjector("").install(b)
            nxt = inj.dispatches
            inj.events[nxt] = [PC.ChaosEvent("pool_oom", nxt, 99)]
            h = b.submit(p, max_new_tokens=16)
            with pytest.raises(NoFreeBlocks):
                h.result(timeout=60)
            b.pool.chaos_fail_allocs = 0
            b.pool.check_invariant()
            assert b.submit(p, max_new_tokens=8).result(
                timeout=120) == ref(p, 8)
        finally:
            b.close()

    def test_client_drop_resolves_the_partial(self, setup):
        """client_drop cancels the named resident lane: it resolves with
        a prefix of its stream, and the ring serves on."""
        model, cfg, ref = setup
        b = _batcher(model, cfg, slots=1, paged=True, block_size=8)
        try:
            p = _prompt(9, 15)
            inj = PC.ChaosInjector("").install(b)
            inj.events[inj.dispatches + 1] = [
                PC.ChaosEvent("client_drop", inj.dispatches + 1, 0)]
            out = b.submit(p, max_new_tokens=40).result(timeout=120)
            full = ref(p, 40)
            assert len(p) < len(out) < len(full)
            assert out == full[:len(out)]
            assert b.submit(p, max_new_tokens=8).result(
                timeout=120) == ref(p, 8)
        finally:
            b.close()

    def test_dump_names_the_fault(self, tmp_path, monkeypatch):
        """jax-free, as tests/test_tracing.py has it for the JAX
        package: an injected fault lands in the pod's ring and the forced
        dump names it."""
        monkeypatch.setenv(TR.FLIGHTREC_DIR_ENV, str(tmp_path))
        fr = TR.FlightRecorder(pod="chaos-pod")
        batcher = SimpleNamespace(
            executor=SimpleNamespace(replay=lambda plan: "ok"),
            lane=[None, None], pool=None, flightrec=fr)
        inj = PC.ChaosInjector("dispatch_fail@1", seed=0).install(batcher)
        assert batcher.executor.replay("p0") == "ok"
        with pytest.raises(RuntimeError, match="chaos"):
            batcher.executor.replay("p1")
        assert inj.fired == [("dispatch_fail", 1)]
        dump = TR.read_flightrec_dump(fr.last_dump_path)
        assert dump["reason"] == "chaos:dispatch_fail"
        ev = [e for e in dump["events"] if e["kind"] == "chaos_injected"]
        assert ev and ev[0]["fault"] == "dispatch_fail" \
            and ev[0]["dispatch"] == 1

    def test_maybe_install_from_env(self, setup):
        model, cfg, _ = setup
        b = _batcher(model, cfg)
        try:
            assert PC.maybe_install_from_env(b, {}) is None
            inj = PC.maybe_install_from_env(
                b, {"TPUJOB_CHAOS": "dispatch_hang@0:0.01",
                    "TPUJOB_CHAOS_SEED": "4"})
            assert sorted(inj.events) == [0]
            b.submit([1, 2, 3], max_new_tokens=2).result(timeout=120)
            assert inj.fired == [("dispatch_hang", 0)]
        finally:
            b.close()
