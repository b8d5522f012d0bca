"""The torch package's batch server (paddle_operator_tpu_torch/infer/
serve.py) held against the JAX batch server over real HTTP: both serve
the same converted ``tiny`` params on CPU, and the same requests get
the same tokens, status codes and bodies.  Also the entry point's
refusals, the drain contract and the jax-free helper copies.
"""

import dataclasses
import json
import os
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_operator_tpu.infer.serve import make_server as jax_make_server
from paddle_operator_tpu.models.llama import make_model as jax_make_model
from paddle_operator_tpu_torch.convert import params_from_jax
from paddle_operator_tpu_torch.infer import serve as S
from paddle_operator_tpu_torch.models.llama import make_model


@pytest.fixture(scope="module")
def servers():
    jmodel, jcfg = jax_make_model("tiny", dtype=jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, 8), jnp.int32))["params"]
    model, cfg = make_model("tiny", device="cpu", dtype=torch.float32)
    model.load_state_dict(params_from_jax(jax.device_get(jparams)))
    port_srv = S.make_server("127.0.0.1", 0, model, cfg, job="j",
                             replica="r0")
    jax_srv = jax_make_server("127.0.0.1", 0, jparams, jcfg, job="j",
                              replica="r0")
    for srv in (port_srv, jax_srv):
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield ({"port": port_srv, "jax": jax_srv},
           {k: f"http://127.0.0.1:{s.server_address[1]}"
            for k, s in (("port", port_srv), ("jax", jax_srv))})
    for srv in (port_srv, jax_srv):
        srv.shutdown()
        srv.server_close()


def _call(url, method="GET", body=None, headers=None):
    data = body if isinstance(body, (bytes, type(None))) \
        else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method,
                                 headers=headers or {})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _both(servers, path, **kw):
    _, urls = servers
    return (_call(urls["port"] + path, **kw),
            _call(urls["jax"] + path, **kw))


GENERATE_BODIES = [
    {"tokens": [[1, 2, 3, 4, 5, 6]], "max_new_tokens": 4},
    {"tokens": [[7, 8, 9, 10, 11, 12, 13, 14, 15],
                [200, 3, 3, 9, 1, 0, 5, 6, 7]], "max_new_tokens": 8},
    {"tokens": [[3, 1, 4, 1, 5]], "max_new_tokens": 5, "eos_token": 2},
    {"tokens": [[42] * 12], "request_id": "abc\r\nX: y"},
]


class TestParity:
    @pytest.mark.parametrize("body", GENERATE_BODIES)
    def test_same_tokens(self, servers, body):
        (pc, pb, ph), (jc, jb, jh) = _both(servers, "/v1/generate",
                                           method="POST", body=body)
        assert pc == jc == 200
        assert json.loads(pb) == json.loads(jb)
        assert ph.get("X-Request-Id") == jh.get("X-Request-Id")
        assert ph.get("X-Tpujob-Replica") == jh.get("X-Tpujob-Replica")

    @pytest.mark.parametrize("path", ["/healthz", "/readyz", "/statusz",
                                      "/metrics", "/v1/adapters",
                                      "/debug/flightrec", "/nope"])
    def test_get_routes_match(self, servers, path):
        (pc, pb, _), (jc, jb, _) = _both(servers, path)
        assert pc == jc
        assert pb == jb

    @pytest.mark.parametrize("path,body", [
        ("/v1/generate", {"tokens": [[1, 2]], "stream": True}),
        ("/v1/generate", {"tokens": [1, 2, 3]}),
        ("/v1/generate", {"max_new_tokens": 3}),
        ("/v1/generate", b"{not json"),
        ("/v1/generate", {"tokens": [[1, 2]], "max_new_tokens": 500}),
        ("/v1/swap", {}),
        ("/v1/kv/restore", b"\x00\x01"),
        ("/v1/kv/prefix", {"tokens": [1, 2]}),
        ("/v1/adapters", {"load": {"name": "a"}}),
        ("/v1/nope", {}),
    ])
    def test_post_routes_match(self, servers, path, body):
        (pc, pb, _), (jc, jb, _) = _both(servers, path, method="POST",
                                         body=body)
        assert pc == jc
        if pc != 400 or path != "/v1/generate":
            assert pb == jb
        else:
            assert "error" in json.loads(pb)

    def test_bad_priority_header_is_400(self, servers):
        hdr = {"X-Request-Priority": "urgent"}
        (pc, _, _), (jc, _, _) = _both(
            servers, "/v1/generate", method="POST",
            body={"tokens": [[1, 2]]}, headers=hdr)
        assert pc == jc == 400

    def test_sampled_request_deterministic_per_seed(self, servers):
        _, urls = servers
        body = {"tokens": [[3, 1, 4, 1, 5]], "max_new_tokens": 6,
                "temperature": 0.8, "top_k": 8, "top_p": 0.9, "seed": 7}
        a = _call(urls["port"] + "/v1/generate", "POST", body)
        b = _call(urls["port"] + "/v1/generate", "POST", body)
        assert a[0] == 200 and json.loads(a[1]) == json.loads(b[1])
        toks = json.loads(a[1])["tokens"][0]
        assert len(toks) == 11 and all(0 <= t < 256 for t in toks)

    def test_out_of_vocab_token_is_400(self, servers):
        _, urls = servers
        code, _, _ = _call(urls["port"] + "/v1/generate", "POST",
                           {"tokens": [[1, 256]]})
        assert code == 400


class TestDrain:
    def test_draining_sheds_with_retry_after(self, servers):
        srvs, urls = servers
        srvs["port"].state.draining = True
        try:
            code, body, hdrs = _call(urls["port"] + "/v1/generate", "POST",
                                     {"tokens": [[1, 2]]})
            assert code == 503 and hdrs.get("Retry-After") == "5"
            assert "draining" in json.loads(body)["error"]
            code, body, hdrs = _call(urls["port"] + "/readyz")
            assert code == 503 and hdrs.get("Retry-After") == "5"
            assert json.loads(body)["reason"] == "draining"
            assert _call(urls["port"] + "/healthz")[0] == 200
        finally:
            srvs["port"].state.draining = False

    def test_drain_exits_preempted(self):
        from paddle_operator_tpu.ft.preemption import EXIT_PREEMPTED as J83
        from paddle_operator_tpu_torch.ft.preemption import EXIT_PREEMPTED
        from paddle_operator_tpu_torch.infer.resilience import (
            ServerState,
            ServingDrain,
        )

        class Srv:
            shut = False

            def shutdown(self):
                self.shut = True

        codes, srv, state = [], Srv(), ServerState()
        drain = ServingDrain(srv, state, handler_grace_s=0.0,
                             exit_fn=codes.append)
        drain.run("test")
        assert state.draining and srv.shut
        assert codes == [EXIT_PREEMPTED] == [J83] == [83]

    def test_main_returns_preempted_after_a_drain(self):
        """``serve_until_drained`` (main()'s tail): once the drain's
        shutdown ends ``serve_forever``, the entry point waits for the
        drain, which exits 83, and itself returns 83 — never 0."""
        from paddle_operator_tpu_torch.infer.resilience import (
            ServerState,
            ServingDrain,
        )

        class Srv:
            def __init__(self):
                self.stop = threading.Event()

            def serve_forever(self):
                self.stop.wait(30)

            def shutdown(self):
                self.stop.set()

        codes, srv = [], Srv()
        drain = ServingDrain(srv, ServerState(), handler_grace_s=0.3,
                             exit_fn=codes.append)
        threading.Timer(0.05, drain.start_async, ("test",)).start()
        assert S.serve_until_drained(srv, drain) == 83
        assert drain.done.is_set()
        for _ in range(500):          # done is set just before the exit
            if codes:
                break
            time.sleep(0.01)
        assert codes == [83]


ENTRY_KNOBS = ("SERVE_CONTINUOUS", "SERVE_PAGED", "SERVE_TP", "QUANTIZE",
               "SERVE_WEIGHT_QUANT", "TPUJOB_CHECKPOINT_PATH",
               "SERVE_SPEC_K", "SERVE_KV_QUANT", "SERVE_HOST_CACHE_BLOCKS",
               "SERVE_HOST_CACHE_MB", "SERVE_PREFILL", "SERVE_MEGASTEP",
               "SERVE_ADAPTERS", "SERVE_TRACE", "SERVE_NAN_CHECK",
               "SERVE_PREEMPT", "SERVE_PREEMPT_MAX_PER_REQ",
               "SERVE_PREEMPT_BUDGET", "SERVE_PREEMPT_WINDOW_S",
               "TPUJOB_CHAOS", "SERVE_KV_MIGRATE",
               "SERVE_KV_PEER_FETCH", "SERVE_KV_STORE", "SERVE_KV_BROKER")


class TestEntryPoint:
    @pytest.mark.parametrize("env", [
        # SERVE_ADAPTERS is served (tests/test_torch_adapters.py): beside
        # a knob still refused, main() refuses that knob
        {"SERVE_CONTINUOUS": "1", "SERVE_ADAPTERS": "acme",
         "SERVE_KV_MIGRATE": "1"},
        {"SERVE_TP": "2"},
    ])
    def test_unported_knobs_refused(self, monkeypatch, env):
        for k in ENTRY_KNOBS:
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        with pytest.raises(ValueError, match="not ported"):
            S.main()

    @pytest.mark.parametrize("env,mode", [
        ({"QUANTIZE": "int8"}, "int8"),
        ({"SERVE_WEIGHT_QUANT": "int8"}, "int8"),
        ({"SERVE_WEIGHT_QUANT": "int4"}, "int4"),
    ], ids=["QUANTIZE=int8", "SERVE_WEIGHT_QUANT=int8",
            "SERVE_WEIGHT_QUANT=int4"])
    def test_weight_quant_knobs_boot(self, monkeypatch, env, mode):
        """The weight-quant knobs pass the refusals, and the replica
        ``main`` builds (paged ring, the model quantized by
        ``quantize_from_env``) serves and names the mode in its
        status."""
        for k in ENTRY_KNOBS:
            monkeypatch.delenv(k, raising=False)
        environ = {"SERVE_CONTINUOUS": "1", "SERVE_PAGED": "1", **env}
        S.refuse_unported(environ)
        model, cfg = make_model("tiny", device="cpu", dtype=torch.float32)
        assert S.quantize_from_env(model, cfg, environ) == mode
        kw = S.ring_kw_from_env(dict(environ, SERVE_BLOCK_SIZE="8",
                                     SERVE_MAX_LEN="64", SERVE_SLOTS="2",
                                     SERVE_CHUNK="4"), cfg)
        srv = S.make_server("127.0.0.1", 0, model, cfg, continuous=True,
                            **kw)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            code, body, _ = _call(url + "/v1/generate", "POST",
                                  {"tokens": [[1, 2, 3]],
                                   "max_new_tokens": 3})
            assert code == 200 and len(json.loads(body)["tokens"][0]) == 6
            st = json.loads(_call(url + "/statusz")[1])
            assert st["weightQuantMode"] == mode
        finally:
            srv.shutdown()
            srv.server_close()
            srv.generator.close()

    def test_unknown_weight_quant_mode_raises(self):
        model, cfg = make_model("tiny", device="cpu", dtype=torch.float32)
        with pytest.raises(ValueError, match="int3"):
            S.quantize_from_env(model, cfg, {"SERVE_WEIGHT_QUANT": "int3"})

    def test_no_card_no_cpu_serving(self, monkeypatch):
        if torch.cuda.is_available():
            pytest.skip("a card is present: main() would serve")
        for k in ENTRY_KNOBS:
            monkeypatch.delenv(k, raising=False)
        with pytest.raises(RuntimeError, match="CUDA"):
            S.main()
        # the continuous paged server needs the card just the same
        monkeypatch.setenv("SERVE_CONTINUOUS", "1")
        monkeypatch.setenv("SERVE_PAGED", "1")
        with pytest.raises(RuntimeError, match="CUDA"):
            S.main()

    def test_checkpoint_path_is_served_on_the_card_only(self, monkeypatch,
                                                       tmp_path):
        """TPUJOB_CHECKPOINT_PATH (the operator injects it into every pod
        of a job with spec.checkpointPath) is no longer refused: main()
        gets past the knobs and, with no card, still refuses to serve on
        the CPU."""
        if torch.cuda.is_available():
            pytest.skip("a card is present: main() would serve")
        for k in ENTRY_KNOBS:
            monkeypatch.delenv(k, raising=False)
        monkeypatch.setenv("TPUJOB_CHECKPOINT_PATH", str(tmp_path))
        S.refuse_unported(dict(os.environ))
        with pytest.raises(RuntimeError, match="CUDA"):
            S.main()

    def test_continuous_server_refused(self):
        # the continuous server serves (TestContinuousServer), adapters,
        # span tracing and disaggregated prefill included
        # (tests/test_torch_adapters.py, tests/test_torch_tracing.py,
        # tests/test_torch_disagg.py); what it does not carry yet —
        # tensor-parallel serving — is refused at construction
        model, cfg = make_model("tiny", device="cpu")
        with pytest.raises(NotImplementedError,
                           match="tensor-parallel"):
            S.make_server("127.0.0.1", 0, model, cfg, continuous=True,
                          trace=True, paged=True, prefill_mode="disagg",
                          mesh="tp2")

    def test_job_env_matches_jax(self):
        from paddle_operator_tpu.launch.launcher import JobEnv as JEnv
        from paddle_operator_tpu_torch.launch.launcher import JobEnv

        for environ in ({}, {"TPUJOB_PORT": "8999", "TPUJOB_NAME": "j",
                             "TPUJOB_CHECKPOINT_PATH": "/c"}):
            a, b = JobEnv.from_env(environ), JEnv.from_env(environ)
            assert (a.port, a.checkpoint_path) == \
                (b.port, b.checkpoint_path)


STATUS_BLOCKS = [
    {},
    {"tokensPerSec": 12.5, "queueDepth": 3, "prefillMode": "chunked",
     "kvQuantMode": "int8", "kvPoolBytes": 1e6, "weightQuantMode": "int8",
     "draining": True, "priorityQueueDepth": [1, 2],
     "adapterNames": ["acme"], "weightGeneration": 4},
    {"servingTp": 1, "megastepN": 4, "dispatchesPerToken": 0.25,
     "hostHitRate": 0.5, "kvStoreBlocks": 7, "draftQuantMode": "int4"},
]


@pytest.mark.parametrize("block", STATUS_BLOCKS)
@pytest.mark.parametrize("replica", [None, "r0"])
def test_serving_gauges_match_jax(block, replica):
    from paddle_operator_tpu.utils import observability as JO
    from paddle_operator_tpu_torch.utils import observability as TO

    assert TO.serving_gauges(block, "ns/j", replica) == \
        JO.serving_gauges(block, "ns/j", replica)


def test_histogram_exposition_matches_jax():
    from paddle_operator_tpu.utils import observability as JO
    from paddle_operator_tpu_torch.utils import observability as TO

    hist = {"ttft": {"buckets": [1, 2.5, 10], "counts": [1, 0, 2],
                     "count": 4, "sum": 31.25},
            "e2e": {"buckets": [5], "counts": [3], "count": 3, "sum": 9.0}}
    for h in (None, {}, hist):
        assert TO.histogram_exposition(h, "j", "r") == \
            JO.histogram_exposition(h, "j", "r")


def test_safe_header_value_matches_jax():
    from paddle_operator_tpu.utils.tracing import safe_header_value as J
    from paddle_operator_tpu_torch.utils.tracing import safe_header_value

    for v in ("abc", "a\r\nb", "é" * 200, 12):
        assert safe_header_value(v) == J(v)


def test_generator_returns_numpy_prompt_plus_new():
    model, cfg = make_model("tiny", device="cpu", dtype=torch.float32)
    gen = S.Generator(model, cfg)
    out = gen(np.asarray([[1, 2, 3]], np.int32), max_new_tokens=4)
    assert isinstance(out, np.ndarray) and out.shape == (1, 7)
    np.testing.assert_array_equal(out[:, :3], [[1, 2, 3]])


# ---------------------------------------------------------------------------
# The continuous paged server (SERVE_CONTINUOUS=1 SERVE_PAGED=1)
# ---------------------------------------------------------------------------

RING_KW = dict(slots=2, chunk_tokens=4, max_len=64,
               prefill_buckets=(8, 16, 32, 64), paged=True, block_size=8)


@pytest.fixture(scope="module")
def ring_servers():
    jmodel, jcfg = jax_make_model("tiny", dtype=jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, 8), jnp.int32))["params"]
    model, cfg = make_model("tiny", device="cpu", dtype=torch.float32)
    model.load_state_dict(params_from_jax(jax.device_get(jparams)))
    srvs = {"port": S.make_server("127.0.0.1", 0, model, cfg,
                                  continuous=True, job="j", replica="r0",
                                  **RING_KW),
            "jax": jax_make_server("127.0.0.1", 0, jparams, jcfg,
                                   continuous=True, job="j", replica="r0",
                                   **RING_KW)}
    for srv in srvs.values():
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield srvs, {k: f"http://127.0.0.1:{s.server_address[1]}"
                 for k, s in srvs.items()}
    for srv in srvs.values():
        srv.shutdown()
        srv.server_close()
        srv.generator.close()


def _stream(url, body):
    """POST a streaming generate; returns the parsed ndjson events."""
    req = urllib.request.Request(url + "/v1/generate",
                                 data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        assert r.headers.get("Transfer-Encoding") == "chunked"
        return [json.loads(line) for line in r.read().splitlines()
                if line.strip()]


def _metric_keys(text: bytes):
    return {line.split(" ")[0] for line in text.decode().splitlines()
            if line and not line.startswith("#")}


class TestContinuousServer:
    @pytest.mark.parametrize("body", [
        {"tokens": [[1, 2, 3, 4, 5, 6]], "max_new_tokens": 7},
        {"tokens": [[7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20,
                     21, 22, 23], [200, 3, 3, 9, 1] * 3 + [4, 4]],
         "max_new_tokens": 9,
         "request_id": "rows"},
        {"tokens": [[3, 1, 4, 1, 5]], "max_new_tokens": 6, "eos_token": 2},
    ])
    def test_greedy_rows_equal_jax(self, ring_servers, body):
        _, urls = ring_servers
        (pc, pb, ph) = _call(urls["port"] + "/v1/generate", "POST", body)
        (jc, jb, jh) = _call(urls["jax"] + "/v1/generate", "POST", body)
        assert pc == jc == 200
        assert json.loads(pb) == json.loads(jb)
        assert ph.get("X-Request-Id") == jh.get("X-Request-Id")

    def test_prefix_hit_resubmission_equal(self, ring_servers):
        srvs, urls = ring_servers
        body = {"tokens": [list(range(30, 54))], "max_new_tokens": 5}
        first = _call(urls["port"] + "/v1/generate", "POST", body)
        hits0 = srvs["port"].generator.batcher.pool.stats[
            "prefix_hit_tokens"]
        again = _call(urls["port"] + "/v1/generate", "POST", body)
        assert first[0] == again[0] == 200 and first[1] == again[1]
        assert srvs["port"].generator.batcher.pool.stats[
            "prefix_hit_tokens"] > hits0

    def test_stream_events(self, ring_servers):
        _, urls = ring_servers
        body = {"tokens": [[9, 8, 7, 6, 5]], "max_new_tokens": 6,
                "stream": True}
        got, want = _stream(urls["port"], body), _stream(urls["jax"], body)
        assert got == want
        assert [e["token"] for e in got[:-1]] == got[-1]["tokens"][5:]
        assert got[-1]["done"] is True

    def test_deadline_partial_is_504(self, ring_servers):
        _, urls = ring_servers
        body = {"tokens": [[4, 4, 4]], "max_new_tokens": 8}
        hdr = {"X-Request-Deadline": "0.000001"}
        (pc, pb, _) = _call(urls["port"] + "/v1/generate", "POST", body, hdr)
        (jc, jb, _) = _call(urls["jax"] + "/v1/generate", "POST", body, hdr)
        assert pc == jc == 504
        assert json.loads(pb) == json.loads(jb)
        assert json.loads(pb)["deadline_exceeded"] == [True]

    def test_metrics_and_statusz_keys_equal_jax(self, ring_servers):
        _, urls = ring_servers
        body = {"tokens": [[5, 6, 7]], "max_new_tokens": 3}
        for url in urls.values():
            assert _call(url + "/v1/generate", "POST", body)[0] == 200
        (pc, pm, _), (jc, jm, _) = (_call(urls["port"] + "/metrics"),
                                    _call(urls["jax"] + "/metrics"))
        assert pc == jc == 200
        assert _metric_keys(pm) == _metric_keys(jm)
        ps = json.loads(_call(urls["port"] + "/statusz")[1])
        js = json.loads(_call(urls["jax"] + "/statusz")[1])
        assert set(ps) == set(js)
        fr = json.loads(_call(urls["port"] + "/debug/flightrec")[1])
        assert any(e["kind"] == "admit" for e in fr["events"])

    def test_priority_and_bad_priority(self, ring_servers):
        _, urls = ring_servers
        body = {"tokens": [[1, 2, 3]], "max_new_tokens": 2}
        for hdr, code in (({"X-Request-Priority": "0"}, 200),
                          ({"X-Request-Priority": "7"}, 400)):
            (pc, _, _) = _call(urls["port"] + "/v1/generate", "POST", body,
                               hdr)
            (jc, _, _) = _call(urls["jax"] + "/v1/generate", "POST", body,
                               hdr)
            assert pc == jc == code

    def test_readyz_while_healing_or_draining(self, ring_servers):
        srvs, urls = ring_servers
        b = srvs["port"].generator.batcher
        assert _call(urls["port"] + "/readyz")[0] == 200
        b._rebuilding = True
        try:
            code, body, _ = _call(urls["port"] + "/readyz")
            assert code == 503 and json.loads(body)["reason"] == "ring"
            assert _call(urls["port"] + "/healthz")[0] == 200
        finally:
            b._rebuilding = False
        srvs["port"].state.draining = True
        try:
            code, body, _ = _call(urls["port"] + "/readyz")
            assert code == 503 and json.loads(body)["reason"] == "draining"
        finally:
            srvs["port"].state.draining = False

    @pytest.mark.parametrize("path", ["/v1/swap", "/v1/kv/restore",
                                      "/v1/adapters"])
    def test_unported_routes_answer_400(self, ring_servers, path):
        """Routes of features a server does not carry answer 400 as the
        JAX server's do: /v1/kv/restore (fleet-level KV is not ported)
        and /v1/adapters without a registry.  /v1/swap is served: it
        answers 400 on an unpaged ring (a swap parks the residents
        through the paged spill) and 200 on a paged one, where it bumps
        the generation (tests/test_torch_swap.py has the rest)."""
        srvs, urls = ring_servers
        if path != "/v1/swap":
            code, body, _ = _call(urls["port"] + path, "POST", {})
            assert code == 400 and "error" in json.loads(body)
            return
        ring = srvs["port"].generator
        for paged, want in ((False, 400), (True, 200)):
            kw = dict(RING_KW, paged=paged)
            srv = S.make_server("127.0.0.1", 0, ring.batcher.params,
                                ring.cfg, continuous=True, **kw)
            srv.swap_base = {"params": S.host_state(ring.batcher.params),
                             "weight_quant": "none"}
            threading.Thread(target=srv.serve_forever, daemon=True).start()
            url = f"http://127.0.0.1:{srv.server_address[1]}"
            try:
                code, body, _ = _call(url + path, "POST", {})
                assert code == want, body
                if paged:
                    assert json.loads(body)["generation"] == 1
                    code, body, _ = _call(url + "/statusz")
                    assert json.loads(body)["weightGeneration"] == 1
                else:
                    assert "paged" in json.loads(body)["error"]
            finally:
                srv.shutdown()
                srv.server_close()
                srv.generator.close()


def _wait_for(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.02)


def test_router_fronts_a_port_replica_restored_from_a_checkpoint(
        ring_servers, tmp_path, monkeypatch):
    """The unchanged router (paddle_operator_tpu/router/router.py
    ``FleetRouter`` + ``make_router_server``) in front of one port
    replica — the continuous paged ring, booted as ``main()`` boots it,
    from a checkpoint of the JAX replica's params saved by the port:
    routed requests get the JAX replica's tokens, the scrape reads the
    replica's gauges, and a drain ends in exit 83 with the router
    taking the replica out of rotation."""
    from paddle_operator_tpu.router.router import (FleetRouter,
                                                   make_router_server)
    from paddle_operator_tpu_torch.ft.preemption import EXIT_PREEMPTED
    from paddle_operator_tpu_torch.infer.resilience import ServingDrain
    from paddle_operator_tpu_torch.train import trainer as TT
    from paddle_operator_tpu_torch.train.checkpoint import CheckpointManager

    monkeypatch.setenv("TPUJOB_FLIGHTREC_DIR", str(tmp_path))
    jmodel, _ = jax_make_model("tiny", dtype=jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, 8), jnp.int32))["params"]
    model, cfg = make_model("tiny", device="cpu", seed=5,
                            dtype=torch.float32)
    model.load_state_dict(params_from_jax(jax.device_get(jparams)))
    ckpt = CheckpointManager(str(tmp_path / "ckpt"))
    ckpt.save(0, TT.create_state(model, TT.make_optimizer()), force=True)
    ckpt.close()
    params, scfg, resumed = S.load_serving_params(str(tmp_path / "ckpt"),
                                                  cfg, device="cpu")
    assert resumed
    replica = S.make_server("127.0.0.1", 0, params, scfg, continuous=True,
                            job="j", replica="r0", **RING_KW)
    threading.Thread(target=replica.serve_forever, daemon=True).start()
    ep = f"127.0.0.1:{replica.server_address[1]}"
    router = FleetRouter([ep], block_size=RING_KW["block_size"],
                         scrape_interval=0.05)
    rsrv = make_router_server("127.0.0.1", 0, router)
    threading.Thread(target=rsrv.serve_forever, daemon=True).start()
    rurl = f"http://127.0.0.1:{rsrv.server_address[1]}"
    _, urls = ring_servers
    codes = []
    try:
        _wait_for(lambda: router.replicas[ep].ready)
        for body in ({"tokens": [[1, 2, 3, 4, 5, 6, 7, 8, 9]],
                      "max_new_tokens": 7},
                     {"tokens": [[200, 3, 3, 9, 1] * 3],
                      "max_new_tokens": 5, "request_id": "routed"}):
            rc, rb, rh = _call(rurl + "/v1/generate", "POST", body)
            jc, jb, _ = _call(urls["jax"] + "/v1/generate", "POST", body)
            assert rc == jc == 200, (rb, jb)
            assert rh.get("X-Router-Replica") == ep
            assert json.loads(rb)["tokens"] == json.loads(jb)["tokens"]
        _wait_for(lambda: router.replicas[ep].gauges.get(
            "tokensPerSec", 0) > 0)
        gauges = router.replicas[ep].gauges
        assert {"queueDepth", "kvBlocksFree", "tokensPerSec"} <= set(gauges)
        assert gauges["kvBlocksFree"] > 0
        ServingDrain(replica, replica.state,
                     batcher=replica.generator.batcher, budget_s=5.0,
                     handler_grace_s=0.0, exit_fn=codes.append).run("test")
        assert codes == [EXIT_PREEMPTED] == [83]
        _wait_for(lambda: not router.replicas[ep].ready)
        assert _call(rurl + "/v1/generate", "POST",
                     {"tokens": [[1, 2, 3]], "max_new_tokens": 2})[0] == 503
    finally:
        rsrv.shutdown()
        rsrv.server_close()
        router.close()
        replica.shutdown()
        replica.server_close()
        replica.generator.close()


REFUSED_KNOBS = [
    # speculative decoding is served (tests/test_torch_spec_ring.py), and
    # so is span tracing (tests/test_torch_tracing.py); beside a knob
    # still refused, that knob is named and they are not
    pytest.param({"SERVE_SPEC_K": "2", "SERVE_TRACE": "1",
                  "SERVE_KV_BROKER": "127.0.0.1:9100"},
                 id="SERVE_SPEC_K=2-SERVE_TRACE=1"),
    # chunked prefill is served (tests/test_torch_chunked_prefill.py),
    # and so is the NaN-lane check (tests/test_torch_resilience.py)
    pytest.param({"SERVE_PREFILL": "chunked", "SERVE_NAN_CHECK": "1",
                  "SERVE_KV_MIGRATE": "1"},
                 id="SERVE_PREFILL=chunked"),
    # disaggregated prefill is served (tests/test_torch_disagg.py); beside
    # a knob still refused, that knob is named and SERVE_PREFILL is not
    pytest.param({"SERVE_PREFILL": "disagg", "SERVE_PREFILL_LANES": "4",
                  "SERVE_KV_MIGRATE": "1"},
                 id="SERVE_PREFILL=disagg"),
    # the megastep is served (tests/test_torch_megastep.py), and so is
    # fault injection (tests/test_torch_resilience.py)
    pytest.param({"SERVE_MEGASTEP": "4",
                  "TPUJOB_CHAOS": "dispatch_hang@3:0.25",
                  "SERVE_KV_PEER_FETCH": "1"},
                 id="SERVE_MEGASTEP=4"),
    # adapters are served (tests/test_torch_adapters.py); beside a knob
    # still refused, that knob is named and SERVE_ADAPTERS is not
    pytest.param({"SERVE_ADAPTERS": "acme", "SERVE_TRACE": "1",
                  "SERVE_TP": "2"},
                 id="SERVE_ADAPTERS=acme"),
    # the ring operations are served: each beside a knob still refused
    pytest.param({"SERVE_TRACE": "1", "SERVE_KV_MIGRATE": "1"},
                 id="SERVE_TRACE=1"),
    pytest.param({"SERVE_NAN_CHECK": "1", "SERVE_PREFILL": "disagg",
                  "SERVE_KV_BROKER": "127.0.0.1:9100"},
                 id="SERVE_NAN_CHECK=1"),
    pytest.param({"TPUJOB_CHAOS": "dispatch_hang@3:0.25",
                  "SERVE_KV_BROKER": "127.0.0.1:9100"},
                 id="TPUJOB_CHAOS=dispatch_hang@3:0.25"),
    {"SERVE_KV_MIGRATE": "1"},
    {"SERVE_KV_PEER_FETCH": "1"},
    {"SERVE_KV_BROKER": "127.0.0.1:9100"}, {"SERVE_TP": "2"},
    # the weight-quant knobs are served (tests/test_torch_weight_quant.py);
    # beside a knob still refused, that knob is named and they are not
    {"QUANTIZE": "int8", "SERVE_KV_PEER_FETCH": "1"},
    pytest.param({"SERVE_WEIGHT_QUANT": "int8", "SERVE_ADAPTERS": "acme",
                  "SERVE_KV_MIGRATE": "1"},
                 id="SERVE_WEIGHT_QUANT=int8-SERVE_ADAPTERS=acme"),
]
SERVED_KNOBS = ("SERVE_MEGASTEP", "QUANTIZE", "SERVE_WEIGHT_QUANT",
                "SERVE_SPEC_K", "SERVE_ADAPTERS", "SERVE_TRACE",
                "SERVE_NAN_CHECK", "TPUJOB_CHAOS", "SERVE_PREFILL_LANES")
# knobs served at the values listed (every SERVE_PREFILL mode is served)
SERVED_SETTINGS = {"SERVE_PREFILL": ("chunked", "disagg")}


@pytest.mark.parametrize("env", REFUSED_KNOBS,
                         ids=lambda e: "-".join(f"{k}={v}"
                                                for k, v in e.items()))
def test_refuse_unported_names_the_knob(env):
    environ = {"SERVE_CONTINUOUS": "1", "SERVE_PAGED": "1", **env}
    knob, value = list(env.items())[-1]      # the refused knob
    with pytest.raises(ValueError, match=knob):
        S.refuse_unported(environ)
    said = str(pytest.raises(ValueError, S.refuse_unported,
                             environ).value)
    assert value in said
    served = [k for k, v in env.items() if v in SERVED_SETTINGS.get(k, ())]
    assert all(k in said for k in env
               if k not in SERVED_KNOBS and k not in served)
    assert not any(k in said for k in SERVED_KNOBS)
    assert not any(k in said for k in served)


# the host tier and the durable store are served
# (tests/test_torch_hostcache.py, tests/test_torch_kvstore.py): each knob
# passes refuse_unported and parses as the JAX entry point parses it
SERVED_TIER_KNOBS = [
    {"SERVE_HOST_CACHE_BLOCKS": "4"}, {"SERVE_HOST_CACHE_MB": "8"},
    {"SERVE_HOST_CACHE_MB": "8", "SERVE_KV_STORE": "dir:/tmp/kvs"},
    {"SERVE_KV_QUANT": "int8", "SERVE_HOST_CACHE_MB": "8"},
]


@pytest.mark.parametrize("env", SERVED_TIER_KNOBS,
                         ids=lambda e: "-".join(f"{k}={v}"
                                                for k, v in e.items()))
def test_host_tier_knobs_served_as_jax_sizes_them(env):
    from paddle_operator_tpu.infer.paged import (
        host_block_bytes as jax_bytes,
    )
    from paddle_operator_tpu.models.llama import CONFIGS as JAX_CONFIGS

    from paddle_operator_tpu_torch.models.llama import CONFIGS

    environ = {"SERVE_CONTINUOUS": "1", "SERVE_PAGED": "1",
               "SERVE_BLOCK_SIZE": "8", **env}
    S.refuse_unported(environ)
    kw = S.ring_kw_from_env(environ, CONFIGS["tiny"])
    want = int(env.get("SERVE_HOST_CACHE_BLOCKS", 0)) or int(
        float(env["SERVE_HOST_CACHE_MB"]) * 1e6 // jax_bytes(
            JAX_CONFIGS["tiny"], 8, env.get("SERVE_KV_QUANT", "none")))
    assert kw["host_cache_blocks"] == want > 0


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_operator_replica_with_tier_and_store_boots(tmp_path, kv_quant):
    """The env the operator renders for a replica of ``spec.serving``
    with ``hostCacheMb`` and ``kvStore`` (TTL and budget too) passes
    refuse_unported and builds a ring with the host tier and the store
    attached; with fleet-level KV on, SERVE_KV_BROKER is still refused
    by name."""
    from paddle_operator_tpu.api import ServingSpec, TPUJob, TPUJobSpec
    from paddle_operator_tpu.controller.builders import construct_serve_pod

    tmpl = {"spec": {"containers": [{"name": "m", "image": "x",
                                     "env": [{"name": "SERVE_KV_QUANT",
                                              "value": kv_quant}]}]}}
    sv = ServingSpec(replicas=1, template=tmpl, block_size=8,
                     host_cache_mb=1, kv_store=f"dir:{tmp_path}/kvs",
                     kv_store_ttl_s=60.0, kv_store_budget_mb=64)
    pod = construct_serve_pod(TPUJob(name="tj", namespace="default",
                                     spec=TPUJobSpec(serving=sv)), 0)
    env = {e["name"]: e["value"] for e in
           pod["spec"]["containers"][0]["env"] if "value" in e}
    assert env["SERVE_HOST_CACHE_MB"] == "1"
    assert env["SERVE_KV_STORE"] == f"dir:{tmp_path}/kvs"
    S.refuse_unported(env)
    model, cfg = make_model("tiny", device="cpu")
    kw = S.ring_kw_from_env(dict(env, SERVE_PREWARM="0",
                                 SERVE_SLOTS="2", SERVE_MAX_LEN="64"), cfg)
    assert kw["host_cache_blocks"] > 0 and kw["paged"]
    srv = S.make_server("127.0.0.1", 0, model, cfg, continuous=True, **kw)
    b = srv.generator.batcher
    try:
        S.wire_kv_store_from_env(b, env)
        assert b.pool.host is not None and b.kv_store is not None
        assert b.pool.store is b.kv_store
        assert (b.kv_store.ttl_s, b.kv_store.budget_mb) == (60.0, 64)
        assert b.kv_store.fingerprint == b._fingerprint()
        assert b.kv_quant == kv_quant
        st = b.serving_status()
        assert st["hostCacheBlocks"] == 0 and st["kvStoreBlocks"] == 0
    finally:
        srv.server_close()
        srv.generator.close()
        b.kv_store.close()
    sv.kv_migration = True
    pod = construct_serve_pod(TPUJob(name="tj", namespace="default",
                                     spec=TPUJobSpec(serving=sv)), 0)
    env = {e["name"]: e["value"] for e in
           pod["spec"]["containers"][0]["env"] if "value" in e}
    with pytest.raises(ValueError, match="SERVE_KV_BROKER") as e:
        S.refuse_unported(env)
    assert "SERVE_KV_STORE" not in str(e.value)
    assert "SERVE_HOST_CACHE" not in str(e.value)


def test_kv_store_ignored_without_the_tier(capsys):
    model, cfg = make_model("tiny", device="cpu")
    srv = S.make_server("127.0.0.1", 0, model, cfg, continuous=True,
                        paged=True, block_size=8, slots=1, max_len=64)
    try:
        S.wire_kv_store_from_env(srv.generator.batcher,
                                 {"SERVE_KV_STORE": "dir:/nonexistent"})
        assert srv.generator.batcher.kv_store is None
        assert "SERVE_KV_STORE ignored" in capsys.readouterr().out
    finally:
        srv.server_close()
        srv.generator.close()


# the preemption knobs are served (tests/test_torch_qos.py): each of them
# passes refuse_unported and parses to the JAX package's QoSConfig
SERVED_PREEMPT_KNOBS = [
    {"SERVE_PREEMPT": "1"}, {"SERVE_PREEMPT_MAX_PER_REQ": "5"},
    {"SERVE_PREEMPT_BUDGET": "9"}, {"SERVE_PREEMPT_WINDOW_S": "2.5"},
]


@pytest.mark.parametrize("env", SERVED_PREEMPT_KNOBS,
                         ids=lambda e: "-".join(f"{k}={v}"
                                                for k, v in e.items()))
def test_preempt_knobs_served_as_jax_parses_them(monkeypatch, env):
    from paddle_operator_tpu.infer.qos import QoSConfig as JaxQoSConfig

    environ = {"SERVE_CONTINUOUS": "1", "SERVE_PAGED": "1", **env}
    S.refuse_unported(environ)
    for k in ("SERVE_PRIORITIES", "SERVE_PREEMPT",
              "SERVE_PREEMPT_MAX_PER_REQ", "SERVE_PREEMPT_BUDGET",
              "SERVE_PREEMPT_WINDOW_S"):
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    got = S.ring_kw_from_env(environ)["qos"]
    assert dataclasses.asdict(got) == \
        dataclasses.asdict(JaxQoSConfig.from_env())


def test_kv_quant_is_accepted_and_implies_paged():
    """SERVE_KV_QUANT=int8 is served (the int8 pool), and like the JAX
    entry point it turns the paged ring on by itself."""
    env = {"SERVE_CONTINUOUS": "1", "SERVE_KV_QUANT": "int8",
           "SERVE_BLOCK_SIZE": "8"}
    S.refuse_unported(env)
    kw = S.ring_kw_from_env(env)
    assert kw["kv_quant"] == "int8" and kw["paged"]
    assert kw["block_size"] == 8 and kw["prefix_cache"]


def test_deployed_env_is_accepted_and_parsed():
    env = {"SERVE_CONTINUOUS": "1", "SERVE_PAGED": "1", "SERVE_SLOTS": "8",
           "SERVE_CHUNK": "8", "SERVE_MAX_QUEUE": "16",
           "SERVE_MAX_LEN": "2048", "SERVE_BLOCK_SIZE": "256",
           "SERVE_NUM_BLOCKS": "65", "SERVE_PREFIX_CACHE": "1",
           "SERVE_PRIORITIES": "3", "SERVE_PREWARM": "0",
           "SERVE_GENERATION": "4", "SERVE_PREEMPT": "0",
           "SERVE_PREFILL": "inline", "SERVE_KV_QUANT": "none",
           "SERVE_WATCHDOG_FLOOR_S": "30", "SERVE_MAX_RESTARTS": "5",
           "SERVE_RESTART_WINDOW_S": "60"}
    S.refuse_unported(env)
    kw = S.ring_kw_from_env(env)
    assert (kw["slots"], kw["chunk_tokens"], kw["max_queue"],
            kw["max_len"], kw["block_size"], kw["num_blocks"]) == \
        (8, 8, 16, 2048, 256, 65)
    assert kw["paged"] and kw["prefix_cache"] and not kw["prewarm"]
    assert kw["generation"] == 4 and kw["qos"].priorities == 3
    assert kw["resilience"].stall_floor_s == 30.0
    assert kw["resilience"].max_restarts == 5
    assert kw["resilience"].restart_window_s == 60.0
