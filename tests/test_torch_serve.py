"""The torch package's batch server (paddle_operator_tpu_torch/infer/
serve.py) held against the JAX batch server over real HTTP: both serve
the same converted ``tiny`` params on CPU, and the same requests get
the same tokens, status codes and bodies.  Also the entry point's
refusals, the drain contract and the jax-free helper copies.
"""

import json
import threading
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


class TestEntryPoint:
    @pytest.mark.parametrize("env", [
        {"SERVE_CONTINUOUS": "1"}, {"SERVE_TP": "2"},
        {"QUANTIZE": "int8"}, {"SERVE_WEIGHT_QUANT": "int8"},
        {"TPUJOB_CHECKPOINT_PATH": "/ckpt"},
    ])
    def test_unported_knobs_refused(self, monkeypatch, env):
        for k in ("SERVE_CONTINUOUS", "SERVE_TP", "QUANTIZE",
                  "SERVE_WEIGHT_QUANT", "TPUJOB_CHECKPOINT_PATH"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        with pytest.raises(ValueError, match="not ported"):
            S.main()

    def test_no_card_no_cpu_serving(self, monkeypatch):
        if torch.cuda.is_available():
            pytest.skip("a card is present: main() would serve")
        for k in ("SERVE_CONTINUOUS", "SERVE_TP", "QUANTIZE",
                  "SERVE_WEIGHT_QUANT", "TPUJOB_CHECKPOINT_PATH"):
            monkeypatch.delenv(k, raising=False)
        with pytest.raises(RuntimeError, match="CUDA"):
            S.main()

    def test_continuous_server_refused(self):
        model, cfg = make_model("tiny", device="cpu")
        with pytest.raises(NotImplementedError):
            S.make_server("127.0.0.1", 0, model, cfg, continuous=True)

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
