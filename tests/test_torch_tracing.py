"""Span tracing on the torch package's serving ring (SERVE_TRACE): the
trace kit (paddle_operator_tpu_torch/utils/tracing.py) held against the
JAX package's on the same calls — TestTraceKit's cases run on both
modules, and the header, the spans, the export lines and the folded
histograms are byte-equal — and the traced ring: a traced port ring's
streams equal an untraced one's and JAX ``decode.generate``'s, every
response carries a span tree with one root, and the unchanged JAX
router stitches a port replica's spans into one timeline.
"""

import json
import threading
import time
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_operator_tpu.infer import decode as JD
from paddle_operator_tpu.models.llama import make_model as jax_make_model
from paddle_operator_tpu.utils import tracing as JTR
from paddle_operator_tpu_torch.convert import params_from_jax
from paddle_operator_tpu_torch.infer import serve as S
from paddle_operator_tpu_torch.infer.batcher import ContinuousBatcher
from paddle_operator_tpu_torch.models.llama import make_model
from paddle_operator_tpu_torch.utils import tracing as PTR

KITS = [pytest.param(JTR, id="jax"), pytest.param(PTR, id="port")]
MAX_LEN = 64


class TestTraceKit:
    """tests/test_tracing.py TestTraceKit, on both packages' kits."""

    @pytest.mark.parametrize("TR", KITS)
    def test_header_roundtrip(self, TR):
        assert TR.parse_trace_header(None) is None
        assert TR.parse_trace_header("") is None
        assert TR.parse_trace_header("abc") == ("abc", None)
        assert TR.parse_trace_header("abc-def") == ("abc", "def")
        assert TR.format_trace_header("abc") == "abc"
        assert TR.format_trace_header("abc", "def") == "abc-def"
        assert TR.parse_trace_header(TR.format_trace_header("t1", "s1")) \
            == ("t1", "s1")
        assert TR.TRACE_HEADER == "X-Tpujob-Trace"
        assert TR.trace_enabled({"SERVE_TRACE": "1"})
        assert not TR.trace_enabled({})

    @pytest.mark.parametrize("TR", KITS)
    def test_request_trace_spans_and_root(self, TR):
        tr = TR.RequestTrace(trace_id="tid1", parent="up1", pod="p0",
                             request_id="r1")
        t0 = time.monotonic()
        tr.add("queue_wait", t0 - 0.01, t0, prio=1)
        tr.finish()
        wire = tr.to_wire()
        assert wire["traceId"] == "tid1"
        root, span = wire["spans"]
        assert root["name"] == "request" and root["parent"] == "up1"
        assert root["attrs"]["requestId"] == "r1"
        assert span["parent"] == root["id"]
        assert span["attrs"]["prio"] == 1
        assert span["pod"] == "p0"
        assert 5 <= span["dur"] <= 500
        assert abs(span["t0"] - time.time() * 1e3) < 60_000
        assert TR.span_roots(wire["spans"]) == [root]

    @pytest.mark.parametrize("TR", KITS)
    def test_span_cap_bounds_long_generations(self, TR):
        tr = TR.RequestTrace()
        for _ in range(TR.RequestTrace.MAX_SPANS + 50):
            tr.add("decode_dispatch", time.monotonic())
        tr.finish()
        wire = tr.to_wire()
        assert len(wire["spans"]) == TR.RequestTrace.MAX_SPANS == 128
        assert wire["spans"][0]["attrs"]["droppedSpans"] == 51

    @pytest.mark.parametrize("TR", KITS)
    def test_seed_grafts_prior_pod_spans(self, TR):
        origin = TR.RequestTrace(trace_id="t", pod="origin")
        origin.add("ttft", time.monotonic())
        ow = origin.to_wire()
        adopter = TR.RequestTrace(trace_id="t", parent=ow["rootId"],
                                  pod="adopter")
        adopter.seed(ow["spans"])
        adopter.add("adopt", time.monotonic())
        spans = adopter.to_wire()["spans"]
        roots = TR.span_roots(spans)
        assert len(roots) == 1 and roots[0]["id"] == ow["rootId"]
        assert sum(s["name"] == "ttft" for s in spans) == 1

    @pytest.mark.parametrize("TR", KITS)
    def test_finish_idempotent_and_error(self, TR):
        tr = TR.RequestTrace()
        tr.finish(error="Boom")
        d1 = tr.to_wire()["spans"][0]["dur"]
        time.sleep(0.01)
        tr.finish()
        assert tr.to_wire()["spans"][0]["dur"] == d1
        assert tr.to_wire()["spans"][0]["attrs"]["error"] == "Boom"

    @pytest.mark.parametrize("TR", KITS)
    def test_tracer_annotate_and_store(self, TR):
        store = TR.TraceStore(cap=2)
        rid = store.root("t9", request_id="q")["id"]
        tr = TR.Tracer(pod="r7").begin(ctx=("t9", rid), request_id="q")
        tr.annotate(promptLen=5, maxNew=3, prio=1, adapter=None)
        root = tr.to_wire()["spans"][0]
        assert root["attrs"] == {"requestId": "q", "promptLen": 5,
                                 "maxNew": 3, "prio": 1}
        assert root["pod"] == "r7" and root["parent"] == rid
        store.add("t9", tr.to_wire()["spans"])
        roots = TR.span_roots(store.get("t9")["spans"])
        assert len(roots) == 1 and roots[0]["id"] == rid
        for t in ("a", "b"):
            store.root(t)
        assert store.get("t9") is None          # LRU-bounded

    def test_wire_forms_byte_equal(self, tmp_path):
        """The header, a span, the JSONL export, its parse, the folded
        histograms and the flight-recorder dump read back: the same
        bytes from both packages."""
        for t, p in ((JTR.format_trace_header("a", "b"),
                      PTR.format_trace_header("a", "b")),
                     (JTR.parse_trace_header(" t-s "),
                      PTR.parse_trace_header(" t-s "))):
            assert t == p
        kw = dict(span_id="s1", pod="r0", slot=2, mode="inline")
        spans = [JTR.make_span("admit", "root", 1.5e12 + 0.1234, 3.14159,
                               **kw),
                 PTR.make_span("admit", "root", 1.5e12 + 0.1234, 3.14159,
                               **kw)]
        assert json.dumps(spans[0]) == json.dumps(spans[1])
        tl = [{"traceId": "t", "requestId": "q", "spans": [spans[0]]}]
        hists = []
        for TR in (JTR, PTR):
            h = TR.ServeHistograms(clock=lambda: 1000.0)
            for v in (0.5, 3.0, 40.0, 900.0, 1e6):
                h.ttft.observe(v)
                h.queue_wait.observe(v / 2)
            hists.append(h.snapshot())
        assert hists[0] == hists[1]
        exports = [TR.export_jsonl(tl, hists[0], pod="r0")
                   for TR in (JTR, PTR)]
        assert exports[0] == exports[1]
        assert JTR.parse_jsonl_export(exports[0] + "junk\n") == \
            PTR.parse_jsonl_export(exports[1] + "junk\n")
        folds = [TR.fold_latency_hists([hists[0], hists[1]])
                 for TR in (JTR, PTR)]
        assert folds[0] == folds[1]
        assert JTR.hist_p95(folds[0]["ttft"]) == \
            PTR.hist_p95(folds[1]["ttft"])
        fr = PTR.FlightRecorder(pod="p")
        fr.record("nan_quarantine", lane=1)
        path = fr.dump_file("test", path=str(tmp_path / "d.json"))
        assert JTR.read_flightrec_dump(path) == \
            PTR.read_flightrec_dump(path)


def test_profiler_trace_writes_a_chrome_trace(tmp_path):
    """utils/observability.py ``trace``: the JAX package's profiler
    context, as torch.profiler writing a Chrome trace."""
    from paddle_operator_tpu_torch.utils.observability import trace

    with trace(str(tmp_path)) as prof:
        torch.ones(4, 4) @ torch.ones(4, 4)
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1 and prof.key_averages()
    assert "traceEvents" in json.loads(files[0].read_text())


@pytest.fixture(scope="module")
def setup():
    jmodel, jcfg = jax_make_model("tiny", dtype=jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, 8), jnp.int32))["params"]
    model, cfg = make_model("tiny", device="cpu", dtype=torch.float32)
    model.load_state_dict(params_from_jax(jax.device_get(jparams)))

    def ref(prompt, new):
        return np.asarray(JD.generate(
            jparams, jcfg, jnp.asarray([prompt], jnp.int32),
            max_new_tokens=new, max_len=MAX_LEN)[0]).tolist()

    return model, cfg, ref


def _prompts():
    rng = np.random.default_rng(3)
    return [rng.integers(0, 256, n).tolist() for n in (5, 13, 21)]


RINGS = [pytest.param(dict(paged=True, block_size=8), id="paged"),
         pytest.param(dict(paged=False), id="contig"),
         pytest.param(dict(paged=True, block_size=8, kv_quant="int8"),
                      id="int8"),
         pytest.param(dict(paged=True, block_size=8, megastep=4,
                           prefill_mode="chunked", prefill_chunk=8),
                      id="paged-megastep4-chunked")]


class TestTracedRing:
    @pytest.mark.parametrize("kw", RINGS)
    def test_traced_equals_untraced_and_jax(self, setup, kw):
        """Tracing adds host timestamps only: a traced ring's greedy
        streams equal an untraced ring's (bit for bit, the int8 pool
        included) and JAX ``generate``'s on the exact pool; each
        request's spans form one tree under its context."""
        model, cfg, ref = setup
        outs = {}
        for trace in (False, True):
            b = ContinuousBatcher(model, cfg, slots=2, max_len=MAX_LEN,
                                  chunk_tokens=4,
                                  prefill_buckets=(8, 16, 32, MAX_LEN),
                                  trace=trace, **kw)
            try:
                hs = [b.submit(p, max_new_tokens=9, request_id=f"q{i}",
                               trace_ctx=("tid", "up") if i == 0 else None)
                      for i, p in enumerate(_prompts())]
                outs[trace] = [h.result(timeout=120) for h in hs]
                if not trace:
                    assert all(h.trace is None for h in hs)
                    continue
                for i, h in enumerate(hs):
                    wire = h.trace.to_wire()
                    names = [s["name"] for s in wire["spans"]]
                    assert names[0] == "request"
                    assert {"queue_wait", "admit", "ttft",
                            "decode_dispatch"} <= set(names)
                    if kw.get("prefill_mode") == "chunked":
                        assert "prefill_slice" in names
                    roots = PTR.span_roots(wire["spans"])
                    assert len(roots) == 1 and roots[0]["name"] == "request"
                    assert roots[0]["attrs"]["promptLen"] == \
                        len(_prompts()[i])
                    assert roots[0]["dur"] > 0
                assert hs[0].trace.trace_id == "tid"
                assert hs[0].trace.to_wire()["spans"][0]["parent"] == "up"
            finally:
                b.close()
        assert outs[True] == outs[False]
        if kw.get("kv_quant") != "int8":
            assert outs[True] == [ref(p, 9) for p in _prompts()]

    def test_spill_and_restore_spans(self, setup):
        """A preempted lane's tree carries its spill and restore spans
        and its stream equals JAX's."""
        model, cfg, ref = setup
        b = ContinuousBatcher(model, cfg, slots=1, max_len=MAX_LEN,
                              chunk_tokens=4, paged=True, block_size=8,
                              prefill_buckets=(8, 16, 32, MAX_LEN),
                              trace=True)
        orig = b._step

        def paced(*a):
            time.sleep(0.02)
            return orig(*a)

        b._step = paced
        try:
            p, q = _prompts()[1:]
            low = b.submit(p, max_new_tokens=20, priority=1)
            while b.lane[0] is None:
                time.sleep(0.005)
            time.sleep(0.05)
            high = b.submit(q, max_new_tokens=4, priority=0)
            assert high.result(timeout=120) == ref(q, 4)
            assert low.result(timeout=120) == ref(p, 20)
            names = [s["name"] for s in low.trace.to_wire()["spans"]]
            assert "spill" in names and "restore" in names
        finally:
            b.close()


def _post(url, body, headers=None):
    req = urllib.request.Request(url + "/v1/generate",
                                 data=json.dumps(body).encode(),
                                 headers=headers or {}, method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, r.read(), dict(r.headers)


def test_router_stitches_a_port_replica(setup):
    """The unchanged JAX router (``trace=True``) in front of a traced
    port replica: the response carries the replica's span tree, the
    stream's done event too, and ``/debug/tracez`` holds ONE timeline
    for the trace id — one parentless root, the router's proxy span and
    the replica's phase spans — with the JAX replica's tokens."""
    from paddle_operator_tpu.router.router import (FleetRouter,
                                                   make_router_server)

    model, cfg, ref = setup
    replica = S.make_server("127.0.0.1", 0, model, cfg, continuous=True,
                            replica="r0", trace=True, slots=2,
                            chunk_tokens=4, max_len=MAX_LEN,
                            prefill_buckets=(8, 16, 32, MAX_LEN),
                            paged=True, block_size=8)
    threading.Thread(target=replica.serve_forever, daemon=True).start()
    ep = f"127.0.0.1:{replica.server_address[1]}"
    router = FleetRouter([ep], block_size=8, scrape_interval=0.05,
                         trace=True, upstream_timeout=30.0)
    rsrv = make_router_server("127.0.0.1", 0, router)
    threading.Thread(target=rsrv.serve_forever, daemon=True).start()
    rurl = f"http://127.0.0.1:{rsrv.server_address[1]}"
    try:
        for _ in range(500):
            if router.replicas[ep].ready:
                break
            time.sleep(0.01)
        prompt = _prompts()[1]
        tid = PTR.new_id()
        code, body, hdrs = _post(rurl, {"tokens": [prompt],
                                        "max_new_tokens": 6,
                                        "request_id": "rq"},
                                 headers={PTR.TRACE_HEADER: tid})
        out = json.loads(body)
        assert code == 200 and out["tokens"] == [ref(prompt, 6)]
        assert hdrs["X-Router-Replica"] == ep
        assert out["trace"][0]["traceId"] == tid
        with urllib.request.urlopen(f"{rurl}/debug/tracez?trace_id={tid}",
                                    timeout=10) as r:
            spans = json.loads(r.read())["spans"]
        names = [s["name"] for s in spans]
        assert names.count("proxy") == 1
        assert {"queue_wait", "admit", "ttft"} <= set(names)
        roots = JTR.span_roots(spans)
        assert len(roots) == 1 and roots[0]["name"] == "request"
        # the stream's done event carries the tree too
        req = urllib.request.Request(
            f"http://{ep}/v1/generate",
            data=json.dumps({"tokens": [prompt], "max_new_tokens": 6,
                             "stream": True}).encode(),
            headers={PTR.TRACE_HEADER: "abc-def"}, method="POST")
        with urllib.request.urlopen(req, timeout=60) as r:
            done = [json.loads(line) for line in r.read().splitlines()
                    if line.strip()][-1]
        assert done["done"] and done["tokens"] == ref(prompt, 6)
        assert done["trace"]["traceId"] == "abc"
        assert done["trace"]["spans"][0]["parent"] == "def"
    finally:
        rsrv.shutdown()
        rsrv.server_close()
        router.close()
        replica.shutdown()
        replica.server_close()
        replica.generator.close()
