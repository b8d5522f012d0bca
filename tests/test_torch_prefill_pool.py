"""The torch package's prefill pool (``infer/prefill_serve.py``: the pod's
``PrefillFrontend``, its HTTP shell and ``python -m`` entry, and the
decode side's ``RemotePrefillClient``) held against the JAX package's
(after tests/test_xdisagg.py and tests/test_prefillpool.py), on the JAX
package's ``tiny`` params converted in float32:

- a port prefill server serving a port decode replica: greedy streams
  equal ``generate`` (bf16 pool) and the in-process engine's (int8
  pool), 1 and 4 engine lanes, whole envelopes and streamed frames;
- the client's discipline against canned pods: failover past a
  draining pod, exhausted attempts posted as a retriable error, a
  deterministic rejection failing one request, a corrupt envelope
  refused, a resolved request never POSTed, a mid-stream death retried
  exactly once, a corrupt frame refused wholesale;
- the pod: 409 on a fingerprint skew, a prefill timeout mapped to a
  retriable 503, a drain that refuses new work and finishes the work in
  flight, the queue depth settled exactly once after a timeout, the
  role-aware ``/statusz`` and ``/metrics``; the N-lane engine's
  head-of-line order;
- the fleet: the unchanged JAX router forwards ``/v1/prefill`` to a port
  pod (``forward_prefill`` and a port replica behind it as broker); a
  JAX decode replica on a port pod and a port replica on a JAX pod give
  ``generate``'s greedy tokens; a remote ring admits an adapter prompt
  inline;
- the entry: ``python -m paddle_operator_tpu_torch.infer.prefill_serve
  --device cpu`` boots, serves a handoff and drains to exit 83 on
  SIGTERM.

Token streams are compared exactly (f32, greedy)."""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_operator_tpu.infer import decode as JD
from paddle_operator_tpu.infer import prefill_serve as JPS
from paddle_operator_tpu.infer.batcher import ContinuousBatcher as JaxBatcher
from paddle_operator_tpu.models.llama import make_model as jax_make_model
from paddle_operator_tpu.router.router import FleetRouter, make_router_server
from paddle_operator_tpu_torch.convert import params_from_jax
from paddle_operator_tpu_torch.infer import prefill_serve as PS
from paddle_operator_tpu_torch.infer import qos as TQ
from paddle_operator_tpu_torch.infer.batcher import ContinuousBatcher
from paddle_operator_tpu_torch.infer.resilience import RetriableError
from paddle_operator_tpu_torch.models.llama import make_model
from paddle_operator_tpu_torch.utils import fleetkv as FK

MAX_LEN = 64
BS = 8
NEW = 6
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def setup():
    jmodel, jcfg = jax_make_model("tiny", dtype=jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, 8), jnp.int32))["params"]
    model, cfg = make_model("tiny", device="cpu", dtype=torch.float32)
    model.load_state_dict(params_from_jax(jax.device_get(jparams)))
    model.requires_grad_(False)
    refs = {}

    def ref(prompt, new=NEW):
        key = (tuple(prompt), new)
        if key not in refs:
            refs[key] = np.asarray(JD.generate(
                jparams, jcfg, jnp.asarray([prompt], jnp.int32),
                max_new_tokens=new, max_len=MAX_LEN)[0]).tolist()
        return refs[key]

    return {"jparams": jparams, "jcfg": jcfg, "model": model, "cfg": cfg,
            "ref": ref}


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n).astype(
        np.int32).tolist()


PROMPTS = [_prompt(n, 50 + i) for i, n in enumerate((5, 19, 30, 12))]


def _ring_kw(**kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("chunk_tokens", 4)
    kw.setdefault("prefill_buckets", (16, MAX_LEN))
    kw.setdefault("paged", True)
    kw.setdefault("block_size", BS)
    kw.setdefault("prefill_mode", "disagg")
    kw.setdefault("prefill_chunk", 8)
    return kw


def _run(b, prompts=PROMPTS, new=NEW):
    return [h.result(timeout=120) for h in [
        b.submit(p, max_new_tokens=new) for p in prompts]]


def _serve(srv):
    threading.Thread(target=lambda: srv.serve_forever(poll_interval=0.02),
                     daemon=True).start()
    return f"127.0.0.1:{srv.server_address[1]}"


def _stop(srv):
    srv.shutdown()
    srv.server_close()
    fe = getattr(srv, "frontend", None)
    if fe is not None:
        fe.close()


def _pod(st, **kw):
    kw.setdefault("block_size", BS)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("prefill_chunk", 8)
    srv = PS.make_prefill_server("127.0.0.1", 0, st["model"], st["cfg"],
                                 **kw)
    return srv, _serve(srv)


def _get(ep, path):
    try:
        with urllib.request.urlopen(f"http://{ep}{path}", timeout=10) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


def _post(ep, body, timeout=60):
    req = urllib.request.Request(
        f"http://{ep}/v1/prefill", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read(), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, e.read(), dict(e.headers)


# ---------------------------------------------------------------------------
# a port pod serving a port replica
# ---------------------------------------------------------------------------


class TestRemoteRing:
    @pytest.mark.parametrize("kv_quant,lanes,stream", [
        ("none", 1, False), ("none", 4, True), ("int8", 1, True),
        ("int8", 4, False)])
    def test_remote_equals_in_process(self, setup, kv_quant, lanes, stream):
        """Every cold prompt prefills on the pod; the streams equal the
        in-process engine's with the same lanes (and, bf16,
        ``generate``); streamed frames land; the pool invariant holds."""
        st = setup
        srv, ep = _pod(st, kv_quant=kv_quant, lanes=lanes, prefix_blocks=16)
        client = PS.RemotePrefillClient(peers=[ep], stream=stream)
        b = ContinuousBatcher(st["model"], st["cfg"], **_ring_kw(
            kv_quant=kv_quant, prefill_client=client))
        try:
            got = _run(b)
            assert b.stats["remote_prefills"] == len(PROMPTS)
            assert bool(b.stats["handoff_frames"]) == (stream and lanes > 1)
            b.pool.check_invariant()
            stz = b.serving_status()
            assert stz["remotePrefills"] == len(PROMPTS)
            assert stz["prefillLanes"] == 0         # the pods export theirs
        finally:
            b.close()
            _stop(srv)
        local = ContinuousBatcher(st["model"], st["cfg"], **_ring_kw(
            kv_quant=kv_quant, prefill_lanes=lanes))
        try:
            assert got == _run(local)
        finally:
            local.close()
        if kv_quant == "none":
            assert got == [st["ref"](p) for p in PROMPTS]

    def test_adapter_prompt_admits_inline_on_a_remote_ring(self, setup):
        """The pods serve the base model: an adapter prompt on a remote
        ring prefills inline on the ring (never POSTed), its stream the
        inline ring's; a base prompt goes remote."""
        st = setup
        srv, ep = _pod(st)
        reg = TQ.AdapterRegistry(st["cfg"], capacity=1, rank=4, device="cpu")
        reg.load("x", seed=7)
        client = PS.RemotePrefillClient(peers=[ep])
        b = ContinuousBatcher(st["model"], st["cfg"], adapters=reg,
                              **_ring_kw(prefill_client=client))
        inline = ContinuousBatcher(st["model"], st["cfg"], adapters=reg,
                                   **_ring_kw(prefill_mode="inline"))
        try:
            got = b.submit(PROMPTS[1], max_new_tokens=NEW,
                           adapter="x").result(timeout=60)
            assert b.stats["remote_prefills"] == 0
            assert srv.frontend.stats["jobs"] == 0
            assert got == inline.submit(PROMPTS[1], max_new_tokens=NEW,
                                        adapter="x").result(timeout=60)
            assert b.submit(PROMPTS[0], max_new_tokens=NEW).result(
                timeout=60) == st["ref"](PROMPTS[0])
            assert b.stats["remote_prefills"] == 1
        finally:
            b.close()
            inline.close()
            _stop(srv)


# ---------------------------------------------------------------------------
# the client against canned pods
# ---------------------------------------------------------------------------


def _mk_handoff(fp=None):
    rng = np.random.default_rng(0)
    arrays = {k: rng.standard_normal((2, 2, 2, 4, 8)).astype(np.float32)
              for k in ("k", "v")}
    return {"first": 7, "promptLen": 6, "nBlocks": 2,
            "fingerprint": fp or {"layers": 2, "blockSize": 4}}, arrays


def _mk_frames(fp):
    rng = np.random.default_rng(3)

    def blk(n):
        return {k: rng.standard_normal((2, n, 2, 4, 8)).astype(np.float32)
                for k in ("k", "v")}

    return [FK.encode_handoff_frame(0, 0, blk(1)),
            FK.encode_handoff_frame(1, 1, blk(1)),
            FK.encode_handoff_final(
                {"seq": 2, "nFrames": 3, "j0": 2, "first": 11,
                 "promptLen": 13, "nBlocks": 4, "fingerprint": fp,
                 "tDone": 1.0}, blk(2))]


class _Stub(BaseHTTPRequestHandler):
    """A canned pod: 'ok' answers a valid envelope, 'draining' 503s,
    'reject' 500s, 'garbage' sends bytes no envelope check passes;
    'stream_ok' a valid frame stream, 'die_mid' one frame then half a
    frame, 'corrupt' a stream with a byte flipped in frame 1."""

    mode = "ok"
    hits = None
    protocol_version = "HTTP/1.1"

    def log_message(self, *a):
        pass

    def do_POST(self):
        body = json.loads(self.rfile.read(int(self.headers.get(
            "Content-Length", 0))) or b"{}")
        self.hits.append(body)
        mode = self.mode
        if mode in ("stream_ok", "die_mid", "corrupt"):
            wires = _mk_frames(body.get("fingerprint"))
            self.send_response(200)
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def emit(raw):
                self.wfile.write(f"{len(raw):x}\r\n".encode() + raw
                                 + b"\r\n")
                self.wfile.flush()

            if mode == "die_mid":
                emit(wires[0])
                emit(wires[1][:9])
                self.connection.close()
                return
            if mode == "corrupt":
                bad = bytearray(wires[1])
                bad[-3] ^= 0xFF
                wires[1] = bytes(bad)
            for w in wires:
                emit(w)
            self.wfile.write(b"0\r\n\r\n")
            return
        if mode == "draining":
            raw = json.dumps({"error": "draining"}).encode()
            self.send_response(503)
        elif mode == "reject":
            raw = json.dumps({"error": "bucket overflow"}).encode()
            self.send_response(500)
        elif mode == "garbage":
            raw = b"TPKVgarbage-not-an-envelope"
            self.send_response(200)
        else:
            raw = FK.encode_handoff(*_mk_handoff(body.get("fingerprint")))
            self.send_response(200)
        self.send_header("Content-Length", str(len(raw)))
        self.end_headers()
        self.wfile.write(raw)


@pytest.fixture()
def stub():
    made = []

    def make(mode):
        hits = []
        srv = ThreadingHTTPServer(("127.0.0.1", 0), type(
            "H", (_Stub,), {"mode": mode, "hits": hits}))
        made.append(srv)
        return _serve(srv), hits

    yield make
    for srv in made:
        _stop(srv)


class _Req:
    def __init__(self, prompt=(1, 2, 3)):
        self.prompt = list(prompt)
        self.temperature = 0.0
        self.seed = 0
        self.request_id = "r0"
        self.done = threading.Event()
        self._cancel = False


def _items(client, until, timeout=20.0):
    out = []
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            item = client.results.get(timeout=0.1)
        except Exception:
            continue
        out.append(item)
        if until(item):
            return out
    raise AssertionError(f"no terminal item in {timeout}s: {out}")


class TestClient:
    def test_failover_past_draining_pod(self, stub):
        d_ep, d_hits = stub("draining")
        o_ep, o_hits = stub("ok")
        client = PS.RemotePrefillClient(peers=[d_ep, o_ep], backoff_s=0.01)
        client.fingerprint = {"layers": 2, "blockSize": 4}
        try:
            client.submit(_Req(), 0)
            (item,) = _items(client, lambda i: True)
            kind, _, slot, arrays, lane, j0, n_blocks, first, _ = item
            assert (kind, lane, j0) == ("final", None, 0)
            assert (slot, n_blocks, first) == (0, 2, 7)
            assert arrays["k"].shape[1] == 2
            assert len(d_hits) == 1 and len(o_hits) == 1
            assert o_hits[0]["tokens"] == [1, 2, 3]
            assert o_hits[0]["fingerprint"] == client.fingerprint
            assert client.stats["retries"] == 1
        finally:
            client.close()

    @pytest.mark.parametrize("mode,attempts,err,hits", [
        ("draining", 2, RetriableError, 2),
        ("reject", 4, RuntimeError, 1),
        ("garbage", 1, FK.EnvelopeError, 1)])
    def test_failures_post_one_error(self, stub, mode, attempts, err, hits):
        """Exhausted attempts post a RETRIABLE error; a deterministic
        rejection fails the one request without a retry storm; a corrupt
        envelope is refused."""
        ep, got_hits = stub(mode)
        client = PS.RemotePrefillClient(peers=[ep], max_attempts=attempts,
                                        backoff_s=0.01)
        try:
            client.submit(_Req(), 1)
            (item,) = _items(client, lambda i: True)
            assert len(item) == 3 and isinstance(item[2], err)
            assert mode != "reject" or "bucket overflow" in str(item[2])
            assert len(got_hits) == hits
        finally:
            client.close()

    def test_unexpected_failure_fails_one_request(self, stub):
        """A failure no wire rule names (here: the payload's host
        pinning) fails its one request; the worker lives on and serves
        the next."""
        ep, hits = stub("ok")
        client = PS.RemotePrefillClient(peers=[ep], workers=1)
        real = client._host
        calls = []

        def host(arrays):
            calls.append(1)
            if len(calls) == 1:
                raise RuntimeError("pinned allocation failed")
            return real(arrays)

        client._host = host
        try:
            client.submit(_Req(), 0)
            (item,) = _items(client, lambda i: True)
            assert len(item) == 3 and "pinned" in str(item[2])
            client.submit(_Req(), 1)
            (item,) = _items(client, lambda i: True)
            assert item[0] == "final" and item[2] == 1
            assert all(t.is_alive() for t in client._threads)
        finally:
            client.close()

    def test_resolved_request_never_posts(self, stub):
        ep, hits = stub("ok")
        client = PS.RemotePrefillClient(peers=[ep])
        try:
            req = _Req()
            req.done.set()
            client.submit(req, 0)
            time.sleep(0.3)
            assert hits == [] and client.results.empty()
        finally:
            client.close()

    def test_mid_stream_death_retries_exactly_once(self, stub):
        """A pod dying mid-frame: the partial stream is refused
        wholesale, the retry lands the whole stream on a healthy pod,
        and exactly one terminal item posts."""
        d_ep, d_hits = stub("die_mid")
        o_ep, o_hits = stub("stream_ok")
        client = PS.RemotePrefillClient(peers=[d_ep, o_ep], backoff_s=0.01,
                                        stream=True)
        client.fingerprint = {"layers": 2, "blockSize": 4}
        try:
            client.submit(_Req(), 0)
            items = _items(client, lambda i: i[0] == "final")
            _, req, slot, arrays, lane, j0, n_blocks, first, _ = items[-1]
            assert (slot, j0, n_blocks, first) == (0, 2, 4, 11)
            assert client.stats["refused_streams"] == 1
            assert len(d_hits) == 1 and len(o_hits) == 1
            time.sleep(0.3)
            while not client.results.empty():
                assert client.results.get_nowait()[0] != "final"
        finally:
            client.close()

    def test_corrupt_frame_refused_wholesale_then_retriable(self, stub):
        ep, hits = stub("corrupt")
        client = PS.RemotePrefillClient(peers=[ep], max_attempts=2,
                                        backoff_s=0.01, stream=True)
        client.fingerprint = {"layers": 2, "blockSize": 4}
        try:
            client.submit(_Req(), 1)
            items = _items(client, lambda i: len(i) == 3)
            assert isinstance(items[-1][2], RetriableError)
            assert all(i[0] == "frame" for i in items[:-1])
            assert client.stats["refused_streams"] == 2 and len(hits) == 2
        finally:
            client.close()


# ---------------------------------------------------------------------------
# the pod
# ---------------------------------------------------------------------------


class TestPod:
    def test_fingerprint_skew_409_and_status_surface(self, setup):
        """A POST whose fingerprint disagrees (another generation) is
        refused with 409 before any work; /healthz, /readyz, the
        role-aware /statusz (the JAX pod's keys), /metrics and
        /debug/flightrec answer."""
        st = setup
        srv, ep = _pod(st, lanes=2, generation=3)
        jsrv = JPS.make_prefill_server(
            "127.0.0.1", 0, st["jparams"], st["jcfg"], block_size=BS,
            max_len=MAX_LEN, buckets=(16, MAX_LEN), lanes=2, generation=3)
        jep = _serve(jsrv)
        try:
            fp = srv.frontend.fingerprint()
            assert fp == jsrv.frontend.fingerprint()
            code, raw, _ = _post(ep, {"tokens": [1, 2, 3],
                                      "fingerprint": dict(fp, gen=2)})
            assert code == 409 and "fingerprint" in json.loads(raw)["error"]
            assert srv.frontend.stats["jobs"] == 0
            code, raw, _ = _post(ep, {"tokens": PROMPTS[2],
                                      "fingerprint": fp})
            assert code == 200
            meta, _ = FK.decode_handoff(raw)
            assert meta["nBlocks"] == 4 and meta["promptLen"] == 30
            assert _get(ep, "/healthz")[0] == 200
            assert _get(ep, "/readyz")[0] == 200
            code, raw, _ = _get(ep, "/statusz")
            stz = json.loads(raw)
            jstz = json.loads(_get(jep, "/statusz")[1])
            assert set(stz) == set(jstz) and stz["role"] == "prefill"
            assert stz["prefillJobs"] == 1 and stz["prefillLanes"] == 2
            metrics = _get(ep, "/metrics")[1].decode()
            jmetrics = _get(jep, "/metrics")[1].decode()
            assert [ln.split("{")[0] for ln in metrics.splitlines()] == [
                ln.split("{")[0] for ln in jmetrics.splitlines()]
            assert 'mode="remote"' in metrics
            assert "events" in json.loads(_get(ep, "/debug/flightrec")[1])
        finally:
            _stop(srv)
            _stop(jsrv)

    def test_prefill_timeout_maps_to_retriable_503(self):
        """A backlogged pod's TimeoutError is overload: 503 with a
        Retry-After, never 500."""

        class _Backlogged:
            draining = False
            stats = {"refused": 0}
            _lock = threading.Lock()

            def fingerprint(self):
                return {"layers": 2}

            def prefill(self, tokens, temperature, seed):
                raise TimeoutError("prefill did not finish within 0s")

        srv = ThreadingHTTPServer(("127.0.0.1", 0), type(
            "H", (PS._PrefillHandler,), {"frontend": _Backlogged()}))
        ep = _serve(srv)
        try:
            code, _, headers = _post(ep, {"tokens": [1, 2, 3]})
            assert code == 503 and headers.get("Retry-After")
        finally:
            _stop(srv)

    def test_drain_refuses_new_finishes_in_flight(self, setup):
        st = setup
        srv, ep = _pod(st)
        gate = threading.Event()
        srv.frontend.exec.pause_gate = lambda: gate.wait(30)
        try:
            fp = srv.frontend.fingerprint()
            results = {}

            def post(tag):
                results[tag] = _post(ep, {"tokens": PROMPTS[1],
                                          "fingerprint": fp})

            t = threading.Thread(target=post, args=("inflight",))
            t.start()
            deadline = time.monotonic() + 30
            while srv.frontend.depth() == 0:
                assert time.monotonic() < deadline
                time.sleep(0.002)
            srv.frontend.draining = True
            post("late")
            assert _get(ep, "/readyz")[0] == 503
            gate.set()
            t.join(timeout=60)
            assert results["late"][0] == 503
            code, raw, _ = results["inflight"]
            assert code == 200
            FK.decode_handoff(raw)
            stz = json.loads(_get(ep, "/statusz")[1])
            assert stz["draining"] is True and stz["refusedHandoffs"] == 1
        finally:
            gate.set()
            _stop(srv)

    def test_queued_timeout_settles_depth_exactly_once(self, setup):
        st = setup
        fe = PS.PrefillFrontend(st["model"], st["cfg"], block_size=BS,
                                max_len=MAX_LEN, buckets=(16, MAX_LEN))
        try:
            with pytest.raises(TimeoutError):
                fe.prefill(PROMPTS[1], 0.0, 0, timeout=0.0)
            assert fe.depth() == 0
            FK.decode_handoff(fe.prefill(PROMPTS[1], 0.0, 0))
            time.sleep(0.2)
            assert fe.depth() == 0
            assert not fe.exec._held        # every lane released
        finally:
            fe.close()

    @pytest.mark.parametrize("lanes", [1, 2])
    def test_results_are_copies_when_the_lane_is_released(self, setup,
                                                           lanes):
        """The matcher releases a lane once its host bytes are made: they
        must be copies — on the CPU ``.cpu()`` of a CPU tensor is the
        tensor itself, a view the next job in the lane would overwrite
        before the handler encodes it.  A job's result read after the
        next job ran in the same lane equals the result of a pod that ran
        it alone."""
        st = setup
        kw = dict(block_size=BS, max_len=MAX_LEN, buckets=(16, MAX_LEN),
                  kv_quant="int8", lanes=lanes, prefill_chunk=8)

        def run(fe, prompt):
            job = fe._submit(prompt, 0.0, 0)
            assert job.done.wait(60) and job.error is None
            return job.result[0]

        fe = PS.PrefillFrontend(st["model"], st["cfg"], **kw)
        try:
            first = run(fe, PROMPTS[1])
            for p in PROMPTS[2:] + PROMPTS[:1]:
                run(fe, p)              # the same lanes again
        finally:
            fe.close()
        alone = PS.PrefillFrontend(st["model"], st["cfg"], **kw)
        try:
            want = run(alone, PROMPTS[1])
        finally:
            alone.close()
        assert sorted(first) == sorted(want)
        for key in want:
            assert torch.equal(first[key], want[key]), key

    def test_short_prompt_first_at_lanes4_last_at_lanes1(self, setup):
        """Head-of-line order with the engine frozen, then released on
        three long jobs and one short prompt: at 4 lanes the short
        prompt finishes first (its first iteration, while the longs have
        slices left); at 1 lane it waits behind every long one."""
        st = setup
        rng = np.random.default_rng(0)
        longs = [[int(x) for x in rng.integers(1, 256, 40)]
                 for _ in range(3)]
        short = [int(x) for x in rng.integers(1, 256, 4)]
        from paddle_operator_tpu_torch.infer.executor import PrefillExecutor

        for lanes, first in ((4, True), (1, False)):
            pe = PrefillExecutor(st["model"], st["cfg"], max_len=MAX_LEN,
                                 block_size=BS, buckets=(MAX_LEN,),
                                 lanes=lanes, prefill_chunk=8)
            gate = threading.Event()
            pe.pause_gate = lambda g=gate: g.wait(60)
            try:
                jobs = [PS._Job(p, 0.0, 0) for p in longs]
                sj = PS._Job(short, 0.0, 0)
                for i, j in enumerate(jobs):
                    pe.submit(j, i)
                pe.submit(sj, 3)
                gate.set()
                order = []
                deadline = time.monotonic() + 60
                while len(order) < 4:
                    assert time.monotonic() < deadline
                    try:
                        item = pe.results.get(timeout=0.1)
                    except Exception:
                        continue
                    if isinstance(item[0], str) and item[0] == "frame":
                        continue
                    req = item[1] if isinstance(item[0], str) else item[0]
                    assert len(item) != 3, item
                    order.append(req)
                    pe.release(req)
                assert (order[0] is sj) if first else (order[-1] is sj)
            finally:
                pe.close()


# ---------------------------------------------------------------------------
# the fleet: the JAX router, mixed fleets, the entry point
# ---------------------------------------------------------------------------


class TestFleet:
    def test_jax_router_forwards_to_a_port_pod(self, setup):
        """The unchanged JAX router scrapes a port pod, forwards
        ``/v1/prefill`` to it (the handoff decodes), and a port replica
        whose broker is that router serves ``generate``'s streams."""
        st = setup
        srv, ep = _pod(st, lanes=2)
        r = FleetRouter([], prefill_endpoints=[ep])
        rsrv = None
        try:
            r.scrape_once()
            assert r.prefill[ep].ready
            code, raw, used = r.forward_prefill(json.dumps(
                {"tokens": PROMPTS[2],
                 "fingerprint": srv.frontend.fingerprint()}).encode())
            assert code == 200 and used == ep
            meta, arrays = FK.decode_handoff(raw)
            assert meta["nBlocks"] == 4 and arrays["k"].shape[1] == 4
            assert r.counters["prefill_jobs_forwarded"] == 1
            rsrv = make_router_server("127.0.0.1", 0, r)
            rep = _serve(rsrv)
            b = ContinuousBatcher(st["model"], st["cfg"], **_ring_kw(
                prefill_client=PS.RemotePrefillClient(broker=rep,
                                                      stream=True)))
            try:
                assert _run(b) == [st["ref"](p) for p in PROMPTS]
                assert b.stats["remote_prefills"] == len(PROMPTS)
                assert b.stats["handoff_frames"] > 0
            finally:
                b.close()
        finally:
            if rsrv is not None:
                rsrv.shutdown()
                rsrv.server_close()
                rsrv.router.close()
            _stop(srv)

    def test_jax_replica_on_port_pod_and_port_replica_on_jax_pod(self, setup):
        """A mixed fleet at f32: a JAX decode replica whose prefill pod
        is the port's, and a port replica on a JAX pod, both give
        ``generate``'s greedy tokens (whole envelopes and streamed
        frames)."""
        st = setup
        want = [st["ref"](p) for p in PROMPTS]
        srv, ep = _pod(st, lanes=2)
        jb = JaxBatcher(st["jparams"], st["jcfg"], **_ring_kw(
            prefill_client=JPS.RemotePrefillClient(peers=[ep], stream=True)))
        try:
            assert _run(jb) == want
            assert jb.stats["remote_prefills"] == len(PROMPTS)
        finally:
            jb.close()
            _stop(srv)
        jsrv = JPS.make_prefill_server(
            "127.0.0.1", 0, st["jparams"], st["jcfg"], block_size=BS,
            max_len=MAX_LEN, buckets=(16, MAX_LEN))
        jep = _serve(jsrv)
        b = ContinuousBatcher(st["model"], st["cfg"], **_ring_kw(
            prefill_client=PS.RemotePrefillClient(peers=[jep])))
        try:
            assert _run(b) == want
            assert b.stats["remote_prefills"] == len(PROMPTS)
        finally:
            b.close()
            _stop(jsrv)

    def test_python_m_entry_boots_serves_and_drains(self, tmp_path):
        """``python -m paddle_operator_tpu_torch.infer.prefill_serve
        --device cpu``: ready on TPUJOB_PORT, a handoff whose envelope
        decodes, and exit 83 (EXIT_PREEMPTED) after SIGTERM; it imports
        no JAX."""
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        env = dict(os.environ, MODEL_PRESET="tiny", TPUJOB_PORT=str(port),
                   SERVE_BLOCK_SIZE="16", SERVE_PREFILL_LANES="2",
                   TPUJOB_CHECKPOINT_PATH=str(tmp_path),
                   PYTHONPATH=str(ROOT), SERVE_DRAIN_BUDGET_S="5")
        code = ("import sys, runpy; "
                "sys.argv = ['prefill_serve', '--device', 'cpu']; "
                "runpy.run_module('paddle_operator_tpu_torch.infer."
                "prefill_serve', run_name='__main__')")
        # runpy under a guard that fails the process if JAX is imported
        guard = ("import sys; "
                 "sys.modules['jax'] = None; " + code)
        proc = subprocess.Popen([sys.executable, "-c", guard], cwd=str(ROOT),
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT)
        ep = f"127.0.0.1:{port}"
        try:
            deadline = time.monotonic() + 120
            while True:
                assert proc.poll() is None, proc.stdout.read().decode()
                try:
                    if _get(ep, "/readyz")[0] == 200:
                        break
                except OSError:
                    pass
                assert time.monotonic() < deadline
                time.sleep(0.2)
            code, raw, _ = _post(ep, {"tokens": PROMPTS[1]})
            assert code == 200
            meta, _ = FK.decode_handoff(raw)
            assert meta["promptLen"] == 19
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=60) == 83
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
