"""The torch package's disaggregated prefill (SERVE_PREFILL=disagg,
SERVE_PREFILL_LANES, _STREAM, _PREFIX_BLOCKS) held against the JAX
package, on numpy-seeded prompts and the JAX package's ``tiny`` params
converted in float32:

- the wire: handoff envelopes, streamed frames and prefix envelopes are
  byte-equal to the JAX package's both ways and refused alike (after
  tests/test_xdisagg.py ``TestHandoffCodec`` and
  tests/test_prefillpool.py ``TestFrameCodec``); the shared backoff law;
  the copied ``utils/wirechaos.py``'s grammar and proxy (after
  tests/test_wirechaos.py);
- the engine's programs against JAX's at f32 (``TOL``): the 1-lane
  whole-prompt prefill (first token; every row below the prompt's
  length — JAX forwards the bucket, whose pad rows hold pad-token KV,
  the port the prompt, whose pad rows stay zero), the N-lane slice and
  final programs (the whole pool: both write whole blocks, pad rows
  included), the handoff copies; an int8 block no job committed crosses
  the wire with JAX's bytes;
- disaggregated rings: greedy streams equal ``generate`` and JAX's own
  disaggregated ring with the same knobs (int8: JAX's int8 ring) — the
  bf16 and int8 pools, lanes 1, 2 and 4, frames streamed or not, the
  engine's prefix cache, megastep 1 and 4, a speculative ring and
  adapter lanes;
- the lifecycle (after tests/test_prefill_modes.py): a prefix hit skips
  the engine, a late handoff of a cancelled request is dropped and its
  engine lane released, chaos under disagg resolves every request
  exactly once and keeps the pool invariant, admission order (recorded
  where requests resolve), deadline, drain, a heal and a weight swap
  with the engine mid-job, the snapshot-lifetime rule, prewarm and the
  ``/statusz`` keys;
- the env: ``SERVE_PREFILL=disagg`` and its knobs are read as the JAX
  entry point reads them; the fleet-KV knobs are still refused by name.

Tolerances: ``TOL`` 1e-5 on f32 K/V rows and scales (the same products,
summation order aside); int8 codes within 1 (an f32 last bit may cross
a code midpoint).  Token streams are compared exactly.
"""

import json
import threading
import time
import urllib.error
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from random import Random

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import ml_dtypes
import torch

from paddle_operator_tpu.infer import decode as JD
from paddle_operator_tpu.infer import executor as JX
from paddle_operator_tpu.infer import paged as JPG
from paddle_operator_tpu.infer import prefill_serve as JPS
from paddle_operator_tpu.infer import qos as JQ
from paddle_operator_tpu.infer.batcher import ContinuousBatcher as JaxBatcher
from paddle_operator_tpu.models.llama import make_model as jax_make_model
from paddle_operator_tpu.utils import fleetkv as JFK
from paddle_operator_tpu.utils import wirechaos as JWC
from paddle_operator_tpu_torch.convert import params_from_jax
from paddle_operator_tpu_torch.infer import executor as X
from paddle_operator_tpu_torch.infer import paged as PG
from paddle_operator_tpu_torch.infer import prefill_serve as PS
from paddle_operator_tpu_torch.infer import qos as TQ
from paddle_operator_tpu_torch.infer import serve as S
from paddle_operator_tpu_torch.infer.batcher import ContinuousBatcher
from paddle_operator_tpu_torch.infer.chaos import ChaosEvent, ChaosInjector
from paddle_operator_tpu_torch.infer.resilience import (
    LaneQuarantined,
    RetriableError,
    RingResilience,
    ShuttingDown,
)
from paddle_operator_tpu_torch.models.llama import Llama, make_model
from paddle_operator_tpu_torch.utils import fleetkv as TFK
from paddle_operator_tpu_torch.utils import wirechaos as TWC

MAX_LEN = 64
BS = 8
TOL = 1e-5
NEW = 6
LENS = (5, 19, 30, 12)


@pytest.fixture(scope="module")
def setup():
    jmodel, jcfg = jax_make_model("tiny", dtype=jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, 8), jnp.int32))["params"]
    model, cfg = make_model("tiny", device="cpu", dtype=torch.float32)
    model.load_state_dict(params_from_jax(jax.device_get(jparams)))
    model.requires_grad_(False)
    refs, rings = {}, {}

    def ref(prompt, new=NEW, params=None):
        """JAX ``decode.generate`` (memoized)."""
        key = (tuple(prompt), new, id(params))
        if key not in refs:
            refs[key] = np.asarray(JD.generate(
                jparams if params is None else params, jcfg,
                jnp.asarray([prompt], jnp.int32), max_new_tokens=new,
                max_len=MAX_LEN)[0]).tolist()
        return refs[key]

    def jax_ring(prompts, new=NEW, **kw):
        """JAX's disaggregated ring on ``prompts`` (memoized by knobs)."""
        key = (tuple(map(tuple, prompts)), new, tuple(sorted(kw.items())))
        if key not in rings:
            jb = JaxBatcher(jparams, jcfg, **_ring_kw(**kw))
            try:
                rings[key] = [h.result(timeout=300) for h in [
                    jb.submit(p, max_new_tokens=new) for p in prompts]]
            finally:
                jb.close()
        return rings[key]

    return {"jparams": jparams, "jcfg": jcfg, "model": model, "cfg": cfg,
            "ref": ref, "jax_ring": jax_ring}


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, 256, n).astype(
        np.int32).tolist()


PROMPTS = [_prompt(n, 10 + i) for i, n in enumerate(LENS)]


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


def _batcher(st, **kw):
    return ContinuousBatcher(st["model"], st["cfg"], **_ring_kw(**kw))


def _run(b, prompts=PROMPTS, new=NEW):
    return [h.result(timeout=120) for h in [
        b.submit(p, max_new_tokens=new) for p in prompts]]


def _wait(cond, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.002)


def _settled(b):
    """The ring holds no handoff in flight and every engine lane is
    released."""
    pe = b.executor.prefill_exec
    return (not b._disagg_waiting and pe.jobs.empty() and pe.results.empty()
            and not getattr(pe, "_held", {}))


def _assert_codes_close(got, want, what):
    diff = np.abs(np.asarray(got, np.int32) - np.asarray(want, np.int32))
    assert diff.max() <= 1, f"{what}: codes differ by {diff.max()}"


# ---------------------------------------------------------------------------
# the wire: envelopes and frames, byte for byte
# ---------------------------------------------------------------------------


def _arrays(n_blocks=2, quant=False, bf16=False, seed=0):
    """One handoff payload: (numpy arrays for JAX, tensors for the port)."""
    lc, h, bs, d = 2, 2, 4, 8
    rng = np.random.default_rng(seed)
    a = {"k": rng.standard_normal((lc, n_blocks, h, bs, d)).astype(
            np.float32),
         "v": rng.standard_normal((lc, n_blocks, h, bs, d)).astype(
            np.float32)}
    if quant:
        a["k"] = (a["k"] * 10).astype(np.int8)
        a["v"] = (a["v"] * 10).astype(np.int8)
        a["ks"] = rng.random((lc, n_blocks, h)).astype(np.float32)
        a["vs"] = np.zeros((lc, n_blocks, h), np.float32)
        a["kt"] = rng.standard_normal((lc, 1, h, bs, d)).astype(np.float32)
        a["vt"] = np.zeros((lc, 1, h, bs, d), np.float32)
    if bf16:
        a = {k: v.astype(ml_dtypes.bfloat16) if v.dtype == np.float32
             else v for k, v in a.items()}
    t = {k: (torch.from_numpy(v.view(np.int16).copy()).view(torch.bfloat16)
             if v.dtype == ml_dtypes.bfloat16 else torch.from_numpy(v.copy()))
         for k, v in a.items()}
    return a, t


def _raw(x):
    """An array's bits as numpy (bfloat16 through an int16 view)."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16).numpy() if x.dtype == torch.bfloat16
                else x.numpy())
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x


def _same_arrays(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = _raw(got[k]), _raw(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w)


META = {"first": 7, "promptLen": 6, "nBlocks": 2,
        "fingerprint": {"layers": 2, "blockSize": 4, "quant": "none"}}


class TestWire:
    @pytest.mark.parametrize("kind", ["f32", "int8", "bf16"])
    def test_handoff_byte_equal_both_ways(self, kind):
        a, t = _arrays(quant=kind == "int8", bf16=kind == "bf16")
        jbuf = JFK.encode_handoff(META, a)
        tbuf = TFK.encode_handoff(META, t)
        assert tbuf == jbuf
        meta, got = TFK.decode_handoff(jbuf)
        assert meta == META
        _same_arrays(got, a)
        meta, got = JFK.decode_handoff(tbuf)
        assert meta == META
        _same_arrays(got, a)

    @pytest.mark.parametrize("FK", [JFK, TFK], ids=["jax", "torch"])
    def test_handoff_refusals(self, FK):
        a, _ = _arrays()
        with pytest.raises(FK.EnvelopeError, match="handoff"):
            FK.decode_handoff(FK.encode_envelope("lane", META, a))
        for missing in ("first", "promptLen", "nBlocks"):
            m = dict(META)
            del m[missing]
            with pytest.raises(FK.EnvelopeError, match=missing):
                FK.decode_handoff(FK.encode_handoff(m, a))
        with pytest.raises(FK.EnvelopeError, match="blocks"):
            FK.decode_handoff(FK.encode_handoff(dict(META, nBlocks=3), a))
        buf = FK.encode_handoff(META, a)
        for cut in (3, 7, len(buf) // 2, len(buf) - 1):
            with pytest.raises(FK.EnvelopeError):
                FK.decode_handoff(buf[:cut])
        bad = bytearray(buf)
        bad[-3] ^= 0xFF
        with pytest.raises(FK.EnvelopeError, match="checksum"):
            FK.decode_handoff(bytes(bad))
        mine = META["fingerprint"]
        FK.check_fingerprint({"fingerprint": dict(mine)}, mine)
        with pytest.raises(FK.EnvelopeError, match="fingerprint"):
            FK.check_fingerprint({"fingerprint": dict(mine, quant="int8")},
                                 mine)

    def test_refusal_messages_equal_jax(self):
        """The same bad envelope is refused with the JAX package's
        message."""
        a, t = _arrays()
        buf = JFK.encode_handoff(dict(META, nBlocks=3), a)
        with pytest.raises(JFK.EnvelopeError) as je:
            JFK.decode_handoff(buf)
        with pytest.raises(TFK.EnvelopeError) as te:
            TFK.decode_handoff(buf)
        assert str(te.value) == str(je.value)

    @pytest.mark.parametrize("quant", [False, True])
    def test_frames_byte_equal_and_read_both_ways(self, quant):
        """A streamed handoff: two intermediate frames and the terminal
        one, each byte-equal to JAX's; the port's reader takes JAX's
        stream and JAX's the port's."""
        f1, t1 = _arrays(1, quant=quant, seed=1)
        f2, t2 = _arrays(1, quant=quant, seed=2)
        fin, tfin = _arrays(2, quant=quant, seed=3)
        if quant:       # frames carry blocks only; the tail is terminal
            for d in (f1, t1, f2, t2):
                d.pop("kt")
                d.pop("vt")
        meta = {"seq": 2, "nFrames": 3, "j0": 2, "first": 11,
                "promptLen": 13, "nBlocks": 4,
                "fingerprint": {"layers": 2}, "tDone": 123.0}
        jw = [JFK.encode_handoff_frame(0, 0, f1),
              JFK.encode_handoff_frame(1, 1, f2),
              JFK.encode_handoff_final(meta, fin)]
        tw = [TFK.encode_handoff_frame(0, 0, t1),
              TFK.encode_handoff_frame(1, 1, t2),
              TFK.encode_handoff_final(meta, tfin)]
        assert tw == jw
        for FK, wires, want in ((TFK, jw, (f1, f2, fin)),
                                (JFK, tw, (f1, f2, fin))):
            stream = b"".join(wires)
            pos = [0]

            def read(n):
                b = stream[pos[0]:pos[0] + n]
                pos[0] += len(b)
                return b

            for seq, w in enumerate(want):
                kind, m, arrays = FK.decode_handoff_frame(
                    FK.read_wire_frame(read), seq)
                assert kind == (FK.FINAL_KIND if seq == 2 else FK.FRAME_KIND)
                _same_arrays(arrays, w)
            assert m == meta
            assert FK.read_wire_frame(read) is None

    @pytest.mark.parametrize("FK", [JFK, TFK], ids=["jax", "torch"])
    def test_frame_refusals(self, FK):
        a, _ = _arrays(1)
        w0 = FK.encode_handoff_frame(0, 0, a)
        w1 = FK.encode_handoff_frame(1, 1, a)
        with pytest.raises(FK.EnvelopeError, match="out of order"):
            FK.decode_handoff_frame(w1[4:], 0)
        stream = (w0 + w1)[:len(w0) + 7]
        pos = [0]

        def read(n):
            b = stream[pos[0]:pos[0] + n]
            pos[0] += len(b)
            return b

        assert FK.read_wire_frame(read) is not None
        with pytest.raises(FK.EnvelopeError, match="mid-frame"):
            FK.read_wire_frame(read)
        env = bytearray(w0[4:])
        env[-3] ^= 0xFF
        with pytest.raises(FK.EnvelopeError, match="checksum"):
            FK.decode_handoff_frame(bytes(env), 0)
        with pytest.raises(FK.EnvelopeError, match="nFrames"):
            FK.decode_handoff_frame(FK.encode_envelope(
                FK.FINAL_KIND, {"seq": 0, "j0": 0, "first": 1,
                                "promptLen": 2, "nBlocks": 1}, {}), 0)
        with pytest.raises(FK.EnvelopeError, match="disagrees"):
            FK.decode_handoff_frame(FK.encode_envelope(
                FK.FINAL_KIND, {"seq": 2, "nFrames": 2, "j0": 0, "first": 1,
                                "promptLen": 2, "nBlocks": 1}, {}), 2)
        with pytest.raises(FK.EnvelopeError, match="k/v"):
            FK.decode_handoff_frame(FK.encode_envelope(
                FK.FRAME_KIND, {"seq": 0, "j0": 0}, {}), 0)

    def test_prefix_envelope_byte_equal_both_ways(self):
        chunks = [[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12]]
        pays = [_arrays(1, quant=True, seed=s) for s in (4, 5)]
        for a, t in pays:
            for d in (a, t):
                d.pop("kt")
                d.pop("vt")
        meta = {"fingerprint": {"layers": 2}, "ns": 0}
        jbuf = JFK.encode_prefix(meta, chunks, [0, 2], [a for a, _ in pays])
        tbuf = TFK.encode_prefix(meta, chunks, [0, 2], [t for _, t in pays])
        assert tbuf == jbuf
        for FK, buf in ((TFK, jbuf), (JFK, tbuf)):
            m, c, idx, got = FK.decode_prefix(buf)
            assert c == chunks and idx == [0, 2] and m["ns"] == 0
            for g, (a, _) in zip(got, pays):
                _same_arrays(g, a)
        for FK in (JFK, TFK):
            with pytest.raises(FK.EnvelopeError, match="missing k/v"):
                FK.decode_prefix(FK.encode_envelope(
                    "prefix", {"chunks": chunks, "blocks": [1]}, {}))

    def test_backoff_law_equals_jax(self):
        for attempt in range(6):
            for ra in (None, "3", "Wed, 21 Oct 2015 07:28:00 GMT"):
                assert TFK.backoff_delay(
                    attempt, base_s=0.25, max_s=8.0, retry_after=ra,
                    rng=Random(attempt)) == JFK.backoff_delay(
                    attempt, base_s=0.25, max_s=8.0, retry_after=ra,
                    rng=Random(attempt))


class _Echo(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    bodies = None

    def log_message(self, *a):
        pass

    def do_GET(self):
        body = b'{"ok": true}'
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self):
        raw = self.rfile.read(int(self.headers.get("Content-Length", 0)))
        type(self).bodies.append(raw)
        body = json.dumps({"echo": json.loads(raw)}, sort_keys=True).encode()
        self.send_response(200)
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)


@pytest.fixture()
def echo():
    h = type("Echo", (_Echo,), {"bodies": []})
    srv = ThreadingHTTPServer(("127.0.0.1", 0), h)
    threading.Thread(target=lambda: srv.serve_forever(poll_interval=0.02),
                     daemon=True).start()
    yield f"127.0.0.1:{srv.server_address[1]}", h
    srv.shutdown()
    srv.server_close()


def _post(endpoint, payload, timeout=10.0):
    req = urllib.request.Request(
        f"http://{endpoint}/v1/prefill", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, r.read()


class TestWireChaosCopy:
    """The copied module, held to tests/test_wirechaos.py's grammar and
    proxy cases."""

    def test_same_edges_kinds_and_grammar_as_jax(self):
        assert TWC.EDGES == JWC.EDGES and TWC.KINDS == JWC.KINDS
        spec = ("client-router=drop@2,burst503@5:3;"
                "router-replica=blackhole@4:6;decode-prefill=corrupt@9,"
                "drop@1")
        got, want = TWC.parse_schedule(spec), JWC.parse_schedule(spec)
        assert {e: [(w.kind, w.at, w.arg) for w in ws]
                for e, ws in got.items()} == {
            e: [(w.kind, w.at, w.arg) for w in ws] for e, ws in want.items()}
        assert [w.at for w in got["decode-prefill"]] == [1, 9]
        assert TWC.parse_schedule(" ; ") == {}
        for bad, match in (("client-rooter=drop@0", "unknown wirechaos edge"),
                           ("client-router=dorp@0", "unknown wirechaos kind"),
                           ("drop@0", "missing 'edge='")):
            with pytest.raises(ValueError, match=match):
                TWC.parse_schedule(bad)

    def test_proxy_fault_free_drop_burst_corrupt(self, echo):
        up, h = echo
        payload = {"tokens": [1, 2, 3]}
        _, direct = _post(up, payload)
        proxy = TWC.WireChaosProxy(up, [TWC.WireEvent("drop", 1),
                                        TWC.WireEvent("burst503", 2, 1),
                                        TWC.WireEvent("corrupt", 3)],
                                   seed=3).start()
        try:
            assert _post(proxy.endpoint, payload)[1] == direct
            with pytest.raises((urllib.error.URLError, ConnectionError,
                                OSError)):
                _post(proxy.endpoint, payload)
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(proxy.endpoint, payload)
            assert ei.value.code == 503
            via = _post(proxy.endpoint, payload)[1]
            assert len(via) == len(direct)
            assert sum(a != b for a, b in zip(via, direct)) == 1
            assert [k for k, _ in proxy.fired] == ["drop", "burst503",
                                                  "corrupt"]
            # drop and the 503 burst never reached the upstream
            assert len(h.bodies) == 3
        finally:
            proxy.close()

    def test_decode_prefill_edge_from_env(self, echo):
        """``remote_prefill_client_from_env`` routes the decode->prefill
        edge through an injured proxy when TPUJOB_WIRE_CHAOS schedules
        it, and leaves it direct when it does not."""
        up, _ = echo
        env = {"SERVE_PREFILL_REMOTE": "1", "SERVE_PREFILL_PEERS": up,
               TWC.WIRE_CHAOS_ENV: "decode-prefill=burst503@0",
               TWC.WIRE_CHAOS_SEED_ENV: "5"}
        client = PS.remote_prefill_client_from_env(env)
        try:
            (ep,) = client.peers
            assert ep != up
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(ep, {"tokens": [1]})
            assert ei.value.code == 503
        finally:
            client.close()
            TWC.close_env_proxies()
        env.pop(TWC.WIRE_CHAOS_ENV)
        client = PS.remote_prefill_client_from_env(env)
        try:
            assert client.peers == [up] and not client.stream
        finally:
            client.close()


# ---------------------------------------------------------------------------
# the engine's programs against JAX's
# ---------------------------------------------------------------------------


def _close(got, want, what, atol=TOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=TOL,
                               atol=atol, err_msg=what)


def _pool_pair(st, quant, lanes, m):
    """Empty engine pools of both packages (JAX's ``init_paged_cache``
    and the port engine's, scales at JAX's 0.0)."""
    kvq = "int8" if quant else "none"
    jc = JPG.init_paged_cache(st["jcfg"], lanes, lanes * m + 1, BS,
                              quant=kvq)
    tc = PG.init_paged_cache(st["cfg"], lanes, lanes * m + 1, BS,
                             device="cpu", quant=kvq)
    if quant:
        for key in ("ks", "vs"):
            tc[key].zero_()
    return jc, tc


class TestEnginePrograms:
    @pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
    def test_disagg_prefill_equals_jax(self, setup, quant):
        """The 1-lane engine's program: the same first token, and every
        row below the prompt's length equal (JAX forwards its bucket, so
        its pad rows hold pad-token KV; the port forwards the prompt).
        int8: full blocks' codes and scales, and the tail row's rows."""
        st = setup
        n, m, bucket = 21, MAX_LEN // BS, 32
        prompt = _prompt(n, 3)
        jc, tc = _pool_pair(st, quant, 1, m)
        jprog = JX.make_disagg_prefill(st["jcfg"], bucket, BS,
                                       quant=quant)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :n] = prompt
        jc, jfirst = jprog(st["jparams"], jc,
                           jnp.arange(1, m + 1, dtype=jnp.int32),
                           jnp.asarray(padded), n, 0.0, 3)
        prog = X.make_disagg_prefill(st["cfg"], bucket, BS, quant=quant)
        with torch.inference_mode():
            first = prog(st["model"], tc, torch.arange(1, m + 1,
                                                       dtype=torch.int32),
                         torch.tensor([prompt], dtype=torch.int32), n, 0.0,
                         3)
        assert int(first) == int(jfirst)
        full, rem = divmod(n, BS)
        for key in ("k", "v"):
            if quant:
                _assert_codes_close(tc[key][:, 1:1 + full].numpy(),
                                    np.asarray(jc[key])[:, 1:1 + full], key)
                _close(tc[key + "s"][:, 1:1 + full],
                       np.asarray(jc[key + "s"])[:, 1:1 + full], key + "s")
                _close(tc[key + "t"][:, 0, :, :rem],
                       np.asarray(jc[key + "t"])[:, 0, :, :rem], key + "t")
            else:
                rows = lambda a: a[:, 1:1 + -(-n // BS)].transpose(  # noqa
                    0, 2, 1, 3, 4).reshape(a.shape[0], a.shape[2], -1,
                                           a.shape[4])[:, :, :n]
                _close(rows(tc[key].numpy()), rows(np.asarray(jc[key])), key)

    @pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
    def test_slice_and_final_equal_jax(self, setup, quant):
        """The N-lane engine's batched slice and final programs on two
        lanes (lane 1 finishes in the final, lane 0 takes a slice first;
        a third lane sits out): the pool's blocks equal JAX's — both
        write whole blocks, pad rows included — and the sampled firsts
        of the finishing lanes."""
        st = setup
        m, nl, sb = MAX_LEN // BS, 3, 8
        jc, tc = _pool_pair(st, quant, nl, m)
        tables = np.stack([np.arange(1 + i * m, 1 + (i + 1) * m,
                                     dtype=np.int32) for i in range(nl)])
        p0, p1 = _prompt(13, 5), _prompt(7, 6)
        toks = np.zeros((nl, sb), np.int32)
        toks[0] = p0[:sb]
        starts = np.zeros((nl,), np.int32)
        limits = np.array([sb, 0, 0], np.int32)
        mask = np.array([True, False, False])
        jslice = JX.make_pool_prefill_slice(st["jcfg"], quant=quant)
        jc = jslice(st["jparams"], jc, jnp.asarray(tables[:, :4]),
                    jnp.asarray(toks), jnp.asarray(starts),
                    jnp.asarray(limits), jnp.asarray(mask))
        tslice = X.make_pool_prefill_slice(st["cfg"], quant=quant)
        t = torch.as_tensor
        with torch.inference_mode():
            tslice(st["model"], tc, t(tables[:, :4]), t(toks), t(starts),
                   t(limits), t(mask))
        # the final: lane 0's remaining 5 rows, lane 1's whole 7
        ftoks = np.zeros((nl, sb), np.int32)
        ftoks[0, :5] = p0[sb:]
        ftoks[1, :7] = p1
        n_rows = np.array([5, 7, 0], np.int32)
        fstarts = np.array([sb, 0, 0], np.int32)
        flimits = np.array([13, 7, 0], np.int32)
        fmask = np.array([True, True, False])
        temps = np.zeros((nl,), np.float32)
        seeds = np.array([1, 2, 3], np.int32)
        jfinal = JX.make_pool_prefill_final(st["jcfg"], quant=quant)
        jc, jfirsts = jfinal(
            st["jparams"], jc, jnp.asarray(tables[:, :4]),
            jnp.asarray(ftoks), jnp.asarray(n_rows), jnp.asarray(fstarts),
            jnp.asarray(temps), jnp.asarray(seeds), jnp.asarray(flimits),
            jnp.asarray(fmask))
        tfinal = X.make_pool_prefill_final(st["cfg"], quant=quant)
        with torch.inference_mode():
            firsts = tfinal(st["model"], tc, t(tables[:, :4]), t(ftoks),
                            t(n_rows), t(fstarts), t(temps),
                            t(seeds.astype(np.int64)), t(flimits), t(fmask))
        assert firsts[:2].tolist() == np.asarray(jfirsts)[:2].tolist()
        # block 0 is the trash block, the last tail row the trash tail:
        # what masked lanes write there is nobody's
        for key in ("k", "v"):
            if quant:
                _assert_codes_close(tc[key][:, 1:].numpy(),
                                    np.asarray(jc[key])[:, 1:], key)
                _close(tc[key + "s"][:, 1:],
                       np.asarray(jc[key + "s"])[:, 1:], key + "s")
                _close(tc[key + "t"][:, :2], np.asarray(jc[key + "t"])[:, :2],
                       key + "t")
            else:
                _close(tc[key][:, 1:], np.asarray(jc[key])[:, 1:], key)

    @pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
    def test_transfers_equal_jax(self, setup, quant):
        """The handoff copies on the same random pools: JAX's 1-lane
        transfer (blocks, and int8's tail row 0 into tail row ``slot``)
        against the port's frame copy and tail copy composed as the
        landing runs them, and the lane-addressed tail copy alone."""
        st = setup
        rng = np.random.default_rng(9)
        kvq = "int8" if quant else "none"

        def pool(total, lanes):
            c = {k: np.array(v) for k, v in JPG.init_paged_cache(
                st["jcfg"], lanes, total, BS, quant=kvq).items()}
            for key in ("k", "v"):
                c[key] = (rng.integers(-127, 128, c[key].shape).astype(
                    np.int8) if quant else rng.standard_normal(
                    c[key].shape).astype(np.float32))
                if quant:
                    c[key + "s"] = rng.random(c[key + "s"].shape).astype(
                        np.float32)
                    c[key + "t"] = rng.standard_normal(
                        c[key + "t"].shape).astype(np.float32)
            return c

        dst, src = pool(12, 2), pool(9, 2)
        src_ids = np.array([1, 2, 3, 0, 0, 0, 0, 0], np.int32)
        dst_ids = np.array([7, 4, 9, 0, 0, 0, 0, 0], np.int32)
        keys = ("k", "v", "ks", "vs", "kt", "vt") if quant else ("k", "v")
        J = {k: jnp.asarray(v) for k, v in dst.items()}
        if quant:
            out = JPG.make_pool_transfer(8, quant=True)(
                *[J[k] for k in keys], *[jnp.asarray(src[k]) for k in keys],
                jnp.asarray(src_ids), jnp.asarray(dst_ids), 1)
        else:
            out = JPG.make_pool_transfer(8)(
                J["k"], J["v"], jnp.asarray(src["k"]), jnp.asarray(src["v"]),
                jnp.asarray(src_ids), jnp.asarray(dst_ids))
        want = dict(zip(keys, out))
        T = {k: torch.as_tensor(v.copy()) for k, v in dst.items()}
        tsrc = {k: torch.as_tensor(v.copy()) for k, v in src.items()}
        # the 1-lane engine's fused JAX copy is the port's frame copy
        # followed, on the int8 pool, by the tail copy from engine row 0
        PG.make_pool_frame_transfer(8, quant=quant)(
            T, tsrc, torch.as_tensor(src_ids[:3]).long(),
            torch.as_tensor(dst_ids[:3]).long())
        if quant:
            PG.make_pool_tail_copy()(T, tsrc, 0, 1)
        for k in keys:
            # JAX's padding writes the trash block: block 0 aside, equal
            np.testing.assert_array_equal(T[k][:, 1:].numpy() if k[1:2] != "t"
                                          else T[k].numpy(),
                                          np.asarray(want[k])[:, 1:]
                                          if k[1:2] != "t"
                                          else np.asarray(want[k]))
        if quant:
            jkt, jvt = JPG.make_pool_tail_copy()(
                jnp.asarray(dst["kt"]), jnp.asarray(dst["vt"]),
                jnp.asarray(src["kt"]), jnp.asarray(src["vt"]), 1, 0)
            T2 = {k: torch.as_tensor(v.copy()) for k, v in dst.items()}
            PG.make_pool_tail_copy()(T2, tsrc, 1, 0)
            np.testing.assert_array_equal(T2["kt"].numpy(), np.asarray(jkt))
            np.testing.assert_array_equal(T2["vt"].numpy(), np.asarray(jvt))

    def test_uncommitted_int8_block_crosses_with_jax_bytes(self, setup):
        """A handoff from a 2-lane int8 engine whose prompt ends
        mid-block: the write-frontier block was never committed, so its
        pool bytes are the pool's initial ones — scale 0.0 and codes 0 in
        both envelopes, byte for byte (the decode pool's own initial
        scale is 1.0).  The header, its meta and the manifest are equal
        byte for byte too; committed blocks agree within the int8
        tolerance, the tail row within TOL."""
        st = setup
        tokens = _prompt(21, 12)
        kw = dict(block_size=BS, max_len=MAX_LEN, buckets=(16, MAX_LEN),
                  kv_quant="int8", lanes=2, prefill_chunk=8)
        jfe = JPS.PrefillFrontend(st["jparams"], st["jcfg"], **kw)
        tfe = PS.PrefillFrontend(st["model"], st["cfg"], **kw)
        try:
            jbuf = jfe.prefill(tokens, 0.0, 0)
            tbuf = tfe.prefill(tokens, 0.0, 0)
        finally:
            jfe.close()
            tfe.close()
        jhead, thead = JFK.peek_header(jbuf), TFK.peek_header(tbuf)
        assert {k: v for k, v in thead.items() if k != "crc"} == {
            k: v for k, v in jhead.items() if k != "crc"}
        hlen = len(JFK.MAGIC) + 8 + len(json.dumps(jhead).encode())
        jm, ja = JFK.decode_handoff(jbuf)
        tm, ta = TFK.decode_handoff(tbuf)
        assert tm == jm and jm["nBlocks"] == 3
        last = np.s_[:, 2]
        for key in ("k", "v", "ks", "vs"):
            assert ta[key][last].numpy().tobytes() == \
                np.asarray(ja[key])[last].tobytes(), key
        assert not ta["ks"][last].any() and not ta["k"][last].any()
        for key in ("k", "v"):
            _assert_codes_close(ta[key][:, :2].numpy(), ja[key][:, :2], key)
            _close(ta[key + "s"][:, :2], ja[key + "s"][:, :2], key + "s")
            _close(ta[key + "t"][:, 0, :, :21 % BS],
                   ja[key + "t"][:, 0, :, :21 % BS], key + "t")
        assert hlen > 0


# ---------------------------------------------------------------------------
# disaggregated rings
# ---------------------------------------------------------------------------

RING_CASES = {
    "bf16-lanes1": {},
    "bf16-lanes1-megastep4": {"megastep": 4},
    "bf16-lanes4": {"prefill_lanes": 4},
    "bf16-lanes4-stream-prefix": {"prefill_lanes": 4, "prefill_stream": True,
                                  "prefill_prefix_blocks": 16},
    "bf16-lanes2-stream-megastep4": {"prefill_lanes": 2,
                                     "prefill_stream": True, "megastep": 4},
    "int8-lanes1": {"kv_quant": "int8"},
    "int8-lanes2-stream-prefix-megastep4": {
        "kv_quant": "int8", "prefill_lanes": 2, "prefill_stream": True,
        "prefill_prefix_blocks": 16, "megastep": 4},
}
# knobs that change no greedy token on either package (the JAX package
# holds each to its engine's tokens): one JAX ring serves a case with or
# without them
SAME_TOKENS = ("megastep", "prefill_stream", "prefill_prefix_blocks")


class TestDisaggRings:
    @pytest.mark.parametrize("case", list(RING_CASES))
    def test_streams_equal_generate_and_jax(self, setup, case):
        """Greedy streams equal JAX's disaggregated ring with the same
        knobs (on the bf16 pool the 1-lane one: JAX holds its N-lane
        rings to it) and, on the bf16 pool, ``generate``; every cold
        prompt was handed off, streamed rings landed frames; the pool
        invariant holds and every engine lane is released."""
        st = setup
        kw = RING_CASES[case]
        b = _batcher(st, **kw)
        try:
            got = _run(b)
            assert b.stats["disagg_prefills"] == len(PROMPTS)
            if kw.get("prefill_stream"):
                assert b.stats["handoff_frames"] > 0
            _wait(lambda: _settled(b), "the engine lanes' release")
            b.pool.check_invariant()
        finally:
            b.close()
        if "kv_quant" in kw:
            assert got == st["jax_ring"](PROMPTS, **{
                k: v for k, v in kw.items() if k not in SAME_TOKENS})
        else:
            assert got == st["jax_ring"](PROMPTS)
            assert got == [st["ref"](p) for p in PROMPTS]

    def test_engine_prefix_cache_hit_equals_cold(self, setup):
        """Decode radix off, so a resubmission's only reuse is the
        engine's own prefix cache: it hits on every prompt with a full
        block before its last token, and the streams stay ``generate``'s
        (after tests/test_prefillpool.py)."""
        st = setup
        b = _batcher(st, prefill_lanes=4, prefill_stream=True,
                     prefill_prefix_blocks=16, prefix_cache=False)
        try:
            want = [st["ref"](p) for p in PROMPTS]
            assert _run(b) == want
            pe = b.executor.prefill_exec
            assert pe.prefix_hits == 0
            assert _run(b) == want
            assert pe.prefix_hits == sum(n > BS for n in LENS)
            b.pool.check_invariant()
        finally:
            b.close()

    @pytest.mark.parametrize("pool", ["bf16", "int8"])
    def test_speculative_ring_attaches_the_draft(self, setup, pool):
        """A speculative ring (a self-draft, K 3): the attach prefills
        the draft lane (``make_spec_attach``) — every draft kept — and
        the streams equal JAX's speculative disaggregated ring on the
        same pool (and, bf16, ``generate``)."""
        st = setup
        kw = {"spec_k": 3} if pool == "bf16" else {"spec_k": 3,
                                                   "kv_quant": "int8"}
        draft = {"draft_params": st["model"], "draft_cfg": st["cfg"]}
        b = _batcher(st, **draft, **kw)
        try:
            got = _run(b)
            assert b.stats["disagg_prefills"] == len(PROMPTS)
            assert b.stats["spec_accepted"] == b.stats["spec_drafted"] > 0
        finally:
            b.close()
        jb = JaxBatcher(st["jparams"], st["jcfg"], draft_params=st["jparams"],
                        draft_cfg=st["jcfg"], **_ring_kw(**kw))
        try:
            assert got == _run(jb)
        finally:
            jb.close()
        if pool == "bf16":
            assert got == [st["ref"](p) for p in PROMPTS]

    @pytest.mark.parametrize("lanes", [1, 2])
    def test_adapter_lanes(self, setup, lanes):
        """Adapter prompts prefill on the engine WITH their delta (the
        registry is shared): a mixed base/adapter burst equals JAX's
        disaggregated adapter ring on the same registry seeds."""
        st = setup
        reg = TQ.AdapterRegistry(st["cfg"], capacity=2, rank=4, device="cpu")
        jreg = JQ.AdapterRegistry(st["jcfg"], capacity=2, rank=4)
        for r in (reg, jreg):
            r.load("x", seed=7)
        wave = [(p, a) for p, a in zip(PROMPTS, ("x", None, "x", None))]
        b = _batcher(st, adapters=reg, prefill_lanes=lanes)
        jb = JaxBatcher(st["jparams"], st["jcfg"], adapters=jreg,
                        **_ring_kw(prefill_lanes=lanes))
        try:
            got = [h.result(timeout=120) for h in [
                b.submit(p, max_new_tokens=NEW, adapter=a) for p, a in wave]]
            want = [h.result(timeout=300) for h in [
                jb.submit(p, max_new_tokens=NEW, adapter=a)
                for p, a in wave]]
            assert b.stats["disagg_prefills"] == len(wave)
        finally:
            b.close()
            jb.close()
        assert got == want
        assert got[1] == st["ref"](PROMPTS[1])
        assert got[0] != st["ref"](PROMPTS[0])


# ---------------------------------------------------------------------------
# the lifecycle
# ---------------------------------------------------------------------------


class TestLifecycle:
    def test_prefix_hit_skips_the_engine(self, setup):
        st = setup
        b = _batcher(st)
        try:
            p = _prompt(20, 80)         # 2 full blocks + a tail of 4
            ref = st["ref"](p, 4)
            assert b.submit(p, max_new_tokens=4).result(timeout=60) == ref
            assert b.stats["disagg_prefills"] == 1
            cold = b.stats["prefill_tokens"]
            assert b.submit(p, max_new_tokens=4).result(timeout=60) == ref
            assert b.stats["disagg_prefills"] == 1      # no second trip
            assert 0 < b.stats["prefill_tokens"] - cold < len(p)
            assert b.pool.hit_rate() > 0
            b.pool.check_invariant()
        finally:
            b.close()

    def test_handoff_dropped_for_cancelled_request(self, setup):
        """A request cancelled while its prompt is away on the engine:
        the lane retires, the late result is dropped and its engine lane
        released, no block leaks."""
        st = setup
        b = _batcher(st)
        pe = b.executor.prefill_exec
        gate = threading.Event()
        pe.pause_gate = lambda: gate.wait(30)
        try:
            victim = b.submit(_prompt(33, 95), max_new_tokens=8)
            _wait(lambda: b._disagg_waiting, "the victim's handoff")
            victim.cancel()
            out = victim.result(timeout=60)
            assert out == _prompt(33, 95)       # resolved at its prompt
            gate.set()
            _wait(lambda: _settled(b), "the dropped handoff's release")
            b.pool.check_invariant()
            assert sum(r is not None for r in b.lane) == 0
            assert b.stats["disagg_prefills"] == 0
            p = _prompt(9, 96)
            assert b.submit(p, max_new_tokens=4).result(
                timeout=60) == st["ref"](p, 4)
        finally:
            gate.set()
            b.close()

    def test_chaos_exactly_once_and_pool_invariant(self, setup):
        """After tests/test_prefill_modes.py's chaos case: a dispatch
        failure with a handoff in flight, a NaN lane, a client drop and
        a drain with queued work in one ring's lifetime — every request
        resolves exactly one way, the pool partition holds after each,
        survivors are ``generate``'s."""
        st = setup
        new = 8
        prompts = [_prompt(13, 100 + i) for i in range(4)]
        refs = [st["ref"](p, new) for p in prompts]

        def resolve(handle):
            try:
                return "ok", handle.result(timeout=120)
            except LaneQuarantined as e:
                return "quarantined", e
            except (ShuttingDown, RetriableError) as e:
                return "retriable", e

        b = _batcher(st, block_size=16, prefill_buckets=(16, MAX_LEN),
                     resilience=RingResilience(watchdog=False, nan_check=True,
                                               max_restarts=4,
                                               backoff_base_s=0.05))
        outcomes = {"ok": 0, "retriable": 0, "quarantined": 0}
        try:
            kind, out = resolve(b.submit(prompts[0], max_new_tokens=new))
            assert kind == "ok" and out == refs[0]
            outcomes["ok"] += 1
            inj = ChaosInjector("", seed=7).install(b)
            nxt = inj.dispatches
            inj.events[nxt] = [ChaosEvent("dispatch_fail", nxt)]
            for h, ref in zip([b.submit(p, max_new_tokens=new)
                               for p in prompts[:2]], refs[:2]):
                kind, out = resolve(h)
                outcomes[kind] += 1
                assert kind in ("retriable", "ok")
                assert kind != "ok" or out == ref
            assert b.stats["watchdog_restarts"] == 1
            b.pool.check_invariant()
            nxt = inj.dispatches
            inj.events[nxt] = [ChaosEvent("nan_lane", nxt, 0)]
            got = [resolve(h) for h in [b.submit(p, max_new_tokens=new)
                                        for p in prompts[:2]]]
            assert sorted(k for k, _ in got) == ["ok", "quarantined"]
            for (kind, out), ref in zip(got, refs[:2]):
                outcomes[kind] += 1
                assert kind != "ok" or out == ref
            b.pool.check_invariant()
            nxt = inj.dispatches
            inj.events[nxt + 1] = [ChaosEvent("client_drop", nxt + 1)]
            kind, out = resolve(b.submit(prompts[2], max_new_tokens=new))
            assert kind == "ok" and out == refs[2][:len(out)]
            outcomes["ok"] += 1
            hs = [b.submit(p, max_new_tokens=new) for p in prompts]
            b.drain(budget_s=60.0)
            for h, ref in zip(hs, refs):
                kind, out = resolve(h)
                outcomes[kind] += 1
                assert kind != "ok" or out == ref[:len(out)]
            b.pool.check_invariant()
            assert sum(outcomes.values()) == 1 + 2 + 2 + 1 + len(prompts)
        finally:
            b.close()

    def test_admission_order_fifo(self, setup):
        """slots=1: queued requests resolve strictly in submission order
        — recorded on the ring's thread where each resolves, not by
        threads racing to append."""
        st = setup
        b = _batcher(st, slots=1)
        order = []
        real = b._finish

        def finish(req, error=None):
            if not req.done.is_set():
                order.append(req.request_id)
            real(req, error)

        b._finish = finish
        try:
            hs = [b.submit(_prompt(12, 30 + i), max_new_tokens=4,
                           request_id=str(i)) for i in range(3)]
            for h in hs:
                h.result(timeout=60)
            assert order == ["0", "1", "2"]
        finally:
            b.close()

    def test_deadline_and_cancel_while_away(self, setup):
        """A lane whose deadline passes, or which is cancelled, while its
        prompt is away resolves with its own prompt (no earlier
        occupant's tokens), and the freed lane serves normally."""
        st = setup
        b = _batcher(st, slots=1)
        pe = b.executor.prefill_exec
        gate = threading.Event()
        try:
            pa = _prompt(6, 80)
            assert b.submit(pa, max_new_tokens=6).result(
                timeout=60) == st["ref"](pa, 6)
            pe.pause_gate = lambda: gate.wait(30)
            pb = _prompt(33, 81)
            h = b.submit(pb, max_new_tokens=8, deadline_s=0.2)
            assert h.result(timeout=60) == pb and h.deadline_exceeded
            h = b.submit(pb, max_new_tokens=8)
            _wait(lambda: b._disagg_waiting, "the handoff")
            h.cancel()
            assert h.result(timeout=60) == pb
            gate.set()
            _wait(lambda: _settled(b), "the releases")
            pe.pause_gate = None
            assert b.submit(pb, max_new_tokens=8).result(
                timeout=60) == st["ref"](pb, 8)
            b.pool.check_invariant()
        finally:
            gate.set()
            b.close()

    def test_drain_finishes_a_lane_away_on_the_engine(self, setup):
        st = setup
        b = _batcher(st)
        p = _prompt(20, 60)
        hs = [b.submit(p, max_new_tokens=6) for _ in range(2)]
        _wait(lambda: b.stats["admitted"] == 2, "both admissions")
        b.drain(budget_s=60.0)
        for h in hs:
            assert h.result(timeout=10) == st["ref"](p, 6)
        with pytest.raises((ShuttingDown, RuntimeError)):
            b.submit(p, max_new_tokens=2)
        assert b.pool.blocks_free() + b.pool.blocks_cached() \
            == b.pool.num_blocks

    def test_heal_and_swap_with_the_engine_mid_job(self, setup):
        """A dispatch fault heals the ring while the engine holds a job:
        the handoff of the failed request is dropped, its lane released,
        and the rebuilt ring serves ``generate``'s stream.  Then a weight
        swap re-stamps the engine's model: cold prompts prefill on the
        NEW weights."""
        st = setup
        b = _batcher(st, prefill_lanes=2, resilience=RingResilience(
            watchdog=False, max_restarts=3, backoff_base_s=0.05))
        pe = b.executor.prefill_exec
        gate = threading.Event()
        try:
            p = _prompt(12, 70)
            assert b.submit(p, max_new_tokens=8).result(
                timeout=60) == st["ref"](p, 8)
            q = _prompt(20, 71)
            resident = b.submit(p, max_new_tokens=40)
            _wait(lambda: any(r is not None and i not in b._disagg_waiting
                              for i, r in enumerate(b.lane)), "a resident")
            pe.pause_gate = lambda: gate.wait(30)
            away = b.submit(q, max_new_tokens=8)
            _wait(lambda: b._disagg_waiting, "the handoff")
            inj = ChaosInjector("").install(b)
            nxt = inj.dispatches
            inj.events[nxt] = [ChaosEvent("dispatch_fail", nxt)]
            for h in (resident, away):
                with pytest.raises(RetriableError):
                    h.result(timeout=60)
            gate.set()
            pe.pause_gate = None
            _wait(lambda: _settled(b), "the healed ring's releases")
            assert b.stats["watchdog_restarts"] == 1
            assert b.submit(q, max_new_tokens=8).result(
                timeout=60) == st["ref"](q, 8)
            # the swap: seed-1 weights, converted from JAX's
            jmodel, _ = jax_make_model("tiny", dtype=jnp.float32)
            jp1 = jmodel.init(jax.random.PRNGKey(1),
                              jnp.zeros((1, 8), jnp.int32))["params"]
            m1 = Llama(st["cfg"], "cpu")
            m1.load_state_dict(params_from_jax(jax.device_get(jp1)))
            m1.requires_grad_(False)
            b.swap_weights(m1)
            assert pe.params is m1
            r = _prompt(17, 72)
            assert b.submit(r, max_new_tokens=6).result(
                timeout=60) == st["ref"](r, 6, params=jp1)
            b.pool.check_invariant()
        finally:
            gate.set()
            b.close()

    @pytest.mark.parametrize("lanes", [1, 2])
    def test_snapshot_lane_reused_only_after_its_copy(self, setup, lanes):
        """The snapshot-lifetime rule.  The engine writes its pool in
        place, so a lane may take the next job only after the ring has
        copied its last one: with the ring's handoff drain paused, the
        engine finishes one job per lane and waits — the queued job's
        prefill does NOT run over the unreleased lane (its result is
        never posted).  Released, both streams equal ``generate``."""
        st = setup
        b = _batcher(st, prefill_lanes=lanes, slots=lanes + 1)
        pe = b.executor.prefill_exec
        gate = threading.Event()
        # the ring's drain stops at the first result it would land
        b.handoff_gate = lambda: (gate.wait(30) if not pe.results.empty()
                                  else None)
        try:
            prompts = [_prompt(21, 40 + i) for i in range(lanes + 1)]
            hs = [b.submit(p, max_new_tokens=6) for p in prompts]
            _wait(lambda: pe.results.qsize() >= lanes
                  and pe.lane_waits > 0, "the engine waiting on a lane")
            time.sleep(0.2)
            # one terminal item per lane; the last job is still waiting
            assert sum(not isinstance(i[0], str) or i[0] == "final"
                       for i in list(pe.results.queue)) == lanes
            assert len(pe._held) == lanes
            gate.set()
            got = [h.result(timeout=60) for h in hs]
            assert got == [st["ref"](p) for p in prompts]
            _wait(lambda: _settled(b), "the releases")
        finally:
            gate.set()
            b.close()

    def test_warm_runs_each_engine_shape(self, setup):
        """The engine's warm-up (what the ring's prewarm runs on the
        card) runs its programs once on either engine shape and leaves no
        result, no held lane, and the engine serving."""
        st = setup
        for lanes in (1, 3):
            pe = X.PrefillExecutor(st["model"], st["cfg"], max_len=MAX_LEN,
                                   block_size=BS, buckets=(16, MAX_LEN),
                                   lanes=lanes, kv_quant="int8")
            try:
                pe.warm()
                assert pe.results.empty() and not pe._held
            finally:
                pe.close()
        b = _batcher(st, prewarm=True)
        try:
            assert b.prewarmed.wait(60) and b.prewarm_error is None
            assert _run(b, PROMPTS[:1]) == [st["ref"](PROMPTS[0])]
        finally:
            b.close()

    @pytest.mark.parametrize("lanes", [1, 4])
    def test_statusz_keys_equal_jax(self, setup, lanes):
        """The prefill keys of ``serving_status`` after the same traffic
        on the port's ring and JAX's (the occupancy and head-of-line
        wait are timing, so only their presence and range)."""
        st = setup
        kw = {"prefill_lanes": lanes, "prefill_stream": lanes > 1}
        b = _batcher(st, **kw)
        jb = JaxBatcher(st["jparams"], st["jcfg"], **_ring_kw(**kw))
        try:
            _run(b)
            _run(jb)
            got, want = b.serving_status(), jb.serving_status()
        finally:
            b.close()
            jb.close()
        for key in ("prefillMode", "prefillQueueDepth", "prefillLanes",
                    "handoffFrames", "remotePrefills",
                    "chunkedPrefillTokenShare"):
            assert got[key] == want[key], key
        for key in ("prefillBatchOccupancy", "prefillHolWaitMs",
                    "overlappedFrames"):
            assert key in got and got[key] >= 0
        assert 0 < got["prefillBatchOccupancy"] <= 1
        assert set(want) - set(got) <= {"specK"} or set(want) <= set(got) | {
            "specK"}


# ---------------------------------------------------------------------------
# the env
# ---------------------------------------------------------------------------


class TestEnv:
    def test_disagg_knobs_read_as_jax_reads_them(self):
        env = {"SERVE_CONTINUOUS": "1", "SERVE_PREFILL": "disagg",
               "SERVE_PREFILL_LANES": "4", "SERVE_PREFILL_STREAM": "1",
               "SERVE_PREFILL_PREFIX_BLOCKS": "32",
               "SERVE_PREFILL_CHUNK": "128"}
        S.refuse_unported(env)
        kw = S.ring_kw_from_env(env)
        assert kw["prefill_mode"] == "disagg" and kw["paged"] is True
        assert (kw["prefill_lanes"], kw["prefill_stream"],
                kw["prefill_prefix_blocks"], kw["prefill_chunk"]) == (
            4, True, 32, 128)
        kw = S.ring_kw_from_env({"SERVE_PREFILL": "disagg"})
        assert (kw["prefill_lanes"], kw["prefill_stream"],
                kw["prefill_prefix_blocks"]) == (1, False, 0)
        assert "prefill_lanes" not in S.ring_kw_from_env(
            {"SERVE_PREFILL": "chunked"})

    @pytest.mark.parametrize("knob", [{"SERVE_KV_MIGRATE": "1"},
                                      {"SERVE_KV_PEER_FETCH": "1"},
                                      {"SERVE_KV_BROKER": "127.0.0.1:9100"},
                                      {"SERVE_TP": "2"}])
    def test_fleet_kv_and_tp_still_refused_by_name(self, knob):
        env = {"SERVE_CONTINUOUS": "1", "SERVE_PREFILL": "disagg",
               "SERVE_PREFILL_REMOTE": "1",
               "SERVE_PREFILL_BROKER": "127.0.0.1:9000", **knob}
        (name, _), = knob.items()
        with pytest.raises(ValueError, match=name) as e:
            S.refuse_unported(env)
        assert "SERVE_PREFILL" not in str(e.value)

    def test_remote_client_from_env(self):
        assert PS.remote_prefill_client_from_env({}) is None
        assert PS.remote_prefill_client_from_env(
            {"SERVE_PREFILL_REMOTE": "1"}) is None
        c = PS.remote_prefill_client_from_env(
            {"SERVE_PREFILL_REMOTE": "1", "SERVE_PREFILL_STREAM": "1",
             "SERVE_PREFILL_BROKER": "10.0.0.1:8800/",
             "SERVE_PREFILL_PEERS": "a:1, b:2"})
        try:
            assert c.broker == "10.0.0.1:8800" and c.stream
            assert c.peers == ["a:1", "b:2"] and c.remote
        finally:
            c.close()

    def test_handoff_fingerprint_equals_jax(self, setup):
        st = setup
        kw = dict(block_size=16, kv_quant="int8", top_k=40, top_p=0.9,
                  wquant="int8", generation=3)
        assert PS.handoff_fingerprint(st["cfg"], **kw) == \
            JPS.handoff_fingerprint(st["jcfg"], **kw)
        b = _batcher(st, top_k=5, generation=2)
        jb = JaxBatcher(st["jparams"], st["jcfg"],
                        **_ring_kw(top_k=5, generation=2))
        try:
            assert b.handoff_fingerprint() == jb.handoff_fingerprint()
        finally:
            b.close()
            jb.close()
