"""The torch package's fleet-level KV held against the JAX package
(tests/test_fleetkv.py), on converted ``tiny`` f32 params (the JAX
``PRNGKey(0)`` tree) and prompts seeded from numpy:

- the lane envelope: ``encode_lane`` of both packages writes the same
  bytes for the same meta and arrays (bf16, int8 with scales and tails,
  speculative, adapter), each package decodes the other's, and both
  refuse the same broken envelopes (every truncation, version skew, CRC,
  missing meta and k/v, fingerprint) with their ``EnvelopeError``; the
  port's ``key`` is ``jax.random.PRNGKey(seed)``; a live int8 lane's
  never-committed frontier block carries scale 0.0, as JAX's does;
- ``adopt`` refuses what JAX's refuses (a foreign fingerprint, a wrong
  payload shape, a zero budget, missing int8 planes, a missing draft
  lane, an unknown adapter) and touches no lane; a valid envelope's
  deadline re-anchors;
- drain-by-migration through the wire codec: a port lane resumes on a
  port ring with JAX's tokens (bf16 and int8 pools, megastep 1 and 4, a
  speculative lane, an adapter lane) while the origin's handle raises
  ``LaneMigrated``; a port lane adopted by a JAX ``ContinuousBatcher``
  and a JAX lane adopted by a port ring give the same tokens; every
  adopter's pool passes ``check_invariant``; a lane parked past
  ``migrate_parked_s`` is offered out;
- peer prefix fetch port->port, JAX->port and port->JAX: a prompt
  demoted on one ring admits on a cold one through host hits, with the
  stream of the exporter's own host hit of the same bytes (and, exported
  by the port from the exact pool, of a cold admission), and the counters
  move; the export under
  concurrent slot reuse returns whole old bytes or 204, never torn ones;
- over HTTP: the routes answer as the JAX ring server's do, the
  unchanged JAX router brokers a migration from a draining port replica
  to a JAX replica and back (a torch variant of ``router/simfleet.py``,
  :class:`TorchSimFleet`, lives in this file: the port must not import
  the router), the client's retry with the same ``request_id`` collects
  the unmigrated oracle's tokens; under ``TPUJOB_WIRE_CHAOS`` on
  ``replica-broker`` (drop, burst503) the lane finishes at its origin
  and runs nowhere else; two port replicas fetch prefixes from each
  other through ``SERVE_KV_PEERS``;
- the operator's contract: the pod env ``controller/builders.py``
  derives for ``kvMigration``, ``peerPrefixFetch`` and ``migrateParkedS``
  boots the port's server through ``serve.main``'s wiring, and each knob
  reaches the ring.

Run on the CPU: ``JAX_PLATFORMS=cpu python -m pytest
tests/test_torch_fleetkv.py -q``.
"""

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

from paddle_operator_tpu_torch.convert import params_from_jax
from paddle_operator_tpu_torch.infer import executor as X
from paddle_operator_tpu_torch.infer import qos as TQ
from paddle_operator_tpu_torch.infer import serve as S
from paddle_operator_tpu_torch.infer.batcher import ContinuousBatcher
from paddle_operator_tpu_torch.infer.resilience import (
    LaneMigrated,
    ShuttingDown,
)
from paddle_operator_tpu_torch.models.llama import Llama, make_model
from paddle_operator_tpu_torch.utils import fleetkv as FK
from paddle_operator_tpu_torch.utils import wirechaos as WC

MAX_LEN = 64
BS = 8
CH = 4
NEW = 24
RANK = 4
ADAPTER_SEED = 5
PROMPT = list(range(1, 13))


@pytest.fixture(scope="module")
def setup():
    from paddle_operator_tpu.infer import decode as JD
    from paddle_operator_tpu.infer.batcher import (
        ContinuousBatcher as JaxBatcher,
    )
    from paddle_operator_tpu.models.llama import Llama as JaxLlama
    from paddle_operator_tpu.models.llama import make_model as jmake

    jmodel, jcfg = jmake("tiny", dtype=jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, 8), jnp.int32))["params"]
    jdcfg = jcfg.draft()
    jdparams = JaxLlama(jdcfg).init(jax.random.PRNGKey(1),
                                    jnp.zeros((1, 8), jnp.int32))["params"]
    model, cfg = make_model("tiny", device="cpu", dtype=torch.float32)
    model.load_state_dict(params_from_jax(jax.device_get(jparams)))
    model.requires_grad_(False)
    dcfg = cfg.draft()
    dmodel = Llama(dcfg, "cpu")
    dmodel.load_state_dict(params_from_jax(jax.device_get(jdparams)))
    dmodel.requires_grad_(False)
    st = {"jcfg": jcfg, "jparams": jparams, "jdcfg": jdcfg,
          "jdparams": jdparams, "cfg": cfg, "model": model, "dcfg": dcfg,
          "dmodel": dmodel, "JaxBatcher": JaxBatcher}
    refs = {}

    def ref(prompt, new, leg="bf16"):
        """JAX's greedy stream for the request, memoized: ``generate``
        (the exact pool, a speculative lane), the JAX int8 ring (the
        int8 pool), the JAX adapter ring (an adapter lane)."""
        key = (tuple(prompt), new, leg)
        if key not in refs:
            if leg in ("bf16", "spec"):
                refs[key] = np.asarray(JD.generate(
                    jparams, jcfg, jnp.asarray([prompt], jnp.int32),
                    max_new_tokens=new, max_len=MAX_LEN)[0]).tolist()
            else:
                b = _jax_ring(st, leg)
                try:
                    refs[key] = b.submit(
                        prompt, max_new_tokens=new,
                        **({"adapter": "t1"} if leg == "adapter" else {})
                    ).result(timeout=300)
                finally:
                    b.close()
        return refs[key]

    st["ref"] = ref
    return st


def _ring_kw(leg="bf16", **kw):
    kw.setdefault("slots", 1)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("chunk_tokens", CH)
    kw.setdefault("prefill_buckets", (16, MAX_LEN))
    kw.setdefault("paged", True)
    kw.setdefault("block_size", BS)
    kw.setdefault("num_blocks", 16)
    if leg == "int8":
        kw["kv_quant"] = "int8"
    return kw


def _port_ring(st, leg="bf16", **kw):
    if leg == "spec":
        kw.update(draft_params=st["dmodel"], draft_cfg=st["dcfg"], spec_k=2)
    if leg == "adapter":
        reg = TQ.AdapterRegistry(st["cfg"], capacity=2, rank=RANK,
                                 device="cpu")
        reg.load("t1", seed=ADAPTER_SEED)
        kw["adapters"] = reg
    return ContinuousBatcher(st["model"], st["cfg"], **_ring_kw(leg, **kw))


def _jax_ring(st, leg="bf16", **kw):
    if leg == "spec":
        kw.update(draft_params=st["jdparams"], draft_cfg=st["jdcfg"],
                  spec_k=2)
    if leg == "adapter":
        from paddle_operator_tpu.infer.qos import AdapterRegistry

        reg = AdapterRegistry(st["jcfg"], capacity=2, rank=RANK)
        reg.load("t1", seed=ADAPTER_SEED)
        kw["adapters"] = reg
    return st["JaxBatcher"](st["jparams"], st["jcfg"],
                            **_ring_kw(leg, **kw))


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(1, 256, n).astype(
        np.int32).tolist()


def _throttle(b, delay=0.03):
    """Slow every dispatch of ring ``b`` (the port's ``executor.replay``
    seam, the JAX ring's ``_step``/``_spec_step``), so a drain lands
    mid-generation at any machine speed."""
    if isinstance(b, ContinuousBatcher):
        owner, name = b.executor, "replay"
    else:
        owner, name = b, ("_spec_step" if b.spec_k else "_step")
    real = getattr(owner, name)

    def slow(*a, **k):
        time.sleep(delay)
        return real(*a, **k)

    setattr(owner, name, slow)


def _wait(pred, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.002)


def _drain_by_migration(origin, adopt, *, port_origin, new=NEW, rid="m/row0",
                        chunks=2, submit_kw=None):
    """Submit one request on ``origin``, drain it once ``chunks``
    dispatches were made, and hand each offered lane through the wire
    codec of ``origin``'s package to ``adopt(buf)``.  Returns the
    origin's handle, the adopted handle and the meta that travelled."""
    enc = FK.encode_lane
    if not port_origin:
        from paddle_operator_tpu.utils import fleetkv as JFK

        enc = JFK.encode_lane
    got = {}

    def migrate_out(meta, spill):
        got["meta"] = meta
        got["handle"] = adopt(enc(meta, spill))
        return True

    origin.migrate_out = migrate_out
    origin._migrate_on_drain = True
    _throttle(origin)
    h = origin.submit(PROMPT, max_new_tokens=new, request_id=rid,
                      **(submit_kw or {}))
    _wait(lambda: origin.stats["chunks"] >= chunks, "no dispatch")
    origin.drain(budget_s=60)
    assert "handle" in got, f"nothing migrated: {h.error!r}"
    return h, got["handle"], got["meta"]


def _port_adopt(b):
    def adopt(buf):
        meta, spill = FK.decode_lane(buf)
        return b.adopt(meta, spill)
    return adopt


def _jax_adopt(b):
    from paddle_operator_tpu.utils import fleetkv as JFK

    def adopt(buf):
        meta, spill = JFK.decode_lane(buf)
        return b.adopt(meta, spill)
    return adopt


def _close(*rings):
    for r in rings:
        if r._thread.is_alive():
            r.close()


# ---------------------------------------------------------------------------
# The lane envelope: bytes and refusals against the JAX codec
# ---------------------------------------------------------------------------


def _lane_arrays(leg, layers=2, heads=2, bs=BS, d=16, m=2, seed=0):
    """Numpy arrays of a spill (JAX layouts) for ``leg``."""
    rng = np.random.default_rng(seed)
    shape = (layers, m, heads, bs, d)
    if leg == "int8":
        arr = {"k": rng.integers(-127, 128, shape).astype(np.int8),
               "v": rng.integers(-127, 128, shape).astype(np.int8),
               "ks": rng.random(shape[:3]).astype(np.float32),
               "vs": rng.random(shape[:3]).astype(np.float32),
               "kt": rng.standard_normal((layers, heads, bs, d)).astype(
                   np.float32),
               "vt": rng.standard_normal((layers, heads, bs, d)).astype(
                   np.float32)}
        arr["ks"][:, -1] = 0.0          # a frontier block never committed
        arr["vs"][:, -1] = 0.0
        return arr
    arr = {"k": rng.standard_normal(shape).astype(np.float32),
           "v": rng.standard_normal(shape).astype(np.float32)}
    if leg == "spec":
        arr["dk"] = rng.standard_normal((1, 1, 80, 16)).astype(np.float32)
        arr["dv"] = rng.standard_normal((1, 1, 80, 16)).astype(np.float32)
    return arr


def _lane_meta(leg, seed=5, rid="r/row0"):
    return {"requestId": rid, "prompt": [1, 2, 3], "out": [9, 4],
            "left": 5, "maxNew": 7, "temperature": 0.0, "seed": seed,
            "eos": None, "priority": 1,
            "adapter": "t1" if leg == "adapter" else None,
            "deadlineS": None, "trace": None,
            "fingerprint": {"layers": 2, "kvHeads": 2, "headDim": 16,
                            "blockSize": BS,
                            "quant": "int8" if leg == "int8" else "none",
                            "specK": 2 if leg == "spec" else 0,
                            "generation": 0}}


def _spills(leg, seed=5):
    """The same lane as a JAX spill (``key``, numpy) and a port spill
    (``seed``, CPU tensors; bf16 rows as torch bf16)."""
    import ml_dtypes

    arr = _lane_arrays(leg)
    if leg == "bf16":
        arr = {k: a.astype(ml_dtypes.bfloat16) for k, a in arr.items()}
    scal = {"pos": 13, "tok": 77, "temp": 0.0, "n_blocks": 2}
    if leg == "spec":
        scal["dpos"] = 12
    jspill = dict(scal, key=np.asarray(jax.random.PRNGKey(seed)), **arr)

    def tensor(a):
        if a.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(a.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(a.copy())

    tspill = dict(scal, seed=seed, **{k: tensor(a) for k, a in arr.items()})
    if leg == "adapter":
        tspill["aid"] = 1       # a replica-local slot: never travels
        jspill["aid"] = 1
    return jspill, tspill


LEGS = ["bf16", "f32", "int8", "spec", "adapter"]


class TestLaneEnvelope:
    @pytest.mark.parametrize("seed", [0, 1, 5, 123456789, 2 ** 31 - 1])
    def test_key_is_jax_prngkey(self, seed):
        assert FK.lane_key(seed) == [
            int(x) for x in np.asarray(jax.random.PRNGKey(seed))]

    @pytest.mark.parametrize("leg", LEGS)
    def test_bytes_equal_jax_both_ways(self, leg):
        from paddle_operator_tpu.utils import fleetkv as JFK

        jspill, tspill = _spills(leg)
        meta = _lane_meta(leg)
        jbuf = JFK.encode_lane(meta, jspill)
        tbuf = FK.encode_lane(meta, tspill)
        assert tbuf == jbuf
        # each package decodes the other's bytes into its own spill
        m2, s2 = FK.decode_lane(jbuf)
        assert m2 == JFK.decode_lane(jbuf)[0]
        assert s2["seed"] == 5 and s2["key"].tolist() == jspill[
            "key"].tolist()
        jm, js = JFK.decode_lane(tbuf)
        for name in FK._LANE_ARRAYS:
            if name not in jspill:
                assert name not in s2 and name not in js
                continue
            want = np.asarray(jspill[name])
            assert js[name].tobytes() == want.tobytes()
            got = s2[name]
            raw = (got.view(torch.int16) if got.dtype == torch.bfloat16
                   else got).numpy()
            assert raw.tobytes() == want.tobytes()
        assert "aid" not in s2 and "aid" not in js
        # the seed comes back from the key when the meta lacks it
        del meta["seed"]
        assert FK.decode_lane(FK.encode_lane(meta, tspill))[1]["seed"] == 5

    def test_every_refusal_matches_jax(self):
        from paddle_operator_tpu.utils import fleetkv as JFK

        jspill, tspill = _spills("int8")
        meta = _lane_meta("int8")
        buf = FK.encode_lane(meta, tspill)
        cases = [buf[:cut] for cut in range(len(buf))]
        skew = bytearray(buf)
        skew[4] = FK.VERSION + 1
        flip = bytearray(buf)
        flip[-3] ^= 0xFF
        cases += [bytes(skew), bytes(flip), b"NOPE" + buf[4:],
                  FK.encode_envelope("prefix", meta, {})]
        for req_key in ("pos", "tok", "temp", "key", "nBlocks", "prompt",
                        "left"):
            m = dict(meta)
            m.update(FK.decode_lane(buf)[0])
            del m[req_key]
            cases.append(FK.encode_envelope(
                "lane", m, {k: tspill[k] for k in ("k", "v")}))
        cases.append(FK.encode_envelope("lane", FK.decode_lane(buf)[0],
                                        {"k": tspill["k"]}))
        for c in cases:
            with pytest.raises(JFK.EnvelopeError) as je:
                JFK.decode_lane(c)
            with pytest.raises(FK.EnvelopeError) as te:
                FK.decode_lane(c)
            assert str(te.value) == str(je.value)
        mine = dict(meta["fingerprint"], generation=1)
        for pkg in (FK, JFK):
            with pytest.raises(pkg.EnvelopeError, match="fingerprint"):
                pkg.check_fingerprint(meta, mine)

    @pytest.mark.parametrize("megastep", [1, 4])
    def test_live_int8_lane_carries_jax_scales(self, setup, megastep):
        """A live int8 lane offered at a drain, on the port's ring and on
        JAX's, same request: every block it maps that no completion has
        quantized yet (the frontier, and blocks mapped ahead for
        dispatches in flight) carries scale 0.0 in both envelopes, and
        the blocks both lanes completed agree (codes within one step,
        scales within rtol 1e-5: the int8 pool's documented
        difference)."""
        st = setup
        new = 52 if megastep > 1 else NEW
        offers = {}
        for kind, ring in (("port", _port_ring(st, "int8",
                                               megastep=megastep)),
                           ("jax", _jax_ring(st, "int8"))):
            try:
                ring.migrate_out = (lambda k: lambda meta, spill:
                                    offers.setdefault(k, (meta, spill))
                                    and False)(kind)
                ring._migrate_on_drain = True
                _throttle(ring)
                h = ring.submit(PROMPT, max_new_tokens=new,
                                request_id="q/row0")
                _wait(lambda: ring.stats["chunks"] >= 1, "no dispatch")
                ring.drain(budget_s=60)
                h.result(timeout=60)
            finally:
                _close(ring)
        done = {}
        for kind, (meta, spill) in offers.items():
            buf = FK.encode_lane(meta, spill)
            _, back = FK.decode_lane(buf)
            n_done = int(spill["pos"]) // BS
            for key in ("ks", "vs"):
                sc = np.asarray(back[key])
                assert (sc[:, n_done:] == 0.0).all(), (kind, key)
                assert (sc[:, :n_done] > 0).all(), (kind, key)
            done[kind] = (n_done, back)
        n = min(done["port"][0], done["jax"][0])
        assert n >= 1
        t, j = done["port"][1], done["jax"][1]
        for key in ("k", "v"):
            diff = (t[key][:, :n].to(torch.int16)
                    - torch.as_tensor(np.asarray(j[key][:, :n])).to(
                        torch.int16)).abs()
            assert int(diff.max()) <= 1
        for key in ("ks", "vs"):
            np.testing.assert_allclose(np.asarray(t[key][:, :n]),
                                       np.asarray(j[key][:, :n]),
                                       rtol=1e-5)


# ---------------------------------------------------------------------------
# adopt: the refusals
# ---------------------------------------------------------------------------


def _junk_lane(cfg, fp, m=1, left=1, **extra):
    shape = (cfg.n_layers, m, cfg.n_kv_heads, BS, cfg.head_dim)
    meta = dict(_lane_meta("bf16", rid="dl/row0"), fingerprint=fp,
                left=left)
    spill = {"pos": 5, "tok": 7, "temp": 0.0, "seed": 1,
             "key": np.asarray([0, 1], np.uint32), "n_blocks": m,
             "k": torch.zeros(shape), "v": torch.zeros(shape)}
    spill.update(extra)
    return meta, spill


def _as_jax(spill):
    return {k: (np.asarray(v) if isinstance(v, torch.Tensor) else v)
            for k, v in spill.items() if k != "seed"}


class TestAdopt:
    @pytest.mark.parametrize("leg", ["bf16", "int8", "spec", "adapter"])
    def test_refuses_mismatches_as_jax_does(self, setup, leg):
        """tests/test_fleetkv.py::TestLaneMigration::
        test_adopt_refuses_mismatches_loudly on both packages' rings:
        each broken lane raises ``EnvelopeError`` on both, no lane state
        changes, and a valid envelope's remaining deadline re-anchors."""
        from paddle_operator_tpu.utils import fleetkv as JFK

        st = setup
        cfg = st["cfg"]
        B, J = _port_ring(st, leg), _jax_ring(st, leg)
        try:
            fp = B._fingerprint()
            assert fp == J._fingerprint()
            cases = []
            meta, spill = _junk_lane(cfg, dict(fp, quant="fp8"))
            cases.append(("fingerprint", meta, spill))
            meta, spill = _junk_lane(cfg, fp)
            spill["k"] = torch.zeros(2, 1, 1, BS, 4)
            cases.append(("shape", meta, spill))
            cases.append(("budget",) + _junk_lane(cfg, fp, left=0))
            if leg == "int8":
                meta, spill = _junk_lane(cfg, fp)
                spill["k"] = spill["k"].to(torch.int8)
                spill["v"] = spill["v"].to(torch.int8)
                cases.append(("scale/tail", meta, spill))
            if leg == "spec":
                cases.append(("draft lane",) + _junk_lane(cfg, fp))
            if leg == "adapter":
                meta, spill = _junk_lane(cfg, fp)
                meta["adapter"] = "nope"
                cases.append(("unknown adapter", meta, spill))
            for what, meta, spill in cases:
                with pytest.raises(FK.EnvelopeError, match=what):
                    B.adopt(meta, spill)
                with pytest.raises(JFK.EnvelopeError):
                    J.adopt(meta, _as_jax(spill))
            assert B.stats["adopted_lanes"] == 0 and not B._parked
            assert B._adopt_q.empty() and all(r is None for r in B.lane)
            B.pool.check_invariant()
            if leg == "bf16":
                # a valid envelope's REMAINING deadline re-anchors here
                meta, spill = _junk_lane(cfg, fp)
                meta["deadlineS"] = 5.0
                t0 = time.monotonic()
                req = B.adopt(meta, spill)
                assert req.deadline is not None
                assert 0 < req.deadline - t0 <= 5.5
                req.cancel()        # resolve the junk lane
                req.result(timeout=60)
                B.pool.check_invariant()
                with pytest.raises(FK.EnvelopeError, match="dtype"):
                    B.adopt(*_junk_lane(cfg, fp, k=torch.zeros(
                        cfg.n_layers, 1, cfg.n_kv_heads, BS,
                        cfg.head_dim, dtype=torch.bfloat16)))
        finally:
            B.close()
            J.close()

    def test_draining_and_contiguous_refuse(self, setup):
        st = setup
        B = _port_ring(st)
        C = ContinuousBatcher(st["model"], st["cfg"],
                              **_ring_kw(paged=False))
        try:
            meta, spill = _junk_lane(st["cfg"], B._fingerprint())
            with pytest.raises(FK.EnvelopeError, match="paged"):
                C.adopt(meta, spill)
            B._draining = True
            with pytest.raises(ShuttingDown):
                B.adopt(meta, spill)
            assert B.stats["adopted_lanes"] == 0
        finally:
            B._draining = False
            B.close()
            C.close()


# ---------------------------------------------------------------------------
# Drain by migration, in process through the wire codec
# ---------------------------------------------------------------------------

MIGRATION_LEGS = [("bf16", 1), ("bf16", 4), ("int8", 1), ("int8", 4),
                  ("spec", 1), ("adapter", 1)]


class TestMigration:
    @pytest.mark.parametrize("leg,megastep", MIGRATION_LEGS,
                             ids=[f"{l}-megastep{m}"
                                  for l, m in MIGRATION_LEGS])
    def test_port_to_port_equals_jax(self, setup, leg, megastep):
        st = setup
        new = 52 if megastep > 1 else NEW
        sub = {"adapter": "t1"} if leg == "adapter" else {}
        A = _port_ring(st, leg, megastep=megastep)
        B = _port_ring(st, leg, megastep=megastep)
        try:
            h, adopted, meta = _drain_by_migration(
                A, _port_adopt(B), port_origin=True, new=new,
                chunks=1 if megastep > 1 else 2, submit_kw=sub)
            with pytest.raises(LaneMigrated):
                h.result(timeout=30)
            # the lane moved mid-stream, at a boundary
            assert 0 < len(meta["out"]) < new
            assert meta["left"] + len(meta["out"]) == new
            got = adopted.result(timeout=300)
            assert got == st["ref"](PROMPT, new, leg), "stream diverged"
            assert A.stats["lane_migrations"] == 1
            assert A.serving_status()["laneMigrations"] == 1
            assert B.stats["adopted_lanes"] == 1
            assert B.serving_status()["adoptedLanes"] == 1
            assert B.stats["restored_lanes"] == 1
            B.pool.check_invariant()
        finally:
            _close(A, B)

    @pytest.mark.parametrize("leg", ["bf16", "int8"])
    def test_port_lane_adopted_by_jax(self, setup, leg):
        st = setup
        A, J = _port_ring(st, leg), _jax_ring(st, leg)
        try:
            h, adopted, _ = _drain_by_migration(A, _jax_adopt(J),
                                                port_origin=True)
            with pytest.raises(LaneMigrated):
                h.result(timeout=30)
            assert adopted.result(timeout=300) == st["ref"](PROMPT, NEW,
                                                            leg)
            assert J.stats["adopted_lanes"] == 1
            J.pool.check_invariant()
        finally:
            _close(A, J)

    @pytest.mark.parametrize("leg", ["bf16", "int8"])
    def test_jax_lane_adopted_by_port(self, setup, leg):
        from paddle_operator_tpu.infer.resilience import (
            LaneMigrated as JaxLaneMigrated,
        )

        st = setup
        J, B = _jax_ring(st, leg), _port_ring(st, leg)
        try:
            h, adopted, _ = _drain_by_migration(J, _port_adopt(B),
                                                port_origin=False)
            with pytest.raises(JaxLaneMigrated):
                h.result(timeout=30)
            assert adopted.result(timeout=300) == st["ref"](PROMPT, NEW,
                                                            leg)
            assert B.stats["adopted_lanes"] == 1
            B.pool.check_invariant()
        finally:
            _close(J, B)

    def test_refused_migration_resumes_locally(self, setup):
        """A peer that refuses: the lane resumes at the origin with the
        unmigrated stream, is never offered again, and the drain waits
        for it."""
        st = setup
        A = _port_ring(st)
        offers = []
        try:
            A.migrate_out = lambda meta, spill: offers.append(meta) or False
            A._migrate_on_drain = True
            _throttle(A)
            h = A.submit(PROMPT, max_new_tokens=NEW, request_id="no/row0")
            _wait(lambda: A.stats["chunks"] >= 2, "no dispatch")
            A.drain(budget_s=60)
            assert h.result(timeout=60) == st["ref"](PROMPT, NEW)
            assert len(offers) == 1 and A.stats["lane_migrations"] == 0
            assert h.migrate_state == "failed"
        finally:
            _close(A)

    def test_parked_lane_offered_after_patience(self, setup):
        """``migrate_parked_s``: a preemption-parked lane that waited that
        long is offered out (and the adopter's stream is the unmigrated
        one); streams and id-less requests never are."""
        from paddle_operator_tpu_torch.infer.qos import QoSConfig

        st = setup
        A = _port_ring(st, qos=QoSConfig(priorities=2))
        B = _port_ring(st)
        got = {}

        def migrate_out(meta, spill):
            m, s = FK.decode_lane(FK.encode_lane(meta, spill))
            got[m["requestId"]] = B.adopt(m, s)
            return True

        try:
            _throttle(A, 0.05)
            A.migrate_out = migrate_out
            A.migrate_parked_s = 0.05
            h = A.submit(PROMPT, max_new_tokens=NEW, request_id="p/row0",
                         priority=1)
            _wait(lambda: A.stats["chunks"] >= 1, "no dispatch")
            urgent = A.submit(_prompt(9, 4), max_new_tokens=30, priority=0)
            with pytest.raises(LaneMigrated):
                h.result(timeout=120)
            assert got["p/row0"].result(timeout=300) == st["ref"](PROMPT,
                                                                  NEW)
            urgent.result(timeout=300)
            assert A.stats["preempted_lanes"] >= 1
            assert A.stats["lane_migrations"] == 1
            B.pool.check_invariant()
            A.pool.check_invariant()
        finally:
            _close(A, B)


# ---------------------------------------------------------------------------
# Peer prefix fetch, in process, every direction
# ---------------------------------------------------------------------------


def _demote(ring, prompt, filler):
    ring.submit(prompt, max_new_tokens=4).result(timeout=300)
    ring.submit(filler, max_new_tokens=4).result(timeout=300)
    assert ring.pool.stats["host_demotions"] >= 3


def _exporter(ring, port):
    """``peer_fetch`` over ``ring``'s export and its package's codec."""
    if port:
        enc = FK.encode_prefix
    else:
        from paddle_operator_tpu.utils import fleetkv as JFK

        enc = JFK.encode_prefix

    def fetch(tokens, ns):
        chunks, idx, payloads = ring.pool.export_host_chain(tokens, ns=0)
        if not idx:
            return None
        if not port:
            payloads = [{k: np.asarray(v) for k, v in p.items()}
                        for p in payloads]
        return enc({"fingerprint": ring._fingerprint()}, chunks, idx,
                   payloads)
    return fetch


class TestPeerFetch:
    @pytest.mark.parametrize("direction", ["port-port", "jax-port",
                                           "port-jax"])
    @pytest.mark.parametrize("leg", ["bf16", "int8"])
    def test_fetched_admission_equals_cold(self, setup, direction, leg):
        st = setup
        src_port = direction.startswith("port")
        dst_port = direction.endswith("port")
        kw = dict(num_blocks=8, host_cache_blocks=16)
        A = (_port_ring if src_port else _jax_ring)(st, leg, **kw)
        B = (_port_ring if dst_port else _jax_ring)(st, leg, **kw)
        try:
            P, Q = _prompt(24, 1), _prompt(56, 2)
            cold = A.submit(P, max_new_tokens=6).result(timeout=300)
            _demote(A, P, Q)
            B.peer_fetch = _exporter(A, src_port)
            got = B.submit(P, max_new_tokens=6,
                           request_id="pf/row0").result(timeout=300)
            # the exporter's own host hit reads the same bytes.  On the
            # int8 pool a hit reads codes where a cold prefill reads
            # exact rows, so a hit need not equal a cold admission there;
            # the JAX ring's own hit and cold runs of this prompt split
            # at a near tie of its first token in 1 of 2 runs under
            # ``-n 6`` (f32 rounding order), so the cold stream is the
            # bar where the port exported
            promoted = A.pool.stats["host_promotions"]
            hit = A.submit(P, max_new_tokens=6).result(timeout=300)
            assert A.pool.stats["host_promotions"] > promoted
            assert got == hit, "peer-fetched stream diverged"
            if leg == "bf16" and src_port:
                assert got == cold
            assert B.stats["peer_prefix_fetches"] == 1
            assert B.pool.stats["peer_blocks_imported"] >= 3
            assert B.pool.stats["host_promotions"] >= 3
            if dst_port:
                assert B.serving_status()["peerPrefixFetches"] == 1
            A.pool.check_invariant()
            B.pool.check_invariant()
        finally:
            _close(A, B)

    def test_export_matches_jax_manager(self, setup):
        """The same admit/publish/retire traffic on both packages'
        managers (host payload stubs): the same chunks and exported
        block indices."""
        from paddle_operator_tpu.infer.paged import (
            PagedCacheManager as JaxManager,
        )
        from paddle_operator_tpu_torch.infer.paged import PagedCacheManager

        outs = []
        for cls in (PagedCacheManager, JaxManager):
            m = cls(1, 64, 8, num_blocks=8, host_cache_blocks=8)
            m.demote_fetch = lambda blk: {"k": np.full((1,), blk),
                                          "v": np.full((1,), blk)}
            P = list(range(100, 124))
            m.admit(0, P)
            m.publish(0, P)
            m.retire(0)
            m.admit(0, list(range(900, 964)))
            m.retire(0)
            chunks, idx, payloads = m.export_host_chain(P + [5, 6])
            outs.append((chunks, idx, [p["k"].tolist() for p in payloads]))
            m.check_invariant()
        assert outs[0] == outs[1] and outs[0][1]


class TestExportUnderSlotReuse:
    """``/v1/kv/prefix`` runs on an HTTP thread while the ring thread
    evicts, promotes and reuses host slots.  A slot the ring takes back
    during an export's copy must never reach the importer torn: the
    export returns the whole old bytes, or nothing (204)."""

    @pytest.fixture()
    def demoted(self, setup):
        """A served port ring whose tier holds a prompt's demoted chain:
        ``(batcher, prompt, base url)``."""
        st = setup
        srv = S.make_server("127.0.0.1", 0, st["model"], st["cfg"],
                            continuous=True, **_ring_kw(
                                num_blocks=8, host_cache_blocks=16))
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        A = srv.generator.batcher
        P, Q = _prompt(24, 1), _prompt(56, 2)
        _demote(A, P, Q)
        yield A, P, f"http://127.0.0.1:{srv.server_address[1]}"
        srv.shutdown()
        srv.server_close()
        srv.generator.close()

    def _reuse_during(self, monkeypatch, A, key_of):
        """Make the export's slot wait run the ring's reuse of the slot:
        the payload leaves the tier (a promote), its slot goes back to
        the slab and a demote of another block refills it."""
        real = X.HostBlock.wait
        fired = []

        def wait(block):
            real(block)
            if fired:
                return
            fired.append(block.slot)
            pool, slab = A.pool, A.executor._slab
            key = key_of(block)
            assert pool.host.pop(key) is block
            block.release()
            held = []
            while True:
                nb = slab.acquire()
                if nb.slot == block.slot:
                    for view in nb.values():
                        view.fill_(7)       # another block's bytes
                    break
                held.append(nb)
            for other in held:
                other.release()
            nb.release()

        monkeypatch.setattr(X.HostBlock, "wait", wait)
        return fired

    def test_reused_slot_is_refused_not_torn(self, demoted, monkeypatch):
        A, P, _ = demoted
        before = A.pool.export_host_chain(P)
        assert before[1]
        keys = {id(A.pool.host.peek(k)): k for k in A.pool.host.keys()}
        fired = self._reuse_during(monkeypatch, A,
                                   lambda b: keys[id(b)])
        with pytest.raises(LookupError, match="left the tier"):
            A.pool.export_host_chain(P)
        assert fired

    def test_whole_old_bytes_when_untouched(self, demoted):
        A, P, _ = demoted
        chunks, idx, payloads = A.pool.export_host_chain(P)
        for j, p in zip(idx, payloads):
            key = None
            for k in A.pool.host.keys():
                if A.pool.entries[k].chunk == tuple(chunks[j]):
                    key = k
            live = A.pool.host.peek(key)
            for name, a in p.items():
                assert torch.equal(a, live[name])
                assert a.data_ptr() != live[name].data_ptr()

    def test_http_export_answers_204_under_reuse(self, demoted,
                                                 monkeypatch):
        A, P, url = demoted
        code, body = _post(url, "/v1/kv/prefix", {"tokens": P})
        assert code == 200
        meta, chunks, idx, payloads = FK.decode_prefix(body)
        assert meta["fingerprint"] == A._fingerprint() and idx
        keys = {id(A.pool.host.peek(k)): k for k in A.pool.host.keys()}
        self._reuse_during(monkeypatch, A, lambda b: keys[id(b)])
        code, body = _post(url, "/v1/kv/prefix", {"tokens": P})
        assert code == 204 and body == b""


# ---------------------------------------------------------------------------
# HTTP: the routes, the router-brokered fleet, wire chaos, static peers
# ---------------------------------------------------------------------------


def _post(url, path, body, timeout=60):
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    req = urllib.request.Request(url + path, data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=30) as r:
        return json.loads(r.read())


class _Replica:
    def __init__(self, kind, srv):
        self.kind = kind
        self.srv = srv
        self.endpoint = f"127.0.0.1:{srv.server_address[1]}"
        self.exit_code = None

    @property
    def batcher(self):
        return self.srv.generator.batcher


class TorchSimFleet:
    """The torch variant of ``router/simfleet.py``: REAL ring servers —
    the port's ``serve.make_server`` and the JAX package's, in this
    process, over the same tiny params — behind the unchanged JAX
    ``FleetRouter`` / ``make_router_server``, each replica wired for
    fleet-level KV as ``SERVE_KV_MIGRATE``/``SERVE_KV_PEER_FETCH`` with
    ``SERVE_KV_BROKER=<router>`` wire it (its own package's
    ``FleetKVClient``).  ``kinds`` names each replica's package;
    ``live`` the replicas the router routes to at first (the others join
    through :meth:`join`)."""

    def __init__(self, st, kinds=("port", "jax"), live=None, ring_kw=None,
                 wire_env=None):
        from paddle_operator_tpu.router.router import (
            FleetRouter,
            make_router_server,
        )

        self.st = st
        self.router = FleetRouter([], block_size=BS, affinity_blocks=2,
                                  scrape_interval=0.05)
        self.router_srv = make_router_server("127.0.0.1", 0, self.router)
        threading.Thread(target=lambda: self.router_srv.serve_forever(
            poll_interval=0.05), daemon=True).start()
        self.broker = f"127.0.0.1:{self.router_srv.server_address[1]}"
        self.url = f"http://{self.broker}"
        kw = _ring_kw(slots=2, host_cache_blocks=16, **(ring_kw or {}))
        self.replicas = []
        for kind in kinds:
            if kind == "port":
                srv = S.make_server("127.0.0.1", 0, st["model"], st["cfg"],
                                    continuous=True, job="sim/fleet",
                                    replica=str(len(self.replicas)), **kw)
            else:
                from paddle_operator_tpu.infer.serve import make_server

                srv = make_server("127.0.0.1", 0, st["jparams"], st["jcfg"],
                                  continuous=True, job="sim/fleet",
                                  replica=str(len(self.replicas)), **kw)
            threading.Thread(target=lambda s=srv: s.serve_forever(
                poll_interval=0.05), daemon=True).start()
            rep = _Replica(kind, srv)
            self.replicas.append(rep)
            self._wire(rep, wire_env or {})
        self.live = list(range(len(kinds)) if live is None else live)
        self.router.set_endpoints([self.replicas[i].endpoint
                                   for i in self.live])
        self.wait_ready()

    def _wire(self, rep, wire_env):
        env = {"SERVE_KV_MIGRATE": "1", "SERVE_KV_PEER_FETCH": "1",
               "SERVE_KV_BROKER": self.broker, "POD_IP": "127.0.0.1",
               **wire_env}
        port = rep.srv.server_address[1]
        if rep.kind == "port":
            S.wire_fleet_kv_from_env(rep.batcher, port, environ=env)
            return
        from paddle_operator_tpu.utils import fleetkv as JFK

        client = JFK.FleetKVClient(broker=self.broker,
                                   origin=rep.endpoint)
        b = rep.batcher
        b.migrate_out = (lambda meta, spill:
                         client.migrate_out(JFK.encode_lane(meta, spill)))
        b._migrate_on_drain = True
        b.peer_fetch = client.fetch_prefix

    def wait_ready(self, timeout=60.0):
        want = {self.replicas[i].endpoint for i in self.live}
        _wait(lambda: want <= {ep for ep, r in self.router.replicas.items()
                               if r.ready}, "fleet not ready", timeout)

    def join(self, idx):
        self.live.append(idx)
        self.router.set_endpoints([self.replicas[i].endpoint
                                   for i in self.live])
        self.wait_ready()

    def drain(self, idx, budget_s=60.0):
        """The scale-down protocol on replica ``idx`` (what a SIGTERM-ed
        pod runs through ``ServingDrain``): /readyz false, the ring
        drains — by migration here — and the server stops."""
        rep = self.replicas[idx]
        rep.srv.state.draining = True
        rep.batcher.drain(budget_s)
        rep.srv.shutdown()
        rep.srv.server_close()
        rep.exit_code = 83

    def post(self, payload, max_retries=30):
        import sys

        client_dir = os.path.join(os.path.dirname(__file__), "..",
                                  "client")
        if client_dir not in sys.path:
            sys.path.insert(0, client_dir)
        import client as client_cli

        return client_cli.post_generate(
            self.url, payload, max_retries=max_retries, backoff_base_s=0.05,
            backoff_max_s=0.5)

    def close(self):
        self.router_srv.shutdown()
        self.router_srv.server_close()
        self.router.close()
        for rep in self.replicas:
            if rep.exit_code is None:
                rep.srv.shutdown()
                rep.srv.server_close()
            try:
                rep.srv.generator.close()
            except Exception:
                pass


@pytest.fixture()
def ring_pair(setup):
    """A port ring server and a JAX ring server, same params and knobs."""
    from paddle_operator_tpu.infer.serve import make_server

    st = setup
    kw = _ring_kw(slots=2, host_cache_blocks=16)
    srvs = {"port": S.make_server("127.0.0.1", 0, st["model"], st["cfg"],
                                  continuous=True, **kw),
            "jax": make_server("127.0.0.1", 0, st["jparams"], st["jcfg"],
                               continuous=True, **kw)}
    for srv in srvs.values():
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    yield srvs, {k: f"http://127.0.0.1:{s.server_address[1]}"
                 for k, s in srvs.items()}
    for srv in srvs.values():
        srv.shutdown()
        srv.server_close()
        srv.generator.close()


class TestRoutes:
    @pytest.mark.parametrize("path,body", [
        ("/v1/kv/restore", b"\x00\x01"),
        ("/v1/kv/restore", b"TPKV"),
        ("/v1/kv/prefix", {"tokens": [1, 2]}),
        ("/v1/kv/prefix", {"tokens": list(range(1, 30)), "ns": 3}),
        ("/v1/kv/prefix", b"{not json"),
    ])
    def test_answers_as_jax(self, ring_pair, path, body):
        _, urls = ring_pair
        (pc, pb), (jc, jb) = (_post(urls[k], path, body)
                              for k in ("port", "jax"))
        assert pc == jc
        assert (pc == 204) == (pb == b"")

    def test_restore_adopts_and_statusz_moves(self, setup, ring_pair):
        """A port lane envelope posted to each ring server: 200
        ``{"adopted": rid}`` on both, a replay cancels the older handle,
        the client's generate with the row's id collects the adopted
        result, ``adoptedLanes`` moves; 409 for a fingerprint skew and
        503 while draining, as JAX's server answers."""
        st = setup
        srvs, urls = ring_pair
        A = _port_ring(st)
        bufs = []
        try:
            A.migrate_out = lambda meta, spill: bufs.append(
                FK.encode_lane(meta, spill)) or False
            A._migrate_on_drain = True
            _throttle(A)
            A.submit(PROMPT, max_new_tokens=NEW, request_id="h/row0")
            _wait(lambda: A.stats["chunks"] >= 2, "no dispatch")
            A.drain(budget_s=60)
        finally:
            _close(A)
        buf, = bufs
        meta = FK.decode_lane(buf)[0]
        skew = FK.encode_lane(dict(meta, fingerprint=dict(
            meta["fingerprint"], generation=9)), FK.decode_lane(buf)[1])
        for kind, url in urls.items():
            code, body = _post(url, "/v1/kv/restore", skew)
            assert code == 409, (kind, body)
            code, body = _post(url, "/v1/kv/restore", buf)
            assert (code, json.loads(body)) == (200, {"adopted": "h/row0"})
            old = srvs[kind].generator.adopted["h/row0"]
            assert _post(url, "/v1/kv/restore", buf)[0] == 200
            assert old._cancel
            code, body = _post(url, "/v1/generate", {
                "tokens": [PROMPT], "max_new_tokens": NEW,
                "request_id": "h"})
            assert code == 200, body
            assert json.loads(body)["tokens"] == [st["ref"](PROMPT, NEW)]
            assert _get(url, "/statusz")["adoptedLanes"] == 2
            srvs[kind].state.draining = True
            try:
                code, _ = _post(url, "/v1/kv/restore", buf)
                assert code == 503
            finally:
                srvs[kind].state.draining = False


def _migrate_over_router(st, origin_kind, adopter_kind):
    fleet = TorchSimFleet(st, kinds=(origin_kind, adopter_kind), live=[0])
    try:
        origin = fleet.replicas[0]
        _throttle(origin.batcher, 0.1)
        base = {"tokens": [PROMPT], "max_new_tokens": 40, "seed": 3}
        want = st["ref"](PROMPT, 40)
        result = {}

        def client():
            result["out"] = fleet.post(dict(base, request_id="mig-1"))

        t = threading.Thread(target=client)
        t.start()
        _wait(lambda: origin.batcher.stats["chunks"] >= 1, "not resident")
        fleet.join(1)
        fleet.drain(0)
        t.join(timeout=120)
        st_code, body = result["out"]
        assert st_code == 200, body
        assert body["tokens"] == [want]
        assert fleet.router.counters["migrations_brokered"] >= 1
        assert fleet.router.counters["routed_migrated"] >= 1
        assert origin.batcher.stats["lane_migrations"] == 1
        adopter = fleet.replicas[1].batcher
        assert adopter.stats["adopted_lanes"] == 1
        adopter.pool.check_invariant()
    finally:
        fleet.close()


class TestRouterBrokered:
    def test_port_to_jax(self, setup):
        _migrate_over_router(setup, "port", "jax")

    def test_jax_to_port(self, setup):
        _migrate_over_router(setup, "jax", "port")

    @pytest.mark.parametrize("fault", ["drop@0", "burst503@0:3"])
    def test_wire_chaos_falls_back_to_completion(self, setup, fault):
        """``TPUJOB_WIRE_CHAOS`` on the replica->broker edge: the offer
        never reaches the router, so the lane resumes at its origin and
        completes there with the oracle's tokens; the peer adopts
        nothing, so no lane runs twice."""
        st = setup
        # peer fetch off: the edge's first POST is the migration offer
        fleet = TorchSimFleet(st, kinds=("port", "port"), wire_env={
            "SERVE_KV_PEER_FETCH": "0",
            WC.WIRE_CHAOS_ENV: f"replica-broker={fault}"})
        try:
            origin = fleet.replicas[0]
            _throttle(origin.batcher, 0.05)
            url = f"http://{origin.endpoint}"
            result = {}

            def client():
                result["out"] = _post(url, "/v1/generate", {
                    "tokens": [PROMPT], "max_new_tokens": 40,
                    "request_id": "wc-1"}, timeout=120)

            t = threading.Thread(target=client)
            t.start()
            _wait(lambda: origin.batcher.stats["chunks"] >= 1,
                  "not resident")
            fleet.drain(0)
            t.join(timeout=120)
            code, body = result["out"]
            assert code == 200, body
            assert json.loads(body)["tokens"] == [st["ref"](PROMPT, 40)]
            assert origin.batcher.stats["lane_migrations"] == 0
            assert fleet.replicas[1].batcher.stats["adopted_lanes"] == 0
            assert fleet.router.counters["migrations_brokered"] == 0
            fired = [p.fired for p in WC.env_proxies()]
            assert any(fired), "no fault fired on the edge"
        finally:
            fleet.close()
            WC.close_env_proxies()


def test_static_peers_fetch_prefixes_both_ways(setup):
    """Two port replicas with ``SERVE_KV_PEERS`` naming each other and no
    router: a prompt demoted on one admits on the other through the
    peer's ``/v1/kv/prefix``, equal to its cold admission."""
    st = setup
    kw = _ring_kw(num_blocks=8, host_cache_blocks=16)
    srvs = [S.make_server("127.0.0.1", 0, st["model"], st["cfg"],
                          continuous=True, **kw) for _ in range(2)]
    for srv in srvs:
        threading.Thread(target=srv.serve_forever, daemon=True).start()
    eps = [f"127.0.0.1:{s.server_address[1]}" for s in srvs]
    try:
        for i, srv in enumerate(srvs):
            S.wire_fleet_kv_from_env(
                srv.generator.batcher, srv.server_address[1], environ={
                    "SERVE_KV_PEER_FETCH": "1", "POD_IP": "127.0.0.1",
                    "SERVE_KV_PEERS": ",".join(eps)})
        for src, dst, seed in ((0, 1, 1), (1, 0, 5)):
            P, Q = _prompt(24, seed), _prompt(56, seed + 1)
            a = srvs[src].generator.batcher
            cold = a.submit(P, max_new_tokens=6).result(timeout=300)
            _demote(a, P, Q)
            code, body = _post(f"http://{eps[dst]}", "/v1/generate", {
                "tokens": [P], "max_new_tokens": 6})
            assert code == 200 and json.loads(body)["tokens"] == [cold]
            b = srvs[dst].generator.batcher
            assert _get(f"http://{eps[dst]}", "/statusz")[
                "peerPrefixFetches"] == 1
            assert b.pool.stats["peer_blocks_imported"] >= 3
            b.pool.check_invariant()
    finally:
        for srv in srvs:
            srv.shutdown()
            srv.server_close()
            srv.generator.close()


# ---------------------------------------------------------------------------
# The operator's contract
# ---------------------------------------------------------------------------


def test_operator_pod_env_boots_with_fleet_kv(setup, monkeypatch):
    """The env ``controller/builders.py`` derives for a PaddleJob with
    ``kvMigration: true``, ``peerPrefixFetch: true`` and
    ``migrateParkedS: 5`` boots the port's replica through
    ``serve.main`` (on the CPU: the card check, the weight load, the
    signal handlers and the serving loop stubbed), and each knob reaches
    the ring."""
    import socket

    from paddle_operator_tpu.api import ServingSpec, TPUJob, TPUJobSpec
    from paddle_operator_tpu.controller.builders import construct_serve_pod
    from paddle_operator_tpu_torch.ft import preemption as FP
    from paddle_operator_tpu_torch.infer import resilience as R

    st = setup
    job = TPUJob(name="kj", namespace="default", spec=TPUJobSpec(
        serving=ServingSpec(
            replicas=2, block_size=BS, kv_migration=True,
            peer_prefix_fetch=True, host_cache_mb=1, migrate_parked_s=5,
            template={"spec": {"containers": [{
                "name": "m", "image": "torch:latest",
                "env": [{"name": "MODEL_PRESET", "value": "tiny"},
                        {"name": "SERVE_MAX_LEN", "value": "64"},
                        {"name": "SERVE_SLOTS", "value": "2"}]}]}})))
    pod = construct_serve_pod(job, 0)
    env = {e["name"]: e.get("value")
           for e in pod["spec"]["containers"][0]["env"]}
    assert env["SERVE_KV_MIGRATE"] == env["SERVE_KV_PEER_FETCH"] == "1"
    assert env["SERVE_MIGRATE_PARKED_S"] == "5"
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    # what kubelet fills in: the pod IP (a fieldRef) and the port
    env.update(POD_IP="127.0.0.1", TPUJOB_PORT=str(port))
    for key in list(os.environ):
        if key.startswith(("SERVE_", "TPUJOB_", "QUANTIZE", "MODEL_")):
            monkeypatch.delenv(key)
    for key, value in env.items():
        if value is not None:
            monkeypatch.setenv(key, value)
    booted = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "cpu")
    monkeypatch.setattr(S, "load_serving_params",
                        lambda path, cfg, device: (st["model"], st["cfg"],
                                                   False))
    monkeypatch.setattr(FP.PreemptionWatcher, "install",
                        classmethod(lambda cls, *a, **k: cls()))
    monkeypatch.setattr(R.ServingDrain, "install",
                        lambda self, watcher, sig=None: None)

    def until_drained(srv, drain):
        booted["srv"], booted["drain"] = srv, drain
        return 83

    monkeypatch.setattr(S, "serve_until_drained", until_drained)
    assert S.main() == 83
    srv = booted["srv"]
    try:
        b = srv.generator.batcher
        client = b.peer_fetch.__self__
        assert isinstance(client, FK.FleetKVClient)
        assert client.broker == env["SERVE_KV_BROKER"] == "kj-serve:8700"
        assert client.origin == f"127.0.0.1:{port}"
        assert b.migrate_out is not None and b._migrate_on_drain
        assert b.migrate_parked_s == 5.0
        assert b.pool is not None and b.pool.host is not None
        assert b.block_size == BS
        assert booted["drain"].batcher is b
        assert b.serving_status()["laneMigrations"] == 0
    finally:
        srv.server_close()
        srv.generator.close()
