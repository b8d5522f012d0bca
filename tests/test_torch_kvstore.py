"""The torch package's durable prefix store held against the JAX package
(tests/test_kvstore.py):

- the envelope (``utils/fleetkv.py``): byte-identical to the JAX
  package's for the same meta and arrays — f32, int8 and bfloat16, the
  last by the dtype name and read back as ``torch.bfloat16`` — decoded
  both ways, with no ``ml_dtypes`` and no JAX imported by the port;
- ``DirBackend`` and ``KVBlockStore`` (tests/test_kvstore.py's cases on
  the port): atomic writes, namespaces, touch, sweep, drop-oldest
  backpressure, fetch with ``skip`` and contiguity, refusal + deletion
  of truncated / corrupt / skewed / misnamed entries, the janitor and
  its CLI, the pool's spill and refill paths; ``flush`` is a condition
  wait that returns only once every offer is on disk;
- ``_fingerprint()`` equals the JAX ring's dict;
- rings on converted ``tiny`` f32 params, exact and int8 pools: a JAX
  ring spills to a directory and a port ring restarted on it serves the
  prefix with the tokens a JAX ring restarted on it serves, promoting
  the files' bytes; a port ring spills and JAX's
  ``KVBlockStore.fetch`` returns the port's payloads exactly, and a JAX
  ring restarted on it serves the port's cold tokens; the live ring
  re-probes its own spilled chain (flush and explicit waits, no
  sleeps); a full slab takes a slot back from the store's queue;
- on the card (``cuda``-marked, skipped here): a host hit and a store
  restart under CUDA graph replay keep the captured addresses and give
  the tier-off tokens.  The JAX package is imported only inside the
  fixtures and tests that need it, so the card's machine (JAX, no flax)
  can run that test.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from paddle_operator_tpu_torch.infer.batcher import ContinuousBatcher
from paddle_operator_tpu_torch.infer.kvstore import (
    DirBackend,
    KVBlockStore,
    parse_store_url,
)
from paddle_operator_tpu_torch.infer.paged import PagedCacheManager
from paddle_operator_tpu_torch.models.llama import make_model
from paddle_operator_tpu_torch.utils import fleetkv as FK
from paddle_operator_tpu_torch.utils.radixkey import chain_key

MAX_LEN = 64
BS = 8
QUANTS = ["none", "int8"]

FP = {"layers": 2, "kvHeads": 1, "headDim": 4, "blockSize": BS,
      "quant": "none", "specK": 0}


def _payload(seed=0):
    rng = np.random.default_rng(seed)
    return {"k": rng.standard_normal((2, 1, BS, 4)).astype(np.float32),
            "v": rng.standard_normal((2, 1, BS, 4)).astype(np.float32)}


def _store(tmp_path, fp=FP, **kw):
    return KVBlockStore(DirBackend(str(tmp_path)), fingerprint=fp, **kw)


def _put_chain(store, tokens, n_blocks, seed=10):
    keys, key = [], None
    for j in range(n_blocks):
        chunk = tuple(tokens[j * BS:(j + 1) * BS])
        key = chain_key(key, chunk)
        keys.append(key)
        store.offer(key, chunk, _payload(seed + j))
    assert store.flush(), "writer queue failed to drain"
    return keys


# ---------------------------------------------------------------------------
# The envelope against JAX's
# ---------------------------------------------------------------------------


def _arrays(seed):
    import ml_dtypes

    rng = np.random.default_rng(seed)
    f32 = rng.standard_normal((2, 1, 3, 8, 4)).astype(np.float32)
    codes = rng.integers(-127, 128, (2, 1, 3, 8, 4)).astype(np.int8)
    scales = rng.random((2, 1, 3)).astype(np.float32)
    bf = rng.standard_normal((2, 1, 3, 8, 4)).astype(np.float32)
    jax_side = {"k": f32, "v": codes, "ks": scales,
                "kt": bf.astype(ml_dtypes.bfloat16)}
    port_side = {"k": torch.from_numpy(f32), "v": torch.from_numpy(codes),
                 "ks": scales,
                 "kt": torch.from_numpy(bf).to(torch.bfloat16)}
    return jax_side, port_side


META = {"key": -1234567890123, "ns": 0, "chunk": list(range(8)),
        "fingerprint": dict(FP, generation=3)}


@pytest.mark.parametrize("seed", [0, 1])
def test_envelope_bytes_equal_jax(seed):
    from paddle_operator_tpu.utils import fleetkv as JFK

    jax_side, port_side = _arrays(seed)
    ours = FK.encode_envelope("kvblock", META, port_side)
    theirs = JFK.encode_envelope("kvblock", META, jax_side)
    assert ours == theirs
    hdr = FK.peek_header(ours)
    assert {m["name"]: m["dtype"] for m in hdr["arrays"]}["kt"] == \
        "bfloat16"
    assert hdr == JFK.peek_header(theirs)


def test_envelope_decodes_both_ways():
    from paddle_operator_tpu.utils import fleetkv as JFK

    jax_side, port_side = _arrays(2)
    kind, meta, got = FK.decode_envelope(
        JFK.encode_envelope("kvblock", META, jax_side))
    assert kind == "kvblock" and meta == META
    assert got["kt"].dtype == torch.bfloat16
    assert torch.equal(got["kt"], port_side["kt"])
    for name in ("k", "v", "ks"):
        assert np.array_equal(got[name].numpy(), jax_side[name])
    kind, meta, back = JFK.decode_envelope(
        FK.encode_envelope("kvblock", META, port_side))
    assert meta == META
    for name, want in jax_side.items():
        assert back[name].dtype == want.dtype
        assert np.array_equal(back[name].view(np.uint8),
                              want.view(np.uint8))


@pytest.mark.parametrize("cut", ["truncate", "crc", "magic", "version"])
def test_envelope_refusals(cut):
    blob = bytearray(FK.encode_envelope("kvblock", META, _arrays(0)[1]))
    if cut == "truncate":
        blob = blob[:-5]
    elif cut == "crc":
        blob[-3] ^= 0xFF
    elif cut == "magic":
        blob[0] ^= 0xFF
    else:
        blob[4] += 1
    with pytest.raises(FK.EnvelopeError):
        FK.decode_envelope(bytes(blob))


def test_port_store_imports_no_jax_and_no_ml_dtypes():
    code = ("import sys; "
            "import paddle_operator_tpu_torch.utils.fleetkv; "
            "import paddle_operator_tpu_torch.infer.kvstore; "
            "bad = [m for m in ('jax', 'ml_dtypes', 'paddle_operator_tpu') "
            "if m in sys.modules]; "
            "sys.exit(1 if bad else 0)")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    assert subprocess.run([sys.executable, "-c", code],
                          env=env).returncode == 0


# ---------------------------------------------------------------------------
# DirBackend and KVBlockStore (tests/test_kvstore.py's cases, on the port)
# ---------------------------------------------------------------------------


class TestParseUrl:
    def test_dir_scheme(self, tmp_path):
        b = parse_store_url(f"dir:{tmp_path}/kv")
        assert isinstance(b, DirBackend)
        assert os.path.isdir(b.root)

    def test_unknown_scheme_refused(self):
        with pytest.raises(ValueError, match="dir:/path"):
            parse_store_url("s3://bucket/kv")
        with pytest.raises(ValueError):
            parse_store_url("dir:")


class TestDirBackend:
    def test_negative_and_positive_keys_distinct_files(self, tmp_path):
        b = DirBackend(str(tmp_path))
        b.put(0, 123, b"pos")
        b.put(0, -123, b"neg")
        assert b.path(0, 123) != b.path(0, -123)
        assert b.get(0, 123) == b"pos"
        assert b.get(0, -123) == b"neg"
        assert b.exists(0, -123)
        b.delete(0, -123)
        assert b.get(0, -123) is None
        assert b.get(0, 999) is None

    def test_path_equals_jax(self, tmp_path):
        from paddle_operator_tpu.infer.kvstore import DirBackend as JaxDir

        ours, theirs = DirBackend(str(tmp_path)), JaxDir(str(tmp_path))
        for ns, key in ((0, 5), (0, -(2 ** 61)), (3, 123456789)):
            assert ours.path(ns, key) == theirs.path(ns, key)

    def test_namespaces_partition(self, tmp_path):
        b = DirBackend(str(tmp_path))
        b.put(0, 7, b"base")
        b.put(3, 7, b"adapter")
        assert b.get(0, 7) == b"base"
        assert b.get(3, 7) == b"adapter"

    def test_put_is_atomic_tmp_invisible(self, tmp_path):
        b = DirBackend(str(tmp_path))
        b.put(0, 5, b"published")
        torn = b.path(0, 5) + ".9999.0.tmp"
        with open(torn, "wb") as f:
            f.write(b"half-writ")
        assert b.get(0, 5) == b"published"
        assert [p for p, _, _ in b.entries()] == [b.path(0, 5)]
        assert b.sweep_tmp(max_age_s=300.0) == 0
        assert os.path.exists(torn)
        old = time.time() - 600
        os.utime(torn, (old, old))
        assert b.sweep_tmp(max_age_s=300.0) == 1
        assert not os.path.exists(torn)

    def test_touch_refreshes_mtime(self, tmp_path):
        b = DirBackend(str(tmp_path))
        b.put(0, 1, b"x")
        old = time.time() - 500
        os.utime(b.path(0, 1), (old, old))
        b.touch(0, 1)
        assert abs(os.stat(b.path(0, 1)).st_mtime - time.time()) < 60


class TestStoreWriteRead:
    def test_offer_flush_fetch_roundtrip_bit_exact(self, tmp_path):
        s = _store(tmp_path)
        toks = list(range(100, 100 + 3 * BS))
        _put_chain(s, toks, 3)
        assert s.stats["puts"] == 3
        chunks, idx, payloads, fp = s.fetch(toks, BS)
        assert idx == [0, 1, 2]
        assert chunks == [toks[:BS], toks[BS:2 * BS], toks[2 * BS:]]
        assert fp == FP
        for j, p in zip(idx, payloads):
            want = _payload(10 + j)
            assert np.array_equal(p["k"].numpy(), want["k"])
            assert np.array_equal(p["v"].numpy(), want["v"])
        assert s.stats["hits"] == 1 and s.stats["blocks_fetched"] == 3
        assert s.hit_rate() == 1.0
        blocks, nbytes = s.usage()
        assert blocks == 3 and nbytes > 0
        s.close()

    def test_same_key_offered_twice_writes_once(self, tmp_path):
        s = _store(tmp_path)
        toks = list(range(200, 200 + BS))
        _put_chain(s, toks, 1)
        _put_chain(s, toks, 1)
        assert s.stats["puts"] == 1
        assert s.usage()[0] == 1
        s.close()

    def test_offer_backpressure_drops_oldest(self, tmp_path):
        s = _store(tmp_path, queue_len=2)
        s._writer = object()            # pin the writer: queue only
        for j in range(4):
            s.offer(100 + j, (j,), _payload(j))
        assert s.stats["put_drops"] == 2
        assert [k for _, k, _, _ in s._q] == [102, 103]
        assert s.shed_oldest()
        assert [k for _, k, _, _ in s._q] == [103]
        assert s.stats["put_drops"] == 3

    def test_adapter_namespace_abstains(self, tmp_path):
        s = _store(tmp_path)
        toks = list(range(300, 300 + BS))
        _put_chain(s, toks, 1)
        chunks, idx, payloads, _fp = s.fetch(toks, BS, ns=3)
        assert (chunks, idx, payloads) == ([], [], [])
        s.close()

    def test_fetch_skip_and_contiguity_break(self, tmp_path):
        s = _store(tmp_path)
        toks = list(range(400, 400 + 3 * BS))
        keys = _put_chain(s, toks, 3)
        _, idx, _, _ = s.fetch(toks, BS, skip=1)
        assert idx == [1, 2]
        s.backend.delete(0, keys[1])
        _, idx, _, _ = s.fetch(toks, BS)
        assert idx == [0]
        s.close()

    def test_partial_trailing_tokens_ignored(self, tmp_path):
        s = _store(tmp_path)
        toks = list(range(500, 500 + BS))
        _put_chain(s, toks, 1)
        chunks, idx, _, _ = s.fetch(toks + [1, 2, 3], BS)
        assert idx == [0] and chunks == [toks]
        assert s.fetch([1, 2], BS)[1] == []
        s.close()

    def test_flush_returns_only_once_written(self, tmp_path):
        """Every offer is on disk when ``flush`` returns True: the
        writer's in-hand offer counts until its file is renamed (the JAX
        store's flush could return between the writer's pop and its busy
        flag)."""
        s = _store(tmp_path)
        for round_ in range(20):
            toks = list(range(1000 * round_, 1000 * round_ + 2 * BS))
            keys = _put_chain(s, toks, 2, seed=round_)
            assert all(s.backend.exists(0, k) for k in keys)
        s.close()


class TestRefusalAtStoreBoundary:
    def _one_entry(self, tmp_path):
        s = _store(tmp_path)
        toks = list(range(600, 600 + BS))
        keys = _put_chain(s, toks, 1)
        return s, toks, keys[0]

    def test_truncated_file_refused_and_gcd(self, tmp_path):
        s, toks, key = self._one_entry(tmp_path)
        path = s.backend.path(0, key)
        blob = open(path, "rb").read()
        with open(path, "wb") as f:
            f.write(blob[:len(blob) // 2])
        _, idx, payloads, _ = s.fetch(toks, BS)
        assert idx == [] and payloads == []
        assert s.stats["refused"] == 1
        assert not os.path.exists(path)
        s.close()

    def test_crc_corruption_refused_and_gcd(self, tmp_path):
        s, toks, key = self._one_entry(tmp_path)
        path = s.backend.path(0, key)
        blob = bytearray(open(path, "rb").read())
        blob[-3] ^= 0xFF
        with open(path, "wb") as f:
            f.write(bytes(blob))
        _, idx, _, _ = s.fetch(toks, BS)
        assert idx == [] and s.stats["refused"] == 1
        assert not os.path.exists(path)
        s.close()

    def test_fingerprint_skew_refused_and_gcd(self, tmp_path):
        s, toks, key = self._one_entry(tmp_path)
        s.close()
        skewed = KVBlockStore(DirBackend(str(tmp_path)),
                              fingerprint=dict(FP, quant="int8"))
        _, idx, _, _ = skewed.fetch(toks, BS)
        assert idx == [] and skewed.stats["refused"] == 1
        assert not skewed.backend.exists(0, key)

    def test_wrong_name_identity_refused(self, tmp_path):
        import shutil

        s, toks, key = self._one_entry(tmp_path)
        other = chain_key(None, tuple(range(700, 700 + BS)))
        dst = s.backend.path(0, other)
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        shutil.copyfile(s.backend.path(0, key), dst)
        _, idx, _, _ = s.fetch(list(range(700, 700 + BS)), BS)
        assert idx == [] and s.stats["refused"] == 1
        assert not os.path.exists(dst)
        s.close()

    def test_crash_mid_write_invisible_to_readers(self, tmp_path):
        s = _store(tmp_path)
        toks = list(range(800, 800 + BS))
        key = chain_key(None, tuple(toks))
        final = s.backend.path(0, key)
        os.makedirs(os.path.dirname(final), exist_ok=True)
        with open(final + ".123.0.tmp", "wb") as f:
            f.write(b"torn half-envelope")
        _, idx, _, _ = s.fetch(toks, BS)
        assert idx == [] and s.stats["refused"] == 0
        assert s.usage() == (0, 0)
        s.close()


class TestJanitor:
    def test_ttl_expires_by_last_touch(self, tmp_path):
        s = _store(tmp_path, ttl_s=100.0)
        toks = list(range(900, 900 + 2 * BS))
        keys = _put_chain(s, toks, 2)
        old = time.time() - 500
        os.utime(s.backend.path(0, keys[0]), (old, old))
        out = s.janitor()
        assert out["expired"] == 1 and s.evictions() == 1
        assert not s.backend.exists(0, keys[0])
        assert s.backend.exists(0, keys[1])
        s.close()

    def test_budget_evicts_lru_by_last_touch(self, tmp_path):
        s = _store(tmp_path, budget_mb=1)
        arr = np.zeros((28000,), np.float64)        # 224KB per array
        keys, key = [], None
        for j in range(4):
            chunk = tuple(range(j * BS, (j + 1) * BS))
            key = chain_key(key, chunk)
            keys.append(key)
            s.offer(key, chunk, {"k": arr, "v": arr})
        assert s.flush()
        now = time.time()
        for rank, j in enumerate([1, 0, 2, 3]):
            t = now - 400 + rank * 100
            os.utime(s.backend.path(0, keys[j]), (t, t))
        out = s.janitor()
        assert out["budget_evicted"] == 2
        assert s.evictions() == 2
        assert not s.backend.exists(0, keys[1])
        assert not s.backend.exists(0, keys[0])
        assert s.backend.exists(0, keys[2])
        assert s.backend.exists(0, keys[3])
        assert s.usage()[1] <= 1 << 20
        s.close()

    def test_janitor_cli_one_pass(self, tmp_path, capsys):
        from paddle_operator_tpu_torch.infer.kvstore import _janitor_main

        s = _store(tmp_path)
        _put_chain(s, list(range(1100, 1100 + BS)), 1)
        s.close()
        rc = _janitor_main([f"dir:{tmp_path}", "--ttl-s", "0"])
        assert rc == 0
        assert "1 blocks" in capsys.readouterr().out


def _mgr(**kw):
    kw.setdefault("slots", 1)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("block_size", BS)
    kw.setdefault("num_blocks", 8)
    kw.setdefault("host_cache_blocks", 2)
    m = PagedCacheManager(**kw)
    m.demote_fetch = lambda blk: {"k": np.full((4,), blk, np.float32),
                                  "v": np.full((4,), blk, np.float32)}
    return m


def _churn(m, base, n_blocks=8):
    P = list(range(base, base + n_blocks * BS))
    m.admit(0, P)
    m.publish(0, P)
    m.retire(0)


class TestPoolSpill:
    def test_overflow_spills_to_store_node_survives(self, tmp_path):
        m = _mgr()
        store = _store(tmp_path, fp=None)
        m.attach_store(store)
        P = list(range(100, 124))
        m.admit(0, P)
        m.publish(0, P)
        m.retire(0)
        _churn(m, 900)
        assert m.host_evictions() >= 1
        assert m.stats["store_spills"] >= 1
        assert store.flush()
        assert store.stats["puts"] >= 1
        stored = [e for e in m.entries.values()
                  if e.block is None and e.stored]
        assert stored
        assert all(not m._servable(e) for e in stored)
        m.check_invariant()
        store.close()

    def test_store_off_overflow_drops_node_regression_pin(self):
        m = _mgr()
        P = list(range(100, 124))
        m.admit(0, P)
        m.publish(0, P)
        m.retire(0)
        _churn(m, 900)
        assert m.host_evictions() >= 1
        assert m.stats["store_spills"] == 0
        assert not any(e.stored for e in m.entries.values())
        m.check_invariant()

    def test_import_refills_store_resident_node(self, tmp_path):
        m = _mgr(host_cache_blocks=8)
        store = _store(tmp_path, fp=None)
        m.attach_store(store)
        P = list(range(100, 124))
        m.admit(0, P)
        m.publish(0, P)
        m.retire(0)
        m.host.capacity = 1
        _churn(m, 900)
        assert store.flush()
        stored_keys = [e.key for e in m.entries.values()
                       if e.block is None and e.stored]
        assert stored_keys
        m.host.capacity = 8
        imported = 0
        while True:
            covered, key = 0, None
            for j in range(3):
                key = m._chain_key(key, tuple(P[j * BS:(j + 1) * BS]))
                e = m.entries.get(key)
                if e is None or not m._servable(e):
                    break
                covered += 1
            if covered == 3:
                break
            chunks, idx, payloads, _fp = store.fetch(P, BS, skip=covered)
            assert idx, "spilled chain must be fetchable"
            imported += m.import_host_blocks(chunks, idx, payloads)
        assert imported == len(stored_keys)
        assert m.stats["store_refills"] >= 1
        assert not any(e.stored for e in m.entries.values()
                       if e.key in stored_keys)
        m.check_invariant()
        hit_len, _ = m.admit(0, P)
        assert hit_len == len(P) - 1
        assert m.take_promotions()
        m.retire(0)
        m.check_invariant()
        store.close()

    def test_scrub_host_chain_deletes_store_copies(self, tmp_path):
        m = _mgr()
        store = _store(tmp_path, fp=None)
        m.attach_store(store)
        P = list(range(100, 124))
        m.admit(0, P)
        m.publish(0, P)
        m.retire(0)
        _churn(m, 900)
        assert store.flush()
        assert store.usage()[0] >= 1
        m.scrub_host_chain(P)
        chunks, idx, _, _ = store.fetch(P, BS)
        assert idx == []
        assert not any(e.stored for e in m.entries.values())
        m.check_invariant()
        store.close()

    def test_publish_reanchors_store_resident_node(self, tmp_path):
        m = _mgr()
        store = _store(tmp_path, fp=None)
        m.attach_store(store)
        P = list(range(100, 124))
        m.admit(0, P)
        m.publish(0, P)
        m.retire(0)
        _churn(m, 900)
        assert any(e.stored for e in m.entries.values())
        m.admit(0, P)
        m.take_promotions()
        m.publish(0, P)
        m.retire(0)
        assert not any(e.stored for e in m.entries.values()
                       if e.block is not None)
        m.check_invariant()
        store.close()

    def test_adapter_namespace_never_spills(self, tmp_path):
        m = _mgr()
        store = _store(tmp_path, fp=None)
        m.attach_store(store)
        ns = 5
        P = list(range(100, 124))
        m.admit(0, P, ns=ns)
        m.publish(0, P, ns=ns)
        m.retire(0)
        _churn(m, 900)
        assert store.flush()
        assert not any(e.stored for e in m.entries.values() if e.ns)
        assert store.stats["puts"] == store.usage()[0]
        m.check_invariant()
        store.close()

    def test_attach_requires_host_tier(self):
        with pytest.raises(ValueError, match="host cache"):
            _mgr(host_cache_blocks=0).attach_store(object())


# ---------------------------------------------------------------------------
# Rings: the fingerprint, cross-package restarts, the live re-probe
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def setup():
    import jax
    import jax.numpy as jnp

    from paddle_operator_tpu.models.llama import make_model as jmake
    from paddle_operator_tpu_torch.convert import params_from_jax

    jmodel, jcfg = jmake("tiny", dtype=jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, 8), jnp.int32))["params"]
    model, cfg = make_model("tiny", device="cpu", dtype=torch.float32)
    model.load_state_dict(params_from_jax(jax.device_get(jparams)))
    return model, cfg, jparams, jcfg


def _ring_kw(**kw):
    kw.setdefault("slots", 1)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("chunk_tokens", 4)
    kw.setdefault("prefill_buckets", (16, MAX_LEN))
    kw.setdefault("paged", True)
    kw.setdefault("block_size", BS)
    kw.setdefault("num_blocks", 8)
    # cap 4: two churn prompts push a 3-block chain fully out to the
    # store; big enough to land the 3-block refill
    kw.setdefault("host_cache_blocks", 4)
    return kw


def _jax_ring(setup, **kw):
    from paddle_operator_tpu.infer.batcher import (
        ContinuousBatcher as JaxBatcher,
    )

    _, _, jparams, jcfg = setup
    return JaxBatcher(jparams, jcfg, **_ring_kw(**kw))


def _port_ring(setup, **kw):
    model, cfg, _, _ = setup
    return ContinuousBatcher(model, cfg, **_ring_kw(**kw))


def _attach(b, tmp_path, store_cls=KVBlockStore, dir_cls=DirBackend):
    store = store_cls(dir_cls(str(tmp_path)), fingerprint=b._fingerprint())
    b.attach_kv_store(store)
    return store


def _prompt(n, seed):
    rng = np.random.default_rng(seed)
    return [int(t) for t in rng.integers(1, 256, (n,))]


def _spill_corpus(b, store):
    """Cold-serve P, then pressure it out of the pool and the cap-4 tier
    into the store; returns (P, cold tokens)."""
    P = _prompt(24, 1)                      # 3 full blocks
    cold = b.submit(P, max_new_tokens=6).result(timeout=300)
    b.submit(_prompt(56, 2), max_new_tokens=4).result(timeout=300)
    b.submit(_prompt(56, 3), max_new_tokens=4).result(timeout=300)
    assert b.pool.stats["host_demotions"] >= 3
    assert b.pool.stats["store_spills"] >= 3
    assert store.flush()
    return P, cold


def _chain_files(tmp_path, tokens):
    """The arrays of the store files on ``tokens``' chain, by key."""
    out, key = {}, None
    backend = DirBackend(str(tmp_path))
    for j in range(len(tokens) // BS):
        key = chain_key(key, tuple(tokens[j * BS:(j + 1) * BS]))
        blob = backend.get(0, key)
        if blob is not None:
            out[key] = FK.decode_envelope(blob)[2]
    return out


@pytest.mark.parametrize("generation", [0, 3])
@pytest.mark.parametrize("kv_quant", QUANTS)
def test_fingerprint_equals_jax(setup, kv_quant, generation):
    jb = _jax_ring(setup, kv_quant=kv_quant, generation=generation)
    b = _port_ring(setup, kv_quant=kv_quant, generation=generation)
    try:
        assert b._fingerprint() == jb._fingerprint()
    finally:
        b.close()
        jb.close()


@pytest.mark.parametrize("kv_quant", QUANTS)
def test_jax_spill_port_restart(setup, tmp_path, kv_quant):
    """A JAX ring spills its corpus to a directory; a port ring started on
    it serves the prefix through probe -> import -> promote with the
    tokens a JAX ring restarted on the same directory serves, and the
    blocks it promoted are the files' bytes.  (Those tokens are the JAX
    ring's cold tokens whenever the JAX ring persisted each block's own
    bytes; on the CPU backend it has been seen to persist another
    block's under a chain key, and the equality with the JAX restart
    still holds the port to whatever the files hold.)"""
    from paddle_operator_tpu.infer import kvstore as JKV

    jb = _jax_ring(setup, kv_quant=kv_quant)
    jstore = _attach(jb, tmp_path, JKV.KVBlockStore, JKV.DirBackend)
    try:
        P, _cold = _spill_corpus(jb, jstore)
    finally:
        jb.close()
        jstore.close()
    jb = _jax_ring(setup, kv_quant=kv_quant)
    jstore = _attach(jb, tmp_path, JKV.KVBlockStore, JKV.DirBackend)
    try:
        want = jb.submit(P, max_new_tokens=6).result(timeout=300)
        assert jb.stats["kv_store_hits"] == 1
    finally:
        jb.close()
        jstore.close()
    files = _chain_files(tmp_path, P)
    b = _port_ring(setup, kv_quant=kv_quant)
    store = _attach(b, tmp_path)
    try:
        got = b.submit(P, max_new_tokens=6).result(timeout=300)
        assert got == want, "store hit diverged from the JAX ring's"
        for key, arrays in files.items():
            e = b.pool.entries[key]
            for name, a in arrays.items():
                assert torch.equal(b.cache[name][:, e.block:e.block + 1], a)
        assert b.stats["kv_store_hits"] == 1
        assert store.stats["blocks_fetched"] >= 3
        assert b.pool.stats["peer_blocks_imported"] >= 3
        assert b.pool.stats["host_promotions"] >= 3
        b.pool.check_invariant()
        st = b.serving_status()
        assert st["kvStoreBlocks"] >= 3 and st["kvStoreHitRate"] > 0
        assert st["kvStoreBytes"] == store.usage()[1]
    finally:
        b.close()
        store.close()


@pytest.mark.parametrize("kv_quant", QUANTS)
def test_port_spill_jax_fetch_and_restart(setup, tmp_path, kv_quant):
    """A port ring spills; JAX's ``KVBlockStore.fetch`` returns the
    port's payloads exactly (the bytes the port offered), and a JAX ring
    restarted on the directory serves the port's cold tokens."""
    from paddle_operator_tpu.infer import kvstore as JKV

    b = _port_ring(setup, kv_quant=kv_quant)
    store = _attach(b, tmp_path)
    offered = {}
    real_offer = store.offer

    def offer(key, chunk, payload, ns=0):
        payload.wait()
        offered[int(key)] = {k: v.clone() for k, v in payload.items()}
        real_offer(key, chunk, payload, ns=ns)

    store.offer = offer
    try:
        P, cold = _spill_corpus(b, store)
        fp = b._fingerprint()
    finally:
        b.close()
        store.close()
    jstore = JKV.KVBlockStore(JKV.DirBackend(str(tmp_path)), fingerprint=fp)
    checked = 0
    for seed, n in ((1, 24), (2, 56), (3, 56)):
        toks = _prompt(n, seed)
        key = None
        keys = []
        for j in range(n // BS):
            key = chain_key(key, tuple(toks[j * BS:(j + 1) * BS]))
            keys.append(key)
        for j in range(n // BS):
            if keys[j] not in offered:
                continue
            _, idx, payloads, _ = jstore.fetch(toks, BS, skip=j)
            assert idx and idx[0] == j
            for name, want in offered[keys[j]].items():
                got = payloads[0][name]
                assert got.dtype == want.numpy().dtype
                assert np.array_equal(got, want.numpy())
            checked += 1
    assert checked == len(offered) >= 3
    jb = _jax_ring(setup, kv_quant=kv_quant)
    jstore = _attach(jb, tmp_path, JKV.KVBlockStore, JKV.DirBackend)
    try:
        assert jb.submit(P, max_new_tokens=6).result(timeout=300) == cold
        assert jb.stats["kv_store_hits"] == 1
        assert jb.pool.stats["host_promotions"] >= 3
    finally:
        jb.close()
        jstore.close()


@pytest.mark.parametrize("kv_quant", QUANTS)
def test_live_ring_reprobe_of_spilled_chain(setup, tmp_path, kv_quant):
    """The SAME ring re-asks a prompt whose chain overflowed out of its
    own host tier: the store-resident nodes re-probe the store instead
    of re-prefilling.  Deterministic: the corpus is on disk when
    ``flush`` returns, and the probe runs on the submit thread itself."""
    b = _port_ring(setup, kv_quant=kv_quant)
    store = _attach(b, tmp_path)
    try:
        P, cold = _spill_corpus(b, store)
        assert any(e.stored for e in b.pool.entries.values())
        toks0 = b.stats["prefill_tokens"]
        got = b.submit(P, max_new_tokens=6).result(timeout=300)
        assert got == cold
        assert b.stats["kv_store_hits"] >= 1
        assert b.pool.stats["store_refills"] >= 1
        assert b.stats["prefill_tokens"] - toks0 < len(P)
        b.pool.check_invariant()
    finally:
        b.close()
        store.close()


def test_no_store_ring_byte_identical(setup):
    b = _port_ring(setup)
    try:
        P = _prompt(24, 1)
        b.submit(P, max_new_tokens=4).result(timeout=300)
        b.submit(_prompt(56, 2), max_new_tokens=4).result(timeout=300)
        assert b.stats["kv_store_probes"] == 0
        assert b.pool.stats["store_spills"] == 0
        assert not any(e.stored for e in b.pool.entries.values())
        st = b.serving_status()
        assert (st["kvStoreBlocks"], st["kvStoreBytes"],
                st["kvStoreHitRate"], st["kvStoreEvictions"]) == \
            (0, 0, 0.0, 0)
        b.pool.check_invariant()
    finally:
        b.close()


def test_ring_attach_requires_host_tier(setup, tmp_path):
    b = _port_ring(setup, host_cache_blocks=0)
    try:
        with pytest.raises(ValueError, match="host cache"):
            b.attach_kv_store(KVBlockStore(DirBackend(str(tmp_path))))
    finally:
        b.close()


def test_full_slab_takes_a_slot_back_from_the_store(setup, tmp_path):
    """With the store's writer held (every overflow stays queued, each
    holding its slot), demotes run the slab dry; the ring then sheds the
    oldest queued offer and keeps serving, tokens unchanged."""
    b = _port_ring(setup, host_cache_blocks=1)
    store = _attach(b, tmp_path)
    store._writer = object()            # the writer never starts
    try:
        P, cold = _prompt(24, 1), None
        cold = b.submit(P, max_new_tokens=6).result(timeout=300)
        for seed in range(2, 6):
            b.submit(_prompt(56, seed), max_new_tokens=4).result(timeout=300)
        slab = b.executor._slab
        assert store.stats["put_drops"] >= 1
        assert len(store._q) <= slab.n_slots
        assert b.submit(P, max_new_tokens=6).result(timeout=300) == cold
        b.pool.check_invariant()
    finally:
        b.close()
        with store._cv:
            while store._shed_locked():
                pass


# ---------------------------------------------------------------------------
# On the card: host hits and the store restart under CUDA graph replay
# ---------------------------------------------------------------------------


@pytest.mark.cuda
class TestHostTierOnCard:
    @pytest.fixture(scope="class")
    def card_model(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")
        return make_model("tiny", device="cuda", seed=0,
                          dtype=torch.float32)

    @pytest.mark.parametrize("kv_quant,megastep", [("none", 1), ("none", 4),
                                                   ("int8", 1)])
    def test_host_hit_keeps_graph_addresses(self, card_model, tmp_path,
                                            kv_quant, megastep):
        """Every dispatch a graph replay: tier-off, host-hit and
        store-restart streams are equal, and the promotes rebind none of
        the captured tensors and capture nothing again."""
        model, cfg = card_model
        kw = dict(kv_quant=kv_quant, megastep=megastep, prewarm=True)
        P = _prompt(24, 1)
        off = ContinuousBatcher(model, cfg, **_ring_kw(host_cache_blocks=0,
                                                       **kw))
        try:
            want = off.submit(P, max_new_tokens=12).result(timeout=300)
        finally:
            off.close()
        b = ContinuousBatcher(model, cfg, **_ring_kw(**kw))
        store = _attach(b, tmp_path)
        try:
            assert b.prewarmed.wait(300) and not b.executor.needs_capture
            graphs = b.executor._graphs
            ptrs = b.executor._state_ptrs()
            assert b.executor._slab.registered
            assert b.submit(P, max_new_tokens=12).result(timeout=300) == want
            for seed in (2, 3):
                b.submit(_prompt(56, seed),
                         max_new_tokens=4).result(timeout=300)
            assert store.flush()
            assert b.submit(P, max_new_tokens=12).result(timeout=300) == want
            assert b.stats["promoted_blocks"] >= 3
            assert b.executor._graphs is graphs
            assert b.executor._state_ptrs() == ptrs
            b.pool.check_invariant()
        finally:
            b.close()
            store.close()
        r = ContinuousBatcher(model, cfg, **_ring_kw(**kw))
        store = _attach(r, tmp_path)
        try:
            assert r.submit(P, max_new_tokens=12).result(timeout=300) == want
            assert r.stats["kv_store_hits"] == 1
        finally:
            r.close()
            store.close()
