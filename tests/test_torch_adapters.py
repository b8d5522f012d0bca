"""The torch package's many-adapter LoRA serving (paddle_operator_tpu_torch/
infer/qos.py ``AdapterRegistry`` and ``lora_qkv``, the ``lora`` leg of
decode, the rings and the scheduler, ``/v1/adapters``) held against the
JAX package's (tests/test_qos.py TestAdapters, TestAdapterPrefixNamespace;
tests/test_weight_quant.py), on converted ``tiny`` f32 params (the JAX
``PRNGKey(0)`` tree) with both registries loaded alike:

- the registry: lifecycle, the zero slot, a full pool, a reused slot's
  fresh namespace, ``from_env`` parsing, ``load_adapter_file``'s zero-pad
  and its errors; ``stable_name_seed`` and ``make_random_adapter`` equal
  JAX's bit for bit; ``lora_qkv`` within 1e-6 of JAX's;
- greedy tokens equal the JAX ``ContinuousBatcher``'s (same registry,
  same ring arguments) for base, ``x``, ``y`` and a mixed batch on the
  contiguous, paged and int8 rings; the same with chunked prefill, a
  prefix hit, megastep 4 and a preempted-then-restored adapter lane; an
  aid-0 lane equals the adapterless ring; ``generate`` with the same
  ``lora`` leg equals the ring;
- no cross-adapter prefix hits (and none across an evict and reload of
  one slot); the host tier never takes an adapter namespace; adapters
  on a speculative ring are refused (and ignored beside SERVE_SPEC_K in
  the entry point) with JAX's messages; a queued request whose adapter
  is evicted fails with JAX's message; LoRA over a
  ``SERVE_WEIGHT_QUANT=int8`` base;
- over HTTP: ``GET``/``POST /v1/adapters`` load, serve, 409 on an evict
  in use, 400 for an unknown adapter, and the JAX router's
  ``parse_adapter_gauges`` reads the loaded set from a torch replica's
  ``/metrics`` after a runtime load and evict;
- on the card (``cuda``-marked, skipped here): an adapter loaded after
  graph capture streams as a ring booted with it.

The JAX package is imported only inside the fixtures and tests that
need it.
"""

import copy
import json
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
from paddle_operator_tpu_torch.infer import decode as D
from paddle_operator_tpu_torch.infer import qos as TQ
from paddle_operator_tpu_torch.infer import serve as S
from paddle_operator_tpu_torch.infer.batcher import ContinuousBatcher
from paddle_operator_tpu_torch.models.llama import Llama, make_model

MAX_LEN = 64
BS = 8
CH = 4
RANK = 4
LORA_TOL = 1e-6     # f32, one gather and two small products
KINDS = ["contiguous", "paged", "int8"]
ADAPTERS = {"x": 7, "y": 9}


@pytest.fixture(scope="module")
def setup():
    from paddle_operator_tpu.models.llama import make_model as jmake

    jmodel, jcfg = jmake("tiny", dtype=jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, 8), jnp.int32))["params"]
    model, cfg = make_model("tiny", device="cpu", dtype=torch.float32)
    model.load_state_dict(params_from_jax(jax.device_get(jparams)))
    model.requires_grad_(False)
    return model, cfg, jparams, jcfg


def _registries(cfg, jcfg, capacity=3):
    from paddle_operator_tpu.infer import qos as JQ

    reg = TQ.AdapterRegistry(cfg, capacity=capacity, rank=RANK,
                             device="cpu")
    jreg = JQ.AdapterRegistry(jcfg, capacity=capacity, rank=RANK)
    for name, seed in ADAPTERS.items():
        reg.load(name, seed=seed)
        jreg.load(name, seed=seed)
    return reg, jreg


def _ring_kw(kind, **kw):
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("chunk_tokens", CH)
    kw.setdefault("prefill_buckets", (16, MAX_LEN))
    if kind != "contiguous":
        kw.update(paged=True, block_size=BS)
        kw.setdefault("num_blocks", 32)
    if kind == "int8":
        kw["kv_quant"] = "int8"
    return kw


def _prompt(s, seed):
    return np.random.default_rng(seed).integers(0, 256, s).astype(
        np.int32).tolist()


def _waves(b, waves):
    """Each wave's (prompt, new, adapter) requests submitted together,
    the next wave after they resolve; the outputs in order."""
    out = []
    for wave in waves:
        hs = [b.submit(p, max_new_tokens=n, adapter=a) for p, n, a in wave]
        out += [h.result(timeout=300) for h in hs]
    return out


@pytest.fixture(scope="class")
def both(setup):
    """``run(kind, waves, **ring_kw)``: the waves through the port's ring
    and the JAX ring built alike, each over its registry; returns
    (port outputs, JAX outputs, the port batcher's stats)."""
    from paddle_operator_tpu.infer.batcher import (
        ContinuousBatcher as JaxBatcher,
    )

    model, cfg, jparams, jcfg = setup

    def run(kind, waves, **kw):
        reg, jreg = _registries(cfg, jcfg)
        b = ContinuousBatcher(model, cfg, adapters=reg, **_ring_kw(kind, **kw))
        jb = JaxBatcher(jparams, jcfg, adapters=jreg, **_ring_kw(kind, **kw))
        try:
            got = _waves(b, waves)
            want = _waves(jb, waves)
            stats = dict(b.stats, hit=(b.pool.stats["prefix_hit_tokens"]
                                       if b.pool is not None else 0))
            if b.pool is not None:
                b.pool.check_invariant()
        finally:
            b.close()
            jb.close()
        return got, want, stats

    return run


# ---------------------------------------------------------------------------
# The registry and the delta rule
# ---------------------------------------------------------------------------


class TestRegistry:
    def test_seed_and_random_adapter_equal_jax(self, setup):
        from paddle_operator_tpu.infer import qos as JQ

        _, cfg, _, jcfg = setup
        for name in ("x", "acme", "tenant-7.v2", "ä"):
            assert TQ.stable_name_seed(name) == JQ.stable_name_seed(name)
        got = TQ.make_random_adapter(cfg, RANK, 7)
        want = JQ.make_random_adapter(jcfg, RANK, 7)
        assert set(got) == set(want) == set(TQ.LORA_PROJS)
        for proj in TQ.LORA_PROJS:
            for key in ("a", "b"):
                assert got[proj][key].dtype == want[proj][key].dtype
                np.testing.assert_array_equal(got[proj][key],
                                              want[proj][key])

    def test_lifecycle_zero_slot_and_full_pool(self, setup):
        _, cfg, _, _ = setup
        reg = TQ.AdapterRegistry(cfg, capacity=2, rank=RANK, device="cpu")
        st = reg.arrays()
        ptrs = [t.data_ptr() for ab in st.values() for t in ab.values()]
        assert len(reg) == 0 and reg.names() == []
        assert reg.load("x", seed=7) == 1 and reg.load("y") == 2
        assert reg.names() == ["x", "y"] and len(reg) == 2
        with pytest.raises(ValueError, match="pool full"):
            reg.load("z", seed=1)
        with pytest.raises(ValueError, match="must match"):
            reg.load("bad name")
        want = TQ.make_random_adapter(cfg, RANK, 7)
        for proj in TQ.LORA_PROJS:
            assert not st[proj]["a"][:, 0].any()
            assert not st[proj]["b"][:, 0].any()
            np.testing.assert_array_equal(st[proj]["a"][:, 1].numpy(),
                                          want[proj]["a"])
        assert reg.resolve("x") == 1
        with pytest.raises(ValueError, match="unknown adapter"):
            reg.resolve("z")
        with pytest.raises(TQ.AdapterInUse):
            reg.evict("x", in_use={1})
        with pytest.raises(TQ.AdapterInUse):
            reg.load("x", seed=3, in_use={1})
        reg.evict("x")
        assert not any(st[p][k][:, 1].any() for p in st for k in "ab")
        with pytest.raises(KeyError):
            reg.ns_of(1)
        with pytest.raises(ValueError, match="unknown adapter"):
            reg.evict("x")
        # every write was in place: the stacks never moved
        assert [t.data_ptr() for ab in st.values()
                for t in ab.values()] == ptrs
        assert reg.nbytes() == sum(t.numel() * 4 for ab in st.values()
                                   for t in ab.values())

    def test_reused_slot_gets_fresh_namespace(self, setup):
        _, cfg, _, _ = setup
        reg = TQ.AdapterRegistry(cfg, capacity=1, rank=RANK, device="cpu")
        idx = reg.load("x", seed=7)
        ns1 = reg.resolve_ns("x")[1]
        reg.evict("x")
        assert reg.load("y", seed=9) == idx
        assert reg.resolve_ns("y") == (idx, reg.ns_of(idx))
        assert reg.ns_of(idx) != ns1 and reg.ns_of(0) == 0
        reg.load("y", seed=11)          # a replace mints one too
        assert reg.ns_of(idx) not in (0, ns1)

    def test_from_env(self, setup, tmp_path):
        from paddle_operator_tpu.infer import qos as JQ

        _, cfg, _, jcfg = setup
        assert TQ.AdapterRegistry.from_env(cfg, {}, device="cpu") is None
        assert TQ.AdapterRegistry.from_env(
            cfg, {"SERVE_ADAPTERS": " "}, device="cpu") is None
        path = tmp_path / "d.npz"
        deltas = JQ.make_random_adapter(jcfg, 2, 5)
        np.savez(path, **{f"{p}_{k}": deltas[p][k]
                          for p in deltas for k in ("a", "b")})
        env = {"SERVE_ADAPTERS": f"acme, zen:seed:9,,f:{path}",
               "SERVE_ADAPTER_RANK": "4", "SERVE_MAX_ADAPTERS": "5"}
        reg = TQ.AdapterRegistry.from_env(cfg, env, device="cpu")
        assert (reg.capacity, reg.rank) == (5, 4)
        assert reg.names() == ["acme", "f", "zen"]
        a = reg.arrays()["wk"]["a"]
        want = TQ.make_random_adapter(cfg, 4, TQ.stable_name_seed("acme"))
        np.testing.assert_array_equal(a[:, reg.resolve("acme")].numpy(),
                                      want["wk"]["a"])
        want = TQ.make_random_adapter(cfg, 4, 9)
        np.testing.assert_array_equal(a[:, reg.resolve("zen")].numpy(),
                                      want["wk"]["a"])
        # the rank-2 file zero-pads to 4
        got = a[:, reg.resolve("f")].numpy()
        np.testing.assert_array_equal(got[..., :2], deltas["wk"]["a"])
        assert not got[..., 2:].any()

    def test_load_adapter_file_pad_and_errors(self, setup, tmp_path):
        from paddle_operator_tpu.infer import qos as JQ

        _, cfg, _, jcfg = setup
        deltas = JQ.make_random_adapter(jcfg, 2, 5)
        arrays = {f"{p}_{k}": deltas[p][k] for p in deltas for k in "ab"}
        path = tmp_path / "ok.npz"
        np.savez(path, **arrays)
        got = TQ.load_adapter_file(cfg, str(path), 4)
        want = JQ.load_adapter_file(jcfg, str(path), 4)
        for p in TQ.LORA_PROJS:
            for k in "ab":
                np.testing.assert_array_equal(got[p][k], want[p][k])
        with pytest.raises(ValueError, match="exceeds the registry rank"):
            TQ.load_adapter_file(cfg, str(path), 1)
        bad = dict(arrays, wv_b=arrays["wv_b"][:, :, :3])
        np.savez(tmp_path / "bad.npz", **bad)
        with pytest.raises(ValueError, match="do not fit"):
            TQ.load_adapter_file(cfg, str(tmp_path / "bad.npz"), 4)
        reg = TQ.AdapterRegistry(cfg, capacity=1, rank=4, device="cpu")
        with pytest.raises(ValueError, match="rank 2 != registry rank 4"):
            reg.load("r", deltas)
        assert reg.names() == []

    def test_lora_qkv_equals_jax(self, setup):
        from paddle_operator_tpu.infer import qos as JQ

        model, cfg, _, jcfg = setup
        reg, jreg = _registries(cfg, jcfg)
        rng = np.random.default_rng(0)
        b, t = 3, 5
        h = rng.standard_normal((b, t, cfg.dim)).astype(np.float32)
        outs = {p: rng.standard_normal((b, t, n)).astype(np.float32)
                for p, (_, n) in TQ._proj_dims(cfg).items()}
        aid = np.array([0, 2, 1], np.int32)
        for li in range(cfg.n_layers):
            got = TQ.lora_qkv(torch.as_tensor(h),
                              TQ.layer_lora((reg.arrays(), None), li)[0],
                              torch.as_tensor(aid),
                              *(torch.as_tensor(outs[p])
                                for p in TQ.LORA_PROJS), torch.float32)
            jl = jax.tree_util.tree_map(lambda a: a[li], jreg.arrays())
            want = JQ.lora_qkv(jnp.asarray(h), jl, jnp.asarray(aid),
                               *(jnp.asarray(outs[p])
                                 for p in TQ.LORA_PROJS), jnp.float32)
            for g, w, p in zip(got, want, TQ.LORA_PROJS):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           atol=LORA_TOL, rtol=0)
            # the base lane's delta is an exact zero
            np.testing.assert_array_equal(got[0][0].numpy(), outs["wq"][0])


# ---------------------------------------------------------------------------
# Rings against the JAX package's
# ---------------------------------------------------------------------------


class TestRingsEqualJax:
    @pytest.mark.parametrize("kind", KINDS)
    def test_base_adapters_and_mixed_batch(self, both, kind):
        p = _prompt(10, 1)
        solo = [[(p, 8, a)] for a in (None, "x", "y")]
        mixed = [[(p, 8, "x"), (p, 8, None)], [(p, 8, "y"), (p, 8, "x")]]
        got, want, _ = both(kind, solo + mixed)
        assert got == want
        base, x, y = got[:3]
        assert len({tuple(base), tuple(x), tuple(y)}) == 3, \
            "the adapters did not change the stream"
        # every lane of a mixed batch equals its solo run
        assert got[3:] == [x, base, y, x]

    @pytest.mark.parametrize("kind", KINDS)
    def test_chunked_prefill(self, both, kind):
        p = _prompt(21, 2)
        waves = [[(p, 6, "x"), (_prompt(13, 3), 6, None)], [(p, 6, "y")]]
        got, want, stats = both(kind, waves, prefill_mode="chunked",
                                prefill_chunk=8)
        assert got == want
        assert stats["chunked_prefill_tokens"] > 0

    @pytest.mark.parametrize("kind", ["paged", "int8"])
    def test_prefix_hit(self, both, kind):
        p = _prompt(2 * BS + 3, 4)
        follower = p[:2 * BS] + _prompt(5, 5)
        waves = [[(p, 6, "x")], [(follower, 6, "x")], [(follower, 6, "y")]]
        got, want, stats = both(kind, waves)
        assert got == want
        assert stats["hit"] == 2 * BS       # x's follower hit, y's did not

    @pytest.mark.parametrize("kind", KINDS)
    def test_megastep4(self, both, kind):
        p = _prompt(9, 6)
        waves = [[(p, 10, "x"), (p, 7, None)], [(p, 10, "y"), (p, 3, "x")]]
        got, want, _ = both(kind, waves, megastep=4)
        assert got == want

    @pytest.mark.parametrize("kind", KINDS)
    def test_aid0_equals_adapterless_ring(self, setup, kind):
        model, cfg, _, jcfg = setup
        reg, _ = _registries(cfg, jcfg)
        p = _prompt(10, 7)
        plain = ContinuousBatcher(model, cfg, **_ring_kw(kind))
        adapt = ContinuousBatcher(model, cfg, adapters=reg,
                                  **_ring_kw(kind))
        try:
            want = plain.submit(p, max_new_tokens=8).result(timeout=300)
            hx = adapt.submit(p, max_new_tokens=8, adapter="x")
            hb = adapt.submit(p, max_new_tokens=8)
            assert hb.result(timeout=300) == want
            assert hx.result(timeout=300) != want
        finally:
            plain.close()
            adapt.close()

    def test_generate_lora_equals_ring(self, setup):
        """``decode.generate`` with the ring's ``lora`` leg (the stacks,
        per-row slots) gives each row the stream its ring lane gives."""
        model, cfg, _, jcfg = setup
        reg, _ = _registries(cfg, jcfg)
        p = _prompt(10, 8)
        b = ContinuousBatcher(model, cfg, adapters=reg,
                              **_ring_kw("contiguous"))
        try:
            want = [b.submit(p, max_new_tokens=6, adapter=a).result(
                timeout=300) for a in (None, "x", "y")]
        finally:
            b.close()
        with torch.inference_mode():
            got = D.generate(model, cfg, torch.as_tensor([p] * 3),
                             max_new_tokens=6, max_len=MAX_LEN,
                             lora=(reg.arrays(),
                                   torch.tensor([0, 1, 2], dtype=torch.int32)))
        assert got.tolist() == want


# ---------------------------------------------------------------------------
# Preemption, namespaces, refusals
# ---------------------------------------------------------------------------


def _throttle(b, delay=0.03):
    """Slow every ring dispatch; clearing the returned gate freezes the
    ring at its next dispatch (tests/test_torch_qos.py ``_throttle``)."""
    real = b.executor.replay
    gate = threading.Event()
    gate.set()

    def slow(plan):
        gate.wait(timeout=120)
        time.sleep(delay)
        return real(plan)

    b.executor.replay = slow
    return gate


def _wait(pred, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.001)


class TestPreemptAndNamespaces:
    @pytest.mark.parametrize("kind", ["paged", "int8"])
    def test_preempted_adapter_lane_restores(self, setup, kind):
        """An adapter lane spilled for a class-0 request resumes with its
        adapter (the spill carries ``aid``): its stream equals the JAX
        ring's run of it alone."""
        from paddle_operator_tpu.infer.batcher import (
            ContinuousBatcher as JaxBatcher,
        )

        model, cfg, jparams, jcfg = setup
        reg, jreg = _registries(cfg, jcfg)
        p, p0 = _prompt(9, 9), _prompt(7, 10)
        jb = JaxBatcher(jparams, jcfg, adapters=jreg,
                        **_ring_kw(kind, slots=1))
        try:
            want = jb.submit(p, max_new_tokens=24,
                             adapter="x").result(timeout=300)
            want0 = jb.submit(p0, max_new_tokens=4).result(timeout=300)
        finally:
            jb.close()
        b = ContinuousBatcher(model, cfg, adapters=reg,
                              **_ring_kw(kind, slots=1))
        try:
            gate = _throttle(b)
            h = b.submit(p, max_new_tokens=24, adapter="x")
            _wait(lambda: b.stats["admitted"] > 0, "never admitted")
            gate.clear()
            _wait(lambda: b.executor.aid_host[0] == 1, "no aid")
            h0 = b.submit(p0, max_new_tokens=4, priority=0)
            gate.set()
            assert h0.result(timeout=300) == want0
            assert h.result(timeout=300) == want
            assert b.stats["preempted_lanes"] >= 1
            assert b.stats["restored_lanes"] >= 1
            assert b.executor.aid_host.tolist() == [0]
            b.pool.check_invariant()
        finally:
            b.close()

    def test_no_cross_adapter_prefix_hits(self, setup):
        """tests/test_qos.py TestAdapterPrefixNamespace: the radix cache
        never serves one adapter's prefix to another (nor to the base
        model), across an evict and reload of one slot too."""
        model, cfg, _, _ = setup
        reg = TQ.AdapterRegistry(cfg, capacity=2, rank=RANK, device="cpu")
        reg.load("x", seed=7)
        b = ContinuousBatcher(model, cfg, adapters=reg,
                              **_ring_kw("paged", slots=1))
        try:
            p = _prompt(2 * BS + 3, 11)
            b.submit(p, max_new_tokens=2).result(timeout=300)
            hit0 = b.pool.stats["prefix_hit_tokens"]
            b.submit(p, max_new_tokens=2, adapter="x").result(timeout=300)
            assert b.pool.stats["prefix_hit_tokens"] == hit0
            b.submit(p, max_new_tokens=2, adapter="x").result(timeout=300)
            hit1 = b.pool.stats["prefix_hit_tokens"]
            assert hit1 > hit0
            reg.evict("x")
            reg.load("x", seed=11)
            b.submit(p, max_new_tokens=2, adapter="x").result(timeout=300)
            assert b.pool.stats["prefix_hit_tokens"] == hit1
            # the base model still hits its own chain
            b.submit(p, max_new_tokens=2).result(timeout=300)
            assert b.pool.stats["prefix_hit_tokens"] > hit1
            b.pool.check_invariant()
        finally:
            b.close()

    def test_store_never_takes_an_adapter_namespace(self, setup):
        """Under churn through a 2-block host tier with a durable store
        attached, adapter chains demote and overflow like any other, but
        only base-namespace payloads are offered to the store, and only
        base requests probe it at submit."""
        model, cfg, _, jcfg = setup
        reg, _ = _registries(cfg, jcfg)

        class Store:
            def __init__(self):
                self.offers, self.probes = [], 0

            def offer(self, key, chunk, payload, ns=0):
                self.offers.append(ns)

            def fetch(self, tokens, bs, ns=0, skip=0):
                self.probes += 1
                return [], [], [], None

            def shed_oldest(self):
                return False

        b = ContinuousBatcher(model, cfg, adapters=reg,
                              **_ring_kw("paged", slots=1, num_blocks=8,
                                         host_cache_blocks=2))
        store = Store()
        b.attach_kv_store(store)
        try:
            for i in range(4):
                for a in ("x", None, "y"):
                    b.submit(_prompt(2 * BS + 1, 20 + i), max_new_tokens=2,
                             adapter=a).result(timeout=300)
            assert b.pool.stats["host_demotions"] > 0
            assert store.offers and set(store.offers) == {0}
            assert b.stats["kv_store_probes"] == store.probes == 4
            b.pool.check_invariant()
        finally:
            b.close()

    def test_spec_ring_refuses_adapters(self, setup, capsys):
        model, cfg, _, jcfg = setup
        reg, _ = _registries(cfg, jcfg)
        dcfg = cfg.draft()
        dmodel = Llama(dcfg, "cpu")
        with pytest.raises(ValueError, match="speculative rings") as e:
            ContinuousBatcher(model, cfg, adapters=reg, draft_params=dmodel,
                              draft_cfg=dcfg, spec_k=2,
                              **_ring_kw("contiguous"))
        assert str(e.value) == ("adapters are not supported on speculative "
                                "rings (the draft proposes base-only); "
                                "disable one of them")
        b = ContinuousBatcher(model, cfg, draft_params=dmodel,
                              draft_cfg=dcfg, spec_k=2,
                              **_ring_kw("contiguous"))
        try:
            with pytest.raises(ValueError, match="speculative rings "
                               r"\(the draft proposes base-only\)"):
                b.submit([1, 2, 3], max_new_tokens=2, adapter="x")
        finally:
            b.close()
        # the entry point's wiring: ignored beside SERVE_SPEC_K, with the
        # JAX server's line; built otherwise
        env = {"SERVE_ADAPTERS": "acme", "SERVE_ADAPTER_RANK": "2"}
        assert S.adapter_kw_from_env(env, cfg, 2, "cpu") == {}
        assert capsys.readouterr().out.strip() == (
            "SERVE_ADAPTERS ignored: adapters are not supported on "
            "speculative rings (the draft proposes base-only)")
        kw = S.adapter_kw_from_env(env, cfg, 0, "cpu")
        assert kw["adapters"].names() == ["acme"] \
            and kw["adapters"].rank == 2
        assert S.adapter_kw_from_env({}, cfg, 0, "cpu") == {}

    def test_queued_then_evicted_is_refused(self, setup):
        """A request queued for an adapter that is evicted (and its slot
        reloaded) before its admission fails with JAX's message."""
        model, cfg, _, jcfg = setup
        reg, _ = _registries(cfg, jcfg)
        b = ContinuousBatcher(model, cfg, adapters=reg,
                              **_ring_kw("paged", slots=1))
        try:
            gate = _throttle(b)
            h = b.submit(_prompt(9, 12), max_new_tokens=12)
            _wait(lambda: b.stats["admitted"] > 0, "never admitted")
            gate.clear()
            hq = b.submit(_prompt(9, 13), max_new_tokens=4, adapter="y")
            reg.evict("y")
            reg.load("z", seed=3)            # reuses y's slot
            gate.set()
            h.result(timeout=300)
            with pytest.raises(ValueError, match=(
                    r"adapter 'y' was evicted/replaced while this request "
                    r"was queued; resubmit")):
                hq.result(timeout=300)
            assert b.executor.aid_host.tolist() == [0]
            # the ring serves on
            assert len(b.submit(_prompt(5, 14), max_new_tokens=2,
                                adapter="z").result(timeout=300)) == 7
        finally:
            b.close()

    def test_submit_validation(self, setup):
        model, cfg, _, jcfg = setup
        reg, _ = _registries(cfg, jcfg)
        b = ContinuousBatcher(model, cfg, adapters=reg,
                              **_ring_kw("paged"))
        plain = ContinuousBatcher(model, cfg, **_ring_kw("paged"))
        try:
            with pytest.raises(ValueError, match="unknown adapter 'nope'"):
                b.submit([1, 2, 3], max_new_tokens=2, adapter="nope")
            with pytest.raises(ValueError, match="no adapter registry"):
                plain.submit([1, 2, 3], max_new_tokens=2, adapter="x")
            st = b.serving_status()
            assert st["activeAdapters"] == 2
            assert st["adapterNames"] == ["x", "y"]
            assert plain.serving_status()["adapterNames"] == []
        finally:
            b.close()
            plain.close()

    def test_lora_on_weight_quant_base(self, setup):
        """tests/test_weight_quant.py test_lora_on_quantized_base_parity:
        the deltas add after the quantized ``_mm``; base traffic equals
        the adapterless quantized ring, an adapter changes the stream,
        and both equal the JAX quantized ring's."""
        from paddle_operator_tpu.infer import quant as JQ
        from paddle_operator_tpu.infer.batcher import (
            ContinuousBatcher as JaxBatcher,
        )
        from paddle_operator_tpu_torch.infer import quant as Q

        model, cfg, jparams, jcfg = setup
        qm = Q.quantize_params(copy.deepcopy(model), cfg, mode="int8",
                               skip=Q.SERVING_SKIP)
        jq = JQ.quantize_params(jparams, jcfg, mode="int8",
                                skip=JQ.SERVING_SKIP)
        reg, jreg = _registries(cfg, jcfg)
        p = _prompt(10, 15)
        plain = ContinuousBatcher(qm, cfg, **_ring_kw("paged"))
        b = ContinuousBatcher(qm, cfg, adapters=reg, **_ring_kw("paged"))
        jb = JaxBatcher(jq, jcfg, adapters=jreg, **_ring_kw("paged"))
        try:
            ref = plain.submit(p, max_new_tokens=8).result(timeout=300)
            base = b.submit(p, max_new_tokens=8).result(timeout=300)
            lora = b.submit(p, max_new_tokens=8,
                            adapter="x").result(timeout=300)
            assert base == ref
            assert lora != base
            assert jb.submit(p, max_new_tokens=8).result(
                timeout=300) == base
            assert jb.submit(p, max_new_tokens=8, adapter="x").result(
                timeout=300) == lora
            assert b.serving_status()["weightQuantMode"] == "int8"
        finally:
            plain.close()
            b.close()
            jb.close()


# ---------------------------------------------------------------------------
# Over HTTP: /v1/adapters and the router's adapter scrape
# ---------------------------------------------------------------------------


def _call(url, method="GET", body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


class TestHttp:
    @pytest.fixture(scope="class")
    def server(self, setup):
        model, cfg, _, jcfg = setup
        reg, _ = _registries(cfg, jcfg)
        srv = S.make_server("127.0.0.1", 0, model, cfg, continuous=True,
                            adapters=reg, job="j", replica="r0",
                            **_ring_kw("paged"))
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        yield srv, f"http://127.0.0.1:{srv.server_address[1]}"
        srv.shutdown()
        srv.server_close()
        srv.generator.close()

    def test_get_load_serve_evict(self, server, setup):
        srv, url = server
        model, cfg, _, _ = setup
        code, body = _call(url + "/v1/adapters")
        assert code == 200 and json.loads(body) == {
            "adapters": ["x", "y"], "capacity": 3, "rank": RANK}
        code, body = _call(url + "/v1/adapters", "POST",
                           {"load": {"name": "orbit", "seed": 3}})
        assert code == 200 and json.loads(body) == {"loaded": "orbit",
                                                    "slot": 3}
        p = _prompt(10, 16)
        gen = {"tokens": [p], "max_new_tokens": 6}
        code, base = _call(url + "/v1/generate", "POST", gen)
        code2, orbit = _call(url + "/v1/generate", "POST",
                             dict(gen, adapter="orbit"))
        assert code == code2 == 200
        assert json.loads(orbit) != json.loads(base)
        # the loaded adapter is the seed-3 smoke adapter: a fresh ring
        # booted with it streams the same tokens
        reg = TQ.AdapterRegistry(cfg, capacity=1, rank=RANK, device="cpu")
        reg.load("orbit", seed=3)
        b = ContinuousBatcher(model, cfg, adapters=reg, **_ring_kw("paged"))
        try:
            assert [b.submit(p, max_new_tokens=6, adapter="orbit").result(
                timeout=300)] == json.loads(orbit)["tokens"]
        finally:
            b.close()
        # 409 while a lane serves it
        batcher = srv.generator.batcher
        gate = _throttle(batcher)
        try:
            h = batcher.submit(p, max_new_tokens=40, adapter="orbit")
            _wait(lambda: 3 in batcher.executor.aid_host.tolist(),
                  "orbit never admitted")
            gate.clear()
            code, body = _call(url + "/v1/adapters", "POST",
                               {"evict": "orbit"})
            assert code == 409 and "serving resident lanes" in \
                json.loads(body)["error"]
            code, _ = _call(url + "/v1/adapters", "POST",
                            {"load": {"name": "orbit", "seed": 4}})
            assert code == 409
        finally:
            gate.set()
            del batcher.executor.replay     # the unthrottled method
        h.result(timeout=300)
        code, body = _call(url + "/v1/adapters", "POST", {"evict": "orbit"})
        assert code == 200 and json.loads(body) == {"evicted": "orbit"}
        code, body = _call(url + "/v1/generate", "POST",
                           dict(gen, adapter="orbit"))
        assert code == 400 and "unknown adapter" in json.loads(body)["error"]

    @pytest.mark.parametrize("body", [
        {"evict": "nope"}, {"load": {"name": "bad name"}}, {"neither": 1},
        {"load": {"name": "f", "path": "/nonexistent/deltas.npz"}}])
    def test_admin_errors_are_400(self, server, body):
        _, url = server
        code, out = _call(url + "/v1/adapters", "POST", body)
        assert code == 400 and "error" in json.loads(out)

    def test_router_reads_adapter_gauges(self, server):
        """The JAX router's ``parse_adapter_gauges`` on the torch
        replica's /metrics follows a runtime load and evict: the router
        routes to a port replica by adapter."""
        from paddle_operator_tpu.router.router import parse_adapter_gauges

        _, url = server

        def loaded():
            with urllib.request.urlopen(url + "/metrics", timeout=60) as r:
                return parse_adapter_gauges(r.read().decode())

        assert loaded() == {"x", "y"}
        assert _call(url + "/v1/adapters", "POST",
                     {"load": {"name": "mint"}})[0] == 200
        assert loaded() == {"x", "y", "mint"}
        assert _call(url + "/v1/adapters", "POST",
                     {"evict": "mint"})[0] == 200
        assert loaded() == {"x", "y"}

    def test_batch_server_ignores_adapter(self, setup):
        """The batch server ignores a request's ``adapter``, as the JAX
        batch server does: the base model's tokens, and its
        /v1/adapters answers as without a registry."""
        from paddle_operator_tpu.infer.serve import (
            make_server as jax_make_server,
        )

        model, cfg, jparams, jcfg = setup
        srvs = [S.make_server("127.0.0.1", 0, model, cfg),
                jax_make_server("127.0.0.1", 0, jparams, jcfg)]
        try:
            for srv in srvs:
                threading.Thread(target=srv.serve_forever,
                                 daemon=True).start()
            urls = [f"http://127.0.0.1:{s.server_address[1]}" for s in srvs]
            gen = {"tokens": [_prompt(6, 17)], "max_new_tokens": 4}
            outs = [[_call(u + "/v1/generate", "POST", dict(gen, adapter=a))
                     for a in (None, "x")] for u in urls]
            assert outs[0] == outs[1]
            assert outs[0][0] == outs[0][1] and outs[0][0][0] == 200
            for u in urls:
                assert _call(u + "/v1/adapters", "POST",
                             {"load": {"name": "x"}})[0] == 400
        finally:
            for srv in srvs:
                srv.shutdown()
                srv.server_close()


# ---------------------------------------------------------------------------
# On the card: a load after capture, under graph replay
# ---------------------------------------------------------------------------


@pytest.mark.cuda
class TestOnCard:
    @pytest.mark.parametrize("kind", KINDS)
    def test_load_after_capture_equals_booted_ring(self, kind):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")
        model, cfg = make_model("tiny", device="cuda", seed=0,
                                dtype=torch.float32)
        p = _prompt(10, 18)
        booted = TQ.AdapterRegistry(cfg, capacity=2, rank=RANK)
        booted.load("x", seed=7)
        late = TQ.AdapterRegistry(cfg, capacity=2, rank=RANK)
        # one ring at a time: two prewarm threads would capture at once
        b0 = ContinuousBatcher(model, cfg, adapters=booted, prewarm=True,
                               **_ring_kw(kind))
        try:
            want = b0.submit(p, max_new_tokens=12,
                             adapter="x").result(timeout=300)
        finally:
            b0.close()
        b1 = ContinuousBatcher(model, cfg, adapters=late, prewarm=True,
                               **_ring_kw(kind))
        try:
            assert b1.prewarmed.wait(300), "prewarm never finished"
            assert not b1.executor.needs_capture, b1.prewarm_error
            graphs, ptrs = b1.executor._graphs, b1.executor._state_ptrs()
            base = b1.submit(p, max_new_tokens=12).result(timeout=300)
            late.load("x", seed=7)             # after capture, in place
            got = b1.submit(p, max_new_tokens=12,
                            adapter="x").result(timeout=300)
            assert got == want != base
            assert b1.executor._graphs is graphs
            assert b1.executor._state_ptrs() == ptrs
        finally:
            b1.close()
