"""The torch package's speculative RING (SERVE_SPEC_K, SERVE_DRAFT,
SERVE_DRAFT_QUANT, TPUJOB_DRAFT_CHECKPOINT_PATH) held against the JAX
package, on converted ``tiny`` f32 params (target from seed 0, a random
draft from seed 1) and numpy-seeded prompts:

- ``ContinuousBatcher(spec_k=3)`` greedy streams equal JAX
  ``decode.generate`` on the contiguous and bf16 paged rings, and JAX's
  own (non-speculative) int8 ring on the int8 ring, at megastep 1 and 4,
  with a random draft that rejects and a self-draft that accepts every
  draft; with chunked prefill (the speculative final inserts); with a
  preemption mid-speculation on both pools (the spill carries the draft
  lane); with the draft quantized (``SERVE_DRAFT_QUANT=int8``);
- the cases of tests/test_speculative.py TestSpeculativeRing (eos inside
  a speculated block, the capacity bound, a draft required); a sampled
  ring lane equals ``speculative_generate`` with its seed;
- ``/statusz`` ``specK``, ``acceptRate`` and ``draftQuantMode`` and the
  ``tpujob_serve_accept_rate`` gauge against the JAX replica's on the
  same traffic; ``spec_kw_from_env`` and ``refuse_unported`` read the
  four knobs as the JAX entry point does; the HTTP server carries
  ``accept_rate`` in responses and in a stream's done event;
- on the card (``cuda``-marked, skipped here): the round under graph
  replay equals the eager program, and kernel #1 launches draft
  n_layers x (K+1) times a round while the paged kernels do not launch.
"""

import copy
import json
import threading
import time
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

try:
    from paddle_operator_tpu.infer import decode as JD
    from paddle_operator_tpu.infer.batcher import (
        ContinuousBatcher as JaxBatcher,
    )
    from paddle_operator_tpu.models.llama import Llama as JaxLlama
    from paddle_operator_tpu.models.llama import (
        make_model as jax_make_model,
    )
    NO_FLAX = None
except ModuleNotFoundError as e:
    # the card's machine has JAX but not flax: there the JAX-held tests
    # skip and the ``cuda`` cases, which need only the port, run
    if e.name != "flax":
        raise
    NO_FLAX = e
from paddle_operator_tpu_torch.convert import params_from_jax
from paddle_operator_tpu_torch.infer import executor as X
from paddle_operator_tpu_torch.infer import quant as Q
from paddle_operator_tpu_torch.infer import serve as S
from paddle_operator_tpu_torch.infer import speculative as SP
from paddle_operator_tpu_torch.infer.batcher import ContinuousBatcher
from paddle_operator_tpu_torch.infer.qos import QoSConfig
from paddle_operator_tpu_torch.models.llama import Llama, make_model

MAX_LEN = 64
BS = 8
K = 3
RINGS = {"contig": {"paged": False},
         "paged": {"paged": True, "block_size": BS},
         "int8": {"paged": True, "block_size": BS, "kv_quant": "int8"}}
LENS = (5, 11, 8, 13)
NEW = 9


@pytest.fixture(scope="module")
def setup():
    if NO_FLAX is not None:
        pytest.skip(f"the JAX package cannot be imported here: {NO_FLAX}")
    jmodel, jcfg = jax_make_model("tiny", dtype=jnp.float32)
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
    refs = {}

    def ref(prompt, new, ring="contig"):
        """JAX's greedy stream: ``generate``, or the JAX int8 ring's
        (memoized)."""
        key = (tuple(int(t) for t in prompt), new, ring == "int8")
        if key not in refs:
            if ring == "int8":
                jb = JaxBatcher(jparams, jcfg, slots=2, max_len=MAX_LEN,
                                chunk_tokens=4, prefill_buckets=(16, MAX_LEN),
                                paged=True, block_size=BS, kv_quant="int8",
                                prefix_cache=False)
                try:
                    refs[key] = jb.submit(prompt, max_new_tokens=new).result(
                        timeout=300)
                finally:
                    jb.close()
            else:
                refs[key] = np.asarray(JD.generate(
                    jparams, jcfg, jnp.asarray([prompt], jnp.int32),
                    max_new_tokens=new, max_len=MAX_LEN)[0]).tolist()
        return refs[key]

    return {"jcfg": jcfg, "jparams": jparams, "jdcfg": jdcfg,
            "jdparams": jdparams, "cfg": cfg, "model": model, "dcfg": dcfg,
            "dmodel": dmodel, "ref": ref}


def _prompt(s, seed):
    return np.random.default_rng(seed).integers(0, 256, s).astype(
        np.int32).tolist()


PROMPTS = [_prompt(n, 10 + i) for i, n in enumerate(LENS)]


def _batcher(st, ring, draft="random", **kw):
    dm, dc = ((st["dmodel"], st["dcfg"]) if draft == "random"
              else (st["model"], st["cfg"]))
    kw.setdefault("slots", 2)
    kw.setdefault("max_len", MAX_LEN)
    kw.setdefault("chunk_tokens", 4)
    kw.setdefault("prefill_buckets", (16, MAX_LEN))
    return ContinuousBatcher(st["model"], st["cfg"], draft_params=dm,
                             draft_cfg=dc, spec_k=K, **RINGS[ring], **kw)


def _serve(b, prompts=PROMPTS, new=NEW):
    reqs = [b.submit(p, max_new_tokens=new) for p in prompts]
    return [r.result(timeout=300) for r in reqs], reqs


def _wait(pred, what, timeout=60.0):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, what
        time.sleep(0.001)


# ---------------------------------------------------------------------------
# greedy streams
# ---------------------------------------------------------------------------


class TestRingStreams:
    @pytest.mark.parametrize("draft", ["random", "self"])
    @pytest.mark.parametrize("megastep", [1, 4])
    @pytest.mark.parametrize("ring", list(RINGS))
    def test_streams_equal_jax(self, setup, ring, megastep, draft):
        """Four ragged prompts through two lanes: every stream equals
        JAX's; a random draft accepts (almost) nothing, a self-draft
        every draft; each request carries its acceptance."""
        st = setup
        b = _batcher(st, ring, draft, megastep=megastep)
        try:
            got, reqs = _serve(b)
            status = b.serving_status()
            if b.pool is not None:
                b.pool.check_invariant()
                assert b.pool.blocks_free() == b.pool.total - 1
        finally:
            b.close()
        assert got == [st["ref"](p, NEW, ring) for p in PROMPTS]
        assert b.stats["admitted"] == 4 == b.stats["evicted"]
        assert b.stats["spec_drafted"] > 0
        rates = [r.accept_rate for r in reqs]
        assert all(r is not None for r in rates)
        assert status["specK"] == K
        if draft == "self":
            assert rates == [1.0] * 4 and status["acceptRate"] == 1.0
        else:
            assert status["acceptRate"] < 0.5

    @pytest.mark.parametrize("megastep", [1, 4])
    @pytest.mark.parametrize("ring", list(RINGS))
    def test_chunked_prefill_streams_equal_jax(self, setup, ring, megastep):
        """``prefill_mode="chunked"`` with 5-row slices: the final slice
        runs the speculative final insert (the draft prefilled whole),
        and every stream equals JAX's."""
        st = setup
        b = _batcher(st, ring, megastep=megastep, prefill_mode="chunked",
                     prefill_chunk=5)
        try:
            got, _ = _serve(b)
            assert b.stats["chunked_prefill_tokens"] == sum(LENS)
            assert not b._prefilling
        finally:
            b.close()
        assert got == [st["ref"](p, NEW, ring) for p in PROMPTS]

    @pytest.mark.parametrize("ring", ["paged", "int8"])
    def test_draft_quant_int8_equals_jax(self, setup, ring):
        """The draft quantized as ``SERVE_DRAFT_QUANT=int8`` builds it
        (the serving skip list): greedy tokens cannot change (only the
        acceptance may), and ``draftQuantMode`` reads int8."""
        st = setup
        dq = Q.quantize_params(copy.deepcopy(st["dmodel"]), st["dcfg"],
                               mode="int8", skip=Q.SERVING_SKIP)
        b = ContinuousBatcher(st["model"], st["cfg"], slots=2,
                              max_len=MAX_LEN, chunk_tokens=4,
                              prefill_buckets=(16, MAX_LEN), draft_params=dq,
                              draft_cfg=st["dcfg"], spec_k=K, **RINGS[ring])
        try:
            got, _ = _serve(b)
            status = b.serving_status()
        finally:
            b.close()
        assert got == [st["ref"](p, NEW, ring) for p in PROMPTS]
        assert status["draftQuantMode"] == "int8"
        assert status["weightQuantMode"] == "none"
        assert status["paramBytes"] == (Q.param_bytes(st["model"])
                                        + Q.param_bytes(dq))


# ---------------------------------------------------------------------------
# preemption mid-speculation
# ---------------------------------------------------------------------------


def _throttle(b, delay=0.03):
    """Slow every dispatch; return a gate whose clear() freezes the
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


@pytest.mark.parametrize("megastep", [1, 4])
@pytest.mark.parametrize("ring", ["paged", "int8"])
def test_preemption_mid_speculation_resumes_bit_identical(setup, ring,
                                                          megastep):
    """A class-0 arrival spills the resident class-1 lane mid-stream
    (its blocks, tail, and the DRAFT lane: ``dk``, ``dv``, ``dpos``),
    and the victim resumes in the other slot with its uninterrupted
    stream — JAX's — under a self-draft whose acceptances make any lost
    draft context show."""
    st = setup
    p = _prompt(9, 3)
    b = _batcher(st, ring, "self", slots=1, num_blocks=16,
                 megastep=megastep, qos=QoSConfig(priorities=2,
                                                  default_priority=1))
    spills = []
    real_spill = b.executor.spill_lane

    def spy(slot):
        spill = real_spill(slot)
        spills.append(spill)
        return spill

    b.executor.spill_lane = spy
    try:
        want = b.submit(p, max_new_tokens=48).result(timeout=300)
        gate = _throttle(b)
        n0, c0 = b.stats["admitted"], b.stats["chunks"]
        h_long = b.submit(p, max_new_tokens=48)
        _wait(lambda: b.stats["admitted"] > n0, "the victim was admitted")
        _wait(lambda: b.stats["chunks"] > c0, "the victim decoded")
        gate.clear()
        h0 = b.submit(_prompt(7, 5), max_new_tokens=4, priority=0)
        gate.set()
        h0.result(timeout=300)
        assert h_long.result(timeout=300) == want \
            == st["ref"](p, 48, ring)
        assert b.stats["preempted_lanes"] == b.stats["restored_lanes"] >= 1
        assert {"dk", "dv", "dpos"} <= set(spills[0])
        assert spills[0]["dpos"] == spills[0]["pos"]
        b.pool.check_invariant()
    finally:
        b.close()


# ---------------------------------------------------------------------------
# tests/test_speculative.py TestSpeculativeRing, and a sampled lane
# ---------------------------------------------------------------------------


class TestSpeculativeRing:
    @pytest.mark.parametrize("ring", ["contig", "paged"])
    def test_eos_in_ring_spec_block(self, setup, ring):
        st = setup
        p = _prompt(7, 3)
        full = st["ref"](p, 12)
        eos = full[7 + 6]
        want = full[:full.index(eos, 7) + 1]
        b = _batcher(st, ring, "self")             # all-accept blocks
        try:
            assert b.submit(p, max_new_tokens=12, eos_token=eos).result(
                timeout=300) == want
        finally:
            b.close()

    def test_spec_capacity_bound(self, setup):
        st = setup
        b = _batcher(st, "contig")
        try:
            with pytest.raises(ValueError, match="speculative headroom"):
                b.submit(list(range(1, 60)), max_new_tokens=4)
            out = b.submit(list(range(1, 50)),
                           max_new_tokens=4).result(timeout=300)
            assert len(out) == 49 + 4
        finally:
            b.close()

    def test_spec_requires_draft(self, setup):
        st = setup
        with pytest.raises(ValueError, match="draft_params"):
            ContinuousBatcher(st["model"], st["cfg"], slots=1,
                              max_len=MAX_LEN, spec_k=2)

    def test_prefix_cache_and_host_tier_off(self, setup):
        """A speculative paged ring turns the radix cache and the host
        tier off, as the JAX ring does: a repeated prompt prefills
        again."""
        st = setup
        b = _batcher(st, "paged", host_cache_blocks=8)
        try:
            assert not b.executor.prefix_cache
            assert b.executor.host_cache_blocks == 0
            p = _prompt(20, 4)
            for _ in range(2):
                b.submit(p, max_new_tokens=3).result(timeout=300)
            assert b.stats["prefill_tokens"] == 40
        finally:
            b.close()

    @pytest.mark.parametrize("ring", ["contig", "int8"])
    def test_sampled_lane_equals_speculative_generate(self, setup, ring):
        """Temperature 0.8, seed 77: a ring lane draws what
        ``speculative_generate`` draws for a lane of that seed (the
        first token at the prompt's last position, then the three round
        streams) — deterministic per seed, in the vocab, whatever slot
        and co-residents the lane has (contiguous ring: exact cache;
        the int8 ring is held to itself across two runs)."""
        st = setup
        p = _prompt(10, 8)
        outs = []
        for _ in range(2):
            b = _batcher(st, ring, "self")
            try:
                other = b.submit(_prompt(6, 9), max_new_tokens=12)
                outs.append(b.submit(p, max_new_tokens=12, temperature=0.8,
                                     seed=77).result(timeout=300))
                other.result(timeout=300)
            finally:
                b.close()
        assert outs[0] == outs[1]
        assert all(0 <= t < st["cfg"].vocab_size for t in outs[0])
        if ring == "contig":
            want = SP.speculative_generate(
                st["model"], st["model"], st["cfg"], st["cfg"],
                torch.as_tensor([p]), max_new_tokens=12, spec_k=K,
                temperature=0.8, seed=77, max_len=MAX_LEN)
            assert outs[0] == want[0].tolist()


# ---------------------------------------------------------------------------
# status, gauges, the env and the HTTP surface
# ---------------------------------------------------------------------------


class TestStatusAndEnv:
    @pytest.mark.parametrize("dquant", ["none", "int8"])
    def test_status_and_gauges_equal_jax(self, setup, dquant):
        """The same traffic through the JAX ring and the port's (same
        draft, quantized alike): ``specK``, ``acceptRate`` and
        ``draftQuantMode`` equal, and so do the gauge lines of
        ``tpujob_serve_accept_rate`` and the draft-quant mode."""
        from paddle_operator_tpu.infer import quant as JQ
        from paddle_operator_tpu.utils import observability as JO
        from paddle_operator_tpu_torch.utils import observability as TO

        st = setup
        jdp, tdp = st["jdparams"], st["dmodel"]
        if dquant != "none":
            jdp = JQ.quantize_params(jdp, st["jdcfg"], mode=dquant,
                                     skip=JQ.SERVING_SKIP)
            tdp = Q.quantize_params(copy.deepcopy(tdp), st["dcfg"],
                                    mode=dquant, skip=Q.SERVING_SKIP)
        kw = dict(slots=2, max_len=MAX_LEN, chunk_tokens=4,
                  prefill_buckets=(16, MAX_LEN), paged=True, block_size=BS,
                  spec_k=K)
        jb = JaxBatcher(st["jparams"], st["jcfg"], draft_params=jdp,
                        draft_cfg=st["jdcfg"], **kw)
        b = ContinuousBatcher(st["model"], st["cfg"], draft_params=tdp,
                              draft_cfg=st["dcfg"], **kw)
        try:
            for ring in (jb, b):
                for p in PROMPTS[:2]:
                    ring.submit(p, max_new_tokens=NEW).result(timeout=300)
            want, got = jb.serving_status(), b.serving_status()
        finally:
            b.close()
            jb.close()
        for key in ("specK", "acceptRate", "draftQuantMode"):
            if key in want:
                assert got[key] == want[key], key
        assert got["draftQuantMode"] == dquant
        tg, jg = (TO.serving_gauges(got, "ns/j", "r0"),
                  JO.serving_gauges(want, "ns/j", "r0"))
        for name in ("tpujob_serve_accept_rate",
                     "tpujob_serve_weight_quant_mode"):
            lines = {k: v for k, v in tg.items() if k.startswith(name)}
            assert lines and lines == {k: v for k, v in jg.items()
                                       if k.startswith(name)}
        assert b._fingerprint()["specK"] == K

    @pytest.mark.parametrize("env", [
        {"SERVE_SPEC_K": "3"},
        {"SERVE_SPEC_K": "2", "SERVE_DRAFT": "tiny"},
        {"SERVE_SPEC_K": "4", "SERVE_DRAFT_QUANT": "int8"},
        {"SERVE_SPEC_K": "4", "SERVE_DRAFT_QUANT": "int4"},
        {"SERVE_SPEC_K": "0", "SERVE_DRAFT_QUANT": "int8"},
        {"SERVE_SPEC_K": "2", "SERVE_DRAFT": "giant"}],
        ids=lambda e: "-".join(f"{k}={v}" for k, v in e.items()))
    def test_spec_kw_from_env(self, setup, monkeypatch, tmp_path, env):
        """The knobs pass ``refuse_unported`` and build what the JAX
        entry point builds: no draft at ``SERVE_SPEC_K`` 0; "auto" is
        ``cfg.draft()``, a preset name that preset, another name a
        ValueError naming it; a fresh draft is the seed-1 init (never
        the target's ``TPUJOB_CHECKPOINT_PATH``); ``SERVE_DRAFT_QUANT``
        quantizes the draft alone."""
        st = setup
        environ = {"SERVE_CONTINUOUS": "1", "SERVE_PAGED": "1", **env}
        S.refuse_unported(environ)
        monkeypatch.setenv("TPUJOB_CHECKPOINT_PATH", str(tmp_path))
        if env.get("SERVE_DRAFT") == "giant":
            with pytest.raises(ValueError, match="giant"):
                S.spec_kw_from_env(environ, st["cfg"], "cpu")
            return
        kw = S.spec_kw_from_env(environ, st["cfg"], "cpu")
        if env["SERVE_SPEC_K"] == "0":
            assert kw == {}
            return
        assert kw["spec_k"] == int(env["SERVE_SPEC_K"])
        dcfg = kw["draft_cfg"]
        if env.get("SERVE_DRAFT") == "tiny":
            assert dcfg.n_layers == 2 and dcfg.dim == 64
        else:
            assert (dcfg.n_layers, dcfg.dim) == (st["dcfg"].n_layers,
                                                 st["dcfg"].dim)
        assert Q.weight_quant_mode(kw["draft_params"]) == env.get(
            "SERVE_DRAFT_QUANT", "none")
        if "SERVE_DRAFT_QUANT" not in env:
            gen = torch.Generator()
            gen.manual_seed(1)
            fresh = Llama(dcfg, "cpu").init_weights(gen)
            assert torch.equal(fresh.lm_head.kernel,
                               kw["draft_params"].lm_head.kernel)

    def test_draft_checkpoint_path_restores_the_draft(self, setup, tmp_path):
        """``TPUJOB_DRAFT_CHECKPOINT_PATH``: the draft's newest step is
        restored as the target's is (``load_serving_params``), and the
        ring serves JAX's greedy tokens with it."""
        from paddle_operator_tpu_torch.train.checkpoint import (
            CheckpointManager,
        )
        from paddle_operator_tpu_torch.train.trainer import (
            create_state,
            make_optimizer,
        )

        st = setup
        draft = copy.deepcopy(st["dmodel"])
        draft.requires_grad_(True)
        ckpt = CheckpointManager(str(tmp_path))
        assert ckpt.save(5, create_state(draft, make_optimizer()), force=True)
        ckpt.wait()
        kw = S.spec_kw_from_env(
            {"SERVE_SPEC_K": str(K),
             "TPUJOB_DRAFT_CHECKPOINT_PATH": str(tmp_path)}, st["cfg"],
            "cpu")
        for name, t in st["dmodel"].state_dict().items():
            assert torch.equal(kw["draft_params"].state_dict()[name], t), name
        b = ContinuousBatcher(st["model"], st["cfg"], slots=2,
                              max_len=MAX_LEN, chunk_tokens=4,
                              prefill_buckets=(16, MAX_LEN), **kw)
        try:
            got, _ = _serve(b, PROMPTS[:2])
        finally:
            b.close()
        assert got == [st["ref"](p, NEW) for p in PROMPTS[:2]]

    def test_http_server_carries_accept_rate(self, setup):
        """``make_server(spec_k=)`` serves: a response carries the rows'
        ``accept_rate`` and a stream's done event the request's;
        ``/statusz`` reads ``specK``."""
        st = setup
        srv = S.make_server("127.0.0.1", 0, st["model"], st["cfg"],
                            continuous=True, slots=2, max_len=MAX_LEN,
                            chunk_tokens=4, prefill_buckets=(16, MAX_LEN),
                            paged=True, block_size=BS,
                            draft_params=st["model"], draft_cfg=st["cfg"],
                            spec_k=K)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            rows = [PROMPTS[1], _prompt(len(PROMPTS[1]), 40)]
            req = urllib.request.Request(
                base + "/v1/generate", method="POST",
                data=json.dumps({"tokens": rows,
                                 "max_new_tokens": NEW}).encode())
            with urllib.request.urlopen(req, timeout=120) as r:
                body = json.loads(r.read())
            assert body["tokens"] == [st["ref"](p, NEW) for p in rows]
            assert body["accept_rate"] == [1.0, 1.0]
            req = urllib.request.Request(
                base + "/v1/generate", method="POST",
                data=json.dumps({"tokens": [PROMPTS[2]], "stream": True,
                                 "max_new_tokens": NEW}).encode())
            with urllib.request.urlopen(req, timeout=120) as r:
                events = [json.loads(ln) for ln in r.read().splitlines()
                          if ln.strip()]
            assert events[-1]["done"] and events[-1]["accept_rate"] == 1.0
            with urllib.request.urlopen(base + "/statusz", timeout=60) as r:
                status = json.loads(r.read())
            assert status["specK"] == K and status["acceptRate"] == 1.0
        finally:
            srv.shutdown()
            srv.server_close()
            srv.generator.close()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
class TestOnCard:
    @pytest.fixture(scope="class")
    def card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")
        model, cfg = make_model("tiny", device="cuda", seed=0,
                                dtype=torch.float32)
        model.requires_grad_(False)
        dcfg = cfg.draft()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(1)
        dmodel = Llama(dcfg, "cuda").init_weights(gen)
        dmodel.requires_grad_(False)
        return model, cfg, dmodel, dcfg

    def _executor(self, card, ring, megastep, dquant):
        model, cfg, dmodel, dcfg = card
        if dquant:
            dmodel = Q.quantize_params(copy.deepcopy(dmodel), dcfg,
                                       mode="int8", skip=Q.SERVING_SKIP)
        kw = dict(RINGS[ring])
        kw.pop("block_size", None)
        return X.RingExecutor(model, cfg, slots=3, max_len=MAX_LEN,
                              chunk_tokens=4, prefill_buckets=(16, MAX_LEN),
                              block_size=BS, megastep=megastep,
                              draft_params=dmodel, draft_cfg=dcfg, spec_k=K,
                              **kw)

    @pytest.mark.parametrize("ring,dquant", [
        ("contig", False), ("paged", False), ("int8", False),
        ("contig", True)], ids=["contig", "paged", "int8", "contig-dq"])
    def test_round_under_graphs_equals_eager_and_counts(self, card, ring,
                                                        dquant):
        """Two executors from the same admissions, one replaying the
        captured round and megastep, one running them eagerly: tokens,
        counts, raw counts, both positions and lane tokens equal bit for
        bit; each replay launches kernel #1 draft n_layers x (K+1) times
        a round and the paged kernels not at all, and with the draft
        quantized kernel #7 7 x draft n_layers x (K+1) times a round."""
        graph = self._executor(card, ring, 4, dquant)
        eager = self._executor(card, ring, 4, dquant)
        graph.prewarm()
        prompts = [_prompt(n, 30 + n) for n in (5, 19, 11)]
        n_layers = card[3].n_layers
        with torch.inference_mode():
            for ex in (graph, eager):
                for slot, p in enumerate(prompts):
                    dev = X.to_device(np.asarray([p], np.int32), ex.device)
                    ins = ex.inserts[16 if len(p) <= 16 else MAX_LEN]
                    if ex.paged:
                        ex.pool.admit(slot, p, max_suffix=0)
                        row = X.to_device(ex.pool.table[slot], ex.device,
                                          torch.int32)
                        ins(ex.params, ex.cache, row, ex.tok, ex.temp,
                            ex.seeds, dev, len(p), slot, 0.0, 0)
                    else:
                        ins(ex.params, ex.cache, ex.tok, ex.temp, ex.seeds,
                            dev, len(p), slot, 0.0, 0)
                    ex.draft_prefill(slot, dev, len(p))
            for k in range(4):
                n = 4 if k % 2 else 1
                for ex in (graph, eager):
                    if ex.paged:
                        for slot in range(3):
                            ex.pool.ensure(slot, len(prompts[slot])
                                           + (k + 1) * 4 * (K + 1))
                plan = X.ExecPlan(
                    n, [True, True, k < 2],
                    table=graph.pool.table if graph.paged else None,
                    eos=np.asarray([-1, -1, -1], np.int32),
                    left=np.asarray([40, 40, 40], np.int32),
                    steps=np.asarray([n, n, n], np.int32))
                c0 = X._launch_counts()
                res = graph.replay(plan)
                gt, gc = res.host()
                graw = res.raw_host()
                ticks = n * n_layers * (K + 1)
                assert [b - a for a, b in zip(c0, X._launch_counts())] \
                    == [ticks, 0, 0, 7 * ticks if dquant else 0, 0]
                eager._upload(plan)
                et, ec, er = eager._program(n)
                np.testing.assert_array_equal(gt, et.cpu().numpy())
                np.testing.assert_array_equal(gc, ec.cpu().numpy())
                np.testing.assert_array_equal(graw, er.cpu().numpy())
                for key in ("pos",):
                    assert torch.equal(graph.cache[key], eager.cache[key])
                    assert torch.equal(graph.dcache[key], eager.dcache[key])
                assert torch.equal(graph.tok, eager.tok)
