"""The torch package's weight-only int8/int4 quantization
(paddle_operator_tpu_torch/infer/quant.py, the quantized ``Dense`` of
models/llama.py, ``infer/decode.py`` ``_mm``) held against the JAX
package's (tests/test_weight_quant.py), on the ``tiny`` preset in f32,
the JAX init converted through numpy:

- ``quantize_leaf``: codes and scales equal JAX's bit for bit from f32
  and bf16 inputs, half-even ties and an all-zero column (scale 1.0)
  included; quantize -> dequantize -> quantize is a fixed point;
- ``quantize_params``: the quantized path set equals JAX's under
  ``SERVING_SKIP`` and under the legacy call; an unknown mode raises;
  ``weight_quant_mode`` and ``param_bytes`` equal JAX's;
- ``params_from_jax`` carries quantized trees (scanned and unscanned)
  into a quantized port model, codes and scales equal;
- ``_mm`` and ``quant_matmul_reference`` against JAX's ``_mm``; prefill
  and decode_step logits against the quantized JAX package's; the bound
  against the unquantized model at bf16 (``TOL = 0.15``, as
  TestLogitBound);
- the quantized rings (contiguous, paged cold and prefix hit, the int8
  pool, megastep 4) give the quantized ``generate``'s greedy tokens;
  ``/statusz`` reports ``weightQuantMode`` and ``paramBytes`` (JAX's
  number), and the ``/metrics`` gauge reads 1; the bf16 default still
  reports "none".

The kernel itself (ops/quant_matmul.py against its plain version, on
the card) is in tests/test_torch_quant_matmul.py.
"""

import copy
import dataclasses
import json
import re
import threading
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_operator_tpu.infer import decode as JD
from paddle_operator_tpu.infer import quant as JQ
from paddle_operator_tpu.infer.serve import make_server as jax_make_server
from paddle_operator_tpu.models.llama import make_model as jax_make_model
from paddle_operator_tpu_torch.convert import params_from_jax
from paddle_operator_tpu_torch.infer import decode as D
from paddle_operator_tpu_torch.infer import quant as Q
from paddle_operator_tpu_torch.infer import serve as S
from paddle_operator_tpu_torch.infer.batcher import ContinuousBatcher
from paddle_operator_tpu_torch.models.llama import Dense, make_model
from paddle_operator_tpu_torch.ops import quant_matmul as QM

MAX_LEN = 64
BS = 8
TOL = 1e-5         # f32, the same products, summation order aside
LOGIT_TOL = 1e-4   # f32 logits after a few layers of matmuls
BOUND_TOL = 0.15   # tests/test_weight_quant.py TestLogitBound.TOL
MODES = ["int8", "int4"]


@pytest.fixture(scope="module")
def setup():
    jmodel, jcfg = jax_make_model("tiny", dtype=jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, 8), jnp.int32))["params"]
    model, cfg = make_model("tiny", device="cpu", dtype=torch.float32)
    model.load_state_dict(params_from_jax(jax.device_get(jparams)))
    model.requires_grad_(False)
    return jcfg, jparams, model, cfg


@pytest.fixture(scope="module")
def quantized(setup):
    """Per mode: (the JAX tree, the port model), both quantized with the
    serving skip list."""
    jcfg, jparams, model, cfg = setup
    out = {}
    for mode in MODES:
        qm = Q.quantize_params(copy.deepcopy(model), cfg, mode=mode,
                               skip=Q.SERVING_SKIP)
        out[mode] = (JQ.quantize_params(jparams, jcfg, mode=mode,
                                        skip=JQ.SERVING_SKIP), qm)
    return out


def _prompt(s, seed):
    return np.random.default_rng(seed).integers(0, 256, s).astype(
        np.int32).tolist()


def _leaf_case(dtype, seed=3):
    """[32, 16] weights: column 3 all zero, column 5 with absmax 127 (so
    scale 1 at int8) holding values on code midpoints (half-even ties),
    the rest random."""
    w = np.random.default_rng(seed).standard_normal((32, 16)).astype(
        np.float32)
    w[:, 3] = 0.0
    w[:, 5] = 0.0
    w[0, 5] = 127.0
    w[1:9, 5] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5, -126.5]
    return jnp.asarray(w, getattr(jnp, dtype)), torch.as_tensor(w).to(
        getattr(torch, dtype))


# ---------------------------------------------------------------------------
# quantize_leaf / dequantize_leaf
# ---------------------------------------------------------------------------


class TestQuantizeLeaf:
    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("mode", MODES)
    def test_codes_and_scales_equal_jax(self, mode, dtype):
        jw, tw = _leaf_case(dtype)
        jl, tl = JQ.quantize_leaf(jw, mode), Q.quantize_leaf(tw, mode)
        assert tl["q"].dtype == torch.int8 and tl["s"].dtype == torch.float32
        assert tl["s"].shape == (1, 16)
        np.testing.assert_array_equal(tl["q"].numpy(),
                                      np.asarray(jl["q"]).astype(np.int8))
        np.testing.assert_array_equal(tl["s"].numpy(), np.asarray(jl["s"]))
        if mode == "int8":
            assert tl["q"][1:9, 5].tolist() == [0, 2, 2, 0, -2, -2, 126,
                                                -126]

    @pytest.mark.parametrize("mode", MODES)
    def test_roundtrip_bit_stable(self, mode):
        w = torch.as_tensor(np.random.default_rng(4).standard_normal(
            (32, 16)).astype(np.float32))
        l1 = Q.quantize_leaf(w, mode)
        deq = Q.dequantize_leaf(l1, torch.float32)
        l2 = Q.quantize_leaf(deq, mode)
        assert torch.equal(l1["q"], l2["q"]) and torch.equal(l1["s"],
                                                             l2["s"])
        assert torch.equal(deq, Q.dequantize_leaf(l2, torch.float32))
        jl = JQ.quantize_leaf(jnp.asarray(w.numpy()), mode)
        np.testing.assert_array_equal(
            deq.numpy(), np.asarray(JQ.dequantize_leaf(jl, jnp.float32)))

    def test_all_zero_column_gets_unit_scale(self):
        leaf = Q.quantize_leaf(torch.zeros(8, 4))
        assert (leaf["s"] == 1.0).all() and not leaf["q"].any()


# ---------------------------------------------------------------------------
# quantize_params, weight_quant_mode, param_bytes, params_from_jax
# ---------------------------------------------------------------------------


def _jax_quantized_paths(tree):
    """'/'-joined paths of the {"q", "s"} leaves of a JAX tree, without
    the kernel suffix (``layers/attn/wq``)."""
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    paths = set()
    for path, _ in flat:
        p = "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path)
        if p.endswith("/kernel/q"):
            paths.add(p[:-len("/kernel/q")])
    return paths


def _port_quantized_paths(model):
    """The same from the port's modules, the layer index dropped (the
    JAX tree stacks the layers)."""
    return {re.sub(r"^layers/\d+/", "layers/", name.replace(".", "/"))
            for name, m in model.named_modules()
            if isinstance(m, Dense) and m.mode != "none"}


CALLS = [pytest.param("int8", True, id="serving-int8"),
         pytest.param("int4", True, id="serving-int4"),
         pytest.param("int8", False, id="legacy")]


def _quantize_both(setup, mode, serving, dtype=None):
    jcfg, jparams, model, cfg = setup
    m = copy.deepcopy(model)
    if dtype is not None:
        jparams = JQ.serving_params(jparams, getattr(jnp, dtype))
        Q.serving_params(m, getattr(torch, dtype))
    if serving:
        return (JQ.quantize_params(jparams, jcfg, mode=mode,
                                   skip=JQ.SERVING_SKIP),
                Q.quantize_params(m, cfg, mode=mode, skip=Q.SERVING_SKIP))
    return JQ.quantize_params(jparams), Q.quantize_params(m)


class TestQuantizeParams:
    @pytest.mark.parametrize("mode,serving", CALLS)
    def test_quantized_paths_equal_jax(self, setup, mode, serving):
        jq, tq = _quantize_both(setup, mode, serving)
        want = _jax_quantized_paths(jq)
        assert _port_quantized_paths(tq) == want
        assert ("lm_head" in want) == (not serving)
        n_layers = setup[3].n_layers
        assert sum(isinstance(m, Dense) and m.mode == mode
                   for m in tq.modules()) == 7 * n_layers + (not serving)
        # the skip list leaves the embedding and the norms as parameters
        names = dict(tq.named_parameters())
        assert "tok_embed.embedding" in names and "final_norm.scale" in names
        # the same call again leaves every tensor as it is
        before = {k: v.clone() for k, v in tq.state_dict().items()}
        if serving:
            Q.quantize_params(tq, mode=mode, skip=Q.SERVING_SKIP)
        else:
            Q.quantize_params(tq)
        after = tq.state_dict()
        assert set(after) == set(before)
        assert all(torch.equal(before[k], after[k]) for k in before)

    def test_unknown_mode_raises(self, setup):
        _, _, model, cfg = setup
        with pytest.raises(ValueError, match="int3"):
            Q.quantize_params(copy.deepcopy(model), cfg, mode="int3")

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    @pytest.mark.parametrize("mode,serving", CALLS)
    def test_mode_and_param_bytes_equal_jax(self, setup, mode, serving,
                                            dtype):
        jq, tq = _quantize_both(setup, mode, serving, dtype)
        assert Q.weight_quant_mode(tq) == JQ.weight_quant_mode(jq) == mode
        assert Q.param_bytes(tq) == JQ.param_bytes(jq)

    @pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
    def test_unquantized_mode_and_bytes_equal_jax(self, setup, dtype):
        _, jparams, model, _ = setup
        m = Q.serving_params(copy.deepcopy(model), getattr(torch, dtype))
        jp = JQ.serving_params(jparams, getattr(jnp, dtype))
        assert Q.weight_quant_mode(m) == JQ.weight_quant_mode(jp) == "none"
        assert Q.param_bytes(m) == JQ.param_bytes(jp)

    @pytest.mark.parametrize("scanned", [True, False])
    @pytest.mark.parametrize("mode,serving", CALLS)
    def test_params_from_jax_quantized_tree(self, setup, mode, serving,
                                            scanned):
        """A quantized JAX tree (the scanned stack, or ``layer_<i>``
        subtrees) converts into a model quantized with the same mode
        and skip list: codes and scales equal the JAX leaves and the
        port's own quantization."""
        jcfg, jparams, model, cfg = setup
        tree = jax.device_get(jparams)
        if not scanned:
            tree = {k: v for k, v in tree.items() if k != "layers"}
            for i in range(cfg.n_layers):
                tree[f"layer_{i}"] = jax.tree.map(lambda a, i=i: a[i],
                                                  jax.device_get(
                                                      jparams["layers"]))
        kw = dict(mode=mode, skip=JQ.SERVING_SKIP) if serving else {}
        jq = JQ.quantize_params(tree, jcfg, **kw) if serving else \
            JQ.quantize_params(tree)
        state = params_from_jax(jax.device_get(jq))
        _, own = _quantize_both(setup, mode, serving)
        skel = make_model("tiny", device="cpu", dtype=torch.float32)[0]
        if serving:
            Q.quantize_params(skel, cfg, mode=mode, skip=Q.SERVING_SKIP)
        else:
            Q.quantize_params(skel)
        skel.load_state_dict(state)
        for key, want in own.state_dict().items():
            got = skel.state_dict()[key]
            assert got.dtype == want.dtype and torch.equal(got, want), key
        assert Q.weight_quant_mode(skel) == mode
        assert state["layers.1.attn.wq.q"].dtype == torch.int8
        assert "layers.1.attn.wq.kernel" not in state


# ---------------------------------------------------------------------------
# The matmul and the forward
# ---------------------------------------------------------------------------


class TestMatmulAndLogits:
    @pytest.mark.parametrize("mode,site", [
        ("int8", "wq"), ("int4", "wq"), ("int8", "w2"), ("int4", "w2"),
        ("int8", "lm_head")])
    def test_mm_equals_jax(self, setup, mode, site):
        # lm_head is quantized by the legacy call only
        jq, tq = _quantize_both(setup, mode, site != "lm_head")
        if site == "lm_head":
            jleaf, dense = jq["lm_head"]["kernel"], tq.lm_head
        elif site == "wq":
            jleaf = jax.tree.map(lambda a: a[1],
                                 jq["layers"]["attn"]["wq"]["kernel"])
            dense = tq.layers[1].attn.wq
        else:
            jleaf = jax.tree.map(lambda a: a[0],
                                 jq["layers"]["mlp"]["w2"]["kernel"])
            dense = tq.layers[0].mlp.w2
        k = dense.q.shape[0]
        x = np.random.default_rng(7).standard_normal((2, 3, k)).astype(
            np.float32)
        want = np.asarray(JD._mm(jnp.asarray(x), jleaf, jnp.float32))
        got = D._mm(torch.as_tensor(x), dense, torch.float32)
        ref = QM.quant_matmul_reference(torch.as_tensor(x), dense.q,
                                        dense.s)
        np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)
        np.testing.assert_allclose(ref.numpy(), want, atol=TOL, rtol=0)
        # the training forward goes through the same route
        np.testing.assert_allclose(dense(torch.as_tensor(x)).numpy(), want,
                                   atol=TOL, rtol=0)

    @pytest.mark.parametrize("mode", MODES)
    def test_prefill_and_decode_logits_equal_jax(self, setup, quantized,
                                                 mode):
        jcfg = setup[0]
        cfg = setup[3]
        jq, tq = quantized[mode]
        prompt = np.asarray([_prompt(19, 5)], np.int32)
        jl, jc = JD.prefill(jq, jcfg, jnp.asarray(prompt), MAX_LEN)
        with torch.inference_mode():
            tl, tc = D.prefill(tq, cfg, torch.as_tensor(prompt), MAX_LEN)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       atol=LOGIT_TOL, rtol=0)
            # the training forward is the logit oracle of the quantized
            # model too
            full = tq(torch.as_tensor(prompt))
            np.testing.assert_allclose(full[:, -1].numpy(), tl.numpy(),
                                       atol=LOGIT_TOL, rtol=0)
            step = JD.make_decode_fn(jcfg)
            tok = np.asarray(jl).argmax(-1).astype(np.int32)
            for _ in range(8):
                jl, jc = step(jq, jnp.asarray(tok), jc)
                tl, tc = D.decode_step(tq, cfg, torch.as_tensor(tok), tc)
                np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                           atol=LOGIT_TOL, rtol=0)
                tok = np.asarray(jl).argmax(-1).astype(np.int32)

    def test_logits_within_bound_of_unquantized_bf16(self, setup):
        """At the serving dtype (bf16), the int8 model's per-step logits
        against the unquantized model's on the same token stream (the
        unquantized model's greedy choice drives both): within
        ``BOUND_TOL``, and not exact."""
        _, _, model, cfg = setup
        bcfg = dataclasses.replace(cfg, dtype=torch.bfloat16)
        base = Q.serving_params(copy.deepcopy(model), torch.bfloat16)
        q8 = Q.quantize_params(copy.deepcopy(base), bcfg, mode="int8",
                               skip=Q.SERVING_SKIP)
        prompt = torch.as_tensor([_prompt(19, 5)])
        with torch.inference_mode():
            lo, co = D.prefill(base, bcfg, prompt, MAX_LEN)
            lq, cq = D.prefill(q8, bcfg, prompt, MAX_LEN)
            worst = float((lq - lo).abs().max())
            tok = lo.argmax(-1).to(torch.int32)
            for _ in range(16):
                lo, co = D.decode_step(base, bcfg, tok, co)
                lq, cq = D.decode_step(q8, bcfg, tok, cq)
                worst = max(worst, float((lq - lo).abs().max()))
                tok = lo.argmax(-1).to(torch.int32)
        assert 0 < worst <= BOUND_TOL, worst


# ---------------------------------------------------------------------------
# The rings and the server
# ---------------------------------------------------------------------------


RINGS = [pytest.param({"paged": False}, 1, id="contig"),
         pytest.param({"paged": True}, 1, id="paged"),
         pytest.param({"paged": True, "kv_quant": "int8"}, 1, id="int8pool"),
         pytest.param({"paged": True}, 4, id="paged-megastep4")]


class TestQuantRings:
    @pytest.mark.parametrize("ring,megastep", RINGS)
    @pytest.mark.parametrize("mode", MODES)
    def test_ring_equals_quantized_generate(self, setup, quantized, ring,
                                            megastep, mode):
        """A cold prompt, a follower sharing its two full blocks (a
        prefix hit on the paged rings, whose 3-token suffix forward takes
        the kernel route) and a resubmission, through the quantized ring:
        the quantized ``generate``'s greedy tokens — on the int8 pool the
        JAX int8 ring's over the quantized tree (against the exact cache
        token equality is not an invariant of the int8 pool)."""
        from paddle_operator_tpu.infer.batcher import (
            ContinuousBatcher as JaxBatcher,
        )

        jcfg, cfg = setup[0], setup[3]
        jq, tq = quantized[mode]
        first = _prompt(19, 21)
        prompts = [first, first[:16] + _prompt(3, 22), first]
        kw = dict(slots=2, max_len=MAX_LEN, chunk_tokens=4, block_size=BS,
                  prefill_buckets=(16, MAX_LEN), megastep=megastep, **ring)
        if ring.get("kv_quant"):
            jb = JaxBatcher(jq, jcfg, **kw)
            try:
                want = [jb.submit(p, max_new_tokens=8).result(timeout=300)
                        for p in prompts]
            finally:
                jb.close()
        else:
            with torch.inference_mode():
                want = [D.generate(tq, cfg, torch.as_tensor([p]),
                                   max_new_tokens=8,
                                   max_len=MAX_LEN)[0].tolist()
                        for p in prompts]
        b = ContinuousBatcher(tq, cfg, **kw)
        try:
            got = [b.submit(p, max_new_tokens=8).result(timeout=120)
                   for p in prompts]
            if b.pool is not None:
                assert b.pool.stats["prefix_hit_tokens"] > 0
                b.pool.check_invariant()
            assert b.serving_status()["weightQuantMode"] == mode
        finally:
            b.close()
        assert got == want


def _serve(model, cfg, **kw):
    srv = S.make_server("127.0.0.1", 0, model, cfg, job="j", replica="r0",
                        **kw)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    return srv, f"http://127.0.0.1:{srv.server_address[1]}"


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.read()


def _post(url, body):
    req = urllib.request.Request(url + "/v1/generate",
                                 data=json.dumps(body).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


@pytest.mark.parametrize("env,mode", [
    ({}, "none"), ({"SERVE_WEIGHT_QUANT": "int8"}, "int8"),
    ({"SERVE_WEIGHT_QUANT": "int4"}, "int4"), ({"QUANTIZE": "int8"}, "int8")],
    ids=["bf16-default", "SERVE_WEIGHT_QUANT=int8", "SERVE_WEIGHT_QUANT=int4",
         "QUANTIZE=int8"])
def test_status_and_gauge_equal_jax(setup, env, mode):
    """The paged ring replica quantized by ``serve.quantize_from_env``
    (what ``main`` runs) beside the JAX ring replica over the tree the
    JAX entry point would build: the same tokens, ``weightQuantMode``
    and ``paramBytes`` on ``/statusz``, and the weight-quant gauge on
    ``/metrics`` (1 when quantized)."""
    jcfg, jparams, model, cfg = setup
    tq = copy.deepcopy(model)
    assert S.quantize_from_env(tq, cfg, env) == mode
    jq = jparams
    if env.get("QUANTIZE") == "int8":
        jq = JQ.quantize_params(jq)
    if env.get("SERVE_WEIGHT_QUANT"):
        jq = JQ.quantize_params(jq, jcfg, mode=env["SERVE_WEIGHT_QUANT"],
                                skip=JQ.SERVING_SKIP)
    ring = dict(continuous=True, paged=True, block_size=BS, slots=2,
                chunk_tokens=4, max_len=MAX_LEN)
    port, purl = _serve(tq, cfg, **ring)
    jsrv = jax_make_server("127.0.0.1", 0, jq, jcfg, job="j", replica="r0",
                           **ring)
    threading.Thread(target=jsrv.serve_forever, daemon=True).start()
    jurl = f"http://127.0.0.1:{jsrv.server_address[1]}"
    try:
        body = {"tokens": [_prompt(11, 6)], "max_new_tokens": 6}
        assert _post(purl, body) == _post(jurl, body)
        ps, js = (json.loads(_get(u + "/statusz")) for u in (purl, jurl))
        assert ps["weightQuantMode"] == js["weightQuantMode"] == mode
        assert ps["paramBytes"] == js["paramBytes"] == JQ.param_bytes(jq)
        gauge = (f'tpujob_serve_weight_quant_mode{{job="j",replica="r0",'
                 f'mode="{mode}",draft="none"}}')
        lines = {ln.split(" ")[0]: float(ln.split(" ")[1])
                 for ln in _get(purl + "/metrics").decode().splitlines()
                 if ln and not ln.startswith("#")}
        assert lines[gauge] == float(mode != "none")
    finally:
        for srv in (port, jsrv):
            srv.shutdown()
            srv.server_close()
        port.generator.close()
        jsrv.generator.close()
