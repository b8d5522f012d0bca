"""The torch package's serving ring on Mixture-of-Experts presets: every
ring mode's greedy tokens equal the JAX ring's on the same converted
params (``tiny-moe`` and ``tiny-moe2`` at f32), through the decode
path's exact ``_moe_ffn`` — the contiguous ring, the paged pool, the
int8 pool, megastep 4, chunked prefill, speculative decoding at K = 2
(``cfg.draft()`` keeps the experts) and int8 weights with the serving
skip list (the experts quantized).  And a tiny-moe replica over HTTP:
it serves, reports the quantization as the JAX ring does, and swaps to
its retained base without a change of tokens.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_operator_tpu.infer import quant as JQ
from paddle_operator_tpu.infer.batcher import ContinuousBatcher as JaxBatcher
from paddle_operator_tpu.models.llama import make_model as jax_make_model
from paddle_operator_tpu_torch.convert import params_from_jax
from paddle_operator_tpu_torch.infer import quant as TQ
from paddle_operator_tpu_torch.infer import serve as S
from paddle_operator_tpu_torch.infer.batcher import ContinuousBatcher
from paddle_operator_tpu_torch.models.llama import Llama, make_model
from paddle_operator_tpu_torch.models.moe import ExpertCodes

MAX_LEN = 64
BS = 8
PRESETS = ["tiny-moe", "tiny-moe2"]
MODES = {
    "contig": {"paged": False},
    "paged": {"paged": True},
    "int8-pool": {"paged": True, "kv_quant": "int8"},
    "megastep4": {"paged": True, "megastep": 4},
    "chunked": {"paged": True, "prefill_mode": "chunked",
                "prefill_chunk": 5},
    "spec2": {"paged": True, "spec_k": 2},
    "int8-weights": {"paged": True},
}
# the traffic: five prompts on two slots (a queue), one a prefix of
# another (a radix hit on the paged rings), budgets that end mid-chunk
TRAFFIC = [(5, 10, 9), (11, 11, 6), (24, 12, 9), (19, 13, 7)]


def _prompt(s, seed):
    return np.random.default_rng(seed).integers(0, 256, s).astype(
        np.int32).tolist()


def _requests():
    reqs = [(_prompt(n, seed), new) for n, seed, new in TRAFFIC]
    reqs.append((reqs[2][0][:16] + _prompt(5, 14), 8))
    return reqs


@pytest.fixture(scope="module", params=PRESETS)
def models(request):
    """The JAX params (target and draft) and the port's models loaded
    with them, at f32."""
    preset = request.param
    jm, jcfg = jax_make_model(preset, dtype=jnp.float32)
    jp = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))[
        "params"]
    model, cfg = make_model(preset, device="cpu", dtype=torch.float32)
    model.load_state_dict(params_from_jax(jax.device_get(jp)))
    jdcfg = jcfg.draft()
    jdm = type(jm)(jdcfg)
    jdp = jdm.init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))[
        "params"]
    dcfg = cfg.draft()
    assert dcfg.n_experts == cfg.n_experts == jdcfg.n_experts
    draft = Llama(dcfg, torch.device("cpu"))
    draft.load_state_dict(params_from_jax(jax.device_get(jdp)))
    return {"jp": jp, "jcfg": jcfg, "jdp": jdp, "jdcfg": jdcfg,
            "model": model, "cfg": cfg, "draft": draft, "dcfg": dcfg}


def _kw(mode):
    kw = dict(MODES[mode], slots=2, max_len=MAX_LEN, chunk_tokens=4,
              prefill_buckets=(16, MAX_LEN))
    if kw.pop("paged"):
        kw.update(paged=True, block_size=BS, num_blocks=32)
    return kw


def _serve(batcher, reqs):
    try:
        hs = [batcher.submit(p, max_new_tokens=n) for p, n in reqs]
        return [h.result(timeout=300) for h in hs]
    finally:
        batcher.close()


@pytest.mark.parametrize("mode", list(MODES))
def test_ring_tokens_equal_the_jax_ring(models, mode):
    m = models
    kw, jkw = _kw(mode), _kw(mode)
    jparams, model = m["jp"], m["model"]
    if mode == "spec2":
        kw.update(draft_params=m["draft"], draft_cfg=m["dcfg"])
        jkw.update(draft_params=m["jdp"], draft_cfg=m["jdcfg"])
    if mode == "int8-weights":
        jparams = JQ.quantize_params(jparams, m["jcfg"], mode="int8",
                                     skip=JQ.SERVING_SKIP)
        model = Llama(m["cfg"], torch.device("cpu"))
        model.load_state_dict(m["model"].state_dict())
        TQ.quantize_params(model, m["cfg"], mode="int8",
                           skip=TQ.SERVING_SKIP)
        assert isinstance(model.layers[0].moe.w2, ExpertCodes)
        assert TQ.param_bytes(model) == JQ.param_bytes(jparams)
    reqs = _requests()
    want = _serve(JaxBatcher(jparams, m["jcfg"], **jkw), reqs)
    b = ContinuousBatcher(model, m["cfg"], **kw)
    got = _serve(b, reqs)
    for (p, n), g, w in zip(reqs, got, want):
        assert len(g) == len(p) + n
        assert g == w
    if b.pool is not None:
        b.pool.check_invariant()


# ---------------------------------------------------------------------------
# an MoE replica over HTTP
# ---------------------------------------------------------------------------


def _post(base, path, payload):
    req = urllib.request.Request(
        f"{base}{path}", data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    with urllib.request.urlopen(req, timeout=120) as resp:
        return resp.status, json.loads(resp.read())


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_replica_serves_reports_and_swaps(models, quant):
    """The ring behind the HTTP front, with ``SERVE_WEIGHT_QUANT`` read
    as ``serve.main()`` reads it (``quantize_from_env``) and its base
    retained as under ``SERVE_SWAP_RETAIN``: a generate equals the JAX
    ring's tokens; ``/statusz`` says the weight quantization the JAX
    ring's status says; a checkpoint-less swap rebuilds the MoE model
    (quantized as at boot) and serves the same tokens."""
    m = models
    model = Llama(m["cfg"], torch.device("cpu"))
    model.load_state_dict(m["model"].state_dict())
    base_state = S.host_state(model)
    env = {"SERVE_WEIGHT_QUANT": quant}
    assert S.quantize_from_env(model, m["cfg"], env) == quant
    jparams = m["jp"] if quant == "none" else JQ.quantize_params(
        m["jp"], m["jcfg"], mode=quant, skip=JQ.SERVING_SKIP)
    kw = _kw("paged")
    srv = S.make_server("127.0.0.1", 0, model, m["cfg"], continuous=True,
                        **kw)
    srv.swap_base = {"params": base_state, "weight_quant": quant}
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    jb = JaxBatcher(jparams, m["jcfg"], **_kw("paged"))
    try:
        prompt = _prompt(13, 21)
        want = jb.submit(prompt, max_new_tokens=6).result(timeout=300)
        body = {"tokens": [prompt], "max_new_tokens": 6}
        code, out = _post(base, "/v1/generate", body)
        assert code == 200 and out["tokens"] == [want]
        with urllib.request.urlopen(f"{base}/statusz", timeout=10) as r:
            st = json.loads(r.read())
        assert st["weightQuantMode"] == jb.serving_status()[
            "weightQuantMode"] == quant
        code, res = _post(base, "/v1/swap", {"generation": 2})
        assert code == 200 and res["generation"] == 2
        swapped = srv.generator.batcher.executor.params
        assert swapped is not model
        assert isinstance(swapped.layers[0].moe.w1, ExpertCodes) == \
            (quant != "none")
        code, out2 = _post(base, "/v1/generate", body)
        assert code == 200 and out2["tokens"] == [want]
    finally:
        jb.close()
        srv.shutdown()
        srv.server_close()
        srv.generator.close()
