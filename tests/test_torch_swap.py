"""Live weight swap on the torch package's serving ring (``POST
/v1/swap``, ``ContinuousBatcher.swap_weights``, ``RingExecutor.
swap_weights``; SERVE_SWAP_RETAIN), held against the JAX package: the
cases of tests/test_serve_swap.py TestInPlaceSwap and TestSwapHTTP, each
with a JAX ring on the same converted ``tiny`` f32 params as the oracle
(equal tokens), plus a flip to int8 weights and back, a swap from a
checkpoint, the refusals (unpaged ring, a speculative ring without its
draft, a tensor-parallel resize, an orbax checkpoint) and the unchanged
JAX ``swapctl`` driving a port replica.
"""

import copy
import json
import threading
import time
import urllib.error
import urllib.request

import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_operator_tpu.infer import quant as JQ
from paddle_operator_tpu.infer.scheduler import (
    ContinuousBatcher as JaxBatcher,
)
from paddle_operator_tpu.models.llama import make_model as jax_make_model
from paddle_operator_tpu_torch.convert import params_from_jax
from paddle_operator_tpu_torch.infer import quant as Q
from paddle_operator_tpu_torch.infer import serve as S
from paddle_operator_tpu_torch.infer.batcher import ContinuousBatcher
from paddle_operator_tpu_torch.models.llama import make_model

RING_KW = dict(slots=2, max_len=48, chunk_tokens=4,
               prefill_buckets=(16, 48), paged=True, block_size=8,
               num_blocks=64, prefix_cache=True)
PROMPT = [1, 2, 3, 4, 5, 6]


@pytest.fixture(scope="module")
def models():
    """Seed 0 and seed 1 params: the JAX trees and the port models
    converted from them."""
    out = {}
    for seed in (0, 1):
        jmodel, jcfg = jax_make_model("tiny", dtype=jnp.float32)
        jp = jmodel.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, 8), jnp.int32))["params"]
        model, cfg = make_model("tiny", device="cpu", dtype=torch.float32)
        model.load_state_dict(params_from_jax(jax.device_get(jp)))
        out[seed] = (jp, jcfg, model, cfg)
    return out


def _jax_oracle(jparams, jcfg, prompt=PROMPT, max_new=8, **kw):
    """A fresh JAX ring on ``jparams``: the token oracle."""
    b = JaxBatcher(jparams, jcfg, **{**RING_KW, **kw})
    try:
        return b.submit(list(prompt), max_new_tokens=max_new).result(
            timeout=300)
    finally:
        b.close()


def _copy(model):
    """The same weights in another model object (a new tree, as a swap
    to identical weights ships it)."""
    return copy.deepcopy(model)


def _wait_active(b, timeout=30.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if any(r is not None for r in b.lane):
            return
        time.sleep(0.005)
    raise TimeoutError("request never became resident")


def _paced(b, secs=0.02):
    orig = b._step

    def paced(*a):
        time.sleep(secs)
        return orig(*a)

    b._step = paced


class TestInPlaceSwap:
    def test_swap_to_new_weights_post_oracle(self, models):
        """After the flip the ring serves the new weights as a fresh JAX
        ring on them does: the old generation's cache never leaks."""
        ja, jcfg, pa, cfg = models[0]
        jb, _, pb, _ = models[1]
        b = ContinuousBatcher(pa, cfg, **RING_KW)
        try:
            pre = b.submit(list(PROMPT), max_new_tokens=8).result(
                timeout=300)
            assert pre == _jax_oracle(ja, jcfg)
            res = b.swap_weights(pb, generation=7)
            assert res["generation"] == 7 and res["servingTp"] == 1
            assert res["weightQuantMode"] == "none"
            post = b.submit(list(PROMPT), max_new_tokens=8).result(
                timeout=300)
            assert post == _jax_oracle(jb, jcfg) != pre
            st = b.serving_status()
            assert (st["weightGeneration"], st["servingTp"],
                    st["weightSwaps"]) == (7, 1, 1)
            assert b.pool.hit_rate() == 0.0     # a fresh radix
        finally:
            b.close()

    @pytest.mark.parametrize("kw", [
        pytest.param({}, id="paged"),
        pytest.param({"kv_quant": "int8"}, id="int8"),
        pytest.param({"megastep": 4}, id="paged-megastep4")])
    def test_mid_flight_swap_parks_and_restores_bit_identical(self, models,
                                                              kw):
        """A swap posted while a stream is resident parks the lane,
        flips and restores it: with identical weights the stream equals
        a ring that never swapped — JAX's on the exact pool, the int8
        pool's own unswapped run."""
        ja, jcfg, pa, cfg = models[0]
        if kw.get("kv_quant"):
            plain = ContinuousBatcher(pa, cfg, **{**RING_KW, **kw})
            try:
                want = plain.submit(list(PROMPT), max_new_tokens=24).result(
                    timeout=300)
            finally:
                plain.close()
        else:
            want = _jax_oracle(ja, jcfg, max_new=24)
        b = ContinuousBatcher(pa, cfg, **{**RING_KW, **kw})
        _paced(b)
        try:
            h = b.submit(list(PROMPT), max_new_tokens=24)
            _wait_active(b)
            res = b.swap_weights(_copy(pa))
            assert res["generation"] == 1          # bump by one
            assert res["parkedLanes"] == 1
            assert h.result(timeout=300) == want
            assert b.serving_status()["weightSwaps"] == 1
            assert set(b.last_swap) >= {"park_s", "flip_s", "capture_s",
                                        "restore_s", "total_s"}
            b.pool.check_invariant()
        finally:
            b.close()

    def test_spec_ring_missing_draft_rolls_back(self, models):
        """All-or-nothing: a speculative ring refuses a swap that ships
        no draft, and keeps serving the old generation exactly."""
        ja, jcfg, pa, cfg = models[0]
        b = ContinuousBatcher(pa, cfg, draft_params=_copy(pa),
                              draft_cfg=cfg, spec_k=3, **RING_KW)
        try:
            with pytest.raises(ValueError, match="draft"):
                b.swap_weights(models[1][2])
            st = b.serving_status()
            assert st["weightGeneration"] == 0 and st["weightSwaps"] == 0
            assert b.executor.params is pa
            out = b.submit(list(PROMPT), max_new_tokens=8).result(
                timeout=300)
            assert out == _jax_oracle(ja, jcfg)
            # with the draft it swaps
            res = b.swap_weights(models[1][2], draft_params=models[1][2])
            assert res["generation"] == 1
            assert b.submit(list(PROMPT), max_new_tokens=8).result(
                timeout=300) == _jax_oracle(models[1][0], jcfg)
        finally:
            b.close()

    def test_unpaged_ring_refuses_swap(self, models):
        _, _, pa, cfg = models[0]
        b = ContinuousBatcher(pa, cfg, slots=2, max_len=48, chunk_tokens=4,
                              prefill_buckets=(16, 48))
        try:
            with pytest.raises(ValueError, match="paged"):
                b.swap_weights(models[1][2])
            with pytest.raises(NotImplementedError, match="tensor-parallel"):
                b.swap_weights(models[1][2], tp=2)
        finally:
            b.close()

    def test_fingerprints_carry_generation(self, models):
        """Generation purity: the store fingerprint is the JAX ring's
        (generation included, tp absent) and follows a swap."""
        ja, jcfg, pa, cfg = models[0]
        b = ContinuousBatcher(pa, cfg, generation=4, **RING_KW)
        jb = JaxBatcher(ja, jcfg, generation=4, **RING_KW)
        try:
            assert b._fingerprint() == jb._fingerprint()
            assert b._fingerprint()["generation"] == 4
            assert "tp" not in b._fingerprint()
            b.swap_weights(_copy(pa), generation=9)
            assert b._fingerprint()["generation"] == 9
        finally:
            b.close()
            jb.close()

    def test_weight_quant_flip_and_back(self, models):
        """A swap to int8 weights routes the projections through the
        int8-weight path (the JAX ring's tokens on the same quantized
        tree), and a swap back to the bf16 tree serves as before."""
        ja, jcfg, pa, cfg = models[0]
        jb, _, pb, _ = models[1]
        qb = Q.quantize_params(_copy(pb), cfg, mode="int8",
                               skip=Q.SERVING_SKIP)
        jqb = JQ.quantize_params(jb, jcfg, mode="int8", skip=JQ.SERVING_SKIP)
        b = ContinuousBatcher(pa, cfg, **RING_KW)
        try:
            res = b.swap_weights(qb)
            assert res["weightQuantMode"] == "int8"
            assert b.serving_status()["weightQuantMode"] == "int8"
            assert b.submit(list(PROMPT), max_new_tokens=8).result(
                timeout=300) == _jax_oracle(jqb, jcfg)
            res = b.swap_weights(pa, generation=5)
            assert res["weightQuantMode"] == "none"
            assert b.submit(list(PROMPT), max_new_tokens=8).result(
                timeout=300) == _jax_oracle(ja, jcfg)
        finally:
            b.close()


class TestSwapHTTP:
    """``/v1/swap`` on a live port replica, and the JAX package's
    ``swapctl`` CLI against it."""

    @pytest.fixture(scope="class")
    def sserver(self, models):
        ja, jcfg, pa, cfg = models[0]
        srv = S.make_server("127.0.0.1", 0, _copy(pa), cfg, continuous=True,
                            **RING_KW)
        # what serve.main() retains under SERVE_SWAP_RETAIN=1
        srv.swap_base = {"params": S.host_state(pa), "weight_quant": "none"}
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        yield f"http://127.0.0.1:{srv.server_address[1]}", srv
        srv.shutdown()
        srv.server_close()
        srv.generator.close()

    def _post(self, base, path, payload):
        req = urllib.request.Request(
            f"{base}{path}", data=json.dumps(payload).encode(),
            headers={"Content-Type": "application/json"}, method="POST")
        try:
            with urllib.request.urlopen(req, timeout=120) as resp:
                return resp.status, json.loads(resp.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def _status(self, base):
        with urllib.request.urlopen(f"{base}/statusz", timeout=10) as r:
            return json.loads(r.read())

    def test_swap_bumps_generation_and_keeps_serving(self, sserver, models):
        base, _ = sserver
        ja, jcfg, _, _ = models[0]
        body = {"tokens": [PROMPT], "max_new_tokens": 4}
        code, out = self._post(base, "/v1/generate", body)
        assert code == 200 and out["tokens"] == [_jax_oracle(ja, jcfg,
                                                             max_new=4)]
        # checkpoint-less swap: rebuilt from the retained base
        code, res = self._post(base, "/v1/swap", {"generation": 3})
        assert code == 200 and res["generation"] == 3
        st = self._status(base)
        assert (st["weightGeneration"], st["servingTp"]) == (3, 1)
        code2, out2 = self._post(base, "/v1/generate", body)
        assert code2 == 200 and out2["tokens"] == out["tokens"]

    def test_no_base_no_checkpoint_is_400(self, sserver):
        base, srv = sserver
        saved, srv.swap_base = srv.swap_base, None
        try:
            code, out = self._post(base, "/v1/swap", {})
            assert code == 400 and "nothing to swap" in out["error"]
        finally:
            srv.swap_base = saved

    def test_missing_checkpoint_path_is_refused(self, sserver, tmp_path):
        """A checkpoint that cannot be restored never flips: a missing
        path, and an orbax step of the JAX package (refused by name, as
        at boot); a resize is refused naming tensor parallelism."""
        base, _ = sserver
        gen = self._status(base)["weightGeneration"]
        code, _ = self._post(base, "/v1/swap",
                             {"checkpoint": "/nonexistent/ckpt"})
        assert code in (400, 503)
        (tmp_path / "7").mkdir()
        code, out = self._post(base, "/v1/swap",
                               {"checkpoint": str(tmp_path)})
        assert code == 400 and "7" in out["error"]
        code, out = self._post(base, "/v1/swap", {"tp": 2})
        assert code == 400 and "tensor-parallel" in out["error"]
        assert self._status(base)["weightGeneration"] == gen

    def test_checkpoint_swap_serves_its_weights(self, sserver, models,
                                                tmp_path):
        """A swap from a checkpoint the port saved of the seed-1 params:
        the replica then answers as a JAX ring on them."""
        from paddle_operator_tpu_torch.train import trainer as TT
        from paddle_operator_tpu_torch.train.checkpoint import (
            CheckpointManager,
        )

        base, _ = sserver
        jb, jcfg, pb, _ = models[1]
        ckpt = CheckpointManager(str(tmp_path / "ckpt"))
        ckpt.save(0, TT.create_state(_copy(pb), TT.make_optimizer()),
                  force=True)
        ckpt.close()
        code, res = self._post(base, "/v1/swap",
                               {"checkpoint": str(tmp_path / "ckpt"),
                                "generation": 11})
        assert code == 200 and res["generation"] == 11
        code, out = self._post(base, "/v1/generate",
                               {"tokens": [PROMPT], "max_new_tokens": 6})
        assert out["tokens"] == [_jax_oracle(jb, jcfg, max_new=6)]
        code, res = self._post(base, "/v1/swap", {"generation": 12})
        assert code == 200

    def test_swapctl_drives_the_server(self, sserver):
        """The unchanged JAX ``swapctl`` speaks the port replica's HTTP."""
        from paddle_operator_tpu.infer import swapctl

        base, _ = sserver
        rc = swapctl.main(["--url", base, "--generation", "21",
                           "--timeout-s", "120"])
        assert rc == 0
        assert swapctl.poll_generation(base, 21, timeout_s=10,
                                       interval_s=0.1)
        assert swapctl.main(["--url", base, "--wait-generation", "21",
                             "--timeout-s", "10"]) == 0
