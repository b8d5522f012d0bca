"""The torch package's decode path (paddle_operator_tpu_torch/infer/
decode.py) held against the JAX package's infer/decode.py on the same
converted ``tiny`` params: greedy generate token for token, decode-step
logits position by position against the training forward, the bf16
logit bound, and the sampling filters on the same numpy logits.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_operator_tpu.infer import decode as JD
from paddle_operator_tpu.models.llama import make_model as jax_make_model
from paddle_operator_tpu_torch.convert import params_from_jax
from paddle_operator_tpu_torch.infer import decode as D
from paddle_operator_tpu_torch.infer.quant import serving_params
from paddle_operator_tpu_torch.models.llama import make_model
from paddle_operator_tpu_torch.ops.decode_attention import decode_attention

BF16_TOL = 0.15     # the repo's bf16 logit bound (tests/test_kvquant.py)


@pytest.fixture(scope="module")
def setup():
    jmodel, jcfg = jax_make_model("tiny", dtype=jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, 8), jnp.int32))["params"]
    model, cfg = make_model("tiny", device="cpu", dtype=torch.float32)
    model.load_state_dict(params_from_jax(jax.device_get(jparams)))
    return jmodel, jcfg, jparams, model, cfg


def _prompt(b, s, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(
        np.int32)


def _with(cfg, impl):
    return dataclasses.replace(cfg, decode_attn=impl)


class TestGenerate:
    @pytest.mark.parametrize("impl", ["plain", "kernel"])
    def test_greedy_tokens_identical(self, setup, impl):
        _, jcfg, jparams, model, cfg = setup
        prompt = _prompt(2, 9, 1)
        want = np.asarray(JD.generate(jparams, jcfg, jnp.asarray(prompt),
                                      max_new_tokens=8, max_len=64))
        with torch.inference_mode():
            got = D.generate(model, _with(cfg, impl),
                             torch.as_tensor(prompt), max_new_tokens=8,
                             max_len=64).numpy()
        np.testing.assert_array_equal(got, want)

    def test_eos_sticks(self, setup):
        _, jcfg, jparams, model, cfg = setup
        prompt = _prompt(2, 6, 2)
        first = np.asarray(JD.generate(jparams, jcfg, jnp.asarray(prompt),
                                       max_new_tokens=4, max_len=32))
        eos = int(first[0, 7])      # row 0's second generated token
        want = np.asarray(JD.generate(jparams, jcfg, jnp.asarray(prompt),
                                      max_new_tokens=6, max_len=32,
                                      eos_token=eos))
        with torch.inference_mode():
            got = D.generate(model, cfg, torch.as_tensor(prompt),
                             max_new_tokens=6, max_len=32,
                             eos_token=eos).numpy()
        np.testing.assert_array_equal(got, want)
        assert (got[0, 7:] == eos).all()

    def test_kernel_path_launch_count_is_cpu_free(self, setup):
        # on CPU tensors the wrapper runs its plain version: no launch
        _, _, _, model, cfg = setup
        before = decode_attention.launches
        with torch.inference_mode():
            D.generate(model, _with(cfg, "kernel"),
                       torch.as_tensor(_prompt(1, 4, 3)), max_new_tokens=3,
                       max_len=16)
        assert decode_attention.launches == before

    def test_capacity_checked(self, setup):
        _, _, _, model, cfg = setup
        with pytest.raises(ValueError, match="exceeds the cache"):
            D.generate(model, cfg, torch.as_tensor(_prompt(1, 10, 4)),
                       max_new_tokens=8, max_len=16)


class TestStepEquivalence:
    def test_prefill_matches_jax_prefill(self, setup):
        _, jcfg, jparams, model, cfg = setup
        toks = _prompt(2, 12, 5)
        want, _ = JD.prefill(jparams, jcfg, jnp.asarray(toks))
        with torch.inference_mode():
            got, cache = D.prefill(model, cfg, torch.as_tensor(toks))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)
        assert cache["pos"] == 12

    @pytest.mark.parametrize("impl", ["plain", "kernel"])
    def test_decode_steps_match_training_forward(self, setup, impl):
        """Prefill 4 tokens, decode the rest one at a time: every step's
        logits equal the flax training forward over the growing
        prefix."""
        jmodel, _, jparams, model, cfg = setup
        toks = _prompt(2, 10, 6)
        c = _with(cfg, impl)
        with torch.inference_mode():
            _, cache = D.prefill(model, c, torch.as_tensor(toks[:, :4]))
            for t in range(4, toks.shape[1]):
                step, cache = D.decode_step(model, c,
                                            torch.as_tensor(toks[:, t]),
                                            cache)
                ref = np.asarray(jmodel.apply(
                    {"params": jparams}, jnp.asarray(toks[:, :t + 1])))
                np.testing.assert_allclose(step.numpy(), ref[:, -1],
                                           rtol=1e-4, atol=1e-4,
                                           err_msg=str(t))

    def test_bf16_logits_within_bound(self, setup):
        """bf16 serving (params cast by serving_params) against the f32
        JAX decode, step by step."""
        _, jcfg, jparams, _, _ = setup
        bmodel, bcfg = make_model("tiny", device="cpu")
        bmodel.load_state_dict(params_from_jax(jax.device_get(jparams)))
        serving_params(bmodel, bcfg.dtype)
        assert bmodel.lm_head.kernel.dtype == torch.bfloat16
        toks = _prompt(2, 10, 7)
        want, jcache = JD.prefill(jparams, jcfg, jnp.asarray(toks[:, :5]))
        with torch.inference_mode():
            got, cache = D.prefill(bmodel, bcfg, torch.as_tensor(toks[:, :5]))
            assert np.abs(got.numpy() - np.asarray(want)).max() < BF16_TOL
            for t in range(5, 10):
                want, jcache = JD.decode_step(jparams, jcfg,
                                              jnp.asarray(toks[:, t]), jcache)
                got, cache = D.decode_step(bmodel, bcfg,
                                           torch.as_tensor(toks[:, t]), cache)
                err = np.abs(got.numpy() - np.asarray(want)).max()
                assert err < BF16_TOL, (t, err)


class TestCache:
    @pytest.mark.parametrize("n", [1, 64, 256, 257, 2048, 2240])
    def test_alloc_len_matches_jax(self, n):
        assert D.cache_alloc_len(n) == JD.cache_alloc_len(n)

    def test_init_cache_layout(self, setup):
        _, jcfg, _, _, cfg = setup
        c = D.init_cache(cfg, 3, 100, device="cpu")
        j = JD.init_cache(jcfg, 3, 100)
        assert tuple(c["k"].shape) == j["k"].shape
        assert c["k"].dtype == torch.float32 and c["pos"] == 0
        with pytest.raises(ValueError, match="RoPE"):
            D.init_cache(cfg, 1, cfg.max_seq_len + 1, device="cpu")

    def test_unported_options_refused(self, setup):
        _, _, _, model, cfg = setup
        # a mesh is a parallel/mesh.py DeviceMesh (tensor-parallel
        # serving: tests/test_torch_serving_tp*.py); anything else raises
        with pytest.raises(TypeError):
            D.init_cache(cfg, 1, 16, device="cpu", mesh=object())
        cache = D.init_cache(cfg, 1, 16, device="cpu")
        tok = torch.zeros((1, 1), dtype=torch.int32)
        with pytest.raises(TypeError):
            D._forward(cfg, model, tok, cache, mesh=object())
        # the lora leg is served (tests/test_torch_adapters.py): the base
        # slot adds an exact zero
        from paddle_operator_tpu_torch.infer.qos import AdapterRegistry

        reg = AdapterRegistry(cfg, capacity=1, rank=2, device="cpu")
        reg.load("x", seed=1)
        want, _ = D._forward(cfg, model, tok,
                             D.init_cache(cfg, 1, 16, device="cpu"))
        got, _ = D._forward(cfg, model, tok, cache,
                            lora=(reg.arrays(),
                                  torch.zeros(1, dtype=torch.int32)))
        assert torch.equal(got, want)


class TestSampling:
    @pytest.mark.parametrize("top_k,top_p", [(5, None), (None, 0.9),
                                             (8, 0.5), (None, 0.3),
                                             (1, None)])
    def test_filter_logits_equals_jax(self, top_k, top_p):
        logits = np.random.default_rng(8).standard_normal(
            (4, 256)).astype(np.float32) * 3
        want = np.asarray(JD._filter_logits(jnp.asarray(logits), top_k,
                                            top_p))
        got = D._filter_logits(torch.as_tensor(logits), top_k,
                               top_p).numpy()
        np.testing.assert_array_equal(got, want)

    def test_sampling_deterministic_and_in_support(self, setup):
        _, _, _, model, cfg = setup
        prompt = torch.as_tensor(_prompt(2, 5, 9))

        def run(seed):
            g = torch.Generator()
            g.manual_seed(seed)
            with torch.inference_mode():
                return D.generate(model, cfg, prompt, max_new_tokens=6,
                                  temperature=0.8, top_k=4, generator=g,
                                  max_len=32)

        a, b = run(3), run(3)
        assert torch.equal(a, b)
        # each sampled token lies in the top-4 of its step's logits
        with torch.inference_mode():
            logits, cache = D.prefill(model, cfg, prompt, 32)
            for i in range(6):
                tok = a[:, 5 + i]
                top = torch.topk(logits, 4).indices
                assert (top == tok[:, None]).any(-1).all(), i
                logits, cache = D.decode_step(model, cfg, tok, cache)
