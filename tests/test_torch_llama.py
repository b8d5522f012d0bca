"""The torch package's LLaMA (paddle_operator_tpu_torch/models/llama.py)
and param converter held against the flax model: the JAX init of
``tiny`` converts leaf for leaf, the port's forward gives the flax
forward's logits, and the presets agree.  Also pins the port's import
boundary: nothing under the torch package (nor chip_smoke.py) imports
jax or the JAX package.
"""

import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_operator_tpu.models import llama as JL
from paddle_operator_tpu_torch.convert import params_from_jax
from paddle_operator_tpu_torch.models import llama as TL

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def tiny():
    jmodel, jcfg = JL.make_model("tiny", dtype=jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, 8), jnp.int32))["params"]
    tree = jax.device_get(jparams)
    model, cfg = TL.make_model("tiny", device="cpu", dtype=torch.float32)
    model.load_state_dict(params_from_jax(tree))
    return jmodel, jparams, tree, model, cfg


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    else:
        yield path, np.asarray(tree)


class TestConvert:
    def test_round_trip_is_exact(self, tiny):
        _, _, tree, model, _ = tiny
        state = {k: v.numpy() for k, v in model.state_dict().items()}
        n = 0
        for path, leaf in _flat(tree):
            if path[0] == "layers":
                back = np.stack([state[".".join(("layers", str(i))
                                                + path[1:])]
                                 for i in range(leaf.shape[0])])
            else:
                back = state[".".join(path)]
            np.testing.assert_array_equal(back, leaf, err_msg=str(path))
            n += leaf.size
        assert n == sum(v.size for v in state.values())

    def test_every_state_key_is_filled(self, tiny):
        _, _, tree, model, _ = tiny
        assert set(params_from_jax(tree)) == set(model.state_dict())

    def test_bf16_leaves_convert_exactly(self, tiny):
        _, jparams, _, _, _ = tiny
        from paddle_operator_tpu.infer.quant import serving_params

        tree = jax.device_get(serving_params(jparams, jnp.bfloat16))
        state = params_from_jax(tree)
        leaf = np.asarray(tree["lm_head"]["kernel"]).astype(np.float32)
        assert state["lm_head.kernel"].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            state["lm_head.kernel"].float().numpy(), leaf)

    def test_unscanned_tree_converts(self, tiny):
        """A ``scan_layers=False`` flax tree (``layer_<i>`` subtrees)
        loads into the same port model and gives the flax logits."""
        jmodel, jcfg = JL.make_model("tiny", dtype=jnp.float32,
                                     scan_layers=False)
        jparams = jmodel.init(jax.random.PRNGKey(1),
                              jnp.zeros((1, 8), jnp.int32))["params"]
        assert "layer_1" in jparams
        model, _ = TL.make_model("tiny", device="cpu", dtype=torch.float32)
        model.load_state_dict(params_from_jax(jax.device_get(jparams)))
        toks = np.random.default_rng(5).integers(0, 256, (2, 9))
        want = np.asarray(jmodel.apply({"params": jparams},
                                       jnp.asarray(toks, jnp.int32)))
        with torch.no_grad():
            got = model(torch.as_tensor(toks)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    def test_int8_leaves_refused(self, tiny):
        """A quantized tree's int8 ``{"q", "s"}`` leaves are refused by
        an unquantized model (its ``kernel`` keys are missing) and load
        into a model quantized with the tree's call (the legacy one
        here), codes and scales equal."""
        _, jparams, _, _, _ = tiny
        from paddle_operator_tpu.infer.quant import quantize_params

        from paddle_operator_tpu_torch.infer import quant as Q

        tree = jax.device_get(quantize_params(jparams))
        state = params_from_jax(tree)
        model, _ = TL.make_model("tiny", device="cpu", dtype=torch.float32)
        with pytest.raises(RuntimeError, match="lm_head.kernel"):
            model.load_state_dict(state)
        Q.quantize_params(model)
        model.load_state_dict(state)
        np.testing.assert_array_equal(
            model.lm_head.q.numpy(), tree["lm_head"]["kernel"]["q"])
        np.testing.assert_array_equal(
            model.layers[1].mlp.w2.s.numpy(),
            tree["layers"]["mlp"]["w2"]["kernel"]["s"][1])


class TestForward:
    @pytest.mark.parametrize("b,s,seed", [(2, 12, 1), (1, 33, 2)])
    def test_logits_match_flax(self, tiny, b, s, seed):
        jmodel, jparams, _, model, _ = tiny
        toks = np.random.default_rng(seed).integers(
            0, 256, (b, s)).astype(np.int32)
        want = np.asarray(jmodel.apply({"params": jparams},
                                       jnp.asarray(toks)))
        with torch.no_grad():
            got = model(torch.as_tensor(toks)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)

    def test_segment_ids_match_flax(self, tiny):
        """Packed documents: attention masked across them, RoPE positions
        absolute — the flax forward's logits."""
        jmodel, jparams, _, model, _ = tiny
        rng = np.random.default_rng(6)
        toks = rng.integers(0, 256, (2, 20)).astype(np.int32)
        seg = (np.arange(20)[None, :] >= np.asarray([[7], [12]])).astype(
            np.int32)
        want = np.asarray(jmodel.apply({"params": jparams},
                                       jnp.asarray(toks), jnp.asarray(seg)))
        with torch.no_grad():
            got = model(torch.as_tensor(toks), torch.as_tensor(seg)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
        with torch.no_grad():
            plain = model(torch.as_tensor(toks)).numpy()
        assert np.abs(plain - got).max() > 1e-3

    def test_init_mirrors_flax_initializers(self):
        model, _ = TL.make_model("tiny", device="cpu", seed=3)
        sd = model.state_dict()
        assert torch.all(sd["layers.0.attn_norm.scale"] == 1)
        assert torch.all(sd["final_norm.scale"] == 1)
        std = float(sd["tok_embed.embedding"].std())
        assert abs(std - 0.02) < 0.002
        again, _ = TL.make_model("tiny", device="cpu", seed=3)
        assert torch.equal(sd["lm_head.kernel"],
                           again.state_dict()["lm_head.kernel"])

    def test_moe_refused(self):
        """MoE presets are ported: no preset is refused any more, and an
        MoE layer holds ``moe`` (router, w1, w2) where a dense one holds
        ``mlp``."""
        for preset in ("tiny-moe", "tiny-moe2"):
            model, cfg = TL.make_model(preset, device="cpu")
            names = set(model.state_dict())
            assert "layers.0.moe.router.kernel" in names
            assert "layers.0.moe.w1" in names and "layers.0.moe.w2" in names
            assert not any(".mlp." in n for n in names)
            assert sum(p.numel() for p in model.parameters()) == \
                cfg.num_params()


class TestConfig:
    @pytest.mark.parametrize("preset", sorted(JL.CONFIGS))
    def test_presets_match(self, preset):
        jc, tc = JL.CONFIGS[preset], TL.CONFIGS[preset]
        for f in dataclasses.fields(tc):
            if f.name in ("dtype", "param_dtype", "decode_attn"):
                continue
            assert getattr(tc, f.name) == getattr(jc, f.name), f.name
        assert tc.head_dim == jc.head_dim
        assert tc.num_params() == jc.num_params()
        assert tc.active_params() == jc.active_params()
        assert tc.flops_per_token() == jc.flops_per_token()

    def test_same_preset_names(self):
        assert set(TL.CONFIGS) == set(JL.CONFIGS)

    def test_dtypes_mirror(self):
        assert TL.CONFIGS["7b"].dtype == torch.bfloat16
        assert TL.CONFIGS["7b"].param_dtype == torch.float32

    def test_resolved_decode_attn(self):
        cfg = TL.CONFIGS["tiny"]
        assert cfg.resolved_decode_attn(torch.device("cpu")) == "plain"
        assert cfg.resolved_decode_attn(torch.device("cuda")) == "kernel"
        forced = dataclasses.replace(cfg, decode_attn="plain")
        assert forced.resolved_decode_attn(torch.device("cuda")) == "plain"
        with pytest.raises(ValueError):
            dataclasses.replace(cfg, decode_attn="xla"
                                ).resolved_decode_attn("cpu")


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


PORT_FILES = sorted((REPO / "paddle_operator_tpu_torch").rglob("*.py")) \
    + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_no_jax(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                  "ml_dtypes", "paddle_operator_tpu")]
    assert not bad, f"{path.name} imports {bad}"
