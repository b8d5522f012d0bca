"""The torch package's remat policies (``LlamaConfig.remat_policy``:
"full", "save_attn", "dots", models/llama.py) held against the JAX
package's ``_layer_cls`` policies: the tiny preset at f32 from the same
init (the JAX init through ``params_from_jax``) on the same batch, the
next-token loss and every parameter's gradient.

Tolerances: loss rtol 1e-5 and grads atol 1e-6 + rtol 1e-4 against JAX
(f32 on both sides, summed in other orders; as tests/test_torch_train.py
holds whole steps); against the port's own "full" policy, bit for bit (a
policy only decides which values the backward keeps and which it
recomputes, and the recompute is the same arithmetic).  What each policy
keeps is counted: the flash forward (the attention routed through
ops/flash_attention.py's operator, the card's path, on CPU tensors)
runs 2 x layers times a step under "full" and "dots" and once a layer
under "save_attn"; under "dots" the backward runs no product of the
forward again.
"""

import itertools
from unittest import mock

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from paddle_operator_tpu.models import llama as JL
from paddle_operator_tpu.train import data as JD
from paddle_operator_tpu.train import trainer as JT
from paddle_operator_tpu_torch.convert import params_from_jax
from paddle_operator_tpu_torch.models import llama as TL
from paddle_operator_tpu_torch.ops import flash_attention as FA
from paddle_operator_tpu_torch.train import trainer as TT

POLICIES = ["full", "save_attn", "dots"]
RTOL, GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-6, 1e-4
B, S = 4, 33


@pytest.fixture(scope="module")
def batch():
    b = next(itertools.islice(JD.deterministic_lm_batches(B, S, 256,
                                                          seed=5), 1))
    rng = np.random.default_rng(2)
    cuts = np.sort(rng.choice(np.arange(2, S - 2), (B, 1), replace=False),
                   axis=1)
    b["segment_ids"] = (np.arange(S)[None, None, :]
                        >= cuts[:, :, None]).sum(1).astype(np.int32)
    return b


@pytest.fixture(scope="module")
def init():
    model, _ = JL.make_model("tiny", dtype=jnp.float32)
    return jax.device_get(model.init(jax.random.PRNGKey(0),
                                     jnp.zeros((1, S - 1), jnp.int32))
                          ["params"])


def _jax_grads(init, batch, policy):
    model, _ = JL.make_model("tiny", dtype=jnp.float32, remat_policy=policy)
    tokens = jnp.asarray(batch["tokens"])
    seg = jnp.asarray(batch["segment_ids"])[:, :-1]

    def loss_fn(params):
        logits = model.apply({"params": params}, tokens[:, :-1], seg)
        return JT.cross_entropy_loss(logits, tokens[:, 1:])[0]

    loss, grads = jax.value_and_grad(loss_fn)(init)
    return float(loss), params_from_jax(jax.device_get(grads))


def _port_grads(init, batch, policy, attention=None):
    model, _ = TL.make_model("tiny", device="cpu", dtype=torch.float32,
                             remat_policy=policy)
    model.load_state_dict(params_from_jax(init))
    tokens = torch.as_tensor(batch["tokens"])
    seg = torch.as_tensor(batch["segment_ids"])[:, :-1]
    with mock.patch.object(TL, "attention", attention or TL.attention):
        logits = model(tokens[:, :-1], seg)
        loss, _ = TT.cross_entropy_loss(logits, tokens[:, 1:])
        loss.backward()
    return float(loss), {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("policy", POLICIES)
def test_loss_and_grads_match_jax(init, batch, policy):
    want_loss, want = _jax_grads(init, batch, policy)
    loss, got = _port_grads(init, batch, policy)
    np.testing.assert_allclose(loss, want_loss, rtol=RTOL)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   atol=GRAD_ATOL, rtol=GRAD_RTOL, err_msg=k)


@pytest.mark.parametrize("policy", ["save_attn", "dots"])
@pytest.mark.parametrize("attention", ["plain", "flash"])
def test_policy_equals_full_bit_for_bit(init, batch, policy, attention):
    fn = FA.flash_attention if attention == "flash" else None
    want_loss, want = _port_grads(init, batch, "full", fn)
    loss, got = _port_grads(init, batch, policy, fn)
    assert loss == want_loss
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("policy,per_layer", [("full", 2), ("save_attn", 1),
                                              ("dots", 2)])
def test_flash_forward_runs_per_policy(init, batch, policy, per_layer):
    calls = []
    real = FA.flash_forward

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    with mock.patch.object(FA, "flash_forward", counting):
        _port_grads(init, batch, policy, FA.flash_attention)
    assert len(calls) == per_layer * TL.CONFIGS["tiny"].n_layers


class _CountMM(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.mm = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default:
            self.mm += 1
        return func(*args, **(kwargs or {}))


def test_dots_keeps_the_projections(init, batch):
    """Under "dots" the backward recomputes no ``aten.mm``: it runs only
    the gradients' products, two for each of the 7 projections a layer
    and the lm_head; under "full" it also recomputes the layer's
    products (all but w2's, whose output no gradient reads)."""
    counts = {}
    for policy in ("full", "dots"):
        model, cfg = TL.make_model("tiny", device="cpu", dtype=torch.float32,
                                   remat_policy=policy)
        model.load_state_dict(params_from_jax(init))
        tokens = torch.as_tensor(batch["tokens"])
        loss, _ = TT.cross_entropy_loss(model(tokens[:, :-1]), tokens[:, 1:])
        with _CountMM() as mode:
            loss.backward()
        counts[policy] = mode.mm
    layers = TL.CONFIGS["tiny"].n_layers
    assert counts["dots"] == 2 * (7 * layers + 1)
    assert counts["full"] == counts["dots"] + 6 * layers


def test_unknown_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        TL.make_model("tiny", device="cpu", remat_policy="everything")
