"""The torch package's Mixture-of-Experts (paddle_operator_tpu_torch/
models/moe.py, the MoE ``Llama``, the train and eval steps over it, the
decode path's ``_moe_ffn`` and the quantized experts) held against the
JAX package on the CPU at f32, with inputs from numpy seeds and the JAX
init converted through numpy (``params_from_jax``):

- ``route_top_k``; ``MoELayer`` output and aux loss against JAX
  ``MoELayer`` at ample capacity and under overflow, top-1 and top-2
  (atol 1e-5);
- the cases of tests/test_moe.py that need no mesh (the dense
  reference, the capacity drop, aux balanced vs collapsed, the top-2
  dense reference and renormalized gates, choice-major congestion,
  ``top_k`` validation), on the port's layer;
- ``Llama`` logits and aux against JAX ``Llama.apply`` (1e-4);
- the train step's 3-step trajectory against JAX ``make_train_step``
  (loss, grad_norm and aux_loss rtol 1e-5, params atol 1e-5) with f32
  and int8 moments — with int8, tests/test_torch_opt8bit.py's rule for
  codes that differ from JAX's by one (at most 0.1% of them; the
  params under them within 1e-4) — and a continuation from a converted
  JAX state; the
  eval step; a checkpoint resume equal to the unbroken run;
- prefill / decode_step / generate against JAX infer/decode.py (the
  cases of tests/test_decode.py, 1e-4 / 2e-4), the decode path against
  the training forward at capacity >= E, and the quantized experts
  (codes, scales and ``param_bytes`` equal to JAX's, logits to 1e-4).

Parametrised over ``tiny-moe`` (top-1) and ``tiny-moe2`` (top-2) where
the case allows.  The rings are in tests/test_torch_moe_ring.py.
"""

import itertools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_operator_tpu.infer import decode as JD
from paddle_operator_tpu.infer import quant as JQ
from paddle_operator_tpu.models import llama as JL
from paddle_operator_tpu.models import moe as JM
from paddle_operator_tpu.parallel.mesh import single_device_mesh
from paddle_operator_tpu.train import data as JDA
from paddle_operator_tpu.train import trainer as JT
from paddle_operator_tpu_torch.convert import (opt_state_from_jax,
                                               params_from_jax)
from paddle_operator_tpu_torch.infer import decode as TD
from paddle_operator_tpu_torch.infer import quant as TQ
from paddle_operator_tpu_torch.models import llama as TL
from paddle_operator_tpu_torch.models import moe as TM
from paddle_operator_tpu_torch.train import data as TDA
from paddle_operator_tpu_torch.train import opt8bit as Q8
from paddle_operator_tpu_torch.train import trainer as TT
from paddle_operator_tpu_torch.train.checkpoint import CheckpointManager

PRESETS = ["tiny-moe", "tiny-moe2"]
LAYER_ATOL = 1e-5
LOGIT_TOL = 1e-4
RTOL = 1e-5
ATOL_PARAMS = 1e-5
# int8 moments: tests/test_torch_opt8bit.py's rule (one code step of mu
# moves an element by up to ~1.25e-5 at lr 1e-3)
FLIP_ATOL = 1e-4
CODES_EQUAL = 0.999
B, S, STEPS = 4, 33, 3


def _np(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# The layer
# ---------------------------------------------------------------------------


def _layers(top_k, capacity_factor, n_experts=4):
    """The JAX layer (tests/test_moe.py's make / make2 shapes), its
    params and input, and the port's layer loaded with those params."""
    jcfg = JM.MoEConfig(dim=16, ffn_dim=32, n_experts=n_experts,
                        capacity_factor=capacity_factor, top_k=top_k,
                        dtype=jnp.float32)
    jlayer = JM.MoELayer(jcfg)
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 8, 16))
    jp = jlayer.init(jax.random.PRNGKey(0), x)["params"]
    tlayer = TM.MoELayer(TM.MoEConfig(
        dim=16, ffn_dim=32, n_experts=n_experts,
        capacity_factor=capacity_factor, top_k=top_k, dtype=torch.float32))
    tlayer.load_state_dict(params_from_jax(jax.device_get(jp)))
    return jlayer, jp, tlayer, x


def _dense_ref(jp, x, top_k, kept=None):
    """Every token through its top-k experts (gates renormalized at
    k > 1), no capacity; ``kept [T, k]`` zeroes the dropped choices."""
    t = x.reshape(-1, x.shape[-1])
    probs = jax.nn.softmax(t @ jp["router"]["kernel"], axis=-1)
    topv, topi = jax.lax.top_k(probs, top_k)
    gates = topv if top_k == 1 else topv / topv.sum(-1, keepdims=True)
    out = 0.0
    for c in range(top_k):
        idx = topi[:, c]
        h = jax.nn.gelu(jnp.einsum("td,tdf->tf", t, jp["w1"][idx]))
        g = gates[:, c] if kept is None else gates[:, c] * kept[:, c]
        out = out + jnp.einsum("tf,tfd->td", h, jp["w2"][idx]) * g[:, None]
    return np.asarray(out).reshape(x.shape)


class TestRouting:
    @pytest.mark.parametrize("k", [1, 2, 3])
    def test_route_top_k_matches_jax(self, k):
        logits = np.random.default_rng(k).normal(size=(37, 8)).astype(
            np.float32)
        probs = np.asarray(jax.nn.softmax(logits, axis=-1))
        jg, ji = JM.route_top_k(jnp.asarray(probs), k)
        tg, ti = TM.route_top_k(torch.as_tensor(probs), k)
        np.testing.assert_array_equal(_np(ti), np.asarray(ji))
        np.testing.assert_allclose(_np(tg), np.asarray(jg), rtol=1e-6)
        if k > 1:
            np.testing.assert_allclose(_np(tg).sum(-1), 1.0, rtol=1e-6)

    def test_expert_selection_is_one_hot(self):
        topi = torch.tensor([[0, 3], [2, 1]])
        sel = TM.expert_selection(topi, 4)
        assert sel.dtype == torch.int32
        np.testing.assert_array_equal(
            _np(sel), np.asarray(jax.nn.one_hot(np.asarray(topi), 4,
                                                dtype=jnp.int32)))


class TestLayer:
    @pytest.mark.parametrize("top_k", [1, 2])
    @pytest.mark.parametrize("cf", [8.0, 1.0, 0.25],
                             ids=["ample", "tight", "overflow"])
    def test_output_and_aux_match_jax(self, top_k, cf):
        jlayer, jp, tlayer, x = _layers(top_k, cf)
        want, waux = jlayer.apply({"params": jp}, x)
        got, aux = tlayer(torch.as_tensor(np.asarray(x)))
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                   atol=LAYER_ATOL)
        np.testing.assert_allclose(float(aux), float(waux), rtol=0,
                                   atol=LAYER_ATOL)

    @pytest.mark.parametrize("top_k", [1, 2])
    def test_grads_match_jax(self, top_k):
        """d(sum(out^2) + 0.01 aux) by every parameter and the input,
        under overflow (dropped assignments get no gradient)."""
        jlayer, jp, tlayer, x = _layers(top_k, 0.5)

        def loss(p, xx):
            out, aux = jlayer.apply({"params": p}, xx)
            return (out ** 2).sum() + 0.01 * aux

        gp, gx = jax.grad(loss, argnums=(0, 1))(jp, x)
        xt = torch.as_tensor(np.asarray(x)).requires_grad_()
        out, aux = tlayer(xt)
        ((out ** 2).sum() + 0.01 * aux).backward()
        want = params_from_jax(jax.device_get(gp))
        for name, p in tlayer.named_parameters():
            np.testing.assert_allclose(_np(p.grad), want[name].numpy(),
                                       rtol=0, atol=LAYER_ATOL,
                                       err_msg=name)
        np.testing.assert_allclose(_np(xt.grad), np.asarray(gx), rtol=0,
                                   atol=LAYER_ATOL)

    @pytest.mark.parametrize("top_k", [1, 2])
    def test_matches_dense_with_ample_capacity(self, top_k):
        _, jp, tlayer, x = _layers(top_k, 8.0)
        out, aux = tlayer(torch.as_tensor(np.asarray(x)))
        np.testing.assert_allclose(_np(out), _dense_ref(jp, x, top_k),
                                   atol=1e-5, rtol=1e-5)
        assert float(aux) > 0

    def test_capacity_overflow_drops_tokens(self):
        _, jp, tlayer, x = _layers(1, 0.25)
        out, _ = tlayer(torch.as_tensor(np.asarray(x)))
        assert not np.allclose(_np(out), _dense_ref(jp, x, 1), atol=1e-5)
        flat = _np(out).reshape(-1, 16)
        assert (np.abs(flat).sum(-1) < 1e-6).any()

    @pytest.mark.parametrize("cf,e,t_local,n_blk",
                             [(0.7, 7, 3, 10), (1.25, 4, 16, 2),
                              (0.5, 4, 16, 4)])
    def test_capacity_is_jaxs_over_the_global_tokens(self, cf, e, t_local,
                                                     n_blk):
        """``capacity`` over the global token count (a rank's tokens times
        the data blocks) is the buffer JAX's layer keeps for those
        tokens: every token routed to expert 0, the rows with an output
        are the kept ones.  At cf 0.7 over 3 x 10 tokens a product that
        rounds per block would give 2, not 3."""
        t = t_local * n_blk
        jcfg = JM.MoEConfig(dim=16, ffn_dim=32, n_experts=e,
                            capacity_factor=cf, top_k=1, dtype=jnp.float32)
        x = jnp.ones((1, t, 16))
        jp = JM.MoELayer(jcfg).init(jax.random.PRNGKey(0), x)["params"]
        kernel = np.zeros((16, e), np.float32)
        kernel[:, 0] = 10.0
        jp = {**jp, "router": {"kernel": jnp.asarray(kernel)}}
        out, _ = JM.MoELayer(jcfg).apply({"params": jp}, x)
        kept = int((np.abs(np.asarray(out)).sum(-1) > 0).sum())
        tcfg = TM.MoEConfig(dim=16, ffn_dim=32, n_experts=e,
                            capacity_factor=cf, top_k=1,
                            dtype=torch.float32)
        assert TM.capacity(tcfg, t_local * n_blk) == kept

    def test_aux_loss_balanced_vs_collapsed(self):
        _, jp, tlayer, x = _layers(1, 8.0)
        xt = torch.as_tensor(np.asarray(x))
        _, aux_normal = tlayer(xt)
        with torch.no_grad():
            tlayer.router.kernel.zero_()
            tlayer.router.kernel[:, 0] = 10.0
        _, aux_collapsed = tlayer(xt * 0 + 1.0)
        assert float(aux_collapsed) > float(aux_normal)
        # every token on expert 0: aux = E * 1 * mean_prob_0 ~ E
        assert float(aux_collapsed) > 3.9

    def test_top2_first_choice_outranks_second_under_congestion(self):
        """tests/test_moe.py's replay of choice-major claiming, on the
        port's layer."""
        _, jp, tlayer, x = _layers(2, 0.25)
        t = x.reshape(-1, 16)
        probs = jax.nn.softmax(t @ jp["router"]["kernel"], axis=-1)
        _, topi = jax.lax.top_k(probs, 2)
        n_tok = t.shape[0]
        cap = max(1, int(0.25 * 2 * n_tok / 4))
        count = {e: 0 for e in range(4)}
        kept = np.zeros((n_tok, 2), bool)
        for c in range(2):
            for tok in range(n_tok):
                e = int(topi[tok, c])
                if count[e] < cap:
                    count[e] += 1
                    kept[tok, c] = True
        out, _ = tlayer(torch.as_tensor(np.asarray(x)))
        np.testing.assert_allclose(_np(out), _dense_ref(jp, x, 2, kept),
                                   atol=1e-5, rtol=1e-5)
        assert kept.sum() < 2 * n_tok
        assert kept[:, 0].sum() >= kept[:, 1].sum()

    def test_top2_gates_renormalized(self):
        _, jp, tlayer, x = _layers(2, 8.0)
        out = _np(tlayer(torch.as_tensor(np.asarray(x)))[0])
        t = x.reshape(-1, 16)
        probs = jax.nn.softmax(t @ jp["router"]["kernel"], axis=-1)
        topv, topi = jax.lax.top_k(probs, 2)
        un = 0.0
        for c in range(2):
            idx = topi[:, c]
            h = jax.nn.gelu(jnp.einsum("td,tdf->tf", t, jp["w1"][idx]))
            un = un + jnp.einsum("tf,tfd->td", h, jp["w2"][idx]) \
                * topv[:, c][:, None]
        assert not np.allclose(out, np.asarray(un).reshape(x.shape),
                               atol=1e-5)

    def test_top_k_validation(self):
        layer = TM.MoELayer(TM.MoEConfig(n_experts=4, top_k=5))
        with pytest.raises(ValueError, match="top_k"):
            layer(torch.zeros((1, 4, 64)))

    def test_gelu_is_the_tanh_form(self):
        """flax's nn.gelu (approximate=True) — the exact erf form would
        differ by ~1e-4 at |x| ~ 2."""
        x = np.linspace(-4, 4, 101, dtype=np.float32)
        got = torch.nn.functional.gelu(torch.as_tensor(x),
                                       approximate="tanh")
        np.testing.assert_allclose(_np(got), np.asarray(jax.nn.gelu(x)),
                                   rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=PRESETS)
def model_pair(request):
    """(preset, JAX model, its config, JAX params, the port's model at
    f32 loaded with them, its config) at the preset's own capacity."""
    preset = request.param
    jm, jc = JL.make_model(preset, dtype=jnp.float32)
    jp = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))[
        "params"]
    tm, tc = TL.make_model(preset, device="cpu", dtype=torch.float32)
    tm.load_state_dict(params_from_jax(jax.device_get(jp)))
    return preset, jm, jc, jp, tm, tc


def _tokens(b, s, seed):
    return np.random.default_rng(seed).integers(0, 256, (b, s)).astype(
        np.int32)


class TestModel:
    def test_config_counts_match_jax(self, model_pair):
        preset, _, jc, jp, tm, tc = model_pair
        assert tc.num_params() == jc.num_params() == sum(
            p.numel() for p in tm.parameters())
        assert tc.active_params() == jc.active_params()
        assert tc.flops_per_token() == jc.flops_per_token()
        n = sum(np.asarray(x).size for x in jax.tree_util.tree_leaves(jp))
        assert n == tc.num_params()

    def test_param_names_convert_without_a_special_case(self, model_pair):
        _, _, _, jp, tm, _ = model_pair
        assert set(params_from_jax(jax.device_get(jp))) == \
            set(tm.state_dict())

    @pytest.mark.parametrize("seg", [False, True], ids=["plain", "packed"])
    def test_logits_and_aux_match_jax(self, model_pair, seg):
        _, jm, _, jp, tm, _ = model_pair
        toks = _tokens(2, 24, 3)
        segs = ((np.arange(24)[None] >= np.array([[9], [15]])).astype(
            np.int32) if seg else None)
        want, waux = jm.apply({"params": jp}, jnp.asarray(toks),
                              None if segs is None else jnp.asarray(segs))
        with torch.no_grad():
            got, aux = tm(torch.as_tensor(toks),
                          None if segs is None else torch.as_tensor(segs))
        np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                                   atol=LOGIT_TOL)
        np.testing.assert_allclose(float(aux), float(waux), rtol=1e-5)

    @pytest.mark.parametrize("policy", ["full", "save_attn", "dots"])
    def test_remat_carries_the_aux(self, model_pair, policy):
        """The per-layer checkpoint returns the (x, aux) pair under each
        policy: loss, aux and grads equal the un-rematerialized run."""
        preset, _, _, jp, _, _ = model_pair
        toks = torch.as_tensor(_tokens(2, 17, 4))
        runs = []
        for remat in (False, True):
            m, _ = TL.make_model(preset, device="cpu", dtype=torch.float32,
                                 remat=remat, remat_policy=policy)
            m.load_state_dict(params_from_jax(jax.device_get(jp)))
            logits, aux = m(toks[:, :-1])
            loss, _ = TT.cross_entropy_loss(logits, toks[:, 1:])
            (loss + aux).backward()
            runs.append((float(loss), float(aux),
                         {n: p.grad.clone() for n, p in m.named_parameters()}))
        assert runs[0][:2] == pytest.approx(runs[1][:2], rel=1e-6)
        for n, g in runs[0][2].items():
            torch.testing.assert_close(runs[1][2][n], g, rtol=1e-5,
                                       atol=1e-7)

    def test_dense_model_still_returns_logits_alone(self):
        m, _ = TL.make_model("tiny", device="cpu", dtype=torch.float32)
        out = m(torch.zeros((1, 4), dtype=torch.long))
        assert isinstance(out, torch.Tensor) and out.shape == (1, 4, 256)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def _batches():
    return list(itertools.islice(
        JDA.deterministic_lm_batches(B, S, 256, seed=11), STEPS))


@pytest.fixture(scope="module", params=[(p, m) for p in PRESETS
                                        for m in ("f32", "int8")],
                ids=lambda v: f"{v[0]}-{v[1]}")
def jax_train(request):
    """The JAX trajectory: init params, each step's metrics, the final
    params, and (params, opt_state) after two steps."""
    preset, moments = request.param
    model, cfg = JL.make_model(preset, dtype=jnp.float32)
    mesh = single_device_mesh()
    opt = JT.make_optimizer(1e-3, warmup_steps=1, decay_steps=100,
                            moments=moments)
    pats = JL.partition_patterns(cfg)
    ex = (jnp.zeros((B, S - 1), jnp.int32),)
    shardings, _ = JT.state_shardings(model, opt, mesh, pats, ex)
    state = JT.create_state(model, opt, mesh, pats, ex)
    step = JT.make_train_step(model, opt, mesh, shardings)
    run = {"preset": preset, "moments": moments,
           "init": jax.device_get(state.params), "metrics": []}
    run["states"] = []
    for i, b in enumerate(_batches()):
        if i == 2:
            run["after_two"] = jax.device_get((state.params,
                                               state.opt_state))
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        run["metrics"].append({k: float(v) for k, v in m.items()})
        run["states"].append(jax.device_get(state.opt_state))
    run["final"] = jax.device_get(state.params)
    return run


def _port_train(run, params=None):
    model, _ = TL.make_model(run["preset"], device="cpu",
                             dtype=torch.float32)
    model.load_state_dict(params_from_jax(params or run["init"]))
    opt = TT.make_optimizer(1e-3, warmup_steps=1, decay_steps=100,
                            moments=run["moments"])
    return TT.create_state(model, opt), TT.make_train_step(opt)


def _assert_run(got, want, model, final, flipped=None):
    """Metrics per step, then the final params at ATOL_PARAMS — except,
    with int8 moments, the elements under a moment code that differed
    from JAX's at some step (``flipped``), held to FLIP_ATOL."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"loss", "tokens", "grad_norm",
                                    "aux_loss"}
        assert g["tokens"] == w["tokens"]
        for key in ("loss", "grad_norm", "aux_loss"):
            np.testing.assert_allclose(g[key], w[key], rtol=RTOL,
                                       err_msg=key)
    want_p = params_from_jax(final)
    got_p = model.state_dict()
    assert set(got_p) == set(want_p)
    for k, v in want_p.items():
        diff = (got_p[k] - v).abs()
        flip = (flipped or {}).get(k, torch.zeros_like(diff, dtype=bool))
        assert float(diff[~flip].max()) <= ATOL_PARAMS, k
        if flip.any():
            assert float(diff[flip].max()) <= FLIP_ATOL, k


def _step_like_jax(state, step, batches, jax_states):
    """Step the port, and with int8 moments hold every moment code after
    each step within one of JAX's and CODES_EQUAL of them equal (the
    rule of tests/test_torch_opt8bit.py: a last-bit difference in an f32
    moment moves a value across a code midpoint; a code that differed
    before may differ by more); returns the state, the metrics and the
    params under a differing code."""
    metrics, flipped, counts, before = [], {}, [], {}
    for b, jopt in zip(batches, jax_states):
        state, m = step(state, {k: torch.as_tensor(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
        mine = state.opt_state
        if mine.kind != "int8":
            continue
        theirs = opt_state_from_jax(jopt)
        for field, tensors in theirs.tensors().items():
            if field.endswith("scales"):
                continue
            for name, t in tensors.items():
                got = mine.tensors()[field][name]
                diff = (got.int() - t.int()).abs()
                # a code that differed at an earlier step carries that
                # difference on (the moment is b1 times its own
                # dequantized value plus the new grad) and may grow by
                # one more rounding; the params under it are the ones
                # held to FLIP_ATOL
                carried = before.get((field, name),
                                     torch.zeros_like(diff, dtype=bool))
                assert int((diff * ~carried).max()) <= 1, name
                before[(field, name)] = carried | (diff > 0)
                counts.append((int((diff == 0).sum()), diff.numel()))
                shape = state.model.get_parameter(name).shape
                flip = Q8._from_blocks((got != t).float(), shape,
                                       torch.float32) > 0
                flipped[name] = flipped.get(name, flip) | flip
    if counts:
        equal, total = map(sum, zip(*counts))
        assert equal / total >= CODES_EQUAL, (equal, total)
    return state, metrics, flipped


class TestTrain:
    def test_three_steps_match_jax(self, jax_train):
        state, step = _port_train(jax_train)
        state, got, flipped = _step_like_jax(state, step, _batches(),
                                             jax_train["states"])
        _assert_run(got, jax_train["metrics"], state.model,
                    jax_train["final"], flipped)
        assert state.step == STEPS
        if jax_train["moments"] == "int8":
            mu = state.opt_state.mu["layers.0.moe.w1"]
            # 3-D expert leaves block along their last axis, as JAX's
            assert mu.codes.shape == (4, 64, 1, 256)

    def test_continues_a_jax_state(self, jax_train):
        params, opt_state = jax_train["after_two"]
        state, step = _port_train(jax_train, params)
        state.opt_state = opt_state_from_jax(opt_state)
        state.step = state.opt_state.count
        state, got, flipped = _step_like_jax(state, step, _batches()[2:],
                                             jax_train["states"][2:])
        _assert_run(got, jax_train["metrics"][2:], state.model,
                    jax_train["final"], flipped)

    def test_eval_step_takes_the_logits(self, model_pair):
        _, jm, _, jp, tm, _ = model_pair
        toks = _batches()[0]["tokens"]
        want = JT.make_eval_step(jm, single_device_mesh())(
            jp, {"tokens": jnp.asarray(toks)})
        got = TT.make_eval_step()(tm, {"tokens": torch.as_tensor(toks)})
        np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                                   rtol=RTOL)


@pytest.mark.parametrize("preset", PRESETS)
@pytest.mark.parametrize("moments", ["f32", "int8"])
def test_checkpoint_resume_equals_unbroken(tmp_path, preset, moments):
    """6 unbroken steps through fit (saves at 3 and 6) against a restore
    of step 3 into a model from another seed and 3 more steps: losses,
    aux losses and the final params bit-equal; the checkpoint holds the
    ``layers.<i>.moe.*`` leaves."""

    def port(seed):
        model, _ = TL.make_model(preset, device="cpu", seed=seed,
                                 dtype=torch.float32)
        opt = TT.make_optimizer(1e-3, warmup_steps=1, decay_steps=100,
                                moments=moments)
        return TT.create_state(model, opt), TT.make_train_step(opt)

    def batches(start=0):
        for b in TDA.deterministic_lm_batches(B, S, 256, seed=5,
                                              start_step=start):
            yield {k: torch.as_tensor(v) for k, v in b.items()}

    state_u, step_u = port(0)
    ckpt = CheckpointManager(str(tmp_path), save_interval_steps=3)
    state_u, hist_u = TT.fit(state_u, step_u, batches(), steps=6,
                             checkpoint=ckpt)
    ckpt.wait()
    saved = torch.load(tmp_path / "3" / "params.pt", weights_only=True)
    assert {"layers.0.moe.router.kernel", "layers.0.moe.w1",
            "layers.1.moe.w2"} <= set(saved)
    state_r, step_r = port(1)
    CheckpointManager(str(tmp_path)).restore(state_r, step=3)
    state_r, hist_r = TT.fit(state_r, step_r, batches(start=3), steps=3)
    for key in ("loss", "aux_loss"):
        assert [h[key] for h in hist_r] == [h[key] for h in hist_u[3:]]
    for k, v in state_u.model.state_dict().items():
        assert torch.equal(state_r.model.state_dict()[k], v), k


# ---------------------------------------------------------------------------
# Decoding
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=PRESETS)
def decode_pair(request):
    """As model_pair at moe_capacity_factor 8.0 (>= E: no drop, so the
    training forward is the exact conditional model too)."""
    preset = request.param
    jm, jc = JL.make_model(preset, dtype=jnp.float32,
                           moe_capacity_factor=8.0)
    jp = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))[
        "params"]
    tm, tc = TL.make_model(preset, device="cpu", dtype=torch.float32,
                           moe_capacity_factor=8.0)
    tm.load_state_dict(params_from_jax(jax.device_get(jp)))
    return jm, jc, jp, tm, tc


class TestDecode:
    def test_prefill_matches_training_forward_when_no_drops(self,
                                                           decode_pair):
        jm, _, jp, tm, tc = decode_pair
        toks = _tokens(2, 10, 0)
        ref, _ = jm.apply({"params": jp}, jnp.asarray(toks))
        cache = TD.init_cache(tc, 2, device="cpu")
        with torch.no_grad():
            logits, _ = TD._forward(tc, tm, torch.as_tensor(toks), cache)
            train, _ = tm(torch.as_tensor(toks))
        np.testing.assert_allclose(_np(logits), np.asarray(ref),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        np.testing.assert_allclose(_np(logits), _np(train), rtol=LOGIT_TOL,
                                   atol=LOGIT_TOL)

    def test_incremental_decode_matches_jax(self, decode_pair):
        jm, jc, jp, tm, tc = decode_pair
        toks = _tokens(2, 8, 5)
        _, jcache = JD.prefill(jp, jc, jnp.asarray(toks[:, :3]))
        with torch.no_grad():
            _, cache = TD.prefill(tm, tc, torch.as_tensor(toks[:, :3]))
            for t in range(3, toks.shape[1]):
                got, cache = TD.decode_step(tm, tc,
                                            torch.as_tensor(toks[:, t]),
                                            cache)
                want, jcache = JD.decode_step(jp, jc, jnp.asarray(toks[:, t]),
                                              jcache)
                ref, _ = jm.apply({"params": jp}, jnp.asarray(toks[:, :t + 1]))
                np.testing.assert_allclose(_np(got), np.asarray(want),
                                           rtol=LOGIT_TOL, atol=LOGIT_TOL,
                                           err_msg=str(t))
                np.testing.assert_allclose(_np(got), np.asarray(ref[:, -1]),
                                           rtol=LOGIT_TOL, atol=LOGIT_TOL,
                                           err_msg=str(t))

    def test_decode_matches_training_forward(self, decode_pair):
        """tests/test_moe_train.py's top-2 decode case (2e-4)."""
        jm, _, jp, tm, tc = decode_pair
        toks = _tokens(2, 9, 2)
        train, _ = jm.apply({"params": jp}, jnp.asarray(toks))
        with torch.no_grad():
            _, cache = TD.prefill(tm, tc, torch.as_tensor(toks[:, :-1]))
            step, _ = TD.decode_step(tm, tc, torch.as_tensor(toks[:, -1]),
                                     cache)
        np.testing.assert_allclose(_np(step), np.asarray(train[:, -1]),
                                   rtol=2e-4, atol=2e-4)

    def test_generate_matches_jax(self, decode_pair):
        _, jc, jp, tm, tc = decode_pair
        prompt = _tokens(3, 5, 7)
        want = JD.generate(jp, jc, jnp.asarray(prompt), max_new_tokens=8)
        with torch.no_grad():
            got = TD.generate(tm, tc, torch.as_tensor(prompt),
                              max_new_tokens=8)
        np.testing.assert_array_equal(_np(got), np.asarray(want))

    def test_sampled_generate_stays_in_vocab(self, decode_pair):
        _, _, _, tm, tc = decode_pair
        with torch.no_grad():
            out = TD.generate(tm, tc, torch.as_tensor(_tokens(2, 4, 1)),
                              max_new_tokens=3, temperature=0.8)
        assert out.shape == (2, 7) and int(out.max()) < tc.vocab_size


class TestQuantizedExperts:
    @pytest.mark.parametrize("legacy,mode", [(True, "int8"),
                                             (False, "int8"),
                                             (False, "int4")],
                             ids=["legacy", "serving-int8", "serving-int4"])
    def test_codes_bytes_and_logits_match_jax(self, decode_pair, legacy,
                                              mode):
        """tests/test_decode.py's quantized MoE case: the experts'
        codes and scales equal JAX ``quantize_leaf`` of the [E, in,
        out] leaf, ``param_bytes`` and ``weight_quant_mode`` equal JAX's,
        and the prefill / decode logits of the quantized models agree."""
        _, jc, jp, _, tc = decode_pair
        kw = {} if legacy else dict(mode=mode, skip=JQ.SERVING_SKIP)
        jq = JQ.quantize_params(jp, None if legacy else jc, **kw)
        m, _ = TL.make_model("tiny-moe" if tc.moe_top_k == 1 else
                             "tiny-moe2", device="cpu", dtype=torch.float32,
                             moe_capacity_factor=8.0)
        m.load_state_dict(params_from_jax(jax.device_get(jp)))
        tkw = {} if legacy else dict(mode=mode, skip=TQ.SERVING_SKIP)
        TQ.quantize_params(m, None if legacy else tc, **tkw)
        moe = m.layers[0].moe
        assert isinstance(moe.w1, TM.ExpertCodes) and moe.w1.mode == mode
        assert "w1" not in dict(moe.named_parameters())
        assert TQ.weight_quant_mode(m) == JQ.weight_quant_mode(jq) == mode
        assert TQ.param_bytes(m) == JQ.param_bytes(jq)
        jw1 = jq["layers"]["moe"]["w1"]
        np.testing.assert_array_equal(
            _np(moe.w1.q), np.asarray(jw1["q"][0]).astype(np.int8))
        np.testing.assert_array_equal(_np(moe.w1.s), np.asarray(jw1["s"][0]))
        assert moe.w1.s.shape == (4, 1, 128)
        # the router stays in the compute dtype
        assert moe.router.mode == "none"
        # the converted quantized tree loads into the quantized model
        m.load_state_dict(params_from_jax(jax.device_get(jq)))
        toks = _tokens(2, 10, 0)
        want, jcache = JD.prefill(jq, jc, jnp.asarray(toks))
        with torch.no_grad():
            got, cache = TD.prefill(m, tc, torch.as_tensor(toks))
            got2, _ = TD.decode_step(m, tc, got.argmax(-1).int(), cache)
        want2, _ = JD.decode_step(jq, jc, jnp.argmax(want, -1).astype(
            jnp.int32), jcache)
        np.testing.assert_allclose(_np(got), np.asarray(want),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        np.testing.assert_allclose(_np(got2), np.asarray(want2),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)

    def test_quantized_moe_decode_runs(self, decode_pair):
        """tests/test_decode.py:317 on the port, tokens equal to the JAX
        quantized model's."""
        _, jc, jp, _, tc = decode_pair
        jq = JQ.quantize_params(jp)
        m, _ = TL.make_model("tiny-moe" if tc.moe_top_k == 1 else
                             "tiny-moe2", device="cpu", dtype=torch.float32,
                             moe_capacity_factor=8.0)
        m.load_state_dict(params_from_jax(jax.device_get(jp)))
        TQ.quantize_params(m)
        assert m.layers[0].moe.w1.q.dtype == torch.int8
        prompt = _tokens(2, 4, 3)
        with torch.no_grad():
            got = TD.generate(m, tc, torch.as_tensor(prompt),
                              max_new_tokens=3)
        want = JD.generate(jq, jc, jnp.asarray(prompt), max_new_tokens=3)
        assert got.shape == (2, 7)
        np.testing.assert_array_equal(_np(got), np.asarray(want))
