"""The torch package's pipeline parallelism (paddle_operator_tpu_torch/
parallel/pipeline.py, the pp train step of train/trainer.py, the pp
checkpoint of train/checkpoint.py) held against the JAX package's, on
the CPU.

- Primitive level: ``pipeline_apply`` (GPipe) and
  ``pipeline_1f1b_grads`` over spawned gloo ranks, stage *s* holding
  its block of a stack of tanh layers (tests/test_parallel_prims.py
  ``TestPipeline``'s stage function), against JAX's
  ``make_pipeline_fn`` and ``make_pipeline_1f1b_fn`` on the conftest's
  8 virtual devices: the output and the gradients of ``sum(out ** 2)``
  in every layer and the input (GPipe), the sum-loss of a softmax head
  seeded with ``1/denom`` and its trunk, head and input gradients
  (1F1B), at pp 2 with M 4 and 2, at pp 4 with M 8, and with a
  per-microbatch side input (atol and rtol 1e-5).
- Train-step level: TPUJob worlds through the launcher shim
  (``initialize(device="cpu")``, ``job_mesh``, ``create_state(mesh=...)``,
  ``make_step_for_mesh(num_microbatches, schedule)``, ``fit`` over
  ``DevicePrefetcher(mesh=...)``, the sharded checkpoint), the tiny
  preset at f32 from the JAX init, three steps against JAX's
  ``make_step_for_mesh`` on the same mesh (losses and grad norms rtol
  1e-5, the saved parameters atol 1e-5, every rank's metrics bit-equal,
  JAX's specs with a layer's pp entry its stage):

  - ``pp2 × dp2 × tp2`` (8 ranks), GPipe and 1F1B at M 4; on the GPipe
    run the pp checkpoint: two more steps, a restore of step 3 on the
    mesh and the same two steps bit for bit, step 3 restored on one CPU
    "card" continuing within the bound, a drain signalled on one rank
    stopping every rank after the same step, and ``load_serving_params``
    reading the drained step's whole ``params.pt``;
  - ``pp2 × fsdp2`` (4 ranks), GPipe and 1F1B at M 4: a stage's
    layers are DTensors over fsdp, gathered and reduce-scattered inside
    each microbatch's backward;
  - ``pp2 × cp2`` (4 ranks), both schedules on padded batches (JAX
    ``test_masked_batches_match_gspmd_both_schedules``) and on packed
    sequences (``test_packed_sequences_match_gspmd_both_schedules``),
    and 1F1B at M 2 (``test_1f1b_small_microbatch_count``).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_operator_tpu.parallel import pipeline as JP
from paddle_operator_tpu_torch.convert import params_from_jax
from paddle_operator_tpu_torch.infer.serve import load_serving_params
from paddle_operator_tpu_torch.models import llama as TL
from paddle_operator_tpu_torch.parallel import pipeline as TP
from paddle_operator_tpu_torch.train import checkpoint as TC
from paddle_operator_tpu_torch.train import trainer as TT
from tests.test_torch_context_parallel import (STEPS, _jax_mesh, check_run,
                                               jax_trajectory, one_card_eval,
                                               spawn_gloo, traj_batches,
                                               traj_world)

TOL = 1e-5
DIM, BM, CLASSES = 8, 4, 5

PRIM_CHILD = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
from paddle_operator_tpu_torch.api.types import MeshSpec
from paddle_operator_tpu_torch.parallel import pipeline as TP
from paddle_operator_tpu_torch.parallel.mesh import make_mesh

a = json.load(open(sys.argv[1]))
rank, world = int(sys.argv[2]), a["world"]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{a['port']}",
                        world_size=world, rank=rank)
mesh = make_mesh(MeshSpec(pp=world), device="cpu")
out = {}
for c in a["cases"]:
    d = np.load(c["inputs"])
    per = d["w"].shape[0] // world
    w = torch.from_numpy(d["w"][rank * per:(rank + 1) * per]) \
        .requires_grad_()
    b = torch.from_numpy(d["b"][rank * per:(rank + 1) * per]) \
        .requires_grad_()
    ex = torch.from_numpy(d["ex"]) if c["extras"] else None

    def block(h, e=None):
        for i in range(per):
            h = torch.tanh(h @ w[i] + b[i])
        return h if e is None else h * e

    xm = torch.from_numpy(d["x"])
    if c["schedule"] == "gpipe":
        x = xm.clone().requires_grad_()
        y = TP.make_pipeline_fn(mesh, block, num_microbatches=xm.shape[0])(
            [w, b], x, ex)
        (y ** 2).sum().backward()
        got = {"out": y.detach(), "dw": w.grad, "db": b.grad,
               "dx": x.grad}
    else:
        hw = torch.from_numpy(d["hw"]).requires_grad_()

        def head(h, t, m):
            ll = torch.log_softmax(h @ hw, -1).gather(
                -1, t.long()[..., None])[..., 0]
            return -(ll * m).sum()

        loss, (dw, db), (dhw,), dx = TP.make_pipeline_1f1b_fn(
            mesh, block, head)([w, b], [hw], xm, torch.from_numpy(d["t"]),
                               torch.from_numpy(d["m"]), float(d["seed"]),
                               ex)
        got = {"loss": loss.reshape(1), "dw": dw, "db": db, "dhw": dhw,
               "dx": dx}
    for k, v in got.items():
        out[f"{c['name']}_{k}"] = v.numpy()
np.savez(f"{a['out']}/rank{rank}.npz", **out)
dist.destroy_process_group()
'''

PRIM_CASES = [
    {"name": f"{schedule}_pp{pp}_m{m}" + ("_ex" if extras else ""),
     "schedule": schedule, "pp": pp, "m": m, "extras": extras}
    for schedule in ("gpipe", "1f1b")
    for pp, m, extras in ((2, 4, False), (2, 2, False), (4, 8, False),
                          (2, 4, True))]


def _prim_inputs(case):
    rng = np.random.default_rng(7)
    n_layers, m = 2 * case["pp"], case["m"]
    mask = (rng.random((m, BM)) < 0.8).astype(np.float32)
    return {
        "w": (rng.standard_normal((n_layers, DIM, DIM)) * 0.3)
        .astype(np.float32),
        "b": (rng.standard_normal((n_layers, DIM)) * 0.1).astype(np.float32),
        "x": rng.standard_normal((m, BM, DIM)).astype(np.float32),
        "ex": rng.uniform(0.5, 1.5, (m, BM, 1)).astype(np.float32),
        "hw": rng.standard_normal((DIM, CLASSES)).astype(np.float32),
        "t": rng.integers(0, CLASSES, (m, BM)).astype(np.int32),
        "m": mask, "seed": np.float32(1.0 / max(mask.sum(), 1.0)),
    }


@pytest.fixture(scope="module")
def prim_worlds(tmp_path_factory):
    """pp -> the port's results by case, one spawned world a pp."""
    worlds = {}

    def get(pp):
        if pp not in worlds:
            tmp = tmp_path_factory.mktemp(f"pp{pp}_prims")
            cases = []
            for c in PRIM_CASES:
                if c["pp"] == pp:
                    np.savez(tmp / f"{c['name']}.npz", **_prim_inputs(c))
                    cases.append(dict(c, inputs=str(tmp / f"{c['name']}"
                                                         ".npz")))
            worlds[pp] = spawn_gloo(tmp, PRIM_CHILD, pp, {"cases": cases})
        return worlds[pp]

    return get


def _jax_block(params, h, extra=None):
    def one(h, layer):
        return jnp.tanh(h @ layer["w"] + layer["b"]), None

    h, _ = jax.lax.scan(one, h, params)
    return h if extra is None else h * extra


def _jax_pipeline(case, d):
    mesh = _jax_mesh({"pp": case["pp"], "dp": 8 // case["pp"]})
    params = {"w": jnp.asarray(d["w"]), "b": jnp.asarray(d["b"])}
    x = jnp.asarray(d["x"])
    extras = jnp.asarray(d["ex"]) if case["extras"] else None
    kw = {"with_extras": True} if case["extras"] else {}
    if case["schedule"] == "gpipe":
        fn = JP.make_pipeline_fn(mesh, _jax_block,
                                 num_microbatches=case["m"], **kw)

        def loss(p, x):
            y = fn(p, x, extras) if extras is not None else fn(p, x)
            return (y ** 2).sum(), y

        with mesh:
            (_, y), (dp, dx) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(params, x)
        return {"out": y, "dw": dp["w"], "db": dp["b"], "dx": dx}

    def head(hp, h, t, m):
        logp = jax.nn.log_softmax(h @ hp["hw"], axis=-1)
        ll = jnp.take_along_axis(logp, t[..., None], -1)[..., 0]
        return -(ll * m).sum()

    fn = JP.make_pipeline_1f1b_fn(mesh, _jax_block, head, **kw)
    args = (params, {"hw": jnp.asarray(d["hw"])}, x, jnp.asarray(d["t"]),
            jnp.asarray(d["m"]), jnp.float32(d["seed"]), 0.0)
    with mesh:
        loss, dt, dh, dx = jax.jit(fn)(*args, extras) \
            if extras is not None else jax.jit(fn)(*args)
    return {"loss": jnp.reshape(loss, (1,)), "dw": dt["w"], "db": dt["b"],
            "dhw": dh["hw"], "dx": dx}


@pytest.mark.parametrize("name", [c["name"] for c in PRIM_CASES])
def test_pipeline_matches_jax(prim_worlds, name):
    case = {c["name"]: c for c in PRIM_CASES}[name]
    res = prim_worlds(case["pp"])
    want = {k: np.asarray(v)
            for k, v in _jax_pipeline(case, _prim_inputs(case)).items()}
    for k, v in want.items():
        got = [r[f"{name}_{k}"] for r in res]
        if k in ("dw", "db"):
            # each stage's gradients are its own layers'
            got = [np.concatenate(got)]
        for g in got:            # replicated: the same on every stage
            np.testing.assert_allclose(g, v, atol=TOL, rtol=TOL,
                                       err_msg=k)


def test_microbatch_validation():
    assert TP.microbatch(torch.zeros(6, 2), 3).shape == (3, 2, 2)
    with pytest.raises(ValueError, match="not divisible"):
        TP.microbatch(torch.zeros(5, 2), 2)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

MORE, DRAIN, DRAIN_RANK = 2, 3, 5


@pytest.fixture(scope="module")
def pp_world(tmp_path_factory):
    """pp2 × dp2 × tp2: GPipe (with the checkpoint checks) and 1F1B."""
    tmp = tmp_path_factory.mktemp("pp2_dp2_tp2")
    axes = {"pp": 2, "dp": 2, "tp": 2}
    batches = traj_batches(STEPS + MORE + DRAIN)
    want = {s: jax_trajectory(axes, batches[:STEPS], schedule=s)
            for s in ("gpipe", "1f1b")}
    runs = [{"name": "gpipe", "batches": batches, "model": {},
             "step": {"schedule": "gpipe", "num_microbatches": 4},
             "more": MORE, "drain": DRAIN, "drain_rank": DRAIN_RANK},
            {"name": "1f1b", "batches": batches[:STEPS], "model": {},
             "step": {"schedule": "1f1b", "num_microbatches": 4}}]
    res = traj_world(tmp, "pp", axes, params_from_jax(want["gpipe"][0]),
                     runs)
    return {"res": res, "want": want, "tmp": tmp, "axes": axes,
            "batches": batches}


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pp_dp_tp_train_step_matches_jax(pp_world, schedule):
    _, metrics, final, specs = pp_world["want"][schedule]
    ckpt = pp_world["tmp"] / f"pp-ckpt-{schedule}"
    runs = check_run(pp_world["res"], schedule, metrics, final, specs,
                     pp_world["axes"], ckpt)
    assert runs[0]["exchange"]["hop"] > 0
    assert not any(r["jax_imported"] for r in pp_world["res"])
    if schedule == "1f1b":
        # the same trajectory as GPipe's (same math, other schedule)
        gpipe = pp_world["res"][0]["runs"]["gpipe"]["fit"]
        for g, f in zip(gpipe, runs[0]["fit"]):
            np.testing.assert_allclose(f["loss"], g["loss"], rtol=1e-5)


class TestPipelineCheckpoint:
    def _runs(self, pp_world):
        return [r["runs"]["gpipe"] for r in pp_world["res"]]

    def test_restore_on_the_mesh_continues_bit_for_bit(self, pp_world):
        runs = self._runs(pp_world)
        assert len({str((r["cont"], r["cont_again"])) for r in runs}) == 1
        for r in runs:
            assert r["restored_step"] == STEPS
            assert r["cont"] == r["cont_again"]

    def test_saves_every_layer_once_and_restores_on_one_card(self, pp_world):
        """The step-3 checkpoint of the pp world: ``params.pt`` whole
        (stage 1's layers came to rank 0 by c10d calls), moments in
        per-rank shard files; restored into a one-device state it
        continues as the mesh did."""
        ckpt = pp_world["tmp"] / "pp-ckpt-gpipe"
        saved = torch.load(ckpt / str(STEPS) / TC.PARAMS_FILE,
                           weights_only=True)
        model, _ = TL.make_model("tiny", device="cpu", dtype=torch.float32)
        assert set(saved) == set(model.state_dict())
        opt = TT.make_optimizer(1e-3, warmup_steps=1, decay_steps=100)
        state = TC.CheckpointManager(str(ckpt)).restore(
            TT.create_state(model, opt), step=STEPS)
        assert state.step == STEPS and state.opt_state.count == STEPS
        step = TT.make_train_step(opt)
        got = []
        for b in pp_world["batches"][STEPS:STEPS + MORE]:
            state, m = step(state, {"tokens": torch.as_tensor(
                b["tokens"].copy())})
            got.append({k: float(v) for k, v in m.items()})
        for g, w in zip(got, self._runs(pp_world)[0]["cont"]):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)

    def test_drain_on_one_rank_stops_every_rank_together(self, pp_world):
        runs = self._runs(pp_world)
        assert len({str(r["drain"]) for r in runs}) == 1
        d = runs[0]["drain"]
        start = STEPS + MORE
        assert d["steps"] == 2 and d["step"] == start + 2 and d["draining"]
        assert runs[DRAIN_RANK]["drain_reason"] == "injected"
        assert {r["drain_reason"] for i, r in enumerate(runs)
                if i != DRAIN_RANK} == {"a peer rank is draining"}
        assert d["all_steps"] == [STEPS, start + 1, start + 2]

    def test_server_loads_the_drained_step(self, pp_world):
        ckpt = pp_world["tmp"] / "pp-ckpt-gpipe"
        newest = self._runs(pp_world)[0]["drain"]["step"]
        served, cfg, resumed = load_serving_params(
            str(ckpt), TL.CONFIGS["tiny"], device="cpu")
        assert resumed
        saved = torch.load(ckpt / str(newest) / TC.PARAMS_FILE,
                           weights_only=True)
        assert set(served.state_dict()) == set(saved)
        for n, p in served.state_dict().items():
            assert torch.equal(p, saved[n].to(cfg.dtype)), n


@pytest.fixture(scope="module")
def ppfsdp_world(tmp_path_factory):
    """pp2 × fsdp2: GPipe and 1F1B, a stage's layers sharded over fsdp
    (gathered and reduce-scattered inside each microbatch's backward)."""
    tmp = tmp_path_factory.mktemp("pp2_fsdp2")
    axes = {"pp": 2, "fsdp": 2}
    batches = traj_batches(STEPS)
    want = {s: jax_trajectory(axes, batches, schedule=s)
            for s in ("gpipe", "1f1b")}
    runs = [{"name": s, "batches": batches, "model": {},
             "step": {"schedule": s, "num_microbatches": 4}}
            for s in ("gpipe", "1f1b")]
    res = traj_world(tmp, "ppfsdp", axes,
                     params_from_jax(want["gpipe"][0]), runs)
    return {"res": res, "want": want, "tmp": tmp, "axes": axes,
            "batches": batches}


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_pp_fsdp_train_step_matches_jax(ppfsdp_world, schedule):
    _, metrics, final, specs = ppfsdp_world["want"][schedule]
    ckpt = ppfsdp_world["tmp"] / f"ppfsdp-ckpt-{schedule}"
    runs = check_run(ppfsdp_world["res"], schedule, metrics, final, specs,
                     ppfsdp_world["axes"], ckpt)
    assert runs[0]["exchange"]["hop"] > 0
    np.testing.assert_allclose(
        runs[0]["eval"], one_card_eval(ckpt, ppfsdp_world["batches"][0]),
        rtol=1e-5)


PPCP_RUNS = {
    "gpipe_mask": ({"mask": True}, "gpipe", 4),
    "1f1b_mask": ({"mask": True}, "1f1b", 4),
    "gpipe_packed": ({"packed": True}, "gpipe", 4),
    "1f1b_packed": ({"packed": True}, "1f1b", 4),
    "1f1b_m2": ({}, "1f1b", 2),
}


@pytest.fixture(scope="module")
def ppcp_world(tmp_path_factory):
    """pp2 × cp2: both schedules on padded and packed batches, 1F1B at
    M 2."""
    tmp = tmp_path_factory.mktemp("pp2_cp2")
    axes = {"pp": 2, "cp": 2}
    want, runs = {}, []
    for name, (kind, schedule, m) in PPCP_RUNS.items():
        batches = traj_batches(STEPS, **kind)
        want[name] = jax_trajectory(axes, batches, schedule=schedule,
                                    num_microbatches=m)
        runs.append({"name": name, "batches": batches, "model": {},
                     "step": {"schedule": schedule,
                              "num_microbatches": m}})
    init = params_from_jax(want["gpipe_mask"][0])
    res = traj_world(tmp, "ppcp", axes, init, runs)
    return {"res": res, "want": want, "tmp": tmp, "axes": axes,
            "runs": runs}


@pytest.mark.parametrize("name", list(PPCP_RUNS))
def test_pp_cp_train_step_matches_jax(ppcp_world, name):
    _, metrics, final, specs = ppcp_world["want"][name]
    ckpt = ppcp_world["tmp"] / f"ppcp-ckpt-{name}"
    runs = check_run(ppcp_world["res"], name, metrics, final, specs,
                     ppcp_world["axes"], ckpt)
    assert runs[0]["exchange"]["hop"] > 0 and runs[0]["exchange"]["shift"]
    batch = {r["name"]: r for r in ppcp_world["runs"]}[name]["batches"][0]
    np.testing.assert_allclose(runs[0]["eval"], one_card_eval(ckpt, batch),
                               rtol=1e-5)
