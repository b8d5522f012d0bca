"""The torch package's expert parallelism (paddle_operator_tpu_torch/
models/moe.py on a mesh, the ep pair and the counts' prefix of
parallel/collectives.py, the MoE mesh step of train/trainer.py, the ep
rule of the sharded checkpoint) held against the JAX package's GSPMD
MoE (tests/test_moe_train.py), in worlds of spawned gloo ranks on the
CPU, each rank started through the port's launcher shim with the env
controller/builders.py gives a TPUJob's pods.

- One job of 8 ranks (``TPUJOB_MESH`` ep2 x dp4) trains, each from the
  JAX init at f32, three steps of JAX ``synthetic_batch(8, 17)`` on the
  meshes ep4 x dp2 and ep2 x dp4 (``tiny-moe``, top-1), ep2 x dp4 at
  ``tiny-moe2`` (top-2) and ep2 x fsdp2 x tp2 (``tiny-moe``), each at
  the default capacity factor 1.25 and at 0.5 (every step drops
  assignments there: a capacity computed from a rank's own tokens would
  drop others).  Against JAX ``make_train_step`` on the same mesh over
  the conftest's 8 virtual devices: losses, ``aux_loss`` and grad norms
  rtol 1e-5, the saved parameters atol 1e-5, every rank's metrics
  bit-equal, each parameter's placements JAX's ``state_shardings``
  specs, the dropped assignments above 0 at 0.5.  On ep2 x dp4 the
  eval step's loss and the mesh forward's ``(logits, aux)`` equal
  JAX's.  The pipeline worlds are in tests/test_torch_moe_pipeline.py.
- ep2 x dp2 (4 ranks) through ``fit`` with the checkpoint: a restore of
  step 3 on the mesh continues bit for bit; the step restores on one
  card and continues within the bound; ``load_serving_params`` reads it
  and greedy ``generate`` (``_moe_ffn``) gives the tokens of the same
  parameters trained without a mesh.
- MoE with ``cp`` > 1 is refused by name (ROADMAP.md Queue A item 8.6).
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_operator_tpu.api import (ResourceSpec, TPUJob, TPUJobSpec,
                                     TPUSpec)
from paddle_operator_tpu.api.types import (HOSTPORT_ANNOTATION, Intranet,
                                           MeshSpec)
from paddle_operator_tpu.controller import builders as B
from paddle_operator_tpu.models import llama as JL
from paddle_operator_tpu.parallel import mesh as JM
from paddle_operator_tpu.train import trainer as JT
from paddle_operator_tpu_torch.convert import params_from_jax
from paddle_operator_tpu_torch.infer import decode as TD
from paddle_operator_tpu_torch.infer.serve import load_serving_params
from paddle_operator_tpu_torch.models import llama as TL
from paddle_operator_tpu_torch.train import checkpoint as TC
from paddle_operator_tpu_torch.train import trainer as TT
from tests.test_torch_sharded_train import _free_port, _pod_env

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
ATOL_PARAMS = 1e-5
BATCH, SEQ, STEPS = 8, 16, 3            # tests/test_moe_train.py's
CFS = (1.25, 0.5)

CHILD = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
from paddle_operator_tpu_torch.launch import launcher
from paddle_operator_tpu_torch.models import llama as TL
from paddle_operator_tpu_torch.parallel import collectives as C
from paddle_operator_tpu_torch.parallel import mesh as PM
from paddle_operator_tpu_torch.parallel import sharding as PS
from paddle_operator_tpu_torch.train import checkpoint as TC
from paddle_operator_tpu_torch.train import data as TD
from paddle_operator_tpu_torch.train import trainer as TT

a = json.load(open(sys.argv[1]))
env = launcher.initialize(device="cpu")
job = launcher.job_mesh(env, device="cpu")
rank = dist.get_rank()
out = {"rank": rank, "runs": {}}
meshes = {json.dumps(env.mesh.to_dict(), sort_keys=True): job}
init = torch.load(a["init"])
data = np.load(a["batches"])
batches = [{"tokens": data[f"b{i}"]} for i in range(len(data.files))]


def mesh_of(axes):
    key = json.dumps({k: v for k, v in axes.items() if v > 1},
                     sort_keys=True)
    if key not in meshes:
        meshes[key] = PM.make_mesh(PM.MeshSpec(**axes), device="cpu")
    return meshes[key]


def floats(hist):
    return [{k: float(v) for k, v in m.items()} for m in hist]


def dropped(model):
    return sum(int(m.moe.dropped) for m in model.layers if hasattr(m, "moe"))


def fresh(run, mesh):
    model, cfg = TL.make_model(run["preset"], device="cpu",
                               dtype=torch.float32,
                               moe_capacity_factor=run["cf"])
    model.load_state_dict(init)
    opt = TT.make_optimizer(1e-3, warmup_steps=1, decay_steps=100)
    sh = TT.state_shardings(model, opt, mesh)
    return TT.create_state(model, opt, mesh=mesh), opt, sh


for run in a["runs"]:
    mesh = mesh_of(run["axes"])
    state, opt, sh = fresh(run, mesh)
    named = dict(state.model.named_parameters())
    step = TT.make_step_for_mesh(opt, mesh, **run["step"])
    r = {"coords": PM.coordinates(mesh),
         "specs": {k: (("pp",) if k in sh.stages else ())
                   + PS.param_spec(p) for k, p in named.items()},
         "planned": {k: sh.spec(k, p.ndim) for k, p in named.items()}}
    for k in C.EXCHANGE:
        C.EXCHANGE[k] = 0
    if run.get("fit"):
        # the checkpoint world: fit with the interval save, two steps on,
        # the restore of step 3 and the same two steps again
        n = run["steps"]
        rows = [TD.process_slice(b, mesh=mesh) for b in batches]
        ckpt = TC.CheckpointManager(run["ckpt"], save_interval_steps=n)
        state, hist = TT.fit(
            state, step, TD.DevicePrefetcher(iter(rows[:n]), mesh=mesh),
            steps=n, checkpoint=ckpt)
        ckpt.wait()
        r["fit"] = floats(hist)
        local = [PS.local_batch(b, mesh, "cpu") for b in rows[n:]]

        def steps_on(state):
            got = []
            for b in local:
                state, m = step(state, b)
                got.append(floats([m])[0])
            return state, got

        state, r["cont"] = steps_on(state)
        state = ckpt.restore(state, step=n)
        r["restored_step"] = state.step
        state, r["cont_again"] = steps_on(state)
        r["files"] = sorted(os.listdir(os.path.join(run["ckpt"], str(n))))
        shard = torch.load(os.path.join(
            run["ckpt"], str(n), TC.SHARD_FILE.format(rank=rank)),
            weights_only=True) if rank in a["writers"] else None
        r["shard_names"] = None if shard is None else sorted(shard["mu"])
    else:
        hist, drops = [], []
        for b in batches[:run["steps"]]:
            state, m = step(state, PS.shard_batch(b, mesh, "cpu"))
            hist.append(m)
            drops.append(dropped(state.model))
        r["fit"] = floats(hist)
        r["dropped"] = drops
        ckpt = TC.CheckpointManager(run["ckpt"])
        ckpt.save(run["steps"], state, force=True)
        ckpt.wait()
        if run.get("eval"):
            b = PS.shard_batch(batches[0], mesh, "cpu")
            r["eval"] = float(TT.make_eval_step(mesh)(state.model,
                                                      b)["loss"])
            tokens = PS.to_local(b["tokens"])
            with torch.no_grad():
                logits, aux = state.model(tokens[:, :-1])
            np.save(os.path.join(a["out"], f"logits{rank}.npy"),
                    logits.numpy())
            r["aux"] = float(aux)
    r["reduce_bytes"] = C.EXCHANGE["reduce"]
    out["runs"][run["name"]] = r
    del state, step

out["refused"] = {}
try:
    cp_mesh = mesh_of({"cp": 2, "fsdp": dist.get_world_size() // 2})
    model, _ = TL.make_model("tiny-moe", device="cpu")
    TT.create_state(model, TT.make_optimizer(), mesh=cp_mesh)
    out["refused"]["moe_cp"] = None
except NotImplementedError as err:
    out["refused"]["moe_cp"] = f"{type(err).__name__}: {err}"
out["jax_imported"] = any(m.split(".")[0] in ("jax", "paddle_operator_tpu")
                          for m in sys.modules)
with open(os.path.join(a["out"], f"rank{rank}.json"), "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
'''


def start_world(tmp, name, slices, workers, mesh, args, child_src=CHILD):
    """Start ``child_src`` on every pod of a ``slices`` x ``workers`` TPUJob
    through the launcher shim, without waiting: returns what
    :func:`finish_world` takes."""
    port = _free_port()
    tmpl = {"spec": {"containers": [{"name": "m", "image": "i"}]}}
    job = TPUJob(name=name, spec=TPUJobSpec(
        intranet=Intranet.HOST,
        worker=ResourceSpec(replicas=slices * workers, template=tmpl),
        tpu=TPUSpec(topology=f"1x{workers}", slice_count=slices,
                    chips_per_worker=1),
        mesh=mesh))
    job.annotations[HOSTPORT_ANNOTATION] = str(port)
    assert job.validate() == []
    pods = []
    for i in range(slices * workers):
        pod = B.construct_pod(job, "worker", i)
        pod["status"] = {"podIP": f"127.0.0.{i + 1}"}
        pods.append(pod)
    cm = B.construct_configmap(job, pods)
    out = tmp / f"{name}-out"
    out.mkdir()
    child = tmp / f"{name}-child.py"
    child.write_text(child_src)
    argf = tmp / f"{name}.json"
    argf.write_text(json.dumps(dict(args, out=str(out))))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "paddle_operator_tpu_torch.launch.launcher",
         "--", sys.executable, str(child), str(argf)],
        env=_pod_env(cm, pod), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for pod in pods]
    return procs, out


def finish_world(started, timeout=300):
    """Wait for a :func:`start_world` world; each rank's result, in rank
    order."""
    procs, out = started
    try:
        for i, p in enumerate(procs):
            _, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"rank {i} failed:\n{err[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(len(procs))]


def jax_mesh(axes):
    spec = MeshSpec(**axes)
    return JM.make_mesh(spec, devices=jax.devices()[:spec.size()])


def batches(n=STEPS):
    """tests/test_moe_train.py's batches: synthetic_batch(8, 17, vocab,
    seed=i)."""
    return [np.asarray(JT.synthetic_batch(BATCH, SEQ + 1, 256,
                                          seed=i)["tokens"])
            for i in range(n)]


def jax_init():
    """The JAX init of the MoE presets (tiny-moe and tiny-moe2 share their
    shapes and values; JAX draws the same values on every mesh)."""
    mesh = jax_mesh({})
    model, cfg = JL.make_model("tiny-moe", mesh=mesh, dtype=jnp.float32)
    opt = JT.make_optimizer(1e-3, warmup_steps=1, decay_steps=100)
    state = JT.create_state(model, opt, mesh, JL.partition_patterns(cfg),
                            (jnp.zeros((BATCH, 8), jnp.int32),))
    return jax.device_get(state.params)


def jax_specs(shardings, n_layers):
    """name (the port's) -> JAX's PartitionSpec tuple, the stacked
    layers dim first."""
    specs = {}
    for path, s in jax.tree_util.tree_flatten_with_path(shardings)[0]:
        keys = [p.key for p in path]
        if keys[0] == "layers":
            for i in range(n_layers):
                specs[f"layers.{i}." + ".".join(keys[1:])] = tuple(s.spec)
        else:
            specs[".".join(keys)] = tuple(s.spec)
    return specs


def jax_run(axes, preset, cf, data, init, step_kw=None, evaluate=False):
    """JAX's step for the mesh ``axes`` over ``data`` at f32 from
    ``init``: (each step's metrics, the params after them, the params'
    specs by the port's names, and with ``evaluate`` the eval loss and
    the forward's (logits, aux) of ``data[0]`` after the steps)."""
    mesh = jax_mesh(axes)
    model, cfg = JL.make_model(preset, mesh=mesh, dtype=jnp.float32,
                               moe_capacity_factor=cf)
    opt = JT.make_optimizer(1e-3, warmup_steps=1, decay_steps=100)
    pats = JL.partition_patterns(cfg)
    ex = (jnp.zeros((BATCH, 8), jnp.int32),)
    shardings, _ = JT.state_shardings(model, opt, mesh, pats, ex)
    state = JT.create_state(model, opt, mesh, pats, ex)
    for got, want in zip(jax.tree.leaves(jax.device_get(state.params)),
                         jax.tree.leaves(init)):
        assert np.array_equal(got, want)
    if step_kw is None:
        step = JT.make_train_step(model, opt, mesh, shardings)
    else:
        step = JT.make_step_for_mesh(model, cfg, opt, mesh, shardings,
                                     **step_kw)
    metrics = []
    for b in data:
        state, m = step(state, {"tokens": jnp.asarray(b)})
        metrics.append({k: float(v) for k, v in m.items()})
    out = {"metrics": metrics, "final": jax.device_get(state.params),
           "specs": jax_specs(shardings.params, cfg.n_layers)}
    if evaluate:
        tokens = jnp.asarray(data[0])
        out["eval"] = float(JT.make_eval_step(model, mesh)(
            state.params, {"tokens": tokens})["loss"])
        logits, aux = model.apply({"params": state.params}, tokens[:, :-1])
        out["logits"], out["aux"] = np.asarray(logits), float(aux)
    return out


def check_metrics(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in ("loss", "aux_loss", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, err_msg=k)
        assert g["tokens"] == w["tokens"]


def check_params(saved, want):
    want = params_from_jax(want)
    assert set(saved) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(saved[k].numpy(), v.numpy(), rtol=0,
                                   atol=ATOL_PARAMS, err_msg=k)


def check_case(res, name, want, axes, ckpt, cf):
    """One run of a world against JAX's: the trajectory, the saved
    parameters, bit-equal metrics on every rank, JAX's specs (a layer's
    leading entry is its stacked dim: None, or pp), drops at cf 0.5."""
    runs = [r["runs"][name] for r in res]
    assert len({json.dumps(r["fit"], sort_keys=True) for r in runs}) == 1
    check_metrics(runs[0]["fit"], want["metrics"])
    saved = torch.load(ckpt / str(STEPS) / TC.PARAMS_FILE,
                       weights_only=True)
    check_params(saved, want["final"])
    pp = axes.get("pp", 1) > 1
    for r in runs:
        assert r["specs"] == r["planned"]
        for k, spec in r["specs"].items():
            spec = tuple(tuple(e) if isinstance(e, list) else e
                         for e in spec)
            jspec = want["specs"][k]
            if TL.layer_index(k) is not None and not pp:
                jspec = jspec[1:]
            assert spec == jspec, (k, spec, jspec)
        if axes.get("ep", 1) > 1 or axes.get("tp", 1) > 1:
            assert r["reduce_bytes"] > 0
    if cf < 1:
        for r in runs:
            assert all(d > 0 for d in r["dropped"]), r["dropped"]
    return runs


CASES = [
    ("ep4_dp2", {"ep": 4, "dp": 2}, "tiny-moe"),
    ("ep2_dp4", {"ep": 2, "dp": 4}, "tiny-moe"),
    ("ep2_dp4_top2", {"ep": 2, "dp": 4}, "tiny-moe2"),
    ("ep2_fsdp2_tp2", {"ep": 2, "fsdp": 2, "tp": 2}, "tiny-moe"),
]


def case_name(name, cf):
    return f"{name}@{cf}"


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 8-rank job: every case of CASES at both capacity factors,
    started first; JAX's runs are computed while it trains."""
    tmp = tmp_path_factory.mktemp("moe_ep")
    data = batches()
    init = jax_init()
    torch.save(params_from_jax(init), tmp / "init.pt")
    np.savez(tmp / "batches.npz", **{f"b{i}": b for i, b in enumerate(data)})
    runs = [{"name": case_name(n, cf), "axes": axes, "preset": preset,
             "cf": cf, "step": {}, "steps": STEPS,
             "eval": n == "ep2_dp4" and cf == CFS[0],
             "ckpt": str(tmp / f"ckpt-{n}-{cf}")}
            for n, axes, preset in CASES for cf in CFS]
    started = start_world(tmp, "moe-ep", 1, 8, MeshSpec(ep=2, dp=4),
                          {"init": str(tmp / "init.pt"),
                           "batches": str(tmp / "batches.npz"),
                           "runs": runs, "writers": []})
    try:
        want = {r["name"]: jax_run(r["axes"], r["preset"], r["cf"], data,
                                   init, evaluate=r["eval"])
                for r in runs}
    finally:
        res = finish_world(started)
    return {"res": res, "want": want, "tmp": tmp, "runs": runs}


@pytest.mark.parametrize("name,cf", [(n, cf) for n, _, _ in CASES
                                     for cf in CFS])
def test_ep_world_matches_jax(world, name, cf):
    axes = dict(next(a for n, a, _ in CASES if n == name))
    key = case_name(name, cf)
    check_case(world["res"], key, world["want"][key], axes,
               world["tmp"] / f"ckpt-{name}-{cf}", cf)


def test_eval_step_and_forward_match_jax(world):
    """make_eval_step(mesh) on ep2 x dp4: JAX's eval loss; the mesh
    forward's (logits, aux): JAX's model.apply on each rank's rows."""
    key = case_name("ep2_dp4", CFS[0])
    want = world["want"][key]
    res = world["res"]
    rows = BATCH // 4
    for r in res:
        run = r["runs"][key]
        np.testing.assert_allclose(run["eval"], want["eval"], rtol=RTOL)
        np.testing.assert_allclose(run["aux"], want["aux"], rtol=RTOL)
        dp = run["coords"]["dp"]
        logits = np.load(world["tmp"] / "moe-ep-out" / f"logits{r['rank']}"
                                                       ".npy")
        np.testing.assert_allclose(
            logits, want["logits"][dp * rows:(dp + 1) * rows],
            rtol=RTOL, atol=1e-5)
    assert not any(r["jax_imported"] for r in res)


def test_moe_with_cp_is_refused_naming_its_item(world):
    for r in world["res"]:
        got = r["refused"]["moe_cp"]
        assert got is not None and got.startswith(
            "NotImplementedError: MoE models with cp=2"), got
        assert "Queue A item 8.6" in got


# ---------------------------------------------------------------------------
# the checkpoint of an ep2 x dp2 step
# ---------------------------------------------------------------------------

CKPT_STEPS, CKPT_MORE = 3, 2


@pytest.fixture(scope="module")
def ckpt_world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep_ckpt")
    data = batches(CKPT_STEPS + CKPT_MORE)
    init = jax_init()
    torch.save(params_from_jax(init), tmp / "init.pt")
    np.savez(tmp / "batches.npz", **{f"b{i}": b for i, b in enumerate(data)})
    run = {"name": "ckpt", "axes": {"ep": 2, "dp": 2}, "preset": "tiny-moe",
           "cf": 0.5, "step": {}, "steps": CKPT_STEPS, "fit": True,
           "ckpt": str(tmp / "ckpt")}
    # the ranks at dp 0 write moment shards: ranks 0 and 1 (ep 0 and 1)
    res = finish_world(start_world(
        tmp, "moe-ckpt", 2, 2, MeshSpec(ep=2, dp=2),
        {"init": str(tmp / "init.pt"), "batches": str(tmp / "batches.npz"),
         "runs": [run], "writers": [0, 1]}))
    return {"res": res, "tmp": tmp, "data": data, "init": init}


def _one_card(init_sd, cf=0.5):
    model, cfg = TL.make_model("tiny-moe", device="cpu",
                               dtype=torch.float32, moe_capacity_factor=cf)
    model.load_state_dict(init_sd)
    opt = TT.make_optimizer(1e-3, warmup_steps=1, decay_steps=100)
    return TT.create_state(model, opt), TT.make_train_step(opt), cfg


def _steps(state, step, data):
    got = []
    for b in data:
        state, m = step(state, {"tokens": torch.as_tensor(b.copy())})
        got.append({k: float(v) for k, v in m.items()})
    return state, got


class TestCheckpoint:
    def test_restore_on_the_mesh_continues_bit_for_bit(self, ckpt_world):
        runs = [r["runs"]["ckpt"] for r in ckpt_world["res"]]
        assert len({json.dumps([r["fit"], r["cont"], r["cont_again"]])
                    for r in runs}) == 1
        for r in runs:
            assert r["restored_step"] == CKPT_STEPS
            assert r["cont"] == r["cont_again"]
        # the experts' moments from both ep ranks, the rest once
        assert runs[0]["files"] == sorted(
            [TC.MARKER, TC.OPT_FILE, TC.PARAMS_FILE, "opt-0.pt",
             "opt-1.pt"])
        ep0, ep1 = runs[0]["shard_names"], runs[1]["shard_names"]
        model, _ = TL.make_model("tiny-moe", device="cpu")
        assert ep0 == sorted(n for n, _ in model.named_parameters())
        assert ep1 == sorted(f"layers.{i}.moe.{w}" for i in range(2)
                             for w in ("w1", "w2"))

    def test_restores_on_one_card_within_the_bound(self, ckpt_world):
        runs = ckpt_world["res"][0]["runs"]["ckpt"]
        state, step, _ = _one_card(params_from_jax(ckpt_world["init"]))
        state = TC.CheckpointManager(str(ckpt_world["tmp"] / "ckpt")) \
            .restore(state, step=CKPT_STEPS)
        assert state.step == CKPT_STEPS
        _, got = _steps(state, step, ckpt_world["data"][CKPT_STEPS:])
        check_metrics(got, runs["cont"])
        # and the mesh's first steps are the one-card run's
        fresh, fstep, _ = _one_card(params_from_jax(ckpt_world["init"]))
        _, first = _steps(fresh, fstep, ckpt_world["data"][:CKPT_STEPS])
        check_metrics(runs["fit"], first)

    def test_served_tokens_equal_the_one_card_run(self, ckpt_world):
        state, step, cfg = _one_card(params_from_jax(ckpt_world["init"]))
        state, _ = _steps(state, step, ckpt_world["data"][:CKPT_STEPS])
        served, scfg, resumed = load_serving_params(
            str(ckpt_world["tmp"] / "ckpt"), cfg, device="cpu")
        assert resumed
        saved = torch.load(ckpt_world["tmp"] / "ckpt" / str(CKPT_STEPS)
                           / TC.PARAMS_FILE, weights_only=True)
        for n, p in served.state_dict().items():
            assert torch.equal(p, saved[n]), n
        prompt = torch.as_tensor(ckpt_world["data"][0][:2, :6].copy())
        with torch.no_grad():
            got = TD.generate(served, scfg, prompt, max_new_tokens=8)
            want = TD.generate(state.model, cfg, prompt, max_new_tokens=8)
        assert torch.equal(got, want)
