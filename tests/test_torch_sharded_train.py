"""The torch package's sharded LLaMA training (parallel/, the mesh train
step of train/trainer.py, train/data.py ``DevicePrefetcher(mesh=...)``,
launch/launcher.py ``job_mesh``, the sharded checkpoint of
train/checkpoint.py) held against the JAX package's, in worlds of
spawned gloo ranks on the CPU.

Each world is a TPUJob's pods as tests/test_rendezvous_multiproc.py
``_run_sharded_train`` makes them: the env the JAX package's
``controller/builders.py`` builds (``construct_pod``,
``construct_configmap``), every rank started through the port's launcher
shim (``python -m paddle_operator_tpu_torch.launch.launcher -- python
<child>``), the child calling ``initialize(device="cpu")`` ->
``job_mesh`` -> ``state_shardings`` / ``create_state`` ->
``make_step_for_mesh`` -> ``fit``.  Three worlds, many checks each:

- dp2 x fsdp2 x tp2 (8 ranks, one slice of 8 workers): the tiny preset
  at f32 from the JAX init, three steps through ``fit`` on the batches
  of JAX ``TestShardedTraining.run_steps`` (tests/test_llama_train.py),
  placed by ``DevicePrefetcher(mesh=...)`` from ``process_slice(...,
  mesh=...)``: losses and grad norms (rtol 1e-5) and the parameters
  after them (atol 1e-5, read from the step-3 checkpoint's whole
  ``params.pt``) equal JAX's ``make_train_step`` on the same mesh over
  8 virtual devices, and the port's single-device run within the same
  bounds; every rank's metrics and parameter fingerprint are
  bit-equal; each parameter's placements are JAX's ``state_shardings``
  specs; ``job_mesh`` has JAX ``job_mesh``'s axes and shape.  Then the
  checkpoint: two more steps, a restore of step 3 on the mesh, the same
  two steps bit for bit; the step-3 checkpoint restored on one CPU
  "card" continues within the bound, and ``load_serving_params`` reads
  the newest step; a drain signalled on one rank stops every rank after
  the same step and commits it; a writer failing on one rank leaves no
  step.  Only rank 0 logs and ticks the timer.  The refusals that need
  a live mesh: MoE with cp above 1, n_layers indivisible by pp, an
  unknown pipeline schedule or cp_impl (an ep mesh, MoE on a pp mesh,
  int8 moments and moment offload on the mesh are accepted; the int8
  and offload worlds are tests/test_torch_int8_mesh.py's).
- fsdp2 (2 ranks, one slice): the same trajectory against JAX on that
  mesh, and the rendezvous test's per-rank data through
  ``DevicePrefetcher(mesh=...)`` against the JAX single-process
  reference (losses rtol 1e-5, parameters atol 1e-5).
- dp2 x fsdp2 (4 ranks, two slices of 2): the per-rank data against the
  JAX single-process reference.

Tolerances are tests/test_torch_train.py's (f32 on both sides; the sums
run in other orders).
"""

import json
import os
import socket
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
from paddle_operator_tpu.launch import launcher as JLA
from paddle_operator_tpu.models import llama as JL
from paddle_operator_tpu.parallel import mesh as JM
from paddle_operator_tpu.train import trainer as JT
from paddle_operator_tpu_torch.convert import params_from_jax
from paddle_operator_tpu_torch.infer.serve import load_serving_params
from paddle_operator_tpu_torch.models import llama as TL
from paddle_operator_tpu_torch.train import checkpoint as TC
from paddle_operator_tpu_torch.train import trainer as TT
from tests.test_torch_mesh import jax_param_specs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL = 1e-5
ATOL_PARAMS = 1e-5
B_TRAJ, S_TRAJ = 8, 33          # run_steps' batch of 33 tokens
B_LOC, SEQ = 2, 16              # the rendezvous test's rows a rank
FIT_STEPS, MORE = 3, 2          # fit, then two steps on and again
DRAIN_STEPS = 3                 # the drained fit's batches (it takes 2)

CHILD = r'''
import json, logging, os, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
from paddle_operator_tpu_torch.ft.preemption import PreemptionWatcher
from paddle_operator_tpu_torch.launch import launcher
from paddle_operator_tpu_torch.models import llama as TL
from paddle_operator_tpu_torch.parallel import mesh as PM
from paddle_operator_tpu_torch.parallel import sharding as PS
from paddle_operator_tpu_torch.parallel.collectives import full_tensor
from paddle_operator_tpu_torch.train import checkpoint as TC
from paddle_operator_tpu_torch.train import data as TD
from paddle_operator_tpu_torch.train import trainer as TT
from paddle_operator_tpu_torch.utils.observability import StepTimer

a = json.load(open(sys.argv[1]))
env = launcher.initialize(device="cpu")
mesh = launcher.job_mesh(env, device="cpu")
rank, world = dist.get_rank(), dist.get_world_size()
out = {"rank": rank, "names": list(mesh.mesh_dim_names),
       "shape": list(mesh.mesh.shape), "coords": PM.coordinates(mesh)}


def fingerprint(model):
    """sum |p| over the global parameters, each element once."""
    total = torch.zeros((), dtype=torch.float64)
    for p in model.parameters():
        total += (PS.to_local(p).detach().double().abs().sum()
                  / TT._replicas(PS.placement_by_axis(p), mesh))
    dist.all_reduce(total)
    return float(total)


def fresh(init):
    model, _ = TL.make_model("tiny", device="cpu", dtype=torch.float32)
    model.load_state_dict(torch.load(init))
    return model, TT.make_optimizer(1e-3, warmup_steps=1, decay_steps=100)


def floats(hist):
    return [{k: float(v) for k, v in m.items()} for m in hist]


def whole(model, path):
    full = {n: full_tensor(p) for n, p in model.named_parameters()}
    if rank == 0:
        torch.save(full, path)


if "trajectory" in a:
    t = a["trajectory"]
    glob = np.load(t["batches"])
    model, opt = fresh(t["init"])
    sh = TT.state_shardings(model, opt, mesh)
    state = TT.create_state(model, opt, mesh=mesh)
    out["specs"] = {n: PS.spec_of(p.placements, mesh, p.ndim)
                    for n, p in state.model.named_parameters()}
    out["planned"] = {n: PS.spec_of(pl, mesh, len(out["specs"][n]))
                      for n, pl in sh.params.items()}
    out["moment_plan_is_params"] = all(
        sh.opt_state[f] == sh.params for f in ("mu", "nu"))
    out["moment_shapes_ok"] = all(
        tuple(state.opt_state.mu[n].shape) == tuple(PS.to_local(p).shape)
        for n, p in state.model.named_parameters())
    batches = [{"tokens": glob[f"b{i}"]} for i in range(len(glob.files))]
    # this rank's rows: its (dp, fsdp) block, the same for tp siblings
    rows = [TD.process_slice(b, mesh=mesh) for b in batches]
    out["row_sums"] = [int(r["tokens"].sum()) for r in rows]
    step = TT.make_step_for_mesh(opt, mesh)
    records = []
    log = logging.getLogger(f"sharded.{rank}")
    log.setLevel(logging.INFO)
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    log.addHandler(handler)
    timer = StepTimer(1, flops_per_token=1.0, peak_flops=1.0)
    ckpt = TC.CheckpointManager(t.get("ckpt"), save_interval_steps=3)
    n_fit = t["fit_steps"]
    state, hist = TT.fit(
        state, step, TD.DevicePrefetcher(iter(rows[:n_fit]), mesh=mesh),
        steps=n_fit, checkpoint=ckpt, logger=log, log_every=1, timer=timer)
    ckpt.wait()
    out["fit"] = floats(hist)
    out["logs"] = list(records)
    out["timer_ticks"] = len(timer.times)
    out["fp_fit"] = fingerprint(state.model)
    if not ckpt.enabled:
        whole(state.model, t["final"])
    else:
        out["steps_after_fit"] = ckpt.all_steps()
        shard = [PS.local_batch(r, mesh, "cpu") for r in rows]
        more = slice(n_fit, n_fit + t["more"])

        def run(state):
            got = []
            for b in shard[more]:
                state, m = step(state, b)
                got.append(floats([m])[0])
            return state, got

        state, out["cont"] = run(state)
        out["fp_cont"] = fingerprint(state.model)
        state = ckpt.restore(state, step=n_fit)
        out["restored_step"] = state.step
        state, out["cont_again"] = run(state)
        out["fp_cont_again"] = fingerprint(state.model)
        out["eval"] = float(TT.make_eval_step(mesh)(state.model,
                                                    shard[0])["loss"])
        watcher = PreemptionWatcher()

        def drained_batches():
            for i, b in enumerate(shard[n_fit + t["more"]:]):
                if i == 1 and rank == t["drain_rank"]:
                    watcher.trigger("injected")
                yield b

        state, hist = TT.fit(state, step, drained_batches(),
                             steps=len(shard), checkpoint=ckpt,
                             preemption=watcher)
        out["drain"] = {"steps": len(hist), "step": state.step,
                        "draining": watcher.draining,
                        "reason": watcher.reason,
                        "all_steps": ckpt.all_steps()}
        out["fp_drained"] = fingerprint(state.model)
        if rank == t["kill_rank"]:
            real = TC._write_file

            def broken(path, obj):
                if os.path.basename(path).startswith("opt-"):
                    raise OSError("injected: the disk is gone")
                return real(path, obj)

            TC._write_file = broken
        ckpt.save(99, state, force=True)
        try:
            ckpt.wait()
            out["kill"] = None
        except Exception as err:
            out["kill"] = f"{type(err).__name__}: {err}"
        out["after_kill_steps"] = ckpt.all_steps()
        refused = {}
        meshes = {k: PM.make_mesh(PM.MeshSpec(**axes), device="cpu")
                  for k, axes in (("ep", {"ep": 2, "fsdp": 4}),
                                  ("pp", {"pp": 2, "fsdp": 4}),
                                  ("cp", {"cp": 2, "fsdp": 4}),
                                  ("pp4", {"pp": 4, "fsdp": 2}))}
        cases = {
            "ep": lambda: TT.make_step_for_mesh(opt, meshes["ep"]),
            "moe_pp": lambda: TT.create_state(
                TL.make_model("tiny-moe", device="cpu")[0],
                TT.make_optimizer(), mesh=meshes["pp"]),
            "moe_cp": lambda: TT.create_state(
                TL.make_model("tiny-moe", device="cpu")[0],
                TT.make_optimizer(), mesh=meshes["cp"]),
            "layers_pp": lambda: TT.create_state(
                TL.make_model("tiny", device="cpu")[0],
                TT.make_optimizer(), mesh=meshes["pp4"]),
            "schedule": lambda: TT.make_step_for_mesh(
                opt, meshes["pp"], schedule="interleaved"),
            "cp_impl": lambda: TT.create_state(
                TL.make_model("tiny", device="cpu", cp_impl="spiral")[0],
                TT.make_optimizer(), mesh=meshes["cp"]),
            "int8": lambda: TT.create_state(
                TL.make_model("tiny", device="cpu")[0],
                TT.make_optimizer(moments="int8"), mesh=mesh),
            "offload": lambda: TT.create_state(
                TL.make_model("tiny", device="cpu")[0],
                TT.make_optimizer(), mesh=mesh, offload_opt_state=True),
        }
        made = {}
        for what, fn in cases.items():
            try:
                made[what] = fn()
                refused[what] = None
            except (NotImplementedError, ValueError) as err:
                refused[what] = f"{type(err).__name__}: {err}"
        out["refused"] = refused

        def local_shape(o, field, name, p):
            """The shape of this rank's region of a moment."""
            if getattr(o, "layout", None) is None:
                return tuple(PS.to_local(p).shape)
            return tuple(s.stop - s.start
                         for s in o.layout[name].field(field)[2])

        # the accepted int8 and offloaded states: each moment tensor the
        # rank's region of its global tensor, an offloaded one in host
        # memory
        for what in ("int8", "offload"):
            st = made.get(what)
            if st is None:
                continue
            o = st.opt_state
            named = dict(st.model.named_parameters())
            tensors = [(f, k, t) for f, ts in o.tensors().items()
                       for k, t in ts.items()]
            out[what] = {
                "kind": o.kind,
                "cases": sorted({l.case for l in
                                 (getattr(o, "layout", None) or {}).values()}),
                "local_shapes_ok": all(
                    tuple(t.shape) == local_shape(o, f, k, named[k])
                    for f, k, t in tensors),
                "on_host": all(t.device.type == "cpu" for _, _, t in tensors),
                "offloaded": o.offload is not None}

if "pod" in a:
    p = a["pod"]
    model, opt = fresh(p["init"])
    state = TT.create_state(model, opt, mesh=mesh)
    step = TT.make_step_for_mesh(opt, mesh)
    blk, n_blocks = PS.data_block(mesh)
    per = world // n_blocks
    mine = range(blk * per, (blk + 1) * per)

    def rank_block(r, i):
        rng = np.random.default_rng(9000 + 131 * r + i)
        return rng.integers(0, 256, (p["rows"], p["seq"] + 1),
                            dtype=np.int32)

    def batches():
        for i in range(p["steps"]):
            yield {"tokens": np.concatenate([rank_block(r, i)
                                             for r in mine])}

    state, hist = TT.fit(state, step,
                         TD.DevicePrefetcher(batches(), mesh=mesh),
                         steps=p["steps"])
    out["pod"] = floats(hist)
    out["pod_fp"] = fingerprint(state.model)
    whole(state.model, p["final"])

out["jax_imported"] = any(m.split(".")[0] in ("jax", "paddle_operator_tpu")
                          for m in sys.modules)
with open(os.path.join(a["out"], f"rank{rank}.json"), "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
'''


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _pod_env(cm, pod):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPU_", "TPUJOB_", "MEGASCALE_"))}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env.update(cm["data"])
    for e in pod["spec"]["containers"][0]["env"]:
        if "value" in e:
            env[e["name"]] = e["value"]
    return env


def _world(tmp, name, slices, workers, mesh, args, child_src=CHILD,
           timeout=240):
    """Run ``child_src`` (default CHILD) on every pod of a ``slices`` x
    ``workers`` job through the launcher shim; returns (the ranks'
    results in rank order, the first pod's env)."""
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
    envs = [_pod_env(cm, pod) for pod in pods]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "paddle_operator_tpu_torch.launch.launcher",
         "--", sys.executable, str(child), str(argf)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for env in envs]
    try:
        for i, p in enumerate(procs):
            _, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"rank {i} failed:\n{err[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    res = [json.loads((out / f"rank{r}.json").read_text())
           for r in range(len(pods))]
    return res, envs[0]


def _jax_mesh(axes):
    spec = MeshSpec(**axes)
    return JM.make_mesh(spec, devices=jax.devices()[:spec.size()])


def _run_steps_batches(n):
    """TestShardedTraining.run_steps' batches (synthetic_batch(8, 33,
    vocab, seed=i)) for i < n."""
    return [np.asarray(JT.synthetic_batch(B_TRAJ, S_TRAJ, 256,
                                          seed=i)["tokens"])
            for i in range(n)]


def _jax_run_steps(axes, batches):
    """TestShardedTraining.run_steps at f32 on the mesh ``axes``: the
    init params, each step's metrics and the params after them."""
    mesh = _jax_mesh(axes)
    model, cfg = JL.make_model("tiny", mesh=mesh, dtype=jnp.float32)
    opt = JT.make_optimizer(1e-3, warmup_steps=1, decay_steps=100)
    pats = JL.partition_patterns(cfg)
    ex = (jnp.zeros((B_TRAJ, 8), jnp.int32),)
    shardings, _ = JT.state_shardings(model, opt, mesh, pats, ex)
    state = JT.create_state(model, opt, mesh, pats, ex)
    init = jax.device_get(state.params)
    step = JT.make_train_step(model, opt, mesh, shardings)
    metrics = []
    for b in batches:
        state, m = step(state, {"tokens": jnp.asarray(b)})
        metrics.append({k: float(v) for k, v in m.items()})
    return init, metrics, jax.device_get(state.params)


def _rank_block(r, i):
    rng = np.random.default_rng(9000 + 131 * r + i)
    return rng.integers(0, 256, (B_LOC, SEQ + 1), dtype=np.int32)


def _jax_pod_reference(world, axes, steps=3):
    """tests/test_rendezvous_multiproc.py's single-process reference:
    the same global batches (every rank's block in rank order) on the
    same mesh in one process."""
    mesh = _jax_mesh(axes)
    model, cfg = JL.make_model("tiny", mesh=mesh, dtype=jnp.float32)
    opt = JT.make_optimizer(1e-3, warmup_steps=1, decay_steps=100)
    pats = JL.partition_patterns(cfg)
    ex = (jnp.zeros((world * B_LOC, 8), jnp.int32),)
    shardings, _ = JT.state_shardings(model, opt, mesh, pats, ex)
    state = JT.create_state(model, opt, mesh, pats, ex)
    init = jax.device_get(state.params)
    step = JT.make_train_step(model, opt, mesh, shardings)
    losses = []
    for i in range(steps):
        tokens = np.concatenate([_rank_block(r, i) for r in range(world)])
        state, m = step(state, {"tokens": jnp.asarray(tokens)})
        losses.append(float(m["loss"]))
    return init, losses, jax.device_get(state.params)


def _port_single(init_sd, batches):
    """The port's single-device run from the same init."""
    model, _ = TL.make_model("tiny", device="cpu", dtype=torch.float32)
    model.load_state_dict(init_sd)
    opt = TT.make_optimizer(1e-3, warmup_steps=1, decay_steps=100)
    state = TT.create_state(model, opt)
    step = TT.make_train_step(opt)
    metrics = []
    for b in batches:
        state, m = step(state, {"tokens": torch.as_tensor(b.copy())})
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


def _assert_metrics(got, want, keys=("loss", "grad_norm")):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in keys:
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, err_msg=k)


def _assert_params(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(v),
                                   rtol=0, atol=ATOL_PARAMS, err_msg=k)


def _same_on_every_rank(res, *keys):
    for k in keys:
        vals = [json.dumps(r[k], sort_keys=True) for r in res]
        assert len(set(vals)) == 1, (k, vals)


def _trajectory_args(tmp, name, axes, batches, ckpt=None):
    init, metrics, final = _jax_run_steps(axes, batches[:FIT_STEPS])
    init_sd = params_from_jax(init)
    torch.save(init_sd, tmp / f"{name}-init.pt")
    np.savez(tmp / f"{name}-batches.npz",
             **{f"b{i}": b for i, b in enumerate(batches)})
    args = {"init": str(tmp / f"{name}-init.pt"),
            "batches": str(tmp / f"{name}-batches.npz"),
            "fit_steps": FIT_STEPS, "more": MORE, "drain_rank": 5,
            "kill_rank": 3, "final": str(tmp / f"{name}-final.pt")}
    if ckpt is not None:
        args["ckpt"] = str(ckpt)
    return args, (init_sd, metrics, final)


def _check_trajectory(res, jax_run, final_params, batches, axes):
    init_sd, want, final = jax_run
    _same_on_every_rank(res, "fit", "fp_fit")
    got = res[0]["fit"]
    _assert_metrics(got, want)
    assert [g["tokens"] for g in got] == [w["tokens"] for w in want]
    _assert_params(final_params, params_from_jax(final))
    # against the port on one device, the same bounds
    single, smetrics = _port_single(init_sd, batches[:FIT_STEPS])
    _assert_metrics(got, smetrics)
    _assert_params(final_params, single.model.state_dict())
    # the layout: each parameter's placements are JAX's specs, and so
    # is the plan state_shardings made; moments take the params' plan
    want_specs, _ = jax_param_specs(axes)
    for r in res:
        specs = {n: tuple(tuple(e) if isinstance(e, list) else e
                          for e in s) for n, s in r["specs"].items()}
        assert specs == want_specs
        assert r["planned"] == r["specs"]
        assert r["moment_plan_is_params"] and r["moment_shapes_ok"]
    # tp siblings read the same rows, other data blocks other rows
    blocks = {}
    for r in res:
        key = (r["coords"]["dp"], r["coords"]["fsdp"])
        blocks.setdefault(key, set()).add(tuple(r["row_sums"]))
    assert all(len(v) == 1 for v in blocks.values())
    assert len({next(iter(v)) for v in blocks.values()}) == len(blocks)
    return single


@pytest.fixture(scope="module")
def world_a(tmp_path_factory):
    """dp2 x fsdp2 x tp2: 8 ranks, one slice of 8 workers."""
    tmp = tmp_path_factory.mktemp("dp2_fsdp2_tp2")
    axes = {"dp": 2, "fsdp": 2, "tp": 2}
    batches = _run_steps_batches(FIT_STEPS + MORE + DRAIN_STEPS)
    args, jax_run = _trajectory_args(tmp, "a", axes, batches,
                                     ckpt=tmp / "ckpt")
    res, env = _world(tmp, "mesh-a", 1, 8, MeshSpec(**axes),
                      {"trajectory": args})
    return {"res": res, "env": env, "jax": jax_run, "batches": batches,
            "ckpt": tmp / "ckpt", "axes": axes}


class TestDpFsdpTp:
    def test_trajectory_matches_jax_and_one_device(self, world_a):
        res, ckpt = world_a["res"], world_a["ckpt"]
        assert res[0]["steps_after_fit"] == [FIT_STEPS]
        saved = torch.load(ckpt / str(FIT_STEPS) / TC.PARAMS_FILE,
                           weights_only=True)
        _check_trajectory(res, world_a["jax"], saved, world_a["batches"],
                          world_a["axes"])
        assert not any(r["jax_imported"] for r in res)

    def test_job_mesh_equals_jax(self, world_a):
        want = JLA.job_mesh(JLA.JobEnv.from_env(world_a["env"]))
        for r in world_a["res"]:
            assert tuple(r["names"]) == tuple(want.axis_names)
            assert tuple(r["shape"]) == want.devices.shape
        # rank r sits at flat position r, as JAX's reshape puts device r
        flat = [r["coords"] for r in world_a["res"]]
        for rank, c in enumerate(flat):
            idx = tuple(c[a] for a in want.axis_names)
            assert int(np.arange(8).reshape(want.devices.shape)[idx]) == rank

    def test_restore_on_the_mesh_continues_bit_for_bit(self, world_a):
        res = world_a["res"]
        _same_on_every_rank(res, "cont", "fp_cont", "cont_again",
                            "fp_cont_again", "eval")
        for r in res:
            assert r["restored_step"] == FIT_STEPS
            assert r["cont"] == r["cont_again"]
            assert r["fp_cont"] == r["fp_cont_again"]

    def test_mesh_checkpoint_restores_on_one_card(self, world_a):
        """The step-3 checkpoint (moments in per-rank shard files)
        restored into a one-device state continues as the mesh did."""
        res, ckpt, batches = world_a["res"], world_a["ckpt"], \
            world_a["batches"]
        model, _ = TL.make_model("tiny", device="cpu", dtype=torch.float32)
        opt = TT.make_optimizer(1e-3, warmup_steps=1, decay_steps=100)
        mgr = TC.CheckpointManager(str(ckpt))
        state = mgr.restore(TT.create_state(model, opt), step=FIT_STEPS)
        assert state.step == FIT_STEPS and state.opt_state.count == FIT_STEPS
        step = TT.make_train_step(opt)
        got = []
        for b in batches[FIT_STEPS:FIT_STEPS + MORE]:
            state, m = step(state, {"tokens": torch.as_tensor(b.copy())})
            got.append({k: float(v) for k, v in m.items()})
        _assert_metrics(got, res[0]["cont"])
        want_eval = TT.make_eval_step()(state.model, {
            "tokens": torch.as_tensor(batches[0].copy())})
        np.testing.assert_allclose(float(want_eval["loss"]), res[0]["eval"],
                                   rtol=RTOL)
        # resume_or_init takes the newest step (the drained one)
        fresh, _ = TL.make_model("tiny", device="cpu", dtype=torch.float32)
        state, resumed = TC.resume_or_init(
            mgr, lambda: TT.create_state(fresh, opt))
        newest = res[0]["drain"]["step"]
        assert resumed and state.step == newest
        # and the server's loader reads its params.pt
        served, cfg, resumed = load_serving_params(
            str(ckpt), TL.CONFIGS["tiny"], device="cpu")
        assert resumed and cfg.param_dtype == cfg.dtype
        saved = torch.load(ckpt / str(newest) / TC.PARAMS_FILE,
                           weights_only=True)
        for n, p in served.state_dict().items():
            assert torch.equal(p, saved[n].to(cfg.dtype)), n

    def test_drain_on_one_rank_stops_every_rank_together(self, world_a):
        res = world_a["res"]
        _same_on_every_rank(res, "fp_drained")
        for r in res:
            r["drain_reason"] = r["drain"].pop("reason")
        _same_on_every_rank(res, "drain")
        d = res[0]["drain"]
        start = FIT_STEPS + MORE
        assert d["steps"] == 2 and d["step"] == start + 2
        assert d["draining"]
        assert res[5]["drain_reason"] == "injected"
        assert {r["drain_reason"] for i, r in enumerate(res) if i != 5} \
            == {"a peer rank is draining"}
        # the interval save of step 6 and the drain's forced save of 7
        assert d["all_steps"] == [FIT_STEPS, start + 1, start + 2]

    def test_failed_writer_on_one_rank_leaves_no_step(self, world_a):
        res, ckpt = world_a["res"], world_a["ckpt"]
        for r in res:
            assert r["kill"] is not None
            assert r["after_kill_steps"] == res[0]["drain"]["all_steps"]
        assert "injected" in res[3]["kill"]
        assert "not committed" in res[0]["kill"]
        assert not (ckpt / "99").exists()
        assert not [n for n in os.listdir(ckpt) if n.startswith(".99.")]

    def test_only_rank_zero_logs_and_times(self, world_a):
        res = world_a["res"]
        assert len(res[0]["logs"]) == FIT_STEPS
        assert res[0]["logs"][0].startswith("step=1 loss=")
        # N ticks make N - 1 intervals
        assert res[0]["timer_ticks"] == FIT_STEPS - 1
        assert all(not r["logs"] and r["timer_ticks"] == 0 for r in res[1:])

    def test_refusals_that_need_a_live_mesh(self, world_a):
        """What stays refused once cp, pp, ep, int8 moments and offload
        run: MoE with cp > 1 (Queue A item 8.6), n_layers indivisible by
        pp, an unknown pipeline schedule or cp_impl.  An ep mesh, MoE on
        a pp mesh, and int8 moments and moment offload on the mesh
        (item 8.3) are accepted: the int8 state holds each rank's region
        of the global blocks (at tiny's widths every cut last axis fits
        one block, which every rank of its axes then holds), the
        offloaded one its moments in host memory."""
        res0 = world_a["res"][0]
        refused = res0["refused"]
        assert refused["ep"] is None and refused["moe_pp"] is None
        assert refused["int8"] is None and refused["offload"] is None
        assert res0["int8"]["kind"] == "int8"
        assert res0["int8"]["cases"] == ["replicated"]
        assert res0["int8"]["local_shapes_ok"]
        assert not res0["int8"]["offloaded"]
        assert res0["offload"]["kind"] == "f32"
        assert res0["offload"]["offloaded"] and res0["offload"]["on_host"]
        assert res0["offload"]["local_shapes_ok"]
        for what, want in (
                ("moe_cp", "NotImplementedError: MoE models with cp=2"),
                ("layers_pp", "ValueError: n_layers=2 not divisible by "
                              "pp=4"),
                ("schedule", "ValueError: unknown pipeline schedule "
                             "'interleaved'"),
                ("cp_impl", "ValueError: unknown cp_impl 'spiral'")):
            assert refused[what] is not None \
                and refused[what].startswith(want), (what, refused[what])
        assert "Queue A item 8.6" in refused["moe_cp"]


@pytest.fixture(scope="module")
def world_b(tmp_path_factory):
    """fsdp2: 2 ranks, one slice — the run_steps trajectory and the
    rendezvous test's per-rank data."""
    tmp = tmp_path_factory.mktemp("fsdp2")
    axes = {"fsdp": 2}
    batches = _run_steps_batches(FIT_STEPS)
    traj, jax_run = _trajectory_args(tmp, "b", axes, batches)
    pod_init, pod_losses, pod_final = _jax_pod_reference(2, axes)
    torch.save(params_from_jax(pod_init), tmp / "pod-init.pt")
    pod = {"init": str(tmp / "pod-init.pt"), "rows": B_LOC, "seq": SEQ,
           "steps": 3, "final": str(tmp / "pod-final.pt")}
    res, _ = _world(tmp, "mesh-b", 1, 2, MeshSpec(**axes),
                    {"trajectory": traj, "pod": pod})
    return {"res": res, "jax": jax_run, "batches": batches, "axes": axes,
            "final": torch.load(traj["final"]),
            "pod": (pod_losses, pod_final, torch.load(pod["final"]))}


def _check_pod(res, pod):
    want_losses, want_final, got_final = pod
    _same_on_every_rank(res, "pod", "pod_fp")
    np.testing.assert_allclose([m["loss"] for m in res[0]["pod"]],
                               want_losses, rtol=RTOL)
    _assert_params(got_final, params_from_jax(want_final))


class TestFsdp:
    def test_trajectory_matches_jax_and_one_device(self, world_b):
        _check_trajectory(world_b["res"], world_b["jax"], world_b["final"],
                          world_b["batches"], world_b["axes"])

    def test_pod_contract_one_slice(self, world_b):
        _check_pod(world_b["res"], world_b["pod"])


def test_pod_contract_two_slices_dp_fsdp(tmp_path):
    """Two slices of 2 workers on dp2 x fsdp2: dp across the slices."""
    axes = {"dp": 2, "fsdp": 2}
    pod_init, pod_losses, pod_final = _jax_pod_reference(4, axes)
    torch.save(params_from_jax(pod_init), tmp_path / "pod-init.pt")
    pod = {"init": str(tmp_path / "pod-init.pt"), "rows": B_LOC,
           "seq": SEQ, "steps": 3, "final": str(tmp_path / "pod-final.pt")}
    res, env = _world(tmp_path, "mesh-c", 2, 2, MeshSpec(**axes),
                      {"pod": pod})
    assert env["TPUJOB_NUM_SLICES"] == "2"
    _check_pod(res, (pod_losses, pod_final, torch.load(pod["final"])))
