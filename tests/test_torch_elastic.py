"""The torch package's elastic resume (paddle_operator_tpu_torch/ft/
elastic.py) held against the JAX package's ft/elastic.py: the
continuity math of tests/test_ft_elastic.py (``:108``, ``:114``,
``:127``, ``:135``) through both, and the resume plan over the port's
``CheckpointManager`` with a real train state, its restore booked under
goodput's ``restore``.  Exact: integer arithmetic and one schedule.
"""

import itertools
import json
import os
import signal
import subprocess
import sys
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from paddle_operator_tpu.api import (ResourceSpec, TPUJob, TPUJobSpec,
                                     TPUSpec)
from paddle_operator_tpu.api.types import (HOSTPORT_ANNOTATION, Intranet,
                                           MeshSpec)
from paddle_operator_tpu.controller import builders as B
from paddle_operator_tpu.controller.fake_api import FakeAPI
from paddle_operator_tpu.controller.reconciler import TPUJobReconciler
from paddle_operator_tpu.ft import elastic as JE
from paddle_operator_tpu.models import llama as JL
from paddle_operator_tpu.parallel.mesh import make_mesh
from paddle_operator_tpu.train import trainer as JT
from paddle_operator_tpu.train.data import (deterministic_lm_batches as
                                            jax_lm_batches)
from paddle_operator_tpu_torch.convert import params_from_jax
from paddle_operator_tpu_torch.ft import elastic as TE
from paddle_operator_tpu_torch.ft.goodput import GoodputTracker
from paddle_operator_tpu_torch.launch import launcher as TLA
from paddle_operator_tpu_torch.models import llama as TL
from paddle_operator_tpu_torch.parallel import sharding as PS
from paddle_operator_tpu_torch.train import data as TD
from paddle_operator_tpu_torch.train import trainer as TT
from paddle_operator_tpu_torch.train.checkpoint import CheckpointManager
from tests.test_torch_sharded_train import REPO, _free_port, _pod_env


@pytest.mark.parametrize("tokens,batch", [(1000, 100), (1050, 100),
                                          (0, 7), (6 * 64, 32)])
def test_resume_step_floor_rereads_partial_batch(tokens, batch):
    assert TE.resume_step_for(tokens, batch) \
        == JE.resume_step_for(tokens, batch)
    assert TE.resume_step_for(1050, 100) == 10   # re-read, never skip
    with pytest.raises(ValueError):
        TE.resume_step_for(10, 0)


def test_scale_schedule_token_equivalent():
    base = TT.make_optimizer(1e-3, warmup_steps=10, decay_steps=100).schedule
    for ref, new, scale in ((512, 256, True), (512, 256, False),
                            (256, 512, True)):
        got = TE.scale_schedule(base, ref, new, scale_lr=scale)
        want = JE.scale_schedule(base, ref, new, scale_lr=scale)
        assert [got(c) for c in range(0, 200, 7)] \
            == [want(c) for c in range(0, 200, 7)]
    lin = lambda count: 0.1 * count                # noqa: E731
    assert TE.scale_schedule(lin, 512, 256)(10) == pytest.approx(0.25)
    assert TE.scale_schedule(lin, 512, 256, scale_lr=False)(10) \
        == pytest.approx(0.5)
    assert TE.scale_schedule(lin, 512, 512) is lin
    with pytest.raises(ValueError):
        TE.scale_schedule(lin, 0, 1)


def test_elastic_resume_fresh_when_no_checkpoint():
    state, resumed, plan = TE.elastic_resume(
        CheckpointManager(""), lambda: {"w": torch.zeros(2)},
        saved_global_batch=64, global_batch=32)
    assert not resumed and torch.equal(state["w"], torch.zeros(2))
    assert plan == {"step": 0, "tokens_consumed": 0, "data_start_step": 0}


def _state(seed=0):
    model, _ = TL.make_model("tiny", device="cpu", seed=seed,
                             dtype=torch.float32)
    opt = TT.make_optimizer(1e-3, warmup_steps=1, decay_steps=100,
                            moments="int8")
    return TT.create_state(model, opt), opt


def test_resume_plan_batch_change(tmp_path):
    """Global batch halved on resume: the iterator offset doubles so
    step x batch is kept, and the data continues where it stopped."""
    path = str(tmp_path / "ck")
    state, opt = _state()
    step = TT.make_train_step(opt)
    for b in itertools.islice(TD.deterministic_lm_batches(8, 17, 256), 6):
        state, _ = step(state, {"tokens": torch.as_tensor(b["tokens"])})
    ckpt = CheckpointManager(path, save_interval_steps=1)
    ckpt.save(6, state, force=True)
    ckpt.close()
    tracker = GoodputTracker()
    fresh, _ = _state(seed=1)
    got, resumed, plan = TE.elastic_resume(
        CheckpointManager(path), lambda: _state(seed=1)[0], fresh,
        saved_global_batch=64, global_batch=32, goodput=tracker)
    assert resumed and got is fresh and got.step == 6
    assert got.opt_state.count == 6
    assert plan == {"step": 6, "tokens_consumed": 6 * 64,
                    "data_start_step": 12}
    assert tracker.badput()["restore"] > 0
    for a, b in zip(got.model.parameters(), state.model.parameters()):
        assert torch.equal(a, b)
    # the same plan from the JAX package's function
    assert JE.resume_step_for(plan["tokens_consumed"], 32) \
        == plan["data_start_step"]


# ---------------------------------------------------------------------------
# elastic dp over the mesh: gloo gangs of spawned ranks
# ---------------------------------------------------------------------------

GB, SEQ, SEED, SPLIT, TOTAL = 8, 17, 7, 3, 6   # tests/ft_worker.py's
RTOL_E, ATOL_E = 2e-4, 2e-5                    # tests/test_ft_elastic.py's

ELASTIC_CHILD = r'''
import json, os, signal, sys, time
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
from paddle_operator_tpu_torch.ft.elastic import elastic_resume
from paddle_operator_tpu_torch.ft.goodput import GoodputTracker
from paddle_operator_tpu_torch.ft.preemption import (EXIT_PREEMPTED,
                                                     PreemptionWatcher)
from paddle_operator_tpu_torch.launch import launcher
from paddle_operator_tpu_torch.models import llama as TL
from paddle_operator_tpu_torch.parallel import mesh as PM
from paddle_operator_tpu_torch.parallel import sharding as PS
from paddle_operator_tpu_torch.train import checkpoint as TC
from paddle_operator_tpu_torch.train import data as TD
from paddle_operator_tpu_torch.train import trainer as TT

a = json.load(open(sys.argv[1]))
env = launcher.initialize(device="cpu")
job = launcher.job_mesh(env, device="cpu")
rank = dist.get_rank()
out = {"rank": rank, "mesh": env.mesh.to_dict(), "world": dist.get_world_size(),
       "runs": {}}
inits = {k: torch.load(v) for k, v in a["inits"].items()}


def fresh(run, mesh):
    model, _ = TL.make_model(run["preset"], device="cpu",
                             dtype=torch.float32)
    model.load_state_dict(inits[run["preset"]])
    opt = TT.make_optimizer(1e-3, warmup_steps=1, decay_steps=50)
    return TT.create_state(model, opt, mesh=mesh), opt


def rows(mesh, start):
    # this rank's rows of the global batches from step `start` on, placed
    # on the mesh by the prefetcher
    return TD.DevicePrefetcher(
        (TD.process_slice(b, mesh=mesh) for b in TD.deterministic_lm_batches(
            a["gb"], a["seq"], 256, seed=a["seed"], start_step=start)),
        mesh=mesh)


def write():
    out["jax_imported"] = any(m.split(".")[0] in ("jax",
                                                  "paddle_operator_tpu")
                              for m in sys.modules)
    with open(os.path.join(a["out"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


for run in a["runs"]:
    mesh = job if not run.get("axes") else PM.make_mesh(
        PM.MeshSpec(**run["axes"]), device="cpu")
    r = {}
    if run["kind"] == "train":
        # train SPLIT steps and save them, then on to TOTAL unbroken
        state, opt = fresh(run, mesh)
        step = TT.make_step_for_mesh(opt, mesh)
        ckpt = TC.CheckpointManager(run["ckpt"], save_interval_steps=a["split"])
        it = rows(mesh, 0)
        state, hist = TT.fit(state, step, it, steps=a["split"],
                             checkpoint=ckpt)
        ckpt.wait()
        losses = [m["loss"] for m in hist]
        for _ in range(a["total"] - a["split"]):
            state, m = step(state, next(it))
            losses.append(float(m["loss"]))
        r["losses"] = losses
    elif run["kind"] == "resume":
        # the gang of the smaller mesh: the newest step restored into a
        # state built against this mesh, then on to TOTAL
        def init_fn():
            return fresh(run, mesh)[0]

        tracker = GoodputTracker()
        state, resumed, plan = elastic_resume(
            TC.CheckpointManager(run["ckpt"]), init_fn,
            saved_global_batch=a["gb"], global_batch=a["gb"],
            goodput=tracker)
        step = TT.make_step_for_mesh(
            TT.make_optimizer(1e-3, warmup_steps=1, decay_steps=50), mesh)
        losses = []
        it = rows(mesh, plan["data_start_step"])
        for _ in range(a["total"] - plan["step"]):
            state, m = step(state, next(it))
            losses.append(float(m["loss"]))
        r.update(resumed=resumed, plan=plan, losses=losses,
                 restore_s=tracker.badput()["restore"],
                 expert_shape=[list(PS.to_local(l.moe.w1).shape)
                               for l in state.model.layers
                               if hasattr(l, "moe")])
    else:
        # the drain: SIGTERM to one rank's launcher shim mid-run; every
        # rank stops after the same step, which is committed
        watcher = PreemptionWatcher.install(signals=(signal.SIGTERM,))
        state, opt = fresh(run, mesh)
        step = TT.make_step_for_mesh(opt, mesh)
        ckpt = TC.CheckpointManager(run["ckpt"], save_interval_steps=100)

        def batches():
            for i, b in enumerate(rows(mesh, 0)):
                if i == a["drain_at"] and rank == a["drain_rank"]:
                    shim = open(f"/proc/{os.getppid()}/cmdline").read()
                    assert "paddle_operator_tpu_torch.launch.launcher" in shim
                    os.kill(os.getppid(), signal.SIGTERM)
                    deadline = time.time() + 30
                    while not watcher.draining and time.time() < deadline:
                        time.sleep(0.01)
                yield b

        state, hist = TT.fit(state, step, batches(), steps=a["total"],
                             checkpoint=ckpt, preemption=watcher)
        ckpt.wait()
        r.update(losses=[m["loss"] for m in hist], step=state.step,
                 reason=watcher.reason, steps=ckpt.all_steps())
        out["runs"][run["name"]] = r
        write()
        dist.destroy_process_group()
        sys.exit(EXIT_PREEMPTED if watcher.draining else 1)
    out["runs"][run["name"]] = r

write()
dist.destroy_process_group()
'''


def _elastic_job(name, port, limits=4):
    """A dp4 TPUJob of 4 one-worker slices, elastic down to one, with
    the operator's elastic clamp (``reconciler._clamp_elastic``) applied
    for a worker ``limits`` below 4: whole slices dropped."""
    tmpl = {"spec": {"containers": [{"name": "m", "image": "i"}]}}
    job = TPUJob(name=name, spec=TPUJobSpec(
        intranet=Intranet.HOST,
        worker=ResourceSpec(replicas=4, requests=1, limits=limits,
                            template=tmpl),
        tpu=TPUSpec(topology="1x1", slice_count=4, chips_per_worker=1),
        mesh=MeshSpec(dp=4)))
    job.annotations[HOSTPORT_ANNOTATION] = str(port)
    TPUJobReconciler(FakeAPI())._clamp_elastic(job)
    assert job.spec.worker.replicas == limits
    return job


def _gang(tmp, name, job, live, args, drain=False, timeout=300):
    """The gang of ``job``'s first ``live`` pods (the others' slices
    dropped): the ConfigMap JAX ``construct_configmap`` builds over the
    live pods, each pod through the port's launcher shim (supervising
    under TPUJOB_DRAIN=1 when ``drain``).  Returns (exit codes, results,
    the ConfigMap's data)."""
    pods = []
    for i in range(live):
        pod = B.construct_pod(job, "worker", i)
        pod["status"] = {"podIP": f"127.0.0.{i + 1}"}
        pods.append(pod)
    cm = B.construct_configmap(job, pods)
    out = tmp / f"{name}-out"
    out.mkdir()
    child = tmp / "elastic_child.py"
    child.write_text(ELASTIC_CHILD)
    argf = tmp / f"{name}.json"
    argf.write_text(json.dumps(dict(args, out=str(out))))
    envs = [_pod_env(cm, pod) for pod in pods]
    if drain:
        for env in envs:
            env["TPUJOB_DRAIN"] = "1"
    procs = [subprocess.Popen(
        [sys.executable, "-m", "paddle_operator_tpu_torch.launch.launcher",
         "--", sys.executable, str(child), str(argf)],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for env in envs]
    codes = []
    try:
        for i, p in enumerate(procs):
            _, err = p.communicate(timeout=timeout)
            codes.append(p.returncode)
            assert p.returncode in (0, 83), \
                f"rank {i} exited {p.returncode}:\n{err[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    res = [json.loads((out / f"rank{r}.json").read_text())
           for r in range(live)]
    return codes, res, cm["data"]


def _jax_dp4_baseline(init):
    """JAX's uninterrupted dp4 run (tests/ft_worker.py ``run_elastic``'s
    baseline, at f32 from ``init``): the TOTAL losses."""
    mesh = make_mesh(MeshSpec(dp=4), devices=jax.devices()[:4])
    model, cfg = JL.make_model("tiny", dtype=jnp.float32)
    opt = JT.make_optimizer(1e-3, warmup_steps=1, decay_steps=50)
    pats = JL.partition_patterns(cfg)
    ex = (jnp.zeros((GB, 8), jnp.int32),)
    sh, _ = JT.state_shardings(model, opt, mesh, pats, ex)
    state = JT.create_state(model, opt, mesh, pats, ex)
    if init is None:
        return jax.device_get(state.params)
    for got, want in zip(jax.tree.leaves(jax.device_get(state.params)),
                         jax.tree.leaves(init)):
        assert np.array_equal(got, want)
    step = JT.make_train_step(model, opt, mesh, sh)
    it = jax_lm_batches(GB, SEQ, cfg.vocab_size, seed=SEED)
    losses = []
    for _ in range(TOTAL):
        state, m = step(state, next(it))
        losses.append(float(m["loss"]))
    return losses


def _jax_moe_init():
    mesh = make_mesh(MeshSpec(), devices=jax.devices()[:1])
    model, cfg = JL.make_model("tiny-moe", dtype=jnp.float32)
    opt = JT.make_optimizer(1e-3, warmup_steps=1, decay_steps=50)
    state = JT.create_state(model, opt, mesh, JL.partition_patterns(cfg),
                            (jnp.zeros((GB, 8), jnp.int32),))
    return jax.device_get(state.params)


class _SavedStep:
    """What JAX ``resume_or_init`` reads of a CheckpointManager, for a
    committed step ``step``: the plan is computed by JAX's own
    ``elastic_resume``."""

    enabled = True

    def __init__(self, step):
        self.step = step

    def latest_step(self):
        return self.step

    def all_steps(self):
        return [self.step]

    def restore(self, like, step):
        return types.SimpleNamespace(step=step)


@pytest.fixture(scope="module")
def gangs(tmp_path_factory):
    """The dp4 gang (4 slices of one worker) trains and saves the dense
    model on dp4, on fsdp2 x dp2 and the MoE model on ep2 x dp2, then
    drains on SIGTERM; the dp2 gang (two slices dropped: the ConfigMap's
    TPUJOB_MESH has dp 2) resumes each; JAX's dp4 run beside them."""
    tmp = tmp_path_factory.mktemp("elastic")
    init = _jax_dp4_baseline(None)
    inits = {"tiny": tmp / "tiny.pt", "tiny-moe": tmp / "moe.pt"}
    torch.save(params_from_jax(init), inits["tiny"])
    torch.save(params_from_jax(_jax_moe_init()), inits["tiny-moe"])
    base = {"inits": {k: str(v) for k, v in inits.items()}, "gb": GB,
            "seq": SEQ, "seed": SEED, "split": SPLIT, "total": TOTAL,
            "drain_at": 1, "drain_rank": 1}
    ck = {k: str(tmp / f"ckpt-{k}") for k in ("dp4", "fsdp", "moe", "drain")}
    job = _elastic_job("elastic", _free_port())
    train = [{"name": "dp4", "kind": "train", "preset": "tiny",
              "ckpt": ck["dp4"]},
             {"name": "fsdp", "kind": "train", "preset": "tiny",
              "axes": {"dp": 2, "fsdp": 2}, "ckpt": ck["fsdp"]},
             {"name": "moe", "kind": "train", "preset": "tiny-moe",
              "axes": {"ep": 2, "dp": 2}, "ckpt": ck["moe"]},
             {"name": "drain", "kind": "drain", "preset": "tiny",
              "ckpt": ck["drain"]}]
    codes4, res4, cm4 = _gang(tmp, "dp4", job, 4, dict(base, runs=train),
                              drain=True)
    resume = [{"name": k, "kind": "resume", "preset":
               "tiny-moe" if k == "moe" else "tiny", "ckpt": ck[k]}
              for k in ("dp4", "drain", "fsdp", "moe")]
    job = _elastic_job("elastic", _free_port(), limits=2)
    codes2, res2, cm2 = _gang(tmp, "dp2", job, 2, dict(base, runs=resume))
    jax_losses = _jax_dp4_baseline(init)
    return {"codes4": codes4, "res4": res4, "cm4": cm4, "codes2": codes2,
            "res2": res2, "cm2": cm2, "jax": jax_losses, "ckpt": ck,
            "inits": inits}


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL_E, atol=ATOL_E)


class TestElasticDpOverTheMesh:
    def test_the_clamp_gives_the_smaller_gang_dp2(self, gangs):
        assert json.loads(gangs["cm4"]["TPUJOB_MESH"]) == {"dp": 4}
        assert json.loads(gangs["cm2"]["TPUJOB_MESH"]) == {"dp": 2}
        assert gangs["cm2"]["TPUJOB_NUM_WORKERS"] == "2"
        for r in gangs["res2"]:
            assert r["mesh"] == {"dp": 2} and r["world"] == 2

    def test_dp4_to_dp2_equals_the_unbroken_runs(self, gangs):
        unbroken = gangs["res4"][0]["runs"]["dp4"]["losses"]
        _close(unbroken, gangs["jax"])
        want_plan = JE.elastic_resume(_SavedStep(SPLIT), lambda: None,
                                      saved_global_batch=GB,
                                      global_batch=GB)[2]
        for r in gangs["res2"]:
            run = r["runs"]["dp4"]
            assert run["resumed"] and run["plan"] == want_plan
            assert run["restore_s"] > 0
            got = unbroken[:SPLIT] + run["losses"]
            _close(got, unbroken)
            _close(got, gangs["jax"])
        assert len({json.dumps(r["runs"]["dp4"]["losses"])
                    for r in gangs["res2"]}) == 1

    def test_dp4_to_dp1_on_one_process(self, gangs):
        """The same resume on the one worker left (three slices
        dropped: TPUJOB_MESH dp 1), a world of one."""
        job = _elastic_job("elastic", 8700, limits=1)
        pod = B.construct_pod(job, "worker", 0)
        pod["status"] = {"podIP": "127.0.0.1"}
        cm = B.construct_configmap(job, [pod])
        assert json.loads(cm["data"]["TPUJOB_MESH"]) == {"dp": 1}
        assert not dist.is_initialized()
        try:
            mesh = TLA.job_mesh(TLA.JobEnv.from_env(cm["data"]),
                                device="cpu")

            def init_fn():
                model, _ = TL.make_model("tiny", device="cpu",
                                         dtype=torch.float32)
                model.load_state_dict(torch.load(gangs["inits"]["tiny"]))
                opt = TT.make_optimizer(1e-3, warmup_steps=1,
                                        decay_steps=50)
                return TT.create_state(model, opt, mesh=mesh)

            state, resumed, plan = TE.elastic_resume(
                CheckpointManager(gangs["ckpt"]["dp4"]), init_fn,
                saved_global_batch=GB, global_batch=GB)
            assert resumed and plan["data_start_step"] == SPLIT
            step = TT.make_step_for_mesh(
                TT.make_optimizer(1e-3, warmup_steps=1, decay_steps=50),
                mesh)
            it = TD.deterministic_lm_batches(GB, SEQ, 256, seed=SEED,
                                             start_step=SPLIT)
            losses = []
            for _ in range(TOTAL - SPLIT):
                b = PS.local_batch(TD.process_slice(next(it), mesh=mesh),
                                   mesh, "cpu")
                state, m = step(state, b)
                losses.append(float(m["loss"]))
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
        unbroken = gangs["res4"][0]["runs"]["dp4"]["losses"]
        _close(unbroken[:SPLIT] + losses, unbroken)
        _close(unbroken[:SPLIT] + losses, gangs["jax"])

    def test_drain_then_resume_at_dp2(self, gangs):
        """SIGTERM to one rank's shim: every rank stops after the same
        step, the drained step is committed, each shim exits 83; the dp2
        gang resumes there and lands on the unbroken trajectory."""
        assert gangs["codes4"] == [83] * 4
        drains = [r["runs"]["drain"] for r in gangs["res4"]]
        d = drains[0]
        assert all(x["step"] == d["step"] and x["steps"] == [d["step"]]
                   for x in drains)
        assert 1 <= d["step"] < TOTAL
        assert drains[1]["reason"].startswith("signal")
        assert {x["reason"] for i, x in enumerate(drains) if i != 1} \
            == {"a peer rank is draining"}
        unbroken = gangs["res4"][0]["runs"]["dp4"]["losses"]
        for r in gangs["res2"]:
            run = r["runs"]["drain"]
            assert run["plan"]["step"] == d["step"]
            _close(d["losses"] + run["losses"], unbroken)

    def test_fsdp2_dp2_to_dp2_recuts_the_moments(self, gangs):
        unbroken = gangs["res4"][0]["runs"]["fsdp"]["losses"]
        _close(unbroken, gangs["res4"][0]["runs"]["dp4"]["losses"])
        for r in gangs["res2"]:
            run = r["runs"]["fsdp"]
            assert run["resumed"] and run["plan"]["step"] == SPLIT
            _close(unbroken[:SPLIT] + run["losses"], unbroken)

    def test_moe_ep2_dp2_to_dp2_reassembles_the_experts(self, gangs):
        unbroken = gangs["res4"][0]["runs"]["moe"]["losses"]
        for r in gangs["res2"]:
            run = r["runs"]["moe"]
            assert run["resumed"] and run["plan"]["step"] == SPLIT
            # every expert on every rank of the dp2 mesh
            assert run["expert_shape"] == [[4, 64, 128]] * 2
            _close(unbroken[:SPLIT] + run["losses"], unbroken)
        assert not any(r["jax_imported"] for r in gangs["res4"]
                       + gangs["res2"])
