"""The torch package's pods of more than one card (ROADMAP.md Queue A
item 8.4: launch/launcher.py ``pod_cards``, ``process_rank``,
``run_pod``, ``initialize``, ``job_mesh``; parallel/mesh.py
``rank_grid``; train/data.py ``process_slice(..., mesh=...)``) held
against the JAX package's one process a pod, on the CPU over gloo.

- Training: a TPUJob of 2 workers with ``chipsPerWorker: 2`` (the pods'
  env from the JAX ``construct_pod`` / ``construct_configmap``), each pod
  started through the port's launcher shim, which starts one child a
  card: fsdp2 × tp2 (the ConfigMap's mesh) and dp2 × tp2, three steps
  of ``tiny`` at f32 on tests/test_llama_train.py's batches.  Each
  equals JAX's sharded step on 4 virtual devices (losses and grad norms
  rtol 1e-5, parameters atol 1e-5: tests/test_torch_sharded_train.py's
  bounds) and the same job on 4 one-card workers bit for bit.
- Layout: the contract of deploy/examples/llama_7b.yaml (16 workers ×
  4 cards, dp2 × fsdp8 × tp4): every (pod, card) pair's rank sits at
  the coordinates of JAX ``make_mesh`` over devices ordered by
  (process, local id), and a pod's cards' rows together are JAX's
  ``process_slice`` of that pod.  No training.
- Supervision: SIGTERM to a 2-card pod's shim drains both children and
  the pod exits 83, and the relaunched pod resumes from the drained
  step; SIGKILL to one child makes the shim return 137 with the sibling
  gone within the bound; a pod that sees fewer cards than it needs and
  a mesh that is not a multiple of the worker count are refused by
  name.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch
import yaml

from paddle_operator_tpu.api import (ResourceSpec, TPUJob, TPUJobSpec,
                                     TPUSpec)
from paddle_operator_tpu.api.types import (HOSTPORT_ANNOTATION, Intranet,
                                           MeshSpec)
from paddle_operator_tpu.controller import builders as B
from paddle_operator_tpu.launch import launcher as JLA
from paddle_operator_tpu.parallel import mesh as JM
from paddle_operator_tpu.train import data as JD
from paddle_operator_tpu_torch.convert import params_from_jax
from paddle_operator_tpu_torch.ft.preemption import EXIT_PREEMPTED
from paddle_operator_tpu_torch.launch import launcher as TLA
from paddle_operator_tpu_torch.parallel import mesh as TM
from paddle_operator_tpu_torch.parallel import sharding as PS
from paddle_operator_tpu_torch.train import data as TD
from tests.test_torch_sharded_train import (FIT_STEPS, REPO, _assert_metrics,
                                            _assert_params, _free_port,
                                            _jax_run_steps, _pod_env,
                                            _run_steps_batches)

CHILD = r'''
import json, os, signal, sys, time
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
from paddle_operator_tpu_torch.ft.preemption import (EXIT_PREEMPTED,
                                                     PreemptionWatcher)
from paddle_operator_tpu_torch.launch import launcher
from paddle_operator_tpu_torch.models import llama as TL
from paddle_operator_tpu_torch.parallel import mesh as PM
from paddle_operator_tpu_torch.parallel import sharding as PS
from paddle_operator_tpu_torch.parallel.collectives import full_tensor
from paddle_operator_tpu_torch.train import checkpoint as TC
from paddle_operator_tpu_torch.train import data as TD
from paddle_operator_tpu_torch.train import trainer as TT

a = json.load(open(sys.argv[1]))
env = launcher.initialize(device="cpu")
job = launcher.job_mesh(env, device="cpu")
rank = dist.get_rank()
out = {"rank": rank, "world": dist.get_world_size(), "pod": env.rank,
       "local": list(launcher.local_card()),
       "coords": PM.coordinates(job), "runs": {}}


def write():
    with open(os.path.join(a["out"], f"rank{rank}.json"), "w") as f:
        json.dump(out, f)


def fresh(mesh):
    model, _ = TL.make_model("tiny", device="cpu", dtype=torch.float32)
    model.load_state_dict(torch.load(a["init"]))
    opt = TT.make_optimizer(1e-3, warmup_steps=1, decay_steps=100)
    return TT.create_state(model, opt, mesh=mesh), opt


data = np.load(a["batches"])
batches = [{"tokens": data[f"b{i}"]} for i in range(len(data.files))]

if a["mode"] == "train":
    for run in a["runs"]:
        mesh = job if not run.get("axes") else PM.make_mesh(
            PM.MeshSpec(**run["axes"]), device="cpu")
        state, opt = fresh(mesh)
        rows = [TD.process_slice(b, mesh=mesh) for b in batches]
        state, hist = TT.fit(state, TT.make_step_for_mesh(opt, mesh),
                             TD.DevicePrefetcher(iter(rows), mesh=mesh),
                             steps=len(rows))
        whole = {k: full_tensor(p).detach().clone()
                 for k, p in state.model.named_parameters()}
        if rank == 0:
            torch.save(whole, os.path.join(a["out"], run["name"] + ".pt"))
        out["runs"][run["name"]] = {
            "metrics": [{k: float(v) for k, v in m.items()} for m in hist],
            "rows": rows[0]["tokens"].tolist()}
    write()
elif a["mode"] == "drain":
    # SIGTERM to the pod's shim at batch drain_at (sent by the pod's
    # card 0): the shim forwards it to every card, the cards drain
    # together and the pod exits 83; a relaunch resumes the step
    watcher = PreemptionWatcher.install(signals=(signal.SIGTERM,))
    ckpt = TC.CheckpointManager(a["ckpt"], save_interval_steps=100)
    state, resumed = TC.resume_or_init(ckpt, lambda: fresh(job)[0])
    opt = TT.make_optimizer(1e-3, warmup_steps=1, decay_steps=100)
    start = state.step

    def feed():
        for i in range(start, len(batches)):
            if i == a["drain_at"] and not resumed \
                    and launcher.local_card()[0] == 0:
                os.kill(os.getppid(), signal.SIGTERM)
                deadline = time.time() + 30
                while not watcher.draining and time.time() < deadline:
                    time.sleep(0.01)
            # placed here, not by a prefetching thread: the signal then
            # lands at a known step
            yield PS.local_batch(TD.process_slice(batches[i], mesh=job),
                                 job, "cpu")

    state, hist = TT.fit(state, TT.make_step_for_mesh(opt, job), feed(),
                         steps=len(batches) - start, checkpoint=ckpt,
                         preemption=watcher)
    ckpt.close()
    out["runs"]["drain"] = {"start": start, "resumed": resumed,
                            "step": state.step, "reason": watcher.reason,
                            "losses": [m["loss"] for m in hist]}
    write()
    dist.destroy_process_group()
    sys.exit(EXIT_PREEMPTED if watcher.draining else 0)
else:
    # hold the world open in a collective loop until killed
    with open(os.path.join(a["out"], f"pid{rank}"), "w") as f:
        f.write(str(os.getpid()))
    t = torch.zeros(1)
    while True:
        dist.all_reduce(t)
        time.sleep(0.01)
dist.destroy_process_group()
'''


def _pod_job(name, port, workers, cards, mesh):
    """A TPUJob of one slice of ``workers`` pods of ``cards`` cards."""
    tmpl = {"spec": {"containers": [{"name": "m", "image": "i"}]}}
    job = TPUJob(name=name, spec=TPUJobSpec(
        intranet=Intranet.HOST,
        worker=ResourceSpec(replicas=workers, template=tmpl),
        tpu=TPUSpec(topology=f"{cards}x{workers}", slice_count=1,
                    chips_per_worker=cards),
        mesh=mesh))
    job.annotations[HOSTPORT_ANNOTATION] = str(port)
    assert job.validate() == []
    return job


def _pods(job, workers):
    pods = []
    for i in range(workers):
        pod = B.construct_pod(job, "worker", i)
        pod["status"] = {"podIP": f"127.0.0.{i + 1}"}
        pods.append(pod)
    return pods, B.construct_configmap(job, pods)


def _start(tmp, name, job, workers, args):
    """One launcher shim a pod, each running CHILD."""
    pods, cm = _pods(job, workers)
    out = tmp / f"{name}-out"
    out.mkdir(exist_ok=True)
    child = tmp / f"{name}-child.py"
    child.write_text(CHILD)
    argf = tmp / f"{name}.json"
    argf.write_text(json.dumps(dict(args, out=str(out))))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "paddle_operator_tpu_torch.launch.launcher",
         "--", sys.executable, str(child), str(argf)],
        env=_pod_env(cm, pod), cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for pod in pods]
    return procs, out, cm


def _finish(procs, codes=(0,), timeout=300):
    rcs = []
    try:
        for i, p in enumerate(procs):
            _, err = p.communicate(timeout=timeout)
            rcs.append(p.returncode)
            assert p.returncode in codes, \
                f"pod {i} exited {p.returncode}:\n{err[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rcs


def _results(out, n):
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(n)]


AXES = {"fstp": {"fsdp": 2, "tp": 2}, "dptp": {"dp": 2, "tp": 2}}


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """The 2-worker × 2-card job and the 4-worker × 1-card job, each
    running fsdp2 × tp2 (the ConfigMap's mesh) and dp2 × tp2; JAX's
    step on both meshes while they train."""
    tmp = tmp_path_factory.mktemp("multicard")
    batches = _run_steps_batches(FIT_STEPS)
    np.savez(tmp / "batches.npz",
             **{f"b{i}": b for i, b in enumerate(batches)})
    jax_fstp = _jax_run_steps(AXES["fstp"], batches)
    init = params_from_jax(jax_fstp[0])
    torch.save(init, tmp / "init.pt")
    args = {"mode": "train", "init": str(tmp / "init.pt"),
            "batches": str(tmp / "batches.npz"),
            "runs": [{"name": "fstp"},
                     {"name": "dptp", "axes": AXES["dptp"]}]}
    mesh = MeshSpec(**AXES["fstp"])
    two, out2, cm2 = _start(tmp, "two", _pod_job(
        "cards2", _free_port(), 2, 2, mesh), 2, args)
    four, out4, _ = _start(tmp, "four", _pod_job(
        "cards1", _free_port(), 4, 1, mesh), 4, args)
    jax_dptp = _jax_run_steps(AXES["dptp"], batches)
    _finish(two)
    _finish(four)
    return {"two": (_results(out2, 4), out2), "four": (_results(out4, 4),
                                                       out4),
            "jax": {"fstp": jax_fstp, "dptp": jax_dptp},
            "batches": batches, "cm": cm2["data"]}


class TestTwoCardPods:
    def test_world_is_one_process_a_card(self, worlds):
        res, _ = worlds["two"]
        assert json.loads(worlds["cm"]["TPUJOB_MESH"]) == AXES["fstp"]
        assert worlds["cm"]["TPUJOB_NUM_WORKERS"] == "2"
        for r in res:
            assert r["world"] == 4
            assert r["local"] == [r["rank"] % 2, 2]
            assert r["pod"] == r["rank"] // 2
        # a pod's cards take the innermost coordinate (tp)
        assert [(r["coords"]["fsdp"], r["coords"]["tp"]) for r in res] == \
            [(0, 0), (0, 1), (1, 0), (1, 1)]

    @pytest.mark.parametrize("run", ["fstp", "dptp"])
    def test_equals_jax_and_the_one_card_workers(self, worlds, run):
        res2, out2 = worlds["two"]
        res4, out4 = worlds["four"]
        init, want, final = worlds["jax"][run]
        for r in res2 + res4:
            assert r["runs"][run]["metrics"] == \
                res2[0]["runs"][run]["metrics"]
        _assert_metrics(res2[0]["runs"][run]["metrics"], want)
        got = torch.load(out2 / f"{run}.pt")
        _assert_params(got, params_from_jax(final))
        one = torch.load(out4 / f"{run}.pt")
        assert set(got) == set(one)
        assert all(torch.equal(got[k], one[k]) for k in one)
        for a, b in zip(res2, res4):
            assert a["runs"][run]["rows"] == b["runs"][run]["rows"]

    def test_pod_rows_are_jax_process_slice(self, worlds):
        """The rows a pod's cards read together are JAX's
        ``process_slice`` for that pod (a block of the global batch a
        pod); tp siblings read the same rows."""
        res, _ = worlds["two"]
        batch = {"tokens": worlds["batches"][0]}
        for run in ("fstp", "dptp"):
            for pod in range(2):
                want = JD.process_slice(batch, pod, 2)["tokens"]
                rows = [np.asarray(r["runs"][run]["rows"]) for r in res
                        if r["pod"] == pod]
                got = np.unique(np.concatenate(rows), axis=0)
                assert np.array_equal(got, np.unique(want, axis=0)), run


def _llama_7b():
    with open(os.path.join(REPO, "deploy", "examples",
                           "llama_7b.yaml")) as f:
        job = TPUJob.from_dict(yaml.safe_load(f))
    assert job.validate() == []
    return job


def test_llama_7b_layout_is_jax_device_order():
    """deploy/examples/llama_7b.yaml: 16 pods of 4 cards on dp2 × fsdp8 ×
    tp4.  Rank of (pod, card) from each pod's env, its coordinates in
    the port's mesh, against JAX ``make_mesh`` over devices ordered by
    (process, local id); and each pod's rows."""
    job = _llama_7b()
    workers = job.spec.worker.replicas
    cards = job.spec.tpu.chips_per_worker
    assert (workers, cards) == (16, 4)
    pods, cm = _pods(job, workers)

    class Dev:
        platform = "cpu"

        def __init__(self, process, local):
            self.process_index, self.local = process, local

    devs = [Dev(p, c) for p in range(workers) for c in range(cards)]
    jmesh = JM.make_mesh(JLA.JobEnv.from_env(cm["data"]).mesh, devices=devs)
    jcoords = {(d.process_index, d.local): idx
               for idx, d in np.ndenumerate(jmesh.devices)}
    grid = None
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, 32000, (32, 8), dtype=np.int32)}
    ranks = set()
    for pod in pods:
        environ = _pod_env(cm, pod)
        env = TLA.JobEnv.from_env(environ)
        assert TLA.pod_cards(env) == cards
        if grid is None:
            grid = TM.rank_grid(env.mesh).numpy()
            sizes = dict(zip(TM.AXIS_ORDER, grid.shape))
        rows = []
        for card in range(cards):
            rank, world = TLA.process_rank(env, card)
            assert world == workers * cards
            ranks.add(rank)
            idx = tuple(int(i) for i in np.argwhere(grid == rank)[0])
            assert idx == jcoords[(env.rank, card)], (env.rank, card)
            coords = dict(zip(TM.AXIS_ORDER, idx))
            block, count = PS.data_block_at(sizes, coords)
            rows.append(TD.process_slice(batch, block, count)["tokens"])
        want = JD.process_slice(batch, env.rank, workers)["tokens"]
        assert np.array_equal(np.unique(np.concatenate(rows), axis=0),
                              np.unique(want, axis=0)), env.rank
    assert ranks == set(range(workers * cards))


def test_elastic_clamp_keeps_the_cards_a_pod():
    """A multi-card job of two slices loses one: the clamp's ConfigMap
    (``dp`` halved, one worker) keeps 2 cards a pod, so the smaller gang
    is one pod of 2 ranks, whose mesh ``job_mesh`` plans and whose
    resume is ``ft/elastic.py``'s (tests/test_torch_int8_mesh.py holds
    it on one-card pods)."""
    from paddle_operator_tpu.controller.fake_api import FakeAPI
    from paddle_operator_tpu.controller.reconciler import TPUJobReconciler

    tmpl = {"spec": {"containers": [{"name": "m", "image": "i"}]}}
    job = TPUJob(name="el", spec=TPUJobSpec(
        intranet=Intranet.HOST,
        worker=ResourceSpec(replicas=2, requests=1, limits=1,
                            template=tmpl),
        tpu=TPUSpec(topology="2x1", slice_count=2, chips_per_worker=2),
        mesh=MeshSpec(dp=2, tp=2)))
    job.annotations[HOSTPORT_ANNOTATION] = "8700"
    TPUJobReconciler(FakeAPI())._clamp_elastic(job)
    pods, cm = _pods(job, 1)
    env = TLA.JobEnv.from_env(_pod_env(cm, pods[0]))
    assert env.mesh.to_dict() == {"tp": 2}          # dp 2 -> 1
    assert env.num_workers == 1 and TLA.pod_cards(env) == 2
    assert [TLA.process_rank(env, c) for c in range(2)] == [(0, 2), (1, 2)]


def test_sigterm_drains_both_cards_and_the_job_resumes(tmp_path):
    batches = _run_steps_batches(4)
    np.savez(tmp_path / "batches.npz",
             **{f"b{i}": b for i, b in enumerate(batches)})
    init = tmp_path / "init.pt"
    from paddle_operator_tpu_torch.models import llama as TL

    torch.save(TL.make_model("tiny", device="cpu",
                             dtype=torch.float32)[0].state_dict(), init)
    args = {"mode": "drain", "init": str(init),
            "batches": str(tmp_path / "batches.npz"),
            "ckpt": str(tmp_path / "ckpt"), "drain_at": 2}
    job = _pod_job("drain", _free_port(), 1, 2, MeshSpec(fsdp=2))
    procs, out, _ = _start(tmp_path, "drain1", job, 1, args)
    assert _finish(procs, codes=(EXIT_PREEMPTED,)) == [EXIT_PREEMPTED]
    # the signal lands while batch 2 is fetched: step 3 finishes, both
    # cards stop after it and its checkpoint is committed
    for r in _results(out, 2):
        run = r["runs"]["drain"]
        assert not run["resumed"] and run["step"] == 3
        assert "SIGTERM" in run["reason"]
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["3"]
    job = _pod_job("drain", _free_port(), 1, 2, MeshSpec(fsdp=2))
    procs, out, _ = _start(tmp_path, "drain2", job, 1, args)
    assert _finish(procs) == [0]
    for r in _results(out, 2):
        run = r["runs"]["drain"]
        assert run["resumed"] and run["start"] == 3 and run["step"] == 4
        assert len(run["losses"]) == 1


def test_sigkill_to_one_card_fails_the_pod(tmp_path):
    np.savez(tmp_path / "batches.npz", b0=np.zeros((2, 2), np.int32))
    args = {"mode": "hold", "init": "", "batches":
            str(tmp_path / "batches.npz")}
    job = _pod_job("kill", _free_port(), 1, 2, MeshSpec(fsdp=2))
    procs, out, _ = _start(tmp_path, "kill", job, 1, args)
    pids = [out / f"pid{r}" for r in range(2)]
    deadline = time.monotonic() + 120
    while not all(p.exists() and p.read_text() for p in pids):
        assert time.monotonic() < deadline and procs[0].poll() is None
        time.sleep(0.05)
    victim, sibling = (int(p.read_text()) for p in pids)
    os.kill(victim, signal.SIGKILL)
    t0 = time.monotonic()
    assert procs[0].wait(timeout=TLA.SIBLING_GRACE_S + 30) == 128 + 9
    assert time.monotonic() - t0 <= TLA.SIBLING_GRACE_S + 5
    with pytest.raises(ProcessLookupError):
        os.kill(sibling, 0)
    procs[0].communicate()


def test_pod_that_sees_fewer_cards_is_refused_by_name(monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    env = TLA.JobEnv.from_env({"TPUJOB_NUM_WORKERS": "1",
                               "TPUJOB_MESH": '{"fsdp": 2}',
                               "TPUJOB_COORDINATOR_ADDRESS": "127.0.0.1:1"})
    assert TLA.pod_cards(env) == 2
    with pytest.raises(RuntimeError, match=r"runs 2 cards .* sees 1 CUDA "
                                           r"card.*never shares a card"):
        TLA.initialize(env)
    assert not dist.is_initialized()


def test_chip_smoke_two_card_pod_env_is_the_configmaps():
    """chip_smoke.py phase 3s starts a pod of 2 cards with CARDS2_POD_ENV:
    what controller/builders.py gives the one worker of a TPUJob of 2
    chips a worker, mesh fsdp 2 (its 2 cards: more than the card's
    machine has, which the phase holds refused by name)."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    tmpl = {"spec": {"containers": [{"name": "m", "image": "i"}]}}
    job = TPUJob(name="two-cards", spec=TPUJobSpec(
        worker=ResourceSpec(replicas=1, template=tmpl),
        tpu=TPUSpec(topology="2x1", slice_count=1, chips_per_worker=2),
        mesh=MeshSpec(fsdp=2)))
    pods, cm = _pods(job, 1)
    env = dict(cm["data"])
    for e in pods[0]["spec"]["containers"][0]["env"]:
        if "value" in e:
            env[e["name"]] = e["value"]
    env["POD_IP"] = pods[0]["status"]["podIP"]
    assert env == chip_smoke.CARDS2_POD_ENV
    assert TLA.pod_cards(TLA.JobEnv.from_env(env)) == 2


def test_mesh_not_a_multiple_of_the_workers_is_refused_by_name(tmp_path):
    env = TLA.JobEnv.from_env({"TPUJOB_NUM_WORKERS": "3",
                               "TPUJOB_MESH": '{"fsdp": 2, "tp": 4}'})
    with pytest.raises(ValueError, match="8 devices, not a multiple of "
                                         "the 3 worker pods"):
        TLA.pod_cards(env)
    marker = tmp_path / "ran"
    environ = {k: v for k, v in os.environ.items()
               if not k.startswith(("TPU_", "TPUJOB_", "MEGASCALE_"))}
    environ.update(TPUJOB_NUM_WORKERS="3",
                   TPUJOB_MESH='{"fsdp": 2, "tp": 4}',
                   PYTHONPATH=REPO + os.pathsep
                   + environ.get("PYTHONPATH", ""))
    r = subprocess.run(
        [sys.executable, "-m", "paddle_operator_tpu_torch.launch.launcher",
         "--", sys.executable, "-c",
         f"open({str(marker)!r}, 'w').write('x')"],
        env=environ, cwd=REPO, capture_output=True, text=True, timeout=60)
    assert r.returncode == 1
    assert "not a multiple of the 3 worker pods" in r.stderr
    assert not marker.exists()
