"""The torch package's in-pod launcher (paddle_operator_tpu_torch/launch/
launcher.py) held against the JAX package's: ``JobEnv.from_env`` field for
field on tests/test_mesh_launch.py TestJobEnv's contract, its defaults,
the ConfigMap round trip through the JAX ``controller/builders.py`` and
the old-controller PSERVER fallback; ``MeshSpec`` against
``api/types.py``'s; the three ``run_supervised`` cases of
tests/test_ft_preemption.py; ``main`` through a subprocess (``--``
stripped, the exec, the no-command JSON line, the ps/heter refusal);
``initialize`` over gloo with two processes from one ConfigMap
all-reducing a tensor (tests/test_rendezvous_multiproc.py's shape), and
its no-ops.
"""

import dataclasses
import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest

from paddle_operator_tpu.api import ResourceSpec, TPUJob, TPUJobSpec, TPUSpec
from paddle_operator_tpu.api import types as JTY
from paddle_operator_tpu.controller import builders as B
from paddle_operator_tpu.launch import launcher as JLA
from paddle_operator_tpu_torch.api import types as TTY
from paddle_operator_tpu_torch.ft.preemption import EXIT_PREEMPTED
from paddle_operator_tpu_torch.launch import launcher as TLA

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONTRACT = {
    "TPUJOB_NAME": "llama",
    "TPUJOB_RANK": "5",
    "TPU_WORKER_ID": "1",
    "MEGASCALE_SLICE_ID": "2",
    "TPUJOB_NUM_WORKERS": "8",
    "TPUJOB_WORKERS_PER_SLICE": "2",
    "TPUJOB_NUM_SLICES": "4",
    "TPUJOB_COORDINATOR_ADDRESS": "llama-worker-0:8476",
    "TPUJOB_WORKER_HOSTS": ",".join(f"h{i}" for i in range(8)),
    "TPUJOB_MESH": '{"dp": 4, "fsdp": 2}',
    "TPUJOB_TOPOLOGY": "2x4",
    "TPUJOB_CHECKPOINT_PATH": "gs://b/ck",
}


def _fields(env):
    """A JobEnv as plain values (the MeshSpec as its dict), so the two
    packages' dataclasses compare field for field."""
    out = {}
    for f in dataclasses.fields(env):
        v = getattr(env, f.name)
        out[f.name] = v.to_dict() if f.name == "mesh" else v
    return out


def _assert_same_env(environ):
    got, want = TLA.JobEnv.from_env(environ), JLA.JobEnv.from_env(environ)
    assert _fields(got) == _fields(want)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    assert got.is_xla_worker == want.is_xla_worker
    assert got.slice_local_hosts() == want.slice_local_hosts()
    return got


def _pod_env(cm, pod, base=None):
    """The env one container sees: the ConfigMap (envFrom) + the pod's
    own vars, over ``base``."""
    env = dict(base or {})
    env.update(cm["data"])
    for e in pod["spec"]["containers"][0]["env"]:
        if "value" in e:
            env[e["name"]] = e["value"]
    return env


def _job(workers=2, ps=0, heter=0, mesh=None, tpu=None):
    tmpl = {"spec": {"containers": [{"name": "m", "image": "i"}]}}
    return TPUJob(name="j", spec=TPUJobSpec(
        tpu=tpu, mesh=mesh or JTY.MeshSpec(),
        worker=ResourceSpec(replicas=workers, template=tmpl),
        ps=ResourceSpec(replicas=ps, template=tmpl) if ps else None,
        heter=ResourceSpec(replicas=heter, template=tmpl) if heter else None))


def _configmap(job, ip="10.0.0.{}"):
    pods = []
    for res_type, spec in (("worker", job.spec.worker), ("ps", job.spec.ps),
                           ("heter", job.spec.heter)):
        for i in range(spec.replicas if spec else 0):
            pod = B.construct_pod(job, res_type, i)
            pod["status"] = {"podIP": ip.format(len(pods) + 1)}
            pods.append(pod)
    return B.construct_configmap(job, pods), pods


# ---------------------------------------------------------------------------
# the contract
# ---------------------------------------------------------------------------


class TestJobEnv:
    def test_parse(self):
        env = _assert_same_env(CONTRACT)
        assert env.rank == 5 and env.worker_id == 1 and env.slice_id == 2
        assert env.num_workers == 8
        assert env.coordinator_address == "llama-worker-0:8476"
        assert env.mesh == TTY.MeshSpec(dp=4, fsdp=2)
        assert env.checkpoint_path == "gs://b/ck"

    def test_slice_local_hosts(self):
        assert _assert_same_env(CONTRACT).slice_local_hosts() == ["h4", "h5"]

    def test_defaults(self):
        env = _assert_same_env({})
        assert env.num_workers == 1 and env.rank == 0
        assert env.mesh == TTY.MeshSpec()
        assert env.port == TTY.COORDINATOR_PORT == JTY.COORDINATOR_PORT

    @pytest.mark.parametrize("environ", [
        {"TRAINING_ROLE": "PSERVER", "TPUJOB_RANK": "3"},
        {"TPUJOB_ROLE": "PSERVER"},
        {"TRAINING_ROLE": "TRAINER"},
        {"TPUJOB_ROLE": "PSERVER", "TPUJOB_RES_TYPE": "heter"},
        {"TPUJOB_WORKERS_PER_SLICE": "", "TPUJOB_NUM_SLICES": ""},
    ], ids=["old-ps", "ps-role", "old-trainer", "res-type-wins",
            "empty-counts"])
    def test_old_controller_fallbacks(self, environ):
        env = _assert_same_env(environ)
        if environ.get("TPUJOB_RES_TYPE"):
            assert env.res_type == environ["TPUJOB_RES_TYPE"]
        elif "PSERVER" in environ.values():
            assert env.res_type == "ps" and not env.is_xla_worker

    @pytest.mark.parametrize("res_type,idx", [("worker", 0), ("worker", 1),
                                              ("ps", 0), ("heter", 0)])
    def test_roundtrip_through_configmap(self, res_type, idx):
        job = _job(workers=2, ps=1, heter=1,
                   mesh=JTY.MeshSpec(dp=2, tp=4),
                   tpu=TPUSpec(topology="2x4", slice_count=1,
                               chips_per_worker=4))
        cm, pods = _configmap(job)
        env = _assert_same_env(_pod_env(cm, B.construct_pod(job, res_type,
                                                            idx)))
        assert env.res_type == res_type
        assert env.mesh == TTY.MeshSpec(dp=2, tp=4)
        assert env.coordinator_address == f"10.0.0.1:{TTY.COORDINATOR_PORT}"
        assert env.slice_local_hosts() == ["10.0.0.1", "10.0.0.2"]
        if res_type == "worker":
            assert env.rank == idx and env.is_xla_worker
        else:
            assert env.rank >= env.num_workers and not env.is_xla_worker

    def test_multislice_configmap(self):
        job = _job(workers=4, tpu=TPUSpec(topology="2x4", slice_count=2,
                                          chips_per_worker=4))
        cm, _ = _configmap(job, ip="127.0.0.{}")
        for i in range(4):
            env = _assert_same_env(_pod_env(cm, B.construct_pod(job,
                                                                "worker", i)))
            assert env.num_slices == 2 and env.workers_per_slice == 2
            assert env.slice_id == i // 2


class TestMeshSpec:
    @pytest.mark.parametrize("d", [{}, {"dp": 4, "fsdp": 2},
                                   {"tp": 2, "pp": 2, "cp": 2, "ep": 4},
                                   {"ep": "2"}, None])
    def test_matches_jax(self, d):
        got, want = TTY.MeshSpec.from_dict(d), JTY.MeshSpec.from_dict(d)
        if d is None:
            assert got is None and want is None
            return
        assert got.to_dict() == want.to_dict()
        assert got.size() == want.size()
        assert TTY.MeshSpec.AXES == JTY.MeshSpec.AXES
        assert [f.name for f in dataclasses.fields(TTY.MeshSpec)] == \
            [f.name for f in dataclasses.fields(JTY.MeshSpec)]

    def test_job_mesh_refused_by_name(self):
        """``job_mesh`` is ported: it plans the JAX ``job_mesh``'s axes and
        shape for the contract's 8 workers (the built mesh of 8 gloo
        ranks is held to JAX's in tests/test_torch_sharded_train.py), and
        what it refuses it refuses by name: before ``initialize``, a job
        of more than one rank, whether its ranks are workers or the
        cards of fewer workers (2 cards a pod of 4 here: a pod of more
        than one card is one process a card, tests/test_torch_multicard.py),
        and a mesh that is not a multiple of the worker count."""
        import torch.distributed as dist

        from paddle_operator_tpu_torch.parallel import mesh as TM

        env = TLA.JobEnv.from_env(CONTRACT)
        want = JLA.job_mesh(JLA.JobEnv.from_env(CONTRACT))
        assert tuple(TM.AXIS_ORDER) == tuple(want.axis_names)
        assert tuple(TM.mesh_shape(env.mesh)) == want.devices.shape
        with pytest.raises(RuntimeError, match="initialize"):
            TLA.job_mesh(env, device="cpu")
        cards = TLA.JobEnv.from_env(dict(CONTRACT, TPUJOB_NUM_WORKERS="4"))
        assert TLA.pod_cards(cards) == 2
        with pytest.raises(RuntimeError, match=r"4 worker\(s\) × 2 card"):
            TLA.job_mesh(cards, device="cpu")
        odd = TLA.JobEnv.from_env(dict(CONTRACT, TPUJOB_NUM_WORKERS="3"))
        with pytest.raises(ValueError, match="not a multiple of the 3 "
                                             "worker pods"):
            TLA.job_mesh(odd, device="cpu")
        assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# run_supervised (tests/test_ft_preemption.py's three cases)
# ---------------------------------------------------------------------------


def _signal_when_ready(ready, sig):
    def go():
        deadline = time.monotonic() + 30
        while not ready.exists() and time.monotonic() < deadline:
            time.sleep(0.02)
        time.sleep(0.1)
        os.kill(os.getpid(), sig)

    t = threading.Thread(target=go)
    t.start()
    return t


class TestRunSupervised:
    def test_exit_code_propagates(self):
        rc = TLA.run_supervised([sys.executable, "-c",
                                 f"import sys; sys.exit({EXIT_PREEMPTED})"])
        assert rc == EXIT_PREEMPTED == 83

    def test_sigterm_forwarded_to_child(self, tmp_path):
        ready = tmp_path / "ready"
        child = (
            "import signal, sys, time, pathlib\n"
            f"signal.signal(signal.SIGTERM, lambda *a: "
            f"sys.exit({EXIT_PREEMPTED}))\n"
            f"pathlib.Path({str(ready)!r}).write_text('up')\n"
            "time.sleep(30)\n")
        t = _signal_when_ready(ready, signal.SIGTERM)
        rc = TLA.run_supervised([sys.executable, "-c", child])
        t.join(timeout=5)
        assert rc == EXIT_PREEMPTED

    def test_unhandled_signal_maps_to_128_plus_n(self, tmp_path):
        ready = tmp_path / "ready"
        child = (
            "import time, pathlib\n"
            f"pathlib.Path({str(ready)!r}).write_text('up')\n"
            "time.sleep(30)\n")
        t = _signal_when_ready(ready, signal.SIGTERM)
        rc = TLA.run_supervised([sys.executable, "-c", child])
        t.join(timeout=5)
        assert rc == 128 + signal.SIGTERM

    def test_handlers_restored(self):
        before = signal.getsignal(signal.SIGTERM)
        TLA.run_supervised([sys.executable, "-c", "pass"])
        assert signal.getsignal(signal.SIGTERM) is before


# ---------------------------------------------------------------------------
# main, as the pod runs it
# ---------------------------------------------------------------------------


def _clean_env(extra=None):
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPU_", "TPUJOB_", "MEGASCALE_"))}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra or {})
    return env


def _launch(args, env, timeout=60):
    return subprocess.run(
        [sys.executable, "-m", "paddle_operator_tpu_torch.launch.launcher",
         *args], env=env, cwd=REPO, capture_output=True, text=True,
        timeout=timeout)


class TestMain:
    CHILD = ("import json, os, sys; print(json.dumps({'argv': sys.argv[1:], "
             "'hosts': os.environ.get('TPU_WORKER_HOSTNAMES'), "
             "'pid': os.getpid()}))")

    @pytest.mark.parametrize("drain", ["", "1"])
    def test_strips_dashes_exports_hosts_runs_command(self, drain):
        env = _clean_env(dict(CONTRACT, TPU_WORKER_HOSTNAMES="localhost",
                              TPUJOB_DRAIN=drain))
        r = _launch(["--", sys.executable, "-c", self.CHILD, "a", "--",
                     "b"], env)
        assert r.returncode == 0, r.stderr
        out = json.loads(r.stdout.strip().splitlines()[-1])
        # only the leading "--" goes; the contract outranks a preset
        assert out["argv"] == ["a", "--", "b"]
        assert out["hosts"] == "h4,h5"

    def test_execs_without_drain(self, tmp_path):
        """Unsupervised, the command replaces the shim: its pid is the
        launcher's own."""
        probe = ("import os, sys; sys.stdout.write(str(os.getpid())); "
                 f"sys.exit({EXIT_PREEMPTED})")
        proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_operator_tpu_torch.launch.launcher",
             "--", sys.executable, "-c", probe],
            env=_clean_env(), cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        out, err = proc.communicate(timeout=60)
        assert proc.returncode == EXIT_PREEMPTED, err
        assert int(out) == proc.pid

    def test_supervised_child_exit_code_is_the_pods(self):
        r = _launch(["--", sys.executable, "-c",
                     f"import sys; sys.exit({EXIT_PREEMPTED})"],
                    _clean_env({"TPUJOB_DRAIN": "yes"}))
        assert r.returncode == EXIT_PREEMPTED

    def test_supervised_sigterm_reaches_the_child(self, tmp_path):
        ready = tmp_path / "ready"
        child = (
            "import signal, sys, time, pathlib\n"
            f"signal.signal(signal.SIGTERM, lambda *a: "
            f"sys.exit({EXIT_PREEMPTED}))\n"
            f"pathlib.Path({str(ready)!r}).write_text('up')\n"
            "time.sleep(30)\n")
        proc = subprocess.Popen(
            [sys.executable, "-m", "paddle_operator_tpu_torch.launch.launcher",
             "--", sys.executable, "-c", child],
            env=_clean_env({"TPUJOB_DRAIN": "true"}), cwd=REPO)
        deadline = time.monotonic() + 30
        while not ready.exists():
            assert time.monotonic() < deadline
            time.sleep(0.02)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == EXIT_PREEMPTED

    @pytest.mark.parametrize("environ", [CONTRACT, {}],
                             ids=["contract", "empty"])
    def test_worker_without_command_prints_jax_line(self, environ):
        r = _launch([], _clean_env(environ))
        assert r.returncode == 0, r.stderr
        got = json.loads(r.stdout.strip())
        env = JLA.JobEnv.from_env(environ)
        # JAX's line, and the pod's card count (one: 8 devices, 8 pods)
        assert got == {"rank": env.rank, "num_workers": env.num_workers,
                       "coordinator": env.coordinator_address,
                       "mesh": env.mesh.to_dict(), "topology": env.topology,
                       "cards": 1}

    @pytest.mark.parametrize("res_type", ["ps", "heter"])
    def test_ps_and_heter_without_command_refused_by_name(self, res_type):
        job = _job(workers=1, ps=1, heter=1)
        cm, _ = _configmap(job)
        env = _pod_env(cm, B.construct_pod(job, res_type, 0), _clean_env())
        for args in ([], ["--"]):
            r = _launch(args, env)
            assert r.returncode == TLA.EXIT_UNPORTED != 0
            assert "Queue A item 9" in r.stderr and res_type in r.stderr
            assert r.stdout == ""


# ---------------------------------------------------------------------------
# initialize
# ---------------------------------------------------------------------------


WORKER_CHILD = """
import torch, torch.distributed as dist
from paddle_operator_tpu_torch.launch import launcher
env = launcher.initialize(device="cpu")
assert env.is_xla_worker
assert dist.get_world_size() == env.num_workers
assert dist.get_rank() == env.rank
t = torch.tensor([float(env.rank + 1)])
dist.all_reduce(t)
ranks = [None] * env.num_workers
dist.all_gather_object(ranks, env.rank)
print("SUM", float(t), "RANKS", sorted(ranks))
import os
print("HOSTS", os.environ.get("TPU_WORKER_HOSTNAMES"))
dist.destroy_process_group()
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class TestInitialize:
    def test_two_gloo_processes_from_one_configmap(self):
        from paddle_operator_tpu.api.types import HOSTPORT_ANNOTATION, Intranet

        port = _free_port()
        tmpl = {"spec": {"containers": [{"name": "m", "image": "i"}]}}
        job = TPUJob(name="rdzv", spec=TPUJobSpec(
            intranet=Intranet.HOST,
            worker=ResourceSpec(replicas=2, template=tmpl)))
        job.annotations[HOSTPORT_ANNOTATION] = str(port)
        cm, pods = _configmap(job, ip="127.0.0.1")
        assert cm["data"]["TPUJOB_COORDINATOR_ADDRESS"] == f"127.0.0.1:{port}"
        envs = [_pod_env(cm, pod, _clean_env()) for pod in pods]
        procs = [subprocess.Popen(
            [sys.executable, "-c", WORKER_CHILD], env=env, cwd=REPO,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for env in envs]
        for env, p in zip(envs, procs):
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0, err
            assert "SUM 3.0 RANKS [0, 1]" in out, out
            hosts = JLA.JobEnv.from_env(env).slice_local_hosts()
            assert f"HOSTS {','.join(hosts)}" in out, out

    def test_single_worker_is_a_noop(self, monkeypatch):
        import torch.distributed as dist

        monkeypatch.delenv("TPU_WORKER_HOSTNAMES", raising=False)
        env = TLA.initialize(TLA.JobEnv.from_env(
            {"TPUJOB_WORKER_HOSTS": "h0"}), device="cpu")
        assert env.num_workers == 1
        assert not dist.is_initialized()
        assert "TPU_WORKER_HOSTNAMES" not in os.environ

    def test_ps_pod_is_a_noop(self):
        import torch.distributed as dist

        env = TLA.initialize(TLA.JobEnv.from_env(
            {"TPUJOB_RES_TYPE": "ps", "TPUJOB_NUM_WORKERS": "2",
             "TPUJOB_RANK": "2"}), device="cpu")
        assert not env.is_xla_worker and not dist.is_initialized()

    def test_no_card_raises_without_cpu_request(self, monkeypatch):
        import torch

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        env = TLA.JobEnv.from_env({"TPUJOB_NUM_WORKERS": "2",
                                   "TPUJOB_COORDINATOR_ADDRESS":
                                   "127.0.0.1:1"})
        with pytest.raises(RuntimeError, match="no CUDA card"):
            TLA.initialize(env)
        with pytest.raises(ValueError, match="device"):
            TLA.initialize(env, device="meta")


def test_chip_smoke_pod_env_is_the_configmaps():
    """chip_smoke.py phase 3q starts the training pod with MOE_POD_ENV:
    it must be what controller/builders.py gives the one worker of a
    one-worker job (the ConfigMap's data and the pod's own vars, its
    POD_IP the pod's IP), the checkpoint path aside."""
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    tmpl = {"spec": {"containers": [{"name": "m", "image": "i"}]}}
    job = TPUJob(name="moe-train", spec=TPUJobSpec(
        worker=ResourceSpec(replicas=1, template=tmpl),
        checkpoint_path="/ckpt"))
    pod = B.construct_pod(job, "worker", 0)
    pod["status"] = {"podIP": "127.0.0.1"}
    cm = B.construct_configmap(job, [pod])
    env = _pod_env(cm, pod)
    env["POD_IP"] = pod["status"]["podIP"]
    assert env.pop("TPUJOB_CHECKPOINT_PATH") == "/ckpt"
    assert env == chip_smoke.MOE_POD_ENV
    got = TLA.JobEnv.from_env(chip_smoke.MOE_POD_ENV)
    assert got.is_xla_worker and got.num_workers == 1 and got.rank == 0
