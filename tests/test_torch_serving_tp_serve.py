"""The port's serving replica under ``SERVE_TP=2``: ``python -m
paddle_operator_tpu_torch.infer.serve --device cpu`` starts two ranks
over gloo, one process each (``serve.serve_tp_pod``,
``launch/launcher.py`` ``run_pod``), rank 0 serving HTTP, in the
preset's bf16:

- the continuous paged replica answers ``/v1/generate`` with the tokens
  of the same weights' tp-2 ring (``ContinuousBatcher(mesh=...)`` and
  ``follow_ring`` in a gloo world of two: the same summation order, so
  equal), whose first-token logits are within the repo's bf16 bound of
  tp 1's; ``/statusz`` says ``servingTp`` 2, a live swap is refused by
  name (400), and SIGTERM drains it: exit 83;
- the batch replica (``Generator(mesh=...)``) answers with the tp-2
  ``generate``'s tokens, and killing its second rank ends the replica
  with a nonzero exit within ``SIBLING_GRACE_S``;
- every knob a tensor-parallel replica does not serve is refused at
  start by name (ROADMAP.md item 8.5b's list), a pod that sees fewer
  cards than ``SERVE_TP`` is refused, and the env the operator renders
  from ``deploy/examples/llama_7b_serving_fleet.yaml`` passes the start
  checks on a pod of 4 cards once its fleet-KV and host-tier knobs are
  left out (with them, those knobs are what is refused).
"""

import json
import os
import signal
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest
import yaml

from paddle_operator_tpu_torch.infer import serve as S
from paddle_operator_tpu_torch.launch.launcher import SIBLING_GRACE_S
from paddle_operator_tpu_torch.models.llama import CONFIGS
from tests.test_torch_serving_tp import RANK_HEAD, REPO, World, _free_port

RING_ENV = {"MODEL_PRESET": "tiny", "SERVE_CONTINUOUS": "1",
            "SERVE_PAGED": "1", "SERVE_BLOCK_SIZE": "8", "SERVE_SLOTS": "2",
            "SERVE_CHUNK": "4", "SERVE_MAX_LEN": "64", "SERVE_PREWARM": "0",
            "SERVE_DRAIN_BUDGET_S": "10"}
BODY = {"tokens": [[3, 14, 15, 92, 65, 35, 89], [7, 1, 2, 9, 40, 1, 6]],
        "max_new_tokens": 8}
BOOT_S = 90
# bf16 logits, the repo's bound (tests/test_kvquant.py TOL)
BF16_TOL = 0.15

# the replicas' references on the same weights (the seed-0 init both
# replicas serve): rank 0 the tp-2 ring the ring replica builds from
# RING_ENV, rank 1 its follower; then the tp-2 generate of the batch
# replica and the first-token logits at tp 2, and at tp 1 on rank 0
CHILD_REF = RANK_HEAD + r'''
from paddle_operator_tpu_torch.infer import decode as D
from paddle_operator_tpu_torch.infer import serve as S
from paddle_operator_tpu_torch.infer.scheduler import (ContinuousBatcher,
                                                       follow_ring)
from paddle_operator_tpu_torch.models.llama import CONFIGS

base = CONFIGS["tiny"]
shard, cfg, _ = S.load_serving_shard("", base, mesh, "cpu")
kw = S.ring_kw_from_env(a["env"], base)
rows, new = a["rows"], a["new"]
if rank:
    follow_ring(shard, cfg, mesh=mesh, **kw)
else:
    b = ContinuousBatcher(shard, cfg, mesh=mesh, **kw)
    try:
        hs = [b.submit(r, max_new_tokens=new, temperature=0.0, seed=i)
              for i, r in enumerate(rows)]
        out["ring"] = [h.result(timeout=120) for h in hs]
    finally:
        b.close()
with torch.inference_mode():
    out["generate"] = D.generate(shard, cfg, torch.tensor(rows[:1]),
                                 max_new_tokens=new, mesh=mesh).tolist()
    out["logits_tp2"] = D.prefill(shard, cfg, torch.tensor(rows),
                                  mesh=mesh)[0].float()
    if rank == 0:
        whole, cfg1, _ = S.load_serving_params("", base, "cpu")
        out["logits_tp1"] = D.prefill(whole, cfg1,
                                      torch.tensor(rows))[0].float()
save()
'''


def _start(tmp, env, port):
    full = {k: v for k, v in os.environ.items()
            if not k.startswith(("SERVE_", "TPUJOB_", "MODEL_"))}
    full.update(env, SERVE_TP="2", TPUJOB_PORT=str(port),
                TPUJOB_FLIGHTREC_DIR=str(tmp), OMP_NUM_THREADS="1",
                PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                              ""))
    return subprocess.Popen(
        [sys.executable, "-m", "paddle_operator_tpu_torch.infer.serve",
         "--device", "cpu"], env=full, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _request(port, path, body=None, timeout=60):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}",
                                 data=data)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _wait_ready(proc, port):
    deadline = time.monotonic() + BOOT_S
    while time.monotonic() < deadline:
        assert proc.poll() is None, proc.communicate()[0][-4000:]
        try:
            if _request(port, "/healthz", timeout=2)[0] == 200:
                return
        except OSError:
            time.sleep(0.2)
    raise AssertionError("the SERVE_TP=2 replica never answered")


def _children(pid):
    """The replica's rank processes (``LOCAL_RANK`` -> pid)."""
    ranks = {}
    with open(f"/proc/{pid}/task/{pid}/children") as f:
        for child in f.read().split():
            with open(f"/proc/{child}/environ", "rb") as e:
                env = dict(kv.split(b"=", 1) for kv in e.read().split(b"\0")
                           if b"=" in kv)
            ranks[int(env[b"LOCAL_RANK"])] = int(child)
    return ranks


def _stop(proc):
    if proc.poll() is None:
        proc.kill()
    proc.communicate()


@pytest.fixture(scope="module")
def tp2_ref(tmp_path_factory):
    """The references' world (:data:`CHILD_REF`), started at once so it
    runs while the replicas boot; the fixture's value reads rank 0's
    results (once)."""
    world = World(tmp_path_factory.mktemp("tp2ref"), "ref", 2, CHILD_REF,
                  {"env": RING_ENV, "rows": BODY["tokens"],
                   "new": BODY["max_new_tokens"]})
    got = []

    def results():
        if not got:
            got.extend(world.results())
            assert not any(r["jax_imported"] for r in got)
            assert (got[0]["logits_tp2"] == got[1]["logits_tp2"]).all()
        return got[0]

    yield results
    for p in world.procs:
        if p.poll() is None:
            p.kill()
            p.wait()


def test_ring_replica_answers_as_tp1_and_drains(tmp_path, tp2_ref):
    port = _free_port()
    proc = _start(tmp_path, RING_ENV, port)
    try:
        ref = tp2_ref()
        diff = (ref["logits_tp2"] - ref["logits_tp1"]).abs().max().item()
        assert diff <= BF16_TOL, diff
        want = [list(r) for r in ref["ring"]]
        assert len(want) == 2 and all(len(r) == 15 for r in want)
        _wait_ready(proc, port)
        assert _request(port, "/v1/generate", BODY) == (200,
                                                        {"tokens": want})
        code, st = _request(port, "/statusz")
        assert code == 200 and st["servingTp"] == 2
        code, out = _request(port, "/v1/swap", {})
        assert code == 400 and "tensor-parallel" in out["error"]
        assert "8.5b" in out["error"]
        ranks = _children(proc.pid)
        assert sorted(ranks) == [0, 1]
        proc.send_signal(signal.SIGTERM)
        log = proc.communicate(timeout=60)[0]
        assert proc.returncode == 83, log[-4000:]
        assert "tp=2" in log
    finally:
        _stop(proc)


def test_batch_replica_answers_and_dies_with_a_rank(tmp_path, tp2_ref):
    port = _free_port()
    proc = _start(tmp_path, {"MODEL_PRESET": "tiny"}, port)
    try:
        want = tp2_ref()["generate"]
        _wait_ready(proc, port)
        code, out = _request(port, "/v1/generate",
                             dict(BODY, tokens=BODY["tokens"][:1]))
        assert code == 200 and out["tokens"] == want
        ranks = _children(proc.pid)
        os.kill(ranks[1], signal.SIGKILL)
        t0 = time.monotonic()
        proc.communicate(timeout=SIBLING_GRACE_S + 30)
        assert proc.returncode not in (0, 83)
        assert time.monotonic() - t0 < SIBLING_GRACE_S + 10
    finally:
        _stop(proc)


# ROADMAP.md Queue A item 8.5b's list, in its order: each knob is refused
# under SERVE_TP > 1, by its name
REFUSED_UNDER_TP = [
    {"SERVE_SPEC_K": "2"},
    {"SERVE_HOST_CACHE_MB": "64"},
    {"SERVE_HOST_CACHE_BLOCKS": "8"},
    {"SERVE_KV_STORE": "dir:/tmp/kvs"},
    {"SERVE_KV_MIGRATE": "1"},
    {"SERVE_KV_PEER_FETCH": "1"},
    {"SERVE_PREFILL": "disagg"},
    {"MODEL_PRESET": "7b-moe"},
]


@pytest.mark.parametrize("knob", REFUSED_UNDER_TP,
                         ids=lambda k: next(iter(k)))
def test_unserved_knobs_refused_by_name(knob):
    name, value = next(iter(knob.items()))
    env = dict(RING_ENV, SERVE_TP="2", **knob)
    with pytest.raises(ValueError, match=name) as e:
        S.check_start(env, cards=2)
    assert f"{name}={value}" in str(e.value) and "8.5b" in str(e.value)
    # the same knob without tensor parallelism is served
    S.check_start(dict(env, SERVE_TP="1"), cards=1)


def test_fleet_example_passes_the_start_checks_on_4_cards():
    from paddle_operator_tpu.api import TPUJob
    from paddle_operator_tpu.controller.builders import construct_serve_pod

    with open(os.path.join(REPO, "deploy/examples/"
                           "llama_7b_serving_fleet.yaml")) as f:
        doc = yaml.safe_load(f)

    def env_of(spec):
        job = TPUJob.from_dict(dict(doc, spec=spec))
        pod = construct_serve_pod(job, 0)
        return {e["name"]: e["value"] for e in
                pod["spec"]["containers"][0]["env"] if "value" in e}

    env = env_of(doc["spec"])
    assert (env["SERVE_TP"], env["MODEL_PRESET"], env["SERVE_PREFILL"],
            env["SERVE_WEIGHT_QUANT"]) == ("4", "7b", "chunked", "int8")
    # as shipped: its fleet-KV and host-tier knobs are what is refused
    with pytest.raises(ValueError) as e:
        S.check_start(env, cards=4)
    said = str(e.value)
    assert all(k in said for k in ("SERVE_KV_MIGRATE", "SERVE_KV_PEER_FETCH",
                                   "SERVE_HOST_CACHE_MB"))
    assert not any(k in said for k in ("SERVE_PREFILL", "SERVE_ADAPTERS",
                                       "SERVE_MEGASTEP", "SERVE_WEIGHT_QUANT",
                                       "MODEL_PRESET"))
    serving = {k: v for k, v in doc["spec"]["serving"].items()
               if k not in ("kvMigration", "peerPrefixFetch", "hostCacheMb")}
    env = env_of(dict(doc["spec"], serving=serving))
    assert S.check_start(env, cards=4) == 4
    with pytest.raises(ValueError, match="SERVE_TP=4 runs one process a "
                                         "card; this pod sees 2"):
        S.check_start(env, cards=2)
    kw = S.ring_kw_from_env(env, CONFIGS["7b"])
    assert kw["paged"] and kw["megastep"] == 4
    assert kw["prefill_mode"] == "chunked" and kw["qos"].preempt
