"""The port's continuous rings tensor-parallel (paddle_operator_tpu_torch
``ContinuousBatcher(mesh=...)`` on rank 0, ``follow_ring`` on rank 1 of
a gloo world of 2), each token-identical to the port's tp-1 ring and to
the JAX package's tp-2 ring (its ``ContinuousBatcher(mesh=...)`` on the
conftest's virtual devices) at f32 on the tiny preset:

- the contiguous ring (JAX tests/test_batcher.py ``TestShardedRing``);
- the bf16 (here f32) and int8 paged rings (JAX tests/test_paged.py
  ``TestShardedPagedRing``);
- megastep 4 (JAX tests/test_megastep.py);
- chunked prefill, on the paged and the contiguous ring;
- mixed adapters, one of them loaded at runtime through the leader
  (JAX tests/test_qos.py ``test_adapter_parity_tp2``);
- a preempted lane, spilled and restored on each rank's kv-head slice,
  resumed bit for bit (JAX tests/test_qos.py
  ``test_preempt_tp2_bit_identical``);
- the contiguous, paged and int8 paged rings again with the decode
  kernels selected (the ring forwards' sharded-wrapper branch, their
  plain versions on these CPU tensors), equal to the tp-1 ring.

One world runs every ring in turn (its own timeout); the JAX and tp-1
references run in this process meanwhile.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from paddle_operator_tpu.infer import qos as JQOS
from paddle_operator_tpu.infer.batcher import ContinuousBatcher as JaxBatcher
from paddle_operator_tpu.models.llama import make_model as jax_make_model
from paddle_operator_tpu.parallel.mesh import make_serving_mesh as jax_mesh
from paddle_operator_tpu_torch.convert import params_from_jax
from paddle_operator_tpu_torch.infer import qos as QOS
from paddle_operator_tpu_torch.infer.scheduler import ContinuousBatcher
from paddle_operator_tpu_torch.models.llama import make_model
from tests.test_torch_serving_tp import RANK_HEAD, World

MAX_LEN = 64
NEW = 7
BASE = dict(slots=2, max_len=MAX_LEN, chunk_tokens=4,
            prefill_buckets=(16, MAX_LEN))
PAGED = dict(BASE, paged=True, block_size=8)
# name -> the ring's arguments (adapters and qos are built per side)
RINGS = {
    "contiguous": BASE,
    "paged": PAGED,
    "paged_int8": dict(PAGED, kv_quant="int8"),
    "megastep4": dict(PAGED, megastep=4),
    "chunked_paged": dict(PAGED, prefill_mode="chunked", prefill_chunk=8),
    "chunked_contiguous": dict(BASE, prefill_mode="chunked",
                               prefill_chunk=8),
    "adapters": PAGED,
}
PREEMPT = dict(PAGED, slots=1, num_blocks=16)
# rings run again with the decode kernels selected
KERNEL_RINGS = ("contiguous", "paged", "paged_int8")
PROMPT_LENS = (5, 11, 30)


def _prompts():
    return [np.random.default_rng(40 + i).integers(0, 256, n).tolist()
            for i, n in enumerate(PROMPT_LENS)]


def _requests(prompts, name):
    """(prompt, adapter) of every request a ring serves."""
    if name != "adapters":
        return [(p, None) for p in prompts]
    return [(prompts[0], "x"), (prompts[0], None), (prompts[1], "y"),
            (prompts[2], "x")]


CHILD_RINGS = RANK_HEAD + r'''
import threading, time
from paddle_operator_tpu_torch.infer import decode as D
from paddle_operator_tpu_torch.infer import qos as QOS
from paddle_operator_tpu_torch.infer.scheduler import (ContinuousBatcher,
                                                       follow_ring)
from paddle_operator_tpu_torch.models.llama import make_model

model, cfg = make_model("tiny", device="cpu", dtype=torch.float32)
model.load_state_dict(torch.load(a["state"]))
shard = D.shard_params_for_serving(model, cfg, mesh)


def ring_kw(name, kw):
    kw = dict(kw, prefill_buckets=tuple(kw["prefill_buckets"]))
    if name == "adapters":
        reg = QOS.AdapterRegistry(cfg, capacity=2, rank=4, device="cpu")
        reg.load("x", seed=7)             # the boot load, on every rank
        kw["adapters"] = reg
    if name == "preempt":
        kw["qos"] = QOS.QoSConfig(priorities=2)
    return kw


def serve(name, kw, body, cfg=cfg):
    if rank:
        follow_ring(shard, cfg, mesh=mesh, **ring_kw(name, kw))
        return
    b = ContinuousBatcher(shard, cfg, mesh=mesh, **ring_kw(name, kw))
    try:
        out[name] = body(b)
        out[name + "_tp"] = b.serving_tp()
        if b.pool is not None:
            b.pool.check_invariant()
    finally:
        b.close()


def plain(name):
    def body(b):
        if name == "adapters":
            b.adapters.load("y", seed=9)  # at runtime, through the leader
        hs = [b.submit(p, max_new_tokens=a["new"], adapter=ad)
              for p, ad in a["requests"][name]]
        return [h.result(timeout=120) for h in hs]
    return body


def preempt(b):
    p, p0 = a["victim"], a["urgent"]
    want = b.submit(p, max_new_tokens=24).result(timeout=120)
    real = b.executor.replay
    gate = threading.Event()
    gate.set()

    def slow(plan):
        gate.wait(timeout=60)
        time.sleep(0.03)
        return real(plan)

    b.executor.replay = slow
    n0 = b.stats["admitted"]
    h_long = b.submit(p, max_new_tokens=24)
    deadline = time.monotonic() + 60
    while b.stats["admitted"] <= n0 and time.monotonic() < deadline:
        time.sleep(0.005)
    gate.clear()              # freeze: the class-0 request finds a full ring
    h0 = b.submit(p0, max_new_tokens=4, priority=0)
    gate.set()
    h0.result(timeout=120)
    got = h_long.result(timeout=120)
    return {"want": want, "got": got, "urgent": h0.result(timeout=1),
            "preempted": b.stats["preempted_lanes"],
            "restored": b.stats["restored_lanes"]}


for name, kw in a["rings"].items():
    serve(name, kw, plain(name))
# the decode kernels' selection: the sharded wrappers' branch of the
# ring forwards (their plain versions on these CPU tensors)
import dataclasses
kcfg = dataclasses.replace(cfg, decode_attn="kernel")
for name in a["kernel_rings"]:
    a["requests"][name + "_kernel"] = a["requests"][name]
    serve(name + "_kernel", a["rings"][name], plain(name + "_kernel"), kcfg)
serve("preempt", a["preempt"], preempt)
save()
'''


@pytest.fixture(scope="module")
def tiny():
    jmodel, jcfg = jax_make_model("tiny", dtype=jnp.float32)
    jparams = jmodel.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, 8), jnp.int32))["params"]
    model, cfg = make_model("tiny", device="cpu", dtype=torch.float32)
    model.load_state_dict(params_from_jax(jax.device_get(jparams)))
    return jcfg, jparams, model, cfg


def _serve(batcher_cls, params, cfg, kw, reqs, new, mesh=None,
           registry=None):
    kw = dict(kw)
    if registry is not None:
        reg = registry(cfg)
        reg.load("x", seed=7)
        reg.load("y", seed=9)
        kw["adapters"] = reg
    if mesh is not None:
        kw["mesh"] = mesh
    b = batcher_cls(params, cfg, **kw)
    try:
        hs = [b.submit(p, max_new_tokens=new, adapter=ad) for p, ad in reqs]
        return [h.result(timeout=300) for h in hs]
    finally:
        b.close()


def test_tp2_rings_equal_tp1_and_jax_tp2(tmp_path, tiny):
    jcfg, jparams, model, cfg = tiny
    prompts = _prompts()
    reqs = {name: _requests(prompts, name) for name in RINGS}
    victim = np.random.default_rng(3).integers(0, 256, 9).tolist()
    urgent = np.random.default_rng(5).integers(0, 256, 7).tolist()
    torch.save(model.state_dict(), tmp_path / "state.pt")
    world = World(tmp_path, "rings", 2, CHILD_RINGS, {
        "state": str(tmp_path / "state.pt"), "rings": RINGS,
        "preempt": PREEMPT, "requests": reqs, "new": NEW,
        "kernel_rings": KERNEL_RINGS,
        "victim": victim, "urgent": urgent})

    def port_reg(c):
        return QOS.AdapterRegistry(c, capacity=2, rank=4, device="cpu")

    def jax_reg(c):
        return JQOS.AdapterRegistry(c, capacity=2, rank=4)

    jmesh = jax_mesh(2)
    want_tp1, want_jax = {}, {}
    for name, kw in RINGS.items():
        adapters = name == "adapters"
        want_tp1[name] = _serve(ContinuousBatcher, model, cfg, kw,
                                reqs[name], NEW,
                                registry=port_reg if adapters else None)
        want_jax[name] = _serve(JaxBatcher, jparams, jcfg, kw, reqs[name],
                                NEW, mesh=jmesh,
                                registry=jax_reg if adapters else None)
    jax_victim = _serve(JaxBatcher, jparams, jcfg, PAGED,
                        [(victim, None)], 24, mesh=jmesh)[0]
    out = world.results()[0]
    assert not out["jax_imported"]
    for name in RINGS:
        assert out[name + "_tp"] == 2
        assert out[name] == want_tp1[name], name
        assert out[name] == want_jax[name], name
    for name in KERNEL_RINGS:
        assert out[name + "_kernel"] == want_tp1[name], name
    # the adapters change the streams (the parity is not vacuous)
    got = out["adapters"]
    assert got[0] != got[1] and got[0][:len(prompts[0])] == prompts[0]
    pre = out["preempt"]
    assert pre["preempted"] >= 1 and pre["restored"] == pre["preempted"]
    assert pre["got"] == pre["want"] == jax_victim
