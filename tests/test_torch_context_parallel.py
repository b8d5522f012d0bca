"""The torch package's context parallelism (paddle_operator_tpu_torch/
parallel/ring_attention.py, parallel/ulysses.py, the exchanges of
parallel/collectives.py, ``LlamaConfig.cp_impl`` and the cp train step)
held against the JAX package's, on the CPU.

- Primitive level: ``ring_attention`` and ``ulysses_attention`` over
  spawned gloo ranks (each holding its chunk of the sequence) against
  JAX's ``make_ring_attention_fn`` / ``make_ulysses_attention_fn`` on
  the conftest's 8 virtual devices (a cp × dp mesh, as
  tests/test_parallel_prims.py builds it): the output and the gradients
  of ``sum(out ** 2)`` in q, k and v, with and without causality, MHA
  and GQA, with and without packed ``segment_ids``, at cp 2 and 4
  (atol and rtol 2e-5, JAX's own bound against the dense reference).
  Ulysses on a rank whose kv heads cp does not divide (4 query, 2 kv
  heads at cp 4: JAX's model falls back to ring there) repeats each kv
  head within its group and equals JAX's ring; a rank whose query heads
  cp does not divide is refused by name.
- Train-step level: a TPUJob world of 8 ranks on ``cp2 × fsdp2 × tp2``
  (the launcher shim, ``initialize(device="cpu")``, ``job_mesh``,
  ``create_state(mesh=...)``, ``make_step_for_mesh``, ``fit`` over
  ``DevicePrefetcher(mesh=...)``, the sharded checkpoint), the tiny
  preset at f32 from the JAX init, with ``cp_impl`` "ring" and
  "ulysses" (the tiny preset's 4 and 2 heads: 2 and 1 a rank under tp
  2, so Ulysses repeats the kv head): three steps' losses and grad
  norms (rtol 1e-5) and the parameters after them (atol 1e-5) equal
  JAX's ``make_train_step`` on the same mesh, every rank's metrics are
  bit-equal, every parameter's placements are JAX's specs, and the
  eval step on the mesh equals the one-device eval of the saved step.

The worlds' helpers (:func:`traj_world`, :func:`jax_trajectory`) serve
tests/test_torch_pipeline.py too.
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

from paddle_operator_tpu.api.types import MeshSpec
from paddle_operator_tpu.models import llama as JL
from paddle_operator_tpu.parallel import mesh as JM
from paddle_operator_tpu.parallel.ring_attention import make_ring_attention_fn
from paddle_operator_tpu.parallel.ulysses import make_ulysses_attention_fn
from paddle_operator_tpu.train import trainer as JT
from paddle_operator_tpu_torch.convert import params_from_jax
from paddle_operator_tpu_torch.models import llama as TL
from paddle_operator_tpu_torch.parallel import ulysses as TU
from paddle_operator_tpu_torch.train import checkpoint as TC
from paddle_operator_tpu_torch.train import trainer as TT
from tests.test_torch_sharded_train import _world

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = RTOL = 2e-5
B, S, D = 2, 64, 16

PRIM_CHILD = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
from paddle_operator_tpu_torch.api.types import MeshSpec
from paddle_operator_tpu_torch.parallel.mesh import make_mesh
from paddle_operator_tpu_torch.parallel.ring_attention import (
    make_ring_attention_fn)
from paddle_operator_tpu_torch.parallel.ulysses import (
    make_ulysses_attention_fn)

a = json.load(open(sys.argv[1]))
rank, world = int(sys.argv[2]), a["world"]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{a['port']}",
                        world_size=world, rank=rank)
mesh = make_mesh(MeshSpec(cp=world), device="cpu")
data = np.load(a["inputs"])
out = {}
for c in a["cases"]:
    q, k, v = (torch.from_numpy(data[f"{c['heads']}_{x}"]) for x in "qkv")
    per = q.shape[1] // world
    sl = slice(rank * per, (rank + 1) * per)
    ql, kl, vl = (t[:, sl].clone().requires_grad_() for t in (q, k, v))
    seg = (torch.from_numpy(data["seg"])[:, sl].contiguous()
           if c["seg"] else None)
    make = make_ring_attention_fn if c["impl"] == "ring" \
        else make_ulysses_attention_fn
    o = make(mesh, causal=c["causal"])(ql, kl, vl, seg)
    (o ** 2).sum().backward()
    out[c["name"] + "_out"] = o.detach().numpy()
    for x, t in zip("qkv", (ql, kl, vl)):
        out[c["name"] + "_d" + x] = t.grad.numpy()
np.savez(f"{a['out']}/rank{rank}.npz", **out)
dist.destroy_process_group()
'''

# The train-step child: a rank of a TPUJob world (the launcher shim runs
# it), training each of ``runs`` in turn from the same init and saving
# its last step; a run with "more" then holds the pp checkpoint: steps
# on, a restore of the saved step and the same steps again, and a drain
# signalled on one rank.
TRAJ_CHILD = r'''
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
from paddle_operator_tpu_torch.ft.preemption import PreemptionWatcher
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
mesh = launcher.job_mesh(env, device="cpu")
rank = dist.get_rank()
out = {"rank": rank, "coords": PM.coordinates(mesh), "runs": {}}


def floats(hist):
    return [{k: float(v) for k, v in m.items()} for m in hist]


for run in a["runs"]:
    model, cfg = TL.make_model("tiny", device="cpu", dtype=torch.float32,
                               **run["model"])
    model.load_state_dict(torch.load(a["init"]))
    ndims = {n: p.ndim for n, p in model.named_parameters()}
    opt = TT.make_optimizer(1e-3, warmup_steps=1, decay_steps=100)
    sh = TT.state_shardings(model, opt, mesh)
    state = TT.create_state(model, opt, mesh=mesh)
    data = np.load(run["batches"])
    n = run["steps"]
    keys = run["keys"]
    rows = [TD.process_slice({k: data[f"{k}{i}"] for k in keys}, mesh=mesh)
            for i in range(n + run.get("more", 0) + run.get("drain", 0))]
    step = TT.make_step_for_mesh(opt, mesh, **run["step"])
    ckpt = TC.CheckpointManager(run["ckpt"], save_interval_steps=n)
    for k in C.EXCHANGE:
        C.EXCHANGE[k] = 0
    state, hist = TT.fit(state, step,
                         TD.DevicePrefetcher(iter(rows[:n]), mesh=mesh),
                         steps=n, checkpoint=ckpt)
    ckpt.wait()
    r = {"fit": floats(hist),
         "specs": {k: sh.spec(k, ndims[k]) for k in sh.params},
         "held": sorted(k for k, _ in state.model.named_parameters()),
         "exchange": dict(C.EXCHANGE),
         "eval": float(TT.make_eval_step(mesh)(
             state.model, PS.local_batch(rows[0], mesh, "cpu"))["loss"]),
         "batch_specs": [PS.spec_of(PS.batch_sharding(mesh, seq), mesh, 2)
                         for seq in (False, True)]}
    if run.get("more"):
        local = [PS.local_batch(b, mesh, "cpu") for b in rows]

        def steps_on(state, batches):
            got = []
            for b in batches:
                state, m = step(state, b)
                got.append(floats([m])[0])
            return state, got

        more = local[n:n + run["more"]]
        state, r["cont"] = steps_on(state, more)
        state = ckpt.restore(state, step=n)
        r["restored_step"] = state.step
        state, r["cont_again"] = steps_on(state, more)
        watcher = PreemptionWatcher()

        def drained():
            for i, b in enumerate(local[n + run["more"]:]):
                if i == 1 and rank == run["drain_rank"]:
                    watcher.trigger("injected")
                yield b

        state, hist = TT.fit(state, step, drained(), steps=len(local),
                             checkpoint=ckpt, preemption=watcher)
        r["drain"] = {"steps": len(hist), "step": state.step,
                      "draining": watcher.draining,
                      "all_steps": ckpt.all_steps()}
        r["drain_reason"] = watcher.reason
    out["runs"][run["name"]] = r
    del state, model

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


def spawn_gloo(tmp, child_src, world, args, timeout=240):
    """Run ``child_src`` on ``world`` gloo ranks of this host (argv: the
    args file, the rank); returns each rank's ``rank<r>.npz``."""
    out = tmp / "out"
    out.mkdir()
    child = tmp / "child.py"
    child.write_text(child_src)
    argf = tmp / "args.json"
    argf.write_text(json.dumps(dict(args, world=world, port=_free_port(),
                                    out=str(out))))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                             ""))
    procs = [subprocess.Popen([sys.executable, str(child), str(argf),
                               str(r)], env=env, cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    try:
        for r, p in enumerate(procs):
            _, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"rank {r} failed:\n{err[-4000:]}"
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]


def _jax_mesh(axes):
    spec = MeshSpec(**axes)
    return JM.make_mesh(spec, devices=jax.devices()[:spec.size()])


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

HEADS = {"mha": (4, 4), "gqa": (8, 4), "kv2": (4, 2)}


def _prim_inputs():
    rng = np.random.default_rng(23)
    arrs = {}
    for name, (h, hkv) in HEADS.items():
        arrs[f"{name}_q"] = rng.standard_normal((B, S, h, D), np.float32)
        arrs[f"{name}_k"] = rng.standard_normal((B, S, hkv, D), np.float32)
        arrs[f"{name}_v"] = rng.standard_normal((B, S, hkv, D), np.float32)
    # contiguous documents, three a row at random cuts
    cuts = np.sort(rng.integers(1, S, (B, 2)), axis=1)
    arrs["seg"] = (np.arange(S)[None, :, None] >= cuts[:, None, :]) \
        .sum(-1).astype(np.int32)
    return arrs


def _cases(cp):
    cases = [{"name": f"{impl}_{'causal' if causal else 'full'}_{heads}"
                      f"{'_seg' if seg else ''}",
              "impl": impl, "causal": causal, "heads": heads, "seg": seg}
             for impl in ("ring", "ulysses") for causal in (True, False)
             for heads in ("mha", "gqa") for seg in (False, True)]
    if cp == 4:
        cases.append({"name": "ulysses_repeat_kv", "impl": "ulysses",
                      "causal": True, "heads": "kv2", "seg": True})
    return cases


@pytest.fixture(scope="module")
def prim_worlds(tmp_path_factory):
    """cp -> (inputs, the port's outputs and gradients made whole), one
    spawned world a cp, made when a test first asks for it."""
    worlds = {}

    def get(cp):
        if cp not in worlds:
            tmp = tmp_path_factory.mktemp(f"cp{cp}_prims")
            arrs = _prim_inputs()
            np.savez(tmp / "inputs.npz", **arrs)
            res = spawn_gloo(tmp, PRIM_CHILD, cp,
                             {"inputs": str(tmp / "inputs.npz"),
                              "cases": _cases(cp)})
            # the ranks' chunks, whole again
            worlds[cp] = arrs, {k: np.concatenate([r[k] for r in res],
                                                  axis=1) for k in res[0]}
        return worlds[cp]

    return get


def _jax_attention(cp, impl, causal, q, k, v, seg):
    """JAX's output and the gradients of sum(out ** 2) in q, k, v."""
    mesh = _jax_mesh({"cp": cp, "dp": 8 // cp})
    make = make_ring_attention_fn if impl == "ring" \
        else make_ulysses_attention_fn
    fn = make(mesh, causal=causal)

    def loss(q, k, v):
        out = fn(q, k, v) if seg is None else fn(q, k, v, seg)
        return (out ** 2).sum(), out

    with mesh:
        (_, out), grads = jax.jit(jax.value_and_grad(
            loss, argnums=(0, 1, 2), has_aux=True))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("cp,case", [(cp, c["name"]) for cp in (2, 4)
                                     for c in _cases(cp)])
def test_attention_matches_jax(prim_worlds, cp, case):
    arrs, got = prim_worlds(cp)
    c = {x["name"]: x for x in _cases(cp)}[case]
    q, k, v = (jnp.asarray(arrs[f"{c['heads']}_{x}"]) for x in "qkv")
    seg = jnp.asarray(arrs["seg"]) if c["seg"] else None
    # kv heads cp does not split: JAX's model runs ring there, and
    # Ulysses with repeated kv heads must equal it
    impl = "ring" if c["heads"] == "kv2" else c["impl"]
    out, grads = _jax_attention(cp, impl, c["causal"], q, k, v, seg)
    np.testing.assert_allclose(got[case + "_out"], out, atol=ATOL,
                               rtol=RTOL)
    for x, g in zip("qkv", grads):
        np.testing.assert_allclose(got[case + "_d" + x], g, atol=ATOL,
                                   rtol=RTOL, err_msg=f"d{x}")


def test_ulysses_refuses_heads_cp_does_not_split():
    assert TU.kv_repeat(4, 2, 4) == 2 and TU.kv_repeat(2, 1, 2) == 2
    assert TU.kv_repeat(8, 4, 2) == 1
    with pytest.raises(NotImplementedError, match="query heads"):
        TU.kv_repeat(2, 2, 4)


def test_cp_attention_dispatch_is_jax_rule():
    cfg = TL.CONFIGS["tiny"]                     # 4 heads, 2 kv heads
    uly = TL.LlamaConfig(**{**cfg.__dict__, "cp_impl": "ulysses"})
    assert TL.cp_attention(cfg, 2) == "ring"
    assert TL.cp_attention(uly, 2) == "ulysses"
    assert TL.cp_attention(uly, 4) == "ring"     # 2 kv heads over 4
    bad = TL.LlamaConfig(**{**cfg.__dict__, "cp_impl": "spiral"})
    with pytest.raises(ValueError, match="unknown cp_impl 'spiral'"):
        TL.cp_attention(bad, 2)
    # what the layer would refuse at its first call, refused up front
    with pytest.raises(NotImplementedError, match="query heads"):
        TL.check_cp(uly, 2, 4)


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

TRAJ_B, TRAJ_S, STEPS = 8, 33, 3


def traj_batches(n, *, mask=False, packed=False, seed=0):
    """``n`` global batches of ``TRAJ_B`` x ``TRAJ_S`` tokens (JAX's
    ``synthetic_batch``), with a ragged padding mask (JAX
    ``test_masked_batches_match_gspmd_both_schedules``) or packed
    ``segment_ids`` (``test_packed_sequences_match_gspmd_both_schedules``)
    when asked."""
    out = []
    for i in range(n):
        b = {"tokens": np.asarray(JT.synthetic_batch(
            TRAJ_B, TRAJ_S, 256, seed=seed + i)["tokens"])}
        if mask:
            lens = 4 + np.random.default_rng(100 + i).integers(
                0, TRAJ_S - 5, TRAJ_B)
            b["mask"] = (np.arange(TRAJ_S)[None, :] < lens[:, None]) \
                .astype(np.float32)
        if packed:
            b["segment_ids"] = np.repeat(
                (np.arange(TRAJ_S)[None, :] >= 5 + 3 * i).astype(np.int32),
                TRAJ_B, 0)
        out.append(b)
    return out


def jax_trajectory(axes, batches, *, model_kw=None, num_microbatches=4,
                   schedule="gpipe"):
    """JAX's step for the mesh ``axes`` (``make_step_for_mesh``: the pp
    step when pp > 1) over ``batches`` at f32: (init params, each step's
    metrics, the params after them, the params' specs by the port's
    names)."""
    mesh = _jax_mesh(axes)
    model, cfg = JL.make_model("tiny", mesh=mesh, dtype=jnp.float32,
                               **(model_kw or {}))
    opt = JT.make_optimizer(1e-3, warmup_steps=1, decay_steps=100)
    pats = JL.partition_patterns(cfg)
    ex = (jnp.zeros((TRAJ_B, 8), jnp.int32),)
    shardings, _ = JT.state_shardings(model, opt, mesh, pats, ex)
    state = JT.create_state(model, opt, mesh, pats, ex)
    init = jax.device_get(state.params)
    step = JT.make_step_for_mesh(model, cfg, opt, mesh, shardings,
                                 num_microbatches=num_microbatches,
                                 schedule=schedule)
    metrics = []
    for b in batches:
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    specs = {}
    for path, s in jax.tree_util.tree_flatten_with_path(
            shardings.params)[0]:
        keys = [p.key for p in path]
        if keys[0] == "layers":
            for i in range(cfg.n_layers):
                specs[f"layers.{i}." + ".".join(keys[1:])] = tuple(s.spec)
        else:
            specs[".".join(keys)] = tuple(s.spec)
    return init, metrics, jax.device_get(state.params), specs


def traj_world(tmp, name, axes, init, runs):
    """A TPUJob world of one slice on the mesh ``axes`` through the
    launcher shim, running TRAJ_CHILD over ``runs`` (name, batches,
    model overrides, step options; each saves its last step under
    ``tmp/<name>``).  Returns the ranks' results."""
    world = int(np.prod(list(axes.values())))
    torch.save(init, tmp / f"{name}-init.pt")
    specs = []
    for r in runs:
        np.savez(tmp / f"{name}-{r['name']}.npz",
                 **{f"{k}{i}": v for i, b in enumerate(r["batches"])
                    for k, v in b.items()})
        spec = {k: v for k, v in r.items() if k != "batches"}
        spec.update(batches=str(tmp / f"{name}-{r['name']}.npz"),
                    keys=sorted(r["batches"][0]), steps=STEPS,
                    ckpt=str(tmp / f"{name}-ckpt-{r['name']}"))
        specs.append(spec)
    res, _ = _world(tmp, name, 1, world, MeshSpec(**axes),
                    {"init": str(tmp / f"{name}-init.pt"), "runs": specs},
                    child_src=TRAJ_CHILD, timeout=300)
    return res


def check_run(res, name, want_metrics, want_final, want_specs, axes, ckpt):
    """A run of a world against JAX's: the trajectory (losses and grad
    norms rtol 1e-5, the saved params atol 1e-5), bit-equal metrics on
    every rank, JAX's specs, the eval on the mesh equal to the saved
    step's eval on one device."""
    runs = [r["runs"][name] for r in res]
    fits = [json.dumps(r["fit"], sort_keys=True) for r in runs]
    assert len(set(fits)) == 1, fits
    got = runs[0]["fit"]
    assert len(got) == len(want_metrics)
    for g, w in zip(got, want_metrics):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
        assert g["tokens"] == w["tokens"]
    saved = torch.load(ckpt / str(STEPS) / TC.PARAMS_FILE,
                       weights_only=True)
    want = params_from_jax(want_final)
    assert set(saved) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(saved[k].numpy(), v.numpy(), rtol=0,
                                   atol=1e-5, err_msg=k)
    pp = axes.get("pp", 1)
    for k, spec in runs[0]["specs"].items():
        spec = tuple(tuple(e) if isinstance(e, list) else e for e in spec)
        jspec = want_specs[k]
        if TL.layer_index(k) is not None and pp == 1:
            jspec = jspec[1:]          # the unsharded stacked layers dim
        assert spec == jspec, (k, spec, jspec)
    # a rank holds its stage's layers and every replicated parameter
    for r, run in zip(res, runs):
        layers = {TL.layer_index(k) for k in run["held"]} - {None}
        stage = r["coords"]["pp"]
        per = TL.CONFIGS["tiny"].n_layers // pp
        assert layers == set(range(stage * per, (stage + 1) * per))
    evals = {r["eval"] for r in runs}
    assert len(evals) == 1
    return runs


def one_card_eval(ckpt, batch, **model_kw):
    """The saved step's params on one CPU device: the eval loss of
    ``batch``."""
    model, _ = TL.make_model("tiny", device="cpu", dtype=torch.float32,
                             **model_kw)
    TC.CheckpointManager(str(ckpt)).restore(model, step=STEPS)
    return float(TT.make_eval_step()(
        model, {k: torch.as_tensor(v.copy()) for k, v in batch.items()
                if k in ("tokens", "mask")})["loss"])


@pytest.fixture(scope="module")
def cp_world(tmp_path_factory):
    """cp2 × fsdp2 × tp2, ring then Ulysses, against JAX on the same
    mesh."""
    tmp = tmp_path_factory.mktemp("cp2_fsdp2_tp2")
    axes = {"cp": 2, "fsdp": 2, "tp": 2}
    batches = traj_batches(STEPS)
    want = {impl: jax_trajectory(axes, batches,
                                 model_kw={"cp_impl": impl})
            for impl in ("ring", "ulysses")}
    init = params_from_jax(want["ring"][0])
    runs = [{"name": impl, "batches": batches,
             "model": {"cp_impl": impl}, "step": {}}
            for impl in ("ring", "ulysses")]
    res = traj_world(tmp, "cp", axes, init, runs)
    return {"res": res, "want": want, "tmp": tmp, "axes": axes,
            "batches": batches}


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_cp_train_step_matches_jax(cp_world, impl):
    _, metrics, final, specs = cp_world["want"][impl]
    ckpt = cp_world["tmp"] / f"cp-ckpt-{impl}"
    runs = check_run(cp_world["res"], impl, metrics, final, specs,
                     cp_world["axes"], ckpt)
    np.testing.assert_allclose(
        runs[0]["eval"],
        one_card_eval(ckpt, cp_world["batches"][0]), rtol=1e-5)
    # batch_sharding with and without the sequence over cp: JAX's specs
    from paddle_operator_tpu.parallel import sharding as JS
    jmesh = _jax_mesh(cp_world["axes"])
    want_specs = [tuple(JS.batch_sharding(jmesh, 1, seq).spec)
                  for seq in (False, True)]
    for r in runs:
        got = [tuple(tuple(e) if isinstance(e, list) else e for e in sp)
               for sp in r["batch_specs"]]
        assert got == want_specs, (got, want_specs)
    ex = runs[0]["exchange"]
    if impl == "ring":
        assert ex["shift"] > 0 and ex["a2a"] == 0
    else:
        assert ex["a2a"] > 0 and ex["shift"] == 0
    assert not any(r["jax_imported"] for r in cp_world["res"])
