"""The torch package's int8 moments and moment offload on a mesh
(ROADMAP.md Queue A item 8.3: parallel/sharding.py ``q8_spec`` /
``q8_layout``, train/trainer.py ``AdamW8bit`` on a mesh and
``MomentOffload`` per rank, train/checkpoint.py's int8 shard files,
ft/elastic.py) held against the JAX package's sharded step
(``make_step_for_mesh`` on the same mesh over the conftest's virtual CPU
devices, computed in this process while the ranks train), in worlds of
spawned gloo ranks, each rank started through the port's launcher shim
with the env of the JAX ``controller/builders.py``.

The widened ``tiny`` (dim 512, 8 heads over 4 kv heads, ffn 1000, vocab
768, 2 layers, f32) puts every one of the three alignment cases on
fsdp2 × tp2: ``wq``, ``wo``, ``w2``, the norms and the embedding are
aligned, ``wk``, ``wv`` (one block) and ``lm_head`` (384 columns of 3
blocks) replicate their blocks, ``w1`` and ``w3`` (500 columns against
2 of 4 blocks) are not aligned.  ``tiny``'s own widths fit one block.

- World A, 4 ranks (a dp4 elastic TPUJob of 4 one-worker slices):
  fsdp2 × tp2 int8 (a checkpoint of step 3, two steps on, its restore
  on the mesh and the same two steps again), the same with offload,
  dp2 × fsdp2 int8, pp2 × tp2 int8 under 1F1B, dp2 × fsdp2 f32 with
  offload, the step-3 checkpoint restored on dp2 × tp2, and the dp4
  int8 run of the elastic test (tiny).
- World B, 8 ranks: JAX's own dp4 × fsdp2 at ``tiny``
  (tests/test_opt8bit.py ``TestTraining``), int8 and int8 + offload.
- World C, 2 ranks: the dp2 gang of the operator's elastic clamp
  resumes the dp4 int8 step through ``elastic_resume``.

Tolerances.  The 3-step trajectory's losses and grad norms are held
to tests/test_torch_opt8bit.py's ``RTOL``.  Codes, scales and
parameters are held ONE STEP at a time: each rank restarts from JAX's
state after step k - 1 (its regions of JAX's parameters and moments)
and takes step k, so no earlier rounding reaches the comparison.  On a
mesh the rounding compounds: JAX's own fsdp2 × tp2 and dp2 × fsdp2 runs
of this model differ from its one-device run by up to 3 codes, 1.6% of
the codes and 1.4e-3 in a parameter after three steps (measured on the
CPU), because each reorders its f32 reductions.  One step: codes within
one of JAX's, at most ``CODE_FLIPS`` of them off (a moment on a code's
midpoint rounds either way); scales ``TRAJ_SCALE_RTOL``; parameters
within ``FLIP_ATOL``, and within ``ATOL_PARAMS`` except under a code
that came out one off and at most ``PARAM_OUTLIERS`` of the rest (an
element whose summed gradient cancels: one embedding element of
5,356,800 on dp2 × fsdp2 moved 2.1e-5 off JAX's).  f32 offload: rtol
and atol 1e-5 (tests/test_offload.py) on the trajectory, and the
resident run bit for bit; the elastic resume rtol 2e-4, atol 2e-5
(tests/test_ft_elastic.py).  Every rank's metrics, and the regions that
several ranks hold, are bit-equal; an offloaded run equals its resident
run bit for bit.
"""

import itertools
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
from paddle_operator_tpu.train import trainer as JT
from paddle_operator_tpu.train.data import (deterministic_lm_batches as
                                            jax_lm_batches)
from paddle_operator_tpu_torch.convert import (opt_state_from_jax,
                                               params_from_jax)
from paddle_operator_tpu_torch.models import llama as TL
from paddle_operator_tpu_torch.parallel import sharding as PS
from paddle_operator_tpu_torch.train import checkpoint as TC
from paddle_operator_tpu_torch.train import opt8bit as Q8
from paddle_operator_tpu_torch.train import trainer as TT
from tests.test_torch_elastic import (ATOL_E, GB, RTOL_E, SEED, SEQ, SPLIT,
                                      TOTAL, _elastic_job)
from tests.test_torch_opt8bit import (ATOL_PARAMS, FLIP_ATOL, RTOL,
                                      TRAJ_SCALE_RTOL)
from tests.test_torch_sharded_train import (REPO, _free_port, _jax_mesh,
                                            _pod_env)

WIDE = dict(dim=512, n_heads=8, n_kv_heads=4, ffn_dim=1000, vocab_size=768)
CODE_FLIPS = 1e-4               # codes one off JAX's, at most this share
PARAM_OUTLIERS = 1e-4           # parameters past ATOL_PARAMS, not flipped
F32_TOL = 1e-5                  # tests/test_offload.py
B_W, S_W, STEPS, MORE = 4, 17, 3, 2
B_T, S_T = 8, 17                # tests/test_opt8bit.py TestTraining's

CHILD = r'''
import json, os, sys, time
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
from paddle_operator_tpu_torch.ft.elastic import elastic_resume
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
inits = {k: torch.load(v) for k, v in a["inits"].items()}
out = {"rank": rank, "world": dist.get_world_size(),
       "mesh": env.mesh.to_dict(), "runs": {}}
tensors = {}


def fresh(run, mesh):
    model, _ = TL.make_model("tiny", device="cpu", dtype=torch.float32,
                             **run["model"])
    model.load_state_dict(inits[run["init"]])
    opt = TT.make_optimizer(run["lr"], warmup_steps=run["warmup"],
                            decay_steps=run["decay"], moments=run["moments"])
    ndims = {n: p.ndim for n, p in model.named_parameters()}
    sh = TT.state_shardings(model, opt, mesh)
    state = TT.create_state(model, opt, mesh=mesh,
                            offload_opt_state=run.get("offload", False))
    return state, opt, sh, ndims


def snap(state):
    return {f: {k: t.detach().clone() for k, t in ts.items()}
            for f, ts in state.opt_state.tensors().items()}


def regions(state):
    o = state.opt_state
    return {f"{f}/{k}": [list(o.layout[k].field(f)[0]),
                         [[s.start, s.stop] for s in o.layout[k].field(f)[2]]]
            for f, ts in o.tensors().items() for k in ts}


def param_regions(state):
    return {f"params/{k}": [list(p.shape), [[s.start, s.stop] for s in
                                            PS.local_slices(
                                                p.shape, p.device_mesh,
                                                p.placements)]]
            for k, p in state.model.named_parameters()}


def param_snap(state):
    return {"params": {k: PS.to_local(p).detach().clone()
                       for k, p in state.model.named_parameters()}}


def wait_for(path, timeout=600):
    deadline = time.time() + timeout
    while not os.path.exists(path):
        if time.time() > deadline:
            raise TimeoutError(path)
        time.sleep(0.1)
    return torch.load(path, weights_only=True)


def inject(state, saved):
    """JAX's state after a step (whole tensors): this rank's regions of
    the parameters and the moments, the count and the step."""
    o = state.opt_state
    with torch.no_grad():
        for k, p in state.model.named_parameters():
            sl = PS.local_slices(p.shape, p.device_mesh, p.placements)
            PS.to_local(p).copy_(saved["params"][k][sl])
        for f, ts in o.tensors().items():
            for k, t in ts.items():
                t.copy_(saved["opt"][f][k][o.layout[k].field(f)[2]])
    o.count = state.step = saved["count"]


def in_slab(state):
    """Every moment tensor a view of the offload's host slab."""
    o = state.opt_state
    slab = o.offload._slab
    lo = slab.data_ptr()
    hi = lo + slab.numel()
    return all(t.device.type == "cpu" and lo <= t.data_ptr() < hi
               for ts in o.tensors().values() for t in ts.values())


def ptrs(state):
    return [t.data_ptr() for ts in state.opt_state.tensors().values()
            for t in ts.values()]


def rows(run, mesh, i):
    data = np.load(run["batches"])
    b = {"tokens": data[f"b{i}"]}
    return PS.local_batch(TD.process_slice(b, mesh=mesh), mesh, "cpu")


def floats(m):
    return {k: float(v) for k, v in m.items()}


for run in a["runs"]:
    mesh = job if not run.get("axes") else PM.make_mesh(
        PM.MeshSpec(**run["axes"]), device="cpu")
    int8 = run["moments"] == "int8"
    r = {}
    if run["kind"] == "train":
        state, opt, sh, ndims = fresh(run, mesh)
        step = TT.make_step_for_mesh(opt, mesh, **run.get("step", {}))
        for k in C.EXCHANGE:
            C.EXCHANGE[k] = 0
        metrics, snaps, host = [], [], []
        for i in range(run["steps"]):
            state, m = step(state, rows(run, mesh, i))
            metrics.append(floats(m))
            if int8:
                snaps.append(snap(state))
            if run.get("offload"):
                host.append(in_slab(state))
        r.update(metrics=metrics, host=host,
                 exchange={k: v / run["steps"]
                           for k, v in C.EXCHANGE.items()})
        ckpt = TC.CheckpointManager(run["ckpt"])
        ckpt.save(run["steps"], state, force=True)
        ckpt.wait()
        if int8:
            STAGE = PM.STAGE_AXES
            r["cases"] = {k: l.case for k, l in state.opt_state.layout.items()}
            r["q8_specs"] = {
                f: {k: PS.spec_of(pl, STAGE if k in sh.stages else mesh,
                                  ndims[k] + 1)
                    for k, pl in by.items()}
                for f, by in sh.opt_state.items()}
            tensors[run["name"]] = {"snaps": snaps,
                                    "regions": regions(state)}
        if run.get("more"):
            more = []
            for i in range(run["steps"], run["steps"] + run["more"]):
                state, m = step(state, rows(run, mesh, i))
                more.append(floats(m))
            after = snap(state)
            again_state = fresh(run, mesh)[0]
            ckpt.restore(again_state, step=run["steps"])
            r["restored_step"] = again_state.step
            again = []
            for i in range(run["steps"], run["steps"] + run["more"]):
                again_state, m = step(again_state, rows(run, mesh, i))
                again.append(floats(m))
            r.update(more=more, again=again, again_bits=all(
                torch.equal(after[f][k], t)
                for f, ts in snap(again_state).items()
                for k, t in ts.items()))
        if run.get("restore_from"):
            # an offloaded restore writes into the host slab in place
            before = ptrs(state)
            TC.CheckpointManager(run["restore_from"]).restore(
                state, step=run["steps"])
            r["restore_in_slab"] = in_slab(state) and ptrs(state) == before
            tensors[run["name"]]["restored"] = snap(state)
        if run.get("elastic_more"):
            losses = [m["loss"] for m in metrics]
            for i in range(run["steps"], run["steps"] + run["elastic_more"]):
                state, m = step(state, rows(run, mesh, i))
                losses.append(float(m["loss"]))
            r["losses"] = losses
    elif run["kind"] == "onestep":
        # each step k from JAX's state after step k - 1 (step 1 from the
        # init), so that no earlier step's rounding reaches it
        state, opt, _, _ = fresh(run, mesh)
        step = TT.make_step_for_mesh(opt, mesh, **run.get("step", {}))
        saved = wait_for(run["jax"])
        one = []
        for i in range(run["steps"]):
            if i:
                inject(state, saved[i - 1])
            state, m = step(state, rows(run, mesh, i))
            one.append(dict(snap(state), **param_snap(state)))
        r["count"] = state.opt_state.count
        tensors[run["name"]] = {"snaps": one, "regions": dict(
            regions(state), **param_regions(state))}
    elif run["kind"] == "restore":
        state = fresh(run, mesh)[0]
        TC.CheckpointManager(run["ckpt"]).restore(state, step=run["step"])
        r["step"] = state.step
        tensors[run["name"]] = {"snaps": [snap(state)],
                                "regions": regions(state)}
    else:
        # the smaller gang of the elastic clamp resumes the newest step
        def init_fn():
            return fresh(run, mesh)[0]

        state, resumed, plan = elastic_resume(
            TC.CheckpointManager(run["ckpt"]), init_fn,
            saved_global_batch=run["gb"], global_batch=run["gb"])
        step = TT.make_step_for_mesh(TT.make_optimizer(
            run["lr"], warmup_steps=run["warmup"], decay_steps=run["decay"],
            moments=run["moments"]), mesh)
        losses = []
        for i in range(plan["data_start_step"], run["total"]):
            state, m = step(state, rows(run, mesh, i))
            losses.append(float(m["loss"]))
        r.update(resumed=resumed, plan=plan, losses=losses,
                 count=state.opt_state.count)
    out["runs"][run["name"]] = r

out["jax_imported"] = any(m.split(".")[0] in ("jax", "paddle_operator_tpu")
                          for m in sys.modules)
torch.save(tensors, os.path.join(a["out"], f"rank{rank}.pt"))
with open(os.path.join(a["out"], f"rank{rank}.json"), "w") as f:
    json.dump(out, f)
dist.destroy_process_group()
'''


class _Launch:
    """The pods of ``job`` (its first ``live``) running CHILD through the
    port's launcher shim with the env of ``construct_pod`` /
    ``construct_configmap``; started at once, collected by ``finish``."""

    def __init__(self, tmp, name, job, live, args, timeout=400):
        pods = []
        for i in range(live):
            pod = B.construct_pod(job, "worker", i)
            pod["status"] = {"podIP": f"127.0.0.{i + 1}"}
            pods.append(pod)
        self.cm = B.construct_configmap(job, pods)
        self.out = tmp / f"{name}-out"
        self.out.mkdir()
        child = tmp / f"{name}-child.py"
        child.write_text(CHILD)
        argf = tmp / f"{name}.json"
        argf.write_text(json.dumps(dict(args, out=str(self.out))))
        self.live, self.timeout = live, timeout
        self.procs = [subprocess.Popen(
            [sys.executable, "-m", "paddle_operator_tpu_torch.launch.launcher",
             "--", sys.executable, str(child), str(argf)],
            env=_pod_env(self.cm, pod), cwd=REPO, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for pod in pods]

    def finish(self):
        try:
            for i, p in enumerate(self.procs):
                _, err = p.communicate(timeout=self.timeout)
                assert p.returncode == 0, f"rank {i} failed:\n{err[-4000:]}"
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        res = [json.loads((self.out / f"rank{r}.json").read_text())
               for r in range(self.live)]
        tens = [torch.load(self.out / f"rank{r}.pt", weights_only=True)
                for r in range(self.live)]
        return res, tens


def _slice_job(name, port, workers, mesh):
    tmpl = {"spec": {"containers": [{"name": "m", "image": "i"}]}}
    job = TPUJob(name=name, spec=TPUJobSpec(
        intranet=Intranet.HOST,
        worker=ResourceSpec(replicas=workers, template=tmpl),
        tpu=TPUSpec(topology=f"1x{workers}", slice_count=1,
                    chips_per_worker=1),
        mesh=mesh))
    job.annotations[HOSTPORT_ANNOTATION] = str(port)
    assert job.validate() == []
    return job


def _batches(n, b, s, vocab, seed):
    return [np.random.default_rng([seed, i]).integers(
        0, vocab, (b, s), dtype=np.int32) for i in range(n)]


def _save_batches(path, batches):
    np.savez(path, **{f"b{i}": b for i, b in enumerate(batches)})
    return str(path)


def _jax_q8_specs(sh, cfg):
    """name -> spec of JAX's ``tree_shardings`` for the codes and the
    scales of the Adam8bit state (a layer's stacked dim first)."""
    adam = sh.opt_state[1][0]
    out = {}
    for moment in ("mu", "nu"):
        for path, s in jax.tree_util.tree_flatten_with_path(
                getattr(adam, moment))[0]:
            keys = [str(getattr(p, "key", getattr(p, "name", p)))
                    for p in path]
            field = moment + ("_codes" if keys[-1] == "q8_codes"
                              else "_scales")
            keys = keys[:-1]
            spec = tuple(s.spec)
            if keys[0] == "layers":
                for i in range(cfg.n_layers):
                    name = f"layers.{i}." + ".".join(keys[1:])
                    out.setdefault(field, {})[name] = spec
            else:
                out.setdefault(field, {})[".".join(keys)] = spec
    return out


def _jax_run(axes, model_kw, moments, batches, *, lr=1e-3, warmup=1,
             decay=100, step_kw=None, rows=8):
    """JAX's step on the mesh ``axes``: init params, each step's metrics,
    (params, opt_state) after each step, and the q8 leaves' specs (the
    stacked layers' leading entry apart)."""
    mesh = _jax_mesh(axes)
    model, cfg = JL.make_model("tiny", mesh=mesh, dtype=jnp.float32,
                               **model_kw)
    opt = JT.make_optimizer(lr, warmup_steps=warmup, decay_steps=decay,
                            moments=moments)
    pats = JL.partition_patterns(cfg)
    ex = (jnp.zeros((rows, 8), jnp.int32),)
    sh, _ = JT.state_shardings(model, opt, mesh, pats, ex)
    state = JT.create_state(model, opt, mesh, pats, ex)
    step = JT.make_step_for_mesh(model, cfg, opt, mesh, sh,
                                 **(step_kw or {}))
    out = {"init": jax.device_get(state.params), "metrics": [],
           "states": []}
    for b in batches:
        state, m = step(state, {"tokens": jnp.asarray(b)})
        out["metrics"].append({k: float(v) for k, v in m.items()})
        out["states"].append(jax.device_get((state.params,
                                             state.opt_state)))
    if moments == "int8":
        specs = {}
        layers = _jax_q8_specs(sh, cfg)
        for f, by in layers.items():
            specs[f] = {k: (v[1:] if k.startswith("layers.") else v)
                        for k, v in by.items()}
            specs[f + "/lead"] = {k: v[0] for k, v in by.items()
                                  if k.startswith("layers.")}
        out["q8_specs"] = specs
    return out


def _jax_init(model_kw):
    return _jax_run({"dp": 1}, model_kw, "f32", [])["init"]


def _assemble(tens, name, which=None, step=-1):
    """The global tensors of run ``name`` from every rank's regions (of
    step ``step``, or of the snapshot ``which``); regions that several
    ranks hold must be bit-equal."""
    whole, seen = {}, {}
    for t in tens:
        if name not in t:
            continue
        snap = t[name][which] if which else t[name]["snaps"][step]
        for f, ts in snap.items():
            for k, v in ts.items():
                shape, reg = t[name]["regions"][f"{f}/{k}"]
                if k not in whole.setdefault(f, {}):
                    whole[f][k] = torch.zeros(shape, dtype=v.dtype)
                    seen.setdefault(f, {})[k] = torch.zeros(shape,
                                                            dtype=torch.bool)
                sl = tuple(slice(a, b) for a, b in reg)
                mask = seen[f][k][sl]
                assert torch.equal(whole[f][k][sl][mask], v[mask]), (f, k)
                whole[f][k][sl] = v
                seen[f][k][sl] = True
    for f, by in seen.items():
        for k, m in by.items():
            assert bool(m.all()), (f, k)
    return whole


def _same_metrics(res, run, key="metrics"):
    vals = {json.dumps(r["runs"][run][key]) for r in res}
    assert len(vals) == 1, vals


def _jax_reference_file(path, want):
    """JAX's state after each step but the last (whole tensors under the
    port's names), written for the ranks' one-step runs."""
    saved = [{"params": params_from_jax(p),
              "opt": opt_state_from_jax(o).tensors(), "count": k + 1}
             for k, (p, o) in enumerate(want["states"][:-1])]
    torch.save(saved, str(path) + ".tmp")
    os.replace(str(path) + ".tmp", path)
    return str(path)


def _trajectory_like_jax(res, run, want):
    """Every rank's metrics bit-equal, and JAX's within ``RTOL``."""
    _same_metrics(res, run)
    got = res[0]["runs"][run]["metrics"]
    assert len(got) == len(want["metrics"])
    for g, w in zip(got, want["metrics"]):
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(g[k], w[k], rtol=RTOL, err_msg=k)
        assert g["tokens"] == w["tokens"]


def _one_step_like_jax(tens, run, want):
    """Each step of run ``run`` taken from JAX's state before it (the
    ranks' ``onestep`` run) against JAX's state after it: codes within
    one, at most ``CODE_FLIPS`` of them off; scales ``TRAJ_SCALE_RTOL``;
    parameters within ``FLIP_ATOL``, and within ``ATOL_PARAMS`` but
    under a code that came out one off and at most ``CODE_FLIPS`` of
    the others (``PARAM_OUTLIERS``).  Rank 0's region of every moment
    is ``opt_state_from_jax`` of JAX's tree cut to it.  Returns (codes
    off, codes)."""
    off = total = outliers = elements = 0
    for i, (jparams, jopt) in enumerate(want["states"]):
        mine = _assemble(tens, run, step=i)
        theirs = opt_state_from_jax(jopt).tensors()
        flipped = {}
        for f, by in theirs.items():
            for k, t in by.items():
                g = mine[f][k]
                if f.endswith("scales"):
                    np.testing.assert_allclose(g.numpy(), t.numpy(),
                                               rtol=TRAJ_SCALE_RTOL,
                                               err_msg=f"{i} {f} {k}")
                    continue
                diff = (g.int() - t.int()).abs()
                assert int(diff.max()) <= 1, (i, f, k)
                off += int((diff != 0).sum())
                total += diff.numel()
                shape = mine["params"][k].shape
                flip = Q8._from_blocks((g != t).float(), shape,
                                       torch.float32) > 0
                flipped[k] = flipped.get(k, flip) | flip
        for k, v in params_from_jax(jparams).items():
            diff = (mine["params"][k] - v).abs()
            assert float(diff.max()) <= FLIP_ATOL, (i, k)
            outliers += int((diff[~flipped[k]] > ATOL_PARAMS).sum())
            elements += diff.numel()
        # rank 0's regions, converted from JAX's tree by the port
        regs = tens[0][run]["regions"]

        def cut(field, name):
            reg = regs.get(f"{field}/{name}")
            return None if reg is None else tuple(
                slice(a, b) for a, b in reg[1])

        local = opt_state_from_jax(jopt, cut=cut).tensors()
        for f, by in tens[0][run]["snaps"][i].items():
            for k, v in by.items():
                if f != "params":
                    assert torch.equal(local[f][k], theirs[f][k][cut(f, k)])
    assert off <= CODE_FLIPS * total, (off, total)
    assert outliers <= PARAM_OUTLIERS * elements, (outliers, elements)
    return off, total


def _saved_params(path, step):
    return torch.load(os.path.join(path, str(step), TC.PARAMS_FILE),
                      weights_only=True)


def _saved_moments(path, step):
    """Every entry of a sharded step's shard files, by file."""
    d = os.path.join(path, str(step))
    opt = torch.load(os.path.join(d, TC.OPT_FILE), weights_only=True)
    return {name: torch.load(os.path.join(d, name), weights_only=True)
            for name in opt["sharded"]["files"]}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The comparisons of this process on one thread: beside the spawned
    ranks (and other test files' ranks under xdist) a pool of threads a
    core ran the same tensor work some hundred times slower."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("int8_mesh")
    wide_init = _jax_init(WIDE)
    tiny_init = _jax_init({})
    inits = {"wide": tmp / "wide.pt", "tiny": tmp / "tiny.pt"}
    torch.save(params_from_jax(wide_init), inits["wide"])
    torch.save(params_from_jax(tiny_init), inits["tiny"])
    wide_b = _save_batches(tmp / "wide.npz",
                           _batches(STEPS + MORE, B_W, S_W, 768, 5))
    tiny_b = [np.asarray(JT.synthetic_batch(B_T, S_T, 256, seed=i)["tokens"])
              for i in range(STEPS)]
    tiny_bp = _save_batches(tmp / "tiny.npz", tiny_b)
    el_b = [b["tokens"] for b in itertools.islice(
        jax_lm_batches(GB, SEQ, 256, seed=SEED), TOTAL)]
    el_bp = _save_batches(tmp / "elastic.npz", el_b)
    ck = {k: str(tmp / f"ckpt-{k}") for k in (
        "fstp", "fstp_off", "dpfs", "pptp", "f32res", "f32off", "elastic",
        "b8", "b8_off")}
    ref = {k: str(tmp / f"jax-{k}.pt") for k in ("fstp", "dpfs", "pptp",
                                                  "b8")}
    wide = {"init": "wide", "model": WIDE, "lr": 1e-3, "warmup": 1,
            "decay": 100, "batches": wide_b, "steps": STEPS}
    fstp = dict(wide, moments="int8", axes={"fsdp": 2, "tp": 2})
    dpfs = dict(wide, moments="int8", axes={"dp": 2, "fsdp": 2})
    pptp = dict(wide, moments="int8", axes={"pp": 2, "tp": 2},
                step={"schedule": "1f1b", "num_microbatches": 2})
    runs_a = [
        dict(fstp, name="fstp", kind="train", ckpt=ck["fstp"], more=MORE),
        dict(fstp, name="fstp_off", kind="train", ckpt=ck["fstp_off"],
             offload=True, restore_from=ck["fstp"]),
        dict(dpfs, name="dpfs", kind="train", ckpt=ck["dpfs"]),
        dict(pptp, name="pptp", kind="train", ckpt=ck["pptp"]),
        dict(wide, name="f32res", kind="train", moments="f32",
             axes={"dp": 2, "fsdp": 2}, ckpt=ck["f32res"]),
        dict(wide, name="f32off", kind="train", moments="f32",
             axes={"dp": 2, "fsdp": 2}, ckpt=ck["f32off"], offload=True),
        dict(fstp, name="dptp", kind="restore", axes={"dp": 2, "tp": 2},
             ckpt=ck["fstp"], step=STEPS),
        {"name": "elastic", "kind": "train", "moments": "int8",
         "init": "tiny", "model": {}, "lr": 1e-3, "warmup": 1,
         "decay": 50, "batches": el_bp, "steps": SPLIT,
         "elastic_more": TOTAL - SPLIT, "ckpt": ck["elastic"]},
        dict(fstp, name="fstp_one", kind="onestep", jax=ref["fstp"]),
        dict(dpfs, name="dpfs_one", kind="onestep", jax=ref["dpfs"]),
        dict(pptp, name="pptp_one", kind="onestep", jax=ref["pptp"])]
    a = _Launch(tmp, "a", _elastic_job("int8-a", _free_port()), 4,
                {"inits": {k: str(v) for k, v in inits.items()},
                 "runs": runs_a})
    tiny = {"init": "tiny", "model": {}, "lr": 1e-3, "warmup": 2,
            "decay": 20, "batches": tiny_bp, "steps": STEPS,
            "moments": "int8"}
    b = _Launch(tmp, "b", _slice_job("int8-b", _free_port(), 8,
                                     MeshSpec(dp=4, fsdp=2)), 8,
                {"inits": {k: str(v) for k, v in inits.items()},
                 "runs": [dict(tiny, name="b8", kind="train", ckpt=ck["b8"]),
                          dict(tiny, name="b8_off", kind="train",
                               ckpt=ck["b8_off"], offload=True),
                          dict(tiny, name="b8_one", kind="onestep",
                               jax=ref["b8"]),
                          dict(tiny, name="b8_off_one", kind="onestep",
                               jax=ref["b8"], offload=True)]})
    # JAX's references while the ranks train, in the order they wait
    wb = _batches(STEPS + MORE, B_W, S_W, 768, 5)[:STEPS]
    jax_runs = {}
    for name, call in (
            ("fstp", lambda: _jax_run({"fsdp": 2, "tp": 2}, WIDE, "int8",
                                      wb)),
            ("b8", lambda: _jax_run({"dp": 4, "fsdp": 2}, {}, "int8",
                                    tiny_b, warmup=2, decay=20)),
            ("dpfs", lambda: _jax_run({"dp": 2, "fsdp": 2}, WIDE, "int8",
                                      wb)),
            ("pptp", lambda: _jax_run({"pp": 2, "tp": 2}, WIDE, "int8", wb,
                                      step_kw={"schedule": "1f1b",
                                               "num_microbatches": 2})),
            ("f32off", lambda: _jax_run({"dp": 2, "fsdp": 2}, WIDE, "f32",
                                        wb)),
            ("elastic", lambda: _jax_run({"dp": 4}, {}, "int8", el_b,
                                         decay=50))):
        jax_runs[name] = call()
        if name in ref:
            _jax_reference_file(ref[name], jax_runs[name])
    res_a, tens_a = a.finish()
    res_b, tens_b = b.finish()
    resume = {"name": "elastic", "kind": "resume", "moments": "int8",
              "init": "tiny", "model": {}, "lr": 1e-3, "warmup": 1,
              "decay": 50, "batches": el_bp, "ckpt": ck["elastic"],
              "gb": GB, "total": TOTAL}
    c = _Launch(tmp, "c", _elastic_job("int8-c", _free_port(), limits=2), 2,
                {"inits": {k: str(v) for k, v in inits.items()},
                 "runs": [resume]})
    res_c, _ = c.finish()
    # the ranks started from each JAX run's own init
    for k, init in (("fstp", wide_init), ("dpfs", wide_init),
                    ("pptp", wide_init), ("f32off", wide_init),
                    ("b8", tiny_init), ("elastic", tiny_init)):
        assert all(np.array_equal(x, y) for x, y in zip(
            jax.tree.leaves(jax_runs[k]["init"]), jax.tree.leaves(init)))
    return {"a": (res_a, tens_a), "b": (res_b, tens_b), "c": res_c,
            "jax": jax_runs, "ckpt": ck, "cm_c": c.cm["data"]}


class TestInt8OnTheMesh:
    @pytest.mark.parametrize("run", ["fstp", "dpfs", "pptp"])
    def test_wide_tiny_matches_jax(self, worlds, run):
        res, tens = worlds["a"]
        _trajectory_like_jax(res, run, worlds["jax"][run])
        off, total = _one_step_like_jax(tens, run + "_one",
                                        worlds["jax"][run])
        assert total > 0
        for r in res:
            assert r["runs"][run + "_one"]["count"] == STEPS
        assert not any(r["jax_imported"] for r in res)

    def test_every_alignment_case_occurs(self, worlds):
        res, _ = worlds["a"]
        for r in res:
            cases = r["runs"]["fstp"]["cases"]
            assert {cases[k] for k in cases} == {
                PS.ALIGNED, PS.REPLICATED, PS.UNALIGNED}
            for i in range(2):
                lay = f"layers.{i}."
                assert cases[lay + "attn.wq.kernel"] == PS.ALIGNED
                assert cases[lay + "mlp.w2.kernel"] == PS.ALIGNED
                assert cases[lay + "attn.wk.kernel"] == PS.REPLICATED
                assert cases[lay + "mlp.w1.kernel"] == PS.UNALIGNED
                assert cases[lay + "mlp.w3.kernel"] == PS.UNALIGNED
            assert cases["lm_head.kernel"] == PS.REPLICATED
            assert cases["tok_embed.embedding"] == PS.ALIGNED
        # cases 2 and 3 gathered rows over tp; the ranks' bytes a step
        ex = res[0]["runs"]["fstp"]["exchange"]
        assert ex["q8_replicated"] > 0 and ex["q8_unaligned"] > 0
        assert res[0]["runs"]["dpfs"]["exchange"]["q8_unaligned"] == 0

    @pytest.mark.parametrize("run", ["fstp", "dpfs", "pptp", "b8"])
    def test_q8_placements_are_jax_specs(self, worlds, run):
        res = worlds["a"][0] if run != "b8" else worlds["b"][0]
        want = worlds["jax"][run]["q8_specs"]
        pp = run == "pptp"
        for r in res:
            got = {f: {k: tuple(tuple(e) if isinstance(e, list) else e
                                for e in s) for k, s in by.items()}
                   for f, by in r["runs"][run]["q8_specs"].items()}
            for f in Q8.AdamW8bitState.FIELDS:
                assert got[f] == want[f], f
                assert set(want[f + "/lead"].values()) == \
                    {"pp" if pp else None}

    def test_offloaded_run_equals_resident_bit_for_bit(self, worlds):
        res, tens = worlds["a"]
        for r in res:
            assert r["runs"]["fstp_off"]["metrics"] == \
                r["runs"]["fstp"]["metrics"]
            assert all(r["runs"]["fstp_off"]["host"])
        for i in range(STEPS):
            got = _assemble(tens, "fstp_off", step=i)
            want = _assemble(tens, "fstp", step=i)
            for f, by in want.items():
                for k, t in by.items():
                    assert torch.equal(got[f][k], t), (i, f, k)
        a = _saved_params(worlds["ckpt"]["fstp_off"], STEPS)
        b = _saved_params(worlds["ckpt"]["fstp"], STEPS)
        assert all(torch.equal(a[k], b[k]) for k in b)

    def test_f32_offload_on_dp_fsdp(self, worlds):
        """tests/test_offload.py on dp2 x fsdp2 at the widened tiny:
        the offloaded trajectory is JAX's (rtol and atol 1e-5), and
        equals the resident run on the mesh bit for bit, moments
        included; the moments stayed in host memory."""
        res, _ = worlds["a"]
        _same_metrics(res, "f32off")
        got = res[0]["runs"]["f32off"]
        assert all(got["host"])
        assert got["metrics"] == res[0]["runs"]["f32res"]["metrics"]
        want = worlds["jax"]["f32off"]
        for g, w in zip(got["metrics"], want["metrics"]):
            for k in ("loss", "grad_norm"):
                np.testing.assert_allclose(g[k], w[k], rtol=F32_TOL,
                                           atol=F32_TOL)
        ck = worlds["ckpt"]
        a = _saved_params(ck["f32off"], STEPS)
        b = _saved_params(ck["f32res"], STEPS)
        assert all(torch.equal(a[k], b[k]) for k in b)
        ma, mb = _saved_moments(ck["f32off"], STEPS), \
            _saved_moments(ck["f32res"], STEPS)
        for name, shard in mb.items():
            for f in ("mu", "nu"):
                for k, e in shard[f].items():
                    assert torch.equal(ma[name][f][k]["local"], e["local"])

    @pytest.mark.parametrize("run", ["b8", "b8_off"])
    def test_jax_dp4_fsdp2_tiny(self, worlds, run):
        """tests/test_opt8bit.py TestTraining's world (dp4 x fsdp2, tiny,
        warmup 2, decay 20), int8 and int8 + offload."""
        res, tens = worlds["b"]
        _trajectory_like_jax(res, run, worlds["jax"]["b8"])
        _one_step_like_jax(tens, run + "_one", worlds["jax"]["b8"])
        if run == "b8_off":
            for r in res:
                assert all(r["runs"][run]["host"])
                assert r["runs"][run]["metrics"] == r["runs"]["b8"]["metrics"]
            for i in range(STEPS):
                got = _assemble(tens, "b8_off", step=i)
                want = _assemble(tens, "b8", step=i)
                assert all(torch.equal(got[f][k], t)
                           for f, by in want.items() for k, t in by.items())


class TestInt8Checkpoint:
    def test_restore_on_the_mesh_continues_bit_for_bit(self, worlds):
        res, _ = worlds["a"]
        _same_metrics(res, "fstp", "more")
        for r in res:
            run = r["runs"]["fstp"]
            assert run["restored_step"] == STEPS
            assert run["more"] == run["again"] and run["again_bits"]

    def _saved_blocks(self, worlds):
        """The global codes and scales of the fsdp2 x tp2 step 3, put
        together from the shard files' regions as they were written."""
        d = os.path.join(worlds["ckpt"]["fstp"], str(STEPS))
        opt = torch.load(os.path.join(d, TC.OPT_FILE), weights_only=True)
        assert opt["moments"] == "int8"
        whole = {}
        for name in opt["sharded"]["files"]:
            shard = torch.load(os.path.join(d, name), weights_only=True)
            for f in Q8.AdamW8bitState.FIELDS:
                for k, e in shard[f].items():
                    w = whole.setdefault(f, {}).setdefault(
                        k, torch.zeros(e["shape"], dtype=e["local"].dtype))
                    w[PS.region(e["shape"], e["spec"], shard["mesh"],
                                shard["coords"])] = e["local"]
        return whole

    def test_shard_files_hold_the_saved_global_blocks(self, worlds):
        """The files hold each region once (a leaf replicated over an
        axis is written by that axis's rank 0), and together they are
        the mesh's step-3 moments."""
        _, tens = worlds["a"]
        saved = self._saved_blocks(worlds)
        want = _assemble(tens, "fstp", step=STEPS - 1)
        for f, by in want.items():
            for k, t in by.items():
                assert torch.equal(saved[f][k], t), (f, k)
        d = os.path.join(worlds["ckpt"]["fstp"], str(STEPS))
        files = torch.load(os.path.join(d, TC.OPT_FILE),
                           weights_only=True)["sharded"]["files"]
        held = {}
        for name in files:
            shard = torch.load(os.path.join(d, name), weights_only=True)
            for k in shard["mu_codes"]:
                held[k] = held.get(k, 0) + 1
        # wk's blocks are replicated over tp: written by tp 0 alone, once
        # an fsdp shard; wq's are cut by both axes: four regions
        assert held["layers.0.attn.wk.kernel"] == 2
        assert held["layers.0.attn.wq.kernel"] == 4
        assert held["lm_head.kernel"] == 2

    def test_restored_on_dp2_tp2_and_one_card_bit_for_bit(self, worlds):
        saved = self._saved_blocks(worlds)
        _, tens = worlds["a"]
        got = _assemble(tens, "dptp", step=0)
        for f, by in saved.items():
            for k, t in by.items():
                assert torch.equal(got[f][k], t), (f, k)
        model, _ = TL.make_model("tiny", device="cpu", dtype=torch.float32,
                                 **WIDE)
        opt = TT.make_optimizer(1e-3, warmup_steps=1, decay_steps=100,
                                moments="int8")
        state = TC.CheckpointManager(worlds["ckpt"]["fstp"]).restore(
            TT.create_state(model, opt), step=STEPS)
        assert state.step == STEPS and state.opt_state.count == STEPS
        one = state.opt_state.tensors()
        for f, by in saved.items():
            for k, t in by.items():
                assert torch.equal(one[f][k], t), (f, k)

    def test_offloaded_restore_lands_in_the_host_slab(self, worlds):
        res, tens = worlds["a"]
        assert all(r["runs"]["fstp_off"]["restore_in_slab"] for r in res)
        got = _assemble(tens, "fstp_off", which="restored")
        saved = self._saved_blocks(worlds)
        for f, by in saved.items():
            for k, t in by.items():
                assert torch.equal(got[f][k], t), (f, k)


class TestInt8Elastic:
    def test_dp4_int8_resumes_at_dp2(self, worlds):
        """The clamp's ConfigMap (dp 4 -> 2, two workers) restarts the
        gang; its resume continues the unbroken dp4 run within JAX's
        bounds, and both are JAX's dp4 int8 run."""
        assert json.loads(worlds["cm_c"]["TPUJOB_MESH"]) == {"dp": 2}
        res_a, _ = worlds["a"]
        unbroken = res_a[0]["runs"]["elastic"]["losses"]
        _same_metrics(res_a, "elastic", "losses")
        jax_losses = [m["loss"] for m in worlds["jax"]["elastic"]["metrics"]]
        np.testing.assert_allclose(unbroken, jax_losses, rtol=RTOL_E,
                                   atol=ATOL_E)
        for r in worlds["c"]:
            run = r["runs"]["elastic"]
            assert r["world"] == 2 and run["resumed"]
            assert run["plan"]["step"] == SPLIT
            assert run["plan"]["data_start_step"] == SPLIT
            assert run["count"] == TOTAL
            got = unbroken[:SPLIT] + run["losses"]
            np.testing.assert_allclose(got, unbroken, rtol=RTOL_E,
                                       atol=ATOL_E)
            np.testing.assert_allclose(got, jax_losses, rtol=RTOL_E,
                                       atol=ATOL_E)
