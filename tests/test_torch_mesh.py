"""The torch package's mesh and sharding rules (paddle_operator_tpu_torch/
parallel/mesh.py, parallel/sharding.py, models/llama.py
``partition_patterns``, train/trainer.py ``state_shardings``) held
against the JAX package's, in this process:

- ``AXIS_ORDER``, ``DATA_AXES`` and ``DEFAULT_RULES`` are the JAX
  package's, and so are ``logical_to_mesh`` and every parameter's and
  moment's spec for the tiny preset on dp2 x fsdp2 x tp2, dp8, fsdp4 x
  tp2 and one device (JAX ``state_shardings(...).params`` on the
  conftest's 8 virtual CPU devices; its stacked ``layers`` dim dropped,
  the port's layers being separate modules);
- ``make_mesh``'s size error, the card default (no fallback to gloo),
  the refusals that need no live mesh (MoE with cp above 1, a tp that
  splits a GQA group, a mesh that is not a multiple of the worker
  count; ``chips_per_worker`` > 1 runs one process a card since item
  8.4, tests/test_torch_multicard.py), the MoE rows of
  ``partition_patterns`` (JAX's ``moe_partition_patterns``, the tiny-moe
  specs on four ep meshes) and the mesh knob's type;
- on a world of one rank (a gloo group over an in-process store, torn
  down after each test): the single-device mesh, a one-worker job's
  ``job_mesh``, and the mesh step on it, which must equal the step
  without a mesh bit for bit (phase 3s of chip_smoke.py holds the same
  on the card at 7b width), through ``fit``, a checkpoint and its
  restore.

The spawned multi-rank worlds are in tests/test_torch_sharded_train.py.
"""

import itertools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch
import torch.distributed as dist

from paddle_operator_tpu.api.types import MeshSpec as JMeshSpec
from paddle_operator_tpu.launch import launcher as JLA
from paddle_operator_tpu.models import llama as JL
from paddle_operator_tpu.parallel import mesh as JM
from paddle_operator_tpu.parallel import sharding as JS
from paddle_operator_tpu.train import trainer as JT
from paddle_operator_tpu_torch.api.types import MeshSpec
from paddle_operator_tpu_torch.launch import launcher as TLA
from paddle_operator_tpu_torch.models import llama as TL
from paddle_operator_tpu_torch.parallel import mesh as TM
from paddle_operator_tpu_torch.parallel import sharding as TS
from paddle_operator_tpu_torch.train import checkpoint as TC
from paddle_operator_tpu_torch.train import data as TD
from paddle_operator_tpu_torch.train import trainer as TT

MESHES = {"dp2_fsdp2_tp2": {"dp": 2, "fsdp": 2, "tp": 2},
          "dp8": {"dp": 8}, "fsdp4_tp2": {"fsdp": 4, "tp": 2},
          "single": {}}


def _sizes(axes):
    return {a: axes.get(a, 1) for a in TM.AXIS_ORDER}


def jax_param_specs(axes, preset="tiny"):
    """name (the port's) -> spec tuple of JAX ``state_shardings`` of
    ``preset`` on the mesh ``axes`` (over the conftest's virtual
    devices), and the JAX moments' specs keyed the same way."""
    spec = JMeshSpec(**axes)
    mesh = JM.make_mesh(spec, devices=jax.devices()[:spec.size()])
    model, cfg = JL.make_model(preset)
    opt = JT.make_optimizer(1e-3, warmup_steps=1, decay_steps=100)
    sh, _ = JT.state_shardings(model, opt, mesh, JL.partition_patterns(cfg),
                               (jnp.zeros((8, 8), jnp.int32),))

    def named(tree):
        out = {}
        for path, s in jax.tree_util.tree_flatten_with_path(tree)[0]:
            keys = [p.key for p in path]
            spec = tuple(s.spec)
            if keys[0] == "layers":
                for i in range(cfg.n_layers):
                    out[f"layers.{i}." + ".".join(keys[1:])] = spec[1:]
            else:
                out[".".join(keys)] = spec
        return out

    adam = sh.opt_state[1][0]
    return named(sh.params), {"mu": named(adam.mu), "nu": named(adam.nu)}


class TestRules:
    def test_axis_order_data_axes_rules_equal_jax(self):
        assert tuple(TM.AXIS_ORDER) == tuple(JM.AXIS_ORDER)
        assert tuple(TM.DATA_AXES) == tuple(JM.DATA_AXES)
        assert TS.DEFAULT_RULES == JS.DEFAULT_RULES
        cfg = TL.CONFIGS["tiny"]
        want = [(p.replace("/", r"\."), s) for p, s in JL._LAYER_PATTERNS]
        assert TL._LAYER_PATTERNS == want
        assert [s for _, s in TL.partition_patterns(cfg)][:3] == \
            [s for _, s in JL.partition_patterns(JL.CONFIGS["tiny"])][:3]
        assert TM.mesh_shape(MeshSpec(dp=2, tp=4)) == \
            JM.mesh_shape(JMeshSpec(dp=2, tp=4))

    @pytest.mark.parametrize("mesh", MESHES, ids=list(MESHES))
    @pytest.mark.parametrize("spec", [("batch",), ("embed", "mlp"),
                                      ("vocab", "embed"), ("heads", None),
                                      ("layers", "embed", "kv_heads"),
                                      ("seq", "expert"), (None,)])
    def test_logical_to_mesh_matches_jax(self, mesh, spec):
        axes = MESHES[mesh]
        jmesh = (JM.make_mesh(JMeshSpec(**axes)) if axes
                 else JM.single_device_mesh())
        want = tuple(JS.logical_to_mesh(spec, mesh=jmesh))
        assert TS.logical_to_mesh(spec, mesh=_sizes(axes)) == want
        # without a mesh nothing is dropped
        assert TS.logical_to_mesh(spec) == tuple(JS.logical_to_mesh(spec))

    @pytest.mark.parametrize("mesh", MESHES, ids=list(MESHES))
    def test_param_and_moment_specs_match_jax(self, mesh):
        axes = MESHES[mesh]
        want, want_moments = jax_param_specs(axes)
        cfg = TL.CONFIGS["tiny"]
        model = TL.Llama(cfg, "meta")
        got = TS.tree_specs(dict(model.named_parameters()), _sizes(axes),
                            TL.partition_patterns(cfg))
        assert got == want
        # a JAX moment is laid out as its parameter, as the port's are
        # (StateShardings.opt_state maps each field to the params' map)
        assert want_moments == {"mu": want, "nu": want}

    def test_placements_round_trip(self):
        class Mesh:                     # the two attributes read
            mesh_dim_names = tuple(TM.AXIS_ORDER)
        spec = ("fsdp", ("dp", "tp"), None)
        pl = TS.placements(spec, Mesh())
        assert [type(p).__name__ for p in pl] == \
            ["Shard", "Replicate", "Shard", "Replicate", "Replicate",
             "Shard"]
        assert TS.spec_of(pl, Mesh(), 3) == spec
        with pytest.raises(ValueError, match="mesh order"):
            TS.placements((("tp", "dp"),), Mesh())

    def test_region_nests_outer_axes_first(self):
        sizes = _sizes({"dp": 2, "fsdp": 2, "tp": 2})
        full = np.arange(16).reshape(8, 2)
        seen = set()
        for dp, fsdp in itertools.product(range(2), range(2)):
            coords = dict.fromkeys(TM.AXIS_ORDER, 0, ) | {"dp": dp,
                                                          "fsdp": fsdp}
            r = TS.region(full.shape, (("dp", "fsdp"), None), sizes, coords)
            block = full[r]
            assert block.shape == (2, 2)
            assert block[0, 0] == (2 * dp + fsdp) * 4   # JAX's row order
            seen.add(int(block[0, 0]))
        assert len(seen) == 4
        with pytest.raises(ValueError, match="not divisible"):
            TS.region((7,), ("fsdp",), sizes, dict.fromkeys(TM.AXIS_ORDER,
                                                            0))

    def test_indivisible_dim_raises_naming_it(self):
        with pytest.raises(ValueError, match="tok_embed.embedding"):
            TS.tree_specs({"tok_embed.embedding": (255, 64)},
                          _sizes({"tp": 2}),
                          TL.partition_patterns(TL.CONFIGS["tiny"]))


class TestRefusals:
    def test_make_mesh_size_error(self):
        assert not dist.is_initialized()
        with pytest.raises(ValueError, match="needs 4 devices, have 1"):
            TM.make_mesh(MeshSpec(fsdp=2, tp=2), device="cpu")
        with pytest.raises(ValueError, match="needs 16 devices, have 8"):
            JM.make_mesh(JMeshSpec(fsdp=16))
        assert not dist.is_initialized()

    def test_card_is_the_default_no_fallback(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA card"):
            TM.single_device_mesh()
        with pytest.raises(RuntimeError, match="no CUDA card"):
            TLA.job_mesh(TLA.JobEnv.from_env({}))
        assert not dist.is_initialized()

    def test_moe_on_a_mesh_is_refused_by_name(self):
        """What stays refused of MoE on a mesh: a cp axis above 1
        (ROADMAP.md Queue A item 8.6); ep and every other axis run."""
        for preset in ("tiny-moe", "tiny-moe2"):
            cfg = TL.CONFIGS[preset]
            with pytest.raises(NotImplementedError,
                               match=r"MoE models with cp=2.*Queue A "
                                     r"item 8\.6"):
                TL.check_moe(cfg, 2)
            TL.check_moe(cfg, 1)
        TL.check_moe(TL.CONFIGS["tiny"], 2)

    @pytest.mark.parametrize("axes", [{"ep": 4, "dp": 2}, {"ep": 2, "dp": 4},
                                      {"ep": 2, "fsdp": 2, "tp": 2},
                                      {"ep": 2, "fsdp": 4}])
    def test_moe_rows_equal_jax_moe_partition_patterns(self, axes):
        """The MoE rows of partition_patterns are JAX's
        ``moe_partition_patterns`` on the port's names, and every MoE
        parameter's spec is JAX's ``state_shardings`` spec."""
        from paddle_operator_tpu.models import moe as JMoE
        from paddle_operator_tpu_torch.models import moe as TMoE

        assert {k.replace("/", "."): v
                for k, v in JMoE.MOE_PARAM_SPECS.items()} \
            == TMoE.MOE_PARAM_SPECS
        rows = TMoE.moe_partition_patterns()
        assert [spec for _, spec in rows] == [
            spec for _, spec in JMoE.moe_partition_patterns(prefix="moe/")]
        cfg = TL.CONFIGS["tiny-moe"]
        pats = TL.partition_patterns(cfg)
        assert pats[-len(rows):] == rows
        model, _ = TL.make_model("tiny-moe", device="cpu")
        got = TS.tree_specs(dict(model.named_parameters()), _sizes(axes),
                            pats)
        want, _ = jax_param_specs(axes, "tiny-moe")
        assert got == want
        assert got["layers.0.moe.w1"][0] == "ep"

    @pytest.mark.parametrize("tp,ok", [(1, True), (2, True), (4, False)])
    def test_tp_that_splits_a_gqa_group_is_refused(self, tp, ok):
        cfg = TL.CONFIGS["tiny"]            # 4 heads over 2 kv heads
        if ok:
            TL.check_tp(cfg, tp)
        else:
            with pytest.raises(ValueError, match="GQA groups"):
                TL.check_tp(cfg, tp)

    def test_chips_per_worker_above_one_is_refused_by_name(self):
        """Pods of several cards are ported (Queue A item 8.4): a mesh of
        8 over 2 workers is 4 cards a pod, whose world of 8 ranks needs
        ``initialize`` first; what stays refused by name is a mesh that
        is not a multiple of the worker count, and a process of a
        4-card pod that the shim did not start."""
        env = TLA.JobEnv.from_env({"TPUJOB_NUM_WORKERS": "2",
                                   "TPUJOB_MESH": '{"fsdp": 2, "tp": 4}'})
        assert TLA.pod_cards(env) == 4
        with pytest.raises(RuntimeError,
                           match=r"2 worker\(s\) × 4 card.*initialize"):
            TLA.job_mesh(env, device="cpu")
        with pytest.raises(RuntimeError, match="one process a card"):
            TLA.initialize(env, device="cpu")
        odd = TLA.JobEnv.from_env({"TPUJOB_NUM_WORKERS": "3",
                                   "TPUJOB_MESH": '{"fsdp": 2, "tp": 4}'})
        with pytest.raises(ValueError, match="not a multiple"):
            TLA.job_mesh(odd, device="cpu")
        assert not dist.is_initialized()

    def test_multi_worker_job_needs_initialize(self):
        env = TLA.JobEnv.from_env({"TPUJOB_NUM_WORKERS": "2",
                                   "TPUJOB_MESH": '{"fsdp": 2}'})
        with pytest.raises(RuntimeError, match="initialize"):
            TLA.job_mesh(env, device="cpu")

    def test_mesh_must_be_a_device_mesh(self):
        opt = TT.make_optimizer()
        for call in (lambda: TT.make_train_step(opt, mesh="fsdp"),
                     lambda: TT.make_eval_step(mesh={"fsdp": 2}),
                     lambda: TD.DevicePrefetcher(iter(()), mesh=object())):
            with pytest.raises(TypeError, match="DeviceMesh"):
                call()


@pytest.fixture
def world_of_one():
    """A gloo world of one rank for the test, destroyed after it."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _batches(n=3, b=4, s=17, seed=11):
    return list(itertools.islice(TD.deterministic_lm_batches(
        b, s, 256, seed=seed), n))


def _tiny(dtype=torch.float32):
    model, cfg = TL.make_model("tiny", device="cpu", dtype=dtype, seed=3)
    return model, cfg, TT.make_optimizer(1e-3, warmup_steps=1,
                                         decay_steps=100)


def test_chip_smoke_mesh_pod_env_is_the_configmaps():
    """chip_smoke.py phase 3s starts its pod with MESH_POD_ENV: what
    controller/builders.py gives the one worker of a one-worker TPUJob
    on a 1x1 slice (its ConfigMap carries TPUJOB_MESH, size 1), the
    checkpoint path aside."""
    import os
    import sys

    from paddle_operator_tpu.api import (ResourceSpec, TPUJob, TPUJobSpec,
                                         TPUSpec)
    from paddle_operator_tpu.controller import builders as B

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, repo)
    try:
        import chip_smoke
    finally:
        sys.path.remove(repo)
    tmpl = {"spec": {"containers": [{"name": "m", "image": "i"}]}}
    job = TPUJob(name="mesh-train", spec=TPUJobSpec(
        worker=ResourceSpec(replicas=1, template=tmpl),
        tpu=TPUSpec(topology="1x1", slice_count=1, chips_per_worker=1),
        mesh=JMeshSpec(), checkpoint_path="/ckpt"))
    assert job.validate() == []
    pod = B.construct_pod(job, "worker", 0)
    pod["status"] = {"podIP": "127.0.0.1"}
    env = dict(B.construct_configmap(job, [pod])["data"])
    for e in pod["spec"]["containers"][0]["env"]:
        if "value" in e:
            env[e["name"]] = e["value"]
    env["POD_IP"] = pod["status"]["podIP"]
    assert env.pop("TPUJOB_CHECKPOINT_PATH") == "/ckpt"
    assert env == chip_smoke.MESH_POD_ENV
    got = TLA.JobEnv.from_env(chip_smoke.MESH_POD_ENV)
    assert got.num_workers == 1 and got.mesh.size() == 1


class TestWorldOfOne:
    def test_single_device_mesh(self, world_of_one):
        mesh = TM.single_device_mesh(device="cpu")
        jmesh = JM.single_device_mesh()
        assert mesh.mesh_dim_names == tuple(jmesh.axis_names)
        assert tuple(mesh.mesh.shape) == jmesh.devices.shape
        assert TM.is_trivial(mesh) and TM.control_group(mesh) is None
        assert TS.data_block(mesh) == (0, 1)

    def test_one_worker_job_mesh_equals_jax(self, world_of_one):
        environ = {"TPUJOB_NUM_WORKERS": "1", "TPUJOB_RANK": "0",
                   "TPUJOB_COORDINATOR_ADDRESS": "127.0.0.1:1"}
        env = TLA.initialize(TLA.JobEnv.from_env(environ), device="cpu")
        assert not dist.is_initialized()      # one worker: no group
        mesh = TLA.job_mesh(env, device="cpu")
        assert dist.get_world_size() == 1 and dist.get_backend() == "gloo"
        # the JAX job_mesh of the same env on a one-chip pod
        want = JM.make_mesh(JLA.JobEnv.from_env(environ).mesh,
                            devices=jax.devices()[:1])
        assert mesh.mesh_dim_names == tuple(want.axis_names)
        assert tuple(mesh.mesh.shape) == want.devices.shape

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_mesh_step_equals_the_plain_step_bit_for_bit(self, world_of_one,
                                                         dtype, tmp_path):
        """The single-device mesh's step runs the single-device
        operations: fit's losses, grad norms and final parameters equal
        the step without a mesh bit for bit (f32 and bf16 compute), and
        a checkpoint of the mesh state restores into a plain one."""
        mesh = TM.single_device_mesh(device="cpu")
        batches = _batches()
        runs = []
        for m in (None, mesh):
            model, cfg, opt = _tiny(dtype)
            state = TT.create_state(model, opt, mesh=m)
            step = TT.make_step_for_mesh(opt, m) if m is not None \
                else TT.make_train_step(opt)
            it = (TD.DevicePrefetcher(iter(batches), mesh=m) if m is not None
                  else TD.DevicePrefetcher(iter(batches), device="cpu"))
            state, hist = TT.fit(state, step, it, steps=10)
            params = {n: TS.to_local(p).detach().clone()
                      for n, p in state.model.named_parameters()}
            runs.append((hist, params, state))
        (h0, p0, _), (h1, p1, mstate) = runs
        assert h0 == h1 and len(h0) == 3
        for n in p0:
            assert torch.equal(p0[n], p1[n]), n
        placements = {n: p.placements
                      for n, p in mstate.model.named_parameters()}
        assert all(p.is_replicate() for pl in placements.values()
                   for p in pl)
        # save on the mesh, restore into a plain state: the same bits
        ckpt = TC.CheckpointManager(str(tmp_path))
        assert ckpt.save(3, mstate, force=True)
        ckpt.wait()
        model, cfg, opt = _tiny(dtype)
        plain = ckpt.restore(TT.create_state(model, opt))
        assert plain.step == 3 and plain.opt_state.count == 3
        for n, p in plain.model.named_parameters():
            assert torch.equal(p, p1[n]), n
            assert torch.equal(plain.opt_state.mu[n],
                               mstate.opt_state.mu[n]), n
        # and back into a mesh state
        model, cfg, opt = _tiny(dtype)
        again = ckpt.restore(TT.create_state(model, opt, mesh=mesh))
        for n, p in again.model.named_parameters():
            assert torch.equal(TS.to_local(p), p1[n]), n

    def test_eval_step_on_the_mesh(self, world_of_one):
        mesh = TM.single_device_mesh(device="cpu")
        model, cfg, opt = _tiny()
        want = TT.make_eval_step()(model, {"tokens": torch.as_tensor(
            _batches(1)[0]["tokens"])})
        TT.create_state(model, opt, mesh=mesh)
        got = TT.make_eval_step(mesh)(model, TS.shard_batch(
            _batches(1)[0], mesh, "cpu"))
        assert float(got["loss"]) == float(want["loss"])
