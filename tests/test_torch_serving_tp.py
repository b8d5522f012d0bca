"""Tensor-parallel serving on the port (paddle_operator_tpu_torch) held
against the JAX package's tp functions, one process a rank:

- (a) ``ops/decode_attention.py`` ``sharded_decode_attention`` and
  ``sharded_paged_decode_attention`` (their plain versions: these are
  CPU tensors) on each rank's heads of a gloo world of 2 and of 4,
  against JAX's ``sharded_decode_attention`` /
  ``sharded_paged_decode_attention`` in interpret mode on the
  conftest's virtual devices — the contiguous cache, the stacked-layer
  select, the paged pool and the int8 pool's operands, raw and int8
  ``wo`` — within rtol = atol = 2e-5 (tests/test_decode_attention.py's
  bar); a tp that does not split the kv heads raises "not divisible"
  before any collective;
- (b) ``decode.generate`` at f32 on the tiny preset: tp 2 through the
  sharded kernel wrappers, tp 4 through the fallback (kv heads 2 do not
  split: attention whole on every rank), and int8 weights at tp 2 —
  each token-identical to JAX's ``generate`` on a tp mesh of the same
  size and to the port at tp 1; a rank's cut from the streamed init
  (``init_serving_shard``) and from a checkpoint
  (``serve.load_serving_shard``) equals the cut of the whole model.

Each world is a set of plain gloo processes with a timeout of its own
(a hung rank fails its test alone); JAX's references run in this
process while the ranks work.
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

from paddle_operator_tpu.infer import decode as JD
from paddle_operator_tpu.infer.quant import quantize_params as jax_quantize
from paddle_operator_tpu.models.llama import make_model as jax_make_model
from paddle_operator_tpu.ops import decode_attention as JA
from paddle_operator_tpu.parallel.mesh import make_serving_mesh as jax_mesh
from paddle_operator_tpu_torch.convert import params_from_jax
from paddle_operator_tpu_torch.infer import decode as D
from paddle_operator_tpu_torch.infer import quant as Q
from paddle_operator_tpu_torch.models.llama import make_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 2e-5
WORLD_TIMEOUT = 150

# (a)'s shapes: JAX's sharded-attention test (8 query heads over 4 kv
# heads), a 3-layer stack, a paged pool of 8-row blocks
B, S, HQ, HKV, DH, E, LN = 4, 64, 8, 4, 32, 24, 3
N, BS, M = 12, 8, 6


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


class World:
    """``tp`` gloo ranks of ``src`` (``python src args.json rank``), each
    writing ``rank<r>.pt`` into its out dir; started at construction so
    the parent's references overlap them."""

    def __init__(self, tmp, name: str, tp: int, src: str, args: dict,
                 timeout: float = WORLD_TIMEOUT) -> None:
        self.out = tmp / f"{name}-out"
        self.out.mkdir()
        child = tmp / f"{name}-child.py"
        child.write_text(src)
        argf = tmp / f"{name}.json"
        argf.write_text(json.dumps(dict(args, tp=tp, port=_free_port(),
                                        out=str(self.out))))
        env = dict(os.environ, OMP_NUM_THREADS="1",
                   PYTHONPATH=REPO + os.pathsep
                   + os.environ.get("PYTHONPATH", ""))
        self.timeout = timeout
        self.procs = [subprocess.Popen(
            [sys.executable, str(child), str(argf), str(r)], env=env,
            cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(tp)]

    def results(self):
        try:
            for i, p in enumerate(self.procs):
                _, err = p.communicate(timeout=self.timeout)
                assert p.returncode == 0, f"rank {i} failed:\n{err[-4000:]}"
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        return [torch.load(self.out / f"rank{r}.pt", weights_only=False)
                for r in range(len(self.procs))]


# the ranks' common head: the gloo group, the serving mesh, the inputs
RANK_HEAD = r'''
import json, sys
import numpy as np
import torch
import torch.distributed as dist

a = json.load(open(sys.argv[1]))
rank, tp = int(sys.argv[2]), a["tp"]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{a['port']}",
                        world_size=tp, rank=rank)
from paddle_operator_tpu_torch.parallel.mesh import make_serving_mesh
mesh = make_serving_mesh(tp, device="cpu")
group = mesh.get_group("tp")
out = {}


def save():
    out["jax_imported"] = any(m.split(".")[0] in ("jax", "paddle_operator_tpu")
                              for m in sys.modules)
    torch.save(out, f"{a['out']}/rank{rank}.pt")
    dist.destroy_process_group()
'''

CHILD_AB = RANK_HEAD + r'''
import dataclasses
from paddle_operator_tpu_torch.infer import decode as D
from paddle_operator_tpu_torch.infer import quant as Q
from paddle_operator_tpu_torch.models.llama import make_model
from paddle_operator_tpu_torch.ops import decode_attention as OA

d = {k: torch.as_tensor(v) for k, v in np.load(a["data"]).items()}


def cut(t, axis, n=None):
    n = n or t.shape[axis]
    per = n // tp
    return t.narrow(axis, rank * per, per).contiguous()


L = d["lengths"]
wo_rows = cut(d["wo"], 0)
woq = {"q": cut(d["woq"], 0), "s": d["wos"]}
for ref in (False, True):
    tag = "ref" if ref else "ker"
    out[f"attn_{tag}"] = OA.sharded_decode_attention(
        cut(d["q"], 1), cut(d["k"], 1), cut(d["v"], 1), L, wo_rows,
        group=group, heads=(a["hq"], a["hkv"]), reference=ref)
    for lay in range(a["ln"]):
        out[f"stack{lay}_{tag}"] = OA.sharded_decode_attention(
            cut(d["q"], 1), cut(d["ks"], 2), cut(d["vs"], 2), L, wo_rows,
            group=group, layer=lay, reference=ref)
    out[f"paged_{tag}"] = OA.sharded_paged_decode_attention(
        cut(d["q"], 1), cut(d["kp"], 1), cut(d["vp"], 1), d["table"],
        d["plen"], wo_rows, group=group, reference=ref)
    out[f"paged_int8_{tag}"] = OA.sharded_paged_decode_attention(
        cut(d["q"], 1), cut(d["kc"], 1), cut(d["vc"], 1), d["table"],
        d["plen"], woq, group=group, k_scale=cut(d["ksc"], 1),
        v_scale=cut(d["vsc"], 1), k_tail=cut(d["kt"], 1),
        v_tail=cut(d["vt"], 1), reference=ref)
# a tp that does not split the kv heads (tiny's 4 over 2 at tp 4; 4 over
# 3 at tp 2) raises in both wrappers before any collective
hkv = 2 if tp == 4 else 3
out["indivisible"] = []
for call in (lambda: OA.sharded_decode_attention(
                 d["q"][:, :1], d["k"][:, :1], d["v"][:, :1], L,
                 d["wo"][:32], group=group, heads=(4, hkv)),
             lambda: OA.sharded_paged_decode_attention(
                 d["q"][:, :1], d["kp"][:, :1], d["vp"][:, :1], d["table"],
                 d["plen"], d["wo"][:32], group=group, heads=(4, hkv))):
    try:
        call()
        out["indivisible"].append("no error")
    except ValueError as e:
        out["indivisible"].append(str(e))

model, cfg = make_model("tiny", device="cpu", dtype=torch.float32)
model.load_state_dict(torch.load(a["state"]))
prompt = d["prompt"]
with torch.inference_mode():
    shard = D.shard_params_for_serving(model, cfg, mesh)
    out["gen"] = D.generate(shard, cfg, prompt, max_new_tokens=8,
                            max_len=64, mesh=mesh)
    # the decode kernel's selection: the sharded wrapper's branch of the
    # forward (its plain version on these CPU tensors); tp 4 falls back
    out["gen_kernel"] = D.generate(
        shard, dataclasses.replace(cfg, decode_attn="kernel"), prompt,
        max_new_tokens=8, max_len=64, mesh=mesh)
    if tp == 2:
        # a checkpoint restored on every rank and cut (serve.main's path)
        from paddle_operator_tpu_torch.infer import serve as S
        from paddle_operator_tpu_torch.train import trainer as TT
        from paddle_operator_tpu_torch.train.checkpoint import (
            CheckpointManager)

        if rank == 0:
            ckpt = CheckpointManager(a["ckpt"])
            ckpt.save(1, TT.create_state(model, TT.make_optimizer()),
                      force=True)
            ckpt.wait()
        dist.barrier()
        restored, _, resumed = S.load_serving_shard(a["ckpt"], cfg, mesh,
                                                    "cpu")
        ref_cut = shard.state_dict()
        out["ckpt_equal"] = resumed and all(
            torch.equal(v, ref_cut[k]) for k, v in
            restored.state_dict().items())
        Q.quantize_params(model)          # the legacy set, lm_head too
        qshard = D.shard_params_for_serving(model, cfg, mesh)
        out["gen_int8"] = D.generate(qshard, cfg, prompt, max_new_tokens=8,
                                     max_len=64, mesh=mesh)
        # the streamed init's cut equals the cut of the whole init
        whole, _ = make_model("tiny", device="cpu", dtype=torch.float32,
                              seed=3)
        a_cut = D.shard_params_for_serving(whole, cfg, mesh).state_dict()
        b_cut = D.init_serving_shard(cfg, mesh, seed=3,
                                     device="cpu").state_dict()
        out["init_equal"] = (a_cut.keys() == b_cut.keys() and all(
            torch.equal(a_cut[k], b_cut[k]) for k in a_cut))
        out["contiguous"] = all(t.is_contiguous() for t in b_cut.values())
        out["wq_shape"] = tuple(shard.layers[0].attn.wq.kernel.shape)
        out["wo_s_shape"] = tuple(qshard.layers[0].attn.wo.s.shape)
        out["w1_s_shape"] = tuple(qshard.layers[0].mlp.w1.s.shape)
save()
'''


def _rand(shape, seed, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


@pytest.fixture(scope="module")
def tiny():
    jmodel, jcfg = jax_make_model("tiny", dtype=jnp.float32,
                                  decode_attn="pallas-interpret")
    jparams = jmodel.init(jax.random.PRNGKey(0),
                          jnp.zeros((1, 8), jnp.int32))["params"]
    model, cfg = make_model("tiny", device="cpu", dtype=torch.float32)
    model.load_state_dict(params_from_jax(jax.device_get(jparams)))
    return jcfg, jparams, model, cfg


def _inputs():
    rng = np.random.default_rng(11)
    d = {"q": _rand((B, HQ, DH), 1), "k": _rand((B, HKV, S, DH), 2),
         "v": _rand((B, HKV, S, DH), 3), "wo": _rand((HQ * DH, E), 4),
         "lengths": np.asarray([5, 64, 0, 17], np.int32),
         "ks": _rand((LN, B, HKV, S, DH), 6),
         "vs": _rand((LN, B, HKV, S, DH), 7),
         "kp": _rand((N, HKV, BS, DH), 8), "vp": _rand((N, HKV, BS, DH), 9),
         "table": np.stack([rng.permutation(np.arange(1, N))[:M]
                            for _ in range(B)]).astype(np.int32),
         "plen": np.asarray([3, 48, 1, 20], np.int32),
         "kc": rng.integers(-127, 128, (N, HKV, BS, DH)).astype(np.int8),
         "vc": rng.integers(-127, 128, (N, HKV, BS, DH)).astype(np.int8),
         "ksc": rng.uniform(0.001, 0.02, (N, HKV)).astype(np.float32),
         "vsc": rng.uniform(0.001, 0.02, (N, HKV)).astype(np.float32),
         "kt": _rand((B + 1, HKV, BS, DH), 12),
         "vt": _rand((B + 1, HKV, BS, DH), 13),
         "woq": rng.integers(-127, 128, (HQ * DH, E)).astype(np.int8),
         "wos": rng.uniform(0.001, 0.02, (1, E)).astype(np.float32),
         "prompt": rng.integers(0, 256, (3, 9)).astype(np.int64)}
    return d


def _jax_attention(d, tp):
    """JAX's sharded wrappers on the same inputs, interpret mode."""
    mesh = jax_mesh(tp)
    j = {k: jnp.asarray(v) for k, v in d.items()}
    want = {"attn": JA.sharded_decode_attention(
        mesh, j["q"], j["k"], j["v"], j["lengths"], j["wo"],
        interpret=True)}
    for lay in range(LN):
        want[f"stack{lay}"] = JA.sharded_decode_attention(
            mesh, j["q"], j["ks"], j["vs"], j["lengths"], j["wo"],
            layer=jnp.asarray(lay, jnp.int32), interpret=True)
    want["paged"] = JA.sharded_paged_decode_attention(
        mesh, j["q"], j["kp"], j["vp"], j["table"], j["plen"], j["wo"],
        interpret=True)
    want["paged_int8"] = JA.sharded_paged_decode_attention(
        mesh, j["q"], j["kc"], j["vc"], j["table"], j["plen"],
        {"q": j["woq"], "s": j["wos"]}, interpret=True,
        k_scale=j["ksc"], v_scale=j["vsc"], k_tail=j["kt"], v_tail=j["vt"])
    return {k: np.asarray(v) for k, v in want.items()}


def _world_args(tmp, tiny, d, name):
    _, _, model, _ = tiny
    np.savez(tmp / f"{name}-data.npz", **d)
    torch.save(model.state_dict(), tmp / f"{name}-state.pt")
    return {"data": str(tmp / f"{name}-data.npz"),
            "state": str(tmp / f"{name}-state.pt"),
            "ckpt": str(tmp / f"{name}-ckpt"),
            "hq": HQ, "hkv": HKV, "ln": LN}


def _check_attention(res, want):
    for r, out in enumerate(res):
        for key, ref in want.items():
            for tag in ("ker", "ref"):
                np.testing.assert_allclose(
                    out[f"{key}_{tag}"].numpy(), ref, rtol=TOL, atol=TOL,
                    err_msg=f"rank {r} {key} {tag}")
        # every rank holds the same all-reduced projection, bit for bit
        assert all(torch.equal(out[k], res[0][k]) for k in out
                   if k.endswith(("_ker", "_ref")))
        assert all("not divisible" in e for e in out["indivisible"])
        assert not out["jax_imported"]


@pytest.mark.parametrize("tp", [2, 4])
def test_sharded_wrappers_and_generate(tmp_path, tiny, tp):
    """(a) and (b) in one gloo world of ``tp`` ranks."""
    jcfg, jparams, model, cfg = tiny
    d = _inputs()
    world = World(tmp_path, f"ab{tp}", tp, CHILD_AB,
                  _world_args(tmp_path, tiny, d, f"ab{tp}"))
    want = _jax_attention(d, tp)
    prompt = d["prompt"]
    jmesh = jax_mesh(tp)
    jgen = np.asarray(JD.generate(
        JD.shard_params_for_serving(jparams, jcfg, jmesh), jcfg,
        jnp.asarray(prompt, jnp.int32), max_new_tokens=8, max_len=64,
        mesh=jmesh))
    with torch.inference_mode():
        tp1 = D.generate(model, cfg, torch.as_tensor(prompt),
                         max_new_tokens=8, max_len=64).numpy()
    if tp == 2:
        qparams = jax_quantize(jparams)
        jgen_q = np.asarray(JD.generate(
            JD.shard_params_for_serving(qparams, jcfg, jmesh), jcfg,
            jnp.asarray(prompt, jnp.int32), max_new_tokens=8, max_len=64,
            mesh=jmesh))
        qmodel, _ = make_model("tiny", device="cpu", dtype=torch.float32)
        qmodel.load_state_dict(model.state_dict())
        Q.quantize_params(qmodel)
        with torch.inference_mode():
            tp1_q = D.generate(qmodel, cfg, torch.as_tensor(prompt),
                               max_new_tokens=8, max_len=64).numpy()
    res = world.results()
    _check_attention(res, want)
    np.testing.assert_array_equal(tp1, jgen)
    for r, out in enumerate(res):
        np.testing.assert_array_equal(out["gen"].numpy(), jgen,
                                      err_msg=f"rank {r}")
        np.testing.assert_array_equal(out["gen_kernel"].numpy(), jgen,
                                      err_msg=f"rank {r}")
    if tp == 2:
        for out in res:
            np.testing.assert_array_equal(out["gen_int8"].numpy(), jgen_q)
            assert out["init_equal"] and out["contiguous"]
            assert out["ckpt_equal"]
            # column-parallel wq cut by columns; row-parallel wo keeps
            # every scale, column-parallel w1 its columns' scales
            assert out["wq_shape"] == (cfg.dim, cfg.dim // 2)
            assert out["wo_s_shape"] == (1, cfg.dim)
            assert out["w1_s_shape"] == (1, cfg.ffn_dim // 2)
        np.testing.assert_array_equal(tp1_q, jgen_q)


def test_indivisible_heads_route_to_fallback():
    """The port's kernel-eligibility rule is JAX's: tiny's 2 kv heads
    split over tp 2 (the sharded wrappers) but not over tp 4, where the
    attention stays whole and runs the plain einsum."""
    from paddle_operator_tpu.models.llama import CONFIGS as JC

    from paddle_operator_tpu_torch.models.llama import (CONFIGS,
                                                        ServingShardConfig,
                                                        serving_shard_config)

    for tp in (1, 2, 4, 8):
        assert CONFIGS["tiny"].decode_tp_compatible(tp) == \
            JC["tiny"].decode_tp_compatible(tp)
    c2 = serving_shard_config(CONFIGS["tiny"], 2)
    assert isinstance(c2, ServingShardConfig)
    assert (c2.n_heads, c2.n_kv_heads, c2.head_dim) == (2, 1, 16)
    assert serving_shard_config(c2, 2) is c2
    c4 = serving_shard_config(CONFIGS["tiny"], 4)
    assert (c4.n_heads, c4.n_kv_heads, c4.decode_attn) == (4, 2, "plain")
    assert serving_shard_config(CONFIGS["7b"], 4).n_kv_heads == 8
