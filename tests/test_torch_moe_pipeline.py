"""The torch package's MoE pipeline step (the pp train step of
train/trainer.py with MoE stages: parallel/pipeline.py's ``has_aux``,
the microbatch rows regrouped as JAX cuts its global batch, the aux
summed over a stage's live microbatches and over pp, divided by M) held
against the JAX package's ``make_step_for_mesh`` on pp2 x ep2 x dp2
(tests/test_moe_train.py ``test_pp_moe_reports_aux`` and
``test_top2_under_both_pipeline_schedules``), in one job of 8 spawned
gloo ranks through the launcher shim: GPipe and 1F1B at M 2, top-1
(``tiny-moe``) and top-2 (``tiny-moe2``), each at the capacity factor
1.25 and 0.5, three steps from the JAX init at f32 — losses,
``aux_loss`` and grad norms rtol 1e-5, the saved parameters atol 1e-5,
every rank's metrics bit-equal, JAX's specs (a layer's stacked dim is
its pp stage), assignments dropped at 0.5.  The worlds without pp are
in tests/test_torch_moe_parallel.py.
"""

import numpy as np
import pytest
import torch

from paddle_operator_tpu.api.types import MeshSpec
from paddle_operator_tpu_torch.convert import params_from_jax
from paddle_operator_tpu_torch.models import llama as TL
from tests.test_torch_moe_parallel import (CFS, batches, case_name,
                                           check_case, finish_world,
                                           jax_init, jax_run, start_world)

AXES = {"pp": 2, "ep": 2, "dp": 2}
M = 2
CASES = [(f"{sched}_{'top2' if preset == 'tiny-moe2' else 'top1'}", sched,
          preset) for sched in ("gpipe", "1f1b")
         for preset in ("tiny-moe", "tiny-moe2")]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_pp")
    data = batches()
    init = jax_init()
    torch.save(params_from_jax(init), tmp / "init.pt")
    np.savez(tmp / "batches.npz", **{f"b{i}": b for i, b in enumerate(data)})
    runs = [{"name": case_name(n, cf), "axes": AXES, "preset": preset,
             "cf": cf, "steps": len(data),
             "step": {"schedule": sched, "num_microbatches": M},
             "ckpt": str(tmp / f"ckpt-{n}-{cf}")}
            for n, sched, preset in CASES for cf in CFS]
    started = start_world(tmp, "moe-pp", 1, 8, MeshSpec(**AXES),
                          {"init": str(tmp / "init.pt"),
                           "batches": str(tmp / "batches.npz"),
                           "runs": runs, "writers": []})
    try:
        want = {r["name"]: jax_run(AXES, r["preset"], r["cf"], data, init,
                                   step_kw=r["step"])
                for r in runs}
    finally:
        res = finish_world(started)
    return {"res": res, "want": want, "tmp": tmp}


@pytest.mark.parametrize("name,cf", [(n, cf) for n, _, _ in CASES
                                     for cf in CFS])
def test_pp_ep_dp_moe_step_matches_jax(world, name, cf):
    key = case_name(name, cf)
    runs = check_case(world["res"], key, world["want"][key], AXES,
                      world["tmp"] / f"ckpt-{name}-{cf}", cf)
    # a rank holds its stage's layer (tiny-moe: one a stage) and every
    # parameter replicated over pp
    for run in runs:
        held = {TL.layer_index(k) for k in run["specs"]} - {None}
        assert held == {run["coords"]["pp"]}
    assert not any(r["jax_imported"] for r in world["res"])
