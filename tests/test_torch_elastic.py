"""The torch package's elastic resume (paddle_operator_tpu_torch/ft/
elastic.py) held against the JAX package's ft/elastic.py: the
continuity math of tests/test_ft_elastic.py (``:108``, ``:114``,
``:127``, ``:135``) through both, and the resume plan over the port's
``CheckpointManager`` with a real train state, its restore booked under
goodput's ``restore``.  Exact: integer arithmetic and one schedule.
"""

import itertools

import pytest
import torch

from paddle_operator_tpu.ft import elastic as JE
from paddle_operator_tpu_torch.ft import elastic as TE
from paddle_operator_tpu_torch.ft.goodput import GoodputTracker
from paddle_operator_tpu_torch.models import llama as TL
from paddle_operator_tpu_torch.train import data as TD
from paddle_operator_tpu_torch.train import trainer as TT
from paddle_operator_tpu_torch.train.checkpoint import CheckpointManager


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
