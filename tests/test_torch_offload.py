"""Host offload of the optimizer's moments in the torch package
(``train/trainer.py`` ``create_state(offload_opt_state=True)``,
``MomentOffload``; the checkpoint's offloaded save and restore) — the
cases of tests/test_offload.py run on the port, with f32 and int8
moments: the trajectory equals the resident one, the moments stay in
host memory between steps, and the offloaded state checkpoints and
restores.

Tolerance: bit for bit.  Unlike the JAX package (whose explicit
transfers change XLA's fusion), the port runs the same update on the
same values wherever the moments live: the offload moves bytes, not
math.  The ``cuda``-marked cases run the same on the card (the staging
ring on its copy streams, pinned host memory, the kernel of
ops/adam8bit.py): ``python -m pytest tests/test_torch_offload.py -m
cuda``.  This file imports nothing of the JAX package.
"""

import numpy as np
import pytest
import torch

from paddle_operator_tpu_torch.models import llama as TL
from paddle_operator_tpu_torch.train import data as TD
from paddle_operator_tpu_torch.train import opt8bit as Q8
from paddle_operator_tpu_torch.train import trainer as TT
from paddle_operator_tpu_torch.train.checkpoint import CheckpointManager

B, S, VOCAB, SEED = 4, 33, 256, 11
MOMENTS = ["f32", "int8"]
# on the card: a head_dim the flash kernels take (64)
CARD = dict(dim=256, n_heads=4, n_kv_heads=2, ffn_dim=512)


def _run(moments, offload, steps=3, device="cpu", state=None, start=0,
         **overrides):
    """``steps`` steps of the tiny preset at f32 from seed 0 (or from
    ``state``); returns the state and the per-step metrics."""
    if state is None:
        model, _ = TL.make_model("tiny", device=device, seed=0,
                                 dtype=torch.float32, **overrides)
        opt = TT.make_optimizer(1e-3, warmup_steps=1, decay_steps=100,
                                moments=moments)
        state = TT.create_state(model, opt, offload_opt_state=offload)
    else:
        opt = TT.make_optimizer(1e-3, warmup_steps=1, decay_steps=100,
                                moments=moments)
    step = TT.make_train_step(opt)
    history = []
    batches = TD.deterministic_lm_batches(B, S, VOCAB, seed=SEED,
                                          start_step=start)
    for _ in range(steps):
        b = next(batches)
        state, m = step(state, {k: torch.as_tensor(v, device=device)
                                for k, v in b.items()})
        history.append({k: float(v) for k, v in m.items()})
    return state, history


def _moments(state):
    return {f"{field}/{name}": t for field, tensors in
            state.opt_state.tensors().items() for name, t in tensors.items()}


def _assert_equal_states(a, b):
    assert a.step == b.step and a.opt_state.count == b.opt_state.count
    for (k, x), (k2, y) in zip(a.model.state_dict().items(),
                               b.model.state_dict().items()):
        assert k == k2 and torch.equal(x.cpu(), y.cpu()), k
    ma, mb = _moments(a), _moments(b)
    assert ma.keys() == mb.keys()
    for k in ma:
        assert torch.equal(ma[k].cpu(), mb[k].cpu()), k


@pytest.mark.parametrize("moments", MOMENTS)
class TestOffload:
    def test_trajectory_matches_resident(self, moments):
        """tests/test_offload.py:41 on the port, bit for bit."""
        ref_state, ref = _run(moments, offload=False)
        got_state, got = _run(moments, offload=True)
        assert got == ref
        _assert_equal_states(got_state, ref_state)

    def test_opt_state_stays_in_host_memory(self, moments):
        """tests/test_offload.py:47 on the port: the moments stay host
        tensors (the same objects, updated in place), the staging ring
        holds them only inside the update."""
        state, _ = _run(moments, offload=True, steps=1)
        before = {k: (t.data_ptr(), t) for k, t in _moments(state).items()}
        state, _ = _run(moments, True, steps=1, state=state, start=1)
        after = _moments(state)
        assert after.keys() == before.keys()
        for k, t in after.items():
            assert t.device.type == "cpu" and t.data_ptr() == before[k][0]
        off = state.opt_state.offload
        assert isinstance(off, TT.MomentOffload)
        assert len(off._staging) == TT.MomentOffload.SLOTS
        n = len(state.opt_state.FIELDS)
        per = [max(t.numel() for name, t in _moments(state).items()
                   if name.startswith(field + "/"))
               for field in state.opt_state.FIELDS]
        assert [t.numel() for t in off._staging[0]] == per and n == len(per)
        assert off.bytes_each_way == sum(
            t.numel() * t.element_size() for t in after.values())

    def test_checkpointable(self, moments, tmp_path):
        """tests/test_offload.py:59 on the port: an offloaded state saves
        and restores like a resident one (into its host tensors), and
        the continued run equals the unbroken one."""
        state, _ = _run(moments, offload=True, steps=2)
        mgr = CheckpointManager(path=str(tmp_path))
        mgr.save(2, state, force=True)
        mgr.wait()
        fresh, _ = _run(moments, offload=True, steps=0)
        ptrs = {k: t.data_ptr() for k, t in _moments(fresh).items()}
        restored = mgr.restore(fresh)
        _assert_equal_states(restored, state)
        assert {k: t.data_ptr() for k, t in _moments(restored).items()} \
            == ptrs
        cont, hist = _run(moments, True, steps=1, state=restored, start=2)
        ref, ref_hist = _run(moments, offload=False, steps=3)
        assert hist == ref_hist[2:]
        _assert_equal_states(cont, ref)
        # a resident state restores the offloaded checkpoint too
        res, _ = _run(moments, offload=False, steps=0)
        _assert_equal_states(mgr.restore(res), state)
        mgr.close()


def test_moments_of_another_kind_are_refused(tmp_path):
    state, _ = _run("int8", offload=True, steps=1)
    mgr = CheckpointManager(path=str(tmp_path))
    mgr.save(1, state, force=True)
    mgr.wait()
    other, _ = _run("f32", offload=False, steps=0)
    before = {k: v.clone() for k, v in other.model.state_dict().items()}
    with pytest.raises(ValueError, match="int8 moments"):
        mgr.restore(other)
    for k, v in other.model.state_dict().items():
        assert torch.equal(v, before[k])       # nothing changed


@pytest.mark.parametrize("moments", MOMENTS)
def test_serving_restore_ignores_the_moments(moments, tmp_path):
    """``load_serving_params`` reads ``params.pt`` alone, whatever the
    moments in ``opt.pt``: the served model is the state's parameters in
    the serving dtype."""
    from paddle_operator_tpu_torch.infer import serve as S

    state, _ = _run(moments, offload=True, steps=1)
    mgr = CheckpointManager(path=str(tmp_path))
    mgr.save(1, state, force=True)
    mgr.close()
    model, cfg, resumed = S.load_serving_params(
        str(tmp_path), TL.CONFIGS["tiny"], device="cpu")
    assert resumed and cfg.param_dtype == torch.bfloat16
    want = state.model.state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k].to(torch.bfloat16)), k


def test_int8_state_layout():
    """One int8 code per value (rows padded to 256) and one f32 scale
    per 256 codes, for each moment."""
    state, _ = _run("int8", offload=True, steps=0)
    want = sum(int(np.prod(Q8.blocked_shape(p.shape)))
               for p in state.model.parameters())
    got = _moments(state)
    assert all(isinstance(q, Q8.Q8) for q in state.opt_state.mu.values())
    for moment in ("mu", "nu"):
        codes = [t for k, t in got.items() if k.startswith(moment + "_codes")]
        scales = [t for k, t in got.items()
                  if k.startswith(moment + "_scales")]
        assert sum(t.numel() for t in codes) == want
        assert sum(t.numel() for t in scales) * Q8.BLOCK == want
        assert {t.dtype for t in codes} == {torch.int8}
        assert {t.dtype for t in scales} == {torch.float32}


@pytest.mark.cuda
class TestOnCard:
    """The same on the card: the copy streams and pinned host memory."""

    @pytest.fixture(autouse=True)
    def _card(self):
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA card")

    @pytest.mark.parametrize("moments", MOMENTS)
    def test_offload_equals_resident_and_pins(self, moments):
        ref_state, ref = _run(moments, False, device="cuda", **CARD)
        got_state, got = _run(moments, True, device="cuda", **CARD)
        assert got == ref
        got_state.opt_state.offload.wait()
        _assert_equal_states(got_state, ref_state)
        for k, t in _moments(got_state).items():
            assert t.device.type == "cpu" and t.is_pinned(), k
        for k, t in _moments(ref_state).items():
            assert t.device.type == "cuda", k

    def test_restore_from_offloaded_int8_checkpoint(self, tmp_path):
        state, _ = _run("int8", True, steps=2, device="cuda", **CARD)
        mgr = CheckpointManager(path=str(tmp_path))
        mgr.save(2, state, force=True)
        mgr.wait()
        fresh, _ = _run("int8", True, steps=0, device="cuda", **CARD)
        restored = mgr.restore(fresh)
        for k, t in _moments(restored).items():
            assert t.is_pinned(), k
        _assert_equal_states(restored, state)
        cont, hist = _run("int8", True, steps=1, device="cuda",
                          state=restored, start=2)
        ref, ref_hist = _run("int8", False, steps=3, device="cuda", **CARD)
        assert hist == ref_hist[2:]
        cont.opt_state.offload.wait()
        _assert_equal_states(cont, ref)
        mgr.close()

    def test_update_launches_the_kernel(self):
        from paddle_operator_tpu_torch.ops import adam8bit as A8

        n0 = A8.adam8bit_update.launches
        state, _ = _run("int8", True, steps=2, device="cuda", **CARD)
        tensors = len(list(state.model.parameters()))
        assert A8.adam8bit_update.launches - n0 == 2 * tensors
        assert np.isfinite([float(p.detach().sum()) for p in
                            state.model.parameters()]).all()
