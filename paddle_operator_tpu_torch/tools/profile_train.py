"""Where a training step's time goes, on the card.

    python3 -m paddle_operator_tpu_torch.tools.profile_train \\
        [--preset 7b] [--layers 8] [--batch 4] [--seq 2048] [--steps 4]

Fresh-inits the preset from seed 0 (f32 params, bf16 compute, full
remat) cut to ``--layers`` layers, and drives ``train/trainer.py``
``make_train_step`` on one repeated batch of ``--batch`` rows of
``--seq + 1`` tokens (two warm-up steps first).  It times ``--steps``
steps on the host clock (synchronized), then profiles ``--steps`` more
with ``torch.profiler``, one step per session: device busy ms per step
(the sum of kernel times), the device's idle share of the step, the
flash kernels' launches per step, the kernel time by class (flash
kernels, GEMMs, everything else) and the kernels that take the most
device time.  The same is measured for the forward and backward alone
(no optimizer update), so the difference prices the update.  Prints
one JSON object.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from paddle_operator_tpu_torch.models.llama import make_model
from paddle_operator_tpu_torch.ops import flash_attention as FA
from paddle_operator_tpu_torch.tools.profile_decode import _measure
from paddle_operator_tpu_torch.train import trainer as T


def kernel_class(name: str) -> str:
    """flash / gemm / other, from a device kernel's name."""
    low = name.lower()
    if "flash_fwd" in low or "flash_bwd" in low:
        return "flash"
    if any(s in low for s in ("gemm", "nvjet", "xmma", "cutlass", "sm90_")):
        return "gemm"
    return "other"


def run(preset: str, layers: int, batch: int, seq: int, steps: int,
        lr: float) -> dict:
    model, cfg = make_model(preset, device="cuda", seed=0, n_layers=layers)
    opt = T.make_optimizer(lr, warmup_steps=1, decay_steps=1000)
    state = {"s": T.create_state(model, opt)}
    step = T.make_train_step(opt)
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (batch, seq + 1), dtype=np.int32)
    b = {"tokens": torch.as_tensor(tokens, device="cuda")}

    def unit():
        state["s"], _ = step(state["s"], b)

    def grads_only():
        for p in model.parameters():
            p.grad = None
        tokens = b["tokens"]
        loss, _ = T.cross_entropy_loss(model(tokens[:, :-1]), tokens[:, 1:])
        loss.backward()

    for _ in range(2):
        unit()
    FA.flash_forward.launches = 0
    m = _measure(unit, steps)
    fwd_per_step = FA.flash_forward.launches / (2 * steps)
    g = _measure(grads_only, steps)
    return {"preset": preset, "layers": layers, "batch": batch, "seq": seq,
            "dtype": str(cfg.dtype), "remat": cfg.remat,
            "wall_ms_per_step": m["wall_ms"],
            "device_busy_ms_per_step": m["device_busy_ms"],
            "device_idle_share": m["device_idle_share"],
            "launches_per_step": m["launches"],
            "flash_fwd_launches_per_step": fwd_per_step,
            "device_ms_by_class": _by_class(m),
            "top_kernels": m["top_kernels"],
            "grads_only": {
                "wall_ms": g["wall_ms"], "device_busy_ms": g["device_busy_ms"],
                "device_idle_share": g["device_idle_share"],
                "launches": g["launches"],
                "device_ms_by_class": _by_class(g)}}


def _by_class(m: dict) -> dict:
    out = {}
    for k in m["all_kernels"]:
        c = kernel_class(k["name"])
        out[c] = out.get(c, 0.0) + k["ms"]
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="7b")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=4,
                    help="steps timed and profiled")
    ap.add_argument("--lr", type=float, default=1e-3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train needs a CUDA card")
    row = run(args.preset, args.layers, args.batch, args.seq, args.steps,
              args.lr)
    row["device"] = torch.cuda.get_device_name(0)
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
