"""Where a decode step's time goes, on the card.

    python3 -m paddle_operator_tpu_torch.tools.profile_decode \\
        [--preset 7b] [--batch 4] [--prompt 512] [--steps 8]

Fresh-inits the preset in bf16 from seed 0, prefills a random prompt,
then for each decode-attention selection ("kernel", "plain", "kernel"
again — in turns, on one card) times ``--steps`` decode steps on the
host clock (synchronized) and profiles the same number of steps with
``torch.profiler``: device busy time per step (the sum of kernel
times), the device's idle share of the step, and the kernels that take
the most device time.  Prints one JSON object per selection.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from paddle_operator_tpu_torch.infer import decode as D
from paddle_operator_tpu_torch.models.llama import CONFIGS, make_model


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def run(params, cfg, prompt, steps: int) -> dict:
    with torch.inference_mode():
        logits, cache = D.prefill(params, cfg, prompt)
        tok = logits.argmax(-1).to(torch.int32)
        for _ in range(3):
            logits, cache = D.decode_step(params, cfg, tok, cache)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(steps):
            logits, cache = D.decode_step(params, cfg, tok, cache)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / steps * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(steps):
                logits, cache = D.decode_step(params, cfg, tok, cache)
            torch.cuda.synchronize()
    # device-side events only: the aten ops that launched them carry the
    # same time again as their own device total
    kernels = [(e.key, _device_us(e) / steps / 1e3, e.count // steps)
               for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and _device_us(e) > 0]
    kernels.sort(key=lambda k: -k[1])
    busy = sum(k[1] for k in kernels)
    return {
        "decode_attn": cfg.decode_attn,
        "batch": prompt.shape[0],
        "fill_at_start": prompt.shape[1] + 3,
        "wall_ms_per_step": wall_ms,
        "device_busy_ms_per_step": busy,
        "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
        "top_kernels": [{"name": n[:90], "ms_per_step": ms,
                         "calls_per_step": c}
                        for n, ms, c in kernels[:10]],
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode needs a CUDA card")
    params, cfg = make_model(args.preset, device="cuda", seed=0,
                             param_dtype=CONFIGS[args.preset].dtype)
    prompt = torch.as_tensor(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (args.batch, args.prompt)), dtype=torch.int32,
        device="cuda")
    for impl in ("kernel", "plain", "kernel"):
        row = run(params, dataclasses.replace(cfg, decode_attn=impl),
                  prompt, args.steps)
        row["device"] = torch.cuda.get_device_name(0)
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
