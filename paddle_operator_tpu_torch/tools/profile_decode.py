"""Where a decode step's time goes, on the card.

    python3 -m paddle_operator_tpu_torch.tools.profile_decode \\
        [--preset 7b] [--batch 4] [--prompt 512] [--steps 8]
    python3 -m paddle_operator_tpu_torch.tools.profile_decode --ring \\
        [--preset 7b] [--slots 8] [--chunk 8] [--block-size 256] \\
        [--prompt 512] [--steps 8]

Fresh-inits the preset in bf16 from seed 0.  For each decode-attention
selection ("kernel", "plain", "kernel" again — in turns, on one card)
it times ``--steps`` units of work on the host clock (synchronized) and
profiles the same number with ``torch.profiler``, one unit per profiler
session so that no trace overflows: device busy time per unit (the sum
of kernel times), the device's idle share of the unit, and the kernels
that take the most device time.  Prints one JSON object per selection.

- batch mode (the default): the unit is one ``decode_step`` of a batch
  of ``--batch`` random prompts of ``--prompt`` tokens, after prefill.
- ``--ring``: the unit is one chunk of the continuous paged ring
  (infer/executor.py ``RingExecutor.replay``, ``--chunk`` ticks) with
  all ``--slots`` lanes resident, each admitted through the cold paged
  prefill of a random ``--prompt``-token prompt; ``--block-size`` is
  the pool's block size.  ``trace_complete`` says whether the traces
  hold every paged-kernel launch the wrapper counted; a turn where they
  do not has lost events and its device numbers are low.
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


def _measure(unit, steps: int) -> dict:
    """Host-clock ms per ``unit()`` over ``steps`` synchronized calls,
    then ``steps`` more, each in a profiler session of its own: device
    busy ms per unit, idle share, top kernels (and all kernels)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        unit()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    totals = {}                                  # kernel -> [us, calls]
    for _ in range(steps):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            unit()
            torch.cuda.synchronize()
        # device-side events only: the aten ops that launched them carry
        # the same time again as their own device total
        for e in prof.key_averages():
            if e.device_type == DeviceType.CUDA and _device_us(e) > 0:
                t = totals.setdefault(e.key, [0.0, 0])
                t[0] += _device_us(e)
                t[1] += e.count
    kernels = [(k, us / steps / 1e3, n / steps)
               for k, (us, n) in totals.items()]
    kernels.sort(key=lambda k: -k[1])
    busy = sum(k[1] for k in kernels)
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy,
        "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
        "launches": sum(k[2] for k in kernels),
        "paged_kernel_calls": sum(k[2] for k in kernels
                                  if "paged_decode_attention" in k[0]),
        "top_kernels": [{"name": n[:90], "ms": ms, "calls": c}
                        for n, ms, c in kernels[:10]],
        "all_kernels": [{"name": n, "ms": ms, "calls": c}
                        for n, ms, c in kernels],
    }


def run(params, cfg, prompt, steps: int) -> dict:
    """Batch mode: one decode step of ``prompt``'s batch is the unit."""
    with torch.inference_mode():
        logits, cache = D.prefill(params, cfg, prompt)
        tok = logits.argmax(-1).to(torch.int32)
        state = {"cache": cache}
        for _ in range(3):
            _, state["cache"] = D.decode_step(params, cfg, tok,
                                              state["cache"])

        def unit():
            _, state["cache"] = D.decode_step(params, cfg, tok,
                                              state["cache"])

        m = _measure(unit, steps)
    return {"mode": "batch", "decode_attn": cfg.decode_attn,
            "batch": prompt.shape[0], "fill_at_start": prompt.shape[1] + 3,
            "wall_ms_per_step": m["wall_ms"],
            "device_busy_ms_per_step": m["device_busy_ms"],
            "device_idle_share": m["device_idle_share"],
            "launches_per_step": m["launches"],
            "top_kernels": m["top_kernels"]}


def run_ring(params, cfg, prompts: np.ndarray, *, chunk: int,
             block_size: int, steps: int) -> dict:
    """Ring mode: one chunk of the paged ring with every lane resident
    is the unit.  Lanes are admitted through the ring's own cold paged
    insert; their positions advance with every chunk, so the fill
    grows by ``chunk`` per unit."""
    from paddle_operator_tpu_torch.infer import executor as X
    from paddle_operator_tpu_torch.ops import decode_attention as DA

    slots, n = prompts.shape
    max_len = n + (2 * steps + 4) * chunk
    ex = X.RingExecutor(params, cfg, slots=slots, max_len=max_len,
                        chunk_tokens=chunk, paged=True,
                        block_size=block_size)
    bucket = next(b for b in ex.buckets if n <= b)
    state = {"pos": n}
    with torch.inference_mode():
        for slot in range(slots):
            ex.pool.admit(slot, prompts[slot].tolist())
            row = X.to_device(ex.pool.table[slot], ex.device, torch.int32)
            ex.inserts[bucket](
                ex.params, ex.cache, row, ex.tok, ex.temp, ex.seeds,
                X.to_device(prompts[slot:slot + 1], ex.device), n, slot,
                0.0, 0)

        def unit():
            for slot in range(slots):
                ex.pool.ensure(slot, state["pos"] + chunk)
            res = ex.replay(X.ExecPlan(1, [True] * slots,
                                       table=ex.pool.table))
            res.host_toks()
            state["pos"] += chunk

        unit()                                    # warm-up chunk
        DA.paged_decode_attention.launches = 0
        fill = state["pos"]
        m = _measure(unit, steps)
        paged = DA.paged_decode_attention.launches / (2 * steps)
    return {"mode": "ring", "decode_attn": cfg.decode_attn,
            "slots": slots, "chunk": chunk, "block_size": block_size,
            "fill_at_start": fill,
            "wall_ms_per_chunk": m["wall_ms"],
            "device_busy_ms_per_chunk": m["device_busy_ms"],
            "device_idle_share": m["device_idle_share"],
            "launches_per_chunk": m["launches"],
            "paged_kernel_launches_per_chunk": paged,
            "trace_paged_kernel_calls_per_chunk": m["paged_kernel_calls"],
            "trace_complete": m["paged_kernel_calls"] == paged,
            "top_kernels": m["top_kernels"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--preset", default="7b")
    ap.add_argument("--ring", action="store_true",
                    help="profile one chunk of the continuous paged ring")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--slots", type=int, default=8)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--block-size", type=int, default=256)
    ap.add_argument("--prompt", type=int, default=512)
    ap.add_argument("--steps", type=int, default=8,
                    help="units timed and profiled")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode needs a CUDA card")
    params, cfg = make_model(args.preset, device="cuda", seed=0,
                             param_dtype=CONFIGS[args.preset].dtype)
    rng = np.random.default_rng(0)
    rows = args.slots if args.ring else args.batch
    prompts = rng.integers(0, cfg.vocab_size, (rows, args.prompt),
                           dtype=np.int32)
    for impl in ("kernel", "plain", "kernel"):
        icfg = dataclasses.replace(cfg, decode_attn=impl)
        if args.ring:
            row = run_ring(params, icfg, prompts, chunk=args.chunk,
                           block_size=args.block_size, steps=args.steps)
        else:
            row = run(params, icfg, torch.as_tensor(prompts, device="cuda"),
                      args.steps)
        row["device"] = torch.cuda.get_device_name(0)
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
