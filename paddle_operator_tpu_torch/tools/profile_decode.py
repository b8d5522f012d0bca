"""Where a decode step's time goes, on the card.

    python3 -m paddle_operator_tpu_torch.tools.profile_decode \\
        [--preset 7b] [--batch 4] [--prompt 512] [--steps 8]
    python3 -m paddle_operator_tpu_torch.tools.profile_decode --ring \\
        [--preset 7b] [--slots 8] [--chunk 8] [--block-size 256] \\
        [--prompt 512] [--steps 8] [--kv-quant int8] [--megastep N]

Fresh-inits the preset in bf16 from seed 0.  For each turn it times
``--steps`` units of work on the host clock (synchronized) and between
CUDA events on the stream, and profiles the same number with
``torch.profiler``, one unit per profiler session so that no trace
overflows: device busy time per unit (the sum of kernel times), the
device's idle share of the unit, and the kernels that take the most
device time.  Prints one JSON object per turn, with the card's name and
power limit.

- batch mode (the default): the unit is one ``decode_step`` of a batch
  of ``--batch`` random prompts of ``--prompt`` tokens, after prefill;
  ``decode_kernel_ms_per_step`` is kernel #1's device time in it.  The
  turns are the decode-attention selections "kernel", "plain", "kernel".
- ``--ring``: the unit is one dispatch of the continuous paged ring
  with all ``--slots`` lanes resident, each admitted through the cold
  paged prefill of a random ``--prompt``-token prompt; ``--block-size``
  is the pool's block size.  A dispatch is ``--megastep`` chunks of
  ``--chunk`` ticks (default 1: one chunk), every lane live throughout.
  The turns are "graph", "eager", "graph", "eager": the dispatch as the
  ring runs it on the card (infer/executor.py ``RingExecutor.replay``,
  a CUDA graph replay), and the same program called directly
  (``RingExecutor.run``: ``executor.step`` or the N-step program,
  launched op by op from Python).  Each row gives its numbers per
  dispatch and per token (slots x chunk x megastep tokens a dispatch),
  and the graphs' capture seconds and memory pool bytes.
  ``trace_complete`` says whether the traces hold every paged-kernel
  launch the wrapper counted; a turn where they do not has lost events
  and its device numbers are low.
  ``--kv-quant int8`` runs the ring over the int8 pool: the counted
  kernel is the int8 one, and ``commit_device_ms_per_chunk`` is the
  device time of the quantize-on-completion writes (the
  ``kv_quant_commit`` range of infer/paged.py ``paged_ring_forward``).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from paddle_operator_tpu_torch.infer import decode as D
from paddle_operator_tpu_torch.models.llama import CONFIGS, make_model


def _device_us(evt, self_time: bool = True) -> float:
    """An event's device time: its own (a kernel), or with
    ``self_time=False`` that of the kernels launched inside it (a
    CPU-side ``record_function`` range)."""
    prefix = "self_" if self_time else ""
    for attr in (f"{prefix}device_time_total", f"{prefix}cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def _measure(unit, steps: int, ranges=()) -> dict:
    """Host-clock ms per ``unit()`` over ``steps`` synchronized calls,
    then ``steps`` more, each in a profiler session of its own: device
    busy ms per unit, idle share, top kernels (and all kernels), and the
    device ms per unit of the kernels launched inside each
    ``record_function`` range named in ``ranges``."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(steps):
        unit()
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    stream_ms = start.elapsed_time(end) / steps
    totals = {}                                  # kernel -> [us, calls]
    in_ranges = {name: 0.0 for name in ranges}   # range -> device us
    for _ in range(steps):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            unit()
            torch.cuda.synchronize()
        # device-side events only: the aten ops that launched them carry
        # the same time again as their own device total, and a
        # record_function range appears there too, as a device-side
        # annotation spanning the kernels it launched
        for e in prof.key_averages():
            if e.key in in_ranges and e.device_type == DeviceType.CPU:
                in_ranges[e.key] += _device_us(e, self_time=False)
            if (e.device_type == DeviceType.CUDA and _device_us(e) > 0
                    and not getattr(e, "is_user_annotation", False)
                    and e.key not in in_ranges):
                t = totals.setdefault(e.key, [0.0, 0])
                t[0] += _device_us(e)
                t[1] += e.count
    kernels = [(k, us / steps / 1e3, n / steps)
               for k, (us, n) in totals.items()]
    kernels.sort(key=lambda k: -k[1])
    busy = sum(k[1] for k in kernels)
    return {
        "wall_ms": wall_ms,
        "stream_ms": stream_ms,
        "device_busy_ms": busy,
        "device_idle_share": max(0.0, 1.0 - busy / wall_ms),
        "launches": sum(k[2] for k in kernels),
        "paged_kernel_calls": sum(k[2] for k in kernels
                                  if "paged_decode_attention" in k[0]),
        "top_kernels": [{"name": n[:90], "ms": ms, "calls": c}
                        for n, ms, c in kernels[:10]],
        "all_kernels": [{"name": n, "ms": ms, "calls": c}
                        for n, ms, c in kernels],
        "ranges_ms": {k: us / steps / 1e3 for k, us in in_ranges.items()},
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
            "decode_kernel_ms_per_step": sum(
                k["ms"] for k in m["all_kernels"]
                if "decode_attention_kernel" in k["name"]
                and "paged" not in k["name"]),
            "top_kernels": m["top_kernels"]}


def run_ring(params, cfg, prompts: np.ndarray, *, chunk: int,
             block_size: int, steps: int, kv_quant: str = "none",
             megastep: int = 1, graph: bool = True) -> dict:
    """Ring mode: one dispatch of the paged ring with every lane
    resident is the unit — ``megastep`` chunks, replayed as a CUDA graph
    (``graph``) or the same program called eagerly.  Lanes are admitted
    through the ring's own cold paged insert after the graphs are
    captured (capture needs an empty ring); their positions advance with
    every dispatch, so the fill grows by ``chunk x megastep`` per unit.
    ``kv_quant="int8"``: the int8 pool."""
    from paddle_operator_tpu_torch.infer import executor as X
    from paddle_operator_tpu_torch.ops import decode_attention as DA

    slots, n = prompts.shape
    advance = chunk * megastep
    max_len = n + (2 * steps + 4) * advance
    ex = X.RingExecutor(params, cfg, slots=slots, max_len=max_len,
                        chunk_tokens=chunk, paged=True,
                        block_size=block_size, kv_quant=kv_quant,
                        megastep=megastep)
    quant = kv_quant != "none"
    bucket = next(b for b in ex.buckets if n <= b)
    state = {"pos": n}
    full = np.full(slots, 1 << 20, np.int32)
    with torch.inference_mode():
        ex.prewarm()                              # capture: ring empty
        for slot in range(slots):
            ex.pool.admit(slot, prompts[slot].tolist())
            row = X.to_device(ex.pool.table[slot], ex.device, torch.int32)
            ex.inserts[bucket](
                ex.params, ex.cache, row, ex.tok, ex.temp, ex.seeds,
                X.to_device(prompts[slot:slot + 1], ex.device), n, slot,
                0.0, 0)

        def unit():
            for slot in range(slots):
                ex.pool.ensure(slot, state["pos"] + advance)
            plan = X.ExecPlan(megastep, [True] * slots, table=ex.pool.table,
                              eos=np.full(slots, -1, np.int32), left=full,
                              steps=np.full(slots, megastep, np.int32))
            if graph:
                ex.replay(plan).host()
            else:
                X.DispatchResult(*ex.run(plan), megastep).host()
            state["pos"] += advance

        unit()                                    # warm-up dispatch
        DA.paged_decode_attention.launches = 0
        DA.paged_decode_attention.quant_launches = 0
        fill = state["pos"]
        m = _measure(unit, steps, ranges=("kv_quant_commit",))
        paged = (DA.paged_decode_attention.quant_launches if quant
                 else DA.paged_decode_attention.launches) / (2 * steps)
    tokens = slots * advance
    out = {"mode": "ring", "dispatch": "graph" if graph else "eager",
           "decode_attn": cfg.decode_attn, "kv_quant": kv_quant,
           "megastep": megastep,
           "slots": slots, "chunk": chunk, "block_size": block_size,
           "pool_bytes": ex.pool_bytes(),
           "graph_capture_s": ex.capture_s,
           "graph_pool_bytes": ex.graph_pool_bytes(),
           "fill_at_start": fill,
           "wall_ms_per_dispatch": m["wall_ms"],
           "stream_ms_per_dispatch": m["stream_ms"],
           "device_busy_ms_per_dispatch": m["device_busy_ms"],
           "device_idle_share": m["device_idle_share"],
           "wall_ms_per_token": m["wall_ms"] / tokens,
           "device_busy_ms_per_token": m["device_busy_ms"] / tokens,
           "launches_per_dispatch": m["launches"],
           "paged_kernel_launches_per_dispatch": paged,
           "trace_paged_kernel_calls_per_dispatch": m["paged_kernel_calls"],
           "trace_complete": m["paged_kernel_calls"] == paged,
           "top_kernels": m["top_kernels"]}
    if quant:
        out["commit_device_ms_per_dispatch"] = \
            m["ranges_ms"]["kv_quant_commit"]
        out["quant_kernel_ms_per_dispatch"] = sum(
            k["ms"] for k in m["all_kernels"]
            if "paged_decode_attention_quant" in k["name"])
    return out


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
    ap.add_argument("--kv-quant", default="none", choices=("none", "int8"),
                    help="the ring's KV pool (with --ring)")
    ap.add_argument("--megastep", type=int, default=1,
                    help="chunks fused into one ring dispatch (with --ring)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()[0]
    params, cfg = make_model(args.preset, device="cuda", seed=0,
                             param_dtype=CONFIGS[args.preset].dtype)
    rng = np.random.default_rng(0)
    rows = args.slots if args.ring else args.batch
    prompts = rng.integers(0, cfg.vocab_size, (rows, args.prompt),
                           dtype=np.int32)
    turns = (("graph", "eager", "graph", "eager") if args.ring
             else ("kernel", "plain", "kernel"))
    for turn in turns:
        if args.ring:
            row = run_ring(params, cfg, prompts, chunk=args.chunk,
                           block_size=args.block_size, steps=args.steps,
                           kv_quant=args.kv_quant, megastep=args.megastep,
                           graph=turn == "graph")
        else:
            icfg = dataclasses.replace(cfg, decode_attn=turn)
            row = run(params, icfg, torch.as_tensor(prompts, device="cuda"),
                      args.steps)
        row["device"] = torch.cuda.get_device_name(0)
        row["card"] = card
        print(json.dumps(row), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
