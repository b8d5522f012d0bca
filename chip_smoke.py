#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py [--phases 2,2b,2c,2d,3,3b,3c,3d,3e,3f,3g,4,4b,4c,4d,
                           4e,4f]

Phases (any failure raises and the script exits non-zero, printing no
result line; with no arguments every phase runs):

1. build — compile every kernel source of the serving and training
   paths from ``paddle_operator_tpu_torch/csrc/`` (one nvcc each, in
   parallel); report each flash kernel instantiation's design, its
   registers, spill bytes and shared memory (``-Xptxas -v``), and the
   registers, spills and shared memory of the three decode kernels'
   instantiations (the paged ones with their tile ring's dynamic shared
   memory at D 128).
2. kernel vs plain — ``decode_attention`` against
   ``decode_attention_reference`` on the card: ragged lengths with 0, 1,
   a full cache and a non-multiple of any tile; the split's chunk edges
   (lengths 0, 1, chunk - 1, chunk, chunk + 1 and the whole cache, 1, 2
   and 4 query heads a block), a cache of one chunk and a stacked-layer
   view; MHA and GQA (n_rep 2, 4); D 64 and 128; float32
   (atol = rtol = 1e-4) and bfloat16 (atol 1e-2, against the plain
   version run in float32 on the bf16 inputs); the main path's shapes;
   the 7b shape at fills 128 and 2048; a length-0 lane gives zeros and
   two runs are bit-identical.  Then the kernel, the plain version and
   ``scaled_dot_product_attention`` (the library yardstick, never used
   by the port) are timed at the 7b shape at fills 128, 528 and 2048 —
   device time from CUDA-graph replay, eager time from one-by-one calls
   — beside the bound and the chunk count; with each, the call's device
   time at chunks of 64, 128, 256 and 512 rows.
2b. paged kernel vs plain — ``paged_decode_attention`` against
   ``paged_decode_attention_reference`` under scrambled block maps:
   ragged lengths {0, 1, full, not a multiple of bs}, bs 16 and 256,
   MHA and GQA (n_rep 2, 4), D 64 and 128, a stacked-layer index, the
   ring's 7b shapes; the split's chunk and block edges (lengths 0, 1,
   chunk - 1, chunk, chunk + 1, bs - 1, bs + 1 and the table's reach at
   bs 16 and 256, 1, 2 and 4 query heads a block, D 64 and 128, and a
   stacked-layer view); same tolerances as phase 2; a length-0 lane
   gives zeros and two runs are bit-identical.  Then timed at 7b, B=8,
   bs=256, fills 128, 528 and 2048, in turns: the paged kernel, its
   plain version, kernel #1 on the same rows laid out contiguously, and
   ``scaled_dot_product_attention`` on those contiguous rows (the same
   work without the table walk; never used by the port); with each, the
   call's device time at chunks of 64, 128, 256, 512, 1024 and 2048 rows
   (2048: one chunk a lane, no split; each setting checked once against
   the plain version).
2d. int8 paged kernel vs plain — ``paged_decode_attention`` with the
   int8 pool's operands (codes, scales, staging tails) against
   ``paged_decode_attention_quant_reference`` under scrambled block
   maps: lengths {0, 1, bs-1, bs, bs+1, full, not a multiple of bs}, bs
   16 and 256, n_rep 1/2/4, D 64 and 128, unstacked and a stacked-layer
   index, the ring's 7b shapes; float32 at atol = rtol = 1e-4, bfloat16
   against the plain version in float32 on the same codes and tails
   (code x scale rounded to bfloat16, as the function does) element by
   element (``BF16_ATOL``) and as a whole (``QUANT_BF16_REL``, the
   relative Frobenius error: at the 7b fills |out| is only a few times
   ``BF16_ATOL``); phase 2b's chunk and block edges; a length-0 lane
   gives zeros and two runs are bit-identical.  Then timed at 7b, B=8,
   bs=256, fills 128, 528 and 2048, in turns: the int8 kernel, its
   plain version, the bf16 paged kernel on the same logical rows, and
   ``scaled_dot_product_attention`` on those rows laid out contiguously
   in bf16 (a yardstick of the same attention without the dequant: no
   PyTorch call computes this function; never used by the port), with
   phase 2b's sweep of chunk rows.  At each timed fill
   the int8 kernel's output must equal, bit for bit, the bf16 paged
   kernel's on the rows dequantized and rounded to bfloat16.
2c. flash kernels vs plain — ``flash_forward`` (O and lse),
   ``flash_backward_dkv`` and ``flash_backward_dq`` each against its
   plain version on the same inputs (the backward kernels get the plain
   forward's lse and delta): causal and not, n_rep 1/2/4, D 64 and 128,
   S 1, 63, 64, 65, 127, 128, 129, 300 and 2048 (the edges of the bf16
   bodies' 64- and 128-row tiles), Sq 300 / Sk 700 and Sq 700 / Sk 300,
   with and without three-document segment ids, plus rows whose query
   id no key carries (o = 0, lse = 0); float32 at
   atol = rtol = 1e-4, bfloat16 against the plain version in float32
   element by element (``FLASH_BF16_ATOL``, one limit a kernel, and
   ``FLASH_BF16_RTOL``) and as a whole (``FLASH_BF16_REL``: the
   relative Frobenius error of each output, and of the forward's O
   over the main path's second half of rows, where |O| is small).  Two
   runs of each backward kernel are bit-identical.  Then timed at the
   7b training shape (B 4, H 32, D 128, causal, bf16) at S 512 and
   2048: each kernel, its plain version, ``scaled_dot_product_attention``
   forward, the library's flash backward (``aten.
   _scaled_dot_product_flash_attention_backward``: dQ, dK and dV in one
   call, the yardstick of the dK/dV + dQ pair) and SDPA
   forward+backward through autograd (library yardsticks, never used by
   the port) and the port's forward+backward, beside their bounds.
3. batch main path — 7b at full width and depth, bf16, fresh init from
   seed 0: the port's batch server answers three ``/v1/generate``
   requests over real HTTP; the kernel's launch count over exactly that
   run must equal n_layers x decode steps.  Then decode ms/token is
   timed.
3b. ring main path — the continuous paged server
   (``make_server(continuous=True, paged=True, slots=8, chunk_tokens=8,
   block_size=256, max_len=2048)``) on the same 7b model answers a
   concurrent burst over real HTTP: 8 cold prompts, 4 followers of one
   512-token prefix, 1 streamed request, then a resubmission (a full
   prefix hit).  The server is built with ``prewarm=True``, which
   captures the ring's resident program as a CUDA graph while the ring
   is empty (capture seconds and the graph pool's bytes are printed);
   every dispatch of the run must be a replay of it.  Launches of the
   paged kernel over exactly that run must equal n_layers x
   chunk_tokens x chunks dispatched, kernel #1 must not launch,
   followers prefill only their suffixes, the pool's invariant holds
   and every block ends free or cached.
3c. training main path — 7b at full width cut to 8 layers (f32
   params, bf16 compute, full remat), fresh init from seed 0:
   ``make_model`` -> ``create_state`` -> ``make_train_step`` -> ``fit``
   over a ``DevicePrefetcher`` for 12 steps of one repeated batch of
   4 x 2049 tokens.  The loss must fall below 0.7x its first value;
   the flash kernels' launches over exactly that run must equal
   2 x layers x steps (forward and the remat recompute) for the forward
   and layers x steps for each backward kernel, and the decode kernels
   must not launch.  Step ms (median after the first two steps),
   tokens/s, MFU and peak memory are reported.
3d. int8 ring main path — the continuous paged server over the int8
   pool (3b's ``make_server`` arguments with ``kv_quant="int8"``, the
   same 64-block pool) on the same 7b model: 3b's burst plus one
   follower whose shared prefix ends mid-block (the first 600 tokens of
   the 1000-token prompt), then the full-prefix resubmission.  The int8
   kernel's launches over exactly that run must equal n_layers x
   chunk_tokens x chunks dispatched, the bf16 paged kernel and kernel
   #1 must not launch, followers prefill only their suffixes, CoW runs,
   ``/statusz`` reports ``kvQuantMode`` int8, the pool's invariant
   holds and every block ends free or cached.  ``kvPoolBytes``, new
   tok/s and TTFT are printed beside 3b's.
3e. megastep main path — 3b's server with ``megastep=4`` (four chunks
   fused into one dispatch, one CUDA graph replay) under 3b's burst:
   every request's tokens must equal 3b's for the same prompt, token
   for token; the paged kernel's launches must equal n_layers x
   chunk_tokens x 4 x dispatches; ``/statusz`` reports ``megastepN`` 4
   and a ``dispatchesPerToken`` below 3b's.  New tok/s, TTFT p50/p95
   and wall ms per token are printed beside 3b's.
3f. checkpoint main path — 7b at full width cut to 2 layers (f32
   params, bf16 compute, full remat), B 4 x 2049 tokens from
   ``deterministic_lm_batches(seed=0)``, lr 1e-3, checkpoints under a
   ``tempfile.mkdtemp()`` removed at the end (its free space printed
   first).  (a) U: a fresh model from seed 0 trained 6 steps through
   ``fit`` with a ``CheckpointManager`` at ``save_interval_steps=3``:
   steps 3 and 6 commit; U2, the same run without a manager, gives the
   spread of two unbroken runs.  (b) R: a fresh model from seed 0 with a
   manager at interval 1000 and an installed ``PreemptionWatcher``;
   ``inject_preemption(at_step=2, signal_self=True)`` delivers a real
   SIGTERM: the watcher drains, the state stops at step 3, step 3 is
   committed by the drain alone and the log says ``checkpoint=saved``.
   (c) A fresh model from seed 1, restored by ``resume_or_init``: its
   step, count and every parameter, ``mu`` and ``nu`` equal R's in
   memory bit for bit.  (d) ``fit`` continues 3 steps from
   ``deterministic_lm_batches(seed=0, start_step=3)``: its losses equal
   U's steps 4-6 bit for bit, and so do its final params (two unbroken
   runs are bit-identical: ``CKPT``'s note).  The flash launches of
   every ``fit`` run are held to 3c's formulas.  (e)
   ``load_serving_params`` reads R's parameter file into bf16 on the
   card, adding no more than the bf16 parameter bytes plus
   ``SERVE_LOAD_MARGIN`` to the allocated memory; the served params
   equal R's cast in memory; 3b's paged server over each generates 32
   greedy tokens for 4 prompts, the two give the same tokens, and the
   paged kernel's launches equal n_layers x chunk_tokens x dispatches.
   The bytes of a checkpoint, how long ``save`` held the loop (the
   snapshot), the background write (s, GB/s) and the two restores are
   printed beside the card's name and power limit.
3g. preemption main path — 3b's server (``SERVE_PRIORITIES=2``,
   preemption at its default, on) on the bf16 pool and on the int8
   pool, each also with ``SERVE_PREEMPT=0`` on the same requests: 8
   class-1 requests (cold 512-token prompts, 192 new tokens, streamed)
   fill the 8 lanes; once every lane has decoded 2 chunks, 2 class-0
   requests (``X-Request-Priority: 0``, 512-token prompts, 32 new
   tokens, streamed) arrive.  With preemption on, ``preemptedLanes`` ==
   the restored lanes >= 1 and ``parkedLanes`` 0 at the end; with it
   off, none.  Every class-1 stream must equal the same request's
   stream from the ``SERVE_PREEMPT=0`` run, token for token; the pool's
   invariant holds after every spill and restore and at the end;
   ``kvBlocksFree`` plus the blocks the burst's prompts left cached
   equals its value before the burst; every dispatch is a replay of the
   prewarm graphs, whose state keeps its addresses; the paged kernel
   (#2, or #3 on the int8 pool) launches n_layers x chunk_tokens x
   dispatches, and after each restore n_layers x chunk_tokens for every
   replay.  Printed: the class-0 requests' time to first token and to
   completion and the class-1 token gaps (p95, max), both ways; each
   spill's ms (host, waits for its copies) and bytes, each restore's
   host and device ms (CUDA events around its queued copies and
   scatter); the launch and replay counts.
4. kernel path == plain path — 7b width, 2 layers, float32: greedy
   ``generate`` through the kernel and through the plain version give
   the same tokens, and per-step logits agree within 1e-3.
4b. paged ring == contiguous ring == ``generate`` — 7b width, 2
   layers, float32: four prompts, one a prefix hit, give identical
   greedy tokens through the paged ring (paged kernel), the contiguous
   ring (kernel #1) and ``generate``.
4d. int8 ring kernel path == plain path — 7b width, 2 layers, float32,
   bs 16: four prompts (one a block-aligned full hit, one a mid-block
   hit) give identical greedy tokens through the int8 ring with the
   kernel and with the plain dequantizing view; per-tick logits of one
   lane over 44 ticks, each tick from the same state, agree within
   1e-3; the worst logit delta of the int8 pool against the unquantized
   pool is reported, not gated.
4e. megastep == single step, graph == eager — 7b width, 2 layers,
   float32, on the contiguous, paged and int8 rings (bs 16), four
   prompts through ``ContinuousBatcher``: megastep 4 gives megastep 1's
   tokens, also with an eos that fires inside a fused iteration and,
   on the paged rings, with every lane's step budget cut to one
   iteration (lanes freeze mid-megastep and resume).  Then, on two
   executors driven from the same admissions, six dispatches (1-step
   and 4-step, with an eos, a budget that runs out and a frozen lane):
   each graph replay's tokens, counts, positions and lane tokens equal
   the eager program's bit for bit.
4f. restore under graphs — 7b width, 2 layers, float32, bs 16, on the
   paged ring at megastep 1 and 4 and the int8 ring at megastep 1 (2
   slots, chunk 8): lane A (40 tokens) decodes alone in slot 0, every
   dispatch a graph replay; at a boundary with its frontier mid-block
   it is spilled, lane B takes slot 0 for one dispatch, A is restored
   into slot 1 and both continue.  A's tokens must equal its
   uninterrupted run's bit for bit (graphs both), and the same spill and
   restore driven eagerly through the plain attention path (the token
   identity phases 4b and 4d hold); the state's addresses and the graphs
   are those from before the restore, and the paged kernel launched on
   the dispatches after it.
4c. training kernel path == plain path — 7b width, 2 layers, float32:
   three train steps with attention through the flash kernels and
   through ``reference_attention`` from the same init agree in loss
   (rtol 1e-5) and grad_norm (rtol 1e-4).
5. report — a ``kernels`` JSON line, the card's name and power limit,
   and as the last line ``{"ok": true, "device": {...}}``.

float32 matrix products run in full float32 (TF32 off) throughout.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory rate
PEAK_OPS = {"torch.bfloat16": 989e12, "torch.float32": 67e12}
# kernel sources: decode_attention.cu holds decode_attention_launch,
# paged_decode_attention_launch and paged_decode_attention_quant_launch;
# flash_attention.cu the forward and both backward kernels
KERNELS = ["decode_attention", "flash_attention"]
# bf16 kernels against their plain version in f32 on the same bf16
# inputs: about 3x the worst error read on the card over every case of
# phases 2 and 2b (1.9e-3 and 3.1e-3 on an H100 80GB HBM3 at 700 W)
BF16_ATOL = 1e-2
# bf16 flash kernels against their plain version in f32 on the same bf16
# inputs, element by element: |err| <= atol + rtol |want|.  rtol 2^-6
# covers a few bf16 roundings (the output's, p's, ds's); each kernel's
# atol is about 2.5x or more its own worst |err| - rtol |want| read on
# the card over every case of phase 2c in three runs (3.0e-3 forward,
# 1.2e-2 dK/dV, 5.5e-3 dQ on an H100 80GB HBM3 at 700 W)
FLASH_BF16_ATOL = {"flash_forward": 1e-2, "flash_backward_dkv": 3e-2,
                   "flash_backward_dq": 1.5e-2}
FLASH_BF16_RTOL = 2.0 ** -6
# and as a whole: ||got - want|| / ||want|| (Frobenius) of each output,
# about 4x the worst reading (2.4e-3, every output: a few bf16 roundings
# of relative size 2^-9); a fault confined to some rows or tiles moves
# it by their share of the norm
FLASH_BF16_REL = 1e-2
# phase 2d's bf16 cases as a whole, ||got - want|| / ||want||: the same
# few bf16 roundings (of code x scale, p and the output)
QUANT_BF16_REL = 1e-2
# phase 3c: 7b width cut to 8 layers, B x (S + 1) tokens, bf16 compute
TRAIN = dict(layers=8, batch=4, seq=2048, steps=12, lr=1e-3)
# phase 3f: 7b width cut to 2 layers (f32 master, bf16 compute), B x
# (S + 1) tokens; U saves every `interval` steps, R is preempted while
# the step consuming batch `drain_at` is in flight.  The continued run
# must equal U bit for bit (losses and final params): two unbroken runs
# of the phase read bit-identical with PyTorch's default algorithms (max
# |loss difference| 0.0 on an H100 80GB HBM3 at 700 W; the embedding
# backward sorts its indices, and cuBLAS on one stream and the flash
# kernels rerun bit for bit)
CKPT = dict(layers=2, batch=4, seq=2048, steps=6, interval=3, drain_at=2,
            lr=1e-3, new_tokens=32)
# phase 3f: what the serving restore may add to the allocated device
# memory beyond the bf16 parameter bytes — the f32 RoPE tables (1 MiB)
# and the allocator's 512-byte rounding
SERVE_LOAD_MARGIN = 16 << 20
PEAK_BF16 = 989e12                 # H100 SXM dense bf16, for MFU
PHASES = ("2", "2b", "2c", "2d", "3", "3b", "3c", "3d", "3e", "3f", "3g",
          "4", "4b", "4c", "4d", "4e", "4f")


def log(*a) -> None:
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, iters: int, warmup: int = 3, graph: bool = True) -> tuple:
    """Per-call time of ``fn(i)``: (device ms, eager ms).

    Device ms: ``iters`` calls captured into one CUDA graph, replayed
    between CUDA events — the card's time alone, without the host's
    per-call Python and launch cost (None with ``graph=False``).  Eager
    ms: the same calls issued one by one between CUDA events, which
    includes that host cost wherever the host issues slower than the
    card runs."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(warmup):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i)
    end.record()
    end.synchronize()
    eager = start.elapsed_time(end) / iters
    if not graph:
        return None, eager

    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(iters):
            fn(i)
    g.replay()
    torch.cuda.synchronize()
    reps = 3
    start.record()
    for _ in range(reps):
        g.replay()
    end.record()
    end.synchronize()
    device = start.elapsed_time(end) / (iters * reps)
    del g
    return device, eager


def attention_bound_ms(b, hq, hkv, d, fill, dtype,
                       table_entries=0) -> tuple:
    """Least time for one decode-attention call: q, the filled K and V
    rows, lengths, the ``table_entries`` int32 block-table entries per
    lane that the fill needs (paged) and the output each moved once,
    against 4 * fill * D operations per (lane, query head) at the
    dtype's peak."""
    import torch

    e = torch.empty((), dtype=dtype).element_size()
    nbytes = (e * (2 * b * hq * d + 2 * b * hkv * fill * d) + 4 * b
              + 4 * b * table_entries)
    ops = 4 * b * hq * fill * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[str(dtype)] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def phase_kernel_vs_plain(report: dict) -> None:
    import torch

    from paddle_operator_tpu_torch.ops import decode_attention as DA

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # (name, B, Hq, Hkv, D, S, lengths, stacked layers or 0)
    cases = []
    for hq, hkv, d in [(8, 8, 64), (8, 4, 128), (16, 4, 64), (8, 2, 128)]:
        cases.append(("ragged", 4, hq, hkv, d, 517, [0, 1, 517, 300], 0))
    # the split's chunk edges: lengths 0, 1, chunk - 1, chunk, chunk + 1
    # and the whole cache, R = 1, 2 and 4 query heads a block, D 64 and
    # 128; a cache of exactly one chunk (no merge); a stacked-layer view
    cr = DA.CHUNK_ROWS
    edges = [0, 1, cr - 1, cr, cr + 1, 3 * cr + 45]
    for hq, hkv in ((8, 8), (8, 4), (16, 4)):
        for d in (64, 128):
            cases.append((f"chunk-edges-R{hq // hkv}", 6, hq, hkv, d,
                          3 * cr + 45, edges, 0))
    cases += [
        ("one-chunk", 3, 8, 4, 128, cr, [0, cr - 1, cr], 0),
        ("stacked-layer", 6, 8, 4, 128, 3 * cr + 45, edges, 3),
        ("main-path-b4", 4, 32, 32, 128, 2048, [513, 520, 530, 543], 0),
        ("main-path-b1", 1, 32, 32, 128, 2048, [95], 0),
        ("7b-fill128", 4, 32, 32, 128, 2048, [128] * 4, 0),
        ("7b-fill2048", 4, 32, 32, 128, 2048, [2048] * 4, 0),
    ]
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype, atol, rtol in [(torch.float32, 1e-4, 1e-4),
                              (torch.bfloat16, BF16_ATOL, 0.0)]:
        for name, b, hq, hkv, d, s, lens, layers in cases:
            q = rand((b, hq, d), dtype)
            lead = (layers,) if layers else ()
            k = rand(lead + (b, hkv, s, d), dtype)
            v = rand(lead + (b, hkv, s, d), dtype)
            L = torch.tensor(lens, dtype=torch.int32, device=dev)
            layer = layers - 1 if layers else None
            got = DA.decode_attention(q, k, v, L, layer=layer).float()
            kl, vl = (k[layer], v[layer]) if layers else (k, v)
            want = DA.decode_attention_reference(q.float(), kl.float(),
                                                 vl.float(), L)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            lim = float((atol + rtol * want.abs()).min())
            ok = bool(((got - want).abs()
                       <= atol + rtol * want.abs()).all())
            log(f"kernel-vs-plain {name} {str(dtype)[6:]} B={b} Hq={hq} "
                f"Hkv={hkv} D={d} S={s} chunks={DA.split_chunks(s)} "
                f"layers={layers} lens={lens}: max_abs_err={err:.3e}"
                f" (atol {atol}, rtol {rtol})")
            if not ok:
                raise AssertionError(f"decode_attention disagrees with "
                                     f"its plain version: {name} {dtype} "
                                     f"max_abs_err {err} > {lim}")
            if 0 in lens and got[lens.index(0)].abs().max() != 0:
                raise AssertionError(f"decode_attention: a lane of length "
                                     f"0 does not give zeros ({name})")
            worst[dtype] = max(worst[dtype], err)
    report["max_abs_err_f32"] = worst[torch.float32]
    report["max_abs_err_bf16"] = worst[torch.bfloat16]
    report["max_abs_err"] = max(worst.values())

    # two runs on the same inputs give the same bits (the merge runs in
    # chunk order): the 7b shape at fill 2048 and the chunk edges
    for b, hq, hkv, s, lens in ((4, 32, 32, 2048, [2048] * 4),
                                (6, 16, 4, 3 * cr + 45, edges)):
        q = rand((b, hq, 128), torch.bfloat16)
        k, v = (rand((b, hkv, s, 128), torch.bfloat16) for _ in range(2))
        L = torch.tensor(lens, dtype=torch.int32, device=dev)
        first = DA.decode_attention(q, k, v, L)
        again = DA.decode_attention(q, k, v, L)
        torch.cuda.synchronize()
        if not torch.equal(first, again):
            raise AssertionError(f"two runs of decode_attention differ "
                                 f"(B={b} Hq={hq} Hkv={hkv} S={s})")
    log("decode_attention: two runs bit-identical (bf16, the 7b shape at "
        "fill 2048 and the chunk edges)")

    # timing at the 7b decode shape (bf16, the serving dtype): copies
    # rotate so the filled bytes of consecutive calls exceed the 50 MB
    # L2, as the 32 layers' caches do on the main path
    import torch.nn.functional as F

    b, h, d, s, copies = 4, 32, 128, 2048, 16
    dtype = torch.bfloat16
    lib = DA._library()
    qs = [rand((b, h, d), dtype) for _ in range(copies)]
    ks = [rand((b, h, s, d), dtype) for _ in range(copies)]
    vs = [rand((b, h, s, d), dtype) for _ in range(copies)]
    timings = []
    for fill in (128, 528, 2048):
        L = torch.full((b,), fill, dtype=torch.int32, device=dev)
        c = copies

        def kern(i):
            DA.decode_attention(qs[i % c], ks[i % c], vs[i % c], L)

        def plain(i):
            DA.decode_attention_reference(qs[i % c], ks[i % c],
                                          vs[i % c], L)

        def sdpa(i):
            F.scaled_dot_product_attention(
                qs[i % c][:, :, None], ks[i % c][:, :, :fill],
                vs[i % c][:, :, :fill])

        # in turns — plain, kernel, library, kernel, plain — so drift
        # shows as a gap between a repeat and its first reading
        row = {"fill": fill, "chunks": DA.split_chunks(s)}
        for key, fn, iters in (("plain_ms", plain, 16), ("ms", kern, 128),
                               ("library_ms", sdpa, 128),
                               ("ms_again", kern, 128),
                               ("plain_ms_again", plain, 16)):
            row[key], row[key.replace("ms", "eager_ms", 1)] = \
                time_ms(fn, iters)
        row["bound_ms"], row["bound_by"] = attention_bound_ms(
            b, h, h, d, fill, dtype)
        # the call's device ms at other chunk sizes (the wrapper takes
        # DA.CHUNK_ROWS)
        out = torch.empty_like(qs[0])
        sweep = {}
        for rows in (64, 128, 256, 512):
            sweep[rows], _ = time_ms(
                lambda i, rows=rows: DA._launch(
                    lib, qs[i % c], ks[i % c], vs[i % c], L, out,
                    d ** -0.5, torch.cuda.current_stream().cuda_stream,
                    chunk_rows=rows), 128)
        row["chunk_rows_ms"] = sweep
        log(f"timing 7b decode_attention bf16 B={b} H={h} D={d} S={s} "
            f"fill={fill}: " + json.dumps(row))
        timings.append(row)
    report["timings"] = timings
    main = next(r for r in timings if r["fill"] == 528)
    for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"):
        report[key] = main[key]
    del qs, ks, vs
    torch.cuda.empty_cache()


def _scrambled_table(rng, b, m, n_blocks):
    """[b, m] distinct pool ids drawn from 1..n_blocks-1 in a random
    order (block 0 is the trash block and is never mapped)."""
    import numpy as np

    ids = rng.permutation(np.arange(1, n_blocks))[:b * m]
    return ids.reshape(b, m).astype(np.int32)


def _paged_edges(DA, bs: int) -> tuple:
    """Lengths at a paged kernel's chunk and block edges for pool block
    size ``bs`` (0, 1, chunk - 1, chunk, chunk + 1, bs - 1, bs + 1 and
    the table's reach) and the table width M that holds them (four
    chunks or more)."""
    c = DA.paged_chunk_rows(bs)
    m = -(-(3 * c + 45) // bs)
    return [0, 1, c - 1, c, c + 1, bs - 1, bs + 1, m * bs], m


# a paged kernel's chunk rows swept beside its timing rows (2048: one
# chunk a lane at the timed shape, no split)
PAGED_SWEEP_ROWS = (64, 128, 256, 512, 1024, 2048)


def _paged_sweep(launch, q0, plain) -> dict:
    """The call's device ms at other chunk rows (the wrapper takes
    ``paged_chunk_rows``): ``launch(i, out, chunk_rows=...)`` runs call
    i into ``out``.  Each setting's first call is checked against
    ``plain`` (the plain version in float32) within ``BF16_ATOL``."""
    import torch

    out = torch.empty_like(q0)
    rows_ms = {}
    for rows in PAGED_SWEEP_ROWS:
        launch(0, out, chunk_rows=rows)
        torch.cuda.synchronize()
        err = float((out.float() - plain).abs().max())
        if err > BF16_ATOL:
            raise AssertionError(f"paged kernel at chunk rows {rows} "
                                 f"disagrees with its plain version by {err}")
        rows_ms[rows], _ = time_ms(
            lambda i, rows=rows: launch(i, out, chunk_rows=rows), 128)
    return {"chunk_rows_ms": rows_ms}


def phase_paged_kernel_vs_plain(report: dict) -> None:
    import numpy as np
    import torch
    import torch.nn.functional as F

    from paddle_operator_tpu_torch.ops import decode_attention as DA

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    rng = np.random.default_rng(2)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    # (name, B, Hq, Hkv, D, bs, M, lengths, stacked layers or 0)
    cases = []
    for hq, hkv, d in [(8, 8, 64), (8, 4, 128), (16, 4, 64), (8, 2, 128)]:
        for bs in (16, 256):
            m = -(-517 // bs)
            cases.append((f"ragged-bs{bs}", 4, hq, hkv, d, bs, m,
                          [0, 1, m * bs, 300], 2))
    # the split's chunk and block edges: lengths 0, 1, chunk - 1, chunk,
    # chunk + 1, bs - 1, bs + 1 and the table's reach, R = 1, 2 and 4
    # query heads a block, D 64 and 128, bs 16 and 256; a stacked-layer
    # view
    for bs in (16, 256):
        lens, m = _paged_edges(DA, bs)
        for hq, hkv in ((8, 8), (8, 4), (16, 4)):
            for d in (64, 128):
                cases.append((f"chunk-edges-R{hq // hkv}-bs{bs}", len(lens),
                              hq, hkv, d, bs, m, lens, 0))
        cases.append((f"chunk-edges-stacked-bs{bs}", len(lens), 8, 4, 128,
                      bs, m, lens, 3))
    cases += [
        ("ring-7b-b8", 8, 32, 32, 128, 256, 8,
         [0, 33, 101, 258, 301, 512, 601, 1001], 0),
        ("7b-fill2048", 8, 32, 32, 128, 256, 8, [2048] * 8, 0),
    ]
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype, atol, rtol in [(torch.float32, 1e-4, 1e-4),
                              (torch.bfloat16, BF16_ATOL, 0.0)]:
        for name, b, hq, hkv, d, bs, m, lens, layers in cases:
            n_blocks = b * m + 4
            shape = (n_blocks, hkv, bs, d)
            if layers:
                shape = (layers,) + shape
            q = rand((b, hq, d), dtype)
            kp = rand(shape, dtype)
            vp = rand(shape, dtype)
            table = torch.as_tensor(_scrambled_table(rng, b, m, n_blocks),
                                    device=dev)
            L = torch.tensor(lens, dtype=torch.int32, device=dev)
            layer = layers - 1 if layers else None
            got = DA.paged_decode_attention(q, kp, vp, table, L,
                                            layer=layer).float()
            kl, vl = (kp[layer], vp[layer]) if layers else (kp, vp)
            want = DA.paged_decode_attention_reference(
                q.float(), kl.float(), vl.float(), table, L)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            lim = float((atol + rtol * want.abs()).min())
            ok = bool(((got - want).abs()
                       <= atol + rtol * want.abs()).all())
            log(f"paged-kernel-vs-plain {name} {str(dtype)[6:]} B={b} "
                f"Hq={hq} Hkv={hkv} D={d} bs={bs} M={m} "
                f"chunks={DA.paged_split_chunks(m, bs)} lens={lens} "
                f"layer={layer}: max_abs_err={err:.3e} (atol {atol}, "
                f"rtol {rtol})")
            if not ok:
                raise AssertionError(
                    f"paged_decode_attention disagrees with its plain "
                    f"version: {name} {dtype} max_abs_err {err} > {lim}")
            if 0 in lens and got[lens.index(0)].abs().max() != 0:
                raise AssertionError(f"paged_decode_attention: a lane of "
                                     f"length 0 does not give zeros "
                                     f"({name})")
            worst[dtype] = max(worst[dtype], err)
    report["max_abs_err_f32"] = worst[torch.float32]
    report["max_abs_err_bf16"] = worst[torch.bfloat16]
    report["max_abs_err"] = max(worst.values())

    # two runs on the same inputs give the same bits (the partials merge
    # in chunk order): the chunk edges at bs 256, bf16
    lens, m = _paged_edges(DA, 256)
    b, n_blocks = len(lens), len(lens) * m + 1
    q = rand((b, 32, 128), torch.bfloat16)
    kp, vp = (rand((n_blocks, 32, 256, 128), torch.bfloat16)
              for _ in range(2))
    table = torch.as_tensor(_scrambled_table(rng, b, m, n_blocks),
                            device=dev)
    L = torch.tensor(lens, dtype=torch.int32, device=dev)
    first = DA.paged_decode_attention(q, kp, vp, table, L)
    again = DA.paged_decode_attention(q, kp, vp, table, L)
    torch.cuda.synchronize()
    if not torch.equal(first, again):
        raise AssertionError("two runs of paged_decode_attention differ")
    log("paged_decode_attention: two runs bit-identical (bf16, the chunk "
        "edges at bs 256)")
    del q, kp, vp

    # timing at the ring's 7b shape (bf16, 8 lanes, bs 256, 8 table
    # blocks per lane): the pool is stacked over 8 layers that the calls
    # rotate through, so consecutive calls' filled bytes exceed the
    # 50 MB L2 as the ring's 32 layers do.  Kernel #1 and SDPA read the
    # same rows gathered into a contiguous cache of their own.
    b, h, d, bs, m, layers = 8, 32, 128, 256, 8, 8
    dtype = torch.bfloat16
    n_blocks = b * m + 1
    lib = DA._library()
    qs = [rand((b, h, d), dtype) for _ in range(layers)]
    kp = rand((layers, n_blocks, h, bs, d), dtype)
    vp = rand((layers, n_blocks, h, bs, d), dtype)
    table = torch.as_tensor(_scrambled_table(rng, b, m, n_blocks),
                            device=dev)
    kc = [DA.gather_lane_view(kp[i], table) for i in range(layers)]
    vc = [DA.gather_lane_view(vp[i], table) for i in range(layers)]
    timings = []
    for fill in (128, 528, 2048):
        L = torch.full((b,), fill, dtype=torch.int32, device=dev)
        c = layers

        def kern(i):
            DA.paged_decode_attention(qs[i % c], kp, vp, table, L,
                                      layer=i % c)

        def plain(i):
            DA.paged_decode_attention_reference(qs[i % c], kp[i % c],
                                                vp[i % c], table, L)

        def contiguous(i):
            DA.decode_attention(qs[i % c], kc[i % c], vc[i % c], L)

        def sdpa(i):
            F.scaled_dot_product_attention(
                qs[i % c][:, :, None], kc[i % c][:, :, :fill],
                vc[i % c][:, :, :fill])

        # in turns, so drift shows as a gap between a repeat and its
        # first reading
        row = {"fill": fill}
        for key, fn, iters in (("plain_ms", plain, 16), ("ms", kern, 128),
                               ("kernel1_ms", contiguous, 128),
                               ("library_ms", sdpa, 128),
                               ("ms_again", kern, 128),
                               ("plain_ms_again", plain, 16)):
            row[key], row[key.replace("ms", "eager_ms", 1)] = \
                time_ms(fn, iters)
        row["bound_ms"], row["bound_by"] = attention_bound_ms(
            b, h, h, d, fill, dtype, table_entries=-(-fill // bs))
        row.update(_paged_sweep(
            lambda i, out, **kw: DA._paged_launch(
                lib, qs[i % c], kp[i % c], vp[i % c], table, L, out,
                d ** -0.5, torch.cuda.current_stream().cuda_stream, **kw),
            qs[0], DA.paged_decode_attention_reference(
                qs[0].float(), kp[0].float(), vp[0].float(), table, L)))
        log(f"timing 7b paged_decode_attention bf16 B={b} H={h} D={d} "
            f"bs={bs} M={m} fill={fill}: " + json.dumps(row))
        timings.append(row)
    report["timings"] = timings
    main = next(r for r in timings if r["fill"] == 528)
    for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "kernel1_ms"):
        report[key] = main[key]
    del qs, kp, vp, kc, vc
    torch.cuda.empty_cache()


def quant_attention_bound_ms(b, hq, hkv, d, fill, bs, dtype) -> tuple:
    """Least time for one int8-pool decode-attention call at a fill
    shared by the ``b`` lanes: the attended K and V rows — one byte an
    element in the full blocks, sizeof(T) in the write-frontier block
    the tail serves — the two f32 scales of each full block and kv
    head, the table entries the fill needs, lengths, q and the output,
    each moved once; against 4 * fill * D operations per (lane, query
    head) at the dtype's peak."""
    import torch

    e = torch.empty((), dtype=dtype).element_size()
    wb = max(fill - 1, 0) // bs
    full_rows, tail_rows = wb * bs, fill - wb * bs
    nbytes = (2 * b * hkv * d * (full_rows + e * tail_rows)
              + 2 * 4 * b * hkv * wb + 4 * b * (-(-fill // bs)) + 4 * b
              + e * 2 * b * hq * d)
    ops = 4 * b * hq * fill * d
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[str(dtype)] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def _quant_pool(gen, n_blocks, hkv, bs, d, lanes, layers=0):
    """Random int8 codes, f32 scales and f32 staging tails (a lane row
    each plus the trash row), stacked over ``layers`` when given."""
    import torch

    lead = (layers,) if layers else ()
    dev = torch.device("cuda")

    def codes():
        return torch.randint(-127, 128, lead + (n_blocks, hkv, bs, d),
                             generator=gen, device=dev, dtype=torch.int8)

    def scales():
        # |code * scale| <= 1.5: the spread of K and V rows (phase 2b
        # draws them from a unit normal)
        return (torch.rand(lead + (n_blocks, hkv), generator=gen,
                           device=dev) * 0.008 + 0.004)

    def tails():
        return torch.randn(lead + (lanes + 1, hkv, bs, d), generator=gen,
                           device=dev)

    return codes(), codes(), scales(), scales(), tails(), tails()


def phase_quant_kernel_vs_plain(report: dict) -> None:
    """Phase 2d: the int8 pool's kernel against its plain version, then
    timings at the ring's 7b shape; see the module docstring."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from paddle_operator_tpu_torch.ops import decode_attention as DA

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    rng = np.random.default_rng(7)

    # (name, B, Hq, Hkv, D, bs, M, lengths, stacked layers or 0); the
    # lengths hold {0, 1, bs-1, bs, bs+1, full, a non-multiple}
    cases = []
    for hq, hkv, d in [(8, 8, 64), (8, 4, 128), (16, 4, 64), (8, 2, 128),
                       (16, 4, 128)]:
        for bs, m in ((16, 8), (256, 3)):
            lens = [0, 1, bs - 1, bs, bs + 1, m * bs, 2 * bs + 7]
            for layers in (0, 2):
                cases.append((f"bs{bs}-L{layers}", len(lens), hq, hkv, d,
                              bs, m, lens, layers))
    # the split's chunk and block edges (as phase 2b), R = 1, 2 and 4,
    # D 64 and 128, bs 16 and 256, unstacked and a stacked-layer index
    for bs in (16, 256):
        lens, m = _paged_edges(DA, bs)
        for hq, hkv in ((8, 8), (8, 4), (16, 4)):
            for d in (64, 128):
                cases.append((f"chunk-edges-R{hq // hkv}-bs{bs}", len(lens),
                              hq, hkv, d, bs, m, lens, 0))
        cases.append((f"chunk-edges-stacked-bs{bs}", len(lens), 8, 4, 128,
                      bs, m, lens, 2))
    cases += [
        ("ring-7b-b8", 8, 32, 32, 128, 256, 8,
         [0, 33, 101, 258, 301, 512, 601, 1001], 0),
        ("7b-fill2048", 8, 32, 32, 128, 256, 8, [2048] * 8, 0),
    ]
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    worst_rel = 0.0
    for dtype, atol, rtol in [(torch.float32, 1e-4, 1e-4),
                              (torch.bfloat16, BF16_ATOL, 0.0)]:
        for name, b, hq, hkv, d, bs, m, lens, layers in cases:
            n_blocks = b * m + 4
            kp, vp, ks, vs, kt, vt = _quant_pool(gen, n_blocks, hkv, bs, d,
                                                 b, layers)
            kt, vt = kt.to(dtype), vt.to(dtype)
            q = torch.randn((b, hq, d), generator=gen, device=dev).to(dtype)
            table = torch.as_tensor(_scrambled_table(rng, b, m, n_blocks),
                                    device=dev)
            L = torch.tensor(lens, dtype=torch.int32, device=dev)
            layer = layers - 1 if layers else None
            got = DA.paged_decode_attention(q, kp, vp, table, L, layer=layer,
                                            k_scale=ks, v_scale=vs,
                                            k_tail=kt, v_tail=vt).float()
            sel = ((lambda t: t[layer]) if layers else (lambda t: t))
            # f32 q; the tails in the kernel's dtype, so the plain view
            # rounds code x scale to it
            want = DA.paged_decode_attention_quant_reference(
                q.float(), sel(kp), sel(vp), table, L, sel(ks), sel(vs),
                sel(kt), sel(vt))
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            rel = float((got - want).norm() / want.norm())
            ok = bool(((got - want).abs()
                       <= atol + rtol * want.abs()).all())
            if dtype == torch.bfloat16:
                ok = ok and rel <= QUANT_BF16_REL
                worst_rel = max(worst_rel, rel)
            log(f"quant-kernel-vs-plain {name} {str(dtype)[6:]} B={b} "
                f"Hq={hq} Hkv={hkv} D={d} bs={bs} M={m} "
                f"chunks={DA.paged_split_chunks(m, bs)} lens={lens} "
                f"layer={layer}: max_abs_err={err:.3e} (atol {atol}, "
                f"rtol {rtol}) rel={rel:.3e}"
                + (f" (limit {QUANT_BF16_REL})"
                   if dtype == torch.bfloat16 else ""))
            if not ok:
                raise AssertionError(
                    f"the int8 paged kernel disagrees with its plain "
                    f"version: {name} {dtype} max_abs_err {err}, "
                    f"rel {rel}")
            if 0 in lens and got[lens.index(0)].abs().max() != 0:
                raise AssertionError(f"the int8 paged kernel: a lane of "
                                     f"length 0 does not give zeros "
                                     f"({name})")
            worst[dtype] = max(worst[dtype], err)
    report["max_abs_err_f32"] = worst[torch.float32]
    report["max_abs_err_bf16"] = worst[torch.bfloat16]
    report["max_rel_err_bf16"] = worst_rel
    report["max_abs_err"] = max(worst.values())

    # two runs on the same inputs give the same bits: the chunk edges at
    # bs 256, bf16
    lens, m = _paged_edges(DA, 256)
    b, n_blocks = len(lens), len(lens) * m + 1
    kp, vp, ks, vs, kt, vt = _quant_pool(gen, n_blocks, 32, 256, 128, b)
    kw = dict(k_scale=ks, v_scale=vs, k_tail=kt.to(torch.bfloat16),
              v_tail=vt.to(torch.bfloat16))
    q = torch.randn((b, 32, 128), generator=gen,
                    device=dev).to(torch.bfloat16)
    table = torch.as_tensor(_scrambled_table(rng, b, m, n_blocks),
                            device=dev)
    L = torch.tensor(lens, dtype=torch.int32, device=dev)
    first = DA.paged_decode_attention(q, kp, vp, table, L, **kw)
    again = DA.paged_decode_attention(q, kp, vp, table, L, **kw)
    torch.cuda.synchronize()
    if not torch.equal(first, again):
        raise AssertionError("two runs of the int8 paged kernel differ")
    log("paged_decode_attention (int8 pool): two runs bit-identical (bf16, "
        "the chunk edges at bs 256)")
    del kp, vp, ks, vs, kt, vt, kw

    # timing at the ring's 7b shape (bf16, 8 lanes, bs 256, 8 table
    # blocks a lane), the pool stacked over 8 layers the calls rotate
    # through so the filled bytes exceed the 50 MB L2.  The bf16 paged
    # kernel reads the same logical rows from a bf16 pool (the int8
    # pool dequantized, the frontier block from the tail), kernel-free
    # SDPA from those rows laid out contiguously.
    b, h, d, bs, m, layers = 8, 32, 128, 256, 8, 8
    dtype = torch.bfloat16
    n_blocks = b * m + 1
    lib = DA._library()
    kp, vp, ks, vs, kt, vt = _quant_pool(gen, n_blocks, h, bs, d, b, layers)
    kt, vt = kt.to(dtype), vt.to(dtype)
    qs = [torch.randn((b, h, d), generator=gen, device=dev).to(dtype)
          for _ in range(layers)]
    table = torch.as_tensor(_scrambled_table(rng, b, m, n_blocks),
                            device=dev)
    timings = []
    for fill in (128, 528, 2048):
        L = torch.full((b,), fill, dtype=torch.int32, device=dev)
        wb = torch.full((b,), (fill - 1) // bs, device=dev)
        kc = [DA.gather_lane_view_quant(kp[i], ks[i], kt[i], table, wb)
              for i in range(layers)]
        vc = [DA.gather_lane_view_quant(vp[i], vs[i], vt[i], table, wb)
              for i in range(layers)]
        # the same rows as a bf16 pool: lane b's frontier block written
        # into its table entry, every other block dequantized
        kb = torch.stack([(kp[i].float() * ks[i][..., None, None]).to(dtype)
                          for i in range(layers)])
        vb = torch.stack([(vp[i].float() * vs[i][..., None, None]).to(dtype)
                          for i in range(layers)])
        front = table[torch.arange(b, device=dev), wb].long()
        kb[:, front], vb[:, front] = kt[:, :b], vt[:, :b]
        c = layers

        def kern(i):
            DA.paged_decode_attention(qs[i % c], kp, vp, table, L,
                                      layer=i % c, k_scale=ks, v_scale=vs,
                                      k_tail=kt, v_tail=vt)

        def plain(i):
            DA.paged_decode_attention_quant_reference(
                qs[i % c], kp[i % c], vp[i % c], table, L, ks[i % c],
                vs[i % c], kt[i % c], vt[i % c])

        def paged_bf16(i):
            DA.paged_decode_attention(qs[i % c], kb, vb, table, L,
                                      layer=i % c)

        def sdpa(i):
            F.scaled_dot_product_attention(
                qs[i % c][:, :, None], kc[i % c][:, :, :fill],
                vc[i % c][:, :, :fill])

        # the kernel's output on these inputs equals the bf16 paged
        # kernel's on the dequantized rows rounded to bf16 (same values,
        # same order): this pins the rounding of code x scale to T
        same = DA.paged_decode_attention(qs[0], kp, vp, table, L, layer=0,
                                         k_scale=ks, v_scale=vs, k_tail=kt,
                                         v_tail=vt)
        ref = DA.paged_decode_attention(qs[0], kb, vb, table, L, layer=0)
        row = {"fill": fill,
               "vs_bf16_pool_max_abs_diff":
                   float((same.float() - ref.float()).abs().max())}
        if row["vs_bf16_pool_max_abs_diff"] != 0.0:
            raise AssertionError(
                f"the int8 paged kernel at fill {fill} differs from the "
                f"bf16 paged kernel on the same rows rounded to bf16 by "
                f"{row['vs_bf16_pool_max_abs_diff']}")
        for key, fn, iters in (("plain_ms", plain, 8), ("ms", kern, 128),
                               ("paged_bf16_ms", paged_bf16, 128),
                               ("library_ms", sdpa, 128),
                               ("ms_again", kern, 128),
                               ("plain_ms_again", plain, 8)):
            row[key], row[key.replace("ms", "eager_ms", 1)] = \
                time_ms(fn, iters)
        row["bound_ms"], row["bound_by"] = quant_attention_bound_ms(
            b, h, h, d, fill, bs, dtype)
        row.update(_paged_sweep(
            lambda i, out, **kw: DA._paged_quant_launch(
                lib, qs[i % c], kp[i % c], vp[i % c], ks[i % c], vs[i % c],
                kt[i % c], vt[i % c], table, L, out, d ** -0.5,
                torch.cuda.current_stream().cuda_stream, **kw),
            qs[0], DA.paged_decode_attention_quant_reference(
                qs[0].float(), kp[0], vp[0], table, L, ks[0], vs[0], kt[0],
                vt[0])))
        log(f"timing 7b paged_decode_attention_quant bf16 B={b} H={h} "
            f"D={d} bs={bs} M={m} fill={fill}: " + json.dumps(row))
        timings.append(row)
        del kc, vc, kb, vb
        torch.cuda.empty_cache()
    report["timings"] = timings
    main = next(r for r in timings if r["fill"] == 528)
    for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                "paged_bf16_ms"):
        report[key] = main[key]
    del qs, kp, vp, ks, vs, kt, vt
    torch.cuda.empty_cache()


FLASH_KERNELS = ("flash_forward", "flash_backward_dkv", "flash_backward_dq")


def flash_bound_ms(b, hq, hkv, s, d, dtype, kind: str) -> tuple:
    """Least time for one causal flash call at [B, S, H, D]: each input
    read once and each output written once, against the products the
    function needs at the dtype's peak — each an S x S x D product per
    (batch, query head), half of it under the causal mask: 2 for the
    forward (QK^T, PV), 4 for dK/dV (QK^T, dO V^T, P^T dO, dS^T Q), 3
    for dQ (QK^T, dO V^T, dS K) and 7 for the forward and backward as
    one function (whose backward computes QK^T and dO V^T once)."""
    import torch

    e = torch.empty((), dtype=dtype).element_size()
    # (q-like tensors, kv-like tensors, f32 rows per query row, products)
    moved = {"fwd": (2, 2, 1, 2), "dkv": (2, 4, 2, 4), "dq": (3, 2, 2, 3),
             "fwd_bwd": (4, 4, 0, 7)}[kind]
    nq, nkv, rows, products = moved
    nbytes = e * b * s * d * (nq * hq + nkv * hkv) + 4 * rows * b * hq * s
    ops = products * 2 * b * hq * s * s * d / 2
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[str(dtype)] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# per wrapper, the body each group of its instantiations in
# flash_attention.cu runs: (dtype and head dims, design)
FLASH_DESIGNS = {
    "flash_forward": [
        ("bf16 D64, D128", "wgmma: S, P and the O accumulator in "
         "registers; TMA loads into a 2-stage ring"),
        ("bf16 D256", "WMMA 16x16x16 through shared memory"),
        ("f32", "FMA through shared memory")],
    "flash_backward_dkv": [
        ("bf16 D64, D128", "wgmma: S^T, dP^T, P^T, dS^T and the dK, dV "
         "accumulators in registers; TMA loads into a 2-stage ring"),
        ("bf16 D256", "WMMA 16x16x16 through shared memory"),
        ("f32", "FMA through shared memory")],
    "flash_backward_dq": [
        ("bf16 D64, D128", "wgmma: S, dP, dS and the dQ accumulator in "
         "registers; TMA K/V loads into a 2-stage ring"),
        ("bf16 D256", "WMMA 16x16x16 through shared memory"),
        ("f32", "FMA through shared memory")],
}
_FLASH_SYMBOLS = {"flash_fwd": "flash_forward",
                  "flash_bwd_dkv": "flash_backward_dkv",
                  "flash_bwd_dq": "flash_backward_dq"}


def ptxas_entries(name: str):
    """(mangled symbol, counts) per kernel entry that ``nvcc -Xptxas -v``
    reported while building kernel source ``name`` in this process:
    registers, spill store and load bytes, stack and static shared
    memory bytes.  None when the library was built before this process
    (no output to report)."""
    import re

    from paddle_operator_tpu_torch.ops import _build

    log_text = _build.LOGS.get(name)
    if log_text is None:
        log(f"{name} ptxas: the library was built before this process; "
            "no -Xptxas -v output to report")
        return None
    out = []
    for block in log_text.split("ptxas info    : Compiling entry "
                                "function")[1:]:
        m = re.match(r" '(\S+)'", block)
        if m is None:
            continue
        nums = {key: int(v) for v, key in re.findall(
            r"(\d+) (bytes stack frame|bytes spill stores|bytes spill "
            r"loads|registers|bytes smem)", block)}
        out.append((m.group(1), {
            "registers": nums.get("registers"),
            "spill_store_bytes": nums.get("bytes spill stores"),
            "spill_load_bytes": nums.get("bytes spill loads"),
            "stack_bytes": nums.get("bytes stack frame"),
            "static_smem_bytes": nums.get("bytes smem", 0)}))
    return out


def flash_build_report(flash: dict) -> None:
    """Per instantiation of the flash kernels: its registers, spill
    bytes and static shared memory from ``nvcc -Xptxas -v`` and the
    dynamic shared memory its launch asks for; with each wrapper's
    designs, into ``flash[kernel]``."""
    import ctypes
    import re

    from paddle_operator_tpu_torch.ops import _build

    lib = _build.load("flash_attention")
    lib.flash_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.flash_smem_bytes.restype = ctypes.c_int
    for kern in FLASH_KERNELS:
        flash[kern]["designs"] = [{"instantiations": what, "body": body}
                                  for what, body in FLASH_DESIGNS[kern]]
        flash[kern]["ptxas"] = []
    entry = re.compile(r"(flash_(fwd|bwd_dkv|bwd_dq)_(hopper|kernel))I(.*?)"
                       r"Li(\d+)E")
    for symbol, nums in ptxas_entries("flash_attention") or ():
        m = entry.search(symbol)
        if m is None:
            continue
        kern = _FLASH_SYMBOLS[f"flash_{m.group(2)}"]
        d = int(m.group(5))
        dtype = 0 if m.group(4) == "f" else 1
        row = {"symbol": m.group(1), "dtype": ["f32", "bf16"][dtype],
               "d": d, **nums, "dynamic_smem_bytes": lib.flash_smem_bytes(
                   FLASH_KERNELS.index(kern), dtype, d)}
        flash[kern]["ptxas"].append(row)
        log(f"flash ptxas {kern}: " + json.dumps(row))


def decode_build_report(*reports: dict) -> None:
    """Per instantiation of the decode kernels (the contiguous split
    kernel, the paged kernel and the int8 pool's): registers, spill
    bytes, stack and static shared memory from ``nvcc -Xptxas -v``, and
    for the paged kernels (instantiated at head_dim 64, 128 and any
    other, ``d`` 0) the dynamic shared memory a launch asks for (at D 128
    for the generic one), into each report's ``ptxas``."""
    import ctypes
    import re

    from paddle_operator_tpu_torch.ops import _build

    lib = _build.load("decode_attention")
    lib.paged_decode_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.paged_decode_smem_bytes.restype = ctypes.c_int
    kernels = {r["name"]: r["name"] + "_kernel" for r in reports}
    for r in reports:
        r["ptxas"] = []
    for symbol, nums in ptxas_entries("decode_attention") or ():
        for r in reports:
            kern = kernels[r["name"]]
            # mangled: the name's length, the name, then its template
            # arguments (T, R and, for the paged kernels, D)
            m = re.search(rf"{len(kern)}{kern}I(f|13__nv_bfloat16)Li(\d)E"
                          r"(?:Li(\d+)E)?", symbol)
            if m is None:
                continue
            row = {"symbol": symbol, "dtype": "f32" if m.group(1) == "f"
                   else "bf16", "r": int(m.group(2)), **nums}
            if m.group(3) is not None:
                row["d"] = int(m.group(3))
                row["dynamic_smem_bytes"] = lib.paged_decode_smem_bytes(
                    int(row["dtype"] == "bf16"), row["r"], row["d"] or 128)
            r["ptxas"].append(row)
            log(f"decode ptxas {kern}: " + json.dumps(row))


def phase_flash_vs_plain(reports: dict) -> None:
    """Phase 2c: the three flash kernels against their plain versions,
    bit-identical reruns, then timings at the 7b training shape."""
    import torch
    import torch.nn.functional as F

    from paddle_operator_tpu_torch.ops import flash_attention as FA

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)

    def rand(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def documents(b, s):
        """[b, s] int32 ids of three packed documents (ragged cuts)."""
        cuts = torch.tensor([0, s // 3, (2 * s) // 3 + 1], device=dev)
        ids = (torch.arange(s, device=dev)[None, :] >= cuts[:, None]).sum(0)
        return ids.to(torch.int32)[None].repeat(b, 1).contiguous()

    # (name, B, Hq, D, n_rep, Sq, Sk, causal, ids: none / docs / orphan
    # q rows); S holds the edges of the bf16 bodies' 64- and 128-row
    # tiles; the last case is the training main path's shape
    cases = [(f"D{d}-rep{n_rep}-S{s}", 2, 8, d, n_rep, s, s, causal, ids)
             for d in (64, 128) for n_rep in (1, 2, 4)
             for s in (1, 63, 64, 65, 127, 128, 129, 300, 2048)
             for causal in (True, False) for ids in ("none", "docs")]
    cases += [(f"Sq{sq}-Sk{sk}", 2, 8, 128, 2, sq, sk, causal, ids)
              for sq, sk in ((300, 700), (700, 300))
              for causal in (True, False) for ids in ("none", "docs")]
    cases += [("orphan-rows", 2, 8, 128, 2, 300, 300, causal, "orphan")
              for causal in (True, False)]
    cases.append(("main-path-7b", 4, 32, 128, 1, 2048, 2048, True, "none"))
    worst = {(k, dt): 0.0 for k in FLASH_KERNELS
             for dt in (torch.float32, torch.bfloat16)}
    excess = {k: 0.0 for k in FLASH_KERNELS}   # bf16 |err| - rtol |want|
    worst_rel = {k: 0.0 for k in FLASH_KERNELS}  # bf16 relative Frobenius
    failures = []
    for dtype in (torch.float32, torch.bfloat16):
        for name, b, hq, d, n_rep, s, sk, causal, ids in cases:
            hkv = hq // n_rep
            q, do = rand((b, s, hq, d), dtype), rand((b, s, hq, d), dtype)
            k, v = rand((b, sk, hkv, d), dtype), rand((b, sk, hkv, d), dtype)
            seg_q = seg_k = None
            if ids != "none":
                seg_q, seg_k = documents(b, s), documents(b, sk)
            if ids == "orphan":
                # the last third of the query rows carry an id no key
                # has: fully masked rows, reachable only through the
                # internal entry points
                seg_q = seg_k.clone()
                seg_q[:, 2 * s // 3:] = 99
            o, lse = FA.flash_forward(q, k, v, seg_q, seg_k, causal=causal)
            qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
            po, plse = FA.flash_forward_reference(qf, kf, vf, seg_q,
                                                  causal=causal, seg_k=seg_k)
            delta = FA.attention_delta(po, dof)
            dk, dv = FA.flash_backward_dkv(q, k, v, do, plse, delta, seg_q,
                                           seg_k, causal=causal)
            dq = FA.flash_backward_dq(q, k, v, do, plse, delta, seg_q, seg_k,
                                      causal=causal)
            pdk, pdv = FA.flash_backward_dkv_reference(
                qf, kf, vf, dof, plse, delta, seg_q, seg_k, causal=causal)
            pdq = FA.flash_backward_dq_reference(qf, kf, vf, dof, plse, delta,
                                                 seg_q, seg_k, causal=causal)
            torch.cuda.synchronize()
            if ids == "orphan" and (o[:, 2 * s // 3:].abs().max() != 0
                                    or lse[:, :, 2 * s // 3:].abs().max()
                                    != 0):
                raise AssertionError("flash_forward: rows with no key do "
                                     "not give o = 0 and lse = 0")
            errs, rels = {}, {}
            what = f"{name} causal={causal} ids={ids} {dtype}"
            pairs = {"flash_forward": [("o", o, po), ("lse", lse, plse)],
                     "flash_backward_dkv": [("dk", dk, pdk), ("dv", dv, pdv)],
                     "flash_backward_dq": [("dq", dq, pdq)]}
            if name == "main-path-7b":
                # the long causal rows, where a typical |O| is ~0.04
                pairs["flash_forward"].append(
                    ("o[S/2:]", o[:, s // 2:], po[:, s // 2:]))
            for kern, outs in pairs.items():
                atol, rtol = ((1e-4, 1e-4) if dtype == torch.float32
                              else (FLASH_BF16_ATOL[kern], FLASH_BF16_RTOL))
                for out, got, want in outs:
                    diff = (got.float() - want).abs()
                    err = float(diff.max())
                    errs[kern] = max(errs.get(kern, 0.0), err)
                    if not bool((diff <= atol + rtol * want.abs()).all()):
                        failures.append(
                            f"{kern} {out} disagrees with its plain version "
                            f"element by element: {what} max_abs_err {err} "
                            f"(atol {atol}, rtol {rtol})")
                    if dtype != torch.bfloat16:
                        continue
                    excess[kern] = max(excess[kern], float(
                        (diff - rtol * want.abs()).max()))
                    if min(s, sk) == 1 and out in ("dk", "dq"):
                        # one key a row: the softmax gradient is 0, and
                        # both sides hold only rounding residue
                        continue
                    rel = float(diff.norm()) / float(want.norm())
                    rels[out] = rel
                    worst_rel[kern] = max(worst_rel[kern], rel)
                    if rel > FLASH_BF16_REL:
                        failures.append(
                            f"{kern} {out} disagrees with its plain version "
                            f"as a whole: {what} relative error {rel:.3e} "
                            f"(limit {FLASH_BF16_REL})")
                worst[kern, dtype] = max(worst[kern, dtype], errs[kern])
            log(f"flash-vs-plain {name} B={b} Hq={hq} {str(dtype)[6:]} "
                f"causal={causal} ids={ids}: " + " ".join(
                    f"{k[6:]}={e:.2e}" for k, e in errs.items())
                + ("; relative " + " ".join(f"{k}={e:.2e}"
                                           for k, e in rels.items())
                   if rels else ""))
    log(f"flash bf16 worst |err| - rtol |want| (rtol {FLASH_BF16_RTOL}): "
        + json.dumps(excess))
    log("flash bf16 worst relative Frobenius error: " + json.dumps(worst_rel))
    if failures:
        raise AssertionError(f"{len(failures)} flash checks failed:\n"
                             + "\n".join(failures[:20]))

    # two runs of each kernel on the same inputs give the same bits
    b, hq, d, s, hkv = 2, 8, 128, 2048, 4
    q, do = rand((b, s, hq, d), torch.bfloat16), rand((b, s, hq, d),
                                                      torch.bfloat16)
    k, v = rand((b, s, hkv, d), torch.bfloat16), rand((b, s, hkv, d),
                                                      torch.bfloat16)
    seg = documents(b, s)
    runs = []
    for _ in range(2):
        o, lse = FA.flash_forward(q, k, v, seg, seg)
        delta = FA.attention_delta(o, do)
        runs.append((o, lse) + FA.flash_backward_dkv(q, k, v, do, lse, delta,
                                                     seg, seg)
                    + (FA.flash_backward_dq(q, k, v, do, lse, delta, seg,
                                            seg),))
    if not all(torch.equal(x, y) for x, y in zip(*runs)):
        raise AssertionError("two runs of the flash kernels differ")
    log("flash kernels: two runs bit-identical (bf16, B=2 S=2048 H=8 "
        "Hkv=4 D=128, causal, 3 documents)")

    # timing at the 7b training shape, in turns: plain, kernel, kernel,
    # plain for each kernel; the library and the port's forward+backward
    b, h, d = 4, 32, 128
    dtype = torch.bfloat16
    for s in (512, 2048):
        q, k, v, do = (rand((b, s, h, d), dtype) for _ in range(4))
        o, lse = FA.flash_forward(q, k, v)
        delta = FA.attention_delta(o, do)
        qt, kt, vt, dot = (x.transpose(1, 2).contiguous()
                           for x in (q, k, v, do))
        leaves = [x.detach().requires_grad_() for x in (q, k, v)]
        tleaves = [x.detach().requires_grad_() for x in (qt, kt, vt)]
        plain_iters = 2 if s == 2048 else 4
        fns = {
            "flash_forward": (lambda i: FA.flash_forward(q, k, v),
                              lambda i: FA.flash_forward_reference(q, k, v),
                              "fwd"),
            "flash_backward_dkv": (
                lambda i: FA.flash_backward_dkv(q, k, v, do, lse, delta),
                lambda i: FA.flash_backward_dkv_reference(q, k, v, do, lse,
                                                          delta), "dkv"),
            "flash_backward_dq": (
                lambda i: FA.flash_backward_dq(q, k, v, do, lse, delta),
                lambda i: FA.flash_backward_dq_reference(q, k, v, do, lse,
                                                         delta), "dq"),
        }
        for kern, (kfn, pfn, kind) in fns.items():
            row = {"seq": s}
            for key, fn, iters in (("plain_ms", pfn, plain_iters),
                                   ("ms", kfn, 10), ("ms_again", kfn, 10),
                                   ("plain_ms_again", pfn, plain_iters)):
                row[key], row[key.replace("ms", "eager_ms", 1)] = \
                    time_ms(fn, iters)
            row["bound_ms"], row["bound_by"] = flash_bound_ms(
                b, h, h, s, d, dtype, kind)
            if kern == "flash_forward":
                row["library_ms"], row["library_eager_ms"] = time_ms(
                    lambda i: F.scaled_dot_product_attention(
                        qt, kt, vt, is_causal=True), 10)
            else:
                row["library_ms"] = None
            log(f"timing 7b {kern} bf16 B={b} H={h} D={d} S={s} causal: "
                + json.dumps(row))
            reports[kern].setdefault("timings", []).append(row)
        # forward + backward as one function (host clock of the eager
        # calls between CUDA events; autograd is not captured)
        pair = {"seq": s}
        _, pair["fwd_bwd_ms"] = time_ms(
            lambda i: torch.autograd.grad(
                FA.flash_attention(*leaves), leaves, do), 5, graph=False)
        _, pair["library_fwd_bwd_ms"] = time_ms(
            lambda i: torch.autograd.grad(
                F.scaled_dot_product_attention(*tleaves, is_causal=True),
                tleaves, dot), 5, graph=False)
        pair["fwd_bwd_bound_ms"], pair["fwd_bwd_bound_by"] = flash_bound_ms(
            b, h, h, s, d, dtype, "fwd_bwd")
        # the backward pair against the library's flash backward, which
        # computes dQ, dK and dV in one call from its own forward's lse
        lib = torch.ops.aten._scaled_dot_product_flash_attention(
            qt, kt, vt, 0.0, True, False)
        lib_bwd = torch.ops.aten._scaled_dot_product_flash_attention_backward
        pair["library_bwd_ms"], pair["library_bwd_eager_ms"] = time_ms(
            lambda i: lib_bwd(dot, qt, kt, vt, *lib[:6], 0.0, True,
                              *lib[6:8]), 10)
        pair["bwd_pair_ms"] = (
            reports["flash_backward_dkv"]["timings"][-1]["ms"]
            + reports["flash_backward_dq"]["timings"][-1]["ms"])
        log(f"timing 7b flash forward+backward vs SDPA (eager) and the "
            f"backward pair vs the library's flash backward (device), bf16 "
            f"B={b} H={h} D={d} S={s} causal: " + json.dumps(pair))
        reports["flash_forward"].setdefault("fwd_bwd", []).append(pair)
        del q, k, v, do, o, lse, delta, qt, kt, vt, dot, leaves, tleaves
        del lib
        torch.cuda.empty_cache()
    for kern in FLASH_KERNELS:
        r = reports[kern]
        r["max_abs_err_f32"] = worst[kern, torch.float32]
        r["max_abs_err_bf16"] = worst[kern, torch.bfloat16]
        r["max_abs_err"] = max(r["max_abs_err_f32"], r["max_abs_err_bf16"])
        main = next(t for t in r["timings"] if t["seq"] == 2048)
        for key in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by"):
            r[key] = main[key]


def _post(base: str, body: dict) -> tuple:
    req = urllib.request.Request(
        base + "/v1/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        out = r.status, json.loads(r.read())
    return out + (time.perf_counter() - t0,)


def _post_stream(base: str, body: dict) -> tuple:
    """A ``"stream": true`` generate: (HTTP status, the ndjson events,
    seconds to the first event, seconds to the end)."""
    req = urllib.request.Request(
        base + "/v1/generate", data=json.dumps(dict(body, stream=True))
        .encode(), headers={"Content-Type": "application/json"},
        method="POST")
    t0 = time.perf_counter()
    first = None
    events = []
    with urllib.request.urlopen(req, timeout=600) as r:
        for line in r:
            if line.strip():
                if first is None:
                    first = time.perf_counter() - t0
                events.append(json.loads(line))
        status = r.status
    return status, events, first, time.perf_counter() - t0


def _check_rows(cfg, prompt, out, n_new, what) -> None:
    """One generated row: the prompt echoed, ``n_new`` new tokens, every
    id inside the vocabulary."""
    if len(out) != len(prompt) + n_new or out[:len(prompt)] != prompt:
        raise AssertionError(f"{what}: {len(out)} tokens for a "
                             f"{len(prompt)}-token prompt + {n_new} new, or "
                             "the prompt is not echoed")
    if min(out) < 0 or max(out) >= cfg.vocab_size:
        raise AssertionError(f"{what}: tokens outside the vocabulary")


def make_7b():
    """7b at full width and depth, bf16, fresh init from seed 0."""
    import torch

    from paddle_operator_tpu_torch.models.llama import CONFIGS, make_model

    t0 = time.perf_counter()
    params, cfg = make_model("7b", device="cuda", seed=0,
                             param_dtype=CONFIGS["7b"].dtype)
    torch.cuda.synchronize()
    log(f"main path: 7b init on the card {time.perf_counter() - t0:.1f}s "
        f"({cfg.num_params() / 1e9:.2f}B params, {cfg.dtype}, "
        f"{cfg.n_layers} layers)")
    return params, cfg


def phase_main_path(report: dict, params, cfg) -> None:
    import numpy as np
    import torch

    from paddle_operator_tpu_torch.infer import decode as D
    from paddle_operator_tpu_torch.infer.serve import make_server
    from paddle_operator_tpu_torch.ops import decode_attention as DA

    srv = make_server("127.0.0.1", 0, params, cfg)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    rng = np.random.default_rng(0)
    r1 = {"tokens": rng.integers(0, cfg.vocab_size, (1, 32)).tolist(),
          "max_new_tokens": 64}
    r2 = {"tokens": rng.integers(0, cfg.vocab_size, (4, 512)).tolist(),
          "max_new_tokens": 32}
    reqs = [r1, r2, r1]
    try:
        _zero_launches()
        results = [_post(base, r) for r in reqs]
        launches = DA.decode_attention.launches
        paged = DA.paged_decode_attention.launches
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
    steps = 0
    for body, (code, out, secs) in zip(reqs, results):
        toks = np.asarray(out["tokens"])
        b, s = np.asarray(body["tokens"]).shape
        n = body["max_new_tokens"]
        if code != 200 or toks.shape != (b, s + n):
            raise AssertionError(f"request {b}x{s}+{n}: HTTP {code}, "
                                 f"shape {toks.shape}")
        if toks.min() < 0 or toks.max() >= cfg.vocab_size:
            raise AssertionError("tokens outside the vocabulary")
        if not (toks[:, :s] == np.asarray(body["tokens"])).all():
            raise AssertionError("response does not echo the prompt")
        steps += n - 1
        log(f"main path: POST B={b} prompt={s} new={n}: HTTP {code} in "
            f"{secs:.3f}s ({b * n / secs:.1f} new tok/s end to end)")
    if results[0][1] != results[2][1]:
        raise AssertionError("greedy resubmission is not byte-identical")
    want = cfg.n_layers * steps
    log(f"main path: decode_attention launches {launches} "
        f"(n_layers {cfg.n_layers} x decode steps {steps} = {want})")
    if launches != want or paged:
        raise AssertionError(f"decode_attention launched {launches} "
                             f"times, expected {want}; the paged kernel "
                             f"{paged} times, expected 0")
    report["launches"] = launches

    # decode ms/token at B=4 after a 512-token prefill (the second
    # request's shape), device-synchronized host clock over 32 steps
    prompt = torch.as_tensor(np.asarray(r2["tokens"], np.int32),
                             device="cuda")
    with torch.inference_mode():
        logits, cache = D.prefill(params, cfg, prompt)
        tok = logits.argmax(-1).to(torch.int32)
        for _ in range(3):
            logits, cache = D.decode_step(params, cfg, tok, cache)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        n = 32
        for _ in range(n):
            logits, cache = D.decode_step(params, cfg, tok, cache)
            tok = logits.argmax(-1).to(torch.int32)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / n * 1e3
    log(f"main path: decode {ms:.3f} ms/token-step at B=4 "
        f"(fill 516-547), {4 / ms * 1e3:.1f} tok/s")
    report["decode_ms_per_step_b4"] = ms
    del cache
    torch.cuda.empty_cache()


RING = dict(continuous=True, paged=True, slots=8, chunk_tokens=8,
            block_size=256, max_len=2048)


def phase_ring_main_path(report: dict, params, cfg,
                         kv_quant: str = "none", bf16_ring=None,
                         megastep: int = 1, ref=None) -> dict:
    """The continuous paged server under a concurrent burst; see the
    module docstring (phases 3b, with ``kv_quant="int8"`` 3d and with
    ``megastep=4`` 3e, whose rings are held beside 3b's ``bf16_ring``
    readings; 3e's tokens against 3b's, ``ref``).  Returns every
    request's output tokens, by (kind, index)."""
    import numpy as np

    from paddle_operator_tpu_torch.infer.serve import make_server
    from paddle_operator_tpu_torch.ops import decode_attention as DA
    from paddle_operator_tpu_torch.utils.radixkey import prefix_chain_key
    from paddle_operator_tpu_torch.utils.tracing import hist_quantile

    quant = kv_quant != "none"
    kw = dict(RING, prewarm=True)
    if quant:
        kw["kv_quant"] = kv_quant
    if megastep > 1:
        kw["megastep"] = megastep
    t_build = time.perf_counter()
    srv = make_server("127.0.0.1", 0, params, cfg, **kw)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    batcher = srv.generator.batcher
    ex = batcher.executor
    # the prewarm thread captures the resident programs (ring empty)
    if not batcher.prewarmed.wait(600) or ex.needs_capture:
        raise AssertionError(f"the ring's CUDA graphs were not captured at "
                             f"prewarm: {batcher.prewarm_error!r}")
    log(f"ring: CUDA graphs of steps {sorted(ex._graphs)} captured in "
        f"{ex.capture_s:.2f}s (server up to captured "
        f"{time.perf_counter() - t_build:.2f}s), graph pool "
        f"{ex.graph_pool_bytes()} bytes, launches recorded "
        f"{ {n: g.launches for n, g in ex._graphs.items()} } on "
        f"{card_line()}")
    bs, chunk = RING["block_size"], RING["chunk_tokens"]
    rng = np.random.default_rng(0)

    def prompt(n):
        return rng.integers(0, cfg.vocab_size, n).tolist()

    cold = [prompt(n) for n in (32, 100, 257, 300, 511, 512, 600, 1000)]
    prefix = cold[5]                       # the 512-token prompt
    followers = [prefix + prompt(16) for _ in range(4)]
    streamed = prompt(64)
    jobs = ([("cold", i, p, 48) for i, p in enumerate(cold)]
            + [("stream", 0, streamed, 32)])
    late = [("follower", i, p, 32) for i, p in enumerate(followers)]
    # the followers go once their shared blocks are in the radix cache
    # (published at the cold prompt's admission), so each one admits
    # through the suffix-only insert
    keys = [prefix_chain_key(prefix, bs, max_blocks=2)[0]]
    if quant:
        # int8: one more follower, the first 600 tokens of the cold
        # 1000-token prompt — its hit (599 tokens) ends mid-block, so it
        # copies that block and seeds its tail from the dequantized copy
        late.append(("midblock", 0, cold[7][:600], 32))
        keys.append(prefix_chain_key(cold[7], bs, max_blocks=3)[0])
    results, errors = {}, []

    def send(kind, i, p, n):
        try:
            body = {"tokens": [p], "max_new_tokens": n}
            results[kind, i] = (_post_stream(base, body) if kind == "stream"
                                else _post(base, body))
        except Exception as e:               # surfaced after the join
            errors.append(f"{kind} {i}: {e!r}")

    try:
        stats0 = dict(batcher.stats)
        replays0 = ex.graph_replays
        _zero_launches()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=send, args=j) for j in jobs]
        for t in threads:
            t.start()
        while not all(k in batcher.pool.entries for k in keys):
            if errors or time.perf_counter() - t0 > 600:
                raise AssertionError(f"the shared prefix was never "
                                     f"cached: {errors}")
            time.sleep(0.005)
        more = [threading.Thread(target=send, args=j) for j in late]
        for t in more:
            t.start()
        for t in threads + more:
            t.join()
        burst_s = time.perf_counter() - t0
        burst_chunks = batcher.stats["chunks"] - stats0["chunks"]
        # a full prefix hit: the cold 512-token prompt again
        send("resubmit", 0, prefix, 48)
        with urllib.request.urlopen(base + "/statusz", timeout=60) as r:
            statusz = json.loads(r.read())
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
        srv.generator.close()                # the ring thread has ended
    replays = ex.graph_replays - replays0
    kernels = {"decode_attention": DA.decode_attention.launches,
               "paged_decode_attention": DA.paged_decode_attention.launches,
               "paged_decode_attention_quant":
                   DA.paged_decode_attention.quant_launches}
    name = ("paged_decode_attention_quant" if quant
            else "paged_decode_attention")
    launches = kernels.pop(name)
    if errors:
        raise AssertionError(f"ring requests failed: {errors}")
    stats = {k: batcher.stats[k] - stats0.get(k, 0)
             for k in ("chunks", "prefill_calls", "prefill_tokens",
                       "admitted", "evicted")}
    pool = batcher.pool

    new_tokens = 0
    outputs = {}
    for (kind, i, p, n) in jobs + late:
        if kind == "stream":
            code, events, first_s, secs = results[kind, i]
            toks = [e["token"] for e in events if "token" in e]
            done = events[-1]
            if code != 200 or not done.get("done") or len(toks) != n \
                    or done["tokens"] != p + toks:
                raise AssertionError(f"streamed request: HTTP {code}, "
                                     f"{len(toks)} token events, last "
                                     f"event {str(done)[:200]}")
            out = done["tokens"]
            log(f"ring: streamed prompt={len(p)} new={n}: first event "
                f"after {first_s:.3f}s, done in {secs:.3f}s")
        else:
            code, body, secs = results[kind, i]
            if code != 200 or len(body["tokens"]) != 1:
                raise AssertionError(f"{kind} {i}: HTTP {code}")
            out = body["tokens"][0]
        _check_rows(cfg, p, out, n, f"{kind} {i}")
        outputs[kind, i] = out
        new_tokens += n
    code, body, resub_s = results["resubmit", 0]
    _check_rows(cfg, prefix, body["tokens"][0], 48, "resubmission")
    outputs["resubmit", 0] = body["tokens"][0]
    cold_new = results["cold", 5][1]["tokens"][0][len(prefix):]
    resub_new = body["tokens"][0][len(prefix):]
    same = sum(a == b for a, b in zip(cold_new, resub_new)) / len(cold_new)

    want = cfg.n_layers * chunk * megastep * stats["chunks"]
    log(f"ring: {name} launches {launches} (n_layers {cfg.n_layers} x "
        f"chunk {chunk} x megastep {megastep} x dispatches "
        f"{stats['chunks']} = {want}); other decode kernels {kernels}; "
        f"CUDA graph replays {replays}")
    if launches != want or any(kernels.values()):
        raise AssertionError(f"{name} launched {launches} times, expected "
                             f"{want}; the other decode kernels {kernels} "
                             "times, expected 0")
    if replays != stats["chunks"]:
        raise AssertionError(f"{stats['chunks']} dispatches but {replays} "
                             "CUDA graph replays")
    # prefill work: every cold prompt whole, each follower its 16-token
    # suffix (the mid-block follower its last token), the resubmission
    # its last token
    want_tokens = (sum(map(len, cold)) + len(streamed) + 4 * 16 + 1
                   + (1 if quant else 0))
    log(f"ring: prefill calls {stats['prefill_calls']}, prefill tokens "
        f"{stats['prefill_tokens']} (expected {len(jobs) + len(late) + 1}"
        f", {want_tokens}); radix hit rate {pool.hit_rate()}, CoW copies "
        f"{pool.stats['cow_copies']}, blocks hwm {pool.stats['blocks_hwm']}")
    if (stats["prefill_tokens"] != want_tokens
            or stats["prefill_calls"] != len(jobs) + len(late) + 1):
        raise AssertionError("the followers or the resubmission did not "
                             "prefill only their suffixes")
    if not pool.hit_rate() > 0 or pool.stats["cow_copies"] < 1:
        raise AssertionError("no radix hit or no copy-on-write")
    pool.check_invariant()
    if pool.blocks_free() + pool.blocks_cached() != pool.num_blocks:
        raise AssertionError(f"blocks still mapped at the end: "
                             f"{pool.blocks_free()} free + "
                             f"{pool.blocks_cached()} cached of "
                             f"{pool.num_blocks}")
    if statusz.get("kvQuantMode") != kv_quant:
        raise AssertionError(f"/statusz kvQuantMode "
                             f"{statusz.get('kvQuantMode')!r}, expected "
                             f"{kv_quant!r}")
    if statusz.get("megastepN") != megastep:
        raise AssertionError(f"/statusz megastepN {statusz.get('megastepN')}"
                             f", expected {megastep}")

    ttft = batcher.hist.ttft
    p50 = hist_quantile(ttft.bounds, ttft.counts, 0.50)
    p95 = hist_quantile(ttft.bounds, ttft.counts, 0.95)
    ring = {
        "kv_quant": kv_quant, "megastep": megastep,
        "burst_s": burst_s, "burst_new_tokens": new_tokens,
        "burst_new_tok_s": new_tokens / burst_s,
        "burst_chunks": burst_chunks,
        "wall_ms_per_chunk": burst_s / burst_chunks * 1e3,
        "wall_ms_per_token": burst_s / new_tokens * 1e3,
        "dispatches_per_token": statusz["dispatchesPerToken"],
        "graph_capture_s": ex.capture_s,
        "graph_pool_bytes": ex.graph_pool_bytes(),
        "ttft_p50_ms": p50, "ttft_p95_ms": p95,
        "resubmit_s": resub_s, "resubmit_token_match_share": same,
        "pool_blocks": pool.num_blocks,
        "pool_gb": batcher.executor.pool_bytes() / 1e9,
        "kv_pool_bytes": statusz["kvPoolBytes"],
    }
    log("ring: " + json.dumps(ring))
    log(f"ring {kv_quant} megastep {megastep} (a smoke reading of one "
        f"burst, not a benchmark): {new_tokens} new tokens in {burst_s:.3f}s "
        f"({ring['burst_new_tok_s']:.1f} new tok/s over the burst), TTFT "
        f"p50 {p50:.1f} ms, p95 {p95:.1f} ms (ring histogram), "
        f"{ring['wall_ms_per_chunk']:.1f} ms wall per dispatch; the "
        f"resubmission matches its cold run on {same:.3f} of its new "
        "tokens (not asserted: a prefill and a one-token suffix forward "
        "round differently in bf16)")
    if ref is not None:
        differ = [k for k in ref if outputs.get(k) != ref[k]]
        log(f"ring megastep {megastep} beside 3b (this run): "
            f"{len(ref) - len(differ)}/{len(ref)} requests token-identical; "
            f"new tok/s {ring['burst_new_tok_s']:.1f} vs "
            f"{bf16_ring['burst_new_tok_s']:.1f}; TTFT p50 {p50:.1f} vs "
            f"{bf16_ring['ttft_p50_ms']:.1f} ms, p95 {p95:.1f} vs "
            f"{bf16_ring['ttft_p95_ms']:.1f} ms; wall ms per token "
            f"{ring['wall_ms_per_token']:.2f} vs "
            f"{bf16_ring['wall_ms_per_token']:.2f}; dispatchesPerToken "
            f"{ring['dispatches_per_token']} vs "
            f"{bf16_ring['dispatches_per_token']}")
        if differ:
            raise AssertionError(f"megastep {megastep} tokens differ from "
                                 f"3b's for {differ}")
        if not ring["dispatches_per_token"] < \
                bf16_ring["dispatches_per_token"]:
            raise AssertionError("the megastep did not lower "
                                 "dispatchesPerToken")
        ring["single_step_ring"] = {k: bf16_ring[k] for k in (
            "burst_new_tok_s", "ttft_p50_ms", "ttft_p95_ms",
            "wall_ms_per_token", "dispatches_per_token")}
        report["ring_megastep"] = ring
        return outputs
    if bf16_ring is not None:
        log(f"ring int8 beside bf16 (3b, this run): kvPoolBytes "
            f"{ring['kv_pool_bytes']} vs {bf16_ring['kv_pool_bytes']} "
            f"({ring['kv_pool_bytes'] / bf16_ring['kv_pool_bytes']:.4f}x); "
            f"new tok/s {ring['burst_new_tok_s']:.1f} vs "
            f"{bf16_ring['burst_new_tok_s']:.1f}; TTFT p50 {p50:.1f} vs "
            f"{bf16_ring['ttft_p50_ms']:.1f} ms, p95 {p95:.1f} vs "
            f"{bf16_ring['ttft_p95_ms']:.1f} ms; wall ms per chunk "
            f"{ring['wall_ms_per_chunk']:.1f} vs "
            f"{bf16_ring['wall_ms_per_chunk']:.1f}")
        ring["bf16_ring"] = {k: bf16_ring[k] for k in (
            "kv_pool_bytes", "burst_new_tok_s", "ttft_p50_ms",
            "ttft_p95_ms", "wall_ms_per_chunk")}
    report["launches"] = launches
    report["ring"] = ring
    return outputs


# phase 3g: 3b's server; 8 class-1 requests (cold 512-token prompts,
# 192 new tokens) fill the lanes, then 2 class-0 requests (512-token
# prompts, 32 new tokens) arrive once every lane has decoded 2 chunks
PREEMPT = dict(prompt=512, victims=8, victim_new=192, urgent=2,
               urgent_new=32, chunks_first=2)


def _stream_timed(base: str, body: dict, headers=None) -> tuple:
    """A ``"stream": true`` generate: (HTTP status, the ndjson events,
    the host clock at each event, the clock at the send)."""
    req = urllib.request.Request(
        base + "/v1/generate", data=json.dumps(dict(body, stream=True))
        .encode(), headers={"Content-Type": "application/json",
                            **(headers or {})}, method="POST")
    t0 = time.perf_counter()
    events, times = [], []
    with urllib.request.urlopen(req, timeout=600) as r:
        for line in r:
            if line.strip():
                events.append(json.loads(line))
                times.append(time.perf_counter())
        status = r.status
    return status, events, times, t0


def _preempt_burst(params, cfg, kv_quant: str, preempt: bool) -> dict:
    """One run of phase 3g's traffic on a fresh 3b server (``kv_quant``
    pool, ``SERVE_PREEMPT`` on or off): every request's tokens, the
    class-0 latencies, the class-1 token gaps, the spills and restores
    (timed by wrappers around the executor's methods), the launches and
    replays, and the pool's accounting."""
    import numpy as np
    import torch

    from paddle_operator_tpu_torch.infer.qos import QoSConfig
    from paddle_operator_tpu_torch.infer.serve import make_server
    from paddle_operator_tpu_torch.ops import decode_attention as DA

    quant = kv_quant != "none"
    env = {"SERVE_PRIORITIES": "2"}
    if not preempt:
        env["SERVE_PREEMPT"] = "0"
    kw = dict(RING, prewarm=True, qos=QoSConfig.from_env(env))
    if quant:
        kw["kv_quant"] = kv_quant
    srv = make_server("127.0.0.1", 0, params, cfg, **kw)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    batcher = srv.generator.batcher
    ex = batcher.executor
    if not batcher.prewarmed.wait(600) or ex.needs_capture:
        raise AssertionError(f"3g: the ring's CUDA graphs were not captured "
                             f"at prewarm: {batcher.prewarm_error!r}")
    graphs = ex._graphs
    ptrs = ex._state_ptrs()
    counter = "quant_launches" if quant else "launches"
    spills, restores, broken = [], [], []
    marks = []              # (host clock, what) of dispatches, spills, restores
    real_spill, real_restore = ex.spill_lane, ex.restore_lane
    real_replay = ex.replay

    def spill_lane(slot):
        t0 = time.perf_counter()
        spill = real_spill(slot)
        t1 = time.perf_counter()
        marks.append((t0, f"spill {(t1 - t0) * 1e3:.1f} ms"))
        spills.append((t1 - t0, sum(
            v.numel() * v.element_size() for v in spill.values()
            if isinstance(v, torch.Tensor))))
        return spill

    def restore_lane(slot, spill):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        e0.record()
        real_restore(slot, spill)
        e1.record()
        t1 = time.perf_counter()
        marks.append((t0, f"restore {(t1 - t0) * 1e3:.1f} ms"))
        restores.append((t1 - t0, e0, e1,
                         getattr(DA.paged_decode_attention, counter),
                         ex.graph_replays))

    def replay(plan):
        marks.append((time.perf_counter(), "dispatch"))
        return real_replay(plan)

    ex.spill_lane, ex.restore_lane = spill_lane, restore_lane
    ex.replay = replay
    for name in ("_preempt", "_try_restore"):
        real = getattr(batcher, name)

        def checked(*a, _real=real, _name=name):
            out = _real(*a)
            try:
                batcher.pool.check_invariant()
            except AssertionError as e:
                broken.append(f"{_name}: {e}")
            return out

        setattr(batcher, name, checked)
    rng = np.random.default_rng(7)
    n = PREEMPT["prompt"]
    victims = [rng.integers(0, cfg.vocab_size, n).tolist()
               for _ in range(PREEMPT["victims"])]
    urgent = [rng.integers(0, cfg.vocab_size, n).tolist()
              for _ in range(PREEMPT["urgent"])]
    results, errors = {}, []

    def send(kind, i, p, new, prio):
        try:
            results[kind, i] = _stream_timed(
                base, {"tokens": [p], "max_new_tokens": new},
                {"X-Request-Priority": str(prio)})
        except Exception as e:              # surfaced after the join
            errors.append(f"{kind} {i}: {e!r}")

    try:
        free0 = batcher.pool.blocks_free()
        stats0 = dict(batcher.stats)
        replays0 = ex.graph_replays
        _zero_launches()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=send, args=(
            "class1", i, p, PREEMPT["victim_new"], 1))
            for i, p in enumerate(victims)]
        for t in threads:
            t.start()
        want_pos = n + PREEMPT["chunks_first"] * RING["chunk_tokens"]
        while not (all(r is not None for r in batcher.lane)
                   and min(batcher._lane_pos) >= want_pos):
            if errors or time.perf_counter() - t0 > 600:
                raise AssertionError(f"3g: the class-1 lanes never all "
                                     f"decoded 2 chunks: {errors}")
            time.sleep(0.002)
        late = [threading.Thread(target=send, args=(
            "class0", i, p, PREEMPT["urgent_new"], 0))
            for i, p in enumerate(urgent)]
        for t in late:
            t.start()
        for t in threads + late:
            t.join()
        burst_s = time.perf_counter() - t0
        with urllib.request.urlopen(base + "/statusz", timeout=60) as r:
            statusz = json.loads(r.read())
        torch.cuda.synchronize()
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
        srv.generator.close()
    if errors:
        raise AssertionError(f"3g requests failed: {errors}")
    out, gaps, urgent_s, class1_done = {}, [], [], []
    for (kind, i), (code, events, times, t_send) in sorted(results.items()):
        p = (victims if kind == "class1" else urgent)[i]
        new = PREEMPT["victim_new" if kind == "class1" else "urgent_new"]
        toks = [e["token"] for e in events if "token" in e]
        done = events[-1]
        if code != 200 or not done.get("done") or len(toks) != new \
                or done["tokens"] != p + toks:
            raise AssertionError(f"3g {kind} {i}: HTTP {code}, {len(toks)} "
                                 f"token events, last {str(done)[:200]}")
        _check_rows(cfg, p, done["tokens"], new, f"3g {kind} {i}")
        out[kind, i] = done["tokens"]
        tt = [t for t, e in zip(times, events) if "token" in e]
        if kind == "class1":
            gaps += [b - a for a, b in zip(tt, tt[1:])]
            class1_done.append(times[-1] - t0)
        else:
            urgent_s.append((tt[0] - t_send, times[-1] - t_send))
    pool = batcher.pool
    pool.check_invariant()
    chunks = batcher.stats["chunks"] - stats0["chunks"]
    launches = getattr(DA.paged_decode_attention, counter)
    per = cfg.n_layers * RING["chunk_tokens"]
    after = [(launches - c, ex.graph_replays - g)
             for _, _, _, c, g in restores]
    gaps = np.asarray(gaps)
    # where the burst's wall time went: the longest host intervals
    # between two dispatches, with the spills and restores inside them
    ticks = [t for t, what in marks if what == "dispatch"]
    waits = sorted(zip(np.diff(ticks), ticks), reverse=True)[:4]
    stalls = [(round((a - t0) * 1e3, 1), round(float(w) * 1e3, 1),
               [what for t, what in marks if what != "dispatch"
                and a <= t < a + w]) for w, a in waits]
    return {
        "kv_quant": kv_quant, "preempt": preempt, "outputs": out,
        "burst_s": burst_s, "chunks": chunks,
        "replays": ex.graph_replays - replays0,
        "launches": launches, "launches_want": per * chunks,
        "other_kernels": (DA.decode_attention.launches,
                          getattr(DA.paged_decode_attention,
                                  "launches" if quant else "quant_launches")),
        "launches_after_restores": after,
        "per_dispatch": per,
        "preempted": statusz["preemptedLanes"],
        "restored": batcher.stats["restored_lanes"] - stats0.get(
            "restored_lanes", 0),
        "parked": statusz["parkedLanes"],
        "free_before": free0, "free_after": statusz["kvBlocksFree"],
        "cached_after": pool.blocks_cached(), "invariant_breaks": broken,
        "spill_ms": [s * 1e3 for s, _ in spills],
        "spill_bytes": [b for _, b in spills],
        "restore_host_ms": [h * 1e3 for h, _, _, _, _ in restores],
        "restore_device_ms": [e0.elapsed_time(e1)
                              for _, e0, e1, _, _ in restores],
        "urgent_ttft_s": [a for a, _ in urgent_s],
        "urgent_done_s": [b for _, b in urgent_s],
        "class1_itl_p95_ms": float(np.percentile(gaps, 95)) * 1e3,
        "class1_gap_max_ms": float(gaps.max()) * 1e3,
        "class1_done_s": sorted(class1_done),
        "dispatch_interval_median_ms": float(np.median(np.diff(ticks))) * 1e3,
        "longest_intervals": stalls,
        "same_graphs": ex._graphs is graphs and ex._state_ptrs() == ptrs,
    }


def _host_link_readings(nbytes: int) -> dict:
    """What a spill's bytes cost on this machine's host link, piece by
    piece: page-locking a fresh host buffer (``torch.empty(...,
    pin_memory=True)``), a device-to-host copy into it and again into the
    same buffer, a copy into pageable memory, and a host-to-device copy
    from the pinned buffer; each timed by the host clock around a
    synchronized copy."""
    import torch

    src = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    torch.cuda.synchronize()

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3, out

    alloc_ms, host = timed(lambda: torch.empty(nbytes, dtype=torch.uint8,
                                               pin_memory=True))
    first_ms, _ = timed(lambda: host.copy_(src, non_blocking=True))
    again_ms, _ = timed(lambda: host.copy_(src, non_blocking=True))
    h2d_ms, _ = timed(lambda: src.copy_(host, non_blocking=True))
    pageable_ms, _ = timed(lambda: src.cpu())
    out = {"bytes": nbytes, "pin_alloc_ms": alloc_ms, "d2h_pinned_ms":
           first_ms, "d2h_pinned_again_ms": again_ms, "h2d_pinned_ms": h2d_ms,
           "d2h_pageable_ms": pageable_ms}
    for key in ("d2h_pinned_again_ms", "h2d_pinned_ms", "d2h_pageable_ms"):
        out[key.replace("_ms", "_gb_s")] = nbytes / out[key] / 1e6
    del src, host
    torch.cuda.empty_cache()
    return out


def phase_preemption(reports: tuple, params, cfg) -> None:
    """Phase 3g: preemption on the 7b ring at full width, on the bf16 and
    int8 pools, each beside a ``SERVE_PREEMPT=0`` run of the same
    requests; see the module docstring."""
    import torch

    for report, kv_quant in zip(reports, ("none", "int8")):
        runs = {}
        for preempt in (True, False):
            runs[preempt] = _preempt_burst(params, cfg, kv_quant, preempt)
            gc.collect()
            torch.cuda.empty_cache()
        on, off = runs[True], runs[False]
        name = ("paged_decode_attention_quant" if kv_quant == "int8"
                else "paged_decode_attention")
        differ = [k for k in on["outputs"] if k[0] == "class1"
                  and on["outputs"][k] != off["outputs"][k]]
        for run in (on, off):
            log(f"preempt {kv_quant} SERVE_PREEMPT={int(run['preempt'])}: "
                f"{name} launches {run['launches']} (n_layers x chunk x "
                f"dispatches {run['launches_want']}), other decode kernels "
                f"{run['other_kernels']}, CUDA graph replays "
                f"{run['replays']} for {run['chunks']} dispatches; "
                f"preemptedLanes {run['preempted']}, restored "
                f"{run['restored']}, parkedLanes {run['parked']}; "
                f"kvBlocksFree {run['free_before']} before, "
                f"{run['free_after']} + {run['cached_after']} cached after; "
                f"class-0 TTFT s {run['urgent_ttft_s']}, done s "
                f"{run['urgent_done_s']}; class-1 token gap p95 "
                f"{run['class1_itl_p95_ms']:.2f} ms, max "
                f"{run['class1_gap_max_ms']:.1f} ms; burst "
                f"{run['burst_s']:.3f} s on {card_line()}")
            bad = []
            if run["launches"] != run["launches_want"] \
                    or any(run["other_kernels"]):
                bad.append("launch counts")
            if run["replays"] != run["chunks"] or not run["same_graphs"]:
                bad.append("not every dispatch a replay of the prewarm "
                           "graphs at their addresses")
            if run["parked"] or run["invariant_breaks"]:
                bad.append(f"parked {run['parked']}, invariant "
                           f"{run['invariant_breaks']}")
            if run["free_after"] + run["cached_after"] != run["free_before"]:
                bad.append("blocks neither free nor cached at the end")
            if bad:
                raise AssertionError(f"3g {kv_quant} preempt "
                                     f"{run['preempt']}: {bad}")
        for run in (on, off):
            log(f"preempt {kv_quant} SERVE_PREEMPT={int(run['preempt'])} "
                f"timeline: class-1 done at s "
                f"{[round(x, 3) for x in run['class1_done_s']]}; median "
                f"interval between dispatches "
                f"{run['dispatch_interval_median_ms']:.1f} ms, longest "
                f"(start ms, length ms, what ran in it) "
                f"{run['longest_intervals']}")
        log(f"preempt {kv_quant}: spills {len(on['spill_ms'])}, ms "
            f"{[round(x, 3) for x in on['spill_ms']]}, bytes "
            f"{on['spill_bytes']}; restores ms host "
            f"{[round(x, 3) for x in on['restore_host_ms']]}, device "
            f"{[round(x, 3) for x in on['restore_device_ms']]}; after each "
            f"restore (launches, replays) {on['launches_after_restores']}; "
            f"class-1 streams equal to SERVE_PREEMPT=0's: "
            f"{8 - len(differ)}/8")
        if not on["preempted"] == on["restored"] >= 1 or off["preempted"]:
            raise AssertionError(f"3g {kv_quant}: preempted "
                                 f"{on['preempted']}, restored "
                                 f"{on['restored']} (preemption on); "
                                 f"{off['preempted']} with it off")
        if differ:
            raise AssertionError(f"3g {kv_quant}: class-1 streams differ "
                                 f"from the SERVE_PREEMPT=0 run: {differ}")
        if not all(c == g * on["per_dispatch"] and g > 0
                   for c, g in on["launches_after_restores"]):
            raise AssertionError(f"3g {kv_quant}: the kernel did not run the "
                                 "restored lanes' dispatches")
        report["preempt"] = {
            k: {key: v for key, v in run.items() if key != "outputs"}
            for k, run in (("on", on), ("off", off))}
        link = _host_link_readings(on["spill_bytes"][0])
        report["preempt"]["host_link"] = link
        log(f"preempt {kv_quant}: the host link for one spill's "
            f"{link['bytes']} bytes: pinning a fresh buffer "
            f"{link['pin_alloc_ms']:.1f} ms, device to pinned host "
            f"{link['d2h_pinned_ms']:.1f} ms (again into the same buffer "
            f"{link['d2h_pinned_again_ms']:.1f} ms, "
            f"{link['d2h_pinned_again_gb_s']:.1f} GB/s), pinned host to "
            f"device {link['h2d_pinned_ms']:.1f} ms "
            f"({link['h2d_pinned_gb_s']:.1f} GB/s), device to pageable "
            f"{link['d2h_pageable_ms']:.1f} ms "
            f"({link['d2h_pageable_gb_s']:.1f} GB/s) on {card_line()}")


def _zero_launches() -> None:
    from paddle_operator_tpu_torch.ops import decode_attention as DA
    from paddle_operator_tpu_torch.ops import flash_attention as FA

    for fn in (DA.decode_attention, DA.paged_decode_attention,
               FA.flash_forward, FA.flash_backward_dkv, FA.flash_backward_dq):
        fn.launches = 0
    DA.paged_decode_attention.quant_launches = 0


def _synced_clock() -> float:
    """Host clock read after the card has finished its queued work, so
    StepTimer's intervals are whole steps."""
    import torch

    torch.cuda.synchronize()
    return time.perf_counter()


def phase_train_main_path(reports: dict) -> None:
    """Phase 3c: 7b width, 8 layers, trained through ``fit``; see the
    module docstring."""
    import itertools
    import statistics

    import numpy as np
    import torch

    from paddle_operator_tpu_torch.models.llama import make_model
    from paddle_operator_tpu_torch.ops import decode_attention as DA
    from paddle_operator_tpu_torch.ops import flash_attention as FA
    from paddle_operator_tpu_torch.train import trainer as T
    from paddle_operator_tpu_torch.train.data import (
        DevicePrefetcher, deterministic_lm_batches)
    from paddle_operator_tpu_torch.utils.observability import StepTimer

    layers, b, s, steps = (TRAIN[k] for k in ("layers", "batch", "seq",
                                              "steps"))
    # what earlier phases left allocated is not the training's
    base_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    model, cfg = make_model("7b", device="cuda", seed=0, n_layers=layers)
    opt = T.make_optimizer(TRAIN["lr"], warmup_steps=1, decay_steps=1000)
    state = T.create_state(model, opt)
    step = T.make_train_step(opt)
    torch.cuda.synchronize()
    log(f"train: 7b width, {layers} layers ({cfg.num_params() / 1e9:.3f}B "
        f"params, f32 params, {cfg.dtype} compute, remat {cfg.remat}), "
        f"model + AdamW state built in "
        f"{time.perf_counter() - t0:.1f}s")
    batch = next(deterministic_lm_batches(b, s + 1, cfg.vocab_size, seed=0))
    batches = DevicePrefetcher(itertools.repeat(batch, steps), device="cuda")
    timer = StepTimer(b * s, cfg.flops_per_token(), PEAK_BF16,
                      window=steps, clock=_synced_clock)
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    t0 = _synced_clock()
    state, history = T.fit(state, step, batches, steps=steps, timer=timer)
    wall = _synced_clock() - t0
    fwd = FA.flash_forward.launches
    dkv = FA.flash_backward_dkv.launches
    dq = FA.flash_backward_dq.launches
    decode = (DA.decode_attention.launches
              + DA.paged_decode_attention.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9 - base_gb
    losses = [h["loss"] for h in history]
    norms = [h["grad_norm"] for h in history]
    log(f"train: losses {losses}")
    log(f"train: grad norms {norms}")
    if len(history) != steps or not all(np.isfinite(losses + norms)):
        raise AssertionError(f"fit ran {len(history)} of {steps} steps, or "
                             "a loss or grad norm is not finite")
    if not losses[-1] < 0.7 * losses[0]:
        raise AssertionError(f"the loss did not fall below 0.7x its first "
                             f"value: {losses[0]} -> {losses[-1]}")
    want = {"fwd": 2 * layers * steps, "dkv": layers * steps,
            "dq": layers * steps}
    log(f"train: launches flash_forward {fwd} (2 x {layers} layers x "
        f"{steps} steps = {want['fwd']}), flash_backward_dkv {dkv}, "
        f"flash_backward_dq {dq} ({layers} x {steps} = {want['dq']}); "
        f"decode kernels {decode}")
    if (fwd, dkv, dq) != (want["fwd"], want["dkv"], want["dq"]) or decode:
        raise AssertionError("the training path's kernel launches do not "
                             "match the formulas")
    times = list(timer.times)           # steps 2..N
    step_ms = statistics.median(times[1:]) * 1e3
    tok_s = b * s / (step_ms / 1e3)
    train = {
        "layers": layers, "batch": b, "seq": s, "steps": steps,
        "lr": TRAIN["lr"], "params": cfg.num_params(),
        "first_loss": losses[0], "last_loss": losses[-1],
        "fit_wall_s": wall, "step_ms_median": step_ms,
        "step_ms": [t * 1e3 for t in times],
        "tokens_per_s": tok_s,
        "flops_per_token": cfg.flops_per_token(),
        "mfu": tok_s * cfg.flops_per_token() / PEAK_BF16,
        "max_memory_allocated_gb": peak_gb,
        "allocated_before_gb": base_gb,
    }
    log("train: " + json.dumps(train))
    log(f"train (one run of {steps} steps, not a benchmark): step "
        f"{step_ms:.1f} ms (median of steps 3..{steps}), {tok_s:.0f} "
        f"tokens/s, MFU {train['mfu']:.3f} against {PEAK_BF16 / 1e12:.0f} "
        f"TFLOP/s bf16, peak memory {peak_gb:.1f} GB (above the "
        f"{base_gb:.1f} GB allocated before it); loss {losses[0]:.3f}"
        f" -> {losses[-1]:.3f}")
    for kern, n in (("flash_forward", fwd), ("flash_backward_dkv", dkv),
                    ("flash_backward_dq", dq)):
        reports[kern]["launches"] = n
    reports["flash_forward"]["train"] = train
    del state, step, model, opt, batches
    torch.cuda.empty_cache()


def phase_checkpoint(reports: dict) -> None:
    """Phase 3f: save, drain, restore, continue and serve a checkpoint;
    see the module docstring."""
    import itertools
    import logging
    import os
    import shutil
    import tempfile

    import numpy as np
    import torch

    from paddle_operator_tpu_torch.ft.preemption import (
        PreemptionWatcher, inject_preemption)
    from paddle_operator_tpu_torch.infer.quant import serving_params
    from paddle_operator_tpu_torch.infer.serve import (load_serving_params,
                                                       make_server)
    from paddle_operator_tpu_torch.models.llama import CONFIGS, make_model
    from paddle_operator_tpu_torch.ops import decode_attention as DA
    from paddle_operator_tpu_torch.ops import flash_attention as FA
    from paddle_operator_tpu_torch.train import trainer as T
    from paddle_operator_tpu_torch.train.checkpoint import (
        CheckpointManager, resume_or_init)
    from paddle_operator_tpu_torch.train.data import (
        DevicePrefetcher, deterministic_lm_batches)
    from paddle_operator_tpu_torch.utils.observability import StepTimer

    layers, b, s = CKPT["layers"], CKPT["batch"], CKPT["seq"]
    steps, drain_at = CKPT["steps"], CKPT["drain_at"]
    card = card_line()

    def new_state(seed):
        model, _ = make_model("7b", device="cuda", seed=seed,
                              n_layers=layers)
        opt = T.make_optimizer(CKPT["lr"], warmup_steps=1, decay_steps=1000)
        return T.create_state(model, opt), T.make_train_step(opt)

    def batches(start, n):
        return DevicePrefetcher(itertools.islice(deterministic_lm_batches(
            b, s + 1, CONFIGS["7b"].vocab_size, seed=0, start_step=start),
            n), device="cuda")

    def run_fit(what, state, step, data, n, **kw):
        """``fit`` with the flash launches of exactly that run held to
        3c's formulas."""
        timer = StepTimer(b * s, 1.0, 1.0, window=n, clock=_synced_clock)
        _zero_launches()
        t0 = _synced_clock()
        state, hist = T.fit(state, step, data, steps=n, timer=timer, **kw)
        secs = _synced_clock() - t0
        done = len(hist)
        got = (FA.flash_forward.launches, FA.flash_backward_dkv.launches,
               FA.flash_backward_dq.launches)
        want = (2 * layers * done, layers * done, layers * done)
        decode = (DA.decode_attention.launches
                  + DA.paged_decode_attention.launches
                  + DA.paged_decode_attention.quant_launches)
        losses = [h["loss"] for h in hist]
        log(f"checkpoint {what}: {done} steps in {secs:.2f}s (step ms "
            f"{[round(t * 1e3, 1) for t in timer.times]}), losses "
            f"{losses}; flash launches fwd/dkv/dq {got} (2 x {layers} x "
            f"{done}, {layers} x {done}, {layers} x {done} = {want}), "
            f"decode kernels {decode}; {card}")
        if got != want or decode:
            raise AssertionError(f"checkpoint {what}: the flash launches "
                                 "do not match the formulas")
        if not np.all(np.isfinite(losses)):
            raise AssertionError(f"checkpoint {what}: a loss is not finite")
        return state, losses

    def same_state(got, want) -> list:
        """Names of what differs between two TrainStates, bit for bit."""
        bad = [k for k, v in want.model.state_dict().items()
               if not torch.equal(got.model.state_dict()[k], v)]
        for part in ("mu", "nu"):
            g, w = getattr(got.opt_state, part), getattr(want.opt_state, part)
            bad += [f"{part}.{k}" for k in w
                    if g[k].dtype != w[k].dtype or not torch.equal(g[k], w[k])]
        if (got.step, got.opt_state.count) != (want.step,
                                               want.opt_state.count):
            bad.append("step/count")
        return bad

    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        free = shutil.disk_usage(root).free
        params_n = dataclasses.replace(CONFIGS["7b"],
                                       n_layers=layers).num_params()
        need = 2 * 3 * 4 * params_n          # two steps of f32 p, mu, nu
        log(f"checkpoint: 7b width, {layers} layers ({params_n / 1e9:.3f}B "
            f"params, f32 master, bf16 compute), B={b} S={s}; "
            f"{free / 1e9:.1f} GB free under {root} (U keeps two steps, "
            f"{need / 1e9:.1f} GB)")
        if free < need:
            raise AssertionError("not enough disk for phase 3f's "
                                 "checkpoints")

        # (a) the unbroken run U, saving under the interval; U2, the same
        # run without a manager, reads the spread of two unbroken runs
        state, step = new_state(0)
        ck_u = CheckpointManager(os.path.join(root, "U"), max_to_keep=2,
                                 save_interval_steps=CKPT["interval"])
        state, losses_u = run_fit("U", state, step, batches(0, steps),
                                  steps, checkpoint=ck_u)
        ck_u.wait()
        save_u = dict(ck_u.last_save)
        if ck_u.all_steps() != [3, 6]:
            raise AssertionError(f"U committed {ck_u.all_steps()}, "
                                 "expected [3, 6]")
        u_final = {k: v.clone() for k, v in state.model.state_dict().items()}
        shutil.rmtree(ck_u.path)
        del state, step
        state, step = new_state(0)
        state, losses_u2 = run_fit("U2", state, step, batches(0, steps),
                                   steps)
        spread = max(abs(x - y) for x, y in zip(losses_u, losses_u2))
        same = "bit-identical" if losses_u == losses_u2 else "differ"
        log(f"checkpoint: two unbroken runs, max |loss difference| "
            f"{spread!r} ({same}; {card})")
        del state, step

        # (b) the drained run R: a real SIGTERM while step 3 is in flight
        state_r, step_r = new_state(0)
        ck_r = CheckpointManager(os.path.join(root, "R"), max_to_keep=2)
        records = []
        logger = logging.getLogger("chip_smoke.checkpoint")
        logger.setLevel(logging.INFO)
        handler = logging.Handler()
        handler.emit = lambda r: records.append(r.getMessage())
        logger.addHandler(handler)
        watcher = PreemptionWatcher.install()
        try:
            data = batches(0, steps)
            state_r, losses_r = run_fit(
                "R", state_r, step_r,
                inject_preemption(data, drain_at, watcher, signal_self=True),
                steps, checkpoint=ck_r, preemption=watcher, logger=logger)
            committed = ck_r.all_steps()     # before any wait of ours
        finally:
            watcher.uninstall()
            logger.removeHandler(handler)
        list(data)                           # let the prefetcher finish
        save_r = dict(ck_r.last_save)
        log(f"checkpoint R: watcher draining {watcher.draining} "
            f"({watcher.reason}), step {state_r.step}, committed "
            f"{committed}; log {records}")
        if not (watcher.draining and state_r.step == drain_at + 1
                and committed == [drain_at + 1]
                and any(f"step={drain_at + 1} checkpoint=saved" in m
                        for m in records)):
            raise AssertionError("the drain did not leave a durable "
                                 "checkpoint of the in-flight step")
        if losses_r != losses_u[:drain_at + 1]:
            log(f"checkpoint R: losses {losses_r} differ from U's first "
                f"{drain_at + 1} {losses_u[:drain_at + 1]}")

        # (c) restore R's checkpoint into a model from another seed
        fresh, step_c = new_state(1)
        t0 = _synced_clock()
        state_c, resumed = resume_or_init(CheckpointManager(ck_r.path),
                                          lambda: fresh)
        restore_s = _synced_clock() - t0
        bad = same_state(state_c, state_r)
        log(f"checkpoint restore: resumed {resumed}, step {state_c.step}, "
            f"count {state_c.opt_state.count} in {restore_s:.3f}s; "
            f"{len(bad)} tensors differ from R's in memory; {card}")
        if not resumed or bad:
            raise AssertionError(f"the restore is not bit-exact: {bad[:8]}")

        # (d) continue 3 steps from the restored state
        state_c, losses_d = run_fit(
            "continued", state_c, step_c, batches(drain_at + 1, steps),
            steps - drain_at - 1)
        worst = max(abs(x - y)
                    for x, y in zip(losses_d, losses_u[drain_at + 1:]))
        params_same = all(torch.equal(state_c.model.state_dict()[k], v)
                          for k, v in u_final.items())
        log(f"checkpoint continued: losses {losses_d} against U's "
            f"{losses_u[drain_at + 1:]}, max |difference| {worst!r}; "
            f"final params bit-identical to U's: {params_same}; {card}")
        if losses_d != losses_u[drain_at + 1:] or not params_same:
            raise AssertionError("the continued run is not bit-identical "
                                 "to the unbroken run")
        del state_c, step_c, fresh, u_final
        gc.collect()
        torch.cuda.empty_cache()

        # (e) serve R's checkpoint: the parameter file only, cast to bf16
        # on its way to the card
        scfg = dataclasses.replace(CONFIGS["7b"], n_layers=layers)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        served, scfg, resumed = load_serving_params(ck_r.path, scfg, "cuda")
        torch.cuda.synchronize()
        serve_restore_s = time.perf_counter() - t0
        added = torch.cuda.memory_allocated() - base
        bf16_bytes = 2 * scfg.num_params()
        log(f"checkpoint serve restore: resumed {resumed} in "
            f"{serve_restore_s:.3f}s; allocated +{added} bytes against "
            f"{bf16_bytes} bf16 parameter bytes (margin "
            f"{SERVE_LOAD_MARGIN}); {card}")
        if not resumed or added > bf16_bytes + SERVE_LOAD_MARGIN:
            raise AssertionError("the serving restore did not resume, or "
                                 "added more than the bf16 parameters")
        in_memory = serving_params(state_r.model, scfg.dtype)
        del state_r, step_r
        differ = [k for k, v in in_memory.state_dict().items()
                  if not torch.equal(served.state_dict()[k], v)]
        if differ:
            raise AssertionError(f"served params differ from R's cast in "
                                 f"memory: {differ[:8]}")
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, scfg.vocab_size, n).tolist()
                   for n in (100, 257, 512, 600)]
        n_new = CKPT["new_tokens"]
        tokens = {}
        for what, params in (("restored", served), ("in memory", in_memory)):
            srv = make_server("127.0.0.1", 0, params, scfg,
                              **dict(RING, prewarm=True))
            th = threading.Thread(target=srv.serve_forever, daemon=True)
            th.start()
            base_url = f"http://127.0.0.1:{srv.server_address[1]}"
            batcher = srv.generator.batcher
            results, errors = {}, []

            def send(i, p):
                try:
                    results[i] = _post(base_url, {"tokens": [p],
                                                  "max_new_tokens": n_new})
                except Exception as e:        # surfaced after the join
                    errors.append(f"{i}: {e!r}")

            try:
                if not batcher.prewarmed.wait(600) or \
                        batcher.executor.needs_capture:
                    raise AssertionError("the ring's CUDA graphs were not "
                                         "captured at prewarm")
                chunks0 = batcher.stats["chunks"]
                _zero_launches()
                threads = [threading.Thread(target=send, args=(i, p))
                           for i, p in enumerate(prompts)]
                for t in threads:
                    t.start()
                for t in threads:
                    t.join()
                chunks = batcher.stats["chunks"] - chunks0
            finally:
                srv.shutdown()
                srv.server_close()
                th.join(timeout=30)
                srv.generator.close()
            launches = DA.paged_decode_attention.launches
            others = (DA.decode_attention.launches,
                      DA.paged_decode_attention.quant_launches,
                      FA.flash_forward.launches)
            if errors:
                raise AssertionError(f"serving requests failed: {errors}")
            rows = []
            for i, p in enumerate(prompts):
                code, body, _ = results[i]
                if code != 200:
                    raise AssertionError(f"{what} {i}: HTTP {code}")
                _check_rows(scfg, p, body["tokens"][0], n_new, f"{what} {i}")
                rows.append(body["tokens"][0])
            tokens[what] = rows
            want = scfg.n_layers * RING["chunk_tokens"] * chunks
            log(f"checkpoint serve ({what}): 4 prompts x {n_new} greedy "
                f"tokens; paged_decode_attention launches {launches} "
                f"(n_layers {scfg.n_layers} x chunk {RING['chunk_tokens']} "
                f"x dispatches {chunks} = {want}); kernel #1, int8 kernel, "
                f"flash forward {others}")
            if launches != want or any(others):
                raise AssertionError(f"checkpoint serve ({what}): the "
                                     "paged kernel's launches do not match "
                                     "the formula, or another kernel ran")
        if tokens["restored"] != tokens["in memory"]:
            raise AssertionError("the restored checkpoint's tokens differ "
                                 "from the in-memory model's")
        del served, in_memory

        summary = {
            "layers": layers, "params": params_n,
            "checkpoint_bytes": save_u["bytes"],
            "snapshot_s": [save_u["snapshot_s"], save_r["snapshot_s"]],
            "write_s": [save_u["write_s"], save_r["write_s"]],
            "write_gb_s": [save_u["bytes"] / save_u["write_s"] / 1e9,
                           save_r["bytes"] / save_r["write_s"] / 1e9],
            "train_restore_s": restore_s,
            "serve_restore_s": serve_restore_s,
            "serve_restore_added_bytes": added,
            "bf16_param_bytes": bf16_bytes,
            "unbroken_spread": spread, "continued_worst": worst,
            "losses_u": losses_u, "losses_u2": losses_u2,
            "losses_continued": losses_d, "card": card,
        }
        log("checkpoint: " + json.dumps(summary))
        log(f"checkpoint (one run, not a benchmark): "
            f"{save_u['bytes'] / 1e9:.3f} GB a step; save() held the loop "
            f"{save_u['snapshot_s']:.3f}s (U, step 6) / "
            f"{save_r['snapshot_s']:.3f}s (R's drain); background write "
            f"{save_u['write_s']:.2f}s ({summary['write_gb_s'][0]:.2f} "
            f"GB/s) / {save_r['write_s']:.2f}s "
            f"({summary['write_gb_s'][1]:.2f} GB/s); restore "
            f"{restore_s:.3f}s (training) / {serve_restore_s:.3f}s "
            f"(serving, bf16); {card}")
        reports["flash_forward"]["checkpoint"] = summary
    finally:
        shutil.rmtree(root, ignore_errors=True)
        gc.collect()
        torch.cuda.empty_cache()


def phase_kernel_path_equals_plain() -> None:
    import numpy as np
    import torch

    from paddle_operator_tpu_torch.infer import decode as D
    from paddle_operator_tpu_torch.models.llama import make_model

    params, cfg = make_model("7b", device="cuda", seed=1, n_layers=2,
                             dtype=torch.float32)
    kcfg = dataclasses.replace(cfg, decode_attn="kernel")
    pcfg = dataclasses.replace(cfg, decode_attn="plain")
    prompt = torch.as_tensor(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 64)),
        dtype=torch.int32, device="cuda")
    with torch.inference_mode():
        a = D.generate(params, kcfg, prompt, max_new_tokens=16, max_len=256)
        b = D.generate(params, pcfg, prompt, max_new_tokens=16, max_len=256)
        if not torch.equal(a, b):
            raise AssertionError("greedy tokens differ between the kernel "
                                 "and the plain decode path")
        lk, ck = D.prefill(params, kcfg, prompt, 256)
        lp, cp = D.prefill(params, pcfg, prompt, 256)
        err = 0.0
        for t in range(16):
            tok = a[:, 64 + t]
            lk, ck = D.decode_step(params, kcfg, tok, ck)
            lp, cp = D.decode_step(params, pcfg, tok, cp)
            err = max(err, float((lk - lp).abs().max()))
    log(f"kernel path == plain path (7b width, 2 layers, f32): tokens "
        f"identical, max logit diff {err:.3e} (limit 1e-3)")
    if err > 1e-3:
        raise AssertionError(f"kernel vs plain decode logits differ by "
                             f"{err}")
    del params
    torch.cuda.empty_cache()


def phase_rings_equal_generate() -> None:
    import numpy as np
    import torch

    from paddle_operator_tpu_torch.infer import decode as D
    from paddle_operator_tpu_torch.infer.batcher import ContinuousBatcher
    from paddle_operator_tpu_torch.models.llama import make_model
    from paddle_operator_tpu_torch.ops import decode_attention as DA

    params, cfg = make_model("7b", device="cuda", seed=3, n_layers=2,
                             dtype=torch.float32)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (300, 64, 513)]
    # a prefix hit: the 513-token prompt's two full blocks + 7 tokens
    prompts.append(prompts[2][:512]
                   + rng.integers(0, cfg.vocab_size, 7).tolist())
    n_new, max_len = 16, 1024
    with torch.inference_mode():
        want = [D.generate(params, cfg,
                           torch.tensor([p], dtype=torch.int32,
                                        device="cuda"),
                           max_new_tokens=n_new, max_len=max_len)[0]
                .tolist() for p in prompts]
    for paged in (True, False):
        DA.decode_attention.launches = 0
        DA.paged_decode_attention.launches = 0
        ring = ContinuousBatcher(params, cfg, slots=4, max_len=max_len,
                                 chunk_tokens=8, paged=paged,
                                 block_size=256)
        try:
            got = [h.result(timeout=600) for h in
                   [ring.submit(p, max_new_tokens=n_new) for p in prompts]]
        finally:
            ring.close()
        contiguous = DA.decode_attention.launches
        launched = DA.paged_decode_attention.launches
        name = "paged" if paged else "contiguous"
        hit = ring.pool.stats["prefix_hit_tokens"] if paged else 0
        log(f"{name} ring == generate (7b width, 2 layers, f32): "
            f"{sum(g == w for g, w in zip(got, want))}/{len(want)} rows "
            f"equal; paged kernel launches {launched}, kernel #1 "
            f"{contiguous}; prefix hit tokens {hit}")
        if got != want:
            raise AssertionError(f"the {name} ring's greedy tokens differ "
                                 "from generate")
        if paged and (not launched or contiguous or hit < 512):
            raise AssertionError("the paged ring did not run the paged "
                                 "kernel alone, or missed the prefix hit")
        if not paged and (launched or not contiguous):
            raise AssertionError("the contiguous ring did not run kernel "
                                 "#1 alone")
    del params
    torch.cuda.empty_cache()


def phase_quant_ring_kernel_equals_plain() -> None:
    """Phase 4d: the int8 ring through its kernel and through the plain
    dequantizing view; see the module docstring."""
    import numpy as np
    import torch

    from paddle_operator_tpu_torch.infer import decode as D
    from paddle_operator_tpu_torch.infer import paged as PG
    from paddle_operator_tpu_torch.infer.batcher import ContinuousBatcher
    from paddle_operator_tpu_torch.models.llama import make_model
    from paddle_operator_tpu_torch.ops import decode_attention as DA

    params, cfg = make_model("7b", device="cuda", seed=4, n_layers=2,
                             dtype=torch.float32)
    kcfg = dataclasses.replace(cfg, decode_attn="kernel")
    pcfg = dataclasses.replace(cfg, decode_attn="plain")
    bs, max_len, n_new = 16, 256, 24
    rng = np.random.default_rng(4)
    a = rng.integers(0, cfg.vocab_size, 48).tolist()     # three blocks
    first = [a, rng.integers(0, cfg.vocab_size, 37).tolist()]
    # once a's blocks are cached: a again (a block-aligned full hit,
    # capped at 47 tokens) and a[:40] (its hit ends mid-block)
    then = [a, a[:40]]
    got = {}
    for name, c in (("kernel", kcfg), ("plain", pcfg)):
        DA.paged_decode_attention.launches = 0
        DA.paged_decode_attention.quant_launches = 0
        ring = ContinuousBatcher(params, c, slots=4, max_len=max_len,
                                 chunk_tokens=8, paged=True, block_size=bs,
                                 kv_quant="int8")
        try:
            rows = [h.result(timeout=600) for h in
                    [ring.submit(p, max_new_tokens=n_new) for p in first]]
            rows += [h.result(timeout=600) for h in
                     [ring.submit(p, max_new_tokens=n_new) for p in then]]
            hits = ring.pool.stats["prefix_hit_tokens"]
            cow = ring.pool.stats["cow_copies"]
            ring.pool.check_invariant()
        finally:
            ring.close()
        launched = DA.paged_decode_attention.quant_launches
        log(f"int8 ring, {name} path (7b width, 2 layers, f32, bs {bs}): "
            f"int8 kernel launches {launched}, bf16 paged kernel "
            f"{DA.paged_decode_attention.launches}; prefix hit tokens "
            f"{hits}, CoW copies {cow}")
        if DA.paged_decode_attention.launches or \
                (launched == 0) != (name == "plain"):
            raise AssertionError(f"the int8 ring's {name} path ran the "
                                 "wrong kernels")
        if hits != 47 + 39 or cow < 2:
            raise AssertionError(f"expected a full hit (47) and a mid-block "
                                 f"hit (39) with copy-on-write, got {hits} "
                                 f"hit tokens and {cow} copies")
        got[name] = rows
    if got["kernel"] != got["plain"]:
        raise AssertionError("greedy tokens differ between the int8 ring's "
                             "kernel and plain paths")

    # per-tick logits: one lane prefilled through the cold paged prefill
    # (37 tokens), then 44 ticks (blocks complete at 47, 63 and 79).  Each
    # tick runs the plain path from a copy of the kernel path's state, so
    # the two are held against each other one tick at a time: from free
    # running states a last-bit difference upstream can move a code
    # across a midpoint when a block quantizes, and that difference then
    # stays.  The unquantized pool (here f32) runs beside them (reported,
    # not gated).
    n = 37
    prompt = torch.tensor([first[1]], dtype=torch.int32, device="cuda")
    table = torch.arange(1, max_len // bs + 1, dtype=torch.int32,
                         device="cuda")[None]
    caches = {}
    with torch.inference_mode():
        for name, quant in (("int8", "int8"), ("plain-pool", "none")):
            cache = PG.init_paged_cache(kcfg, 1, max_len // bs + 1, bs,
                                        quant=quant)
            out = D.paged_prefill(params, kcfg, prompt, cache, table[0],
                                  block_size=bs, last_only=True,
                                  quant=quant == "int8", prompt_len=n)
            if quant == "int8":
                cache["kt"][:, 0], cache["vt"][:, 0] = out[2][:, 0], \
                    out[3][:, 0]
            cache["pos"][0] = n
            caches[name] = cache
        tok = out[0][0, -1].argmax(-1).reshape(1).to(torch.int32)
        err = vs_pool = 0.0
        for _ in range(44):
            twin = {k: t.clone() for k, t in caches["int8"].items()}
            lk, _ = PG.paged_ring_forward(kcfg, params, tok, caches["int8"],
                                          table, quant=True)
            lp, _ = PG.paged_ring_forward(pcfg, params, tok, twin, table,
                                          quant=True)
            lb, _ = PG.paged_ring_forward(kcfg, params, tok,
                                          caches["plain-pool"], table)
            for cache in caches.values():
                cache["pos"] += 1
            err = max(err, float((lk - lp).abs().max()))
            vs_pool = max(vs_pool, float((lk - lb).abs().max()))
            tok = lk[0].argmax(-1).reshape(1).to(torch.int32)
    log(f"int8 ring kernel path == plain path (7b width, 2 layers, f32, bs "
        f"{bs}): tokens identical over {len(first) + len(then)} requests, "
        f"max logit diff {err:.3e} over 44 ticks from the same state "
        f"(limit 1e-3); int8 against the unquantized pool (not gated): "
        f"worst logit delta {vs_pool:.3e}")
    if err > 1e-3:
        raise AssertionError(f"int8 kernel vs plain ring logits differ by "
                             f"{err}")
    del params, caches
    torch.cuda.empty_cache()


MEGA_RINGS = (("contiguous", {"paged": False}),
              ("paged", {"paged": True, "block_size": 16}),
              ("int8", {"paged": True, "block_size": 16,
                        "kv_quant": "int8"}))


def _admit_cold(ex, slot, prompt) -> None:
    """A cold admission into a bare executor, as the scheduler makes it:
    map the lane's blocks (paged) and run the bucket's insert."""
    import numpy as np
    import torch

    from paddle_operator_tpu_torch.infer import executor as X

    n = len(prompt)
    bucket = next(b for b in ex.buckets if n <= b)
    dev_prompt = X.to_device(np.asarray([prompt], np.int32), ex.device)
    if ex.paged:
        ex.pool.admit(slot, prompt)
        row = X.to_device(ex.pool.table[slot], ex.device, torch.int32)
        ex.inserts[bucket](ex.params, ex.cache, row, ex.tok, ex.temp,
                           ex.seeds, dev_prompt, n, slot, 0.0, 0)
    else:
        ex.inserts[bucket](ex.params, ex.cache, ex.tok, ex.temp, ex.seeds,
                           dev_prompt, n, slot, 0.0, 0)


def phase_megastep_rings() -> None:
    """Phase 4e: megastep 4 == megastep 1 on the three rings, and graph
    replay == the eager program; see the module docstring."""
    import numpy as np
    import torch

    from paddle_operator_tpu_torch.infer import executor as X
    from paddle_operator_tpu_torch.infer.batcher import ContinuousBatcher
    from paddle_operator_tpu_torch.models.llama import make_model

    params, cfg = make_model("7b", device="cuda", seed=5, n_layers=2,
                             dtype=torch.float32)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist()
               for n in (40, 300, 129, 64)]
    n_new, max_len, chunk = 40, 512, 8

    def serve(ring, megastep, eos=None, freeze=False):
        b = ContinuousBatcher(params, cfg, slots=4, max_len=max_len,
                              chunk_tokens=chunk, megastep=megastep,
                              prewarm=True, **ring)
        budgets = []
        if freeze:
            # a huge per-iteration estimate: every lane's step budget is
            # 1 of 4 iterations, so lanes freeze mid-megastep
            b._step_s_est = 3000.0
            real = b.executor.replay

            def spy(plan):
                budgets.append(int(np.min(
                    plan.steps[np.asarray(plan.active, bool)])))
                return real(plan)

            b.executor.replay = spy
        try:
            b.prewarmed.wait(600)
            out = [h.result(timeout=600) for h in [
                b.submit(p, max_new_tokens=n_new, eos_token=eos,
                         deadline_s=3000.0 if freeze else None)
                for p in prompts]]
            if b.pool is not None:
                b.pool.check_invariant()
            return out, dict(b.stats), budgets
        finally:
            b.close()

    for name, ring in MEGA_RINGS:
        one, s1, _ = serve(ring, 1)
        four, s4, _ = serve(ring, 4)
        # an eos that first fires inside a fused iteration, after the
        # first (new token 0 comes from the prefill, 1-8 from iteration
        # 0), and not on a chunk's last tick
        r, at = next((r, i) for r, out in enumerate(one)
                     for i in range(10, n_new)
                     if out[len(prompts[r]) + i]
                     not in out[len(prompts[r]):len(prompts[r]) + i]
                     and i % chunk)
        eos = one[r][len(prompts[r]) + at]
        one_e, _, _ = serve(ring, 1, eos)
        four_e, _, _ = serve(ring, 4, eos)
        cut = len(one_e[r]) - len(prompts[r])
        if cut != at + 1:
            raise AssertionError(f"{name} ring: eos {eos} cut request {r} "
                                 f"to {cut} new tokens, expected {at + 1}")
        line = (f"megastep {name} ring (7b width, 2 layers, f32): N=4 "
                f"tokens == N=1 on {sum(a == b for a, b in zip(four, one))}"
                f"/{len(one)} requests, dispatches {s4['chunks']} vs "
                f"{s1['chunks']}; eos {eos} cut request {r} to {cut} new "
                f"tokens, N=4 == N=1 on "
                f"{sum(a == b for a, b in zip(four_e, one_e))}/{len(one)}")
        if four != one or four_e != one_e or not s4["chunks"] < s1["chunks"]:
            raise AssertionError(line)
        if ring["paged"]:
            frozen, _, budgets = serve(ring, 4, freeze=True)
            line += (f"; frozen lanes (step budgets {sorted(set(budgets))})"
                     f" resume == N=1 on "
                     f"{sum(a == b for a, b in zip(frozen, one))}/{len(one)}")
            if frozen != one or min(budgets) != 1:
                raise AssertionError(line)
        log(line)

    # graph replay == the eager program, on executors driven alike
    with torch.inference_mode():
        for name, ring in MEGA_RINGS:
            exs = []
            for _ in range(2):
                ex = X.RingExecutor(params, cfg, slots=4, max_len=max_len,
                                    chunk_tokens=chunk, megastep=4, **ring)
                exs.append(ex)
            graph, eager = exs
            graph.prewarm()
            for ex in exs:
                for slot, p in enumerate(prompts):
                    _admit_cold(ex, slot, p)
            gone = 0
            for k in range(6):
                n = 4 if k % 2 else 1
                for ex in exs:
                    if ex.paged:
                        for slot, p in enumerate(prompts):
                            ex.pool.ensure(slot, len(p) + (k + 1) * 4 * chunk)
                plan = X.ExecPlan(
                    n, [True, True, True, k < 4],
                    table=graph.pool.table if graph.paged else None,
                    eos=np.asarray([-1, eos, -1, -1], np.int32),
                    left=np.asarray([500, 500, 20, 500], np.int32),
                    steps=np.asarray([4, 4, 4, 2 if graph.paged else 4],
                                     np.int32))
                gt, gc_ = graph.replay(plan).host()
                et, ec = X.DispatchResult(*eager.run(plan), n).host()
                same = (np.array_equal(gt, et)
                        and (n == 1 or np.array_equal(gc_, ec))
                        and torch.equal(graph.cache["pos"],
                                        eager.cache["pos"])
                        and torch.equal(graph.tok, eager.tok))
                if not same:
                    raise AssertionError(f"{name} ring: graph replay {k} "
                                         f"({n} steps) differs from the "
                                         "eager program")
                if n > 1:
                    gone += int((ec.sum(axis=0) < 4 * chunk).sum())
            log(f"megastep {name} ring: 6 graph replays (1- and 4-step) == "
                f"the eager program bit for bit (toks, counts, pos, tok); "
                f"lanes cut short in fused dispatches {gone}; capture "
                f"{graph.capture_s:.2f}s, graph pool "
                f"{graph.graph_pool_bytes()} bytes")
            del exs, graph, eager
    del params
    torch.cuda.empty_cache()


def _restore_run(ex, prompts, megastep, graphs: bool, spill_at=None):
    """Phase 4f's drive of one executor, every dispatch a graph replay
    (``graphs``) or the eager program: lane A (``prompts[0]``) decodes
    alone in slot 0; with ``spill_at`` set it is spilled after that many
    dispatches, lane B (``prompts[1]``) takes slot 0 for one dispatch,
    A is restored into slot 1 and both continue.  Returns A's tokens
    over the dispatches (the admission's first token aside) and what
    the restore saw: the state's addresses before and after, the graphs
    object before and after, and A's kernel launches after it."""
    import numpy as np

    from paddle_operator_tpu_torch.infer import executor as X
    from paddle_operator_tpu_torch.ops import decode_attention as DA

    chunk, total = ex.chunk, 3 if megastep > 1 else 6
    pos = {0: len(prompts[0])}
    slot_a, seen = 0, {}

    def dispatch():
        for slot, p in pos.items():
            ex.pool.ensure(slot, p + megastep * chunk)
        active = [i in pos for i in range(ex.slots)]
        plan = X.ExecPlan(megastep, active, table=ex.pool.table,
                          eos=np.full(ex.slots, -1, np.int32),
                          left=np.full(ex.slots, 1000, np.int32),
                          steps=np.full(ex.slots, megastep, np.int32))
        res = ex.replay(plan) if graphs else X.DispatchResult(
            *ex.run(plan), megastep)
        toks, _ = res.host()
        for slot in pos:
            pos[slot] += megastep * chunk
        return toks.reshape(-1, ex.slots)

    _admit_cold(ex, 0, prompts[0])
    got = []
    for k in range(total):
        if k == spill_at:
            spill = ex.spill_lane(0)
            ex.pool.retire(0)
            del pos[0]
            _admit_cold(ex, 0, prompts[1])
            pos[0] = len(prompts[1])
            dispatch()
            seen["ptrs"], seen["graphs"] = ex._state_ptrs(), ex._graphs
            ex.restore_lane(1, spill)
            seen["ptrs_after"], seen["graphs_after"] = (ex._state_ptrs(),
                                                        ex._graphs)
            pos[1] = spill["pos"]
            slot_a = 1
            seen["launches"] = (DA.paged_decode_attention.launches
                                + DA.paged_decode_attention.quant_launches)
        got += dispatch()[:, slot_a].tolist()
    if spill_at is not None:
        seen["launches"] = (DA.paged_decode_attention.launches
                            + DA.paged_decode_attention.quant_launches
                            - seen["launches"])
        ex.pool.check_invariant()
    return got, seen


def phase_restore_under_graphs() -> None:
    """Phase 4f: a lane spilled at a boundary and restored into another
    slot under CUDA graph replay resumes the uninterrupted stream bit for
    bit; see the module docstring."""
    import numpy as np
    import torch

    from paddle_operator_tpu_torch.infer import executor as X
    from paddle_operator_tpu_torch.models.llama import make_model

    params, cfg = make_model("7b", device="cuda", seed=6, n_layers=2,
                             dtype=torch.float32)
    pcfg = dataclasses.replace(cfg, decode_attn="plain")
    rng = np.random.default_rng(6)
    prompts = [rng.integers(0, cfg.vocab_size, n).tolist() for n in (40, 57)]
    rings = (("paged", {"paged": True, "block_size": 16}, 1),
             ("paged", {"paged": True, "block_size": 16}, 4),
             ("int8", {"paged": True, "block_size": 16, "kv_quant": "int8"},
              1))
    with torch.inference_mode():
        for name, ring, megastep in rings:
            def executor(c):
                return X.RingExecutor(params, c, slots=2, max_len=256,
                                      chunk_tokens=8, megastep=megastep,
                                      **ring)

            spill_at = 1 if megastep > 1 else 2
            ref_ex = executor(cfg)
            ref_ex.prewarm()
            want, _ = _restore_run(ref_ex, prompts, megastep, True)
            del ref_ex
            ex = executor(cfg)
            ex.prewarm()
            replays0 = ex.graph_replays
            got, seen = _restore_run(ex, prompts, megastep, True, spill_at)
            replays = ex.graph_replays - replays0
            del ex
            plain, _ = _restore_run(executor(pcfg), prompts, megastep,
                                    False, spill_at)
            line = (f"restore under graphs, {name} ring megastep {megastep} "
                    f"(7b width, 2 layers, f32, bs 16): spilled at pos "
                    f"{len(prompts[0]) + spill_at * megastep * 8}, restored "
                    f"into slot 1; {len(got)} tokens == uninterrupted: "
                    f"{got == want}, == plain path (eager): {plain == got}; "
                    f"addresses kept {seen['ptrs'] == seen['ptrs_after']}, "
                    f"no recapture {seen['graphs'] is seen['graphs_after']}; "
                    f"{replays} replays, paged kernel launches after the "
                    f"restore {seen['launches']}")
            log(line)
            if (got != want or plain != got
                    or seen["ptrs"] != seen["ptrs_after"]
                    or seen["graphs"] is not seen["graphs_after"]
                    or not seen["launches"]):
                raise AssertionError(line)
    del params
    torch.cuda.empty_cache()


def phase_train_kernel_equals_plain() -> None:
    """Phase 4c: three f32 train steps through the flash kernels and
    through the plain attention, from the same init."""
    from unittest import mock

    import numpy as np
    import torch

    from paddle_operator_tpu_torch.models import llama as LM
    from paddle_operator_tpu_torch.ops import flash_attention as FA
    from paddle_operator_tpu_torch.ops.attention import reference_attention
    from paddle_operator_tpu_torch.train import trainer as T
    from paddle_operator_tpu_torch.train.data import deterministic_lm_batches

    model, cfg = LM.make_model("7b", device="cuda", seed=2, n_layers=2,
                               dtype=torch.float32)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    data = deterministic_lm_batches(2, 513, cfg.vocab_size, seed=4)
    batches = [{k: torch.as_tensor(v, device="cuda") for k, v in b.items()}
               for _, b in zip(range(3), data)]

    def run():
        model.load_state_dict(init)
        opt = T.make_optimizer(1e-3, warmup_steps=1, decay_steps=100)
        state = T.create_state(model, opt)
        step = T.make_train_step(opt)
        out = []
        for b in batches:
            state, m = step(state, b)
            out.append((float(m["loss"]), float(m["grad_norm"])))
        return out

    FA.flash_forward.launches = 0
    kern = run()
    launched = FA.flash_forward.launches
    with mock.patch.object(LM, "attention", reference_attention):
        plain = run()
    if not launched or FA.flash_forward.launches != launched:
        raise AssertionError("the kernel run did not launch the flash "
                             "forward, or the plain run did")
    log(f"train kernel path == plain path (7b width, 2 layers, f32, B=2 "
        f"S=512, 3 steps): kernel {kern}, plain {plain}")
    for (lk, gk), (lp, gp) in zip(kern, plain):
        if not (np.isclose(lk, lp, rtol=1e-5, atol=0)
                and np.isclose(gk, gp, rtol=1e-4, atol=0)):
            raise AssertionError(f"train step through the kernels differs "
                                 f"from the plain path: loss {lk} vs {lp}, "
                                 f"grad_norm {gk} vs {gp}")
    del model, init, batches
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + " (default: all; the build always runs)")
    phases = set(ap.parse_args().phases.split(","))
    if phases - set(PHASES):
        ap.error(f"unknown phases {sorted(phases - set(PHASES))}")
    if "3e" in phases:
        phases.add("3b")            # 3e is held against 3b's tokens
    if not (ROOT / "paddle_operator_tpu_torch" / "csrc").is_dir():
        print("chip_smoke.py: the paddle_operator_tpu_torch package is not "
              "beside this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA card (torch.cuda.is_available() is "
              "false)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on "
        f"{torch.cuda.get_device_name(0)}; tf32 off")

    from paddle_operator_tpu_torch.ops import _build

    t_all = t0 = time.perf_counter()
    secs = _build.build(KERNELS)
    log(f"build: {json.dumps(secs)} ({time.perf_counter() - t0:.1f}s "
        "wall, parallel)")

    source = "paddle_operator_tpu_torch/csrc/decode_attention.cu"
    contiguous = {"name": "decode_attention", "route": "cuda",
                  "source": source,
                  "replaces": "paddle_operator_tpu/ops/decode_attention.py"
                              ":148"}
    paged = {"name": "paged_decode_attention", "route": "cuda",
             "source": source,
             "replaces": "paddle_operator_tpu/ops/decode_attention.py:281"}
    quant = {"name": "paged_decode_attention_quant", "route": "cuda",
             "source": source,
             "replaces": "paddle_operator_tpu/ops/decode_attention.py:294"}
    flash = {kern: {"name": kern, "route": "cuda",
                    "source": "paddle_operator_tpu_torch/csrc/"
                              "flash_attention.cu",
                    "replaces": "paddle_operator_tpu/ops/pallas_attention.py"
                                f":{line}"}
             for kern, line in zip(FLASH_KERNELS, (86, 224, 276))}

    def run(phase, fn, *args):
        if phase in phases:
            t = time.perf_counter()
            out = fn(*args)
            log(f"phase {phase}: {time.perf_counter() - t:.1f}s")
            return out
        return None

    flash_build_report(flash)
    decode_build_report(contiguous, paged, quant)
    log(f"build: flash_attention.cu {secs['flash_attention']:.1f}s")
    run("2", phase_kernel_vs_plain, contiguous)
    run("2b", phase_paged_kernel_vs_plain, paged)
    run("2d", phase_quant_kernel_vs_plain, quant)
    run("2c", phase_flash_vs_plain, flash)
    if phases & {"3", "3b", "3d", "3e", "3g"}:
        params, cfg = make_7b()
        run("3", phase_main_path, contiguous, params, cfg)
        ring_tokens = run("3b", phase_ring_main_path, paged, params, cfg)
        gc.collect()        # the servers' reference cycles hold the caches
        torch.cuda.empty_cache()
        run("3d", phase_ring_main_path, quant, params, cfg, "int8",
            paged.get("ring"))
        gc.collect()
        torch.cuda.empty_cache()
        run("3e", phase_ring_main_path, paged, params, cfg, "none",
            paged.get("ring"), 4, ring_tokens)
        gc.collect()
        torch.cuda.empty_cache()
        run("3g", phase_preemption, (paged, quant), params, cfg)
        del params
        gc.collect()
        torch.cuda.empty_cache()
    run("3c", phase_train_main_path, flash)
    run("3f", phase_checkpoint, flash)
    run("4", phase_kernel_path_equals_plain)
    run("4b", phase_rings_equal_generate)
    run("4c", phase_train_kernel_equals_plain)
    run("4d", phase_quant_ring_kernel_equals_plain)
    run("4e", phase_megastep_rings)
    run("4f", phase_restore_under_graphs)
    log(f"all phases: {time.perf_counter() - t_all:.1f}s")

    order = ["name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "max_abs_err_f32", "max_abs_err_bf16",
             "decode_ms_per_step_b4", "kernel1_ms", "paged_bf16_ms", "ring",
             "ring_megastep", "preempt", "train", "checkpoint", "fwd_bwd", "designs",
             "ptxas",
             "timings"]
    print(json.dumps({"kernels": [
        {k: r.get(k) for k in order if k in r or k in order[:11]}
        for r in (contiguous, paged, quant, *flash.values())]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
