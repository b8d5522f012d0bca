#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py [--phases 2,2b,3,3b,4,4b]

Phases (any failure raises and the script exits non-zero, printing no
result line; with no arguments every phase runs):

1. build — compile every kernel source of the serving paths from
   ``paddle_operator_tpu_torch/csrc/`` (one nvcc each, in parallel).
2. kernel vs plain — ``decode_attention`` against
   ``decode_attention_reference`` on the card: ragged lengths with 0, 1,
   a full cache and a non-multiple of any tile; MHA and GQA (n_rep 2, 4);
   D 64 and 128; float32 (atol = rtol = 1e-4) and bfloat16 (atol 1e-2,
   against the plain version run in float32 on the bf16 inputs); the
   main path's shapes; the 7b shape at fills 128 and 2048.  Then the
   kernel, the plain version and ``scaled_dot_product_attention`` (the
   library yardstick, never used by the port) are timed at the 7b shape
   at fills 128, 528 and 2048 — device time from CUDA-graph replay,
   eager time from one-by-one calls — beside the bound.
2b. paged kernel vs plain — ``paged_decode_attention`` against
   ``paged_decode_attention_reference`` under scrambled block maps:
   ragged lengths {0, 1, full, not a multiple of bs}, bs 16 and 256,
   MHA and GQA (n_rep 2, 4), D 64 and 128, a stacked-layer index, the
   ring's 7b shapes; same tolerances as phase 2.  Then timed at 7b,
   B=8, bs=256, fills 128, 528 and 2048, in turns: the paged kernel,
   its plain version, kernel #1 on the same rows laid out contiguously,
   and ``scaled_dot_product_attention`` on those contiguous rows (the
   same work without the table walk; never used by the port).
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
   prefix hit).  Launches of the paged kernel over exactly that run
   must equal n_layers x chunk_tokens x chunks dispatched, kernel #1
   must not launch, followers prefill only their suffixes, the pool's
   invariant holds and every block ends free or cached.
4. kernel path == plain path — 7b width, 2 layers, float32: greedy
   ``generate`` through the kernel and through the plain version give
   the same tokens, and per-step logits agree within 1e-3.
4b. paged ring == contiguous ring == ``generate`` — 7b width, 2
   layers, float32: four prompts, one a prefix hit, give identical
   greedy tokens through the paged ring (paged kernel), the contiguous
   ring (kernel #1) and ``generate``.
5. report — a ``kernels`` JSON line, the card's name and power limit,
   and as the last line ``{"ok": true, "device": {...}}``.

float32 matrix products run in full float32 (TF32 off) throughout.
"""

from __future__ import annotations

import argparse
import dataclasses
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
# one source file holds both kernels (decode_attention_launch and
# paged_decode_attention_launch)
KERNELS = ["decode_attention"]
# bf16 kernels against their plain version in f32 on the same bf16
# inputs: about 3x the worst error read on the card over every case of
# phases 2 and 2b (1.9e-3 and 3.1e-3 on an H100 80GB HBM3 at 700 W)
BF16_ATOL = 1e-2
PHASES = ("2", "2b", "3", "3b", "4", "4b")


def log(*a) -> None:
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True, timeout=60).stdout.strip().splitlines()
    return out[0].strip()


def time_ms(fn, iters: int, warmup: int = 3) -> tuple:
    """Per-call time of ``fn(i)``: (device ms, eager ms).

    Device ms: ``iters`` calls captured into one CUDA graph, replayed
    between CUDA events — the card's time alone, without the host's
    per-call Python and launch cost.  Eager ms: the same calls issued
    one by one between CUDA events, which includes that host cost
    wherever the host issues slower than the card runs."""
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

    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(iters):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    reps = 3
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    device = start.elapsed_time(end) / (iters * reps)
    del graph
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

    cases = []
    for hq, hkv, d in [(8, 8, 64), (8, 4, 128), (16, 4, 64), (8, 2, 128)]:
        cases.append(("ragged", 4, hq, hkv, d, 517, [0, 1, 517, 300]))
    cases += [
        ("main-path-b4", 4, 32, 32, 128, 2048, [513, 520, 530, 543]),
        ("main-path-b1", 1, 32, 32, 128, 2048, [95]),
        ("7b-fill128", 4, 32, 32, 128, 2048, [128] * 4),
        ("7b-fill2048", 4, 32, 32, 128, 2048, [2048] * 4),
    ]
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for dtype, atol, rtol in [(torch.float32, 1e-4, 1e-4),
                              (torch.bfloat16, BF16_ATOL, 0.0)]:
        for name, b, hq, hkv, d, s, lens in cases:
            q = rand((b, hq, d), dtype)
            k = rand((b, hkv, s, d), dtype)
            v = rand((b, hkv, s, d), dtype)
            L = torch.tensor(lens, dtype=torch.int32, device=dev)
            got = DA.decode_attention(q, k, v, L).float()
            want = DA.decode_attention_reference(q.float(), k.float(),
                                                 v.float(), L)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            lim = float((atol + rtol * want.abs()).min())
            ok = bool(((got - want).abs()
                       <= atol + rtol * want.abs()).all())
            log(f"kernel-vs-plain {name} {str(dtype)[6:]} B={b} Hq={hq} "
                f"Hkv={hkv} D={d} S={s} lens={lens}: max_abs_err={err:.3e}"
                f" (atol {atol}, rtol {rtol})")
            if not ok:
                raise AssertionError(f"decode_attention disagrees with "
                                     f"its plain version: {name} {dtype} "
                                     f"max_abs_err {err} > {lim}")
            worst[dtype] = max(worst[dtype], err)
    report["max_abs_err_f32"] = worst[torch.float32]
    report["max_abs_err_bf16"] = worst[torch.bfloat16]
    report["max_abs_err"] = max(worst.values())

    # timing at the 7b decode shape (bf16, the serving dtype): copies
    # rotate so the filled bytes of consecutive calls exceed the 50 MB
    # L2, as the 32 layers' caches do on the main path
    import torch.nn.functional as F

    b, h, d, s, copies = 4, 32, 128, 2048, 16
    dtype = torch.bfloat16
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
        row = {"fill": fill}
        for key, fn, iters in (("plain_ms", plain, 16), ("ms", kern, 128),
                               ("library_ms", sdpa, 128),
                               ("ms_again", kern, 128),
                               ("plain_ms_again", plain, 16)):
            row[key], row[key.replace("ms", "eager_ms", 1)] = \
                time_ms(fn, iters)
        row["bound_ms"], row["bound_by"] = attention_bound_ms(
            b, h, h, d, fill, dtype)
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
                f"Hq={hq} Hkv={hkv} D={d} bs={bs} M={m} lens={lens} "
                f"layer={layer}: max_abs_err={err:.3e} (atol {atol}, "
                f"rtol {rtol})")
            if not ok:
                raise AssertionError(
                    f"paged_decode_attention disagrees with its plain "
                    f"version: {name} {dtype} max_abs_err {err} > {lim}")
            worst[dtype] = max(worst[dtype], err)
    report["max_abs_err_f32"] = worst[torch.float32]
    report["max_abs_err_bf16"] = worst[torch.bfloat16]
    report["max_abs_err"] = max(worst.values())

    # timing at the ring's 7b shape (bf16, 8 lanes, bs 256, 8 table
    # blocks per lane): the pool is stacked over 8 layers that the calls
    # rotate through, so consecutive calls' filled bytes exceed the
    # 50 MB L2 as the ring's 32 layers do.  Kernel #1 and SDPA read the
    # same rows gathered into a contiguous cache of their own.
    b, h, d, bs, m, layers = 8, 32, 128, 256, 8, 8
    dtype = torch.bfloat16
    n_blocks = b * m + 1
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
        DA.decode_attention.launches = 0
        DA.paged_decode_attention.launches = 0
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


def phase_ring_main_path(report: dict, params, cfg) -> None:
    """The continuous paged server under a concurrent burst; see the
    module docstring (phase 3b)."""
    import numpy as np

    from paddle_operator_tpu_torch.infer.serve import make_server
    from paddle_operator_tpu_torch.ops import decode_attention as DA
    from paddle_operator_tpu_torch.utils.radixkey import prefix_chain_key
    from paddle_operator_tpu_torch.utils.tracing import hist_quantile

    srv = make_server("127.0.0.1", 0, params, cfg, **RING)
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    base = f"http://127.0.0.1:{srv.server_address[1]}"
    batcher = srv.generator.batcher
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
        DA.decode_attention.launches = 0
        DA.paged_decode_attention.launches = 0
        t0 = time.perf_counter()
        threads = [threading.Thread(target=send, args=j) for j in jobs]
        for t in threads:
            t.start()
        # the followers go once the shared prefix is in the radix cache
        # (published at the 512-token prompt's admission), so each one
        # admits through the suffix-only insert
        key, _ = prefix_chain_key(prefix, bs, max_blocks=2)
        while key not in batcher.pool.entries:
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
    finally:
        srv.shutdown()
        srv.server_close()
        th.join(timeout=30)
        srv.generator.close()                # the ring thread has ended
    launches = DA.paged_decode_attention.launches
    contiguous = DA.decode_attention.launches
    if errors:
        raise AssertionError(f"ring requests failed: {errors}")
    stats = {k: batcher.stats[k] - stats0.get(k, 0)
             for k in ("chunks", "prefill_calls", "prefill_tokens",
                       "admitted", "evicted")}
    pool = batcher.pool

    new_tokens = 0
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
        new_tokens += n
    code, body, resub_s = results["resubmit", 0]
    _check_rows(cfg, prefix, body["tokens"][0], 48, "resubmission")
    cold_new = results["cold", 5][1]["tokens"][0][len(prefix):]
    resub_new = body["tokens"][0][len(prefix):]
    same = sum(a == b for a, b in zip(cold_new, resub_new)) / len(cold_new)

    want = cfg.n_layers * chunk * stats["chunks"]
    log(f"ring: paged_decode_attention launches {launches} (n_layers "
        f"{cfg.n_layers} x chunk {chunk} x chunks {stats['chunks']} = "
        f"{want}); decode_attention launches {contiguous}")
    if launches != want or contiguous:
        raise AssertionError(f"paged kernel launched {launches} times, "
                             f"expected {want}; kernel #1 {contiguous} "
                             "times, expected 0")
    # prefill work: every cold prompt whole, each follower its 16-token
    # suffix, the resubmission its last token
    want_tokens = sum(map(len, cold)) + len(streamed) + 4 * 16 + 1
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

    ttft = batcher.hist.ttft
    p50 = hist_quantile(ttft.bounds, ttft.counts, 0.50)
    p95 = hist_quantile(ttft.bounds, ttft.counts, 0.95)
    ring = {
        "burst_s": burst_s, "burst_new_tokens": new_tokens,
        "burst_new_tok_s": new_tokens / burst_s,
        "burst_chunks": burst_chunks,
        "wall_ms_per_chunk": burst_s / burst_chunks * 1e3,
        "ttft_p50_ms": p50, "ttft_p95_ms": p95,
        "resubmit_s": resub_s, "resubmit_token_match_share": same,
        "pool_blocks": pool.num_blocks,
        "pool_gb": batcher.executor.pool_bytes() / 1e9,
    }
    log("ring: " + json.dumps(ring))
    log(f"ring (a smoke reading of one burst, not a benchmark): "
        f"{new_tokens} new tokens in {burst_s:.3f}s "
        f"({ring['burst_new_tok_s']:.1f} new tok/s over the burst), TTFT "
        f"p50 {p50:.1f} ms, p95 {p95:.1f} ms (ring histogram), "
        f"{ring['wall_ms_per_chunk']:.1f} ms wall per chunk; the "
        f"resubmission matches its cold run on {same:.3f} of its new "
        "tokens (not asserted: a prefill and a one-token suffix forward "
        "round differently in bf16)")
    report["launches"] = launches
    report["ring"] = ring


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES)
                    + " (default: all; the build always runs)")
    phases = set(ap.parse_args().phases.split(","))
    if phases - set(PHASES):
        ap.error(f"unknown phases {sorted(phases - set(PHASES))}")
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

    def run(phase, fn, *args):
        if phase in phases:
            t = time.perf_counter()
            fn(*args)
            log(f"phase {phase}: {time.perf_counter() - t:.1f}s")

    run("2", phase_kernel_vs_plain, contiguous)
    run("2b", phase_paged_kernel_vs_plain, paged)
    if phases & {"3", "3b"}:
        params, cfg = make_7b()
        run("3", phase_main_path, contiguous, params, cfg)
        run("3b", phase_ring_main_path, paged, params, cfg)
        del params
        torch.cuda.empty_cache()
    run("4", phase_kernel_path_equals_plain)
    run("4b", phase_rings_equal_generate)
    log(f"all phases: {time.perf_counter() - t_all:.1f}s")

    order = ["name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "max_abs_err_f32", "max_abs_err_bf16",
             "decode_ms_per_step_b4", "kernel1_ms", "ring", "timings"]
    print(json.dumps({"kernels": [
        {k: r.get(k) for k in order if k in r or k in order[:11]}
        for r in (contiguous, paged)]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
