#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero, printing no
result line):

1. build — compile every kernel of the serving path from
   ``paddle_operator_tpu_torch/csrc/`` (one nvcc each, in parallel).
2. kernel vs plain — ``decode_attention`` against
   ``decode_attention_reference`` on the card: ragged lengths with 0, 1,
   a full cache and a non-multiple of any tile; MHA and GQA (n_rep 2, 4);
   D 64 and 128; float32 (atol = rtol = 1e-4) and bfloat16 (atol 2e-2,
   against the plain version run in float32 on the bf16 inputs); the
   main path's shapes; the 7b shape at fills 128 and 2048.  Then the
   kernel, the plain version and ``scaled_dot_product_attention`` (the
   library yardstick, never used by the port) are timed at the 7b shape
   at fills 128, 528 and 2048 — device time from CUDA-graph replay,
   eager time from one-by-one calls — beside the bound.
3. main path — 7b at full width and depth, bf16, fresh init from seed 0:
   the port's batch server answers three ``/v1/generate`` requests over
   real HTTP; the kernel's launch count over exactly that run must equal
   n_layers x decode steps.  Then decode ms/token is timed.
4. kernel path == plain path — 7b width, 2 layers, float32: greedy
   ``generate`` through the kernel and through the plain version give
   the same tokens, and per-step logits agree within 1e-3.
5. report — a ``kernels`` JSON line, the card's name and power limit,
   and as the last line ``{"ok": true, "device": {...}}``.

float32 matrix products run in full float32 (TF32 off) throughout.
"""

from __future__ import annotations

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
KERNELS = ["decode_attention"]


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


def attention_bound_ms(b, hq, hkv, d, fill, dtype) -> tuple:
    """Least time for one decode-attention call: q, the filled K and V
    rows, lengths and the output each moved once, against 4 * fill * D
    operations per (lane, query head) at the dtype's peak."""
    import torch

    e = torch.empty((), dtype=dtype).element_size()
    nbytes = e * (2 * b * hq * d + 2 * b * hkv * fill * d) + 4 * b
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
                              (torch.bfloat16, 2e-2, 0.0)]:
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


def _post(base: str, body: dict) -> tuple:
    req = urllib.request.Request(
        base + "/v1/generate", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=600) as r:
        out = r.status, json.loads(r.read())
    return out + (time.perf_counter() - t0,)


def phase_main_path(report: dict) -> None:
    import numpy as np
    import torch

    from paddle_operator_tpu_torch.infer import decode as D
    from paddle_operator_tpu_torch.infer.serve import make_server
    from paddle_operator_tpu_torch.models.llama import CONFIGS, make_model
    from paddle_operator_tpu_torch.ops import decode_attention as DA

    t0 = time.perf_counter()
    params, cfg = make_model("7b", device="cuda", seed=0,
                             param_dtype=CONFIGS["7b"].dtype)
    torch.cuda.synchronize()
    log(f"main path: 7b init on the card {time.perf_counter() - t0:.1f}s "
        f"({cfg.num_params() / 1e9:.2f}B params, {cfg.dtype}, "
        f"{cfg.n_layers} layers)")
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
        results = [_post(base, r) for r in reqs]
        launches = DA.decode_attention.launches
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
    if launches != want:
        raise AssertionError(f"decode_attention launched {launches} "
                             f"times, expected {want}")
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
    del params, cache
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


def main() -> int:
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

    t0 = time.perf_counter()
    secs = _build.build(KERNELS)
    log(f"build: {json.dumps(secs)} ({time.perf_counter() - t0:.1f}s "
        "wall, parallel)")

    report = {"name": "decode_attention", "route": "cuda",
              "source": "paddle_operator_tpu_torch/csrc/decode_attention.cu",
              "replaces": "paddle_operator_tpu/ops/decode_attention.py:148"}
    phase_kernel_vs_plain(report)
    phase_main_path(report)
    phase_kernel_path_equals_plain()

    order = ["name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms", "max_abs_err_f32", "max_abs_err_bf16",
             "decode_ms_per_step_b4", "timings"]
    print(json.dumps({"kernels": [{k: report[k] for k in order}]}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
