"""Generation server — the port of ``paddle_operator_tpu/infer/
serve.py``.

Serves JSON over stdlib HTTP with the JAX server's surface:

    POST /v1/generate
      {"tokens": [[...], ...], "max_new_tokens": N,
       "temperature": 0.7, "top_k": 40, "top_p": 0.9, "eos_token": 2,
       "seed": 0, "request_id": "...", "stream": false,
       "deadline_s": 2.0, "priority": 0}
    -> {"tokens": [[...], ...]}   (prompt + continuation per row)
    GET /healthz /readyz /statusz /metrics /debug/flightrec

Two modes, as in the JAX package:

- **batch mode** (:class:`Generator`): each request's whole batch runs
  through :func:`infer.decode.generate` under one lock.
- **continuous mode** (``make_server(..., continuous=True)``,
  ``SERVE_CONTINUOUS=1``): rows become independent requests on the
  decode ring (infer/scheduler.py) — staggered concurrent requests
  decode side by side, lanes recycle on eos/budget.  With
  ``SERVE_PAGED=1`` the ring's KV lives in the block pool with radix
  prefix reuse (infer/paged.py), the configuration the operator
  deploys on every fleet replica; ``SERVE_KV_QUANT=int8`` stores that
  pool as int8 codes + per-block scales (and implies SERVE_PAGED=1).
  Streaming (``"stream": true``),
  deadlines (``X-Request-Deadline``/``deadline_s``, 504 partials),
  priorities (``X-Request-Priority``/``priority``; on the paged ring a
  more urgent request preempts a less urgent lane, SERVE_PREEMPT) and
  the ring's ``/statusz``, ``/metrics`` and ``/debug/flightrec`` are
  served.

Greedy output equals the JAX server's token for token.  Sampled tokens
differ from the JAX server's for the same seed (``jax.random`` is not
reproduced; infer/executor.py ``_sample_tokens`` has the rule).
``/v1/swap``, ``/v1/kv/*`` and ``POST /v1/adapters`` answer as the JAX
server does when those features are not configured.

The entry point restores the parameters from the operator's
``TPUJOB_CHECKPOINT_PATH`` (:func:`load_serving_params`).  Run on the
card::

    SERVE_CONTINUOUS=1 SERVE_PAGED=1 MODEL_PRESET=7b TPUJOB_PORT=8999 \\
    python3 -m paddle_operator_tpu_torch.infer.serve
"""

from __future__ import annotations

import dataclasses
import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple

import numpy as np
import torch

from paddle_operator_tpu_torch.infer import decode as D
from paddle_operator_tpu_torch.infer.resilience import (
    RetriableError,
    ServerState,
    ShuttingDown,
)
from paddle_operator_tpu_torch.models.llama import Llama, LlamaConfig
from paddle_operator_tpu_torch.utils.tracing import safe_header_value

class Generator:
    """Lock-serialized wrapper around decode.generate: one request's
    batch at a time on the params' device, under inference mode."""

    def __init__(self, params: Llama, cfg: LlamaConfig, mesh=None) -> None:
        D._refuse_mesh(mesh)
        self.params = params
        self.cfg = cfg
        self.device = params.tok_embed.embedding.device
        self._lock = threading.Lock()

    def __call__(self, tokens: np.ndarray, *, max_new_tokens: int,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 eos_token: Optional[int] = None,
                 seed: int = 0) -> np.ndarray:
        tokens = np.asarray(tokens, np.int32)
        # an out-of-range id would be a device-side assert on the card
        # (the JAX gather clamps instead): refuse it as a bad request
        if tokens.size and (tokens.min() < 0
                            or tokens.max() >= self.cfg.vocab_size):
            raise ValueError(f"token ids must lie in [0, "
                             f"{self.cfg.vocab_size})")
        with self._lock, torch.inference_mode():
            prompt = torch.as_tensor(tokens, device=self.device)
            gen = None
            if temperature > 0:
                gen = torch.Generator(device=self.device)
                gen.manual_seed(seed)
            out = D.generate(self.params, self.cfg, prompt,
                             max_new_tokens=max_new_tokens,
                             temperature=temperature, top_k=top_k,
                             top_p=top_p, eos_token=eos_token,
                             generator=gen)
            return out.cpu().numpy()


class ContinuousGenerator:
    """The decode ring behind the Generator call surface: rows of one
    HTTP request become independent ring requests (they may land in
    different decode waves), and the call blocks until all rows finish.
    Concurrent HTTP threads interleave in the ring — that is the
    point."""

    def __init__(self, params: Llama, cfg: LlamaConfig, **ring_kw) -> None:
        from paddle_operator_tpu_torch.infer.batcher import (
            ContinuousBatcher,
        )

        self.batcher = ContinuousBatcher(params, cfg, **ring_kw)
        self.cfg = cfg

    def __call__(self, tokens: np.ndarray, *, max_new_tokens: int,
                 temperature: float = 0.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 eos_token: Optional[int] = None,
                 seed: int = 0) -> list:
        rows, _ = self.generate_rows(
            tokens, max_new_tokens=max_new_tokens, temperature=temperature,
            top_k=top_k, top_p=top_p, eos_token=eos_token, seed=seed)
        return rows

    def generate_rows(self, tokens, *, max_new_tokens: int,
                      temperature: float = 0.0,
                      top_k: Optional[int] = None,
                      top_p: Optional[float] = None,
                      eos_token: Optional[int] = None, seed: int = 0,
                      request_id: Optional[str] = None,
                      deadline_s: Optional[float] = None,
                      priority: Optional[int] = None,
                      adapter: Optional[str] = None):
        """Rows + per-row deadline-exceeded flags (a flagged row carries
        the PARTIAL tokens produced before its budget ran out).
        ``request_id`` is threaded into ``submit`` per row so capacity
        rejections name the offender."""
        if (top_k, top_p) != (self.batcher._top_k, self.batcher._top_p) \
                and (top_k is not None or top_p is not None):
            raise ValueError(
                "top_k/top_p are fixed per continuous server "
                f"(configured: top_k={self.batcher._top_k} "
                f"top_p={self.batcher._top_p})")
        reqs = []
        try:
            for i, row in enumerate(tokens):
                rid_row = (f"{request_id}/row{i}"
                           if request_id is not None else None)
                reqs.append(self.batcher.submit(
                    row, max_new_tokens=max_new_tokens,
                    temperature=temperature, seed=seed + i,
                    eos_token=eos_token, deadline_s=deadline_s,
                    priority=priority, adapter=adapter,
                    request_id=rid_row))
            # ragged rows: sequences stop at eos, no rectangular array
            rows = [r.result(timeout=600) for r in reqs]
        except Exception:
            # a later row's submit rejected or a result timed out: the
            # already-submitted rows have no consumer — cancel them
            # rather than decode them to their full budgets
            for r in reqs:
                r.cancel()
            raise
        return rows, [r.deadline_exceeded for r in reqs]

    def close(self) -> None:
        self.batcher.close()


class _Handler(BaseHTTPRequestHandler):
    generator = None      # injected: Generator or ContinuousGenerator
    state = None          # injected resilience.ServerState
    # fleet identity (make_server job=/replica=): labels /metrics
    job_key = "local"
    replica_id = ""
    # chunked transfer (the streaming path) requires HTTP/1.1; plain
    # responses carry Content-Length so keep-alive stays correct
    protocol_version = "HTTP/1.1"
    timeout = 120

    def log_message(self, *a):
        pass

    def _send(self, code: int, obj, headers=None) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)

    def _retry_hdr(self) -> dict:
        return {"Retry-After": self.state.retry_after_s if self.state
                else 5}

    def _batcher(self):
        return getattr(self.generator, "batcher", None)

    def do_GET(self):
        # /healthz: should this pod be REPLACED (the ring died for
        # good); /readyz: should it take TRAFFIC (false while draining
        # or mid-self-heal)
        b = self._batcher()
        if self.path == "/healthz":
            if b is not None and not b.healthy:
                self._send(503, {"ok": False, "reason": "ring dead"})
            else:
                self._send(200, {"ok": True})
        elif self.path == "/readyz":
            draining = bool(self.state and self.state.draining)
            if not draining and (b is None or b.accepting):
                self._send(200, {"ready": True})
            else:
                self._send(503, {"ready": False,
                                 "reason": ("draining" if draining
                                            else "ring")},
                           headers=self._retry_hdr())
        elif self.path == "/v1/adapters":
            self._send(200, {"adapters": [], "capacity": 0})
        elif self.path == "/statusz":
            # the ring's serving_status block (batch mode publishes none)
            st = b.serving_status() if b is not None else {}
            if self.replica_id:
                st["replica"] = self.replica_id
            self._send(200, st)
        elif self.path == "/metrics":
            from paddle_operator_tpu_torch.utils.observability import (
                histogram_exposition,
                serving_gauges,
            )

            st = b.serving_status() if b is not None else {}
            gauges = serving_gauges(st, self.job_key,
                                    replica=self.replica_id or None)
            text = "".join(f"{k} {v}\n" for k, v in sorted(gauges.items()))
            text += histogram_exposition(st.get("latencyHist"),
                                         self.job_key,
                                         self.replica_id or None)
            body = text.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path == "/debug/flightrec":
            fr = getattr(b, "flightrec", None) if b is not None else None
            self._send(200, fr.dump("debug_endpoint") if fr is not None
                       else {"events": []})
        else:
            self._send(404, {})

    def _stream_generate(self, req, id_hdrs=None) -> None:
        """``"stream": true`` (continuous mode, single row): emit
        newline-delimited JSON events as the ring produces tokens —
        {"token": t} per generated token, then {"done": true, "tokens":
        [full sequence]} — over chunked transfer, in chunk-sized
        bursts."""
        gen = self.generator
        if not isinstance(gen, ContinuousGenerator):
            raise ValueError("streaming requires the continuous server "
                             "(SERVE_CONTINUOUS=1)")
        if ((req.get("top_k"), req.get("top_p"))
                != (gen.batcher._top_k, gen.batcher._top_p)
                and (req.get("top_k") is not None
                     or req.get("top_p") is not None)):
            raise ValueError(
                "top_k/top_p are fixed per continuous server "
                f"(configured: top_k={gen.batcher._top_k} "
                f"top_p={gen.batcher._top_p})")
        tokens = np.asarray(req["tokens"], np.int32)
        if tokens.ndim != 2 or tokens.shape[0] != 1:
            raise ValueError("streaming takes tokens [1, seq]")
        prio = req.get("priority")
        handle = gen.batcher.submit(
            tokens[0], max_new_tokens=int(req.get("max_new_tokens", 32)),
            temperature=float(req.get("temperature", 0.0)),
            seed=int(req.get("seed", 0)), eos_token=req.get("eos_token"),
            stream=True, request_id=req.get("request_id"),
            deadline_s=req.get("deadline_s"),
            priority=int(prio) if prio is not None else None,
            adapter=req.get("adapter"))

        def emit(obj) -> None:
            body = json.dumps(obj).encode() + b"\n"
            self.wfile.write(f"{len(body):x}\r\n".encode() + body
                             + b"\r\n")
            self.wfile.flush()

        # everything from the first socket write onward sits inside the
        # try: a disconnect must still reach the finally's cancel, or
        # the abandoned request holds its lane to the full budget
        try:
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            for k, v in (id_hdrs or {}).items():
                self.send_header(k, str(v))
            self.end_headers()
            for tok in handle.stream(timeout=600):
                emit({"token": tok})
            done_ev = {"done": True, "tokens": handle.result(timeout=5)}
            if handle.deadline_exceeded:         # 504-style partial
                done_ev["deadline_exceeded"] = True
            emit(done_ev)
            self.wfile.write(b"0\r\n\r\n")
        except OSError:
            return   # client disconnected mid-stream: nothing to say
        except Exception as e:
            try:
                emit({"error": str(e)})
                self.wfile.write(b"0\r\n\r\n")
            except OSError:
                pass
        finally:
            handle.cancel()     # a no-op once the generation finished

    def do_POST(self):
        # drain the body before ANY response: under HTTP/1.1 keep-alive
        # an unread body would be parsed as the next request's start line
        n = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(n) if n else b""
        continuous = isinstance(self.generator, ContinuousGenerator)
        # the routes of features this port does not carry, answered as
        # the JAX server answers them when the feature is not configured
        if self.path == "/v1/kv/restore":
            self._send(400, {"error": (
                "lane adoption (fleet-level KV) is not ported to the "
                "torch package yet (ROADMAP.md Queue A)" if continuous
                else "lane adoption requires the continuous server")})
            return
        if self.path == "/v1/kv/prefix":
            self.send_response(204)
            self.send_header("Content-Length", "0")
            self.end_headers()
            return
        if self.path == "/v1/adapters":
            self._send(400, {"error": "no adapter registry (set "
                                      "SERVE_ADAPTERS to enable)"})
            return
        if self.path == "/v1/swap":
            self._send(400, {"error": (
                "live weight swap is not ported to the torch package yet "
                "(ROADMAP.md Queue A)" if continuous
                else "live swap requires the continuous ring "
                     "(SERVE_CONTINUOUS=1)")})
            return
        if self.path != "/v1/generate":
            self._send(404, {})
            return
        if self.state is not None and self.state.draining:
            # SIGTERM drain: admissions stop FIRST
            self._send(503, {"error": "server draining"},
                       headers=self._retry_hdr())
            return
        try:
            req = json.loads(body)
            # per-request deadline: the X-Request-Deadline header or the
            # body's deadline_s (body wins); an expired request resolves
            # with the tokens produced so far and a 504-style marker
            deadline_s = req.get("deadline_s")
            hdr = self.headers.get("X-Request-Deadline")
            if deadline_s is None and hdr is not None:
                deadline_s = float(hdr)
            # QoS class: X-Request-Priority or the body's priority (body
            # wins); 0 is the most urgent class
            priority = req.get("priority")
            phdr = self.headers.get("X-Request-Priority")
            if priority is None and phdr is not None:
                priority = int(phdr)
            id_hdrs = {}
            if req.get("request_id") is not None:
                id_hdrs["X-Request-Id"] = safe_header_value(
                    req.get("request_id"))
            if self.replica_id:
                id_hdrs["X-Tpujob-Replica"] = self.replica_id
            if req.get("stream"):
                if deadline_s is not None:
                    req["deadline_s"] = float(deadline_s)
                if priority is not None:
                    req["priority"] = int(priority)
                return self._stream_generate(req, id_hdrs=id_hdrs)
            tokens = np.asarray(req["tokens"], np.int32)
            if tokens.ndim != 2:
                raise ValueError("tokens must be [batch, seq]")
            opts = dict(
                max_new_tokens=int(req.get("max_new_tokens", 32)),
                temperature=float(req.get("temperature", 0.0)),
                top_k=req.get("top_k"),
                top_p=req.get("top_p"),
                eos_token=req.get("eos_token"),
                seed=int(req.get("seed", 0)))
            gen = self.generator
            if continuous:
                rows, expired = gen.generate_rows(
                    tokens, request_id=req.get("request_id"),
                    deadline_s=(float(deadline_s)
                                if deadline_s is not None else None),
                    priority=(int(priority)
                              if priority is not None else None),
                    adapter=req.get("adapter"), **opts)
                resp = {"tokens": rows}
                if any(expired):
                    # deadline partials: 504 when EVERY row ran out,
                    # 200 with per-row flags on a mixed batch — either
                    # way the partial tokens are delivered
                    resp["deadline_exceeded"] = expired
                    self._send(504 if all(expired) else 200, resp,
                               headers=id_hdrs)
                    return
                self._send(200, resp, headers=id_hdrs)
                return
            out = gen(tokens, **opts)
            self._send(200, {"tokens": out.tolist()}, headers=id_hdrs)
        except (ShuttingDown, RetriableError) as e:
            # the request was fine, the server was not: retry signal
            self._send(503, {"error": str(e)}, headers=self._retry_hdr())
        except (ValueError, KeyError, TypeError,
                json.JSONDecodeError) as e:
            self._send(400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — server-side failure
            # 503 tells clients to retry/fail over, not to blame their
            # request
            self._send(503, {"error": str(e)})


def make_server(host: str, port: int, params: Llama, cfg: LlamaConfig,
                *, continuous: bool = False, mesh=None,
                job: str = "local", replica: str = "",
                **ring_kw) -> ThreadingHTTPServer:
    """A server over ``params`` (the port's Llama, on the device it
    should serve from): batch mode, or with ``continuous=True`` the
    decode ring (``ring_kw``: the ContinuousBatcher arguments — slots,
    chunk_tokens, max_len, paged, block_size, num_blocks, prefix_cache,
    max_queue, qos, resilience, prewarm, ...).  The returned server
    carries ``.generator`` (call its ``close()`` to stop a ring) and
    ``.state`` (the drain flags)."""
    D._refuse_mesh(mesh)
    if continuous:
        gen = ContinuousGenerator(params, cfg, **ring_kw)
    else:
        if ring_kw:
            raise TypeError(f"batch mode takes no ring options "
                            f"({sorted(ring_kw)})")
        gen = Generator(params, cfg)
    state = ServerState()
    handler = type("Handler", (_Handler,),
                   {"generator": gen, "state": state,
                    "job_key": job, "replica_id": replica})
    srv = ThreadingHTTPServer((host, port), handler)
    srv.generator = gen
    srv.state = state
    return srv


def refuse_unported(environ) -> None:
    """Raise on every knob this port cannot honour yet — it never
    silently serves something else than what was asked for.  Each
    refused knob is named in the message."""
    refused = []

    def on(key, off=("", "0")):
        return environ.get(key, "").strip() not in off

    if int(environ.get("SERVE_TP", "1") or 1) > 1:
        refused.append(f"SERVE_TP={environ['SERVE_TP']} (tensor "
                       "parallelism)")
    if on("QUANTIZE", ("", "none", "off")):
        refused.append(f"QUANTIZE={environ['QUANTIZE']}")
    if on("SERVE_WEIGHT_QUANT", ("", "none")):
        refused.append(f"SERVE_WEIGHT_QUANT="
                       f"{environ['SERVE_WEIGHT_QUANT']}")
    if int(environ.get("SERVE_SPEC_K", "0") or 0) > 0:
        refused.append(f"SERVE_SPEC_K={environ['SERVE_SPEC_K']} "
                       "(speculative decoding)")
    for key in ("SERVE_HOST_CACHE_BLOCKS", "SERVE_HOST_CACHE_MB"):
        if float(environ.get(key, "0") or 0) > 0:
            refused.append(f"{key}={environ[key]} (the host spill tier)")
    if on("SERVE_PREFILL", ("", "inline")):
        refused.append(f"SERVE_PREFILL={environ['SERVE_PREFILL']} "
                       "(chunked/disaggregated prefill)")
    if on("SERVE_ADAPTERS"):
        refused.append(f"SERVE_ADAPTERS={environ['SERVE_ADAPTERS']} "
                       "(LoRA adapters)")
    if environ.get("SERVE_TRACE", "0") == "1":
        refused.append("SERVE_TRACE=1 (span tracing)")
    if environ.get("SERVE_NAN_CHECK", "0") == "1":
        refused.append("SERVE_NAN_CHECK=1 (the NaN-lane check)")
    if on("TPUJOB_CHAOS"):
        refused.append(f"TPUJOB_CHAOS={environ['TPUJOB_CHAOS']} "
                       "(fault injection)")
    for key in ("SERVE_KV_MIGRATE", "SERVE_KV_PEER_FETCH"):
        if environ.get(key, "0") == "1":
            refused.append(f"{key}=1 (fleet-level KV)")
    for key in ("SERVE_KV_STORE", "SERVE_KV_BROKER"):
        if on(key):
            refused.append(f"{key}={environ[key]} (fleet-level KV)")
    if refused:
        raise ValueError("not ported to the torch package yet "
                         "(ROADMAP.md Queue A): " + "; ".join(refused))


def ring_kw_from_env(environ) -> dict:
    """The continuous ring's arguments from the ``SERVE_*`` env, as the
    JAX entry point reads them: SERVE_SLOTS, SERVE_CHUNK,
    SERVE_MAX_QUEUE, SERVE_MAX_LEN, SERVE_GENERATION, SERVE_PAGED with
    SERVE_BLOCK_SIZE / SERVE_PREFIX_CACHE / SERVE_NUM_BLOCKS,
    SERVE_KV_QUANT, SERVE_MEGASTEP, SERVE_PRIORITIES, SERVE_PREWARM, the
    preemption knobs (SERVE_PREEMPT, on unless "0", and its budgets
    SERVE_PREEMPT_MAX_PER_REQ / _BUDGET / _WINDOW_S: a waiting request
    of a more urgent class spills the least urgent lane of a full paged
    ring, which resumes later bit-identically) and the watchdog knobs
    (SERVE_WATCHDOG*, SERVE_MAX_RESTARTS, SERVE_RESTART_WINDOW_S).

    SERVE_MEGASTEP=N fuses N ring iterations into one dispatch (one
    CUDA graph replay on the card), with eos / token budget / deadline
    ticks carried on the device: admissions move to megastep
    boundaries, so a queued request may wait up to N iterations for a
    lane.  0 or unset is the single-step default (the CRD's
    ``spec.serving.megastep`` 0 means "server default").

    SERVE_KV_QUANT=int8 (the int8 KV pool: int8 codes + one f32 scale
    per (block, kv head), for deployments bound by capacity rather than
    latency) needs the paged ring — the pool block is the quantization
    unit — so it implies SERVE_PAGED=1, with the other paged knobs
    honoured as under an explicit SERVE_PAGED=1."""
    from paddle_operator_tpu_torch.infer.qos import QoSConfig
    from paddle_operator_tpu_torch.infer.resilience import RingResilience

    kw = {"slots": int(environ.get("SERVE_SLOTS", "8")),
          "chunk_tokens": int(environ.get("SERVE_CHUNK", "8")),
          "max_queue": int(environ.get("SERVE_MAX_QUEUE", "0")),
          # self-healing on by default for deployed rings
          "resilience": RingResilience.from_env(environ),
          "generation": int(environ.get("SERVE_GENERATION", "0") or 0),
          "prewarm": environ.get("SERVE_PREWARM", "1") == "1",
          "qos": QoSConfig.from_env(environ)}
    if environ.get("SERVE_MAX_LEN"):
        kw["max_len"] = int(environ["SERVE_MAX_LEN"])
    megastep = int(environ.get("SERVE_MEGASTEP", "0") or 0)
    if megastep > 1:
        kw["megastep"] = megastep
    kvq = environ.get("SERVE_KV_QUANT", "none") or "none"
    if kvq != "none":
        kw["kv_quant"] = kvq
        if environ.get("SERVE_PAGED", "0") != "1":
            print("SERVE_KV_QUANT implies SERVE_PAGED=1 (the pool block "
                  "is the quantization unit)", flush=True)
    if environ.get("SERVE_PAGED", "0") == "1" or kvq != "none":
        kw["paged"] = True
        kw["block_size"] = int(environ.get("SERVE_BLOCK_SIZE", "256"))
        kw["prefix_cache"] = environ.get("SERVE_PREFIX_CACHE", "1") == "1"
        if environ.get("SERVE_NUM_BLOCKS"):
            kw["num_blocks"] = int(environ["SERVE_NUM_BLOCKS"])
    return kw


def load_serving_params(path: str, cfg: LlamaConfig, device="cuda"
                        ) -> Tuple[Llama, LlamaConfig, bool]:
    """The parameters to serve, in the serving dtype ``cfg.dtype`` on
    ``device``: the newest committed step under ``path``
    (train/checkpoint.py; a newest step that fails to load is passed
    over with a logged warning), else — no path, or no step yet — a
    fresh init from seed 0.  Returns ``(model, its config, resumed)``.

    Only the checkpoint's parameter file is read, and each float tensor
    is cast to ``cfg.dtype`` as it is copied into a model built in that
    dtype — the JAX package's ``serving_params`` cast.  So the device
    holds the serving-dtype model alone: no f32 master copy and no
    optimizer state ever reach it."""
    from paddle_operator_tpu_torch.train.checkpoint import (
        CheckpointManager,
        resume_or_init,
    )

    cfg = dataclasses.replace(cfg, param_dtype=cfg.dtype)

    def init() -> Llama:
        gen = torch.Generator(device=device)
        gen.manual_seed(0)
        return Llama(cfg, device).init_weights(gen)

    model, resumed = resume_or_init(CheckpointManager(path), init)
    return model, cfg, resumed


def main() -> int:
    """Serving entrypoint: restore MODEL_PRESET (default 7b) from
    TPUJOB_CHECKPOINT_PATH — fresh init from seed 0 when it holds no
    step — on the card in the serving dtype (``load_serving_params``)
    and serve on TPUJOB_PORT: batch mode, or the decode ring with
    SERVE_CONTINUOUS=1 (paged with SERVE_PAGED=1, over the int8 pool
    with SERVE_KV_QUANT=int8); SIGTERM drains and exits EXIT_PREEMPTED
    (83)."""
    from paddle_operator_tpu_torch.ft.preemption import PreemptionWatcher
    from paddle_operator_tpu_torch.infer.resilience import ServingDrain
    from paddle_operator_tpu_torch.launch.launcher import JobEnv
    from paddle_operator_tpu_torch.models.llama import CONFIGS

    env = JobEnv.from_env()
    refuse_unported(os.environ)
    if not torch.cuda.is_available():
        raise RuntimeError("the torch server runs on a CUDA card and "
                           "found none")
    continuous = os.environ.get("SERVE_CONTINUOUS", "0") == "1"
    ring_kw = ring_kw_from_env(os.environ) if continuous else {}
    preset = os.environ.get("MODEL_PRESET", "7b")
    params, cfg, resumed = load_serving_params(
        env.checkpoint_path, CONFIGS[preset], "cuda")
    mode = "batch"
    if continuous:
        mode = (f"continuous, paged={bool(ring_kw.get('paged'))}, "
                f"kv_quant={ring_kw.get('kv_quant', 'none')}, "
                f"megastep={ring_kw.get('megastep', 1)}, "
                f"slots={ring_kw['slots']}, "
                f"chunk={ring_kw['chunk_tokens']}")
    print(f"serving {preset} (resumed={resumed}, mode={mode}, "
          f"device={torch.cuda.get_device_name(0)}) on :{env.port}",
          flush=True)
    srv = make_server("0.0.0.0", env.port, params, cfg,
                      continuous=continuous,
                      job=os.environ.get("TPUJOB_NAME", "local"),
                      replica=os.environ.get("TPUJOB_REPLICA_ID", ""),
                      **ring_kw)
    batcher = srv.generator.batcher if continuous else None
    watcher = PreemptionWatcher.install()
    ServingDrain(srv, srv.state, batcher=batcher,
                 budget_s=float(os.environ.get("SERVE_DRAIN_BUDGET_S",
                                               "30"))).install(watcher)
    srv.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
