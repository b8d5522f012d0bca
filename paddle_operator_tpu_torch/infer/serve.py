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
  pool as int8 codes + per-block scales (and implies SERVE_PAGED=1);
  ``SERVE_HOST_CACHE_MB`` adds the host spill tier behind the radix
  cache and ``SERVE_KV_STORE=dir:/path`` the durable prefix store below
  it (:func:`wire_kv_store_from_env`).  With ``SERVE_SPEC_K=K`` the
  ring decodes SPECULATIVELY (infer/speculative.py): a draft model
  (``SERVE_DRAFT``: "auto" derives ``cfg.draft()``, or a preset name;
  its weights from ``TPUJOB_DRAFT_CHECKPOINT_PATH``, quantized under
  ``SERVE_DRAFT_QUANT``; :func:`spec_kw_from_env`) proposes K tokens a
  round, the target verifies them in one forward, and every response
  carries the per-row ``accept_rate``.
  Streaming (``"stream": true``),
  deadlines (``X-Request-Deadline``/``deadline_s``, 504 partials),
  priorities (``X-Request-Priority``/``priority``; on the paged ring a
  more urgent request preempts a less urgent lane, SERVE_PREEMPT) and
  the ring's ``/statusz``, ``/metrics`` and ``/debug/flightrec`` are
  served.  ``SERVE_ADAPTERS`` serves many LoRA adapters off the one base
  model (infer/qos.py ``AdapterRegistry``; ``SERVE_ADAPTER_RANK``,
  ``SERVE_MAX_ADAPTERS``): a request's ``"adapter"`` selects one, and
  ``GET``/``POST /v1/adapters`` list, load and evict them at runtime.

Ring operations, as the JAX server has them: ``POST /v1/swap`` flips
new weights into the running paged ring (:meth:`_Handler._swap`; a
checkpoint, or the base retained under ``SERVE_SWAP_RETAIN``, loaded,
quantized and uploaded on the handler's thread, off the ring's);
``SERVE_TRACE=1`` gives every response a span tree under its
``X-Tpujob-Trace`` context (``"trace"`` in batch responses and in a
stream's done event), which the fleet router stitches;
``SERVE_NAN_CHECK=1`` fails a lane whose logits go non-finite alone
(503, retriable); ``TPUJOB_CHAOS`` injects the deterministic faults of
infer/chaos.py into the live ring.

Greedy output equals the JAX server's token for token.  Sampled tokens
differ from the JAX server's for the same seed (``jax.random`` is not
reproduced; infer/executor.py ``_sample_tokens`` has the rule).
``/v1/kv/*`` answer as the JAX server does when fleet-level KV is not
configured; so does ``/v1/adapters`` on a server without a registry.
The batch server ignores a request's ``"adapter"``, as the JAX batch
server does.

The entry point restores the parameters from the operator's
``TPUJOB_CHECKPOINT_PATH`` (:func:`load_serving_params`) and quantizes
their projections under ``SERVE_WEIGHT_QUANT=int8|int4`` or the legacy
``QUANTIZE=int8`` (:func:`quantize_from_env`, infer/quant.py), in either
mode.  Run on the card::

    SERVE_CONTINUOUS=1 SERVE_PAGED=1 MODEL_PRESET=7b TPUJOB_PORT=8999 \\
    python3 -m paddle_operator_tpu_torch.infer.serve
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import threading
import time
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
from paddle_operator_tpu_torch.utils import tracing as TR

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
        return self.generate_rows(
            tokens, max_new_tokens=max_new_tokens, temperature=temperature,
            top_k=top_k, top_p=top_p, eos_token=eos_token, seed=seed)[0]

    def generate_rows(self, tokens, *, max_new_tokens: int,
                      temperature: float = 0.0,
                      top_k: Optional[int] = None,
                      top_p: Optional[float] = None,
                      eos_token: Optional[int] = None, seed: int = 0,
                      request_id: Optional[str] = None,
                      deadline_s: Optional[float] = None,
                      priority: Optional[int] = None,
                      adapter: Optional[str] = None,
                      trace_ctx=None):
        """Rows + per-row speculative accept rates (None entries when
        the ring is not speculative) + per-row deadline-exceeded flags
        (a flagged row carries the PARTIAL tokens produced before its
        budget ran out) + per-row span trees (None entries when the ring
        does not trace).
        ``request_id`` is threaded into ``submit`` per row so capacity
        rejections name the offender; ``trace_ctx`` is the parsed
        ``X-Tpujob-Trace`` context every row traces under."""
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
                    request_id=rid_row, trace_ctx=trace_ctx))
            # ragged rows: sequences stop at eos, no rectangular array
            rows = [r.result(timeout=600) for r in reqs]
        except Exception:
            # a later row's submit rejected or a result timed out: the
            # already-submitted rows have no consumer — cancel them
            # rather than decode them to their full budgets
            for r in reqs:
                r.cancel()
            raise
        return (rows, [r.accept_rate for r in reqs],
                [r.deadline_exceeded for r in reqs],
                [r.trace for r in reqs])

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
            # the loaded set and the pool's capacity/rank contract
            reg = getattr(b, "adapters", None) if b is not None else None
            if reg is None:
                self._send(200, {"adapters": [], "capacity": 0})
            else:
                self._send(200, {"adapters": reg.names(),
                                 "capacity": reg.capacity,
                                 "rank": reg.rank})
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

    def _stream_generate(self, req, trace_ctx=None, id_hdrs=None) -> None:
        """``"stream": true`` (continuous mode, single row): emit
        newline-delimited JSON events as the ring produces tokens —
        {"token": t} per generated token, then {"done": true, "tokens":
        [full sequence]} (with ``"trace"`` on a tracing ring) — over
        chunked transfer, in chunk-sized bursts."""
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
            adapter=req.get("adapter"), trace_ctx=trace_ctx)

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
            if handle.accept_rate is not None:   # speculative ring
                done_ev["accept_rate"] = handle.accept_rate
            if handle.deadline_exceeded:         # 504-style partial
                done_ev["deadline_exceeded"] = True
            if handle.trace is not None:
                done_ev["trace"] = handle.trace.to_wire()
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

    def _adapters_admin(self, body: bytes) -> None:
        """POST /v1/adapters — runtime load/evict:
        ``{"load": {"name": ..., "path"?: ..., "seed"?: ...}}`` installs
        (path: .npz deltas; seed or neither: the deterministic random
        smoke adapter), ``{"evict": "name"}`` removes — 409 while a
        resident, parked or queued lane still uses it, 400 for anything
        else that fails."""
        from paddle_operator_tpu_torch.infer.qos import (
            AdapterInUse,
            load_adapter_file,
        )

        b = self._batcher()
        reg = getattr(b, "adapters", None) if b is not None else None
        if reg is None:
            self._send(400, {"error": "no adapter registry (set "
                                      "SERVE_ADAPTERS to enable)"})
            return

        def lanes_in_use():
            # resident + parked + QUEUED: a queued request resolved its
            # adapter slot at submit, and evicting or replacing it (or a
            # later load reusing the slot) would serve it another
            # tenant's deltas
            in_use = {r.adapter_idx for r in list(b.lane) if r is not None}
            in_use |= {pk.req.adapter_idx for pk in list(b._parked)}
            in_use |= {r.adapter_idx for r in b._pending.items()}
            return in_use

        try:
            req = json.loads(body)
            if "load" in req:
                spec = req["load"]
                name = spec["name"]
                if spec.get("path"):
                    deltas = load_adapter_file(b.cfg, spec["path"],
                                               reg.rank)
                    idx = reg.load(name, deltas, in_use=lanes_in_use())
                else:
                    idx = reg.load(name, seed=spec.get("seed"),
                                   in_use=lanes_in_use())
                self._send(200, {"loaded": name, "slot": idx})
            elif "evict" in req:
                reg.evict(req["evict"], in_use=lanes_in_use())
                self._send(200, {"evicted": req["evict"]})
            else:
                raise ValueError("body must carry 'load' or 'evict'")
        except AdapterInUse as e:
            self._send(409, {"error": str(e)})
        except (ValueError, KeyError, TypeError,
                json.JSONDecodeError) as e:
            self._send(400, {"error": str(e)})
        except OSError as e:
            self._send(400, {"error": f"adapter file: {e}"})

    def _swap(self, body: bytes) -> None:
        """POST /v1/swap — the live weight swap, with the JAX server's
        body and codes.  Body (every key optional): ``checkpoint`` (a
        training checkpoint directory; omitted: the retained base,
        ``SERVE_SWAP_RETAIN``), ``draft_checkpoint`` (speculative rings),
        ``weight_quant`` / ``draft_quant`` (none|int8|int4; omitted: the
        base's mode), ``generation`` (omitted: bump by one), ``tp``
        (only 1: a resize is refused), ``timeout_s``.  The load, the
        quantization and the upload to the card (on a stream of its
        own) run on THIS thread while the old weights keep serving; only
        the park, flip, capture and restore run on the ring.  200 + the
        summary; 400 a bad body or nothing to swap to; 409 a swap
        already in flight; 503 + Retry-After when the ring cannot swap
        now (draining, rebuilding, no boundary reached)."""
        b = self._batcher()
        if b is None:
            self._send(400, {"error": "live swap requires the "
                             "continuous ring (SERVE_CONTINUOUS=1)"})
            return
        try:
            req = json.loads(body) if body else {}
            base = getattr(self.server, "swap_base", None)
            cfg = self.generator.cfg
            tp = req.get("tp")
            if tp is not None and int(tp) != b.serving_tp():
                raise NotImplementedError(
                    f"a swap to tp={tp}: tensor-parallel serving is not "
                    "ported to the torch package yet (ROADMAP.md Queue A)")
            wq = req.get("weight_quant")
            if wq is None:
                wq = (base or {}).get("weight_quant", "none")
            t0 = time.perf_counter()
            ckpt = req.get("checkpoint")
            if ckpt:
                params = _load_swap_checkpoint(ckpt, cfg, b.device,
                                               wq or "none")
            elif base is not None:
                params = model_from_state(base["params"], cfg, b.device,
                                          wq or "none",
                                          base.get("legacy_quant", False))
            else:
                raise ValueError(
                    "no 'checkpoint' given and no retained base "
                    "(SERVE_SWAP_RETAIN=0) — nothing to swap to")
            dparams = None
            if b.spec_k > 0:
                dwq = req.get("draft_quant")
                if dwq is None:
                    dwq = (base or {}).get("draft_quant", "none")
                dck = req.get("draft_checkpoint")
                if dck:
                    dparams = _load_swap_checkpoint(dck, b.draft_cfg,
                                                    b.device, dwq or "none")
                elif base is not None \
                        and base.get("draft_params") is not None:
                    dparams = model_from_state(base["draft_params"],
                                               b.draft_cfg, b.device,
                                               dwq or "none")
                else:
                    raise ValueError(
                        "speculative ring: a swap needs "
                        "'draft_checkpoint' or a retained draft base")
            upload_s = time.perf_counter() - t0
            kw = {}
            if req.get("generation") is not None:
                kw["generation"] = int(req["generation"])
            res = b.swap_weights(
                params, draft_params=dparams,
                timeout=float(req.get("timeout_s", 120.0)), **kw)
            b.last_swap["upload_s"] = upload_s
            self._send(200, res)
        except (ShuttingDown, RetriableError) as e:
            self._send(503, {"error": str(e)}, headers=self._retry_hdr())
        except ValueError as e:
            already = "already in flight" in str(e)
            self._send(409 if already else 400, {"error": str(e)})
        except (NotImplementedError, KeyError, TypeError,
                json.JSONDecodeError) as e:
            self._send(400, {"error": str(e)})
        except Exception as e:     # noqa: BLE001 — refuse, never crash
            self._send(503, {"error": str(e)}, headers=self._retry_hdr())

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
            self._adapters_admin(body)
            return
        if self.path == "/v1/swap":
            self._swap(body)
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
            # trace context: the router (or a client) propagates
            # X-Tpujob-Trace; on a SERVE_TRACE=1 ring every row traces
            # under it and the span sets ride the response
            trace_ctx = TR.parse_trace_header(
                self.headers.get(TR.TRACE_HEADER))
            id_hdrs = {}
            if req.get("request_id") is not None:
                id_hdrs["X-Request-Id"] = TR.safe_header_value(
                    req.get("request_id"))
            if self.replica_id:
                id_hdrs["X-Tpujob-Replica"] = self.replica_id
            if req.get("stream"):
                if deadline_s is not None:
                    req["deadline_s"] = float(deadline_s)
                if priority is not None:
                    req["priority"] = int(priority)
                return self._stream_generate(req, trace_ctx=trace_ctx,
                                             id_hdrs=id_hdrs)
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
                rows, rates, expired, traces = gen.generate_rows(
                    tokens, request_id=req.get("request_id"),
                    deadline_s=(float(deadline_s)
                                if deadline_s is not None else None),
                    priority=(int(priority)
                              if priority is not None else None),
                    adapter=req.get("adapter"), trace_ctx=trace_ctx,
                    **opts)
                resp = {"tokens": rows}
                if gen.batcher.spec_k > 0:
                    # speculative ring: acceptance rides every response
                    resp["accept_rate"] = rates
                if any(t is not None for t in traces):
                    # per-row span sets: response metadata only, the
                    # token payload is untouched
                    resp["trace"] = [t.to_wire() if t is not None
                                     else None for t in traces]
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
    for key in ("SERVE_KV_MIGRATE", "SERVE_KV_PEER_FETCH"):
        if environ.get(key, "0") == "1":
            refused.append(f"{key}=1 (fleet-level KV)")
    if on("SERVE_KV_BROKER"):
        refused.append(f"SERVE_KV_BROKER={environ['SERVE_KV_BROKER']} "
                       "(fleet-level KV)")
    if refused:
        raise ValueError("not ported to the torch package yet "
                         "(ROADMAP.md Queue A): " + "; ".join(refused))


def ring_kw_from_env(environ, cfg: Optional[LlamaConfig] = None) -> dict:
    """The continuous ring's arguments from the ``SERVE_*`` env, as the
    JAX entry point reads them: SERVE_SLOTS, SERVE_CHUNK,
    SERVE_MAX_QUEUE, SERVE_MAX_LEN, SERVE_GENERATION, SERVE_PAGED with
    SERVE_BLOCK_SIZE / SERVE_PREFIX_CACHE / SERVE_NUM_BLOCKS,
    SERVE_KV_QUANT, SERVE_MEGASTEP, SERVE_PREFILL with
    SERVE_PREFILL_CHUNK, SERVE_PRIORITIES, SERVE_PREWARM, SERVE_TRACE
    (span capture), SERVE_NAN_CHECK (the NaN-lane check), the
    preemption knobs (SERVE_PREEMPT, on unless "0", and its budgets
    SERVE_PREEMPT_MAX_PER_REQ / _BUDGET / _WINDOW_S: a waiting request
    of a more urgent class spills the least urgent lane of a full paged
    ring, which resumes later bit-identically) and the watchdog knobs
    (SERVE_WATCHDOG*, SERVE_MAX_RESTARTS, SERVE_RESTART_WINDOW_S).

    The host spill tier (paged only) is sized by SERVE_HOST_CACHE_BLOCKS
    (blocks) or SERVE_HOST_CACHE_MB (megabytes, converted at the pool's
    host bytes a block, ``paged.host_block_bytes``): eviction demotes
    refcount-0 cached prefix blocks to host memory instead of discarding
    them, and a later hit promotes them back byte for byte.  0 or unset
    is the tierless ring.  ``cfg`` (default: the MODEL_PRESET's) is the
    served model's config, whose block bytes size the tier.

    SERVE_MEGASTEP=N fuses N ring iterations into one dispatch (one
    CUDA graph replay on the card), with eos / token budget / deadline
    ticks carried on the device: admissions move to megastep
    boundaries, so a queued request may wait up to N iterations for a
    lane.  0 or unset is the single-step default (the CRD's
    ``spec.serving.megastep`` 0 means "server default").

    SERVE_PREFILL=inline|chunked|disagg: how admission prefill reaches
    the card.  ``chunked`` interleaves SERVE_PREFILL_CHUNK-token slices
    (default 64) into ring iterations, so a cold long prompt never
    stalls resident decode lanes for a whole prefill; ``disagg`` (implies
    SERVE_PAGED=1: the handoff is block-granular) moves cold prefills to
    a separate engine — SERVE_PREFILL_LANES (1: the monolithic engine;
    N: N chunk-interleaved lanes), SERVE_PREFILL_STREAM=1 (completed
    block groups land while the rest prefills) and
    SERVE_PREFILL_PREFIX_BLOCKS (the engine's own prefix cache, 0 off)
    — or, with SERVE_PREFILL_REMOTE=1, to the prefill pool's pods
    (SERVE_PREFILL_BROKER / SERVE_PREFILL_PEERS: the client itself is
    :func:`~paddle_operator_tpu_torch.infer.prefill_serve.
    remote_prefill_client_from_env`'s, built by ``main``).

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
          # self-healing on by default for deployed rings (with the
          # NaN-lane check under SERVE_NAN_CHECK=1)
          "resilience": RingResilience.from_env(environ),
          # SERVE_TRACE=1: per-request span capture
          "trace": TR.trace_enabled(environ),
          "generation": int(environ.get("SERVE_GENERATION", "0") or 0),
          "prewarm": environ.get("SERVE_PREWARM", "1") == "1",
          "qos": QoSConfig.from_env(environ)}
    if environ.get("SERVE_MAX_LEN"):
        kw["max_len"] = int(environ["SERVE_MAX_LEN"])
    megastep = int(environ.get("SERVE_MEGASTEP", "0") or 0)
    if megastep > 1:
        kw["megastep"] = megastep
    prefill_mode = environ.get("SERVE_PREFILL", "inline")
    if prefill_mode != "inline":
        kw["prefill_mode"] = prefill_mode
    if prefill_mode == "disagg":
        if environ.get("SERVE_PAGED", "0") != "1":
            print("SERVE_PREFILL=disagg implies SERVE_PAGED=1 "
                  "(block-granular handoff)", flush=True)
        kw["prefill_lanes"] = int(environ.get("SERVE_PREFILL_LANES", "1")
                                  or 1)
        kw["prefill_stream"] = environ.get("SERVE_PREFILL_STREAM",
                                           "0") == "1"
        kw["prefill_prefix_blocks"] = int(
            environ.get("SERVE_PREFILL_PREFIX_BLOCKS", "0") or 0)
    if environ.get("SERVE_PREFILL_CHUNK"):
        kw["prefill_chunk"] = int(environ["SERVE_PREFILL_CHUNK"])
    kvq = environ.get("SERVE_KV_QUANT", "none") or "none"
    if kvq != "none":
        kw["kv_quant"] = kvq
        if environ.get("SERVE_PAGED", "0") != "1":
            print("SERVE_KV_QUANT implies SERVE_PAGED=1 (the pool block "
                  "is the quantization unit)", flush=True)
    if (environ.get("SERVE_PAGED", "0") == "1" or kvq != "none"
            or prefill_mode == "disagg"):
        kw["paged"] = True
        kw["block_size"] = int(environ.get("SERVE_BLOCK_SIZE", "256"))
        kw["prefix_cache"] = environ.get("SERVE_PREFIX_CACHE", "1") == "1"
        if environ.get("SERVE_NUM_BLOCKS"):
            kw["num_blocks"] = int(environ["SERVE_NUM_BLOCKS"])
        host_blocks = int(environ.get("SERVE_HOST_CACHE_BLOCKS", "0") or 0)
        host_mb = float(environ.get("SERVE_HOST_CACHE_MB", "0") or 0)
        if not host_blocks and host_mb > 0:
            from paddle_operator_tpu_torch.infer.paged import (
                host_block_bytes,
            )
            from paddle_operator_tpu_torch.models.llama import CONFIGS

            if cfg is None:
                cfg = CONFIGS[environ.get("MODEL_PRESET", "7b")]
            host_blocks = int(host_mb * 1e6 // host_block_bytes(
                cfg, kw["block_size"], kvq))
        if host_blocks > 0:
            kw["host_cache_blocks"] = host_blocks
    return kw


def wire_kv_store_from_env(batcher, environ=None) -> None:
    """The durable prefix store from the env: ``SERVE_KV_STORE=dir:/path``
    attaches the persistent tier below the host tier — tier overflow
    persists through a background writer instead of being discarded, and
    the submit thread probes the store for a prompt's missing chain.
    ``SERVE_KV_STORE_TTL_S`` (expire idle entries),
    ``SERVE_KV_STORE_BUDGET_MB`` (LRU size budget),
    ``SERVE_KV_STORE_JANITOR_S`` (in-process janitor period; 0 leaves
    the lifecycle to the offline ``python -m
    paddle_operator_tpu_torch.infer.kvstore`` pass) and
    ``SERVE_KV_STORE_QUEUE`` (the writer queue's bound, drop-oldest).
    Needs the paged ring and the host tier; unset, nothing changes."""
    environ = os.environ if environ is None else environ
    url = environ.get("SERVE_KV_STORE", "").strip()
    if not url:
        return
    if batcher.pool is None or batcher.pool.host is None:
        print("SERVE_KV_STORE ignored: the durable store spills from "
              "and promotes through the host tier — set SERVE_PAGED=1 "
              "and SERVE_HOST_CACHE_BLOCKS/_MB", flush=True)
        return
    from paddle_operator_tpu_torch.infer import kvstore as KVS

    try:
        backend = KVS.parse_store_url(url)
    except (ValueError, OSError) as e:
        print(f"SERVE_KV_STORE ignored: {e}", flush=True)
        return
    store = KVS.KVBlockStore(
        backend, fingerprint=batcher._fingerprint(),
        ttl_s=float(environ.get("SERVE_KV_STORE_TTL_S", "0") or 0),
        budget_mb=int(environ.get("SERVE_KV_STORE_BUDGET_MB", "0") or 0),
        queue_len=int(environ.get("SERVE_KV_STORE_QUEUE", "256") or 256))
    batcher.attach_kv_store(store)
    janitor_s = float(environ.get("SERVE_KV_STORE_JANITOR_S", "0") or 0)
    if janitor_s > 0:
        def _janitor_loop():
            while not batcher._stop.wait(janitor_s):
                try:
                    store.janitor()
                except OSError:
                    pass

        threading.Thread(target=_janitor_loop, daemon=True,
                         name="kvstore-janitor").start()
    print(f"durable KV store attached: {url} "
          f"(ttl_s={store.ttl_s}, budget_mb={store.budget_mb}, "
          f"janitor_s={janitor_s})", flush=True)


_SIDE_STREAMS: dict = {}


@contextlib.contextmanager
def _side_stream(device):
    """The block's device work (a swap's upload and quantization) on a
    CUDA stream of its own, waited for at the end, so the ring's stream
    never queues behind it; off the card just ``no_grad``.  One stream a
    device: the allocator reuses a swapped-out model's memory only for
    allocations on the stream that made it."""
    device = torch.device(device)
    if device.type != "cuda":
        with torch.no_grad():
            yield
        return
    side = _SIDE_STREAMS.get(device)
    if side is None:
        side = _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    with torch.cuda.stream(side), torch.no_grad():
        yield
    side.synchronize()


def model_from_state(state: dict, cfg: LlamaConfig, device,
                     weight_quant: str = "none",
                     legacy_quant: bool = False) -> Llama:
    """A served model on ``device`` from a host state dict (the base
    retained under ``SERVE_SWAP_RETAIN``), quantized as at boot
    (``legacy_quant``: ``QUANTIZE=int8``'s call first; ``weight_quant``
    with the serving skip list), built on a stream of its own."""
    from paddle_operator_tpu_torch.infer import quant as Q

    with _side_stream(device):
        model = Llama(cfg, torch.device(device))
        model.load_state_dict(state)
        if legacy_quant:
            Q.quantize_params(model)
        if weight_quant != "none":
            Q.quantize_params(model, cfg, mode=weight_quant,
                              skip=Q.SERVING_SKIP)
    return model


def host_state(model: Llama) -> dict:
    """The model's state dict copied to host memory: the retained swap
    base (``SERVE_SWAP_RETAIN``), host RAM, not the card's."""
    return {k: v.detach().to("cpu", copy=True)
            for k, v in model.state_dict().items()}


def _load_swap_checkpoint(path: str, cfg: LlamaConfig, device,
                          weight_quant: str = "none") -> Llama:
    """The weights of a ``/v1/swap`` from a training checkpoint, on the
    handler's thread: the newest committed step under ``path``
    restored as at boot (:func:`load_serving_params`: serving dtype, an
    orbax step of the JAX package refused by name), uploaded on a stream
    of its own and quantized under ``weight_quant``.  Raises when no
    step is there: a swap never flips to fresh-init weights."""
    from paddle_operator_tpu_torch.infer import quant as Q
    from paddle_operator_tpu_torch.train.checkpoint import (
        CheckpointManager,
    )

    if CheckpointManager(path).latest_step() is None:
        raise ValueError(f"no checkpoint restorable at {path}")
    with _side_stream(device):
        model, cfg, _ = load_serving_params(path, cfg, device)
        if weight_quant != "none":
            Q.quantize_params(model, cfg, mode=weight_quant,
                              skip=Q.SERVING_SKIP)
    return model


def load_serving_params(path: str, cfg: LlamaConfig, device="cuda",
                        seed: int = 0) -> Tuple[Llama, LlamaConfig, bool]:
    """The parameters to serve, in the serving dtype ``cfg.dtype`` on
    ``device``: the newest committed step under ``path``
    (train/checkpoint.py; a newest step that fails to load is passed
    over with a logged warning), else — no path, or no step yet — a
    fresh init from ``seed``.  Returns ``(model, its config,
    resumed)``.

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
        gen.manual_seed(seed)
        return Llama(cfg, device).init_weights(gen)

    model, resumed = resume_or_init(CheckpointManager(path), init)
    return model, cfg, resumed


def spec_kw_from_env(environ, cfg: LlamaConfig, device="cuda",
                     retain: bool = False) -> dict:
    """The speculative ring's arguments from the env, as the JAX entry
    point builds them: ``SERVE_SPEC_K=K`` (0 or unset: none, ``{}``);
    ``SERVE_DRAFT`` names the draft config — "auto" (the default)
    derives ``cfg.draft()``, a preset name uses that preset; the draft's
    weights restore from ``TPUJOB_DRAFT_CHECKPOINT_PATH`` as
    :func:`load_serving_params` restores the target's, else a fresh
    init from seed 1 (a random draft: acceptance about 1/vocab); and
    ``SERVE_DRAFT_QUANT=int8|int4`` quantizes the DRAFT's projections
    with the serving skip list.  A coarser draft can only lower the
    acceptance, never change a greedy token.  Returns ``{"draft_params",
    "draft_cfg", "spec_k"}`` with the draft on ``device`` (and, with
    ``retain``, ``"draft_base"``: the draft's host state dict before its
    quantization, with ``"draft_quant"``); call it before the ring is
    built (its graphs read the final addresses)."""
    from paddle_operator_tpu_torch.infer import quant as Q
    from paddle_operator_tpu_torch.infer.speculative import (
        check_draft_compat,
    )
    from paddle_operator_tpu_torch.models.llama import CONFIGS

    spec_k = int(environ.get("SERVE_SPEC_K", "0") or 0)
    if spec_k <= 0:
        return {}
    name = environ.get("SERVE_DRAFT", "auto") or "auto"
    if name == "auto":
        dcfg = cfg.draft()
    elif name in CONFIGS:
        dcfg = CONFIGS[name]
    else:
        raise ValueError(f"SERVE_DRAFT={name!r}: expected 'auto' or one "
                         f"of {sorted(CONFIGS)}")
    check_draft_compat(cfg, dcfg)
    dpath = environ.get("TPUJOB_DRAFT_CHECKPOINT_PATH", "").strip()
    if dpath:
        dmodel, dcfg, _ = load_serving_params(dpath, dcfg, device, seed=1)
    else:
        # no manager at all: CheckpointManager(None) would read the
        # TARGET's TPUJOB_CHECKPOINT_PATH
        dcfg = dataclasses.replace(dcfg, param_dtype=dcfg.dtype)
        gen = torch.Generator(device=device)
        gen.manual_seed(1)
        dmodel = Llama(dcfg, device).init_weights(gen)
    dwq = environ.get("SERVE_DRAFT_QUANT", "none") or "none"
    kw = {"draft_params": dmodel, "draft_cfg": dcfg, "spec_k": spec_k}
    if retain:
        kw.update(draft_base=host_state(dmodel), draft_quant=dwq)
    if dwq != "none":
        Q.quantize_params(dmodel, dcfg, mode=dwq, skip=Q.SERVING_SKIP)
    return kw


def adapter_kw_from_env(environ, cfg: LlamaConfig, spec_k: int = 0,
                        device="cuda") -> dict:
    """The ring's LoRA registry from the env, as the JAX entry point
    builds it: ``SERVE_ADAPTERS`` (``name``, ``name:seed:<int>`` or
    ``name:/path.npz`` entries; SERVE_ADAPTER_RANK / SERVE_MAX_ADAPTERS
    size the pool) -> ``{"adapters": registry}`` on ``device``, more
    loaded and evicted at runtime through POST /v1/adapters.  Unset:
    ``{}``.  Beside ``SERVE_SPEC_K`` > 0 it prints the JAX server's line
    and returns ``{}``: the ring serves the base model only."""
    from paddle_operator_tpu_torch.infer.qos import AdapterRegistry

    if spec_k:
        if environ.get("SERVE_ADAPTERS", "").strip():
            print("SERVE_ADAPTERS ignored: adapters are not supported "
                  "on speculative rings (the draft proposes base-only)",
                  flush=True)
        return {}
    adapters = AdapterRegistry.from_env(cfg, environ, device)
    return {"adapters": adapters} if adapters is not None else {}


def quantize_from_env(model: Llama, cfg: LlamaConfig, environ) -> str:
    """Weight-only quantization of the served model, in place, as the
    JAX entry point applies it after its restore: ``QUANTIZE=int8`` is
    the legacy call (int8, ``lm_head`` included); ``SERVE_WEIGHT_QUANT=
    int8|int4`` quantizes with the serving skip list (the embedding,
    ``lm_head`` and the norms stay in the serving dtype); another mode
    raises ``ValueError`` naming it.  One projection at a time, each
    unquantized kernel released as its codes are made.  Call it before
    the ring is built: graphs captured at boot read the final
    addresses.  Returns the served model's mode ("none" unquantized)."""
    from paddle_operator_tpu_torch.infer import quant as Q

    if environ.get("QUANTIZE", "") == "int8":
        Q.quantize_params(model)
    wq = environ.get("SERVE_WEIGHT_QUANT", "none") or "none"
    if wq != "none":
        Q.quantize_params(model, cfg, mode=wq, skip=Q.SERVING_SKIP)
    return Q.weight_quant_mode(model)


def main() -> int:
    """Serving entrypoint: restore MODEL_PRESET (default 7b) from
    TPUJOB_CHECKPOINT_PATH — fresh init from seed 0 when it holds no
    step — on the card in the serving dtype (``load_serving_params``)
    and serve on TPUJOB_PORT: batch mode, or the decode ring with
    SERVE_CONTINUOUS=1 (paged with SERVE_PAGED=1, over the int8 pool
    with SERVE_KV_QUANT=int8), its weights quantized under
    SERVE_WEIGHT_QUANT or QUANTIZE (``quantize_from_env``) and, with
    SERVE_SPEC_K, a draft model beside it (``spec_kw_from_env``), or,
    with SERVE_ADAPTERS, its LoRA adapters (``adapter_kw_from_env``;
    ignored beside SERVE_SPEC_K, as in the JAX package);
    SIGTERM drains and exits EXIT_PREEMPTED (83).

    The continuous ring serves ``POST /v1/swap``; ``SERVE_SWAP_RETAIN``
    (default 1) keeps a host copy of the base weights before their
    quantization (and of the draft's), so a swap without a checkpoint
    rebuilds from it (0: a swap must name a checkpoint).
    ``TPUJOB_CHAOS`` installs the fault injector (infer/chaos.py) on the
    ring."""
    from paddle_operator_tpu_torch.ft.preemption import PreemptionWatcher
    from paddle_operator_tpu_torch.infer.chaos import maybe_install_from_env
    from paddle_operator_tpu_torch.infer.quant import weight_quant_mode
    from paddle_operator_tpu_torch.infer.resilience import ServingDrain
    from paddle_operator_tpu_torch.launch.launcher import JobEnv
    from paddle_operator_tpu_torch.models.llama import CONFIGS

    env = JobEnv.from_env()
    refuse_unported(os.environ)
    if not torch.cuda.is_available():
        raise RuntimeError("the torch server runs on a CUDA card and "
                           "found none")
    continuous = os.environ.get("SERVE_CONTINUOUS", "0") == "1"
    preset = os.environ.get("MODEL_PRESET", "7b")
    ring_kw = (ring_kw_from_env(os.environ, CONFIGS[preset]) if continuous
               else {})
    params, cfg, resumed = load_serving_params(
        env.checkpoint_path, CONFIGS[preset], "cuda")
    retain = (continuous
              and os.environ.get("SERVE_SWAP_RETAIN", "1") == "1")
    swap_base = None
    if retain:
        swap_base = {"params": host_state(params),
                     "weight_quant": (os.environ.get("SERVE_WEIGHT_QUANT",
                                                     "none") or "none"),
                     "legacy_quant": os.environ.get("QUANTIZE", "") == "int8"}
    wquant = quantize_from_env(params, cfg, os.environ)
    mode = "batch"
    if continuous:
        spec_kw = spec_kw_from_env(os.environ, cfg, "cuda", retain=retain)
        if retain and "draft_base" in spec_kw:
            swap_base["draft_params"] = spec_kw.pop("draft_base")
            swap_base["draft_quant"] = spec_kw.pop("draft_quant")
        ring_kw.update(spec_kw)
        ring_kw.update(adapter_kw_from_env(os.environ, cfg,
                                           ring_kw.get("spec_k", 0),
                                           "cuda"))
        if ring_kw.get("prefill_mode") == "disagg":
            # SERVE_PREFILL_REMOTE=1: cold prefills go to the prefill pool
            from paddle_operator_tpu_torch.infer.prefill_serve import (
                remote_prefill_client_from_env,
            )

            client = remote_prefill_client_from_env(os.environ)
            if client is not None:
                ring_kw["prefill_client"] = client
        dquant = (weight_quant_mode(ring_kw["draft_params"])
                  if "draft_params" in ring_kw else "none")
        mode = (f"continuous, paged={bool(ring_kw.get('paged'))}, "
                f"prefill={ring_kw.get('prefill_mode', 'inline')}, "
                f"kv_quant={ring_kw.get('kv_quant', 'none')}, "
                f"megastep={ring_kw.get('megastep', 1)}, "
                f"spec_k={ring_kw.get('spec_k', 0)}, "
                f"draft_quant={dquant}, "
                f"host_cache_blocks={ring_kw.get('host_cache_blocks', 0)}, "
                f"adapters={len(ring_kw.get('adapters') or ())}, "
                f"slots={ring_kw['slots']}, "
                f"chunk={ring_kw['chunk_tokens']}")
    print(f"serving {preset} (resumed={resumed}, weight_quant={wquant}, "
          f"mode={mode}, "
          f"device={torch.cuda.get_device_name(0)}) on :{env.port}",
          flush=True)
    srv = make_server("0.0.0.0", env.port, params, cfg,
                      continuous=continuous,
                      job=os.environ.get("TPUJOB_NAME", "local"),
                      replica=os.environ.get("TPUJOB_REPLICA_ID", ""),
                      **ring_kw)
    # the /v1/swap handler reaches the retained base through the server
    srv.swap_base = swap_base
    batcher = srv.generator.batcher if continuous else None
    if batcher is not None:
        # TPUJOB_CHAOS: deterministic fault injection on the live ring
        maybe_install_from_env(batcher)
        wire_kv_store_from_env(batcher)
    watcher = PreemptionWatcher.install()
    drain = ServingDrain(srv, srv.state, batcher=batcher,
                         budget_s=float(os.environ.get(
                             "SERVE_DRAIN_BUDGET_S", "30")))
    drain.install(watcher)
    return serve_until_drained(srv, drain)


def serve_until_drained(srv, drain) -> int:
    """Serve until the drain shuts ``srv`` down, then wait for the drain
    and return ``EXIT_PREEMPTED``.  The drain's ``shutdown`` ends
    ``serve_forever`` on this thread while the drain thread still gives
    the handler threads their grace before it exits the process as
    preempted; returning 0 here first ended the process with 0 (seen on
    the card in a SIGTERM of ``main()``)."""
    from paddle_operator_tpu_torch.ft.preemption import EXIT_PREEMPTED

    srv.serve_forever()
    drain.done.wait()
    return EXIT_PREEMPTED


if __name__ == "__main__":
    raise SystemExit(main())
