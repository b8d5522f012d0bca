"""Minimal generation server — the port of
``paddle_operator_tpu/infer/serve.py``, batch mode.

Serves :func:`infer.decode.generate` as JSON over stdlib HTTP, with the
JAX server's surface:

    POST /v1/generate
      {"tokens": [[...], ...], "max_new_tokens": N,
       "temperature": 0.7, "top_k": 40, "top_p": 0.9, "eos_token": 2,
       "seed": 0, "request_id": "..."}
    -> {"tokens": [[...], ...]}   (prompt + continuation per row)
    GET /healthz /readyz /statusz /metrics /debug/flightrec

Batch mode only: each request's whole batch runs through ``generate``
under one lock (no compile cache exists to port — PyTorch runs
eagerly).  The continuous ring's routes (``"stream": true``,
``/v1/swap``, ``/v1/kv/*``, ``POST /v1/adapters``) answer exactly as
the JAX batch-mode server answers them.

Greedy output equals the JAX server's token for token.  Temperature
sampling draws from a ``torch.Generator`` seeded with the request's
``seed``; it cannot reproduce ``jax.random`` bit for bit, so sampled
tokens differ from the JAX server's for the same seed.

Run on the card::

    MODEL_PRESET=7b TPUJOB_PORT=8999 \\
    python3 -m paddle_operator_tpu_torch.infer.serve
"""

from __future__ import annotations

import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np
import torch

from paddle_operator_tpu_torch.infer import decode as D
from paddle_operator_tpu_torch.infer.resilience import ServerState
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


class _Handler(BaseHTTPRequestHandler):
    generator: Generator  # injected
    state = None          # injected resilience.ServerState
    # fleet identity (make_server job=/replica=): labels /metrics
    job_key = "local"
    replica_id = ""
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

    def do_GET(self):
        # /healthz: should this pod be REPLACED (no ring to die here);
        # /readyz: should it take TRAFFIC (false while draining)
        if self.path == "/healthz":
            self._send(200, {"ok": True})
        elif self.path == "/readyz":
            if self.state and self.state.draining:
                self._send(503, {"ready": False, "reason": "draining"},
                           headers=self._retry_hdr())
            else:
                self._send(200, {"ready": True})
        elif self.path == "/v1/adapters":
            self._send(200, {"adapters": [], "capacity": 0})
        elif self.path == "/statusz":
            # batch mode publishes no serving_status block
            st = {}
            if self.replica_id:
                st["replica"] = self.replica_id
            self._send(200, st)
        elif self.path == "/metrics":
            from paddle_operator_tpu_torch.utils.observability import (
                histogram_exposition,
                serving_gauges,
            )

            gauges = serving_gauges({}, self.job_key,
                                    replica=self.replica_id or None)
            text = "".join(f"{k} {v}\n" for k, v in sorted(gauges.items()))
            text += histogram_exposition(None, self.job_key,
                                         self.replica_id or None)
            body = text.encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path == "/debug/flightrec":
            self._send(200, {"events": []})
        else:
            self._send(404, {})

    def do_POST(self):
        # drain the body before ANY response: under HTTP/1.1 keep-alive
        # an unread body would be parsed as the next request's start line
        n = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(n) if n else b""
        # the continuous ring's routes, answered as a batch server does
        if self.path == "/v1/kv/restore":
            self._send(400, {"error": "lane adoption requires the "
                                      "continuous server"})
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
            self._send(400, {"error": "live swap requires the "
                             "continuous ring (SERVE_CONTINUOUS=1)"})
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
            # parsed for the JAX server's 400s on malformed values;
            # deadlines and priorities act only on the continuous ring
            if req.get("deadline_s") is None \
                    and self.headers.get("X-Request-Deadline") is not None:
                float(self.headers.get("X-Request-Deadline"))
            if req.get("priority") is None \
                    and self.headers.get("X-Request-Priority") is not None:
                int(self.headers.get("X-Request-Priority"))
            id_hdrs = {}
            if req.get("request_id") is not None:
                id_hdrs["X-Request-Id"] = safe_header_value(
                    req.get("request_id"))
            if self.replica_id:
                id_hdrs["X-Tpujob-Replica"] = self.replica_id
            if req.get("stream"):
                raise ValueError("streaming requires the continuous "
                                 "server (SERVE_CONTINUOUS=1)")
            tokens = np.asarray(req["tokens"], np.int32)
            if tokens.ndim != 2:
                raise ValueError("tokens must be [batch, seq]")
            out = self.generator(
                tokens,
                max_new_tokens=int(req.get("max_new_tokens", 32)),
                temperature=float(req.get("temperature", 0.0)),
                top_k=req.get("top_k"),
                top_p=req.get("top_p"),
                eos_token=req.get("eos_token"),
                seed=int(req.get("seed", 0)))
            self._send(200, {"tokens": out.tolist()}, headers=id_hdrs)
        except (ValueError, KeyError, TypeError,
                json.JSONDecodeError) as e:
            self._send(400, {"error": str(e)})
        except Exception as e:  # noqa: BLE001 — server-side failure
            # 503 tells clients to retry/fail over, not to blame their
            # request
            self._send(503, {"error": str(e)})


def make_server(host: str, port: int, params: Llama, cfg: LlamaConfig,
                *, continuous: bool = False, mesh=None,
                job: str = "local", replica: str = ""
                ) -> ThreadingHTTPServer:
    """A batch-mode server over ``params`` (the port's Llama, on the
    device it should serve from).  The returned server carries
    ``.generator`` and ``.state`` (the drain flags)."""
    if continuous:
        raise NotImplementedError(
            "the continuous decode ring is not ported to the torch "
            "package yet (ROADMAP.md Queue A, continuous ring)")
    gen = Generator(params, cfg, mesh=mesh)
    state = ServerState()
    handler = type("Handler", (_Handler,),
                   {"generator": gen, "state": state,
                    "job_key": job, "replica_id": replica})
    srv = ThreadingHTTPServer((host, port), handler)
    srv.generator = gen
    srv.state = state
    return srv


def refuse_unported(environ, checkpoint_path: str) -> None:
    """Raise on every knob this port cannot honour yet — it never
    silently serves something else than what was asked for."""
    refused = []
    if environ.get("SERVE_CONTINUOUS", "0") == "1":
        refused.append("SERVE_CONTINUOUS=1 (the continuous ring)")
    if int(environ.get("SERVE_TP", "1") or 1) > 1:
        refused.append(f"SERVE_TP={environ['SERVE_TP']} (tensor "
                       "parallelism)")
    if environ.get("QUANTIZE", "") not in ("", "none", "off"):
        refused.append(f"QUANTIZE={environ['QUANTIZE']}")
    if environ.get("SERVE_WEIGHT_QUANT", "none") not in ("", "none"):
        refused.append(f"SERVE_WEIGHT_QUANT="
                       f"{environ['SERVE_WEIGHT_QUANT']}")
    if checkpoint_path:
        refused.append(f"TPUJOB_CHECKPOINT_PATH={checkpoint_path} "
                       "(checkpoint restore)")
    if refused:
        raise ValueError("not ported to the torch package yet "
                         "(ROADMAP.md Queue A): " + "; ".join(refused))


def main() -> int:
    """Serving entrypoint: fresh-init MODEL_PRESET (default 7b) from
    seed 0 on the card in the serving dtype and serve on TPUJOB_PORT;
    SIGTERM drains and exits EXIT_PREEMPTED (83)."""
    from paddle_operator_tpu_torch.ft.preemption import PreemptionWatcher
    from paddle_operator_tpu_torch.infer.resilience import ServingDrain
    from paddle_operator_tpu_torch.launch.launcher import JobEnv
    from paddle_operator_tpu_torch.models.llama import CONFIGS, make_model

    env = JobEnv.from_env()
    refuse_unported(os.environ, env.checkpoint_path)
    if not torch.cuda.is_available():
        raise RuntimeError("the torch server runs on a CUDA card and "
                           "found none")
    preset = os.environ.get("MODEL_PRESET", "7b")
    serve_dtype = CONFIGS[preset].dtype
    # no checkpoint: fresh init straight into the serving dtype
    params, cfg = make_model(preset, device="cuda", seed=0,
                             param_dtype=serve_dtype)
    print(f"serving {preset} (resumed=False, mode=batch, "
          f"device={torch.cuda.get_device_name(0)}) on :{env.port}",
          flush=True)
    srv = make_server("0.0.0.0", env.port, params, cfg,
                      job=os.environ.get("TPUJOB_NAME", "local"),
                      replica=os.environ.get("TPUJOB_REPLICA_ID", ""))
    watcher = PreemptionWatcher.install()
    ServingDrain(srv, srv.state).install(watcher)
    srv.serve_forever()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
