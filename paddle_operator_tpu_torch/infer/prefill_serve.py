"""Standalone prefill server — the cross-host half of disaggregated
prefill, the port of ``paddle_operator_tpu/infer/prefill_serve.py``.

The in-process engine (``executor.PrefillExecutor``) hands completed
prompts to the decode ring by an in-place block copy; this module wraps
the SAME engine in its own HTTP process, so prefill capacity scales in
its own pods, independently of decode.

Protocol (one round trip; prefill is side-effect-free, so retries are
always safe)::

    POST /v1/prefill   {"tokens": [...], "temperature": t, "seed": s,
                        "fingerprint": {...}, "requestId": "...",
                        "stream": false}
    -> 200  application/octet-stream: a fleet-KV HANDOFF envelope
            (utils/fleetkv.encode_handoff: dtype/shape manifest, CRC,
            fingerprint; the decode side refuses it wholesale on any
            mismatch) — or, with "stream": true, chunked transfer of
            length-prefixed frames (utils/fleetkv.encode_handoff_frame
            ... encode_handoff_final)
    -> 409  fingerprint mismatch (a mixed fleet: never serve bytes the
            decode pool would misinterpret)
    -> 503  draining, or a prefill that timed out (a backlogged pod):
            the decode side retries another pod

The decode replica's :class:`RemotePrefillClient` sits where the
in-process engine sits at the scheduler seam (same ``submit(req,
slot)`` / ``results`` contract), POSTs on worker threads, never the
ring's, and posts host payloads the scheduler lands through the promote
scatter.  Envelopes and frames are byte-compatible with the JAX
package's both ways, so a port decode replica can take a JAX prefill
pod's handoffs and the reverse (token for token under greedy decoding:
the sampled first token follows each package's own sampler).

Drain: SIGTERM flips /readyz false and new prefills 503; in-flight jobs
finish and flush their responses inside the budget; the process exits
EXIT_PREEMPTED (83), which the reconciler counts as preempted, not
failed.

Boot: ``python -m paddle_operator_tpu_torch.infer.prefill_serve`` —
MODEL_PRESET restored from TPUJOB_CHECKPOINT_PATH (a fresh init from
seed 0 without a step), SERVE_WEIGHT_QUANT, SERVE_KV_QUANT,
SERVE_BLOCK_SIZE, SERVE_MAX_LEN, SERVE_PREFILL_LANES, SERVE_PREFILL_CHUNK,
SERVE_PREFILL_PREFIX_BLOCKS, SERVE_GENERATION, served on TPUJOB_PORT; on
the card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from paddle_operator_tpu_torch.utils import tracing as TR

# One whole-prompt forward a job, bounded by model size — generous for a
# cold 7b 2k-token prefill, small enough that a wedged pod sheds its
# waiters onto healthy peers.
PREFILL_TIMEOUT_S = 120.0


def handoff_fingerprint(cfg, *, block_size: int, kv_quant: str,
                        top_k: Optional[int], top_p: Optional[float],
                        wquant: str = "none",
                        generation: int = 0) -> Dict[str, Any]:
    """The geometry and sampling rule a handoff envelope must match —
    the JAX function's dict, key for key (no backend field: a port pod
    serves a JAX replica and the reverse).  Spec depth is absent (the
    DRAFT lane prefills decode-side at attach) and tp is absent (host
    bytes re-shard through the promote scatter); top-k/top-p are
    present (the pod samples the FIRST token), and so are the WEIGHT
    quant mode and generation (handed-off KV is a function of the
    weights that produced it)."""
    return {"layers": int(cfg.n_layers),
            "kvHeads": int(cfg.n_kv_heads),
            "headDim": int(cfg.head_dim),
            "blockSize": int(block_size),
            "quant": kv_quant,
            "wquant": wquant,
            "gen": int(generation),
            "topK": top_k, "topP": top_p}


class _Job:
    """The request shim the prefill engine reads (prompt, temperature,
    seed, adapter slot and the done/_cancel lifecycle flags).
    ``wants_frames`` (a streamed handoff): the matcher routes the
    engine's block-group frames into ``frames`` for the chunked
    response; without it frames are dropped and only the terminal result
    lands."""

    __slots__ = ("prompt", "temperature", "seed", "adapter_idx", "done",
                 "_cancel", "result", "error", "t0", "accounted",
                 "wants_frames", "frames")

    def __init__(self, prompt: Sequence[int], temperature: float,
                 seed: int, wants_frames: bool = False) -> None:
        self.prompt = [int(t) for t in prompt]
        self.temperature = float(temperature)
        self.seed = int(seed)
        self.adapter_idx = 0
        self.done = threading.Event()
        self._cancel = False
        self.result: Optional[Tuple[Any, ...]] = None
        self.error: Optional[Exception] = None
        self.t0 = time.monotonic()
        # exactly-once depth accounting (under the frontend lock): a
        # timed-out job may be dropped by the engine while QUEUED (no
        # result ever posted) or may still finish and post one —
        # whichever side settles first decrements, the other skips
        self.accounted = False
        self.wants_frames = bool(wants_frames)
        self.frames: Optional["queue.Queue[tuple]"] = (
            queue.Queue() if wants_frames else None)


class PrefillFrontend:
    """The device half of the prefill server: one ``PrefillExecutor``
    plus a matcher thread that turns its results into HOST bytes and
    resolves each job.  The engine writes its pool in place, so the
    matcher copies a result's blocks to host memory (after the engine's
    event) and then releases the engine lane — the snapshot-lifetime
    rule's consumer half.  Kept apart from the HTTP shell so tests can
    drive it in-process."""

    def __init__(self, params: Any, cfg, *, block_size: int, max_len: int,
                 buckets: Tuple[int, ...] = (),
                 top_k: Optional[int] = None,
                 top_p: Optional[float] = None,
                 kv_quant: str = "none", lanes: int = 1,
                 prefill_chunk: int = 64, prefix_blocks: int = 0,
                 generation: int = 0) -> None:
        import os

        from paddle_operator_tpu_torch.infer import executor as X
        from paddle_operator_tpu_torch.infer import quant as Q

        self.cfg = cfg
        self.block_size = int(block_size)
        self.kv_quant = kv_quant
        # detected, not configured: the served tree decides (as the
        # decode side's fingerprint does)
        self.wquant = Q.weight_quant_mode(params)
        self.generation = int(generation)
        self.quant = kv_quant == "int8"
        self.top_k, self.top_p = top_k, top_p
        self.lanes = max(1, int(lanes))
        # the N-lane engine always produces frames (streaming clients
        # consume them; the matcher drops them for jobs that did not
        # ask); the 1-lane oracle engine never does
        self.exec = X.PrefillExecutor(
            params, cfg, max_len=max_len, block_size=self.block_size,
            buckets=tuple(buckets) or (max_len,), top_k=top_k, top_p=top_p,
            kv_quant=kv_quant, lanes=self.lanes,
            prefill_chunk=prefill_chunk, stream=self.lanes > 1,
            prefix_blocks=prefix_blocks)
        self.draining = False
        self._lock = threading.Lock()
        self._depth = 0
        self.stats = {"jobs": 0, "prompt_tokens": 0, "errors": 0,
                      "refused": 0}
        # rolling per-job wall EMA: the gauge the SLO autoscaler turns a
        # TTFT target into a queue-depth bound with
        self.prefill_ms_avg = 0.0
        # the pod's own bounded event ring (refusals, per-job errors,
        # drain), served at /debug/flightrec and dumped on SIGTERM
        self.flightrec = TR.FlightRecorder(
            pod=os.environ.get("TPUJOB_REPLICA_ID", ""))
        self._t_start = time.monotonic()
        self._stop = threading.Event()
        self._matcher = threading.Thread(target=self._match_loop,
                                         daemon=True, name="prefill-match")
        self._matcher.start()

    def fingerprint(self) -> Dict[str, Any]:
        return handoff_fingerprint(
            self.cfg, block_size=self.block_size, kv_quant=self.kv_quant,
            top_k=self.top_k, top_p=self.top_p, wquant=self.wquant,
            generation=self.generation)

    def depth(self) -> int:
        with self._lock:
            return self._depth

    # -- engine results -> host bytes -----------------------------------------

    def _host_blocks(self, snap, lane: int, j0: int, j1: int,
                     tail: bool = False) -> Dict[str, torch.Tensor]:
        """An in-process snapshot's blocks [j0, j1) of engine lane
        ``lane`` (and, ``tail`` on the int8 pool, the lane's exact
        staging-tail row) as CPU tensors, read after the engine's
        event."""
        ev = snap.get("ready")
        if ev is not None:
            ev.synchronize()
        ids = self.exec.tables[lane][j0:j1]
        idx = torch.as_tensor(np.asarray(ids, np.int64)).to(
            snap["k"].device)
        keys = ("k", "v", "ks", "vs") if self.quant else ("k", "v")
        # copies, never views: the lane is released once they are made
        arrays = {key: snap[key].index_select(1, idx).to("cpu", copy=True)
                  for key in keys}
        if tail and self.quant:
            for key in ("kt", "vt"):
                arrays[key] = snap[key][:, lane:lane + 1].to("cpu",
                                                             copy=True)
        return arrays

    def _match_loop(self) -> None:
        results = self.exec.results
        with torch.inference_mode():
            while not self._stop.is_set():
                try:
                    item = results.get(timeout=0.05)
                except queue.Empty:
                    continue
                error = not isinstance(item[0], str)  # (job, slot, error)
                job = item[0] if error else item[1]
                try:
                    self._match(item, error, job)
                except Exception as e:      # noqa: BLE001 — this job only
                    job.error = e
                    if job.wants_frames:
                        job.frames.put(("error", job, e))
                    self._settle(job)
                finally:
                    if error or item[0] == "final":
                        # the host copies are complete: the lane is free
                        self.exec.release(job)

    def _match(self, item, error: bool, job: "_Job") -> None:
        if error:
            job.error = item[2]
            if job.wants_frames:
                job.frames.put(("error", job, item[2]))
            self._settle(job)
            return
        if item[0] == "frame":
            if job.wants_frames and not job.done.is_set():
                _, _, _, snap, lane, j0, j1 = item
                job.frames.put(("frame", j0,
                                self._host_blocks(snap, lane, j0, j1)))
            return
        # ("final", job, slot, snap, lane, j0, n_blocks, first, t_done)
        _, _, _, snap, lane, j0, n_blocks, first, t_done = item
        # a job without frames takes every block from the final
        j0 = j0 if job.wants_frames else 0
        job.result = (self._host_blocks(snap, lane, j0, n_blocks, tail=True),
                      j0, n_blocks, int(first), t_done)
        if job.wants_frames:
            job.frames.put(("final",))
        self._settle(job)

    def _settle(self, job: "_Job") -> None:
        ms = (time.monotonic() - job.t0) * 1e3
        with self._lock:
            if not job.accounted:
                job.accounted = True
                self._depth -= 1
                self.prefill_ms_avg = (
                    ms if not self.prefill_ms_avg
                    else 0.8 * self.prefill_ms_avg + 0.2 * ms)
        job.done.set()

    def _submit(self, tokens: Sequence[int], temperature: float, seed: int,
                wants_frames: bool = False) -> "_Job":
        job = _Job(tokens, temperature, seed, wants_frames=wants_frames)
        with self._lock:
            self._depth += 1
        self.exec.submit(job, 0)
        return job

    def _timeout(self, job: "_Job", timeout: float) -> None:
        job._cancel = True      # dropped by the engine if still queued
        # a QUEUED cancelled job never posts a result: settle the depth
        # here (``accounted`` keeps a job that still finishes from
        # decrementing twice)
        with self._lock:
            if not job.accounted:
                job.accounted = True
                self._depth -= 1
        raise TimeoutError(f"prefill did not finish within {timeout}s")

    def _account(self, job: "_Job") -> None:
        with self._lock:
            self.stats["jobs"] += 1
            self.stats["prompt_tokens"] += len(job.prompt)

    def _failed(self, job: "_Job") -> Exception:
        with self._lock:
            self.stats["errors"] += 1
        self.flightrec.record("prefill_error", error=str(job.error)[:200])
        return job.error

    def prefill(self, tokens: Sequence[int], temperature: float, seed: int,
                timeout: float = PREFILL_TIMEOUT_S) -> bytes:
        """One whole-prompt prefill's HANDOFF envelope.  Raises on an
        engine failure or a timeout — the HTTP shell maps those to error
        responses, and the decode side fails (or retries) that one
        request."""
        from paddle_operator_tpu_torch.utils import fleetkv as FK

        job = self._submit(tokens, temperature, seed)
        if not job.done.wait(timeout):
            self.flightrec.record("prefill_timeout", tokens=len(job.prompt))
            self._timeout(job, timeout)
        if job.error is not None:
            raise self._failed(job)
        arrays, _, n_blocks, first, _ = job.result
        self._account(job)
        meta = {"first": first, "promptLen": len(job.prompt),
                "nBlocks": int(n_blocks), "fingerprint": self.fingerprint()}
        return FK.encode_handoff(meta, arrays)

    def prefill_stream(self, tokens: Sequence[int], temperature: float,
                       seed: int, timeout: float = PREFILL_TIMEOUT_S):
        """A STREAMED prefill: yield length-prefixed wire frames —
        completed block groups as they finish, then the terminal frame
        (remaining blocks, staging tail, first token, fingerprint) — so
        the decode side's upload and the wire overlap the remaining
        prefill.  Raises a timeout or an engine error BEFORE the first
        yield (mapped to HTTP statuses); after the first frame the
        handler can only drop the connection, which the client refuses
        wholesale."""
        from paddle_operator_tpu_torch.utils import fleetkv as FK

        job = self._submit(tokens, temperature, seed,
                           wants_frames=self.lanes > 1)
        seq = 0
        if job.frames is not None:
            deadline = time.monotonic() + timeout
            while True:
                try:
                    item = job.frames.get(
                        timeout=max(0.0, deadline - time.monotonic()))
                except queue.Empty:
                    self._timeout(job, timeout)
                if item[0] == "error":
                    raise self._failed(job)
                if item[0] == "final":
                    break
                _, j0, arrays = item
                yield FK.encode_handoff_frame(seq, j0, arrays)
                seq += 1
        else:
            # the 1-lane oracle engine has no frames: one terminal frame
            # carries the whole handoff (a valid 1-frame stream)
            if not job.done.wait(timeout):
                self._timeout(job, timeout)
            if job.error is not None:
                raise self._failed(job)
        arrays, j0, n_blocks, first, t_done = job.result
        self._account(job)
        yield FK.encode_handoff_final(
            {"seq": seq, "nFrames": seq + 1, "j0": int(j0),
             "first": int(first), "promptLen": len(job.prompt),
             "nBlocks": int(n_blocks), "fingerprint": self.fingerprint(),
             "tDone": float(t_done)}, arrays)

    # -- status -----------------------------------------------------------------

    def serving_status(self) -> Dict[str, Any]:
        """The prefill pod's status block, the JAX pod's keys: ``role:
        "prefill"`` is what the router's fleet fold keys on (a pool that
        never decodes must not skew the fleet's tok/s or hit rates);
        ``tokensPerSec`` here is PREFILL tokens/s."""
        elapsed = max(1e-9, time.monotonic() - self._t_start)
        with self._lock:
            return {
                "role": "prefill",
                "prefillQueueDepth": self._depth,
                "prefillMsAvg": round(self.prefill_ms_avg, 3),
                "tokensPerSec": round(
                    self.stats["prompt_tokens"] / elapsed, 2),
                "tokensTotal": self.stats["prompt_tokens"],
                "prefillJobs": self.stats["jobs"],
                "prefillErrors": self.stats["errors"],
                "refusedHandoffs": self.stats["refused"],
                "prefillLanes": self.lanes,
                "prefillBatchOccupancy": self.exec.batch_occupancy(),
                "prefillHolWaitMs": self.exec.hol_wait_ms_p95(),
                "prefillPrefixHits": self.exec.prefix_hits,
                "draining": self.draining,
            }

    def metrics_text(self, job: str, replica: str) -> str:
        """Prometheus exposition for the router's scrape — the fleet
        gauge NAMES (queue depth under mode="remote", tok/s, draining)
        plus the prefill-only ones, so one scrape parser serves both
        pools."""
        st = self.serving_status()
        rep = f',replica="{replica}"' if replica else ""
        lbl = f'{{job="{job}"{rep}}}'
        lines = [
            (f'tpujob_serve_prefill_queue_depth{{job="{job}"{rep},'
             f'mode="remote"}} {float(st["prefillQueueDepth"])}'),
            f'tpujob_serve_prefill_ms_avg{lbl} '
            f'{float(st["prefillMsAvg"])}',
            f'tpujob_serve_prefill_jobs_total{lbl} '
            f'{float(st["prefillJobs"])}',
            f'tpujob_serve_tokens_per_sec{lbl} '
            f'{float(st["tokensPerSec"])}',
            f'tpujob_serve_prefill_lanes{lbl} '
            f'{float(st["prefillLanes"])}',
            f'tpujob_serve_prefill_batch_occupancy{lbl} '
            f'{float(st["prefillBatchOccupancy"])}',
            f'tpujob_serve_prefill_hol_wait_ms{lbl} '
            f'{float(st["prefillHolWaitMs"])}',
            f'tpujob_serve_draining{lbl} '
            f'{1.0 if st["draining"] else 0.0}',
        ]
        return "\n".join(lines) + "\n"

    def close(self) -> None:
        self._stop.set()
        self.exec.close()
        self._matcher.join(timeout=10)


class _PrefillHandler(BaseHTTPRequestHandler):
    frontend: PrefillFrontend    # injected
    job_key = "local"
    replica_id = ""
    protocol_version = "HTTP/1.1"
    timeout = 120

    def log_message(self, *a):
        pass

    def _send_json(self, code: int, obj, headers=None) -> None:
        body = json.dumps(obj).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        fe = self.frontend
        if self.path == "/healthz":
            self._send_json(200, {"ok": True})
        elif self.path == "/readyz":
            if fe.draining:
                self._send_json(503, {"ready": False, "reason": "draining"},
                                headers={"Retry-After": 5})
            else:
                self._send_json(200, {"ready": True})
        elif self.path == "/statusz":
            st = fe.serving_status()
            if self.replica_id:
                st["replica"] = self.replica_id
            self._send_json(200, st)
        elif self.path == "/metrics":
            body = fe.metrics_text(self.job_key, self.replica_id).encode()
            self.send_response(200)
            self.send_header("Content-Type", "text/plain; version=0.0.4")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        elif self.path == "/debug/flightrec":
            self._send_json(200, fe.flightrec.dump("debug_endpoint"))
        else:
            self._send_json(404, {})

    def do_POST(self):
        from paddle_operator_tpu_torch.utils.fleetkv import (
            EnvelopeError,
            check_fingerprint,
        )

        n = int(self.headers.get("Content-Length", 0))
        body = self.rfile.read(n) if n else b""
        if self.path != "/v1/prefill":
            self._send_json(404, {})
            return
        fe = self.frontend
        if fe.draining:
            # refusing handoffs IS the pod's drain protocol: the decode
            # side retries another pod, and jobs in flight finish
            with fe._lock:
                fe.stats["refused"] += 1
            fe.flightrec.record("handoff_refused", reason="draining")
            self._send_json(503, {"error": "draining"},
                            headers={"Retry-After": 2})
            return
        try:
            req = json.loads(body)
            tokens = [int(t) for t in req["tokens"]]
            if not tokens:
                raise ValueError("empty prompt")
            theirs = req.get("fingerprint")
            if theirs is not None:
                check_fingerprint({"fingerprint": theirs}, fe.fingerprint())
        except EnvelopeError as e:
            self._send_json(409, {"error": str(e)})
            return
        except (ValueError, KeyError, TypeError,
                json.JSONDecodeError) as e:
            self._send_json(400, {"error": str(e)})
            return
        if req.get("stream"):
            return self._stream_prefill(fe, req, tokens)
        try:
            buf = fe.prefill(tokens, float(req.get("temperature", 0.0)),
                             int(req.get("seed", 0)))
        except TimeoutError as e:
            # overload (a backlogged pod), not a defect of the prompt:
            # 503 like draining, so the decode side walks on
            self._send_json(503, {"error": str(e)},
                            headers={"Retry-After": 2})
            return
        except Exception as e:      # noqa: BLE001 — isolate per job
            # a deterministic per-prompt failure: NOT retriable — the
            # decode side fails that one request
            self._send_json(500, {"error": str(e)})
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(buf)))
        self.end_headers()
        self.wfile.write(buf)

    def _stream_prefill(self, fe, req, tokens) -> None:
        """``"stream": true``: chunked transfer of length-prefixed
        handoff frames as block groups complete.  Errors BEFORE the
        first frame map to HTTP statuses as on the whole-envelope path;
        after it the only honest signal is dropping the connection,
        which the receiver refuses wholesale (per-frame CRC and the
        terminal frame's count make a partial stream unusable)."""
        gen = fe.prefill_stream(tokens, float(req.get("temperature", 0.0)),
                                int(req.get("seed", 0)))
        try:
            first_frame = next(gen)
        except TimeoutError as e:
            self._send_json(503, {"error": str(e)},
                            headers={"Retry-After": 2})
            return
        except StopIteration:
            self._send_json(500, {"error": "empty handoff stream"})
            return
        except Exception as e:      # noqa: BLE001
            self._send_json(500, {"error": str(e)})
            return
        try:
            self.send_response(200)
            self.send_header("Content-Type", "application/octet-stream")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()

            def emit(wire: bytes) -> None:
                self.wfile.write(f"{len(wire):x}\r\n".encode() + wire
                                 + b"\r\n")
                self.wfile.flush()

            emit(first_frame)
            for wire in gen:
                emit(wire)
            self.wfile.write(b"0\r\n\r\n")
        except OSError:
            return      # the client went away mid-stream
        except Exception:   # noqa: BLE001 — the engine died mid-stream
            # drop the connection: the receiver sees a truncated frame
            # and refuses the whole stream
            try:
                self.wfile.flush()
            except OSError:
                pass
            self.close_connection = True


def make_prefill_server(host: str, port: int, params: Any, cfg, *,
                        block_size: int = 256,
                        max_len: Optional[int] = None,
                        buckets: Tuple[int, ...] = (),
                        top_k: Optional[int] = None,
                        top_p: Optional[float] = None,
                        kv_quant: str = "none", job: str = "local",
                        replica: str = "", lanes: int = 1,
                        prefill_chunk: int = 64, prefix_blocks: int = 0,
                        generation: int = 0) -> ThreadingHTTPServer:
    """The HTTP shell around a :class:`PrefillFrontend` on the params'
    device.  The returned server carries ``.frontend`` — close it when
    tearing down."""
    fe = PrefillFrontend(params, cfg, block_size=block_size,
                         max_len=max_len or cfg.max_seq_len,
                         buckets=buckets, top_k=top_k, top_p=top_p,
                         kv_quant=kv_quant, lanes=lanes,
                         prefill_chunk=prefill_chunk,
                         prefix_blocks=prefix_blocks, generation=generation)
    handler = type("PrefillHandler", (_PrefillHandler,),
                   {"frontend": fe, "job_key": job, "replica_id": replica})
    srv = ThreadingHTTPServer((host, port), handler)
    srv.frontend = fe
    return srv


# ---------------------------------------------------------------------------
# Decode-side client: the network stand-in for the in-process engine
# ---------------------------------------------------------------------------


class RemotePrefillClient:
    """The decode replica's prefill-pool client — the in-process
    ``PrefillExecutor``'s seam (``submit(req, slot)`` / ``results``),
    marked ``remote = True`` so the handoff drain lands host payloads
    through the promote scatter.

    POSTs run on worker threads, never the ring thread.  ``broker`` (the
    fleet router, which forwards ``/v1/prefill`` to the least-loaded
    ready prefill pod) is preferred; static ``peers`` are the
    router-less fallback.  Prefill is side-effect-free, so every failure
    mode retries freely: connection errors, 503 (a draining pod) and 409
    (a pod of another generation mid-roll) walk to the next attempt; a
    deterministic 4xx/5xx fails the request.  Exhausted attempts post a
    retriable error: the request 503s and the client's fleet-level
    retry re-routes it.  ``pin`` (set by a ring on the card): payloads
    are page-locked here, on the worker, so the ring's upload leaves
    from pinned memory without a copy on the ring's thread."""

    remote = True

    def __init__(self, broker: str = "", peers: Sequence[str] = (), *,
                 timeout: float = PREFILL_TIMEOUT_S, workers: int = 2,
                 max_attempts: int = 4, backoff_s: float = 0.2,
                 stream: bool = False) -> None:
        self.broker = broker.strip().rstrip("/")
        self.peers = [p.strip() for p in peers if p.strip()]
        if not self.broker and not self.peers:
            raise ValueError("remote prefill needs a broker or peers")
        self.timeout = timeout
        self.max_attempts = max_attempts
        self.backoff_s = backoff_s
        # streamed handoff: frames post to the scheduler as they arrive
        # off the wire, so the upload overlaps the pod's remaining
        # prefill and the transfer
        self.stream = bool(stream)
        self.pin = False
        # the ring's handoff fingerprint — stamped by the scheduler
        self.fingerprint: Optional[Dict[str, Any]] = None
        self.jobs: "queue.Queue[tuple]" = queue.Queue()
        self.results: "queue.Queue[tuple]" = queue.Queue()
        self.stats = {"posted": 0, "retries": 0, "failed": 0,
                      # streams refused WHOLESALE: a mid-stream pod death,
                      # truncated / CRC-bad / out-of-order frames (each
                      # walked to the next candidate)
                      "refused_streams": 0}
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"remote-prefill-{i}")
            for i in range(max(1, int(workers)))]
        for t in self._threads:
            t.start()

    def submit(self, req, slot: int) -> None:
        self.jobs.put((req, slot))

    def _targets(self) -> list:
        if self.broker:
            return [self.broker] * self.max_attempts
        reps = -(-self.max_attempts // len(self.peers))
        return (self.peers * reps)[:self.max_attempts]

    def _host(self, arrays: Dict[str, torch.Tensor]
              ) -> Dict[str, torch.Tensor]:
        if not self.pin:
            return arrays
        return {key: t.pin_memory() for key, t in arrays.items()}

    def _worker(self) -> None:
        while not self._stop.is_set():
            try:
                req, slot = self.jobs.get(timeout=0.05)
            except queue.Empty:
                continue
            if req.done.is_set() or req._cancel:
                continue            # resolved while queued: drop
            try:
                outcome = self._post_job(req, slot)
            except Exception as e:  # noqa: BLE001 — fail this request only
                # an unexpected failure (a host allocation, a decode)
                # fails the one request: a worker that died here would
                # leave the lane waiting for a handoff forever
                outcome = (req, slot, e)
            if outcome != "done":   # a streamed final is already posted
                self.results.put(outcome)

    def _post_job(self, req, slot: int):
        """One job's POSTs: ``"done"`` (a streamed final posted), or the
        outcome tuple to post — a result or ``(req, slot, error)``."""
        from paddle_operator_tpu_torch.infer.resilience import RetriableError
        from paddle_operator_tpu_torch.utils import fleetkv as FK

        body = json.dumps({
            "tokens": [int(t) for t in req.prompt],
            "temperature": float(req.temperature),
            "seed": int(req.seed),
            "requestId": getattr(req, "request_id", None),
            "fingerprint": self.fingerprint,
            "stream": self.stream,
        }).encode()
        outcome = None
        t_wire0 = time.monotonic()
        if self.stream:
            for i, ep in enumerate(self._targets()):
                if req.done.is_set() or req._cancel:
                    break           # resolved meanwhile: stop POSTing
                if i:
                    self.stats["retries"] += 1
                    time.sleep(FK.backoff_delay(
                        i - 1, base_s=self.backoff_s, max_s=1.0))
                res = self._stream_attempt(ep, body, req, slot)
                if res == "next":
                    continue
                if res == "done":
                    self._wire_span(req, t_wire0, ep, i, stream=True)
                outcome = res
                break
        else:
            # the whole walk — connection errors, 503 and 409 retry to
            # the next candidate with jittered backoff — is the shared
            # bounded-retry helper
            attempts = [0]

            def _on_retry(ep, i):
                attempts[0] = i + 1
                self.stats["retries"] += 1

            code, raw, used = FK.http_post_retry(
                [self.broker] if self.broker else self.peers,
                "/v1/prefill", body, content_type="application/json",
                timeout=self.timeout, max_attempts=self.max_attempts,
                backoff_base_s=self.backoff_s, backoff_max_s=1.0,
                retry_statuses=(503, 409), on_retry=_on_retry,
                abort=lambda: req.done.is_set() or req._cancel)
            if used is not None and code not in (0, 503, 409):
                if code != 200:
                    try:
                        msg = json.loads(raw).get("error", raw[:120])
                    except Exception:   # noqa: BLE001
                        msg = raw[:120]
                    outcome = (req, slot, RuntimeError(
                        f"remote prefill rejected ({code}): {msg}"))
                else:
                    try:
                        meta, arrays = FK.decode_handoff(raw)
                        if self.fingerprint is not None:
                            FK.check_fingerprint(meta, self.fingerprint)
                        self.stats["posted"] += 1
                        self._wire_span(req, t_wire0, used, attempts[0],
                                        stream=False)
                        outcome = ("final", req, slot, self._host(arrays),
                                   None, 0, int(meta["nBlocks"]),
                                   int(meta["first"]), time.monotonic())
                    except FK.EnvelopeError as e:
                        outcome = (req, slot, e)
        if outcome is None:
            self.stats["failed"] += 1
            outcome = (req, slot, RetriableError(
                "no prefill pod accepted the handoff "
                f"({self.max_attempts} attempts); retry"))
        return outcome

    @staticmethod
    def _wire_span(req, t0: float, ep: str, attempts: int,
                   stream: bool) -> None:
        """The remote handoff's wire span: POST to the decoded envelope
        (streamed: to the terminal frame), stamped from this worker
        thread onto the request's trace (thread-safe).  It covers the
        pod's queue, its prefill and the transfer; the pod's
        ``prefillMsAvg`` gauge splits out the compute."""
        tr = getattr(req, "trace", None)
        if tr is not None:
            tr.add("remote_prefill", t0, target=ep, attempts=attempts + 1,
                   stream=stream)

    def _stream_attempt(self, ep: str, body: bytes, req, slot: int):
        """One STREAMED attempt against ``ep``: frames post to the
        scheduler AS THEY ARRIVE; the terminal frame posts the remainder
        and the first token.  Returns ``"done"`` (final posted),
        ``"next"`` (retry another candidate: 503, 409, a connection
        failure, a mid-stream death or a truncated / CRC-bad /
        out-of-order frame, all refused wholesale — frames already
        uploaded are overwritten by the retry, idempotently), or a
        terminal error outcome (a deterministic rejection)."""
        from http.client import HTTPConnection, HTTPException

        from paddle_operator_tpu_torch.utils import fleetkv as FK

        host, _, port = ep.rpartition(":")
        conn = HTTPConnection(host, int(port), timeout=self.timeout)
        streaming = False       # past the 200: a failure is a broken stream
        try:
            # one stream a connection, torn down by the server after the
            # terminal frame
            conn.request("POST", "/v1/prefill", body=body,
                         headers={"Content-Type": "application/json",
                                  "Connection": "close"})
            resp = conn.getresponse()
            if resp.status in (503, 409):
                resp.read()
                return "next"
            if resp.status != 200:
                raw = resp.read()
                try:
                    msg = json.loads(raw).get("error", raw[:120])
                except Exception:   # noqa: BLE001
                    msg = raw[:120]
                return (req, slot, RuntimeError(
                    f"remote prefill rejected ({resp.status}): {msg}"))
            streaming = True
            seq = 0
            while True:
                buf = FK.read_wire_frame(resp.read)
                if buf is None:
                    raise FK.EnvelopeError(
                        "handoff stream ended before its terminal frame")
                kind, meta, arrays = FK.decode_handoff_frame(buf, seq)
                if kind == FK.FRAME_KIND:
                    width = arrays["k"].shape[1]
                    self.results.put(
                        ("frame", req, slot, self._host(arrays), None,
                         int(meta["j0"]), int(meta["j0"]) + width))
                    seq += 1
                    continue
                if self.fingerprint is not None:
                    FK.check_fingerprint(meta, self.fingerprint)
                self.stats["posted"] += 1
                self.results.put(
                    ("final", req, slot, self._host(arrays), None,
                     int(meta["j0"]), int(meta["nBlocks"]),
                     int(meta["first"]), time.monotonic()))
                return "done"
        except FK.EnvelopeError:
            self.stats["refused_streams"] += 1
            return "next"
        except (OSError, ValueError, HTTPException):
            # refused or reset, or the pod died mid-chunk: a started
            # stream refuses wholesale either way; retry elsewhere
            if streaming:
                self.stats["refused_streams"] += 1
            return "next"
        finally:
            conn.close()

    def close(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5)


def remote_prefill_client_from_env(environ=None
                                   ) -> Optional[RemotePrefillClient]:
    """serve.py wiring: SERVE_PREFILL_REMOTE=1 (with SERVE_PREFILL=disagg)
    moves cold prefills to the prefill POOL — SERVE_PREFILL_BROKER names
    the router (it forwards to the least-loaded ready prefill pod),
    SERVE_PREFILL_PEERS is the router-less static list,
    SERVE_PREFILL_STREAM=1 consumes the pool's streamed frames.  With
    TPUJOB_WIRE_CHAOS scheduling faults on the ``decode-prefill`` edge,
    the endpoints are replaced by an injured in-process proxy
    (utils/wirechaos.py).  Returns None when remote prefill is off."""
    import os

    from paddle_operator_tpu_torch.utils import wirechaos as WC

    environ = os.environ if environ is None else environ
    if environ.get("SERVE_PREFILL_REMOTE", "0") != "1":
        return None
    broker = environ.get("SERVE_PREFILL_BROKER", "")
    peers = [p for p in environ.get("SERVE_PREFILL_PEERS", "").split(",")
             if p.strip()]
    if not broker and not peers:
        print("SERVE_PREFILL_REMOTE=1 ignored: set SERVE_PREFILL_BROKER "
              "or SERVE_PREFILL_PEERS", flush=True)
        return None
    broker = WC.wire_endpoint_from_env("decode-prefill", broker,
                                       env=environ)
    peers = [WC.wire_endpoint_from_env("decode-prefill", p, env=environ)
             for p in peers]
    return RemotePrefillClient(
        broker=broker, peers=peers,
        stream=environ.get("SERVE_PREFILL_STREAM", "0") == "1")


def main(argv=None) -> int:
    """Prefill-pod entrypoint (``python -m
    paddle_operator_tpu_torch.infer.prefill_serve [--device cpu]``):
    restore the params as serve.py does, serve /v1/prefill on
    TPUJOB_PORT, drain on SIGTERM by refusing new handoffs and finishing
    the jobs in flight, exit EXIT_PREEMPTED."""
    import argparse
    import os

    from paddle_operator_tpu_torch.ft.preemption import (
        EXIT_PREEMPTED,
        PreemptionWatcher,
    )
    from paddle_operator_tpu_torch.infer.serve import (
        load_serving_params,
        quantize_from_env,
    )
    from paddle_operator_tpu_torch.launch.launcher import JobEnv
    from paddle_operator_tpu_torch.models.llama import CONFIGS

    ap = argparse.ArgumentParser(prog="prefill_serve")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise RuntimeError("the prefill pod runs on a CUDA card and found "
                           "none (pass --device cpu to run on the CPU)")
    env = JobEnv.from_env()
    if int(os.environ.get("SERVE_TP", "1") or 1) > 1:
        raise ValueError(f"SERVE_TP={os.environ['SERVE_TP']} (tensor "
                         "parallelism) is not ported to the torch package "
                         "yet (ROADMAP.md Queue A)")
    preset = os.environ.get("MODEL_PRESET", "7b")
    params, cfg, resumed = load_serving_params(
        env.checkpoint_path, CONFIGS[preset], args.device)
    # match the decode fleet's weight quantization: handed-off KV is a
    # function of the weights that produced it (the fingerprint refuses
    # a skew regardless)
    wq = quantize_from_env(params, cfg, os.environ)
    max_len = int(os.environ.get("SERVE_MAX_LEN", "0")) or cfg.max_seq_len
    kv_quant = os.environ.get("SERVE_KV_QUANT", "none") or "none"
    lanes = int(os.environ.get("SERVE_PREFILL_LANES", "1") or 1)
    srv = make_prefill_server(
        "0.0.0.0", env.port, params, cfg,
        block_size=int(os.environ.get("SERVE_BLOCK_SIZE", "256")),
        max_len=max_len, kv_quant=kv_quant,
        job=os.environ.get("TPUJOB_NAME", "local"),
        replica=os.environ.get("TPUJOB_REPLICA_ID", ""), lanes=lanes,
        prefill_chunk=int(os.environ.get("SERVE_PREFILL_CHUNK", "64")
                          or 64),
        prefix_blocks=int(os.environ.get("SERVE_PREFILL_PREFIX_BLOCKS",
                                         "256") or 0),
        generation=int(os.environ.get("SERVE_GENERATION", "0") or 0))
    srv.frontend.exec.warm()
    print(f"prefill pool {preset} (resumed={resumed}, kv_quant={kv_quant}, "
          f"weight_quant={wq}, lanes={lanes}, max_len={max_len}, "
          f"device={args.device}) on :{env.port}", flush=True)
    budget = float(os.environ.get("SERVE_DRAIN_BUDGET_S", "30"))
    code = [0]

    def drain(reason: str) -> None:
        fe = srv.frontend
        fe.flightrec.record("drain_start", reason=str(reason))
        fe.flightrec.dump_file("sigterm")
        fe.draining = True          # /readyz false, new prefills 503
        deadline = time.monotonic() + budget
        while fe.depth() > 0 and time.monotonic() < deadline:
            time.sleep(0.05)        # jobs in flight finish and flush
        time.sleep(0.2)             # their responses leave the socket
        code[0] = EXIT_PREEMPTED
        srv.shutdown()

    watcher = PreemptionWatcher.install()
    watcher.on_drain(lambda reason: threading.Thread(
        target=drain, args=(reason,), daemon=True).start())
    srv.serve_forever()
    srv.frontend.close()
    return code[0]


if __name__ == "__main__":
    raise SystemExit(main())
