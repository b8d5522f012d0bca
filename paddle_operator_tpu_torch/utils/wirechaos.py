"""Deterministic wire-fault proxy for fleet edges — the port's own copy
of ``paddle_operator_tpu/utils/wirechaos.py`` (host-only: sockets and
threads, no array library), so the port's decode replica serves
``TPUJOB_WIRE_CHAOS`` on its decode->prefill edge without importing the
JAX package.

``infer/chaos.py`` injects faults at ring **dispatch indices**; this
module injures the wires the fleet runs on: a seeded HTTP proxy that
sits on any fleet edge and injures traffic at deterministic **request
indices**.

Edges (the names double as schedule keys)::

    client-router    production client  -> fleet router
    router-replica   fleet router       -> decode replica
    replica-broker   decode replica     -> router broker (/v1/kv/*)
    decode-prefill   decode replica     -> prefill pod
    replica-store    decode replica     -> durable prefix store front

Fault kinds (applied to POSTs only — GETs, i.e. /readyz and /metrics
scrapes, always relay transparently so fault indices stay pinned to
the *work* stream, independent of scrape timing)::

    drop        read half the request body, then close the socket —
                the request never reaches the upstream (connection
                drop mid-body; client sees a reset and retries)
    truncate    relay the response but cut the body to one third
                (min 8 bytes) and close without the chunked
                terminator — mid-stream death
    corrupt     flip one byte of the response payload (position
                drawn from the seeded rng)
    dup         deliver the request to the upstream TWICE; relay the
                second response — duplicate delivery, the edge's
                idempotency (router dedupe / broker migration replay /
                side-effect-free prefill) is what keeps it correct
    burst503    answer ``503`` + ``Retry-After: 1`` without contacting
                the upstream; ``arg`` = burst length in consecutive
                POSTs (default 1)
    blackhole   accept the request, then hang ``arg`` seconds
                (default 30) and close without a response — the fault
                the router's circuit breaker exists for
    trickle     relay the response byte-identically but spread over
                ``arg`` seconds (default 1.0) in small chunks

Schedules mirror ``TPUJOB_CHAOS``: ``kind@index[:arg]`` atoms, comma
separated, grouped per edge with ``edge=...`` and ``;`` between edges::

    TPUJOB_WIRE_CHAOS="client-router=drop@2,burst503@5:3;router-replica=blackhole@4:6"
    TPUJOB_WIRE_CHAOS_SEED=7

``index`` is the Nth POST (0-based) through that proxy.  Unknown kinds
and unknown edge names raise ``ValueError`` — a typo'd schedule that
silently injected nothing would fake a green chaos gate.  Every fault
is counted per edge and pinned in ``fired`` so tests assert exactly
what was injected (``tpujob_wirechaos_*`` counters,
docs/observability.md).

Fault-free traffic through a proxy is byte-identical to the direct
path — the serve-wirechaos gate pins this with a byte-compare, so the
proxy can be left installed on a production edge at zero risk.

Standalone (so an edge of a real deployment can be injured without
touching either endpoint)::

    python -m paddle_operator_tpu_torch.utils.wirechaos client-router 127.0.0.1:8800 --port 8899
"""
from __future__ import annotations

import json
import os
import socket
import threading
import time
from dataclasses import dataclass, field
from http.client import HTTPConnection
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from random import Random
from typing import Dict, List, Optional, Tuple

WIRE_CHAOS_ENV = "TPUJOB_WIRE_CHAOS"
WIRE_CHAOS_SEED_ENV = "TPUJOB_WIRE_CHAOS_SEED"

EDGES = ("client-router", "router-replica", "replica-broker",
         "decode-prefill", "replica-store")

KINDS = ("drop", "truncate", "corrupt", "dup", "burst503", "blackhole",
         "trickle")


@dataclass(frozen=True)
class WireEvent:
    kind: str
    at: int                     # Nth POST through the edge, 0-based
    arg: float = 0.0


def parse_schedule(spec: str) -> Dict[str, List[WireEvent]]:
    """``edge=kind@index[:arg],...[;edge=...]`` -> events per edge.

    Raises ``ValueError`` on unknown edges or kinds — same discipline
    as ``chaos.parse_schedule``: a schedule that silently matches
    nothing would fake a green gate.
    """
    out: Dict[str, List[WireEvent]] = {}
    for group in spec.split(";"):
        group = group.strip()
        if not group:
            continue
        edge, eq, atoms = group.partition("=")
        edge = edge.strip()
        if not eq:
            raise ValueError(
                f"wirechaos group {group!r} missing 'edge=' prefix")
        if edge not in EDGES:
            raise ValueError(
                f"unknown wirechaos edge {edge!r} (known: {EDGES})")
        events = out.setdefault(edge, [])
        for atom in atoms.split(","):
            atom = atom.strip()
            if not atom:
                continue
            kind, _, rest = atom.partition("@")
            kind = kind.strip()
            if kind not in KINDS:
                raise ValueError(
                    f"unknown wirechaos kind {kind!r} (known: {KINDS})")
            at_s, _, arg_s = rest.partition(":")
            events.append(WireEvent(kind, int(at_s),
                                    float(arg_s) if arg_s else 0.0))
        events.sort(key=lambda e: e.at)
    return out


# Response headers worth relaying verbatim — Content-Length /
# Transfer-Encoding are recomputed by the relay itself.
_FWD_RESP = ("content-type", "retry-after")


class WireChaosProxy:
    """One injured edge: a threading HTTP proxy in front of
    ``upstream`` (``host:port``) applying ``events`` at deterministic
    POST indices.  ``counters["faults"][kind]`` and ``fired``
    [(kind, index)] are the assertion surface."""

    def __init__(self, upstream: str,
                 events: Optional[List[WireEvent]] = None, *,
                 edge: str = "client-router", seed: int = 0,
                 host: str = "127.0.0.1", port: int = 0,
                 upstream_timeout: float = 120.0) -> None:
        if edge not in EDGES:
            raise ValueError(
                f"unknown wirechaos edge {edge!r} (known: {EDGES})")
        for ev in events or []:
            if ev.kind not in KINDS:
                raise ValueError(f"unknown wirechaos kind {ev.kind!r}")
        self.upstream = upstream.strip().rstrip("/")
        self.edge = edge
        self.rng = Random(seed)
        self.upstream_timeout = upstream_timeout
        self._sched: Dict[int, WireEvent] = {}
        for ev in events or []:
            # one fault per index — first scheduled wins
            self._sched.setdefault(ev.at, ev)
        self._lock = threading.Lock()
        self._idx = 0
        self._burst_left = 0
        self.fired: List[Tuple[str, int]] = []
        self.counters: Dict[str, object] = {
            "requests": 0, "upstream_errors": 0,
            "faults": {k: 0 for k in KINDS}}

        proxy = self

        class _Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *a):            # quiet
                pass

            def do_GET(self):                      # scrapes: transparent
                proxy._relay_get(self)

            def do_POST(self):
                proxy._serve_post(self)

        self._srv = ThreadingHTTPServer((host, port), _Handler)
        self._srv.daemon_threads = True
        self.host = host
        self.port = int(self._srv.server_address[1])
        self.endpoint = f"{self.host}:{self.port}"
        self.url = f"http://{self.endpoint}"
        self._thread: Optional[threading.Thread] = None

    # -- lifecycle ----------------------------------------------------
    def start(self) -> "WireChaosProxy":
        self._thread = threading.Thread(
            target=self._srv.serve_forever,
            name=f"wirechaos-{self.edge}", daemon=True)
        self._thread.start()
        return self

    def close(self) -> None:
        self._srv.shutdown()
        self._srv.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- metrics ------------------------------------------------------
    def metrics_text(self) -> str:
        lines = [f'tpujob_wirechaos_requests_total{{edge="{self.edge}"}}'
                 f' {float(self.counters["requests"])}']
        for kind in KINDS:
            n = self.counters["faults"][kind]
            lines.append(
                f'tpujob_wirechaos_faults_total{{edge="{self.edge}",'
                f'kind="{kind}"}} {float(n)}')
        lines.append(
            f'tpujob_wirechaos_upstream_errors_total'
            f'{{edge="{self.edge}"}}'
            f' {float(self.counters["upstream_errors"])}')
        return "\n".join(lines) + "\n"

    # -- relay internals ----------------------------------------------
    def _conn(self) -> HTTPConnection:
        host, _, port = self.upstream.rpartition(":")
        return HTTPConnection(host, int(port),
                              timeout=self.upstream_timeout)

    @staticmethod
    def _req_headers(h) -> Dict[str, str]:
        out = {}
        for k, v in h.headers.items():
            lk = k.lower()
            if lk == "content-type" or lk.startswith("x-"):
                out[k] = v
        return out

    def _relay_get(self, h) -> None:
        conn = self._conn()
        try:
            conn.request("GET", h.path, headers=self._req_headers(h))
            resp = conn.getresponse()
            body = resp.read()
        except (OSError, socket.timeout):
            with self._lock:
                self.counters["upstream_errors"] += 1
            self._plain(h, 503, b'{"error": "wirechaos: upstream down"}')
            return
        finally:
            conn.close()
        self._respond(h, resp, body)

    def _respond(self, h, resp, body: bytes) -> None:
        """Non-streamed relay of an upstream response."""
        try:
            h.send_response(resp.status)
            for k, v in resp.getheaders():
                if k.lower() in _FWD_RESP or k.lower().startswith("x-"):
                    h.send_header(k, v)
            h.send_header("Content-Length", str(len(body)))
            h.end_headers()
            h.wfile.write(body)
        except (OSError, socket.timeout):
            pass                # client went away mid-write

    def _plain(self, h, status: int, body: bytes,
               retry_after: Optional[str] = None) -> None:
        try:
            h.send_response(status)
            h.send_header("Content-Type", "application/json")
            if retry_after is not None:
                h.send_header("Retry-After", retry_after)
            h.send_header("Content-Length", str(len(body)))
            h.end_headers()
            h.wfile.write(body)
        except (OSError, socket.timeout):
            pass

    def _hang_up(self, h) -> None:
        """Close the client socket abruptly (no HTTP response)."""
        try:
            h.close_connection = True
            h.connection.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            h.connection.close()
        except OSError:
            pass

    # -- the POST path ------------------------------------------------
    def _serve_post(self, h) -> None:
        with self._lock:
            idx = self._idx
            self._idx += 1
            ev = self._sched.get(idx)
            if ev is None and self._burst_left > 0:
                self._burst_left -= 1
                ev = WireEvent("burst503", idx)
            elif ev is not None and ev.kind == "burst503":
                self._burst_left = max(0, int(ev.arg or 1) - 1)
            if ev is not None:
                self.fired.append((ev.kind, idx))
                self.counters["faults"][ev.kind] += 1
            self.counters["requests"] += 1
        kind = ev.kind if ev is not None else None

        clen = int(h.headers.get("Content-Length", "0") or 0)

        if kind == "drop":
            # connection drop mid-body: consume half the upload, reset
            if clen:
                h.rfile.read(max(1, clen // 2))
            self._hang_up(h)
            return
        if kind == "burst503":
            h.rfile.read(clen)
            self._plain(h, 503,
                        b'{"error": "wirechaos: injected 503 burst"}',
                        retry_after="1")
            return
        if kind == "blackhole":
            h.rfile.read(clen)
            time.sleep(ev.arg or 30.0)
            self._hang_up(h)
            return

        body = h.rfile.read(clen)
        headers = self._req_headers(h)

        if kind == "dup":
            # duplicate delivery: the upstream executes twice; relay
            # the SECOND response — dedupe/idempotency must absorb it
            st, raw, hdrs, err = self._post_upstream(h.path, body,
                                                     headers)
            if err:
                self._plain(h, 503,
                            b'{"error": "wirechaos: upstream down"}')
                return
        st, raw, hdrs, err = self._post_upstream(h.path, body, headers)
        if err:
            with self._lock:
                self.counters["upstream_errors"] += 1
            self._plain(h, 503, b'{"error": "wirechaos: upstream down"}')
            return

        if kind == "truncate":
            cut = raw[:max(8, len(raw) // 3)]
            try:
                h.send_response(st)
                for k, v in hdrs:
                    if (k.lower() in _FWD_RESP
                            or k.lower().startswith("x-")):
                        h.send_header(k, v)
                h.send_header("Transfer-Encoding", "chunked")
                h.end_headers()
                h.wfile.write(f"{len(cut):x}\r\n".encode() + cut
                              + b"\r\n")
                h.wfile.flush()
            except (OSError, socket.timeout):
                pass
            self._hang_up(h)    # no terminator: mid-stream death
            return
        if kind == "corrupt" and raw:
            pos = self.rng.randrange(len(raw))
            raw = raw[:pos] + bytes([raw[pos] ^ 0xFF]) + raw[pos + 1:]
        if kind == "trickle":
            total_s = ev.arg or 1.0
            slices = 8
            step = max(1, (len(raw) + slices - 1) // slices) or 1
            try:
                h.send_response(st)
                for k, v in hdrs:
                    if (k.lower() in _FWD_RESP
                            or k.lower().startswith("x-")):
                        h.send_header(k, v)
                h.send_header("Transfer-Encoding", "chunked")
                h.end_headers()
                for i in range(0, max(len(raw), 1), step):
                    piece = raw[i:i + step]
                    if piece:
                        h.wfile.write(f"{len(piece):x}\r\n".encode()
                                      + piece + b"\r\n")
                        h.wfile.flush()
                    time.sleep(total_s / slices)
                h.wfile.write(b"0\r\n\r\n")
            except (OSError, socket.timeout):
                pass
            return

        # fault-free (and corrupt, which is shape-preserving): relay
        # the exact bytes — the gate byte-compares this path
        fake = _FakeResp(st, hdrs)
        self._respond(h, fake, raw)

    def _post_upstream(self, path: str, body: bytes,
                       headers: Dict[str, str]):
        conn = self._conn()
        try:
            conn.request("POST", path, body=body, headers=headers)
            resp = conn.getresponse()
            return resp.status, resp.read(), resp.getheaders(), False
        except (OSError, socket.timeout):
            return 0, b"", [], True
        finally:
            conn.close()


class _FakeResp:
    def __init__(self, status: int, headers) -> None:
        self.status = status
        self._headers = headers

    def getheaders(self):
        return self._headers


# ---------------------------------------------------------------------------
# Env-driven install (mirrors chaos.maybe_install_from_env)
# ---------------------------------------------------------------------------

_ENV_PROXIES: List[WireChaosProxy] = []


def maybe_proxy_from_env(edge: str, upstream: str,
                         env: Optional[Dict[str, str]] = None
                         ) -> Optional[WireChaosProxy]:
    """Start a proxy for ``edge`` in front of ``upstream`` when
    ``TPUJOB_WIRE_CHAOS`` schedules faults on that edge; None
    otherwise.  Raises ``ValueError`` on a malformed schedule."""
    env = os.environ if env is None else env
    spec = env.get(WIRE_CHAOS_ENV, "").strip()
    if not spec:
        return None
    sched = parse_schedule(spec)
    if edge not in sched:
        return None
    seed = int(env.get(WIRE_CHAOS_SEED_ENV, "0") or 0)
    proxy = WireChaosProxy(upstream, sched[edge], edge=edge,
                           seed=seed).start()
    _ENV_PROXIES.append(proxy)
    print(f"wirechaos: edge {edge} injured "
          f"({len(sched[edge])} scheduled fault(s), seed {seed}) — "
          f"{proxy.endpoint} -> {upstream}", flush=True)
    return proxy


def wire_endpoint_from_env(edge: str, upstream: str,
                           env: Optional[Dict[str, str]] = None) -> str:
    """Endpoint indirection for callers that only hold a ``host:port``
    string: returns the injured proxy endpoint when the env schedules
    this edge, the upstream unchanged otherwise."""
    if not upstream:
        return upstream
    proxy = maybe_proxy_from_env(edge, upstream, env=env)
    return proxy.endpoint if proxy is not None else upstream


def env_proxies() -> List[WireChaosProxy]:
    return list(_ENV_PROXIES)


def close_env_proxies() -> None:
    while _ENV_PROXIES:
        _ENV_PROXIES.pop().close()


# ---------------------------------------------------------------------------
# Standalone CLI — injure an edge of a live deployment
# ---------------------------------------------------------------------------

def main(argv: Optional[List[str]] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="wirechaos: deterministic wire-fault proxy")
    ap.add_argument("edge", choices=EDGES)
    ap.add_argument("upstream", help="host:port to front")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--schedule", default=None,
                    help=f"kind@index[:arg],... (default: the {edge_env()}"
                         " entry for this edge)")
    ap.add_argument("--seed", type=int, default=None)
    args = ap.parse_args(argv)

    if args.schedule is not None:
        events = parse_schedule(f"{args.edge}={args.schedule}"
                                ).get(args.edge, [])
    else:
        spec = os.environ.get(WIRE_CHAOS_ENV, "")
        events = parse_schedule(spec).get(args.edge, []) if spec else []
    seed = (args.seed if args.seed is not None
            else int(os.environ.get(WIRE_CHAOS_SEED_ENV, "0") or 0))
    proxy = WireChaosProxy(args.upstream, events, edge=args.edge,
                           seed=seed, host=args.host, port=args.port)
    print(f"wirechaos proxy [{args.edge}] listening on "
          f"{proxy.endpoint} -> {args.upstream} "
          f"({len(events)} scheduled fault(s), seed {seed})", flush=True)
    try:
        proxy._srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        proxy._srv.server_close()
        print(proxy.metrics_text(), flush=True)
    return 0


def edge_env() -> str:
    return WIRE_CHAOS_ENV


if __name__ == "__main__":
    raise SystemExit(main())
