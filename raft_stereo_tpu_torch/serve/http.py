"""Stdlib-only HTTP front for :class:`StereoServer` (the port of
``raft_stereo_tpu/serve/http.py``; ``python -m raft_stereo_tpu_torch.serve``).

``http.server.ThreadingHTTPServer``: one thread a connection, each blocking
on its request's :class:`ResultHandle` while the scheduler batches across
connections. Endpoints, status codes, headers and bodies are the JAX
package's:

* ``POST /v1/predict`` — an ``.npz`` body with ``left``/``right`` HWC
  arrays; optional query arguments ``iters``, ``stream``, ``warm=1``. An
  optional ``traceparent`` header (obs/fleet.py's
  ``00-<trace_id>-<span_id>-01``) parents the server's queue_wait /
  collect_group / dispatch / retire spans under the client's span, and is
  echoed back. 200 → an ``.npz`` with ``flow`` (H, W, 1) and the request's
  metadata in headers; 422 → the request retired as an error (a poisoned
  input); 503 → draining, or the queue full (backpressure). One client's
  422 never touches another's 200.
* ``GET /healthz`` — scheduler liveness and counters (JSON); 503 once
  draining, so a load balancer stops routing here during shutdown.
* ``GET /slo`` — the SLOTracker rollup (p50/p99/pairs_per_sec) as JSON.
* ``GET /metrics`` — the same rollup as Prometheus text (``raft_serve_*``
  gauges and counters); off with ``make_http_server(..., metrics=False)``
  / ``--no_metrics``.

SIGTERM/SIGINT drain through training/resilience.SignalGuard (stop
admitting, finish every admitted request, exit 0); SIGHUP reloads the
newest manifest-valid checkpoint (serve/__main__.py).
"""

from __future__ import annotations

import io
import json
import logging
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from raft_stereo_tpu_torch.obs.fleet import parse_traceparent
from raft_stereo_tpu_torch.serve.server import (ServerBusy, ServerDraining,
                                                StereoServer)

logger = logging.getLogger(__name__)


def _json_bytes(payload) -> bytes:
    return (json.dumps(payload, sort_keys=True) + "\n").encode()


# stats() key -> (prometheus metric name, type). Counters are monotone
# process-lifetime totals (SLOTracker counters); everything else is a
# point-in-time gauge.
_PROM_METRICS = (
    ("p50_ms", "raft_serve_latency_p50_ms", "gauge",
     "Rolling-window p50 end-to-end latency (ms)"),
    ("p99_ms", "raft_serve_latency_p99_ms", "gauge",
     "Rolling-window p99 end-to-end latency (ms)"),
    ("pairs_per_sec", "raft_serve_pairs_per_sec", "gauge",
     "Sustained throughput over the SLO sample window"),
    ("in_flight", "raft_serve_in_flight", "gauge",
     "Device dispatches currently in flight"),
    ("queue_depth", "raft_serve_queue_depth", "gauge",
     "Requests admitted but not yet collected into a batch"),
    ("window_requests", "raft_serve_window_requests", "gauge",
     "Retirements inside the current SLO sample window"),
    ("draining", "raft_serve_draining", "gauge",
     "1 once admission closed for shutdown"),
    ("executables", "raft_serve_executables", "gauge",
     "Compiled bucket programs resident in the cache"),
    ("sessions", "raft_serve_sessions", "gauge",
     "Live warm-start video sessions"),
    ("admitted", "raft_serve_requests_admitted_total", "counter",
     "Requests admitted past the bounded queue"),
    ("completed", "raft_serve_requests_completed_total", "counter",
     "Requests retired ok"),
    ("failed", "raft_serve_requests_failed_total", "counter",
     "Requests retired as errors (poisoned output / dispatch failure)"),
    ("rejected", "raft_serve_requests_rejected_total", "counter",
     "Submits shed by backpressure or drain"),
)


# per-bucket quality gauges (stats()["quality"], present when the server
# runs with the convergence aux): rendered with a bucket label — the one
# labeled metric family, so a scrape can alert on quality drift per shape
# bucket (e.g. after a hot reload) without parsing the JSON rollup.
_PROM_QUALITY = (
    ("final_residual_p50", "raft_serve_final_residual_p50",
     "Rolling p50 of the last-iteration mean |delta disparity| (px)"),
    ("final_residual_p95", "raft_serve_final_residual_p95",
     "Rolling p95 of the last-iteration mean |delta disparity| (px)"),
    ("n", "raft_serve_quality_window_requests",
     "Requests inside the rolling quality window"),
)


# per-bucket adaptive iteration gauges (stats()["iters"], present when
# requests ride the compiled early-exit flavors, ``cli serve
# --iter_policy``): rolling iters_taken percentiles per shape bucket —
# the scrapeable evidence that the recorded policy is actually saving
# iterations in production (and, against raft_serve_final_residual_*,
# that quality holds).
_PROM_ITERS = (
    ("iters_taken_p50", "raft_serve_iters_taken_p50",
     "Rolling p50 of refinement iterations applied per request"),
    ("iters_taken_p95", "raft_serve_iters_taken_p95",
     "Rolling p95 of refinement iterations applied per request"),
    ("iters_taken_mean", "raft_serve_iters_taken_mean",
     "Rolling mean of refinement iterations applied per request"),
    ("n", "raft_serve_iters_window_requests",
     "Requests inside the rolling iters_taken window"),
)


# per-bucket output-range drift gauges (stats()["output_range"], present
# when the server runs the numerics flavor, ``cli serve --numerics``):
# rolling extremes of the served flow per shape bucket — the scrapeable
# signal for a model starting to rail or collapse its outputs.
_PROM_OUTPUT_RANGE = (
    ("output_min_p05", "raft_serve_output_min_p05",
     "Rolling p05 of per-request output flow minimum (px)"),
    ("output_max_p95", "raft_serve_output_max_p95",
     "Rolling p95 of per-request output flow maximum (px)"),
    ("n", "raft_serve_output_range_window_requests",
     "Requests inside the rolling output-range window"),
)


def prometheus_metrics(stats: dict, host_id: Optional[str] = None) -> str:
    """Render a ``stats()`` dict as Prometheus text exposition format.

    ``host_id`` (``cli serve`` passes the telemetry's) adds a ``host``
    label to every sample — alongside the existing ``bucket`` label on
    the per-bucket families — so a future multi-replica scrape
    aggregates cleanly; None keeps the unlabeled single-process shape.
    """
    hl = f'host="{host_id}"' if host_id else ""
    plain = "{" + hl + "}" if hl else ""
    lines = []
    for key, name, kind, help_text in _PROM_METRICS:
        if key not in stats:
            continue
        value = stats[key]
        if isinstance(value, bool):
            value = int(value)
        lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {kind}")
        lines.append(f"{name}{plain} {float(value):g}")
    for stats_key, families in (("quality", _PROM_QUALITY),
                                ("iters", _PROM_ITERS),
                                ("output_range", _PROM_OUTPUT_RANGE)):
        per_bucket = stats.get(stats_key) or {}
        if not per_bucket:
            continue
        for key, name, help_text in families:
            lines.append(f"# HELP {name} {help_text}")
            lines.append(f"# TYPE {name} gauge")
            for bucket in sorted(per_bucket):
                value = per_bucket[bucket].get(key)
                if value is None:
                    continue
                labels = f'bucket="{bucket}"' + (f",{hl}" if hl else "")
                lines.append(f"{name}{{{labels}}} {float(value):g}")
    return "\n".join(lines) + "\n"


class _Handler(BaseHTTPRequestHandler):
    server_version = "raft-stereo-serve/1.0"
    #: set by make_http_server
    stereo: StereoServer = None  # type: ignore[assignment]
    #: /metrics exposition toggle (make_http_server(metrics=...))
    metrics: bool = True
    #: host label on /metrics samples (make_http_server(host_id=...))
    host_id: Optional[str] = None

    def log_message(self, fmt, *args):  # route to logging, not stderr
        logger.debug("http: " + fmt, *args)

    def _reply(self, code: int, body: bytes, ctype: str = "application/json",
               headers: Optional[dict] = None) -> None:
        self.send_response(code)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, str(v))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self):
        path = urlparse(self.path).path
        if path == "/healthz":
            stats = self.stereo.stats()
            code = 503 if stats["draining"] or stats["stopped"] else 200
            self._reply(code, _json_bytes(stats))
        elif path == "/slo":
            self._reply(200, _json_bytes(self.stereo.stats()))
        elif path == "/metrics" and self.metrics:
            self._reply(200, prometheus_metrics(
                self.stereo.stats(), host_id=self.host_id).encode(),
                ctype="text/plain; version=0.0.4; charset=utf-8")
        else:
            self._reply(404, _json_bytes({"error": "not found"}))

    def do_POST(self):
        url = urlparse(self.path)
        if url.path != "/v1/predict":
            self._reply(404, _json_bytes({"error": "not found"}))
            return
        try:
            n = int(self.headers.get("Content-Length", "0"))
            with np.load(io.BytesIO(self.rfile.read(n))) as npz:
                left, right = npz["left"], npz["right"]
        except Exception as exc:
            self._reply(400, _json_bytes(
                {"error": f"bad request body: {exc}"}))
            return
        q = parse_qs(url.query)
        # cross-process trace join: a traceparent header parents the
        # server-side span tree under the client's span (malformed
        # headers degrade to "no remote parent", never an error)
        traceparent = self.headers.get("traceparent")
        parent = parse_traceparent(traceparent)
        try:
            handle = self.stereo.submit(
                left, right,
                iters=int(q["iters"][0]) if "iters" in q else None,
                stream=q["stream"][0] if "stream" in q else None,
                warm_start=q.get("warm", ["0"])[0] == "1",
                timeout=5.0, parent=parent)
        except ServerDraining:
            self._reply(503, _json_bytes({"error": "draining"}),
                        headers={"Retry-After": "never"})
            return
        except ServerBusy:
            self._reply(503, _json_bytes({"error": "queue full"}),
                        headers={"Retry-After": "1"})
            return
        except ValueError as exc:
            self._reply(400, _json_bytes({"error": str(exc)}))
            return
        result = handle.result()
        meta = {"X-Request-Id": result.request_id,
                "X-Latency-Ms": round(result.latency_s * 1e3, 3),
                "X-Batch-Size": result.batch_size,
                "X-Bucket": result.bucket}
        if parent is not None:
            meta["traceparent"] = traceparent
        if not result.ok:
            self._reply(422, _json_bytes(
                {"error": result.error, "kind": result.error_kind,
                 "request_id": result.request_id}), headers=meta)
            return
        buf = io.BytesIO()
        np.savez_compressed(buf, flow=result.flow)
        self._reply(200, buf.getvalue(),
                    ctype="application/octet-stream", headers=meta)


def make_http_server(stereo: StereoServer, host: str = "127.0.0.1",
                     port: int = 8600, metrics: bool = True,
                     host_id: Optional[str] = None) -> ThreadingHTTPServer:
    """Bind (but do not serve) the HTTP front; caller owns serve/shutdown."""
    handler = type("BoundHandler", (_Handler,),
                   {"stereo": stereo, "metrics": metrics,
                    "host_id": host_id})
    httpd = ThreadingHTTPServer((host, port), handler)
    httpd.daemon_threads = True
    return httpd


def serve_forever(stereo: StereoServer, httpd: ThreadingHTTPServer,
                  should_stop, poll_s: float = 0.25,
                  maybe_reload=None, drain_timeout_s: float = 300.0) -> int:
    """Run the HTTP loop until ``should_stop()`` (typically a
    SignalGuard's ``requested``), then drain gracefully.

    ``maybe_reload`` (optional) is polled each tick — the SIGHUP hot-reload
    hook; its exceptions are logged, never fatal (a bad reload must not
    take down a serving process). Returns the exit code (0 = clean drain).
    """
    import time
    t = threading.Thread(target=httpd.serve_forever, daemon=True,
                         name="serve-http")
    t.start()
    logger.info("serve: listening on http://%s:%d", *httpd.server_address)
    clean = True
    try:
        while not should_stop():
            time.sleep(poll_s)
            if maybe_reload is not None:
                try:
                    maybe_reload()
                except Exception:
                    logger.exception("serve: hot reload failed; continuing "
                                     "with current weights")
    finally:
        logger.info("serve: stop requested — draining")
        httpd.shutdown()
        stereo.request_drain()
        clean = stereo.join(timeout=drain_timeout_s)
        logger.info("serve: drain %s", "complete" if clean else "TIMED OUT")
    return 0 if clean else 1
