"""SLO telemetry for the serving loop (the port's copy of
``raft_stereo_tpu/serve/slo.py``; schema-v6 events).

Three records ride the event bus (obs/telemetry.py):

* ``request`` — one a retired request: its terminal ``status`` (``ok`` /
  ``error``), queue wait and end-to-end latency, the bucket and batch it
  rode and, on failure, the error and the traceback's tail;
* ``queue`` — the admission side's depth gauge (every ``gauge_every``-th
  submit): queue depth, dispatches in flight, the admitted / completed /
  failed / rejected counters;
* ``slo`` — every ``emit_every`` retirements: p50/p99 end-to-end latency
  (ms) over a sliding window of samples, dispatches in flight and the
  pairs/s sustained over that window. With the convergence output on,
  the rollup carries a per-bucket ``quality`` extra (rolling percentiles
  of the last iteration's residual), so quality drift after a hot reload
  shows. The ``output_range`` and ``iters`` extras of the JAX package's
  numerics and adaptive flavours are kept for when those flavours are
  ported (ROADMAP A11); the port's server feeds neither yet.

The tracker is lock-guarded (the scheduler thread retires, client threads
admit) and fails open: with ``telemetry=None`` it still aggregates and
emits nothing.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any, Dict, Optional


def percentile(sorted_vals, q: float) -> float:
    """Nearest-rank percentile over an ascending list (obs/compare.py's
    convention); 0.0 on empty input."""
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1,
              max(0, int(round(q / 100.0 * (len(sorted_vals) - 1)))))
    return float(sorted_vals[idx])


class SLOTracker:
    def __init__(self, telemetry=None, *, window: int = 256,
                 emit_every: int = 16, gauge_every: int = 8):
        self.telemetry = telemetry
        self.window = max(1, int(window))
        self.emit_every = max(1, int(emit_every))
        self.gauge_every = max(1, int(gauge_every))
        self._lock = threading.Lock()
        # (retire wall-clock, latency seconds) per retired request
        self._samples: "deque" = deque(maxlen=self.window)
        # rolling final-residual window per bucket label (the serve
        # quality gauges; fed only when the converge aux is on)
        self._quality: Dict[str, "deque"] = {}
        # rolling (output_min, output_max) window per bucket label — the
        # output-range drift gauges; fed only when the numerics aux is on
        self._ranges: Dict[str, "deque"] = {}
        # rolling iters_taken window per bucket label — the adaptive
        # (early-exit) iteration gauges; fed only when requests ride the
        # compiled early-exit flavors (serve --iter_policy)
        self._iters: Dict[str, "deque"] = {}
        self.admitted = 0
        self.completed = 0
        self.failed = 0
        self.rejected = 0
        self._retired_since_emit = 0

    # --- admission side ------------------------------------------------------

    def admit(self, queue_depth: int, in_flight: int) -> None:
        with self._lock:
            self.admitted += 1
            emit = self.admitted % self.gauge_every == 1 \
                or self.gauge_every == 1
            counters = self._counters()
        if emit and self.telemetry is not None:
            self.telemetry.emit("queue", depth=int(queue_depth),
                                in_flight=int(in_flight), **counters)

    def reject(self) -> None:
        with self._lock:
            self.rejected += 1

    # --- retirement side -----------------------------------------------------

    def retire(self, request_id: str, status: str, latency_s: float,
               queue_wait_s: float, bucket: str, batch_size: int,
               in_flight: int, stream: Optional[str] = None,
               error: Optional[str] = None,
               traceback_tail: Optional[str] = None,
               final_residual: Optional[float] = None,
               iters_taken: Optional[int] = None,
               output_min: Optional[float] = None,
               output_max: Optional[float] = None) -> None:
        """Record one terminal request outcome; emits the ``request`` event
        and, on cadence, the ``slo`` rollup. ``final_residual`` (mean
        |Δdisparity| of the last refinement iteration, from the converge
        aux) feeds the per-bucket rolling quality gauges;
        ``iters_taken`` (refinement iterations the compiled early-exit
        flavor actually applied) feeds the per-bucket adaptive iteration
        gauges — together they close the policy loop: iterations saved AND
        quality held; ``output_min``/``output_max`` (host range of the
        request's unpadded flow, from the numerics flavor) feed the
        per-bucket output-range drift gauges."""
        now = time.monotonic()
        with self._lock:
            if status == "ok":
                self.completed += 1
            else:
                self.failed += 1
            self._samples.append((now, float(latency_s)))
            if final_residual is not None and status == "ok":
                dq = self._quality.get(bucket)
                if dq is None:
                    dq = self._quality[bucket] = deque(maxlen=self.window)
                dq.append(float(final_residual))
            if iters_taken is not None and status == "ok":
                iq = self._iters.get(bucket)
                if iq is None:
                    iq = self._iters[bucket] = deque(maxlen=self.window)
                iq.append(int(iters_taken))
            if (output_min is not None and output_max is not None
                    and status == "ok"):
                rq = self._ranges.get(bucket)
                if rq is None:
                    rq = self._ranges[bucket] = deque(maxlen=self.window)
                rq.append((float(output_min), float(output_max)))
            self._retired_since_emit += 1
            do_slo = self._retired_since_emit >= self.emit_every
            if do_slo:
                self._retired_since_emit = 0
                slo = self._snapshot_locked(in_flight)
        if self.telemetry is not None:
            payload: Dict[str, Any] = dict(
                id=request_id, status=status,
                latency_s=round(float(latency_s), 6),
                queue_wait_s=round(float(queue_wait_s), 6),
                bucket=bucket, batch_size=int(batch_size))
            if stream is not None:
                payload["stream"] = stream
            if error is not None:
                payload["error"] = error
            if traceback_tail is not None:
                payload["traceback"] = traceback_tail[-2000:]
            if final_residual is not None:
                payload["final_residual"] = round(float(final_residual), 6)
            if iters_taken is not None:
                payload["iters_taken"] = int(iters_taken)
            if output_min is not None:
                payload["output_min"] = round(float(output_min), 4)
            if output_max is not None:
                payload["output_max"] = round(float(output_max), 4)
            self.telemetry.emit("request", **payload)
            if do_slo:
                self.telemetry.emit("slo", **slo)

    # --- rollups -------------------------------------------------------------

    def _counters(self) -> Dict[str, int]:
        return {"admitted": self.admitted, "completed": self.completed,
                "failed": self.failed, "rejected": self.rejected}

    def _snapshot_locked(self, in_flight: int) -> Dict[str, Any]:
        lats = sorted(l for _, l in self._samples)
        span = (self._samples[-1][0] - self._samples[0][0]
                if len(self._samples) > 1 else 0.0)
        pairs = len(self._samples)
        pps = pairs / span if span > 0 else 0.0
        snap = {
            "p50_ms": round(percentile(lats, 50) * 1e3, 3),
            "p99_ms": round(percentile(lats, 99) * 1e3, 3),
            "pairs_per_sec": round(pps, 4),
            "in_flight": int(in_flight),
            "window_requests": pairs,
            **self._counters(),
        }
        if self._quality:
            snap["quality"] = {
                bucket: {
                    "final_residual_p50": round(
                        percentile(sorted(dq), 50), 6),
                    "final_residual_p95": round(
                        percentile(sorted(dq), 95), 6),
                    "n": len(dq),
                }
                for bucket, dq in sorted(self._quality.items()) if dq
            }
        if self._iters:
            snap["iters"] = {
                bucket: {
                    "iters_taken_p50": round(
                        percentile(sorted(iq), 50), 2),
                    "iters_taken_p95": round(
                        percentile(sorted(iq), 95), 2),
                    "iters_taken_mean": round(sum(iq) / len(iq), 3),
                    "n": len(iq),
                }
                for bucket, iq in sorted(self._iters.items()) if iq
            }
        if self._ranges:
            snap["output_range"] = {
                bucket: {
                    "output_min_p05": round(percentile(
                        sorted(lo for lo, _ in rq), 5), 4),
                    "output_max_p95": round(percentile(
                        sorted(hi for _, hi in rq), 95), 4),
                    "n": len(rq),
                }
                for bucket, rq in sorted(self._ranges.items()) if rq
            }
        return snap

    def snapshot(self, in_flight: int = 0) -> Dict[str, Any]:
        """Current rollup (the ``/slo`` HTTP endpoint + loadtest report)."""
        with self._lock:
            return self._snapshot_locked(in_flight)

    def flush(self, in_flight: int = 0) -> None:
        """Emit a final ``slo`` rollup regardless of cadence — called at
        drain so short traces (< ``emit_every`` retirements) still leave
        the headline record in events.jsonl."""
        with self._lock:
            if not self._samples:
                return
            self._retired_since_emit = 0
            slo = self._snapshot_locked(in_flight)
        if self.telemetry is not None:
            self.telemetry.emit("slo", **slo)
