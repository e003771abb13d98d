"""The run-scoped telemetry bus: events.jsonl writer + stall watchdog (the
port's copy of ``raft_stereo_tpu/obs/telemetry.py``).

A :class:`Telemetry` instance owns one run directory and appends
schema-stamped records (obs/events.py) to ``<run_dir>/events.jsonl``. It is
thread-safe (a decode thread and the watchdog emit concurrently with the
main loop) and fail-open: a telemetry bug must never take down the run it
observes, so emit errors are logged once and swallowed.

The bus, the stall watchdog, heartbeats, the flight recorder and fleet
stamping are the JAX package's, record for record. Three observers read
the device through ``torch`` instead of JAX:

* **Compile hook** — each nvcc build of a CUDA kernel
  (``ops/kernels/_build.py``) becomes a ``compile`` record with
  ``source="nvcc:<kernel>"`` on every open instance. A run whose kernels
  are already built emits none, as a JAX run with a warm cache does.
* **Device** — ``run_start`` carries ``devices``: ``{"platform": "gpu",
  "kind": <name>, "count": n}`` from ``torch.cuda``, or ``{"platform":
  "cpu", "count": 1}`` for a run on the CPU (``Telemetry(device="cpu")``)
  or without a card.
* **Device memory** — ``memory`` records carry ``torch.cuda``'s allocator
  statistics under JAX's key names (``bytes_in_use``,
  ``peak_bytes_in_use``, ``bytes_limit``), which the JAX package's
  summarizers read; a run on the CPU carries ``stats: {}``.

The flight recorder dumps the last records (and the attached tracer's
span ring) to ``<run_dir>/flightrec-<host>-<ts>.jsonl`` when the watchdog
fires, an ``anomaly``/``preempt`` record lands, on the crash path
(:meth:`Telemetry.error`), or on an explicit drain, rate-limited per
reason.
"""

from __future__ import annotations

import json
import logging
import os
import re
import threading
import time
import traceback
from collections import deque
from typing import Any, Dict, Optional

import torch

from raft_stereo_tpu_torch.obs.events import append_json_log, make_record
from raft_stereo_tpu_torch.obs.fleet import TRACEPARENT_ENV, resolve_host_id
from raft_stereo_tpu_torch.ops.kernels import _build

logger = logging.getLogger(__name__)

# Stall-deadline widening before the first heartbeat: the first step
# builds kernels and warms cuDNN.
_FIRST_STEP_GRACE = 10.0

# Flight-recorder knobs: recent-record ring capacity, and the per-reason
# dump rate limit (a wedged run re-fires the watchdog every interval;
# one dump per episode is the useful one).
_FLIGHT_RING = 256
_FLIGHT_MIN_INTERVAL_S = 30.0

# A heartbeat thread that wakes this many cadence intervals late reports
# itself: the host is wedged enough that even a daemon timer could not
# run, which is exactly what the JAX package's fleet aggregator's
# DEAD_HOST deadline looks for offline — the anomaly
# rides the flight-recorder trigger so the postmortem has the window.
_HEARTBEAT_GAP_FACTOR = 3.0

# Every open instance; the build hook emits a compile record on each.
_active_instances: "set[Telemetry]" = set()


def _compile_listener(kernel: str, seconds: float) -> None:
    for tel in list(_active_instances):
        tel._emit_compile(f"nvcc:{kernel}", seconds)


class Telemetry:
    """Event bus for one run directory; safe to use as a context manager
    (exceptions inside the ``with`` are recorded as ``error`` events and
    re-raised)."""

    def __init__(self, run_dir: str, run_name: Optional[str] = None,
                 stall_deadline_s: Optional[float] = None,
                 host_id: Optional[str] = None, fleet: bool = True,
                 device=None):
        self.run_dir = run_dir
        # the device the run computes on: None is the current card where
        # there is one; a CPU device reports the CPU and no card memory
        self.device = None if device is None else torch.device(device)
        self.run_name = run_name or os.path.basename(
            os.path.normpath(run_dir)) or "run"
        self.events_path = os.path.join(run_dir, "events.jsonl")
        self._t0 = time.monotonic()
        self._lock = threading.Lock()
        self._closed = False
        self._emit_failed = False
        # step bookkeeping (heartbeat + throughput windows)
        self._steps = 0
        self._last_beat = self._t0
        self._window_pairs = 0
        self._window_t0 = self._t0
        self._compile_s = 0.0
        # stall watchdog
        self._deadline = stall_deadline_s
        self._grace = _FIRST_STEP_GRACE
        self._stalled = False
        self._stop = threading.Event()
        self._watchdog: Optional[threading.Thread] = None
        # fleet stamping (schema v10): host identity on every record;
        # fleet=False restores the single-process v9-shaped stream
        self.fleet = bool(fleet)
        self.host_id = resolve_host_id(host_id) if self.fleet else None
        self._heartbeats: list = []
        # flight recorder: recent-record mirror + attached tracer
        self.tracer = None
        self._recent: "deque" = deque(maxlen=_FLIGHT_RING)
        self._flight_last: Dict[str, float] = {}
        os.makedirs(run_dir, exist_ok=True)
        _active_instances.add(self)
        _build.add_build_listener(_compile_listener)
        if stall_deadline_s and stall_deadline_s > 0:
            interval = min(max(stall_deadline_s / 4.0, 0.05), 10.0)
            self._watchdog = threading.Thread(
                target=self._watch, args=(interval,),
                name="telemetry-watchdog", daemon=True)
            self._watchdog.start()

    # --- core ---------------------------------------------------------------

    def emit(self, event: str, **payload: Any) -> None:
        """Append one record; never raises (fail-open, logged once)."""
        rec = make_record(event, t=time.monotonic() - self._t0, **payload)
        if self.host_id is not None:
            rec.setdefault("host_id", self.host_id)
            rec.setdefault("pid", os.getpid())
        try:
            with self._lock:
                if self._closed:
                    return
                append_json_log(self.events_path, rec, stream=None)
                if event != "span":  # span rings live in the tracer
                    self._recent.append(rec)
        except Exception:
            # the with-block released the lock during unwinding; re-take it
            # so the once-only latch is race-free across emitting threads
            with self._lock:
                first = not self._emit_failed
                self._emit_failed = True
            if first:
                logger.exception("telemetry emit failed (disabled for run)")
            return
        # Trigger OUTSIDE the lock: flight_dump re-enters emit (for the
        # flightrec record) and snapshots the tracer under its own lock.
        if event in ("anomaly", "preempt"):
            self.flight_dump(event)

    def attach_tracer(self, tracer) -> None:
        """Bind a Tracer (obs/trace.py): its span flushes already ride this
        bus via :meth:`emit`; binding also puts its ring into flight dumps
        and has close/``__exit__`` flush it before ``run_end``."""
        self.tracer = tracer

    def flight_dump(self, reason: str) -> Optional[str]:
        """Dump the in-memory rings to ``<run_dir>/flightrec-<ts>.jsonl``.

        First line is a header (reason, counts); then the recent records
        (``kind: event``) and the tracer's span ring including still-open
        spans (``kind: span``), each with its payload nested under
        ``record`` so payload fields can never clobber the envelope. A
        ``flightrec`` record lands on the bus
        pointing at the file. Returns the path, or None when rate-limited,
        closed, or the dump failed (fail-open like everything here).
        """
        now = time.monotonic()
        with self._lock:
            if self._closed:
                return None
            last = self._flight_last.get(reason)
            if last is not None and (
                    now - last < _FLIGHT_MIN_INTERVAL_S):
                return None
            self._flight_last[reason] = now
            events = list(self._recent)
        tracer = self.tracer
        spans = tracer.snapshot() if tracer is not None else []
        ts = time.strftime("%Y%m%dT%H%M%S")
        # host-prefixed so N processes sharing a run dir cannot clobber
        # each other's dumps (fleet=False keeps the legacy name)
        tag = "" if self.host_id is None else \
            re.sub(r"[^A-Za-z0-9_.-]+", "_", self.host_id) + "-"
        path = os.path.join(self.run_dir, f"flightrec-{tag}{ts}.jsonl")
        n = 1
        while os.path.exists(path):  # two dumps in one second
            path = os.path.join(
                self.run_dir, f"flightrec-{tag}{ts}-{n}.jsonl")
            n += 1
        try:
            with open(path, "w") as f:
                f.write(json.dumps({
                    "kind": "flightrec", "reason": reason,
                    "run": self.run_name, "host_id": self.host_id,
                    "t": round(now - self._t0, 6),
                    "events": len(events), "spans": len(spans)}) + "\n")
                # the payload rides nested: records have their own `kind`
                # fields (anomaly), which must not clobber the envelope
                for rec in events:
                    f.write(json.dumps(
                        {"kind": "event", "record": rec}) + "\n")
                for sp in spans:
                    f.write(json.dumps(
                        {"kind": "span", "record": sp}) + "\n")
        except Exception:
            logger.exception("flight-recorder dump failed")
            return None
        self.emit("flightrec", reason=reason, path=path,
                  events=len(events), spans=len(spans))
        logger.warning("flight recorder (%s): %d events + %d spans -> %s",
                       reason, len(events), len(spans), path)
        return path

    def close(self) -> None:
        tracer = self.tracer
        if tracer is not None:  # salvage buffered spans (idempotent)
            try:
                tracer.close()
            except Exception:
                logger.exception("tracer close failed")
        self._stop.set()
        if self._watchdog is not None:
            self._watchdog.join(timeout=2.0)
        for t in self._heartbeats:
            t.join(timeout=2.0)
        _active_instances.discard(self)
        with self._lock:
            self._closed = True

    def __enter__(self) -> "Telemetry":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc is not None:
            self.error(exc)
        if self.tracer is not None:  # no span may land after run_end
            try:
                self.tracer.close()
            except Exception:
                logger.exception("tracer close failed")
        self.emit("run_end", steps=self._steps,
                  ok=exc is None, compile_s=round(self._compile_s, 3))
        self.close()

    @property
    def steps(self) -> int:
        """Heartbeats (completed steps) observed by this instance."""
        return self._steps

    # --- record helpers -----------------------------------------------------

    def run_start(self, config: Optional[Dict[str, Any]] = None,
                  **payload: Any) -> None:
        payload.setdefault("devices", _device_info(self.device))
        if self.host_id is not None:
            # a launcher's trace envelope (scripts/fleet_drill.py-style
            # subprocess launches) joins this run to the parent span
            envelope = os.environ.get(TRACEPARENT_ENV)
            if envelope:
                payload.setdefault("traceparent", envelope)
        self.emit("run_start", run=self.run_name,
                  config=config or {}, **payload)
        if self.host_id is not None:
            # monotonic + wall sampled back-to-back: the offset `cli
            # fleet` aligns this process's `t` axis with (wall = t +
            # (wall - monotonic))
            mono, wall = time.monotonic(), time.time()
            self.emit("clock_anchor", host_id=self.host_id,
                      monotonic=round(mono - self._t0, 6),
                      wall=round(wall, 6))

    def start_heartbeat(self, role: str, every_s: float,
                        probe=None) -> Optional[threading.Thread]:
        """Liveness beats on cadence from a daemon thread: one schema-v10
        ``heartbeat`` record per ``every_s`` seconds with a per-role
        strictly-increasing ``seq`` (the aggregator detects gaps without
        trusting wall clocks). ``probe()`` -> dict of extras riding each
        beat (e.g. a step snapshot); probe errors are swallowed —
        fail-open like the rest of the bus. No-op (returns None) when
        fleet stamping is off or the cadence is non-positive."""
        if self.host_id is None or not every_s or every_s <= 0:
            return None
        t = threading.Thread(
            target=self._beat, args=(str(role), float(every_s), probe),
            name=f"telemetry-heartbeat-{role}", daemon=True)
        t.start()
        self._heartbeats.append(t)
        return t

    def _beat(self, role: str, every_s: float, probe) -> None:
        seq = 0
        last = time.monotonic()
        while not self._stop.wait(every_s):
            now = time.monotonic()
            gap, last = now - last, now
            extras: Dict[str, Any] = {}
            if probe is not None:
                try:
                    extras = dict(probe() or {})
                except Exception:
                    extras = {}
            self.emit("heartbeat", host_id=self.host_id, role=role,
                      seq=seq, every_s=every_s, **extras)
            if seq > 0 and gap > _HEARTBEAT_GAP_FACTOR * every_s:
                # rides the anomaly -> flight-recorder trigger in emit()
                self.emit("anomaly", kind="heartbeat_gap", role=role,
                          gap_s=round(gap, 3), every_s=every_s)
            seq += 1

    def step(self, step: int, data_wait_s: float, dispatch_s: float,
             fetch_s: float, batch_size: Optional[int] = None,
             **payload: Any) -> None:
        """One completed training/eval step; doubles as the heartbeat."""
        if batch_size is not None:
            payload["batch_size"] = batch_size
            self._window_pairs += batch_size
        self.emit("step", step=int(step),
                  data_wait_s=round(data_wait_s, 6),
                  dispatch_s=round(dispatch_s, 6),
                  fetch_s=round(fetch_s, 6), **payload)
        self.heartbeat()

    def heartbeat(self) -> None:
        # under the bus lock: the watchdog thread reads these as a unit and
        # flips _stalled back the other way
        with self._lock:
            self._steps += 1
            self._last_beat = time.monotonic()
            self._stalled = False

    def checkpoint(self, step: int, path: str, **payload: Any) -> None:
        """``reason`` rides along as an extra field: "periodic" saves omit
        it; the fault-tolerance paths stamp "preempt"/"crash"/"final"
        (training/resilience.py)."""
        self.emit("checkpoint", step=int(step), path=path, **payload)
        self.memory()

    def validation(self, results: Dict[str, float],
                   dataset: Optional[str] = None) -> None:
        payload = {"dataset": dataset} if dataset else {}
        self.emit("validation",
                  results={k: float(v) for k, v in results.items()},
                  **payload)

    def throughput(self, pairs_per_sec: float, steps: int,
                   **payload: Any) -> None:
        self.emit("throughput", pairs_per_sec=round(pairs_per_sec, 4),
                  steps=int(steps), **payload)

    def window_throughput(self) -> Optional[float]:
        """Pairs/sec since the last call (or run start); emits a
        ``throughput`` record and resets the window. None when no batch-sized
        steps landed in the window."""
        now = time.monotonic()
        pairs, dt = self._window_pairs, now - self._window_t0
        self._window_pairs, self._window_t0 = 0, now
        if pairs == 0 or dt <= 0:
            return None
        pps = pairs / dt
        self.throughput(pps, steps=self._steps, window_s=round(dt, 3))
        return pps

    def memory(self) -> None:
        self.emit("memory", stats=_memory_stats(self.device))

    def loader_gauge(self, gauges: Dict[str, Any]) -> None:
        """Queue-depth/wait gauges from the data pipeline's producer thread."""
        self.emit("loader", **gauges)

    def pipeline(self, in_flight: int, **payload: Any) -> None:
        """In-flight-depth gauge from the streaming eval pipeline
        (eval/stream.py); 0 means the device queue drained."""
        self.emit("pipeline", in_flight=int(in_flight), **payload)

    def error(self, exc: BaseException) -> None:
        self.emit("error", error=f"{type(exc).__name__}: {exc}",
                  traceback="".join(traceback.format_exception(
                      type(exc), exc, exc.__traceback__))[-4000:])
        self.flight_dump("crash")

    def _emit_compile(self, source: str, duration: float) -> None:
        self._compile_s += duration
        self.emit("compile", duration_s=round(duration, 3), source=source)

    # --- watchdog -----------------------------------------------------------

    def _watch(self, interval: float) -> None:
        while not self._stop.wait(interval):
            deadline = self._deadline
            if deadline is None:
                continue
            with self._lock:
                steps = self._steps
                elapsed = time.monotonic() - self._last_beat
                fire = elapsed > (deadline * self._grace if steps == 0
                                  else deadline) and not self._stalled
                if fire:
                    self._stalled = True  # one record per episode
            if steps == 0:
                deadline = deadline * self._grace
            if fire:
                # emit/flight_dump OUTSIDE the lock: emit takes it itself
                logger.warning(
                    "STALL: no step completed in %.1fs (deadline %.1fs) — "
                    "run %s may be wedged; details in %s", elapsed, deadline,
                    self.run_name, self.events_path)
                self.emit("stall", seconds_since_step=round(elapsed, 3),
                          deadline_s=deadline, steps=steps)
                self.flight_dump("stall")


def _on_card(device: Optional[torch.device]) -> bool:
    """Whether a run on ``device`` (None: the default) computes on a card."""
    if device is not None and device.type != "cuda":
        return False
    return torch.cuda.is_available()


def _device_info(device: Optional[torch.device] = None) -> Dict[str, Any]:
    try:
        if _on_card(device):
            return {"platform": "gpu",
                    "kind": torch.cuda.get_device_name(device),
                    "count": torch.cuda.device_count()}
    except RuntimeError:  # a driver fault: report nothing, never raise
        return {}
    return {"platform": "cpu", "count": 1}


def _memory_stats(device: Optional[torch.device] = None) -> Dict[str, Any]:
    """The run's card's allocator statistics under the JAX package's key
    names; {} for a run on the CPU."""
    try:
        if not _on_card(device):
            return {}
        stats = torch.cuda.memory_stats(device)
        _, total = torch.cuda.mem_get_info(device)
    except RuntimeError:
        return {}
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak",
                                               0)),
            "bytes_limit": int(total)}
