"""The run's timeline (the port's copy of ``raft_stereo_tpu/obs/timeline.py``):
one Chrome/Perfetto-loadable view of a run, three record sources on one
clock.

* **host spans**: schema-v7 ``span`` records (obs/trace.py) become
  complete ("X") events, one track per producing thread, so a step's
  data_wait/dispatch/fetch legs (or a request's queue_wait/collect_group/
  dispatch/retire legs) nest under their root;
* **point events**: stall/anomaly/compile/checkpoint/flightrec/preempt
  records become instant ("i") markers on a track of their own;
* **device trace**: where a Chrome-trace capture lies under the run dir
  (utils/profiling.py's readers), its device lanes are merged in with
  their pids moved out of the host range and shifted so that the earliest
  device op sits under the earliest host ``dispatch`` span.

The output is ``{"traceEvents": [...]}``, written to
``<run_dir>/timeline.json`` by default: ``python -m raft_stereo_tpu_torch.cli
timeline <run_dir>``.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence

from raft_stereo_tpu_torch.obs.events import read_events

#: pid of the host-span process in the merged timeline; device pids are
#: remapped to _DEVICE_PID_BASE + original so the ranges never collide.
HOST_PID = 1
EVENTS_PID = 2
_DEVICE_PID_BASE = 100000

#: event types rendered as instant markers (everything with a `t` that
#: marks a moment rather than an interval and is worth seeing on a track)
_INSTANT_EVENTS = ("stall", "anomaly", "compile", "checkpoint",
                   "flightrec", "preempt", "resume", "error", "heartbeat")

#: span names that root a unit of work, for the coverage summary
ROOT_NAMES = ("step", "request")


def span_coverage(spans: Sequence[Dict[str, Any]],
                  root_names: Sequence[str] = ROOT_NAMES
                  ) -> Dict[str, Any]:
    """How much of each root span's wall time its children account for.

    Returns ``{"roots": n, "min": f, "mean": f}`` over roots with nonzero
    duration (fractions clamped to 1.0; the phase legs are designed to
    tile their root exactly, so ~1.0 is the healthy reading and the
    acceptance bar is >= 0.9). No roots -> ``{"roots": 0}``.
    """
    by_parent: Dict[str, float] = {}
    for s in spans:
        parent = s.get("parent_id")
        if parent is not None:
            by_parent[parent] = by_parent.get(parent, 0.0) + \
                float(s.get("dur_s", 0.0))
    fracs = []
    for s in spans:
        if s.get("name") not in root_names:
            continue
        dur = float(s.get("dur_s", 0.0))
        if dur <= 0:
            continue
        fracs.append(min(by_parent.get(s.get("span_id"), 0.0) / dur, 1.0))
    if not fracs:
        return {"roots": 0}
    return {"roots": len(fracs),
            "min": round(min(fracs), 4),
            "mean": round(sum(fracs) / len(fracs), 4)}


def _span_events(spans: Sequence[Dict[str, Any]], pid: int = HOST_PID,
                 process_name: str = "host spans",
                 shift_s: float = 0.0) -> List[Dict[str, Any]]:
    """Host spans -> Chrome "X" events, one tid per producing thread.

    ``pid``/``process_name``/``shift_s`` let obs/fleet.py render one
    process-group per host on a shared aligned clock; the single-run
    timeline uses the defaults.
    """
    tids: Dict[str, int] = {}
    out: List[Dict[str, Any]] = [
        {"ph": "M", "pid": pid, "name": "process_name",
         "args": {"name": process_name}}]
    for s in spans:
        thread = s.get("thread", "main")
        if thread not in tids:
            tids[thread] = len(tids) + 1
            out.append({"ph": "M", "pid": pid, "tid": tids[thread],
                        "name": "thread_name", "args": {"name": thread}})
        args = {k: v for k, v in s.items()
                if k not in ("schema", "ts", "t", "event", "name",
                             "start_s", "dur_s", "thread")}
        out.append({
            "ph": "X", "pid": pid, "tid": tids[thread],
            "name": s.get("name", "?"),
            "ts": round((float(s.get("start_s", 0.0)) + shift_s) * 1e6, 3),
            "dur": round(float(s.get("dur_s", 0.0)) * 1e6, 3),
            "args": args,
        })
    return out


def _instant_events(records: Sequence[Dict[str, Any]],
                    pid: int = EVENTS_PID, process_name: str = "events",
                    shift_s: float = 0.0) -> List[Dict[str, Any]]:
    out: List[Dict[str, Any]] = [
        {"ph": "M", "pid": pid, "name": "process_name",
         "args": {"name": process_name}},
        {"ph": "M", "pid": pid, "tid": 1, "name": "thread_name",
         "args": {"name": "markers"}}]
    n = 0
    for r in records:
        if r.get("event") not in _INSTANT_EVENTS or "t" not in r:
            continue
        n += 1
        args = {k: v for k, v in r.items()
                if k not in ("schema", "ts", "t", "event")}
        out.append({
            "ph": "i", "s": "g", "pid": pid, "tid": 1,
            "name": r["event"],
            "ts": round((float(r["t"]) + shift_s) * 1e6, 3),
            "args": args,
        })
    return out if n else []


def _device_events(run_dir: str, spans: Sequence[Dict[str, Any]]
                   ) -> List[Dict[str, Any]]:
    """Merge the run's Chrome-trace capture, shifted onto the span clock.

    Alignment anchor: the earliest device op starts with the earliest
    host ``dispatch``-named span (the host call that queued the first
    device work); with no dispatch span, the earliest span of all. No
    capture -> empty list (host-only timeline).
    """
    from raft_stereo_tpu_torch.utils.profiling import (device_lanes,
                                                       load_trace_events)
    try:
        _, events = load_trace_events(run_dir)
    except Exception:
        return []
    device_pids, _ = device_lanes(events)
    if not device_pids:
        return []
    dev = [e for e in events
           if e.get("pid") in device_pids and "ts" in e]
    if not dev:
        return []
    dev_t0 = min(float(e["ts"]) for e in dev if e.get("ph") == "X")
    anchors = [float(s.get("start_s", 0.0)) for s in spans
               if "dispatch" in str(s.get("name", ""))]
    if not anchors:
        anchors = [float(s.get("start_s", 0.0)) for s in spans]
    shift_us = (min(anchors) * 1e6 - dev_t0) if anchors else -dev_t0
    out: List[Dict[str, Any]] = []
    for e in events:
        if e.get("pid") not in device_pids:
            continue
        e = dict(e)
        e["pid"] = _DEVICE_PID_BASE + int(e["pid"])
        if "ts" in e:
            e["ts"] = round(float(e["ts"]) + shift_us, 3)
        out.append(e)
    return out


def build_timeline(run_dir: str,
                   out: Optional[str] = None) -> Dict[str, Any]:
    """Build ``<run_dir>/timeline.json``; returns a summary dict
    (path, event counts, coverage, whether a device trace merged)."""
    events_path = os.path.join(run_dir, "events.jsonl")
    records = read_events(events_path)
    spans = [r for r in records if r.get("event") == "span"]
    trace_events: List[Dict[str, Any]] = []
    trace_events.extend(_span_events(spans))
    trace_events.extend(_instant_events(records))
    device = _device_events(run_dir, spans)
    trace_events.extend(device)
    out = out or os.path.join(run_dir, "timeline.json")
    with open(out, "w") as f:
        json.dump({"traceEvents": trace_events,
                   "displayTimeUnit": "ms"}, f)
    return {
        "path": out,
        "spans": len(spans),
        "markers": sum(1 for e in trace_events if e.get("ph") == "i"),
        "device_events": len(device),
        "coverage": span_coverage(spans),
    }


def main(argv: Optional[Sequence[str]] = None) -> int:
    from raft_stereo_tpu_torch.cli import build_timeline_parser
    args = build_timeline_parser().parse_args(argv)
    try:
        summary = build_timeline(args.run_dir, out=args.out)
    except (FileNotFoundError, ValueError) as e:
        print(f"timeline: {e}")
        return 1
    cov = summary["coverage"]
    cov_line = ("no root spans" if not cov.get("roots") else
                f"{cov['roots']} roots, child coverage min "
                f"{cov['min']:.0%} mean {cov['mean']:.0%}")
    print(f"timeline: {summary['path']}\n"
          f"  {summary['spans']} spans, {summary['markers']} markers, "
          f"{summary['device_events']} device events\n"
          f"  {cov_line}\n"
          f"  load at ui.perfetto.dev or chrome://tracing")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
