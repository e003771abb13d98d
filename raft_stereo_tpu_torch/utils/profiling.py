"""Readers of a Chrome-trace capture (the port's copy of the trace-reader
half of ``raft_stereo_tpu/utils/profiling.py``).

A capture is the newest ``plugins/profile/*/*.trace.json.gz`` under a log
directory, the layout a ``jax.profiler`` trace leaves: a gzipped
``{"traceEvents": [...]}`` object whose device processes carry a
``/device:`` name and whose per-op lanes are threads named "XLA Ops".
:func:`summarize_trace` totals device-op time by category and by op, and
:func:`format_report` renders it; ``obs/summarize.py`` and
``obs/timeline.py`` read a run's capture through these, and a run without
one reports no trace section. The capture itself, the compile timers and
the serial-floor fit stay with the JAX package (ROADMAP A15).
"""

from __future__ import annotations

import collections
import glob
import gzip
import json
import os
from typing import Any, Dict, List, Optional


def _latest_trace_json(log_dir: str) -> Optional[str]:
    paths = sorted(glob.glob(
        os.path.join(log_dir, "plugins", "profile", "*", "*.trace.json.gz")))
    return paths[-1] if paths else None


def load_trace_events(log_dir: str) -> tuple:
    """Load the latest Chrome-trace capture under ``log_dir``.

    Returns ``(path, events)``: the ``traceEvents`` list of the newest
    ``plugins/profile/*/*.trace.json.gz``. Raises FileNotFoundError when
    no capture exists.
    """
    path = _latest_trace_json(log_dir)
    if path is None:
        raise FileNotFoundError(f"no trace.json.gz under {log_dir}")
    data = json.load(gzip.open(path, "rt"))
    return path, data.get("traceEvents", [])


def device_lanes(events) -> tuple:
    """Identify the device lanes of a Chrome-trace event list.

    Returns ``(device_pids, op_tids)``: process ids whose metadata name
    mentions ``/device:`` and their "XLA Ops" ``(pid, tid)`` lanes, the
    per-op device timeline. Host-only captures return two empty sets.
    """
    device_pids = set()
    op_tids = set()
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            if "/device:" in e.get("args", {}).get("name", ""):
                device_pids.add(e["pid"])
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            if e.get("args", {}).get("name") == "XLA Ops":
                op_tids.add((e["pid"], e["tid"]))
    return device_pids, op_tids


def summarize_trace(log_dir: str, top: int = 25) -> Dict[str, Any]:
    """Aggregate device-op time from the latest trace under ``log_dir``.

    Returns ``{"trace": path, "note": ..., "total_device_ms": t,
    "by_category": [...], "top_ops": [...]}``, times totalled over the
    captured region. Categories are the ops' ``hlo_category`` argument
    (``while`` wrappers skipped: their body ops count one by one);
    ``top_ops`` carries each op's ``long_name`` prefix.
    """
    path, events = load_trace_events(log_dir)
    device_pids, op_tids = device_lanes(events)

    cat_time: collections.Counter = collections.Counter()
    op_time: collections.Counter = collections.Counter()
    op_count: collections.Counter = collections.Counter()
    op_meta: Dict[str, str] = {}
    total = 0.0
    for e in events:
        if e.get("ph") != "X" or e.get("pid") not in device_pids:
            continue
        if op_tids and (e["pid"], e.get("tid")) not in op_tids:
            continue
        args = e.get("args", {})
        dur = e.get("dur", 0)
        cat = args.get("hlo_category", "?")
        if cat == "while":
            continue  # wrapper op; its body ops are counted individually
        name = e["name"]
        cat_time[cat] += dur
        op_time[name] += dur
        op_count[name] += 1
        total += dur
        if name not in op_meta:
            op_meta[name] = args.get("long_name", "")[:160]

    return {
        "trace": path,
        # host-only captures carry no per-op device lane: an empty
        # summary with a note is the result there
        "note": (None if device_pids else
                 "no XLA device lane in trace (CPU/host-only capture); "
                 "op summaries require a TPU/GPU trace"),
        "total_device_ms": total / 1e3,
        "by_category": [
            {"category": c, "ms": t / 1e3}
            for c, t in cat_time.most_common()
        ],
        "top_ops": [
            {"name": n, "ms": t / 1e3, "count": op_count[n],
             "hlo": op_meta.get(n, "")}
            for n, t in op_time.most_common(top)
        ],
    }


def format_report(report: Dict[str, Any]) -> str:
    lines: List[str] = [
        f"trace: {report['trace']}",
        f"total device-op time: {report['total_device_ms']:.1f} ms",
    ]
    if report.get("note"):
        lines.append(f"note: {report['note']}")
    lines += ["", "by category:"]
    for row in report["by_category"]:
        lines.append(f"  {row['ms']:9.2f} ms  {row['category']}")
    lines.append("")
    lines.append("top ops:")
    for row in report["top_ops"]:
        lines.append(f"  {row['ms']:9.2f} ms x{row['count']:<5d} "
                     f"{row['name'][:48]:48s} {row['hlo'][:70]}")
    return "\n".join(lines)
