"""The run report (the port's copy of ``raft_stereo_tpu/obs/summarize.py``):
``python -m raft_stereo_tpu_torch.cli telemetry <run_dir>``.

It merges what a run leaves behind:

* ``<run_dir>/events.jsonl`` (obs/telemetry.py): per-phase step timing
  percentiles, the throughput trend over step windows, spans, compile
  count and time, checkpoints, validations, stalls and errors;
* a Chrome-trace capture under the run dir (``plugins/profile/...``):
  device-op and category totals through
  :func:`utils.profiling.summarize_trace`.

Either half may be absent; the report says so instead of failing, since
its job is reading partial artifacts from wedged runs. Its text is the
JAX package's, word for word, so that both tools report a run alike.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict, List, Optional, Sequence

from raft_stereo_tpu_torch.obs.events import read_events, validate_events

_PHASES = ("data_wait_s", "dispatch_s", "fetch_s")


def _percentiles(values: Sequence[float]) -> Dict[str, float]:
    import numpy as np
    arr = np.asarray(sorted(values), dtype=np.float64)
    return {
        "p50": float(np.percentile(arr, 50)),
        "p90": float(np.percentile(arr, 90)),
        "max": float(arr[-1]),
        "total": float(arr.sum()),
    }


def _throughput_trend(steps: List[Dict[str, Any]],
                      n_windows: int = 5) -> List[Dict[str, Any]]:
    """Pairs/sec per window of consecutive step records (wall time from the
    monotonic ``t`` axis; falls back to per-phase sums when ``t`` is absent)."""
    timed = [s for s in steps if "batch_size" in s]
    if len(timed) < 2:
        return []
    per = max(len(timed) // n_windows, 1)
    trend = []
    for i in range(0, len(timed), per):
        win = timed[i:i + per]
        if len(win) >= 2 and all("t" in s for s in win):
            dt = win[-1]["t"] - win[0]["t"]
            pairs = sum(s["batch_size"] for s in win[1:])
        else:
            dt = sum(sum(s.get(p, 0.0) for p in _PHASES) for s in win)
            pairs = sum(s["batch_size"] for s in win)
        if dt > 0:
            trend.append({
                "steps": [win[0].get("step"), win[-1].get("step")],
                "pairs_per_sec": round(pairs / dt, 3),
            })
    return trend


def _pipeline_overlap(steps: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Overlap efficiency of a pipelined run: serial phase work / wall time.

    ``serial_s`` sums every step's data-wait + dispatch + fetch; ``wall_s``
    spans the monotonic ``t`` axis from the first to the last step record.
    Sequential loops land at ~1.0 (all phase work on the critical path);
    values above 1.0 mean the pipeline overlapped that much host/device
    work per unit of wall clock (eval/stream.py's whole purpose); well
    below 1.0 means time went somewhere the phase split doesn't see.
    """
    timed = [s for s in steps if "t" in s]
    if len(timed) < 2:
        return None
    wall = timed[-1]["t"] - timed[0]["t"]
    if wall <= 0:
        return None
    # the first record's phases happened before its own `t` stamp, i.e.
    # outside the [t_first, t_last] window — sum the in-window steps only
    serial = sum(sum(s.get(p, 0.0) for p in _PHASES) for s in timed[1:])
    return {"serial_s": round(serial, 4), "wall_s": round(wall, 4),
            "efficiency": round(serial / wall, 3)}


def _span_summary(events: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Phase percentiles + overlap efficiency from schema-v7 spans.

    The span-derived twin of :func:`_pipeline_overlap`/the step-phase
    table: per-name duration percentiles, root child-coverage, and —
    because child spans are the serial phase work while wall time spans
    first start to last end — a pipeline-overlap efficiency that needs no
    trace capture. This is what lets ``cli telemetry`` say something
    better than "trace: none" on span-carrying runs.
    """
    spans = [e for e in events if e.get("event") == "span"]
    if not spans:
        return None
    from raft_stereo_tpu_torch.obs.timeline import span_coverage
    by_name: Dict[str, List[float]] = {}
    for s in spans:
        by_name.setdefault(str(s.get("name", "?")), []).append(
            float(s.get("dur_s", 0.0)))
    starts = [float(s.get("start_s", 0.0)) for s in spans]
    ends = [float(s.get("start_s", 0.0)) + float(s.get("dur_s", 0.0))
            for s in spans]
    wall = max(ends) - min(starts)
    serial = sum(float(s.get("dur_s", 0.0)) for s in spans
                 if s.get("parent_id") is not None)
    out: Dict[str, Any] = {
        "count": len(spans),
        "by_name": {n: {"count": len(v), **_percentiles(v)}
                    for n, v in sorted(by_name.items())},
        "coverage": span_coverage(spans),
    }
    if wall > 0 and serial > 0:
        out["overlap"] = {"serial_s": round(serial, 4),
                          "wall_s": round(wall, 4),
                          "efficiency": round(serial / wall, 3)}
    return out


def _pipeline_gauges(events: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    import numpy as np
    gauges = [e for e in events if e.get("event") == "pipeline"]
    if not gauges:
        return None
    depths = [g["in_flight"] for g in gauges if "in_flight" in g]
    out: Dict[str, Any] = {"gauges": len(gauges)}
    if depths:
        out["in_flight_p50"] = float(np.median(depths))
        out["in_flight_max"] = int(max(depths))
    last = gauges[-1]
    for k in ("window", "microbatch"):
        if k in last:
            out[k] = last[k]
    return out


def _xla_summary(events: List[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Headline numbers from the compiled-artifact introspection records
    (``xla_memory``/``xla_cost``): the LAST of each in the log. The
    port writes none (ROADMAP A15); a log that holds them reports them."""
    mems = [e for e in events if e.get("event") == "xla_memory"]
    costs = [e for e in events if e.get("event") == "xla_cost"]
    if not mems and not costs:
        return None
    out: Dict[str, Any] = {"n_memory": len(mems), "n_cost": len(costs)}
    if mems:
        m = mems[-1]
        out["source"] = m.get("source")
        for k in ("peak_bytes", "temp_bytes", "argument_bytes",
                  "output_bytes", "capacity_bytes", "headroom_bytes"):
            if k in m:
                out[k] = m[k]
    if costs:
        c = costs[-1]
        out.setdefault("source", c.get("source"))
        for k in ("flops", "bytes_accessed", "flops_per_byte"):
            if k in c:
                out[k] = c[k]
    return out


def _find_trace_dir(run_dir: str) -> Optional[str]:
    hits = glob.glob(os.path.join(run_dir, "**", "plugins", "profile"),
                     recursive=True)
    if not hits:
        return None
    # summarize_trace expects the log dir CONTAINING plugins/profile
    return os.path.dirname(os.path.dirname(sorted(hits)[0]))


def summarize_run(run_dir: str, top: int = 10) -> Dict[str, Any]:
    """Build the merged report dict for ``run_dir``."""
    report: Dict[str, Any] = {"run_dir": run_dir}

    events_path = os.path.join(run_dir, "events.jsonl")
    if os.path.exists(events_path):
        events = read_events(events_path)
        report["events"] = _summarize_events(events)
        report["schema_errors"] = validate_events(events)[:20]
    else:
        report["events"] = None

    trace_dir = _find_trace_dir(run_dir)
    if trace_dir is not None:
        from raft_stereo_tpu_torch.utils.profiling import summarize_trace
        try:
            report["trace"] = summarize_trace(trace_dir, top=top)
        except Exception as e:  # partial/corrupt capture from a wedged run
            report["trace"] = {"error": f"{type(e).__name__}: {e}"}
    else:
        report["trace"] = None
    return report


def _summarize_events(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    by = lambda kind: [e for e in events if e.get("event") == kind]  # noqa: E731
    steps = by("step")
    out: Dict[str, Any] = {
        "n_records": len(events),
        "run": next((e.get("run") for e in by("run_start")), None),
        "steps": len(steps),
        "phases": {p: _percentiles([s[p] for s in steps if p in s])
                   for p in _PHASES if any(p in s for s in steps)},
        "throughput_trend": _throughput_trend(steps),
        "pipeline_overlap": _pipeline_overlap(steps),
        "spans": _span_summary(events),
        "pipeline": _pipeline_gauges(events),
        "xla": _xla_summary(events),
        "converge": _converge_summary(events),
        "compiles": {
            "count": len(by("compile")),
            "total_s": round(sum(e.get("duration_s", 0.0)
                                 for e in by("compile")), 3),
        },
        "checkpoints": [{"step": e.get("step"), "path": e.get("path"),
                         **({"reason": e["reason"]} if "reason" in e
                            else {})}
                        for e in by("checkpoint")],
        # fault tolerance (training/resilience.py): preemption, resume
        # provenance, checkpoint-integrity verdicts, anomaly skips
        "preempts": [{"signal": e.get("signal"), "step": e.get("step")}
                     for e in by("preempt")],
        "resumes": [{"step": e.get("step"), "path": e.get("path")}
                    for e in by("resume")],
        "ckpt_integrity_failures": [
            {"path": e.get("path"), "reason": e.get("reason")}
            for e in by("ckpt_integrity") if not e.get("ok")],
        "anomalies": _anomaly_summary(by("anomaly")),
        "validations": [e.get("results") for e in by("validation")],
        "stalls": [{"t": e.get("t"),
                    "seconds_since_step": e.get("seconds_since_step"),
                    "deadline_s": e.get("deadline_s")}
                   for e in by("stall")],
        "errors": [e.get("error") for e in by("error")],
    }
    ends = by("run_end")
    if ends:
        out["run_end"] = {k: ends[-1].get(k) for k in ("steps", "ok", "t")}
    mems = [e for e in by("memory") if e.get("stats")]
    if mems:
        last = mems[-1]["stats"]
        out["memory_last"] = {k: last[k] for k in
                              ("bytes_in_use", "peak_bytes_in_use")
                              if k in last}
    return out


def _converge_summary(events: List[Dict[str, Any]]
                      ) -> Optional[Dict[str, Any]]:
    """Headlines from schema-v8 ``converge`` records (obs/converge.py):
    curve count by source, half-life percentiles ("by which iteration had
    the residual halved?") and final-residual percentiles — the quick read
    before replaying the full decision table with ``cli converge``."""
    curves = [e for e in events if e.get("event") == "converge"]
    if not curves:
        return None
    from raft_stereo_tpu_torch.obs.converge import _percentile
    by_source: Dict[str, int] = {}
    for c in curves:
        src = str(c.get("source", "?"))
        by_source[src] = by_source.get(src, 0) + 1
    out: Dict[str, Any] = {
        "count": len(curves),
        "budget": max(int(c.get("iters", 0)) for c in curves),
        "by_source": by_source,
    }
    hls = [float(c["half_life"]) for c in curves if "half_life" in c]
    if hls:
        out["half_life_p50"] = int(_percentile(hls, 50.0))
        out["half_life_p95"] = int(_percentile(hls, 95.0))
        out["n_half_life"] = len(hls)
    finals = [float(c["final_residual"]) for c in curves
              if "final_residual" in c]
    if finals:
        out["final_residual_p50"] = round(_percentile(finals, 50.0), 6)
        out["final_residual_p95"] = round(_percentile(finals, 95.0), 6)
    return out


def _anomaly_summary(anomalies: List[Dict[str, Any]]
                     ) -> Optional[Dict[str, Any]]:
    if not anomalies:
        return None
    by_kind: Dict[str, int] = {}
    for e in anomalies:
        kind = e.get("kind", "?")
        by_kind[kind] = by_kind.get(kind, 0) + 1
    out: Dict[str, Any] = {"count": len(anomalies), "by_kind": by_kind}
    skips = [e for e in anomalies if e.get("kind") == "nonfinite_grad"]
    if skips:
        out["skipped_update_steps"] = [e.get("step") for e in skips]
    return out


def format_summary(report: Dict[str, Any]) -> str:
    lines: List[str] = [f"run: {report['run_dir']}"]
    ev = report.get("events")
    if ev is None:
        lines.append("events: none (no events.jsonl under the run dir)")
    else:
        lines.append(f"events: {ev['n_records']} records, "
                     f"{ev['steps']} steps"
                     + (f" (run '{ev['run']}')" if ev.get("run") else ""))
        end = ev.get("run_end")
        if end:
            lines.append(f"run_end: ok={end.get('ok')} "
                         f"steps={end.get('steps')} at t={end.get('t')}s")
        if ev["phases"]:
            lines.append("")
            lines.append("per-step phases (s):"
                         "          p50       p90       max     total")
            for p, q in ev["phases"].items():
                lines.append(f"  {p:16s} {q['p50']:12.4f} {q['p90']:9.4f} "
                             f"{q['max']:9.4f} {q['total']:9.2f}")
        if ev["throughput_trend"]:
            lines.append("")
            lines.append("throughput trend (pairs/sec):")
            for w in ev["throughput_trend"]:
                lines.append(f"  steps {w['steps'][0]}-{w['steps'][1]}: "
                             f"{w['pairs_per_sec']}")
        ov = ev.get("pipeline_overlap")
        if ov:
            lines.append("")
            lines.append(f"pipeline overlap: {ov['efficiency']}x "
                         f"({ov['serial_s']}s of phase work in "
                         f"{ov['wall_s']}s wall)")
        sp = ev.get("spans")
        if sp:
            lines.append("")
            lines.append(f"spans: {sp['count']}"
                         + (f", root child-coverage min "
                            f"{sp['coverage']['min']:.0%} mean "
                            f"{sp['coverage']['mean']:.0%}"
                            if sp["coverage"].get("roots") else ""))
            lines.append("span phases (s):   count"
                         "       p50       p90       max     total")
            for name, q in sp["by_name"].items():
                lines.append(f"  {name:16s} {q['count']:5d} "
                             f"{q['p50']:9.4f} {q['p90']:9.4f} "
                             f"{q['max']:9.4f} {q['total']:9.2f}")
        pg = ev.get("pipeline")
        if pg:
            depth = (f"in-flight p50 {pg['in_flight_p50']} "
                     f"max {pg['in_flight_max']}"
                     if "in_flight_p50" in pg else "no depth samples")
            extras = ", ".join(f"{k}={pg[k]}" for k in ("window", "microbatch")
                               if k in pg)
            lines.append(f"pipeline gauges: {pg['gauges']} ({depth}"
                         + (f", {extras}" if extras else "") + ")")
        xl = ev.get("xla")
        if xl:
            gib = 1024 ** 3
            parts = []
            if "peak_bytes" in xl:
                peak = f"peak {xl['peak_bytes'] / gib:.2f} GiB"
                if "capacity_bytes" in xl:
                    peak += (f" of {xl['capacity_bytes'] / gib:.1f} GiB "
                             f"(headroom "
                             f"{xl['headroom_bytes'] / gib:.2f} GiB)")
                if "temp_bytes" in xl:
                    peak += f", temps {xl['temp_bytes'] / gib:.2f} GiB"
                parts.append(peak)
            if "flops" in xl:
                cost = f"{xl['flops']:.3g} flops"
                if "flops_per_byte" in xl:
                    cost += f", {xl['flops_per_byte']} flops/byte"
                parts.append(cost)
            lines.append("")
            lines.append(f"xla executable ({xl.get('source')}): "
                         + "; ".join(parts))
        cv = ev.get("converge")
        if cv:
            lines.append("")
            srcs = ", ".join(f"{s}:{n}" for s, n in
                             sorted(cv["by_source"].items()))
            lines.append(f"convergence curves: {cv['count']} "
                         f"(budget {cv['budget']} iters; {srcs})")
            if "half_life_p50" in cv:
                lines.append(f"  residual half-life: p50 iter "
                             f"{cv['half_life_p50']}, p95 iter "
                             f"{cv['half_life_p95']} "
                             f"(n={cv['n_half_life']})")
            if "final_residual_p50" in cv:
                lines.append(f"  final residual: p50 "
                             f"{cv['final_residual_p50']} px, p95 "
                             f"{cv['final_residual_p95']} px — replay "
                             f"exit thresholds with `cli converge`")
        c = ev["compiles"]
        lines.append("")
        lines.append(f"compiles: {c['count']} ({c['total_s']} s)")
        lines.append(f"checkpoints: {len(ev['checkpoints'])}"
                     + ("".join(
                         f"\n  step {k['step']}"
                         + (f" [{k['reason']}]" if "reason" in k else "")
                         + f": {k['path']}"
                         for k in ev["checkpoints"][-3:])))
        for p in ev.get("preempts", []):
            lines.append(f"PREEMPT: {p['signal']} at step {p['step']} "
                         f"(saved; resume with --restore_ckpt auto)")
        for r in ev.get("resumes", []):
            lines.append(f"resumed: step {r['step']} from {r['path']}")
        for f_ in ev.get("ckpt_integrity_failures", []):
            lines.append(f"CKPT INTEGRITY: skipped {f_['path']} "
                         f"({f_['reason']})")
        an = ev.get("anomalies")
        if an:
            lines.append(f"ANOMALIES: {an['count']} ({an['by_kind']})"
                         + (f", skipped updates at steps "
                            f"{an['skipped_update_steps']}"
                            if "skipped_update_steps" in an else ""))
        for v in ev["validations"]:
            lines.append(f"validation: {v}")
        if "memory_last" in ev:
            lines.append(f"device memory (last): {ev['memory_last']}")
        if ev["stalls"]:
            lines.append(f"STALLS: {len(ev['stalls'])}")
            for s in ev["stalls"]:
                lines.append(f"  t={s['t']}s: no step for "
                             f"{s['seconds_since_step']}s "
                             f"(deadline {s['deadline_s']}s)")
        else:
            lines.append("stalls: none")
        for e in ev["errors"]:
            lines.append(f"ERROR: {e}")
        if ev.get("schema_errors") or report.get("schema_errors"):
            for e in report.get("schema_errors", []):
                lines.append(f"schema violation: {e}")

    tr = report.get("trace")
    lines.append("")
    if tr is None:
        sp = (ev or {}).get("spans") if ev else None
        if sp and sp.get("overlap"):
            o = sp["overlap"]
            lines.append(
                f"trace: no jax.profiler capture; span-derived pipeline "
                f"efficiency {o['efficiency']}x ({o['serial_s']}s of span "
                f"work in {o['wall_s']}s wall)")
        else:
            lines.append(
                "trace: none (no jax.profiler capture under the run dir)")
    elif "error" in tr:
        lines.append(f"trace: unreadable ({tr['error']})")
    else:
        from raft_stereo_tpu_torch.utils.profiling import format_report
        lines.append("profiler trace:")
        lines.append(format_report(tr))
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        description="Summarize a run directory's telemetry "
                    "(events.jsonl + optional profiler trace)")
    p.add_argument("run_dir")
    p.add_argument("--top", type=int, default=10,
                   help="top device ops to show from the trace")
    args = p.parse_args(argv)
    print(format_summary(summarize_run(args.run_dir, top=args.top)))
    return 0
