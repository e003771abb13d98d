"""The fleet observatory (the port's copy of ``raft_stereo_tpu/obs/fleet.py``):
host identity for fleet stamping, the trace header, and the roll-up of N
processes' logs.

:func:`resolve_host_id` names a process (explicit > ``RAFT_HOST_ID`` env >
``<hostname>-<pid>``); the Telemetry bus stamps it, with ``pid``, on every
record and emits a ``clock_anchor`` at run_start. A launcher's trace
envelope rides the ``RAFT_TRACEPARENT`` env var into the child's run_start;
an HTTP client's rides the ``traceparent`` header
(:func:`format_traceparent` / :func:`parse_traceparent`).

``python -m raft_stereo_tpu_torch.cli fleet <dir-with-N-run-dirs>`` merges
per-host event logs into one clock-aligned roll-up (per-host step-time
and throughput distributions, the skew table, heartbeat gaps, cross-host
trace joins; :func:`aggregate_fleet`) and one Perfetto timeline with a
process group a host (:func:`build_fleet_timeline`).
:func:`diagnose_fleet` (``cli doctor`` pointed at such a directory) names
STRAGGLER, DEAD_HOST and DESYNC, or FLEET_OK. A data-parallel run's rank
directories (``<run_dir>/<name>/rank<r>``) are such a fleet. Logs are read
leniently here (:func:`read_events_lenient`): a killed host's last line may
be cut mid-write, and the roll-up still tells its story; the strict lint
(obs/validate.py) stays strict.
"""

from __future__ import annotations

import datetime
import json
import os
import socket
from typing import Any, Dict, List, Optional, Sequence

from raft_stereo_tpu_torch.obs.trace import SpanContext

#: explicit host identity for a launched process
HOST_ID_ENV = "RAFT_HOST_ID"
#: cross-process trace envelope for subprocess launches (a traceparent
#: header value the child's run_start records)
TRACEPARENT_ENV = "RAFT_TRACEPARENT"

# --- fleet verdict thresholds ----------------------------------------------
#: STRAGGLER: a host's step p95 must reach this multiple of the median of
#: the OTHER hosts' p95 (median-of-others, not fleet median, so one slow
#: host cannot drag the reference toward itself in a small fleet)
STRAGGLER_FACTOR = 2.0
#: ... over at least this many post-compile steps (one step is noise)
STRAGGLER_MIN_STEPS = 2
#: DEAD_HOST: a heartbeat gap (tail or internal) past this many cadence
#: intervals on a host that never wrote a clean run_end
DEAD_HOST_GAP_BEATS = 3.0
#: DESYNC: live hosts' max step counters may differ by this many steps
#: (barrier-free loops legitimately skew by a step or two)
DESYNC_STEP_MARGIN = 2


def resolve_host_id(explicit: Optional[str] = None) -> str:
    """Name this process for fleet stamping: explicit > RAFT_HOST_ID env >
    ``<short-hostname>-<pid>`` (unique per process on one machine)."""
    if explicit:
        return str(explicit)
    env = os.environ.get(HOST_ID_ENV)
    if env:
        return env
    host = socket.gethostname().split(".")[0] or "host"
    return f"{host}-{os.getpid()}"


def format_traceparent(ctx) -> str:
    """SpanContext -> ``00-<trace_id>-<span_id>-01`` (the W3C traceparent
    shape with the repo's short ids, which hold no dashes)."""
    return f"00-{ctx.trace_id}-{ctx.span_id}-01"


def parse_traceparent(header: Optional[str]):
    """Header value -> SpanContext, or None for anything malformed (a
    broken header degrades to "no remote parent", never an error)."""
    if not isinstance(header, str):
        return None
    parts = header.strip().split("-")
    if len(parts) != 4 or not parts[1] or not parts[2]:
        return None
    return SpanContext(trace_id=parts[1], span_id=parts[2])


def read_events_lenient(path: str) -> List[Dict[str, Any]]:
    """Parse an events.jsonl, skipping unparseable lines: a SIGKILL'd
    writer truncates its final line mid-write, and the aggregator must
    still read the rest (the strict reader is obs/events.read_events)."""
    out: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError:
                continue
            if isinstance(rec, dict):
                out.append(rec)
    return out


def discover_runs(fleet_dir: str) -> List[str]:
    """Child run dirs (those holding an ``events.jsonl``), sorted."""
    if not os.path.isdir(fleet_dir):
        raise FileNotFoundError(f"{fleet_dir}: not a directory")
    out = []
    for name in sorted(os.listdir(fleet_dir)):
        child = os.path.join(fleet_dir, name)
        if os.path.isfile(os.path.join(child, "events.jsonl")):
            out.append(child)
    return out


def load_host(run_dir: str) -> Dict[str, Any]:
    """One host's log + its clock offset (``wall = t + offset``).

    The offset comes from the schema-v10 ``clock_anchor`` record; logs
    predating v10 fall back to the first record's wall-clock ``ts`` minus
    its monotonic ``t`` (coarser — ``ts`` has millisecond resolution and
    is stamped a hair after ``t`` — but enough to place an old log on the
    fleet axis). ``anchored`` says which one was used.
    """
    records = read_events_lenient(os.path.join(run_dir, "events.jsonl"))
    host_id, anchor = None, None
    for r in records:
        if anchor is None and r.get("event") == "clock_anchor":
            anchor = r
        if host_id is None and isinstance(r.get("host_id"), str) \
                and r["host_id"]:
            host_id = r["host_id"]
        if host_id is not None and anchor is not None:
            break
    if host_id is None:
        host_id = os.path.basename(os.path.normpath(run_dir)) or "host"
    offset = None
    if anchor is not None:
        try:
            offset = float(anchor["wall"]) - float(anchor["monotonic"])
        except (KeyError, TypeError, ValueError):
            offset = None
    if offset is None:
        for r in records:
            if "t" in r and isinstance(r.get("ts"), str):
                try:
                    wall = datetime.datetime.fromisoformat(
                        r["ts"]).timestamp()
                    offset = wall - float(r["t"])
                except (ValueError, TypeError):
                    continue
                break
    return {"run_dir": run_dir, "host_id": host_id, "records": records,
            "offset": offset if offset is not None else 0.0,
            "anchored": anchor is not None}


def _percentile(xs: Sequence[float], q: float) -> float:
    xs = sorted(xs)
    if not xs:
        return 0.0
    k = (len(xs) - 1) * q / 100.0
    lo = int(k)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


def _step_stats(records: Sequence[Dict[str, Any]]) -> Optional[Dict[str, Any]]:
    """Train-step timing distribution for one host; None for hosts that
    run no train loop (a serve host's ``step`` records — the loadtest's
    per-request accounting — are excluded the way doctor excludes them:
    any ``request`` record means this is a serving log)."""
    if any(r.get("event") == "request" for r in records):
        return None
    steps = [r for r in records
             if r.get("event") == "step" and "in_flight" not in r]
    if not steps:
        return None
    body = steps[1:] or steps  # first step's dispatch carries compile
    totals = [float(r.get("data_wait_s", 0.0))
              + float(r.get("dispatch_s", 0.0))
              + float(r.get("fetch_s", 0.0)) for r in body]
    pairs = sum(int(r["batch_size"]) for r in body if "batch_size" in r)
    ts = [float(r["t"]) for r in body if "t" in r]
    dt = (max(ts) - min(ts)) if len(ts) > 1 else 0.0
    return {
        "n": len(steps),
        "step_max": max(int(r.get("step", 0)) for r in steps),
        "p50_s": round(_percentile(totals, 50.0), 6),
        "p95_s": round(_percentile(totals, 95.0), 6),
        "pairs_per_sec": round(pairs / dt, 4) if dt > 0 and pairs else None,
    }


def _heartbeat_stats(records: Sequence[Dict[str, Any]]
                     ) -> Dict[str, Dict[str, Any]]:
    """Per-role beat bookkeeping: count, cadence (the ``every_s`` extra,
    else the median inter-beat delta), worst internal gap, last beat's
    monotonic ``t``. Gap-vs-deadline judgment happens fleet-side where
    the aligned end time is known."""
    by_role: Dict[str, List[Dict[str, Any]]] = {}
    for r in records:
        if r.get("event") == "heartbeat":
            by_role.setdefault(str(r.get("role", "?")), []).append(r)
    out: Dict[str, Dict[str, Any]] = {}
    for role, beats in by_role.items():
        ts = sorted(float(b["t"]) for b in beats if "t" in b)
        cadence = None
        for b in beats:
            if isinstance(b.get("every_s"), (int, float)) \
                    and b["every_s"] > 0:
                cadence = float(b["every_s"])
                break
        deltas = [b - a for a, b in zip(ts, ts[1:])]
        if cadence is None and deltas:
            cadence = _percentile(deltas, 50.0)
        out[role] = {
            "beats": len(beats),
            "every_s": cadence,
            "max_gap_s": round(max(deltas), 3) if deltas else 0.0,
            "last_t": ts[-1] if ts else None,
        }
    return out


def _cross_host_traces(hosts: Sequence[Dict[str, Any]]
                       ) -> List[Dict[str, Any]]:
    """Traces whose spans land in more than one host's log, with the
    count of remote parent links (a span whose ``parent_id`` resolves in
    a DIFFERENT host's file — the propagated-context join)."""
    span_host: Dict[str, str] = {}   # span_id -> host_id
    by_trace: Dict[str, List[Dict[str, Any]]] = {}
    for h in hosts:
        for r in h["records"]:
            if r.get("event") != "span":
                continue
            sid = r.get("span_id")
            if isinstance(sid, str):
                span_host.setdefault(sid, h["host_id"])
            tid = r.get("trace_id")
            if isinstance(tid, str):
                by_trace.setdefault(tid, []).append(
                    dict(r, _host=h["host_id"]))
    joins: List[Dict[str, Any]] = []
    for tid, spans in sorted(by_trace.items()):
        host_ids = sorted({s["_host"] for s in spans})
        if len(host_ids) < 2:
            continue
        remote_links = []
        for s in spans:
            parent = s.get("parent_id")
            owner = span_host.get(parent) if isinstance(parent, str) else None
            if owner is not None and owner != s["_host"]:
                remote_links.append({
                    "child": s.get("name"), "child_host": s["_host"],
                    "parent_host": owner})
        joins.append({"trace_id": tid, "hosts": host_ids,
                      "spans": len(spans), "remote_links": remote_links})
    return joins


def aggregate_fleet(fleet_dir: str) -> Dict[str, Any]:
    """Merge N per-host logs into one clock-aligned rollup.

    Per host: identity, clock offset, aligned start/end (epoch seconds),
    clean-exit flag, step-time distribution, heartbeat bookkeeping with
    the tail gap measured against the FLEET's aligned end (a host whose
    beats stop while the rest of the fleet runs on is the dead-host
    signal). Fleet-wide: the skew table (each host's p95 vs the median of
    the others') and cross-host trace joins.
    """
    run_dirs = discover_runs(fleet_dir)
    if not run_dirs:
        raise ValueError(
            f"{fleet_dir}: no run dirs with an events.jsonl underneath")
    hosts = [load_host(d) for d in run_dirs]
    for h in hosts:
        ts = [float(r["t"]) for r in h["records"] if "t" in r]
        h["aligned_start"] = (min(ts) + h["offset"]) if ts else None
        h["aligned_end"] = (max(ts) + h["offset"]) if ts else None
        h["clean_exit"] = any(
            r.get("event") == "run_end" for r in h["records"])
        h["steps"] = _step_stats(h["records"])
        h["heartbeats"] = _heartbeat_stats(h["records"])
    fleet_end = max((h["aligned_end"] for h in hosts
                     if h["aligned_end"] is not None), default=None)
    fleet_start = min((h["aligned_start"] for h in hosts
                       if h["aligned_start"] is not None), default=None)
    for h in hosts:
        for hb in h["heartbeats"].values():
            tail = None
            if hb["last_t"] is not None and fleet_end is not None:
                tail = fleet_end - (hb["last_t"] + h["offset"])
            hb["tail_gap_s"] = round(tail, 3) if tail is not None else None
    # skew table: each stepping host's p95 against the median of the rest
    stepping = [h for h in hosts if h["steps"]]
    skew = []
    for h in stepping:
        others = [o["steps"]["p95_s"] for o in stepping if o is not h]
        ref = _percentile(others, 50.0) if others else None
        skew.append({
            "host_id": h["host_id"],
            "p50_ms": round(h["steps"]["p50_s"] * 1e3, 2),
            "p95_ms": round(h["steps"]["p95_s"] * 1e3, 2),
            "others_p95_ms": round(ref * 1e3, 2) if ref else None,
            "vs_others": (round(h["steps"]["p95_s"] / ref, 2)
                          if ref else None),
        })
    return {
        "fleet_dir": fleet_dir,
        "n_hosts": len(hosts),
        "wall_s": (round(fleet_end - fleet_start, 3)
                   if fleet_end is not None and fleet_start is not None
                   else None),
        "hosts": [{k: v for k, v in h.items() if k != "records"}
                  for h in hosts],
        "skew": skew,
        "cross_host_traces": _cross_host_traces(hosts),
    }


def _verdict(phase: str, verdict: str, evidence: List[str],
             **extra: Any) -> Dict[str, Any]:
    return dict({"phase": phase, "verdict": verdict,
                 "evidence": evidence}, **extra)


def fleet_verdicts(rollup: Dict[str, Any]) -> List[Dict[str, Any]]:
    """STRAGGLER / DEAD_HOST / DESYNC over an :func:`aggregate_fleet`
    rollup; FLEET_OK when nothing fires. Each verdict carries the
    offending ``host`` (machine-checkable attribution) plus evidence
    lines quoting both the host's and the fleet's numbers."""
    verdicts: List[Dict[str, Any]] = []
    dead: set = set()
    # DEAD_HOST first: a dead host's step counter trivially desyncs, so
    # DESYNC must be judged over the survivors only
    for h in rollup["hosts"]:
        if h["clean_exit"]:
            continue  # a clean run_end is an exit, not a death
        for role, hb in sorted(h["heartbeats"].items()):
            if not hb["every_s"]:
                continue
            deadline = DEAD_HOST_GAP_BEATS * hb["every_s"]
            gaps = [g for g in (hb["tail_gap_s"], hb["max_gap_s"])
                    if g is not None]
            worst = max(gaps) if gaps else 0.0
            if worst > deadline:
                dead.add(h["host_id"])
                verdicts.append(_verdict("fleet", "DEAD_HOST", [
                    f"host {h['host_id']} ({role}): last heartbeat "
                    f"{hb['tail_gap_s']}s before the fleet's aligned end "
                    f"(deadline {deadline:.1f}s = "
                    f"{DEAD_HOST_GAP_BEATS:g}x the {hb['every_s']:.1f}s "
                    f"cadence, worst gap {worst:.1f}s)",
                    f"no run_end in its log after {hb['beats']} beat(s) — "
                    f"the process died, it did not exit",
                ], host=h["host_id"]))
                break
    for row in rollup["skew"]:
        if row["vs_others"] is None:
            continue
        steps = next(h["steps"] for h in rollup["hosts"]
                     if h["host_id"] == row["host_id"])
        if steps["n"] - 1 < STRAGGLER_MIN_STEPS:
            continue
        if row["vs_others"] >= STRAGGLER_FACTOR:
            verdicts.append(_verdict("fleet", "STRAGGLER", [
                f"host {row['host_id']}: step p95 {row['p95_ms']}ms = "
                f"{row['vs_others']:.1f}x the other hosts' median p95 "
                f"{row['others_p95_ms']}ms (threshold "
                f"{STRAGGLER_FACTOR:g}x, {steps['n']} steps)",
                "every synchronized collective waits for the slowest "
                "host — fix this one before scaling out",
            ], host=row["host_id"]))
    live = [h for h in rollup["hosts"]
            if h["steps"] and h["host_id"] not in dead]
    if len(live) >= 2:
        lo = min(live, key=lambda h: h["steps"]["step_max"])
        hi = max(live, key=lambda h: h["steps"]["step_max"])
        spread = hi["steps"]["step_max"] - lo["steps"]["step_max"]
        if spread > DESYNC_STEP_MARGIN:
            verdicts.append(_verdict("fleet", "DESYNC", [
                f"live hosts' step counters diverge by {spread}: "
                f"{hi['host_id']} at step {hi['steps']['step_max']} vs "
                f"{lo['host_id']} at step {lo['steps']['step_max']} "
                f"(margin {DESYNC_STEP_MARGIN})",
                "replicas drifting apart means a lost barrier or "
                "divergent data feed — dead hosts are judged separately",
            ], host=lo["host_id"]))
    if not verdicts:
        n = rollup["n_hosts"]
        verdicts.append(_verdict("fleet", "FLEET_OK", [
            f"{n} host(s) aligned: no straggler past "
            f"{STRAGGLER_FACTOR:g}x, no heartbeat gap past "
            f"{DEAD_HOST_GAP_BEATS:g}x cadence, step counters within "
            f"{DESYNC_STEP_MARGIN}",
        ]))
    return verdicts


def diagnose_fleet(fleet_dir: str) -> Dict[str, Any]:
    """The ``cli doctor`` entry for a fleet dir: same report shape as
    obs/doctor.diagnose (``{"run_dir", "verdicts"}``)."""
    return {"run_dir": fleet_dir,
            "verdicts": fleet_verdicts(aggregate_fleet(fleet_dir))}


def build_fleet_timeline(fleet_dir: str,
                         out: Optional[str] = None) -> Dict[str, Any]:
    """One Perfetto timeline for N hosts: a process-group per host (spans
    + an instant-marker track each), every track shifted onto the shared
    aligned clock (zero = the fleet's earliest aligned record)."""
    run_dirs = discover_runs(fleet_dir)
    if not run_dirs:
        raise ValueError(
            f"{fleet_dir}: no run dirs with an events.jsonl underneath")
    from raft_stereo_tpu_torch.obs.timeline import (_instant_events,
                                                    _span_events)
    hosts = [load_host(d) for d in run_dirs]
    starts = []
    for h in hosts:
        ts = [float(r["t"]) for r in h["records"] if "t" in r]
        if ts:
            starts.append(min(ts) + h["offset"])
    fleet_t0 = min(starts) if starts else 0.0
    trace_events: List[Dict[str, Any]] = []
    n_spans = 0
    for i, h in enumerate(hosts):
        pid = 10 * (i + 1)  # spans at pid, markers at pid+1, per host
        shift = h["offset"] - fleet_t0
        spans = [r for r in h["records"] if r.get("event") == "span"]
        n_spans += len(spans)
        trace_events.extend(_span_events(
            spans, pid=pid, process_name=f"{h['host_id']} spans",
            shift_s=shift))
        trace_events.extend(_instant_events(
            h["records"], pid=pid + 1,
            process_name=f"{h['host_id']} events", shift_s=shift))
    out = out or os.path.join(fleet_dir, "fleet_timeline.json")
    with open(out, "w") as f:
        json.dump({"traceEvents": trace_events,
                   "displayTimeUnit": "ms"}, f)
    return {"path": out, "hosts": len(hosts), "spans": n_spans,
            "markers": sum(1 for e in trace_events if e.get("ph") == "i")}


def format_rollup(rollup: Dict[str, Any],
                  verdicts: Optional[List[Dict[str, Any]]] = None) -> str:
    lines = [f"fleet: {rollup['fleet_dir']} — {rollup['n_hosts']} host(s)"
             + (f", {rollup['wall_s']}s aligned wall"
                if rollup["wall_s"] is not None else "")]
    for h in rollup["hosts"]:
        bits = [f"  {h['host_id']}:"]
        s = h["steps"]
        if s:
            pps = f", {s['pairs_per_sec']} pairs/s" \
                if s["pairs_per_sec"] else ""
            bits.append(f"{s['n']} steps (p50 {s['p50_s'] * 1e3:.1f}ms, "
                        f"p95 {s['p95_s'] * 1e3:.1f}ms{pps})")
        for role, hb in sorted(h["heartbeats"].items()):
            tail = f", tail gap {hb['tail_gap_s']}s" \
                if hb["tail_gap_s"] is not None else ""
            bits.append(f"{role} beats {hb['beats']} "
                        f"(max gap {hb['max_gap_s']}s{tail})")
        bits.append("clean exit" if h["clean_exit"] else "NO run_end")
        if not h["anchored"]:
            bits.append("[unanchored: ts-derived offset]")
        lines.append(" ".join(bits))
    if rollup["skew"]:
        lines.append("  skew (p95 vs median of other hosts):")
        for row in rollup["skew"]:
            vs = f"{row['vs_others']:.2f}x" if row["vs_others"] else "n/a"
            lines.append(f"    {row['host_id']}: {row['p95_ms']}ms vs "
                         f"{row['others_p95_ms']}ms -> {vs}")
    joins = rollup["cross_host_traces"]
    lines.append(f"  cross-host traces: {len(joins)}")
    for j in joins:
        links = "; ".join(
            f"{l['child']}@{l['child_host']} <- {l['parent_host']}"
            for l in j["remote_links"]) or "no resolved remote parent"
        lines.append(f"    {j['trace_id']}: {j['spans']} spans across "
                     f"{'/'.join(j['hosts'])} ({links})")
    for v in verdicts or []:
        lines.append(f"  [{v['phase']}] {v['verdict']}")
        for e in v["evidence"]:
            lines.append(f"    - {e}")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    from raft_stereo_tpu_torch.cli import build_fleet_parser
    args = build_fleet_parser().parse_args(argv)
    try:
        rollup = aggregate_fleet(args.fleet_dir)
        timeline = build_fleet_timeline(args.fleet_dir, out=args.out)
    except (FileNotFoundError, ValueError) as e:
        print(f"fleet: {e}")
        return 1
    verdicts = fleet_verdicts(rollup)
    report = dict(rollup, verdicts=verdicts, timeline=timeline)
    rollup_path = os.path.join(args.fleet_dir, "fleet_rollup.json")
    with open(rollup_path, "w") as f:
        json.dump(report, f, indent=2)
    if args.json:
        print(json.dumps(report, indent=2))
    else:
        print(format_rollup(rollup, verdicts))
        print(f"  rollup: {rollup_path}\n  timeline: {timeline['path']} "
              f"({timeline['hosts']} process-groups, {timeline['spans']} "
              "spans) — load at ui.perfetto.dev")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
