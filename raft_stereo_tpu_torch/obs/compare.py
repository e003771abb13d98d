"""The two-run regression gate (the port's copy of
``raft_stereo_tpu/obs/compare.py``): ``python -m raft_stereo_tpu_torch.cli
compare <baseline> <candidate>``.

Each run's ``events.jsonl`` is reduced to comparable scalars, and the
candidate fails (exit 1) when any of them moves past its threshold in the
bad direction:

* ``throughput_pairs_per_sec``: the best ``throughput`` record; higher is
  better;
* the per-phase step percentiles (``data_wait/dispatch/fetch`` p50/p90);
  lower is better;
* ``peak_memory_bytes``: the largest of the ``memory`` stats and the
  ``xla_memory`` records; lower is better;
* ``compile_total_s``: the summed ``compile`` records; lower is better.

A metric that one run lacks is skipped, not failed, and the report names
it. A run with no readable events is an error (exit 2): "nothing to
compare" never reads as "no regression".
"""

from __future__ import annotations

import json
import os
import sys
from typing import Any, Dict, List, Optional, Sequence

from raft_stereo_tpu_torch.obs.events import read_events

_PHASES = ("data_wait_s", "dispatch_s", "fetch_s")

# Default relative thresholds, the JAX package's (so that both gates judge
# a pair of runs alike): throughput is the steadiest metric, phase
# percentiles and compile times are noisier (host scheduling, cache
# warmth), so their gates are looser.
DEFAULT_THRESHOLDS = {
    "throughput_drop": 0.03,    # candidate pairs/sec below baseline by >3%
    "phase_increase": 0.25,     # any phase percentile worse by >25%
    "memory_growth": 0.05,      # peak bytes above baseline by >5%
    "compile_growth": 0.50,     # total compile seconds above baseline by >50%
}


def _percentile(values: Sequence[float], q: float) -> float:
    import numpy as np
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def extract_metrics(run_dir: str) -> Optional[Dict[str, float]]:
    """Reduce a run dir's events.jsonl to the gate's comparable scalars.

    Returns None when the run left no parseable events (the caller decides
    whether that is an error or a skip).
    """
    path = run_dir
    if os.path.isdir(path):
        path = os.path.join(path, "events.jsonl")
    if not os.path.exists(path):
        return None
    try:
        events = read_events(path)
    except ValueError:
        return None
    if not events:
        return None
    by = lambda kind: [e for e in events if e.get("event") == kind]  # noqa: E731

    metrics: Dict[str, float] = {}
    tp = [e["pairs_per_sec"] for e in by("throughput")
          if isinstance(e.get("pairs_per_sec"), (int, float))]
    if tp:
        metrics["throughput_pairs_per_sec"] = max(tp)

    steps = by("step")
    for phase in _PHASES:
        vals = [s[phase] for s in steps
                if isinstance(s.get(phase), (int, float))]
        if vals:
            metrics[f"{phase}_p50"] = _percentile(vals, 50)
            metrics[f"{phase}_p90"] = _percentile(vals, 90)

    peaks: List[float] = []
    for e in by("memory"):
        stats = e.get("stats") or {}
        v = stats.get("peak_bytes_in_use", stats.get("bytes_in_use"))
        if isinstance(v, (int, float)):
            peaks.append(float(v))
    for e in by("xla_memory"):
        if isinstance(e.get("peak_bytes"), (int, float)):
            peaks.append(float(e["peak_bytes"]))
    if peaks:
        metrics["peak_memory_bytes"] = max(peaks)

    compiles = [e.get("duration_s", 0.0) for e in by("compile")]
    if compiles:
        metrics["compile_total_s"] = float(sum(compiles))
    return metrics


def _gate(metric: str, thresholds: Dict[str, float]):
    """(threshold key, higher_is_better) for one metric name."""
    if metric == "throughput_pairs_per_sec":
        return "throughput_drop", True
    if metric == "peak_memory_bytes":
        return "memory_growth", False
    if metric == "compile_total_s":
        return "compile_growth", False
    return "phase_increase", False  # the per-phase percentiles


def compare_runs(baseline_dir: str, candidate_dir: str,
                 thresholds: Optional[Dict[str, float]] = None
                 ) -> Dict[str, Any]:
    """Build the comparison report; see module doc for semantics."""
    thr = dict(DEFAULT_THRESHOLDS)
    if thresholds:
        thr.update({k: v for k, v in thresholds.items() if v is not None})
    base = extract_metrics(baseline_dir)
    cand = extract_metrics(candidate_dir)
    report: Dict[str, Any] = {
        "baseline": baseline_dir, "candidate": candidate_dir,
        "thresholds": thr, "metrics": {}, "regressions": [], "skipped": [],
    }
    if cand is None or base is None:
        report["error"] = ("candidate has no readable events.jsonl"
                           if cand is None
                           else "baseline has no readable events.jsonl")
        report["ok"] = False
        return report
    for name in sorted(set(base) | set(cand)):
        if name not in base or name not in cand:
            report["skipped"].append(name)
            continue
        a, b = base[name], cand[name]
        key, higher_better = _gate(name, thr)
        # relative move in the BAD direction ("rel" > 0 = candidate worse)
        if a == 0:
            rel = 0.0 if b == 0 else float("inf")
        else:
            rel = (a - b) / a if higher_better else (b - a) / a
        regressed = rel > thr[key]
        report["metrics"][name] = {
            "baseline": a, "candidate": b,
            "regression_rel": round(rel, 5) if rel != float("inf") else None,
            "threshold": thr[key], "ok": not regressed,
        }
        if regressed:
            report["regressions"].append(name)
    report["ok"] = not report["regressions"]
    return report


def format_comparison(report: Dict[str, Any]) -> str:
    lines = [f"baseline:  {report['baseline']}",
             f"candidate: {report['candidate']}"]
    if report.get("error"):
        lines.append(f"ERROR: {report['error']}")
        return "\n".join(lines)
    lines.append("")
    lines.append(f"{'metric':28s} {'baseline':>14s} {'candidate':>14s} "
                 f"{'worse by':>9s}  gate")
    for name, m in report["metrics"].items():
        rel = m["regression_rel"]
        rel_s = "inf" if rel is None else f"{100 * rel:+.1f}%"
        lines.append(f"{name:28s} {m['baseline']:14.6g} "
                     f"{m['candidate']:14.6g} {rel_s:>9s}  "
                     f"{'ok' if m['ok'] else 'REGRESSED'}")
    for name in report["skipped"]:
        lines.append(f"{name:28s} {'(skipped: present in one run only)'}")
    lines.append("")
    if report["regressions"]:
        lines.append("REGRESSION: " + ", ".join(report["regressions"]))
    else:
        lines.append("ok: no metric moved past its threshold")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        description="Regression-gate two runs' events.jsonl "
                    "(exit 1 on regression, 2 on unreadable input)")
    p.add_argument("baseline", help="baseline run dir (or events.jsonl)")
    p.add_argument("candidate", help="candidate run dir (or events.jsonl)")
    p.add_argument("--max-throughput-drop", type=float, default=None,
                   help=f"relative drop tolerated "
                        f"(default {DEFAULT_THRESHOLDS['throughput_drop']})")
    p.add_argument("--max-phase-increase", type=float, default=None,
                   help=f"relative phase-percentile increase tolerated "
                        f"(default {DEFAULT_THRESHOLDS['phase_increase']})")
    p.add_argument("--max-memory-growth", type=float, default=None,
                   help=f"relative peak-memory growth tolerated "
                        f"(default {DEFAULT_THRESHOLDS['memory_growth']})")
    p.add_argument("--max-compile-growth", type=float, default=None,
                   help=f"relative compile-time growth tolerated "
                        f"(default {DEFAULT_THRESHOLDS['compile_growth']})")
    p.add_argument("--json", default=None,
                   help="write the full report to this path; '-' prints "
                        "the report JSON to stdout INSTEAD of the text "
                        "table (for machine consumers)")
    args = p.parse_args(argv)
    report = compare_runs(args.baseline, args.candidate, thresholds={
        "throughput_drop": args.max_throughput_drop,
        "phase_increase": args.max_phase_increase,
        "memory_growth": args.max_memory_growth,
        "compile_growth": args.max_compile_growth,
    })
    if args.json == "-":
        json.dump(report, sys.stdout, indent=1)
        sys.stdout.write("\n")
    else:
        if args.json:
            os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
            with open(args.json, "w") as f:
                json.dump(report, f, indent=1)
        print(format_comparison(report))
    if report.get("error"):
        return 2
    return 0 if report["ok"] else 1
