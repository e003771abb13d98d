"""The bottleneck diagnosis (the port's copy of
``raft_stereo_tpu/obs/doctor.py``):
``python -m raft_stereo_tpu_torch.cli doctor <run_dir>`` names the dominant
bottleneck of each phase a run's log holds (train steps, served requests),
with the evidence lines that earned it.

* **STALLED**: the stall watchdog fired; it trumps everything, since rate
  analysis of a wedged run is noise.
* **COMPILE_STORM**: compilations ate a large share of the wall clock.
* **QUEUE_SATURATED** (serve): requests spend most of their latency
  waiting for admission into a batch.
* **DATA_STARVED** (train): the median step's data_wait share is dominant.
* **COMPUTE_BOUND**: the device-side phases dominate.
* **BALANCED**: nothing dominates; **UNKNOWN** only when the log holds no
  usable evidence.
* **OVER_ITERATED** (``converge`` phase): the recorded curves show p95 of
  frames or requests settled (residual <= obs/converge.py's DOCTOR_TAU)
  well before the iteration budget.
* **NONFINITE_ORIGIN / BF16_SATURATION / GRAD_EXPLOSION /
  NUMERICS_CLEAN** (``numerics`` phase), in that priority order, from the
  ``numerics`` records.
* **STRAGGLER / DEAD_HOST / DESYNC / FLEET_OK** (``fleet`` phase): pointed
  at a directory of per-host run dirs instead of one run, doctor routes to
  obs/fleet.py's cross-host verdicts.

Rules, thresholds and evidence text are the JAX package's, so that both
tools give one log the same diagnosis.
"""

from __future__ import annotations

import os
from typing import Any, Dict, List, Optional, Sequence

from raft_stereo_tpu_torch.obs.events import read_events
from raft_stereo_tpu_torch.obs.summarize import _percentiles

# rule thresholds (fractions of wall / latency)
COMPILE_STORM_MIN_EVENTS = 3
COMPILE_STORM_WALL_FRAC = 0.5
DATA_STARVED_FRAC = 0.4
COMPUTE_BOUND_FRAC = 0.6
QUEUE_SATURATED_FRAC = 0.5
# OVER_ITERATED: p95 exit iteration must undercut the budget by at least
# this many iterations (a 1-iteration margin is measurement noise, not a
# tuning opportunity), over at least this many curves
OVER_ITERATED_MARGIN = 2
OVER_ITERATED_MIN_CURVES = 4


def _median(xs: Sequence[float]) -> float:
    return _percentiles(list(xs))["p50"] if xs else 0.0


def _verdict(phase: str, verdict: str,
             evidence: List[str]) -> Dict[str, Any]:
    return {"phase": phase, "verdict": verdict, "evidence": evidence}


def _wall_s(records: Sequence[Dict[str, Any]]) -> float:
    ts = [float(r["t"]) for r in records if "t" in r]
    return (max(ts) - min(ts)) if len(ts) > 1 else 0.0


def _check_stall(records, phase: str) -> Optional[Dict[str, Any]]:
    stalls = [r for r in records if r.get("event") == "stall"]
    if not stalls:
        return None
    worst = max(float(r.get("seconds_since_step", 0.0)) for r in stalls)
    return _verdict(phase, "STALLED", [
        f"stall watchdog fired {len(stalls)}x; worst gap "
        f"{worst:.1f}s since the last completed step",
        "rate analysis suppressed: a wedged run's steady-state numbers "
        "are noise — check the flight-recorder dump and the device link",
    ])


def _check_compile_storm(records, phase: str,
                         wall: float) -> Optional[Dict[str, Any]]:
    compiles = [r for r in records if r.get("event") == "compile"]
    total = sum(float(r.get("duration_s", 0.0)) for r in compiles)
    if (len(compiles) >= COMPILE_STORM_MIN_EVENTS and wall > 0
            and total > COMPILE_STORM_WALL_FRAC * wall):
        return _verdict(phase, "COMPILE_STORM", [
            f"{len(compiles)} compilations totaling {total:.1f}s = "
            f"{total / wall:.0%} of the {wall:.1f}s wall clock",
            "look for shape churn (bucket spread, microbatch breaks) or "
            "a cold/invalidated compilation cache",
        ])
    return None


def _diagnose_train(records) -> Optional[Dict[str, Any]]:
    # step records in a serving log are the loadtest's per-request
    # accounting (serve/loadtest.py), not a train loop — the request
    # records carry that story; steps with in_flight are eval frames
    if any(r.get("event") == "request" for r in records):
        return None
    steps = [r for r in records
             if r.get("event") == "step" and "in_flight" not in r]
    if not steps:
        return None
    phase = "train"
    hit = _check_stall(records, phase)
    if hit:
        return hit
    wall = _wall_s(records)
    hit = _check_compile_storm(records, phase, wall)
    if hit:
        return hit
    # skip the first step: its dispatch leg carries compilation
    body = steps[1:] or steps
    waits = [float(r.get("data_wait_s", 0.0)) for r in body]
    disps = [float(r.get("dispatch_s", 0.0)) for r in body]
    fetches = [float(r.get("fetch_s", 0.0)) for r in body]
    totals = [w + d + f for w, d, f in zip(waits, disps, fetches)]
    med_total = _median(totals)
    if med_total <= 0:
        return _verdict(phase, "UNKNOWN",
                        ["step records carry no usable phase timing"])
    wait_frac = _median(waits) / med_total
    dev_frac = _median([d + f for d, f in zip(disps, fetches)]) / med_total
    if wait_frac > DATA_STARVED_FRAC:
        evidence = [
            f"median step: data_wait {_median(waits) * 1e3:.1f}ms of "
            f"{med_total * 1e3:.1f}ms ({wait_frac:.0%}) over "
            f"{len(body)} steps"]
        loaders = [r for r in records if r.get("event") == "loader"]
        if loaders:
            depths = [float(r.get("queue_depth", 0)) for r in loaders]
            evidence.append(
                f"loader prefetch queue depth: median {_median(depths):.0f}"
                f" (0 = producer cannot keep up)")
        evidence.append("raise decode workers / prefetch before touching "
                        "the model")
        return _verdict(phase, "DATA_STARVED", evidence)
    if dev_frac >= COMPUTE_BOUND_FRAC:
        return _verdict(phase, "COMPUTE_BOUND", [
            f"median step: dispatch+fetch "
            f"{_median([d + f for d, f in zip(disps, fetches)]) * 1e3:.1f}"
            f"ms of {med_total * 1e3:.1f}ms ({dev_frac:.0%}) over "
            f"{len(body)} steps",
            "the pipeline keeps the device fed; wins come from the "
            "model/compiler (serial-floor work, ROADMAP item 1)",
        ])
    return _verdict(phase, "BALANCED", [
        f"median step {med_total * 1e3:.1f}ms: data_wait {wait_frac:.0%}, "
        f"device {dev_frac:.0%} — no phase dominates",
    ])


def _diagnose_serve(records) -> Optional[Dict[str, Any]]:
    requests = [r for r in records if r.get("event") == "request"]
    if not requests:
        return None
    phase = "serve"
    hit = _check_stall(records, phase)
    if hit:
        return hit
    hit = _check_compile_storm(records, phase, _wall_s(records))
    if hit:
        return hit
    lats = [float(r.get("latency_s", 0.0)) for r in requests]
    waits = [float(r.get("queue_wait_s", 0.0)) for r in requests]
    med_lat = _median(lats)
    if med_lat <= 0:
        return _verdict(phase, "UNKNOWN",
                        ["request records carry no usable latency"])
    wait_frac = _median(waits) / med_lat
    rejected = 0
    for r in records:
        if r.get("event") in ("queue", "slo"):
            rejected = max(rejected, int(r.get("rejected", 0)))
    if wait_frac > QUEUE_SATURATED_FRAC:
        evidence = [
            f"median request: queue_wait {_median(waits) * 1e3:.1f}ms of "
            f"{med_lat * 1e3:.1f}ms latency ({wait_frac:.0%}) over "
            f"{len(requests)} requests"]
        if rejected:
            evidence.append(f"{rejected} submits shed by backpressure — "
                            f"offered load exceeds service rate")
        depths = [int(r.get("depth", 0)) for r in records
                  if r.get("event") == "queue"]
        if depths:
            evidence.append(f"admission queue depth: median "
                            f"{_median([float(d) for d in depths]):.0f}, "
                            f"max {max(depths)}")
        evidence.append("scale out, raise max_batch/window, or shed "
                        "earlier")
        return _verdict(phase, "QUEUE_SATURATED", evidence)
    return _verdict(phase, "COMPUTE_BOUND", [
        f"median request: queue_wait {wait_frac:.0%} of "
        f"{med_lat * 1e3:.1f}ms latency over {len(requests)} requests — "
        f"time goes to the device, not the queue",
        "bigger wins come from the compiled program (bucket/batch "
        "shape), not admission tuning",
    ])


def _diagnose_converge(records) -> Optional[Dict[str, Any]]:
    """OVER_ITERATED: the recorded convergence curves prove the iteration
    budget overshoots where the estimate stops moving."""
    from raft_stereo_tpu_torch.obs.converge import (DOCTOR_TAU,
                                                    exit_percentile)
    curves = [r for r in records if r.get("event") == "converge"]
    if len(curves) < OVER_ITERATED_MIN_CURVES:
        return None
    ev = exit_percentile(curves, tau=DOCTOR_TAU, q=95.0)
    if ev is None:
        return None
    budget, p95 = ev["budget"], ev["exit_iter"]
    if p95 > budget - OVER_ITERATED_MARGIN:
        return None
    return _verdict("converge", "OVER_ITERATED", [
        f"p95 converged by iter {p95} of {budget} (residual <= "
        f"{ev['tau']}px over {ev['n']} curves, "
        f"{ev['n_converged']}/{ev['n']} converged within budget)",
        f"the last {budget - p95} iterations refine disparities that "
        f"have stopped moving — device time with no quality return",
        "freeze the operating point into a policy with `cli converge "
        "<run_dir> --emit-policy iter_policy.json` and serve it via "
        "--iter_policy — the compiled early exit banks these savings "
        "per sample instead of lowering the budget for everyone",
    ])


def _diagnose_numerics(records) -> Optional[Dict[str, Any]]:
    """The numerics observatory's verdict, in severity order:
    NONFINITE_ORIGIN > BF16_SATURATION > GRAD_EXPLOSION > NUMERICS_CLEAN.
    None when the run recorded no numerics events (pre-v9 artifacts)."""
    from raft_stereo_tpu_torch.obs.numerics import (GRAD_ALARM_NORM,
                                                    split_label)
    numerics = [r for r in records if r.get("event") == "numerics"]
    if not numerics:
        return None
    phase = "numerics"
    grads = [r for r in numerics if r.get("kind") == "grad"]
    taps = [r for r in numerics if r.get("kind") == "taps"]
    # 1) non-finite provenance — a NaN origin trumps everything else
    for r in taps:
        fnf = r.get("first_nonfinite")
        if fnf:
            return _verdict(phase, "NONFINITE_ORIGIN", [
                f"first non-finite values at tap '{fnf.get('tap')}' "
                f"iteration {fnf.get('iter')} ({fnf.get('count')} "
                f"elements; source {r.get('source')})",
                "every later NaN is downstream of this site — fix the "
                "producer, not the symptoms",
                "full per-tap series: `cli numerics <run_dir>`",
            ])
    for r in grads:
        bad = [n for n, v in zip(r.get("leaves", []),
                                 r.get("grad_norm", [])) if v is None]
        if bad:
            return _verdict(phase, "NONFINITE_ORIGIN", [
                f"non-finite gradient norm at step {r.get('step')} in "
                f"{len(bad)} leaf/leaves; first: {bad[0]}",
                "the anomaly guard skips these updates; the named leaf "
                "is where the backward first blew up",
                "full per-leaf trend: `cli numerics <run_dir>`",
            ])
    # 2) bf16 rail hits — silent clipping that precedes overflow-to-inf
    sat_by_tap: Dict[str, int] = {}
    for r in taps:
        for key, series in (r.get("taps") or {}).items():
            s = sum(int(v) for v in series.get("sat", []) if v)
            if s:
                label = split_label(key)[1] if ":" in key else key
                sat_by_tap[label] = sat_by_tap.get(label, 0) + s
    if sat_by_tap:
        worst = max(sat_by_tap, key=lambda k: sat_by_tap[k])
        return _verdict(phase, "BF16_SATURATION", [
            f"{sum(sat_by_tap.values())} values at the bf16 finite rail "
            f"across {len(sat_by_tap)} tap(s); worst: '{worst}' "
            f"({sat_by_tap[worst]} hits)",
            "values at the rail clip silently and overflow to inf one "
            "scale later — rescale or lift this stack to fp32",
            "saturation leaderboard: `cli numerics <run_dir>`",
        ])
    # 3) finite but exploding gradients
    worst_leaf, worst_norm, worst_step = None, 0.0, None
    for r in grads:
        for name, v in zip(r.get("leaves", []), r.get("grad_norm", [])):
            if v is not None and float(v) > worst_norm:
                worst_leaf, worst_norm = name, float(v)
                worst_step = r.get("step")
    if worst_leaf is not None and worst_norm > GRAD_ALARM_NORM:
        return _verdict(phase, "GRAD_EXPLOSION", [
            f"leaf '{worst_leaf}' gradient norm {worst_norm:.3g} at step "
            f"{worst_step} (alarm threshold {GRAD_ALARM_NORM:g})",
            "clip harder, lower the LR, or check this leaf's input "
            "statistics before it goes non-finite",
            "per-leaf trend: `cli numerics <run_dir>`",
        ])
    n_taps = sum(len(r.get("taps") or {}) for r in taps)
    return _verdict(phase, "NUMERICS_CLEAN", [
        f"{len(grads)} grad record(s) and {len(taps)} tap record(s) "
        f"({n_taps} tap series): all finite, no bf16 rail hits, no "
        f"gradient norm above {GRAD_ALARM_NORM:g}",
    ])


def diagnose(run_dir: str) -> Dict[str, Any]:
    """Diagnose one run dir; returns ``{"run_dir", "verdicts": [...]}``.

    ``verdicts`` holds one entry per phase with evidence; a log with
    neither steps nor requests yields a single UNKNOWN verdict. A
    directory WITHOUT its own events.jsonl but holding child run dirs
    that have one is a fleet dir: the report routes to the fleet
    observatory's cross-host verdicts (obs/fleet.py).
    """
    events_path = (os.path.join(run_dir, "events.jsonl")
                   if os.path.isdir(run_dir) else run_dir)
    if os.path.isdir(run_dir) and not os.path.exists(events_path):
        from raft_stereo_tpu_torch.obs import fleet
        if fleet.discover_runs(run_dir):
            return fleet.diagnose_fleet(run_dir)
    records = read_events(events_path)
    verdicts = [v for v in (_diagnose_train(records),
                            _diagnose_serve(records),
                            _diagnose_converge(records),
                            _diagnose_numerics(records)) if v is not None]
    if not verdicts:
        verdicts = [_verdict("run", "UNKNOWN", [
            "no step or request records — nothing to diagnose"])]
    return {"run_dir": run_dir, "verdicts": verdicts}


def format_diagnosis(report: Dict[str, Any]) -> str:
    lines = [f"doctor: {report['run_dir']}"]
    for v in report["verdicts"]:
        lines.append(f"  [{v['phase']}] {v['verdict']}")
        for e in v["evidence"]:
            lines.append(f"    - {e}")
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    from raft_stereo_tpu_torch.cli import build_doctor_parser
    args = build_doctor_parser().parse_args(argv)
    try:
        report = diagnose(args.run_dir)
    except (FileNotFoundError, ValueError) as e:
        print(f"doctor: {e}")
        return 1
    if getattr(args, "json"):
        import json
        print(json.dumps(report, indent=2))
    else:
        print(format_diagnosis(report))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
