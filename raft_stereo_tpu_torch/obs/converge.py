"""Convergence curves and the iteration policy (the port's copy of
``raft_stereo_tpu/obs/converge.py``).

The test-mode forward measures, per iteration, how far the GRU still moves
the disparity field (``RAFTStereo.forward(..., iter_metrics=...)``) and,
given ground truth, the low-res EPE.

* :func:`converge_payload` / :func:`emit` downsample one curve (strictly
  increasing iteration indices, both endpoints kept) and put a schema-v8
  ``converge`` record on the telemetry bus: one an evaluated frame or a
  served request.
* :func:`simulate` / :func:`decision_table` replay recorded curves
  against exit thresholds τ (exit at the first iteration whose residual
  drops to τ), without running the model: iterations saved and the
  predicted EPE change, per source and shape bucket.
* :func:`build_policy` / :func:`load_policy` / :func:`policy_digest` /
  :func:`policy_lookup`: the table frozen into a per-bucket iteration
  policy (τ, budget, min_iters, and the row that earned each entry) that
  the adaptive forward runs on (``StereoPredictor(iter_policy=...)``,
  ``evaluate --iter_policy``, ``serve --iter_policy``). ``load_policy``
  lints it (obs/validate.py).
* :func:`main`: ``python -m raft_stereo_tpu_torch.obs.converge <run_dir>
  [--emit-policy p.json]``.

The curves are mean |Δ disparity| in low-res pixels: τ is "what one more
iteration would still move".
"""

from __future__ import annotations

import json
import math
import os
import sys
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

#: stored points per curve (endpoints always kept; the full curve when the
#: iteration budget is already this small)
DEFAULT_MAX_POINTS = 32

#: default early-exit threshold grid (mean |Δ disparity|, low-res px)
DEFAULT_TAUS = (0.5, 0.2, 0.1, 0.05, 0.02, 0.01)

#: the JAX package's doctor's "converged" threshold, the policy default
DOCTOR_TAU = 0.05


def downsample(values: Sequence[float],
               max_points: int = DEFAULT_MAX_POINTS
               ) -> Tuple[List[int], List[float]]:
    """At most ``max_points`` strictly increasing indices covering
    ``[0, n-1]`` (both endpoints kept, a uniform stride between) and the
    values there."""
    n = len(values)
    if n == 0:
        return [], []
    max_points = max(max_points, 2)
    if n <= max_points:
        idx = list(range(n))
    else:
        idx = sorted({round(i * (n - 1) / (max_points - 1))
                      for i in range(max_points)})
    return idx, [float(values[i]) for i in idx]


def half_life(idx: Sequence[int], residual: Sequence[float]) -> Optional[int]:
    """The first stored iteration index whose residual fell to half the
    first one; None when none did."""
    if not residual:
        return None
    target = residual[0] / 2.0
    for i, v in zip(idx, residual):
        if v <= target:
            return int(i)
    return None


def converge_payload(source: str, iters: int, residual: Sequence[float], *,
                     epe: Optional[Sequence[float]] = None,
                     bucket: Optional[str] = None,
                     max_points: int = DEFAULT_MAX_POINTS,
                     **extra: Any) -> Dict[str, Any]:
    """One ``converge`` record's payload from a full-length curve."""
    idx, res = downsample(residual, max_points)
    payload: Dict[str, Any] = {
        "source": source, "iters": int(iters), "idx": idx, "residual": res,
    }
    if epe is not None:
        payload["epe"] = [float(epe[i]) for i in idx]
    if bucket is not None:
        payload["bucket"] = bucket
    if res:
        payload["final_residual"] = res[-1]
        hl = half_life(idx, res)
        if hl is not None:
            payload["half_life"] = hl
    payload.update(extra)
    return payload


def emit(telemetry, source: str, iters: int, residual: Sequence[float], *,
         epe: Optional[Sequence[float]] = None,
         bucket: Optional[str] = None, **extra: Any) -> None:
    """Downsample and emit one curve; nothing without a telemetry sink."""
    if telemetry is None:
        return
    telemetry.emit("converge", **converge_payload(
        source, iters, residual, epe=epe, bucket=bucket, **extra))


# --- the early-exit simulator ----------------------------------------------

def load_records(path: str) -> List[Dict[str, Any]]:
    """All ``converge`` records from a run dir (or events.jsonl path)."""
    from raft_stereo_tpu_torch.obs.events import read_events
    if os.path.isdir(path):
        path = os.path.join(path, "events.jsonl")
    if not os.path.exists(path):
        return []
    return [r for r in read_events(path) if r.get("event") == "converge"]


def exit_iter(idx: Sequence[int], residual: Sequence[float],
              tau: float) -> Optional[int]:
    """Iterations an early-exit policy at threshold tau would have spent:
    idx[k]+1 at the first stored point with residual <= tau (None when the
    curve never converged within the recorded budget)."""
    for i, v in zip(idx, residual):
        if v <= tau:
            return int(i) + 1
    return None


def simulate(rec: Dict[str, Any], tau: float) -> Dict[str, Any]:
    """What exiting at tau would have done to ONE recorded curve."""
    iters = int(rec["iters"])
    used = exit_iter(rec["idx"], rec["residual"], tau)
    converged = used is not None
    used = used if converged else iters
    out = {"converged": converged, "exit_iter": used,
           "saved": iters - used, "epe_delta": None}
    epe = rec.get("epe")
    if epe:
        k = rec["idx"].index(used - 1) if converged else len(epe) - 1
        out["epe_delta"] = float(epe[k]) - float(epe[-1])
    return out


def _percentile(values: List[float], q: float) -> float:
    """Nearest-rank percentile (the serve/slo.py convention)."""
    if not values:
        return float("nan")
    vals = sorted(values)
    rank = max(1, math.ceil(q / 100.0 * len(vals)))
    return vals[rank - 1]


def exit_percentile(records: Iterable[Dict[str, Any]], tau: float = DOCTOR_TAU,
                    q: float = 95.0) -> Optional[Dict[str, Any]]:
    """"By which iteration had q% of frames converged (at tau)?" — over-
    iteration evidence. Never-converged curves count as the full budget, so
    the percentile cannot claim headroom convergence didn't earn."""
    recs = list(records)
    if not recs:
        return None
    exits, n_conv = [], 0
    for r in recs:
        sim = simulate(r, tau)
        exits.append(float(sim["exit_iter"]))
        n_conv += bool(sim["converged"])
    return {"n": len(recs), "n_converged": n_conv, "tau": tau, "q": q,
            "budget": max(int(r["iters"]) for r in recs),
            "exit_iter": int(_percentile(exits, q))}


def decision_table(records: Iterable[Dict[str, Any]],
                   taus: Sequence[float] = DEFAULT_TAUS,
                   bucket_by: str = "both") -> List[Dict[str, Any]]:
    """The ROADMAP 1(b) decision table over recorded curves.

    One row per (source, bucket granularity, tau): how many curves, the
    p50/p95 exit iteration, mean predicted iterations saved, and the mean
    predicted EPE delta (None when no curve carried the EPE aux).
    ``bucket_by``: "bucket" (per shape bucket), "all" (collapsed), or
    "both".
    """
    groups: Dict[Tuple[str, str], List[Dict[str, Any]]] = {}
    for rec in records:
        source = str(rec.get("source", "?"))
        keys = []
        if bucket_by in ("bucket", "both"):
            keys.append((source, str(rec.get("bucket", "?"))))
        if bucket_by in ("all", "both"):
            keys.append((source, "*"))
        for key in keys:
            groups.setdefault(key, []).append(rec)
    rows: List[Dict[str, Any]] = []
    for (source, bucket) in sorted(groups):
        recs = groups[(source, bucket)]
        budget = max(int(r["iters"]) for r in recs)
        for tau in taus:
            sims = [simulate(r, tau) for r in recs]
            exits = [float(s["exit_iter"]) for s in sims]
            deltas = [s["epe_delta"] for s in sims
                      if s["epe_delta"] is not None]
            rows.append({
                "source": source, "bucket": bucket, "tau": tau,
                "n": len(recs), "budget": budget,
                "converged_frac": sum(s["converged"] for s in sims)
                / len(sims),
                "exit_p50": int(_percentile(exits, 50.0)),
                "exit_p95": int(_percentile(exits, 95.0)),
                "saved_mean": sum(s["saved"] for s in sims) / len(sims),
                "epe_delta_mean": (sum(deltas) / len(deltas)
                                   if deltas else None),
                "n_epe": len(deltas),
            })
    return rows


# --- the recorded iteration policy (the actuation half) ---------------------

#: current iter_policy.json schema version
POLICY_VERSION = 1
#: top-level marker that routes a JSON artifact to the policy lint
POLICY_KIND = "iter_policy"


def build_policy(records: Iterable[Dict[str, Any]], *,
                 tau: float = DOCTOR_TAU, min_iters: int = 1,
                 margin: int = 1, source_run: str = "?") -> Dict[str, Any]:
    """Distill recorded curves into a per-bucket iteration policy.

    One entry per shape bucket (plus a ``default`` from the collapsed
    ``"*"`` rows): exit threshold ``tau``, iteration ``budget`` =
    ``exit_p95 + margin`` clamped to the recorded budget (the p95 exit
    plus safety margin — the policy must not cost quality the table never
    predicted), and ``min_iters``. Every entry carries provenance — the
    source run and the decision-table row that earned it — so the lint
    (obs/validate.py check_iter_policy) can hold the numbers referentially
    against their origin. When several sources share a bucket the LARGEST
    candidate budget wins (the conservative merge).
    """
    recs = list(records)
    if not recs:
        raise ValueError("no converge records to build a policy from")
    rows = decision_table(recs, taus=(float(tau),), bucket_by="both")

    def entry_of(row: Dict[str, Any]) -> Dict[str, Any]:
        budget = min(int(row["budget"]), int(row["exit_p95"]) + int(margin))
        budget = max(1, budget)
        return {
            "tau": float(row["tau"]),
            "budget": budget,
            "min_iters": max(1, min(int(min_iters), budget)),
            "provenance": {"source": row["source"], "row": dict(row)},
        }

    buckets: Dict[str, Dict[str, Any]] = {}
    default: Optional[Dict[str, Any]] = None
    for row in rows:
        e = entry_of(row)
        if row["bucket"] == "*":
            if default is None or e["budget"] > default["budget"]:
                default = e
        elif row["bucket"] != "?":
            cur = buckets.get(row["bucket"])
            if cur is None or e["budget"] > cur["budget"]:
                buckets[row["bucket"]] = e
    doc: Dict[str, Any] = {
        "kind": POLICY_KIND, "version": POLICY_VERSION,
        "source_run": source_run, "buckets": buckets,
    }
    if default is not None:
        doc["default"] = default
    return doc


def policy_digest(doc: Dict[str, Any]) -> str:
    """Short stable digest of a policy doc — the serve cache-flavor key
    (serve/cache.py) and the provenance stamp on emitted events."""
    import hashlib
    blob = json.dumps(doc, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def load_policy(path: str) -> Dict[str, Any]:
    """Load + lint one ``iter_policy.json``; raises ValueError with the
    first named violation — a doctored policy must fail at load, not at
    serve time."""
    with open(path) as f:
        doc = json.load(f)
    from raft_stereo_tpu_torch.obs.validate import check_iter_policy
    errors = check_iter_policy(doc)
    if errors:
        raise ValueError(f"{path}: {errors[0]}"
                         + (f" (+{len(errors) - 1} more)"
                            if len(errors) > 1 else ""))
    return doc


def policy_lookup(doc: Dict[str, Any],
                  bucket: Optional[str]) -> Optional[Dict[str, Any]]:
    """Resolve one bucket (``"HxW"``) to its policy entry; falls back to
    the ``default`` entry, then None (caller keeps the fixed trip)."""
    if bucket is not None:
        e = doc.get("buckets", {}).get(bucket)
        if e is not None:
            return e
    return doc.get("default")


def format_table(rows: List[Dict[str, Any]]) -> str:
    """Render the decision table for the terminal."""
    header = (f"{'source':<18} {'bucket':<12} {'tau':>6} {'n':>5} "
              f"{'conv%':>6} {'p50':>4} {'p95':>4} {'saved':>6} "
              f"{'epe_delta':>10}")
    lines = [header, "-" * len(header)]
    for r in rows:
        delta = ("-" if r["epe_delta_mean"] is None
                 else f"{r['epe_delta_mean']:+.3f}")
        lines.append(
            f"{r['source']:<18} {r['bucket']:<12} {r['tau']:>6g} "
            f"{r['n']:>5} {100.0 * r['converged_frac']:>5.0f}% "
            f"{r['exit_p50']:>4} {r['exit_p95']:>4} "
            f"{r['saved_mean']:>6.1f} {delta:>10}")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    """``python -m raft_stereo_tpu_torch.obs.converge <run_dir>``: the
    offline early-exit simulator, and ``--emit-policy`` to write a
    policy."""
    from raft_stereo_tpu_torch.cli import build_converge_parser
    args = build_converge_parser().parse_args(argv)
    records = load_records(args.run_dir)
    if not records:
        print(f"no converge records under {args.run_dir} — run eval/serve "
              "with convergence telemetry on (it is the default; "
              "--no_converge disables it)", file=sys.stderr)
        return 1
    taus = tuple(args.taus) if args.taus else DEFAULT_TAUS
    rows = decision_table(records, taus=taus, bucket_by=args.bucket_by)
    doc = {"run_dir": args.run_dir, "curves": len(records),
           "taus": list(taus), "bucket_by": args.bucket_by,
           "table": rows}
    if args.emit_policy:
        ptau = DOCTOR_TAU if args.policy_tau is None else args.policy_tau
        policy = build_policy(records, tau=ptau,
                              min_iters=args.policy_min_iters,
                              margin=args.policy_margin,
                              source_run=args.run_dir)
        os.makedirs(os.path.dirname(args.emit_policy) or ".", exist_ok=True)
        with open(args.emit_policy, "w") as f:
            json.dump(policy, f, indent=2, sort_keys=True)
            f.write("\n")
        print(f"iter policy written: {args.emit_policy} "
              f"({len(policy['buckets'])} bucket(s)"
              f"{', default' if 'default' in policy else ''}, "
              f"tau={ptau:g}, digest {policy_digest(policy)})",
              file=sys.stderr)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2)
    if args.json == "-":
        # the cli compare convention: '-' streams the JSON to stdout
        # INSTEAD of the text table (converge_drill's replay leg and
        # other machine consumers parse this)
        json.dump(doc, sys.stdout, indent=1)
        sys.stdout.write("\n")
    else:
        if args.json:
            os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
            with open(args.json, "w") as f:
                json.dump(doc, f, indent=2)
        budget = max(int(r["iters"]) for r in records)
        print(f"{len(records)} curves, iteration budget {budget} "
              f"({args.run_dir})")
        print(format_table(rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
