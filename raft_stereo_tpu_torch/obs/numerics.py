"""Numerics records and their offline report (the port's copy of
``raft_stereo_tpu/obs/numerics.py``).

* **grad records** — the train step computes one L2 norm per parameter
  (``make_train_step(..., numerics=True)``, in the JAX package's leaf
  order); the trainer puts the vector on the bus as schema-v9
  ``numerics`` records of ``kind="grad"`` every ``numerics_every`` steps,
  and always when a norm is not finite. :func:`grad_leaf_names` names the
  leaves in that order and :func:`top_leaves` ranks the offenders
  (non-finite first, then by norm) for the ``anomaly`` record's
  attribution.
* **tap records** — the test-mode forward with ``numerics=True``
  (models/raft_stereo.py, the sink in nn/gru.py) returns per-iteration
  ``[min, max, absmean, nonfinite, sat, underflow]`` rows a tap;
  :func:`taps_payload` turns the fetched ``(iters, 6)`` stacks into one
  ``kind="taps"`` record with NaN provenance (``first_nonfinite``: the
  dataflow-earliest tap of the earliest poisoned iteration).
* **the offline report** — :func:`build_report` / :func:`format_report`
  (``python -m raft_stereo_tpu_torch.cli numerics <run_dir>``): per-leaf
  gradient-norm trends, per-tap activation ranges, the bf16 saturation
  leaderboard and the first-nonfinite report over a run's records, as the
  JAX package's ``cli numerics`` reports them.

The bf16 counters are taken against bfloat16 whatever the tensor's dtype:
**saturation** counts ``|x| >= BF16_MAX_FINITE``, **underflow** nonzero
magnitudes below ``BF16_MIN_NORMAL``, compared on the raw fp32 bit
pattern (a float compare would miss denormals where the device flushes
them).
"""

from __future__ import annotations

import json
import math
import os
import sys
from typing import (TYPE_CHECKING, Any, Dict, Iterable, List, Optional,
                    Sequence, Tuple)

import numpy as np

if TYPE_CHECKING:  # the report half runs without torch
    import torch

#: per-tap per-iteration statistics, in order (nn/gru.py ``_tap_stats``
#: stacks exactly this layout)
STAT_FIELDS = ("min", "max", "absmean", "nonfinite", "sat", "underflow")

#: largest finite bfloat16 (0x7F7F): the saturation counter's rail
BF16_MAX_FINITE = 3.3895313892515355e38

#: smallest normal bfloat16 (2**-126): the underflow counter's rail
BF16_MIN_NORMAL = 1.1754943508222875e-38

#: a per-leaf gradient norm above this raises the GRAD_EXPLOSION alarm
GRAD_ALARM_NORM = 1e3

#: leaves quoted in anomaly attribution
TOP_K = 5


def grad_leaf_names(model: torch.nn.Module) -> List[str]:
    """The parameter leaves' names as the JAX package writes them
    (``"/"``-joined paths), in the order of ``leaf_grad_norms``."""
    from raft_stereo_tpu_torch.utils.weights import jax_leaf_names
    return ["/".join(path) for _, path in jax_leaf_names(model)]


def _clean(v: Any) -> Optional[float]:
    """float(v), with non-finite collapsed to None (the only NaN marker a
    strict-JSON consumer can round-trip)."""
    f = float(v)
    return f if math.isfinite(f) else None


def top_leaves(names: Sequence[str], norms: Sequence[Any],
               k: int = TOP_K) -> List[Tuple[str, Optional[float]]]:
    """Top-k offending leaves: non-finite norms first, then by descending
    norm."""
    pairs = [(str(n), _clean(v)) for n, v in zip(names, norms)]
    pairs.sort(key=lambda p: (0, 0.0) if p[1] is None else (1, -p[1]))
    return pairs[:k]


def grad_payload(step: int, names: Sequence[str], norms: Sequence[Any],
                 source: str = "train", **extra: Any) -> Dict[str, Any]:
    """One ``kind="grad"`` numerics payload from the fetched per-leaf norms
    (non-finite norms become null)."""
    payload: Dict[str, Any] = {
        "source": source, "kind": "grad", "step": int(step),
        "leaves": [str(n) for n in names],
        "grad_norm": [_clean(v) for v in norms],
        "top": [[n, v] for n, v in top_leaves(names, norms)],
    }
    payload.update(extra)
    return payload


def split_label(key: str) -> Tuple[int, str]:
    """Sink keys are ``"<order>:<label>"``; returns ``(order, label)``.
    Unprefixed keys sort last, in name order."""
    head, sep, tail = key.partition(":")
    if sep and head.isdigit():
        return int(head), tail
    return 1 << 30, key


def taps_payload(source: str, taps: Dict[str, Any], *,
                 bucket: Optional[str] = None,
                 **extra: Any) -> Optional[Dict[str, Any]]:
    """One ``kind="taps"`` payload from fetched per-tap ``(iters,
    len(STAT_FIELDS))`` stacks (None for an empty dict). Non-finite series
    values become null; ``first_nonfinite`` is the earliest poisoned
    iteration, ties to the dataflow-earliest tap."""
    if not taps:
        return None
    ordered = sorted(taps.items(), key=lambda kv: split_label(kv[0]))
    out_taps: Dict[str, Dict[str, List[Optional[float]]]] = {}
    iters = sat_total = underflow_total = 0
    first_nf: Optional[Dict[str, Any]] = None
    for key, arr in ordered:
        label = split_label(key)[1]
        a = np.asarray(arr, dtype=np.float64)
        if a.ndim == 1:
            a = a[None]
        iters = max(iters, a.shape[0])
        series = {name: [_clean(v) for v in a[:, i]]
                  for i, name in enumerate(STAT_FIELDS)}
        # a non-finite count means the reduction itself was poisoned: 0 in
        # the rollups, the nonfinite series still tells
        nf = [0 if v is None else int(v) for v in series["nonfinite"]]
        sat_total += sum(0 if v is None else int(v) for v in series["sat"])
        underflow_total += sum(0 if v is None else int(v)
                               for v in series["underflow"])
        for it, count in enumerate(nf):
            if count > 0:
                if first_nf is None or it < first_nf["iter"]:
                    first_nf = {"tap": label, "iter": it, "count": count}
                break
        out_taps[label] = series
    payload: Dict[str, Any] = {
        "source": source, "kind": "taps", "iters": int(iters),
        "taps": out_taps, "sat_total": int(sat_total),
        "underflow_total": int(underflow_total),
        "first_nonfinite": first_nf,
    }
    if bucket is not None:
        payload["bucket"] = bucket
    payload.update(extra)
    return payload


def alarm(payload: Dict[str, Any]) -> Optional[str]:
    """The reason a record should fire a flight-recorder dump, or None."""
    if payload.get("kind") == "grad":
        norms = payload.get("grad_norm") or []
        if any(v is None for v in norms):
            return "nonfinite_grad_leaf"
        if any(v is not None and v > GRAD_ALARM_NORM for v in norms):
            return "grad_explosion"
        return None
    if payload.get("first_nonfinite") is not None:
        return "nonfinite_tap"
    if payload.get("sat_total", 0) > 0:
        return "bf16_saturation"
    return None


def emit(telemetry, payload: Optional[Dict[str, Any]]) -> None:
    """Put one numerics record on the bus; an alarming record also banks a
    flight-recorder dump (rate-limited by the bus). No-op without a sink or
    payload."""
    if telemetry is None or payload is None:
        return
    telemetry.emit("numerics", **payload)
    if alarm(payload) is not None:
        dump = getattr(telemetry, "flight_dump", None)
        if dump is not None:
            dump("numerics")


# --- the offline report (cli numerics) ---------------------------------------

def load_records(path: str) -> List[Dict[str, Any]]:
    """All ``numerics`` records from a run dir (or events.jsonl path)."""
    from raft_stereo_tpu_torch.obs.events import read_events
    if os.path.isdir(path):
        path = os.path.join(path, "events.jsonl")
    if not os.path.exists(path):
        return []
    return [r for r in read_events(path) if r.get("event") == "numerics"]


def leaf_trend(records: Iterable[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Per-leaf gradient-norm trend over the run's grad records: first /
    last / max norm, growth ratio, and whether the leaf ever went
    non-finite. Sorted worst-first (non-finite, then by last norm)."""
    series: Dict[str, List[Tuple[int, Optional[float]]]] = {}
    for r in records:
        if r.get("kind") != "grad":
            continue
        step = int(r.get("step", 0))
        for name, v in zip(r.get("leaves") or [], r.get("grad_norm") or []):
            series.setdefault(str(name), []).append((step, v))
    rows = []
    for name, pts in series.items():
        pts.sort(key=lambda p: p[0])
        finite = [v for _, v in pts if v is not None]
        nonfinite_steps = [s for s, v in pts if v is None]
        first = finite[0] if finite else None
        last = next((v for _, v in reversed(pts) if v is not None), None)
        rows.append({
            "leaf": name, "n": len(pts),
            "first": first, "last": last,
            "max": max(finite) if finite else None,
            "growth": (last / first if first and last is not None
                       else None),
            "nonfinite_steps": nonfinite_steps,
        })
    rows.sort(key=lambda r: (0, 0.0) if r["nonfinite_steps"]
              else (1, -(r["last"] or 0.0)))
    return rows


def tap_trend(records: Iterable[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Per-tap aggregate over the run's tap records: value envelope,
    mean absmean, and the counter totals. Trace order preserved."""
    agg: Dict[str, Dict[str, Any]] = {}
    order: List[str] = []
    for r in records:
        if r.get("kind") != "taps":
            continue
        for label, series in (r.get("taps") or {}).items():
            row = agg.get(label)
            if row is None:
                row = agg[label] = {
                    "tap": label, "events": 0, "min": None, "max": None,
                    "absmean_sum": 0.0, "absmean_n": 0,
                    "nonfinite": 0, "sat": 0, "underflow": 0}
                order.append(label)
            row["events"] += 1
            mins = [v for v in series.get("min", []) if v is not None]
            maxs = [v for v in series.get("max", []) if v is not None]
            if mins:
                row["min"] = (min(mins) if row["min"] is None
                              else min(row["min"], min(mins)))
            if maxs:
                row["max"] = (max(maxs) if row["max"] is None
                              else max(row["max"], max(maxs)))
            for v in series.get("absmean", []):
                if v is not None:
                    row["absmean_sum"] += v
                    row["absmean_n"] += 1
            for field in ("nonfinite", "sat", "underflow"):
                row[field] += sum(int(v) for v in series.get(field, [])
                                  if v is not None)
    rows = []
    for label in order:
        row = agg[label]
        rows.append({
            "tap": label, "events": row["events"],
            "min": row["min"], "max": row["max"],
            "absmean": (row["absmean_sum"] / row["absmean_n"]
                        if row["absmean_n"] else None),
            "nonfinite": row["nonfinite"], "sat": row["sat"],
            "underflow": row["underflow"],
        })
    return rows


def saturation_leaderboard(tap_rows: Sequence[Dict[str, Any]]
                           ) -> List[Dict[str, Any]]:
    """Taps that tripped the bf16 counters, worst first (the range-
    pressure ranking the bf16 kernel rewrites will watch)."""
    hot = [r for r in tap_rows if r["sat"] or r["underflow"]]
    hot.sort(key=lambda r: (-r["sat"], -r["underflow"]))
    return hot


def first_nonfinite_report(records: Iterable[Dict[str, Any]]
                           ) -> List[Dict[str, Any]]:
    """Every recorded NaN origin: tap records with ``first_nonfinite``
    and grad records with null per-leaf norms."""
    out = []
    for r in records:
        if r.get("kind") == "taps" and r.get("first_nonfinite"):
            fn = r["first_nonfinite"]
            out.append({"source": r.get("source"), "kind": "taps",
                        "tap": fn.get("tap"), "iter": fn.get("iter"),
                        "frame": r.get("frame"), "id": r.get("id"),
                        "bucket": r.get("bucket")})
        elif r.get("kind") == "grad":
            bad = [n for n, v in zip(r.get("leaves") or [],
                                     r.get("grad_norm") or [])
                   if v is None]
            if bad:
                out.append({"source": r.get("source"), "kind": "grad",
                            "step": r.get("step"), "leaves": bad[:TOP_K],
                            "n_leaves": len(bad)})
    return out


def build_report(run_dir: str,
                 records: Sequence[Dict[str, Any]],
                 top: int = 10) -> Dict[str, Any]:
    """The ``cli numerics`` report document (the ``--json`` payload)."""
    leaves = leaf_trend(records)
    taps = tap_trend(records)
    return {
        "run_dir": run_dir,
        "grad_events": sum(1 for r in records if r.get("kind") == "grad"),
        "tap_events": sum(1 for r in records if r.get("kind") == "taps"),
        "leaves": leaves[:top],
        "n_leaves": len(leaves),
        "taps": taps,
        "saturation": saturation_leaderboard(taps),
        "first_nonfinite": first_nonfinite_report(records),
    }


def _fmt(v: Optional[float], spec: str = ".3g") -> str:
    return "-" if v is None else format(v, spec)


def format_report(doc: Dict[str, Any]) -> str:
    """Render the report for the terminal."""
    lines = [f"{doc['grad_events']} grad + {doc['tap_events']} tap "
             f"numerics records ({doc['run_dir']})"]
    if doc["leaves"]:
        lines.append("")
        lines.append(f"per-leaf gradient norms (worst {len(doc['leaves'])} "
                     f"of {doc['n_leaves']}):")
        header = (f"  {'leaf':<44} {'first':>9} {'last':>9} {'max':>9} "
                  f"{'growth':>7} {'nonfin':>6}")
        lines += [header, "  " + "-" * (len(header) - 2)]
        for r in doc["leaves"]:
            lines.append(
                f"  {r['leaf'][:44]:<44} {_fmt(r['first']):>9} "
                f"{_fmt(r['last']):>9} {_fmt(r['max']):>9} "
                f"{_fmt(r['growth'], '.2f'):>7} "
                f"{len(r['nonfinite_steps']):>6}")
    if doc["taps"]:
        lines.append("")
        lines.append("activation taps (refinement scan, trace order):")
        header = (f"  {'tap':<24} {'events':>6} {'min':>10} {'max':>10} "
                  f"{'absmean':>9} {'nonfin':>6} {'sat':>5} {'uflow':>6}")
        lines += [header, "  " + "-" * (len(header) - 2)]
        for r in doc["taps"]:
            lines.append(
                f"  {r['tap'][:24]:<24} {r['events']:>6} "
                f"{_fmt(r['min']):>10} {_fmt(r['max']):>10} "
                f"{_fmt(r['absmean']):>9} {r['nonfinite']:>6} "
                f"{r['sat']:>5} {r['underflow']:>6}")
    if doc["saturation"]:
        lines.append("")
        lines.append("bf16 saturation leaderboard:")
        for r in doc["saturation"]:
            lines.append(f"  {r['tap']}: sat={r['sat']} "
                         f"underflow={r['underflow']} "
                         f"(|max|={_fmt(r['max'])})")
    if doc["first_nonfinite"]:
        lines.append("")
        lines.append("first-nonfinite provenance:")
        for r in doc["first_nonfinite"]:
            if r["kind"] == "taps":
                where = f"frame={r['frame']}" if r.get("frame") is not None \
                    else f"id={r.get('id')}"
                lines.append(
                    f"  [{r['source']}] tap {r['tap']!r} at refinement "
                    f"iteration {r['iter']} ({where})")
            else:
                lines.append(
                    f"  [{r['source']}] step {r['step']}: {r['n_leaves']} "
                    f"non-finite grad leaves, first {r['leaves']}")
    elif doc["grad_events"] or doc["tap_events"]:
        lines.append("")
        lines.append("no non-finite values recorded")
    return "\n".join(lines)


def main(argv: Optional[List[str]] = None) -> int:
    """``cli numerics <run_dir>`` — the offline numerics report."""
    from raft_stereo_tpu_torch.cli import build_numerics_parser
    args = build_numerics_parser().parse_args(argv)
    records = load_records(args.run_dir)
    if not records:
        print(f"no numerics records under {args.run_dir} — run train/eval "
              "with numerics telemetry on (the default; --no_numerics "
              "disables it) or serve with --numerics", file=sys.stderr)
        return 1
    doc = build_report(args.run_dir, records, top=args.top)
    if args.json:
        # the cli compare convention: '-' streams JSON to stdout INSTEAD
        # of the text report; any other value is an output path
        if args.json == "-":
            json.dump(doc, sys.stdout, indent=1)
            print()
        else:
            os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
            with open(args.json, "w") as f:
                json.dump(doc, f, indent=2)
            print(f"numerics report written to {args.json}")
    else:
        print(format_report(doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
