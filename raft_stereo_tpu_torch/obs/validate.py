"""Artifact-level event validation (the port's copy of
``raft_stereo_tpu/obs/validate.py``): resolve a path (a file or a run
directory) to its ``events.jsonl``, parse it, and hold every record
against the schema (obs/events.py) and the referential checks below; an
``iter_policy.json`` is held against the policy schema instead.

``python -m raft_stereo_tpu_torch.obs.validate <events.jsonl | run_dir |
iter_policy.json> [...]`` lints each argument and exits 1 on any
violation (the port's counterpart of ``scripts/check_events.py``).
``obs/converge.load_policy`` runs :func:`check_iter_policy` on every
policy it loads.
"""

from __future__ import annotations

import os
import sys
from typing import Iterable, List, Optional, Sequence

from raft_stereo_tpu_torch.obs.events import read_events, validate_events


def check_span_integrity(records: Iterable[dict]) -> List[str]:
    """Referential integrity of schema-v7 ``span`` records within one file.

    A tracer flush may interleave traces, but by end-of-file every
    ``parent_id`` must resolve to a flushed ``span_id`` (obs/trace.py's
    ``close()`` guarantees this by force-flushing open spans) and span ids
    must be unique — an orphan parent or a duplicate id means a writer
    dropped or double-emitted part of a trace. The one exemption:
    spans marked ``remote_parent`` inherited their parent across a
    process boundary (a traceparent header / RAFT_TRACEPARENT envelope,
    obs/fleet.py), so the parent legitimately lives in ANOTHER host's
    file — ``cli fleet`` resolves those joins across the fleet dir.
    """
    spans = [r for r in records
             if isinstance(r, dict) and r.get("event") == "span"]
    errors: List[str] = []
    seen: set = set()
    for s in spans:
        sid = s.get("span_id")
        if sid in seen:
            errors.append(f"span: duplicate span_id {sid!r}")
        seen.add(sid)
    for s in spans:
        parent = s.get("parent_id")
        if parent is not None and parent not in seen \
                and not s.get("remote_parent"):
            errors.append(
                f"span {s.get('span_id')!r} ({s.get('name')!r}): orphan "
                f"parent_id {parent!r} — no such span in this file")
        trace = s.get("trace_id")
        if not isinstance(trace, str) or not trace:
            errors.append(
                f"span {s.get('span_id')!r}: missing/empty trace_id")
    return errors


def check_converge_integrity(records: Iterable[dict]) -> List[str]:
    """Consistency of schema-v8 ``converge`` records (obs/converge.py).

    The downsampled curve must be internally coherent or the early-exit
    simulator silently lies: indices strictly increasing within the
    iteration budget and ending on the final iteration, curves no longer
    than the budget, residual/epe the same length as the index list, and
    every value finite (a NaN residual means the aux read garbage).
    """
    import math
    recs = [r for r in records
            if isinstance(r, dict) and r.get("event") == "converge"]
    errors: List[str] = []
    for n, r in enumerate(recs):
        tag = f"converge #{n} ({r.get('source')!r})"
        idx, residual = r.get("idx"), r.get("residual")
        iters = r.get("iters")
        if not isinstance(idx, list) or not isinstance(residual, list) \
                or not isinstance(iters, int):
            errors.append(f"{tag}: idx/residual/iters malformed")
            continue
        if len(idx) != len(residual):
            errors.append(f"{tag}: {len(idx)} indices vs "
                          f"{len(residual)} residual values")
        if len(idx) > iters:
            errors.append(f"{tag}: {len(idx)} stored points exceed the "
                          f"iteration budget {iters}")
        if any(b <= a for a, b in zip(idx, idx[1:])):
            errors.append(f"{tag}: downsample indices not strictly "
                          f"increasing: {idx}")
        if idx and (idx[0] < 0 or idx[-1] != iters - 1):
            errors.append(f"{tag}: indices must cover [0, iters-1]; got "
                          f"first={idx[0]} last={idx[-1]} iters={iters}")
        epe = r.get("epe")
        if epe is not None and (not isinstance(epe, list)
                                or len(epe) != len(idx)):
            errors.append(f"{tag}: epe curve length mismatch")
        for name in ("residual", "epe"):
            vals = r.get(name)
            if isinstance(vals, list) and not all(
                    isinstance(v, (int, float)) and math.isfinite(v)
                    for v in vals):
                errors.append(f"{tag}: non-finite {name} value")
    return errors


def check_numerics_integrity(records: Iterable[dict]) -> List[str]:
    """Consistency of schema-v9 ``numerics`` records (obs/numerics.py).

    grad records must keep ``leaves`` and ``grad_norm`` parallel (the
    attribution hinges on index alignment), with every norm a number or
    null (null IS the NaN marker — a NaN literal would not round-trip
    strict JSON). taps records must keep every stat series the same
    length as the advertised iteration count, counters non-negative, and
    the ``first_nonfinite`` pointer referentially valid: it must name a
    recorded tap and an in-range iteration whose nonfinite counter is
    actually positive.
    """
    from raft_stereo_tpu_torch.obs.numerics import STAT_FIELDS
    recs = [r for r in records
            if isinstance(r, dict) and r.get("event") == "numerics"]
    errors: List[str] = []
    for n, r in enumerate(recs):
        kind = r.get("kind")
        tag = f"numerics #{n} ({r.get('source')!r}, kind={kind!r})"
        if kind == "grad":
            leaves, norms = r.get("leaves"), r.get("grad_norm")
            if not isinstance(leaves, list) or not isinstance(norms, list):
                errors.append(f"{tag}: leaves/grad_norm malformed")
                continue
            if len(leaves) != len(norms):
                errors.append(f"{tag}: {len(leaves)} leaves vs "
                              f"{len(norms)} grad_norm values")
            if not all(v is None or isinstance(v, (int, float))
                       for v in norms):
                errors.append(f"{tag}: grad_norm values must be numbers "
                              "or null")
        elif kind == "taps":
            taps, iters = r.get("taps"), r.get("iters")
            if not isinstance(taps, dict) or not isinstance(iters, int):
                errors.append(f"{tag}: taps/iters malformed")
                continue
            for label, series in taps.items():
                if not isinstance(series, dict):
                    errors.append(f"{tag}: tap {label!r} series malformed")
                    continue
                for field in STAT_FIELDS:
                    vals = series.get(field)
                    if not isinstance(vals, list) or len(vals) != iters:
                        errors.append(f"{tag}: tap {label!r} {field} "
                                      f"series is not length iters={iters}")
                    elif field in ("nonfinite", "sat", "underflow") \
                            and any(isinstance(v, (int, float)) and v < 0
                                    for v in vals):
                        errors.append(f"{tag}: tap {label!r} negative "
                                      f"{field} counter")
            fn = r.get("first_nonfinite")
            if fn is not None:
                if not isinstance(fn, dict):
                    errors.append(f"{tag}: first_nonfinite malformed")
                elif fn.get("tap") not in taps:
                    errors.append(f"{tag}: first_nonfinite names unknown "
                                  f"tap {fn.get('tap')!r}")
                elif not isinstance(fn.get("iter"), int) \
                        or not 0 <= fn["iter"] < iters:
                    errors.append(f"{tag}: first_nonfinite iter "
                                  f"{fn.get('iter')!r} outside "
                                  f"[0, {iters})")
                else:
                    series = taps[fn["tap"]].get("nonfinite")
                    if isinstance(series, list) and len(series) > fn["iter"] \
                            and not (isinstance(series[fn["iter"]],
                                                (int, float))
                                     and series[fn["iter"]] > 0):
                        errors.append(
                            f"{tag}: first_nonfinite points at tap "
                            f"{fn['tap']!r} iter {fn['iter']} but its "
                            "nonfinite counter is not positive there")
        else:
            errors.append(f"{tag}: unknown kind (expected grad|taps)")
    return errors


def check_fleet_integrity(records: Iterable[dict]) -> List[str]:
    """Consistency of the schema-v10 fleet records (obs/fleet.py).

    Host identity must be coherent or the offline clock alignment
    attributes evidence to the wrong process: every stamped ``host_id``
    non-empty and identical within a process segment (a ``run_start``
    opens a new segment — an auto-resumed run legitimately appends a
    second process's records, and pids differ, but two host identities
    INSIDE one segment mean two writers share a log), ``heartbeat``
    sequence numbers strictly increasing per (host, role) with a
    non-decreasing ``t`` axis within a segment, and at most one
    ``clock_anchor`` per host per segment — present whenever heartbeats
    are (beats without an anchor cannot be placed on the fleet clock).
    v1–v9 artifacts carry none of these records and no stamps, so they
    lint clean (additive).
    """
    recs = [r for r in records if isinstance(r, dict)]
    errors: List[str] = []
    hosts: set = set()
    anchors: dict = {}
    last_seq: dict = {}
    last_t: dict = {}
    have_beats = False
    have_anchor = False
    for n, r in enumerate(recs):
        if r.get("event") == "run_start":  # a new process segment begins
            hosts, anchors = set(), {}
            last_seq, last_t = {}, {}
        if "host_id" in r:
            hid = r.get("host_id")
            if not isinstance(hid, str) or not hid:
                errors.append(f"#{n} ({r.get('event')!r}): empty/"
                              f"non-string host_id {hid!r}")
            else:
                hosts.add(hid)
                if len(hosts) > 1:
                    errors.append(
                        f"#{n}: host_id inconsistent within one process "
                        f"segment: {sorted(hosts)} (one segment = one "
                        f"process)")
                    hosts = {hid}
        if r.get("event") == "clock_anchor":
            have_anchor = True
            hid = r.get("host_id")
            anchors[hid] = anchors.get(hid, 0) + 1
            if anchors[hid] > 1:
                errors.append(f"#{n}: clock_anchor repeated for host "
                              f"{hid!r} (must be present once per "
                              f"segment)")
        if r.get("event") == "heartbeat":
            have_beats = True
            key = (r.get("host_id"), r.get("role"))
            seq = r.get("seq")
            if not isinstance(seq, int) or seq < 0:
                errors.append(f"heartbeat #{n}: seq must be a "
                              f"non-negative int, got {seq!r}")
                continue
            if key in last_seq and seq <= last_seq[key]:
                errors.append(
                    f"heartbeat #{n} ({key[0]!r}/{key[1]!r}): seq {seq} "
                    f"not after {last_seq[key]} — cadence not monotonic")
            last_seq[key] = seq
            t = r.get("t")
            if isinstance(t, (int, float)):
                if key in last_t and t < last_t[key]:
                    errors.append(
                        f"heartbeat #{n} ({key[0]!r}/{key[1]!r}): t {t} "
                        f"rewound below {last_t[key]}")
                last_t[key] = t
    if have_beats and not have_anchor:
        errors.append("heartbeat records present but no clock_anchor — "
                      "beats cannot be placed on the fleet clock")
    return errors


def check_iter_policy(doc: dict) -> List[str]:
    """Schema and referential lint of one ``iter_policy.json`` document
    (obs/converge.py ``build_policy``): the artifact the adaptive
    inference mode runs on, so a doctored one fails with a named reason
    instead of mis-budgeting the loop. Returns the violations, in order
    (empty when clean).

    Checks: version/kind, bucket coverage (at least one bucket or a
    default, bucket keys shaped ``HxW``), τ > 0 per entry (τ=0 is the
    parity-test value, never a production policy), integer budgets with
    ``1 <= min_iters <= budget``, provenance present (source run + table
    row), and referential consistency of each entry against its
    provenance row: the row's τ must match the entry's, and the entry's
    budget must not exceed the recorded iteration budget (the row's
    ``budget`` — the valid_iters the curves were recorded at).
    """
    errors: List[str] = []
    if not isinstance(doc, dict):
        return ["iter_policy: not a JSON object"]
    if doc.get("kind") != "iter_policy":
        errors.append(f"iter_policy: kind {doc.get('kind')!r} != "
                      "'iter_policy'")
    if doc.get("version") != 1:
        errors.append(f"iter_policy: unsupported version "
                      f"{doc.get('version')!r}")
    if not isinstance(doc.get("source_run"), str) or not doc.get("source_run"):
        errors.append("iter_policy: missing source_run provenance")
    buckets = doc.get("buckets")
    if not isinstance(buckets, dict):
        errors.append("iter_policy: buckets must be an object")
        buckets = {}
    entries = [(f"bucket {k!r}", v) for k, v in sorted(buckets.items())]
    if "default" in doc:
        entries.append(("default", doc["default"]))
    if not entries:
        errors.append("iter_policy: no bucket coverage — neither a bucket "
                      "entry nor a default")
    for key in buckets:
        parts = str(key).split("x")
        if len(parts) != 2 or not all(p.isdigit() and int(p) > 0
                                      for p in parts):
            errors.append(f"iter_policy: bucket key {key!r} is not 'HxW'")
    for tag, e in entries:
        if not isinstance(e, dict):
            errors.append(f"iter_policy {tag}: entry malformed")
            continue
        tau, budget = e.get("tau"), e.get("budget")
        min_iters = e.get("min_iters")
        if not isinstance(tau, (int, float)) or not tau > 0:
            errors.append(f"iter_policy {tag}: tau must be > 0, got {tau!r}")
        if not isinstance(budget, int) or budget < 1:
            errors.append(f"iter_policy {tag}: budget must be an int >= 1, "
                          f"got {budget!r}")
        if not isinstance(min_iters, int) or min_iters < 1 \
                or (isinstance(budget, int) and min_iters > budget):
            errors.append(f"iter_policy {tag}: min_iters must be in "
                          f"[1, budget], got {min_iters!r}")
        prov = e.get("provenance")
        if not isinstance(prov, dict) or not isinstance(prov.get("source"),
                                                        str) \
                or not isinstance(prov.get("row"), dict):
            errors.append(f"iter_policy {tag}: provenance (source + table "
                          "row) missing")
            continue
        row = prov["row"]
        row_tau = row.get("tau")
        if isinstance(row_tau, (int, float)) and isinstance(tau, (int, float)) \
                and float(row_tau) != float(tau):
            errors.append(f"iter_policy {tag}: entry tau {tau!r} != "
                          f"provenance row tau {row_tau!r}")
        row_budget = row.get("budget")
        if isinstance(row_budget, int) and isinstance(budget, int) \
                and budget > row_budget:
            errors.append(f"iter_policy {tag}: budget {budget} exceeds the "
                          f"recorded iteration budget {row_budget} "
                          "(valid_iters the curves were recorded at)")
    return errors


def check_policy_path(path: str) -> List[str]:
    """Validate one ``iter_policy.json`` file path."""
    import json
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        return [f"{path}: unreadable policy JSON: {e}"]
    return [f"{path}: {e}" for e in check_iter_policy(doc)]


def _looks_like_policy(path: str) -> bool:
    """A .json artifact routed to the policy lint: either its top-level
    ``kind`` says so, or it cannot be parsed at all (in which case the
    policy checker reports the parse failure for .json paths)."""
    import json
    if not path.endswith(".json"):
        return False
    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return True
    return isinstance(doc, dict) and doc.get("kind") == "iter_policy"


def check_path(path: str) -> List[str]:
    """Validate one ``events.jsonl`` (or a run directory containing one),
    or — for ``*.json`` artifacts whose ``kind`` is ``iter_policy`` — the
    iteration-policy schema (:func:`check_iter_policy`).

    Returns ``["<path>: <violation>", ...]`` — empty means the artifact
    conforms. A missing file and an empty log are violations: an artifact
    that silently vanished is exactly what a lint must not bless.
    """
    if os.path.isdir(path):
        path = os.path.join(path, "events.jsonl")
    if not os.path.exists(path):
        return [f"{path}: missing"]
    if _looks_like_policy(path):
        return check_policy_path(path)
    try:
        records = read_events(path)
    except ValueError as e:
        return [str(e)]
    if not records:
        return [f"{path}: empty event log"]
    errors = validate_events(records)
    errors.extend(check_span_integrity(records))
    errors.extend(check_converge_integrity(records))
    errors.extend(check_numerics_integrity(records))
    errors.extend(check_fleet_integrity(records))
    return [f"{path}: {e}" for e in errors]


def check_paths(paths: Iterable[str]) -> List[str]:
    """Validate several artifacts; concatenated :func:`check_path` output."""
    errors: List[str] = []
    for path in paths:
        errors.extend(check_path(path))
    return errors


def main(argv: Optional[Sequence[str]] = None,
         doc: Optional[str] = None) -> int:
    """The check-events CLI body: lint each argument, report, exit 1 on any
    violation. ``doc`` is the usage text printed when no paths are given."""
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv:
        print((doc or __doc__).strip(), file=sys.stderr)
        return 2
    errors = check_paths(argv)
    for e in errors:
        print(e, file=sys.stderr)
    if not errors:
        print(f"ok: {len(argv)} artifact(s) conform to the event schema")
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())
