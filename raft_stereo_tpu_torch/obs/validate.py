"""Schema lint of the iteration policy (the port's copy of
``check_iter_policy`` from ``raft_stereo_tpu/obs/validate.py``; the event
log lint stays to be ported, ROADMAP A14). ``obs/converge.load_policy``
runs it on every policy it loads.
"""

from __future__ import annotations

from typing import List


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
