"""Numerics records, the gradient and tap halves (the port's copy of part
of ``raft_stereo_tpu/obs/numerics.py``).

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

The bf16 counters are taken against bfloat16 whatever the tensor's dtype:
**saturation** counts ``|x| >= BF16_MAX_FINITE``, **underflow** nonzero
magnitudes below ``BF16_MIN_NORMAL``, compared on the raw fp32 bit
pattern (a float compare would miss denormals where the device flushes
them). The offline reports stay to be ported (ROADMAP A14).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from raft_stereo_tpu_torch.utils.weights import jax_leaf_names

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
