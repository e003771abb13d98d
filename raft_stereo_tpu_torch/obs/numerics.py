"""Numerics records, the gradient half (the port's copy of part of
``raft_stereo_tpu/obs/numerics.py``).

The train step computes one L2 norm per parameter (``make_train_step(...,
numerics=True)``, in the JAX package's leaf order); the trainer puts the
vector on the bus as schema-v9 ``numerics`` records of ``kind="grad"`` every
``numerics_every`` steps, and always when a norm is not finite.
:func:`grad_leaf_names` names the leaves in that order and
:func:`top_leaves` ranks the offenders (non-finite first, then by norm) for
the ``anomaly`` record's attribution. The activation taps and the offline
reports are not ported (ROADMAP A11, A14).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from raft_stereo_tpu_torch.utils.weights import jax_leaf_names

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
