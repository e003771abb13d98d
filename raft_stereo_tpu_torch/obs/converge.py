"""Convergence curves on the event bus (the emit half of
``raft_stereo_tpu/obs/converge.py``).

The test-mode forward measures, per iteration, how far the GRU still moves
the disparity field (``RAFTStereo.forward(..., iter_metrics=...)``).
:func:`converge_payload` / :func:`emit` downsample one such curve (strictly
increasing iteration indices, both endpoints kept) and put a schema-v8
``converge`` record on the telemetry bus: one a served request. The policy
half (the early-exit simulator, ``build_policy``/``load_policy``) is not
ported yet (ROADMAP A11).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

#: stored points per curve (endpoints always kept; the full curve when the
#: iteration budget is already this small)
DEFAULT_MAX_POINTS = 32


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
