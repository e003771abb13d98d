"""Host identity for fleet stamping and the trace header (the parts of
``raft_stereo_tpu/obs/fleet.py`` the telemetry bus and the HTTP front use).

:func:`resolve_host_id` names a process (explicit > ``RAFT_HOST_ID`` env >
``<hostname>-<pid>``); the Telemetry bus stamps it, with ``pid``, on every
record and emits a ``clock_anchor`` at run_start. A launcher's trace
envelope rides the ``RAFT_TRACEPARENT`` env var into the child's run_start;
an HTTP client's rides the ``traceparent`` header
(:func:`format_traceparent` / :func:`parse_traceparent`).
"""

from __future__ import annotations

import os
import socket
from typing import Optional

from raft_stereo_tpu_torch.obs.trace import SpanContext

#: explicit host identity for a launched process
HOST_ID_ENV = "RAFT_HOST_ID"
#: cross-process trace envelope for subprocess launches (a traceparent
#: header value the child's run_start records)
TRACEPARENT_ENV = "RAFT_TRACEPARENT"


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
