"""Host identity for fleet stamping (the part of
``raft_stereo_tpu/obs/fleet.py`` the telemetry bus uses).

:func:`resolve_host_id` names a process (explicit > ``RAFT_HOST_ID`` env >
``<hostname>-<pid>``); the Telemetry bus stamps it, with ``pid``, on every
record and emits a ``clock_anchor`` at run_start. A launcher's trace
envelope rides the ``RAFT_TRACEPARENT`` env var into the child's run_start.
"""

from __future__ import annotations

import os
import socket
from typing import Optional

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
