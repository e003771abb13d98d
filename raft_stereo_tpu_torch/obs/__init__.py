"""Run-scoped observability (the port's telemetry and its report tools): the
schema-stamped JSONL event bus, span tracing and host identity, record for
record the JAX package's, with device fields from ``torch.cuda``; and the
consumers that read it back, report for report the JAX package's.

* :class:`Telemetry` (obs/telemetry.py), the event bus, and the schema and
  shared sink (obs/events.py);
* span tracing (obs/trace.py);
* the schema lint (obs/validate.py): :func:`check_path` /
  :func:`check_paths`, ``python -m raft_stereo_tpu_torch.obs.validate``;
* the run report (obs/summarize.py, ``cli telemetry``), the two-run
  regression gate (obs/compare.py, ``cli compare``), the timeline
  (obs/timeline.py), the bottleneck diagnosis (obs/doctor.py), the
  convergence and numerics reports (obs/converge.py, obs/numerics.py) and
  the fleet roll-up (obs/fleet.py), each behind
  ``python -m raft_stereo_tpu_torch.cli <command>``.
"""

from raft_stereo_tpu_torch.obs.events import (EVENT_TYPES, SCHEMA_VERSION,
                                              SUPPORTED_SCHEMA_VERSIONS,
                                              append_json_log, make_record,
                                              read_events, validate_events,
                                              validate_record)
from raft_stereo_tpu_torch.obs.fleet import (HOST_ID_ENV, TRACEPARENT_ENV,
                                             aggregate_fleet, diagnose_fleet,
                                             format_traceparent,
                                             parse_traceparent,
                                             resolve_host_id)
from raft_stereo_tpu_torch.obs.trace import (NULL_TRACER, Span, Tracer,
                                             tracer_for)
from raft_stereo_tpu_torch.obs.validate import check_path, check_paths
from raft_stereo_tpu_torch.obs.summarize import format_summary, summarize_run
from raft_stereo_tpu_torch.obs.compare import compare_runs

__all__ = [
    "EVENT_TYPES", "SCHEMA_VERSION", "SUPPORTED_SCHEMA_VERSIONS",
    "append_json_log", "make_record", "read_events", "validate_events",
    "validate_record", "check_path", "check_paths", "Telemetry",
    "NULL_TRACER", "Span", "Tracer", "tracer_for",
    "HOST_ID_ENV", "TRACEPARENT_ENV", "aggregate_fleet", "diagnose_fleet",
    "format_traceparent", "parse_traceparent", "resolve_host_id",
    "format_summary", "summarize_run", "compare_runs",
]


def __getattr__(name):
    # the event bus imports torch (its device fields); the readers and the
    # report tools need none of it, and a report loads without it
    if name == "Telemetry":
        from raft_stereo_tpu_torch.obs.telemetry import Telemetry
        return Telemetry
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
