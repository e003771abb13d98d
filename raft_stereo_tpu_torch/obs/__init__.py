"""Run-scoped observability (the port's telemetry core): the schema-stamped
JSONL event bus, span tracing and host identity, record for record the JAX
package's, with device fields from ``torch.cuda``."""

from raft_stereo_tpu_torch.obs.events import (EVENT_TYPES, SCHEMA_VERSION,
                                              SUPPORTED_SCHEMA_VERSIONS,
                                              append_json_log, make_record,
                                              read_events, validate_events,
                                              validate_record)
from raft_stereo_tpu_torch.obs.fleet import (HOST_ID_ENV, TRACEPARENT_ENV,
                                             resolve_host_id)
from raft_stereo_tpu_torch.obs.telemetry import Telemetry
from raft_stereo_tpu_torch.obs.trace import (NULL_TRACER, Span, Tracer,
                                             tracer_for)

__all__ = [
    "EVENT_TYPES", "SCHEMA_VERSION", "SUPPORTED_SCHEMA_VERSIONS",
    "append_json_log", "make_record", "read_events", "validate_events",
    "validate_record", "HOST_ID_ENV", "TRACEPARENT_ENV", "resolve_host_id",
    "Telemetry", "NULL_TRACER", "Span", "Tracer", "tracer_for",
]
