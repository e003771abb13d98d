"""Continuous-batching stereo serving (the port of
``raft_stereo_tpu/serve``).

* :mod:`~raft_stereo_tpu_torch.serve.batching` — the greedy same-key
  grouping shared with the streaming evaluator, and the bounded request
  queue;
* :mod:`~raft_stereo_tpu_torch.serve.cache` — the shape-bucketed program
  cache (one served forward a bucket key, warmed before traffic, hot
  reload of the weights in place);
* :mod:`~raft_stereo_tpu_torch.serve.server` — the scheduler thread:
  continuous micro-batches across clients, per-request fault isolation,
  graceful drain, per-stream ``flow_init`` warm starts;
* :mod:`~raft_stereo_tpu_torch.serve.slo` — p50/p99 latency, in-flight
  depth and sustained pairs/s as schema-v6 ``request``/``queue``/``slo``
  records;
* :mod:`~raft_stereo_tpu_torch.serve.http` — the stdlib HTTP front
  (``python -m raft_stereo_tpu_torch.serve``);
* :mod:`~raft_stereo_tpu_torch.serve.loadtest` — the many-client trace
  generator (``python -m raft_stereo_tpu_torch.serve.loadtest``).
"""

from raft_stereo_tpu_torch.serve.batching import (BoundedQueue, QueueClosed,
                                                  collect_group, stack_pairs)
from raft_stereo_tpu_torch.serve.cache import BucketKey, ExecutableCache
from raft_stereo_tpu_torch.serve.server import (ServeConfig, ServeResult,
                                                ServerDraining, StereoServer)
from raft_stereo_tpu_torch.serve.slo import SLOTracker

__all__ = [
    "BoundedQueue", "QueueClosed", "collect_group", "stack_pairs",
    "ServeConfig", "ServeResult", "ServerDraining", "StereoServer",
    "BucketKey", "ExecutableCache", "SLOTracker",
]
