"""The continuous-batching stereo server (the port of
``raft_stereo_tpu/serve/server.py``).

One scheduler thread, the production shape of eval/stream.py's window:

::

    clients --submit()--> BoundedQueue --scheduler--> ExecutableCache
                                          |  (greedy same-bucket groups,
                                          |   bounded in-flight window)
    clients <--ResultHandle-- retire <----+

* **Admission** — ``submit()`` puts a request into a bounded queue
  (backpressure instead of a backlog) and returns a :class:`ResultHandle`.
  After ``request_drain()`` the queue is closed: new submits raise
  :class:`ServerDraining`, and everything already admitted completes (the
  SIGTERM contract: stop admitting, finish, exit 0).
* **Batching** — the scheduler pulls the queue in arrival order and packs
  consecutive requests of one ``(bucket H×W, iters, warm, policy, impl)``
  key into one dispatch (serve/batching.py, the streaming evaluator's
  policy), lingering up to ``linger_s`` for stragglers while the batch is
  short. Where an iteration policy covers a bucket, its budget caps the
  iterations and the early-exit flavour serves it (``policy`` is the
  policy's digest, ``@digest`` in the bucket label).
  Requests of different raw shapes share a dispatch when they pad to the
  same bucket; each keeps its own padder for an exact unpad.
* **Fault isolation** — the served program returns a per-sample finiteness
  flag computed on the device. A poisoned request retires as an error and
  its batchmates retire normally. An exception at dispatch or at retire (a
  device fault surfaces there) fails exactly that batch, each request with
  the traceback, and the scheduler keeps serving.
* **Warm starts** — ``stream`` + ``warm_start=True`` requests ride the
  warm flavour: the server keeps each video session's last low-res flow on
  the host and feeds it back as ``flow_init`` (zeros on a first frame or
  after the stream changes shape). Frames of one session are submitted in
  order (each result awaited before the next submit).
* **Hot reload** — ``reload(state_dict)`` swaps the weights between
  batches, in the scheduler thread: queued and in-flight work is never
  dropped; dispatches after the swap use the new weights.

The scheduler thread enters ``torch.inference_mode()`` and, on the card,
selects the server's device for itself (both are per thread).
"""

from __future__ import annotations

import dataclasses
import itertools
import logging
import threading
import time
import traceback as tb_module
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from raft_stereo_tpu_torch.config import RAFTStereoConfig
from raft_stereo_tpu_torch.inference import PAD_DIVIS, bucket_size
from raft_stereo_tpu_torch.obs import numerics as numerics_obs
from raft_stereo_tpu_torch.obs.converge import emit as converge_emit
from raft_stereo_tpu_torch.obs.trace import NULL_TRACER
from raft_stereo_tpu_torch.serve.batching import (BoundedQueue, QueueClosed,
                                                  collect_group)
from raft_stereo_tpu_torch.serve.cache import (BucketKey, ExecutableCache,
                                               padded_batch)
from raft_stereo_tpu_torch.serve.slo import SLOTracker

logger = logging.getLogger(__name__)

#: with no dispatch in flight the scheduler waits for a request this long
#: at a time (a request wakes it at once)
IDLE_POLL_S = 0.05
#: with dispatches in flight it waits in slices this short, and retires
#: the oldest as soon as it is done, so a client that waits for each
#: result (a camera's loop) does not wait out the idle poll as well
RETIRE_POLL_S = 0.001


class ServerDraining(Exception):
    """submit() after request_drain(): admission is closed for shutdown."""


class ServerBusy(Exception):
    """submit() timed out on a full queue: backpressure, try again."""


@dataclasses.dataclass
class ServeConfig:
    """Scheduler and queue knobs (``python -m raft_stereo_tpu_torch.serve``
    and ``.serve.loadtest``); the JAX package's fields and defaults."""

    #: most requests stacked through one dispatch
    max_batch: int = 4
    #: bounded request-queue depth (admission backpressure past it)
    queue_depth: int = 64
    #: most dispatches in flight
    window: int = 2
    #: refinement iterations when a request names none
    default_iters: int = 32
    #: pad buckets up to multiples of this (0: exact /32 padding)
    bucket: int = 0
    #: wait up to this long for same-bucket stragglers while a batch is
    #: below max_batch (0: dispatch at once)
    linger_s: float = 0.0
    #: warm each bucket up with a forward on zeros before traffic
    aot: bool = True
    #: one `slo` rollup every N retired requests
    slo_every: int = 16
    #: latency window for p50/p99 and sustained pairs/s
    slo_window: int = 256
    #: serve the converge flavour: per-request residual curves (`converge`
    #: records) and the per-bucket quality gauges of the slo rollups
    converge: bool = True
    #: serve the numerics flavour: a `numerics` record a dispatch (the tap
    #: statistics) and each request's output range in the slo rollups and
    #: on /metrics; off by default, and then the forward has no taps
    numerics: bool = False
    #: iteration-policy path (or loaded doc): buckets it covers are served
    #: by the early-exit forward, its budget in place of default_iters,
    #: with iters_taken in the request/slo telemetry and on /metrics
    iter_policy: Any = None
    #: early-exit override: None = adaptive iff iter_policy is set, False
    #: ignores a loaded policy, True without one is an error
    adaptive: Optional[bool] = None
    #: serve buckets whose padded width reaches this with the memoryless
    #: 'fused' correlation (BucketKey.impl); 0 is off
    fused_width: int = 0


@dataclasses.dataclass
class ServeResult:
    """Terminal outcome of one request (what :meth:`ResultHandle.result`
    returns: errors are data here, the per-request isolation contract)."""

    request_id: str
    ok: bool
    flow: Optional[np.ndarray] = None    # unpadded (H, W, 1) flow-x
    error: Optional[str] = None
    error_kind: Optional[str] = None     # "nonfinite_output" | "dispatch"
    traceback: Optional[str] = None
    stream: Optional[str] = None
    latency_s: float = 0.0
    queue_wait_s: float = 0.0
    batch_size: int = 0
    bucket: str = ""
    #: the last iteration's mean |Δ disparity| (None without converge)
    final_residual: Optional[float] = None
    #: the whole residual curve, one value an iteration (converge only)
    residuals: Optional[np.ndarray] = None
    #: refinement iterations the early exit applied to this request (None
    #: on fixed-trip forwards)
    iters_taken: Optional[int] = None
    #: host min and max of the unpadded output flow (numerics flavour
    #: only; None on errors)
    output_min: Optional[float] = None
    output_max: Optional[float] = None
    #: the low-res flow this request's frame leaves its session (warm
    #: requests only): the next frame's flow_init
    flow_lowres: Optional[np.ndarray] = None

    @property
    def disparity(self) -> Optional[np.ndarray]:
        """Positive disparity (H, W), the library API's convention."""
        return None if self.flow is None else -self.flow[..., 0]


class ResultHandle:
    """Future for one admitted request; ``result()`` blocks until retired."""

    def __init__(self, request_id: str):
        self.request_id = request_id
        self._done = threading.Event()
        self._result: Optional[ServeResult] = None

    def done(self) -> bool:
        return self._done.is_set()

    def result(self, timeout: Optional[float] = None) -> ServeResult:
        if not self._done.wait(timeout=timeout):
            raise TimeoutError(
                f"request {self.request_id} not retired within {timeout}s")
        return self._result

    def _set(self, result: ServeResult) -> None:
        self._result = result
        self._done.set()


class _Job:
    """Work the scheduler thread runs between batches (a bucket warm-up:
    cuDNN and cuBLAS keep per-thread state, so a warm-up warms only the
    thread it runs in); ``wait`` returns its result or raises its error."""

    def __init__(self, fn):
        self.fn = fn
        self._done = threading.Event()
        self._result = None
        self._error: Optional[BaseException] = None

    def run(self) -> None:
        try:
            self._result = self.fn()
        except Exception as exc:
            self._error = exc
        self._done.set()

    def cancel(self) -> None:
        self._error = RuntimeError("the scheduler stopped before the job ran")
        self._done.set()

    def wait(self):
        self._done.wait()
        if self._error is not None:
            raise self._error
        return self._result


@dataclasses.dataclass
class _Request:
    id: str
    image1: np.ndarray
    image2: np.ndarray
    iters: int
    warm: bool
    stream: Optional[str]
    t_submit: float
    handle: ResultHandle
    # remote trace context: the client span this request's spans join
    parent: Optional[Any] = None
    t_dispatch: float = 0.0
    # lifecycle stamps of the request's span tree (queue_wait ends when
    # the scheduler pulls the request, dispatch when the forward is
    # enqueued)
    t_collect: float = 0.0
    t_disp_end: float = 0.0


class StereoServer:
    """Continuous-batching inference over one model on one device (CUDA
    unless ``device="cpu"``). Thread-safe ``submit``; one scheduler
    thread. ``state_dict`` holds the port's weights."""

    def __init__(self, cfg: RAFTStereoConfig,
                 state_dict: Dict[str, torch.Tensor],
                 serve: Optional[ServeConfig] = None, *, device=None,
                 telemetry=None, autostart: bool = True):
        self.cfg = cfg
        self.serve = serve or ServeConfig()
        self.telemetry = telemetry
        self.cache = ExecutableCache(cfg, state_dict, device=device,
                                     aot=self.serve.aot,
                                     converge=self.serve.converge,
                                     numerics=self.serve.numerics,
                                     iter_policy=self.serve.iter_policy,
                                     adaptive=self.serve.adaptive)
        self.device = self.cache.device
        self.slo = SLOTracker(telemetry, window=self.serve.slo_window,
                              emit_every=self.serve.slo_every)
        self._queue: BoundedQueue = BoundedQueue(self.serve.queue_depth)
        # single-owner state: only the scheduler thread mutates these;
        # other threads may read len() for gauges
        self._in_flight: "deque" = deque()
        self._sessions: Dict[str, Tuple[Tuple[int, ...], np.ndarray]] = {}
        self._pending: Optional[Dict[str, torch.Tensor]] = None
        self._reload_note: Optional[str] = None
        self._jobs: "deque" = deque()
        self._vars_lock = threading.Lock()
        self._ids = itertools.count()
        self._draining = False
        self._stopped = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="serve-scheduler")
        if autostart:
            self.start()

    # --- lifecycle -----------------------------------------------------------

    def start(self) -> "StereoServer":
        if not self._thread.is_alive() and not self._stopped.is_set():
            self._thread.start()
        return self

    @property
    def draining(self) -> bool:
        return self._draining

    def request_drain(self) -> None:
        """Graceful shutdown, phase 1: close admission. Requests already
        admitted (queued or in flight) all complete."""
        if not self._draining:
            self._draining = True
            logger.info("serve: drain requested — admission closed, "
                        "finishing %d queued + %d in-flight dispatches",
                        len(self._queue), len(self._in_flight))
        self._queue.close()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Wait for the scheduler to finish draining; True when stopped."""
        self._thread.join(timeout=timeout)
        return not self._thread.is_alive()

    def close(self, timeout: Optional[float] = None) -> bool:
        self.request_drain()
        if not self._thread.is_alive() and not self._stopped.is_set():
            # never started: drain the queue inline, so admitted work is
            # still served
            self._run()
            return True
        return self.join(timeout)

    # --- admission -----------------------------------------------------------

    def submit(self, left: np.ndarray, right: np.ndarray, *,
               iters: Optional[int] = None, stream: Optional[str] = None,
               warm_start: bool = False, timeout: Optional[float] = None,
               parent=None) -> ResultHandle:
        """Admit one HWC stereo pair; returns the request's future.

        ``parent`` is an optional span context (obs/trace.py
        ``SpanContext``, e.g. parsed from a traceparent header) that the
        request's span tree joins.

        Raises :class:`ServerDraining` once a drain has started and
        :class:`ServerBusy` when the queue stays full past ``timeout``,
        both before admission: a raised submit is a rejected request,
        never a lost one."""
        if self._draining:
            self.slo.reject()
            raise ServerDraining("server is draining; submit rejected")
        left = np.asarray(left)
        right = np.asarray(right)
        if left.ndim != 3 or right.ndim != 3 or left.shape != right.shape:
            raise ValueError(
                f"expected matching HWC pairs, got {left.shape} vs "
                f"{right.shape}")
        rid = f"r{next(self._ids):06d}"
        req = _Request(
            id=rid, image1=left, image2=right,
            iters=int(iters) if iters is not None
            else self.serve.default_iters,
            warm=bool(warm_start and stream is not None),
            stream=stream, t_submit=time.perf_counter(),
            handle=ResultHandle(rid), parent=parent)
        try:
            admitted = self._queue.put(req, timeout=timeout)
        except QueueClosed:
            self.slo.reject()
            raise ServerDraining("server is draining; submit rejected")
        if not admitted:
            self.slo.reject()
            raise ServerBusy(
                f"request queue full ({self.serve.queue_depth}) for "
                f"{timeout}s")
        self.slo.admit(queue_depth=len(self._queue),
                       in_flight=len(self._in_flight))
        return req.handle

    # --- hot reload ----------------------------------------------------------

    def reload(self, state_dict: Dict[str, torch.Tensor],
               note: Optional[str] = None) -> None:
        """Swap the weights at the next batch boundary. Queued and
        in-flight requests are untouched; later dispatches use the new
        weights. Raises at once on a structure mismatch."""
        self.cache.check_structure(state_dict)
        with self._vars_lock:
            self._pending = state_dict
            self._reload_note = note

    def _run_jobs(self) -> None:
        with self._vars_lock:
            jobs, self._jobs = list(self._jobs), deque()
        for job in jobs:
            job.run()

    def _apply_pending_reload(self) -> None:
        with self._vars_lock:
            state_dict, note = self._pending, self._reload_note
            self._pending = None
            self._reload_note = None
        if state_dict is None:
            return
        self.cache.reload(state_dict)
        logger.info("serve: hot-reloaded model weights%s",
                    f" ({note})" if note else "")
        if self.telemetry is not None:
            self.telemetry.emit("queue", depth=len(self._queue),
                                in_flight=len(self._in_flight),
                                reload=True, note=note,
                                **self.slo._counters())

    # --- introspection -------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        snap = self.slo.snapshot(in_flight=len(self._in_flight))
        snap.update(queue_depth=len(self._queue),
                    draining=self._draining,
                    stopped=self._stopped.is_set(),
                    executables=len(self.cache),
                    sessions=len(self._sessions))
        return snap

    def warmup(self, shapes, batch_sizes=(1,), iters=None,
               warm: bool = False) -> int:
        """Make (and with ``aot`` run once) the bucket programs of raw
        ``(H, W)`` shapes before traffic; returns the number made. A
        running server warms up in its scheduler thread, between batches,
        and this call waits for it."""
        keys = []
        for h, w in shapes:
            bh, bw = self._bucket_shape(h, w)
            it, policy = self._bucket_plan(
                bh, bw, int(iters or self.serve.default_iters))
            for b in batch_sizes:
                keys.append(BucketKey(bh, bw, int(b), it, warm, policy,
                                      self._bucket_impl(bw)))
        if not self._thread.is_alive():
            return self.cache.warmup(keys)
        job = _Job(lambda: self.cache.warmup(keys))
        with self._vars_lock:
            self._jobs.append(job)
        return job.wait()

    # --- scheduler internals -------------------------------------------------

    def _bucket_shape(self, h: int, w: int) -> Tuple[int, int]:
        return (bucket_size(h, PAD_DIVIS, self.serve.bucket),
                bucket_size(w, PAD_DIVIS, self.serve.bucket))

    def _bucket_plan(self, bh: int, bw: int, iters: int) -> Tuple[int, str]:
        """(iterations, policy digest) of a padded bucket: where the
        loaded policy covers it, its budget caps the iterations and the
        group rides the early-exit flavour (a cache without policies
        serves every bucket fixed)."""
        lookup = getattr(self.cache, "bucket_entry", None)
        entry = lookup(bh, bw) if lookup is not None else None
        if entry is None:
            return iters, ""
        return min(int(iters), int(entry["budget"])), self.cache.policy_digest

    def _bucket_impl(self, bw: int) -> str:
        """The correlation flavour of a padded bucket width: '' keeps the
        config's implementation; buckets at or past ``fused_width`` ride
        the memoryless 'fused' one (no volume)."""
        fw = int(self.serve.fused_width or 0)
        if fw and bw >= fw and self.cfg.corr_implementation != "fused":
            return "fused"
        return ""

    def _group_key(self, req: _Request) -> Tuple:
        bh, bw = self._bucket_shape(*req.image1.shape[:2])
        iters, policy = self._bucket_plan(bh, bw, req.iters)
        return (bh, bw, iters, req.warm, policy, self._bucket_impl(bw))

    def _collect(self, first: _Request) -> List[_Request]:
        first.t_collect = first.t_collect or time.perf_counter()
        group = collect_group(
            first, self._queue.get_nowait, self._queue.push_front,
            self.serve.max_batch, key=self._group_key)
        tc = time.perf_counter()
        for req in group:
            req.t_collect = req.t_collect or tc
        deadline = time.perf_counter() + self.serve.linger_s
        k0 = self._group_key(first)
        while (len(group) < self.serve.max_batch
               and self.serve.linger_s > 0):
            remaining = deadline - time.perf_counter()
            if remaining <= 0:
                break
            item = self._queue.get(timeout=remaining)
            if item is None:
                break
            if self._group_key(item) != k0:
                self._queue.push_front(item)
                break
            item.t_collect = item.t_collect or time.perf_counter()
            group.append(item)
        return group

    def _session_init(self, req: _Request, bh: int, bw: int) -> np.ndarray:
        """The request's low-res warm-start field: its session's last
        output, or zeros for a new (or reshaped) session."""
        f = self.cfg.factor
        shape = (bh // f, bw // f, 2)
        state = self._sessions.get(req.stream or "")
        if state is not None and state[0] == shape:
            return state[1]
        return np.zeros(shape, np.float32)

    def _dispatch(self, group: List[_Request]) -> None:
        bh, bw, iters, warm, policy, impl = self._group_key(group[0])
        key = BucketKey(bh, bw, len(group), iters, warm, policy, impl)
        t0 = time.perf_counter()
        for req in group:
            req.t_dispatch = t0
        inits = np.stack([self._session_init(r, bh, bw)
                          for r in group]) if warm else None
        try:
            im1, padders, staged1 = padded_batch(
                [r.image1 for r in group], (bh, bw), self.device)
            im2, _, staged2 = padded_batch(
                [r.image2 for r in group], (bh, bw), self.device)
            dispatch = self.cache(key, im1, im2, inits,
                                  keep=(staged1, staged2))
        except Exception as exc:  # shape/launch failure: fail this batch
            self._fail_group(group, key, exc, kind="dispatch")
            return
        t1 = time.perf_counter()
        for req in group:
            req.t_disp_end = t1
        self._in_flight.append((group, padders, key, dispatch))

    def _retire(self) -> None:
        group, padders, key, dispatch = self._in_flight.popleft()
        try:
            # the device-completion point: a fault of the asynchronous
            # forward is raised here
            flow_lr, flow_up, finite, *aux = dispatch.result()
        except Exception as exc:
            self._fail_group(group, key, exc, kind="dispatch")
            return
        # the outputs after the guard, in the forward's order: the
        # per-sample curves, the adaptive flavour's iters_taken, the tap
        # statistics last (adaptive and numerics never combine)
        taps = aux.pop() if aux and self.serve.numerics else None
        taken = aux.pop() if aux and key.policy else None
        deltas = aux[0] if aux and getattr(self.cache, "converge",
                                           self.serve.converge) else None
        now = time.perf_counter()
        if taps is not None:
            # one numerics record a dispatch (the statistics are batch-wide)
            numerics_obs.emit(self.telemetry, numerics_obs.taps_payload(
                f"serve:{key.label()}", taps,
                bucket=f"{key.height}x{key.width}", id=group[0].id))
        for j, req in enumerate(group):
            if not bool(finite[j]):
                # this request failed; its batchmates retire normally. A
                # poisoned session resets, so one bad frame does not
                # poison the warm-start chain
                if req.stream is not None:
                    self._sessions.pop(req.stream, None)
                self._finish(req, ServeResult(
                    request_id=req.id, ok=False,
                    error="non-finite values in request output",
                    error_kind="nonfinite_output", stream=req.stream,
                    latency_s=now - req.t_submit,
                    queue_wait_s=req.t_dispatch - req.t_submit,
                    batch_size=len(group), bucket=key.label()))
                continue
            flow = padders[j].unpad(flow_up[j:j + 1])[0]
            output_min = output_max = None
            if taps is not None:
                # the request's output range for the drift gauges (paid
                # for only with the numerics flavour)
                output_min, output_max = float(flow.min()), float(flow.max())
            flow_lowres = None
            if req.warm and req.stream is not None:
                flow_lowres = flow_lr[j].copy()
                self._sessions[req.stream] = (flow_lowres.shape, flow_lowres)
            final_residual = curve = None
            iters_taken = None if taken is None else int(taken[j])
            if deltas is not None:
                curve = deltas[:, j].copy()
                extra = {} if iters_taken is None else {
                    "iters_taken": iters_taken}
                # the adaptive forward records 0.0 rows for frozen
                # iterations: the quality gauge takes the last applied
                # update's residual
                applied = curve[curve > 0.0]
                final_residual = (float(applied[-1])
                                  if iters_taken is not None and applied.size
                                  else float(curve[-1]))
                converge_emit(self.telemetry, f"serve:{key.label()}",
                              len(curve), curve,
                              bucket=f"{key.height}x{key.width}", id=req.id,
                              **extra)
            self._finish(req, ServeResult(
                request_id=req.id, ok=True, flow=flow, stream=req.stream,
                latency_s=now - req.t_submit,
                queue_wait_s=req.t_dispatch - req.t_submit,
                batch_size=len(group), bucket=key.label(),
                final_residual=final_residual, residuals=curve,
                iters_taken=iters_taken, output_min=output_min,
                output_max=output_max, flow_lowres=flow_lowres))

    def _fail_group(self, group: List[_Request], key: BucketKey,
                    exc: BaseException, kind: str) -> None:
        now = time.perf_counter()
        trace = "".join(tb_module.format_exception(
            type(exc), exc, exc.__traceback__))
        logger.warning("serve: batch %s failed (%s); failing %d request(s) "
                       "individually, scheduler continues",
                       key.label(), exc, len(group))
        for req in group:
            self._finish(req, ServeResult(
                request_id=req.id, ok=False,
                error=f"{type(exc).__name__}: {exc}", error_kind=kind,
                traceback=trace, stream=req.stream,
                latency_s=now - req.t_submit,
                queue_wait_s=(req.t_dispatch or now) - req.t_submit,
                batch_size=len(group), bucket=key.label()))

    def _finish(self, req: _Request, result: ServeResult) -> None:
        req.handle._set(result)
        self.slo.retire(
            request_id=req.id, status="ok" if result.ok else "error",
            latency_s=result.latency_s, queue_wait_s=result.queue_wait_s,
            bucket=result.bucket, batch_size=result.batch_size,
            in_flight=len(self._in_flight), stream=req.stream,
            error=result.error, traceback_tail=result.traceback,
            final_residual=result.final_residual,
            iters_taken=result.iters_taken,
            output_min=result.output_min, output_max=result.output_max)
        # the request's span tree from its lifecycle stamps: queue_wait /
        # collect_group / dispatch / retire tile the root exactly (end =
        # submit + the latency the client was told)
        tracer = getattr(self.telemetry, "tracer", None) or NULL_TRACER
        if tracer.enabled:
            end = req.t_submit + result.latency_s
            tc = req.t_collect or req.t_dispatch or end
            td = req.t_dispatch or tc
            te = req.t_disp_end or td
            # a remote parent's span lives in the client's log:
            # remote_parent exempts the root from the in-file orphan lint
            remote = {"remote_parent": True} if req.parent is not None \
                else {}
            root = tracer.record(
                "request", req.t_submit, end, id=req.id,
                parent=req.parent,
                status="ok" if result.ok else "error",
                bucket=result.bucket, batch_size=result.batch_size,
                **remote)
            tracer.record("queue_wait", req.t_submit, tc, parent=root)
            tracer.record("collect_group", tc, td, parent=root)
            tracer.record("dispatch", td, te, parent=root)
            tracer.record("retire", te, end, parent=root)

    def _run(self) -> None:
        try:
            # both are per thread: this one dispatches every forward
            with torch.inference_mode():
                if self.device.type == "cuda":
                    torch.cuda.set_device(self.device)
                while True:
                    self._run_jobs()
                    self._apply_pending_reload()
                    while len(self._in_flight) >= max(1, self.serve.window):
                        self._retire()
                    first = self._queue.get(
                        timeout=RETIRE_POLL_S if self._in_flight
                        else IDLE_POLL_S)
                    if first is None:
                        if self._in_flight:
                            # the oldest dispatch retires once it is done;
                            # a closed, empty queue has nothing to wait for
                            if (self._queue.closed
                                    or self._in_flight[0][3].ready()):
                                self._retire()
                        elif self._queue.closed and len(self._queue) == 0:
                            break
                        continue
                    group = self._collect(first)
                    # a reload asked for before this group's dispatch
                    # applies to it (the batch boundary)
                    self._apply_pending_reload()
                    self._dispatch(group)
                while self._in_flight:
                    self._retire()
            self.slo.flush(in_flight=0)
        finally:
            with self._vars_lock:
                jobs, self._jobs = list(self._jobs), deque()
            for job in jobs:
                job.cancel()
            # drain: flush buffered spans and bank a flight-recorder dump,
            # so a post-drain postmortem has the run's tail
            tracer = getattr(self.telemetry, "tracer", None)
            if tracer is not None:
                tracer.flush()
            flight = getattr(self.telemetry, "flight_dump", None)
            if flight is not None and self._draining:
                flight("drain")
            self._stopped.set()
            logger.info("serve: scheduler stopped (%s)",
                        "drained" if self._draining else "exited")
