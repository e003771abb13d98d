"""Streaming evaluation driver: overlap decode / dispatch / fetch (the
port's copy of ``raft_stereo_tpu/eval/stream.py``).

The four validators in eval/validate.py share one frame loop. Sequentially,
each frame pays decode + H2D + device compute + D2H + host metrics end to
end, and the card idles while the host works. This driver pipelines the
stages:

* **decode** — a small pool decodes frames ahead of dispatch, in index
  order, bounded by ``prefetch``. The port's own datasets
  (data/datasets.py) decode in worker processes: their numpy PNG decode
  holds the GIL in thousands of small steps a frame, and on threads it
  would stall the dispatching thread (the JAX package's decoders release
  the GIL, so it decodes on threads); other datasets decode on threads;
* **dispatch** — frames go to ``predictor.predict_async`` and the handle is
  queued; up to ``window`` dispatches stay in flight, so the card's queue
  does not drain while the host fetches;
* **micro-batch** — consecutive frames whose raw shapes agree are stacked
  through ONE dispatch, up to ``microbatch``;
* **retire** — handles are resolved strictly in dispatch (= dataset index)
  order and the per-frame metric closure runs on the host while later
  frames compute, so aggregation is the sequential loop's.

Predictors without ``predict_async`` — or ``StreamConfig(enabled=False)``
— take the sequential loop with the same consume ordering and telemetry.

Telemetry: every frame emits a ``step`` record with the data-wait /
dispatch / fetch split (plus ``in_flight`` depth and ``batch_size``), the
streaming path emits a ``pipeline`` gauge every ``GAUGE_EVERY`` dispatches,
and both record ``eval/*`` spans when the bus has a tracer. A predictor
built with ``converge`` adds one ``converge`` record a frame (with ``epe``
and ``iters_taken`` when it has them, also from a micro-batch), one with
``numerics`` one ``numerics`` record a dispatch (the tap statistics are
taken over the whole batch). With ``iter_epe`` the frames' GT goes to
the forward.
"""

from __future__ import annotations

import atexit
import collections
import multiprocessing
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Union

import numpy as np

from raft_stereo_tpu_torch.data.datasets import StereoDataset
from raft_stereo_tpu_torch.data.loader import stop_worker_server
from raft_stereo_tpu_torch.obs import converge as converge_obs
from raft_stereo_tpu_torch.obs import numerics as numerics_obs
from raft_stereo_tpu_torch.obs.trace import NULL_TRACER
from raft_stereo_tpu_torch.serve.batching import collect_group, stack_pairs

# pipeline-gauge cadence, matching data/loader.py's producer gauges
GAUGE_EVERY = 16


@dataclass
class StreamConfig:
    """Knobs of the streaming pipeline (CLI: --stream*, --decode_workers)."""

    #: None = auto: stream when the predictor has ``predict_async``
    enabled: Optional[bool] = None
    #: max in-flight device dispatches (1 = no overlap)
    window: int = 3
    #: max consecutive same-shape frames stacked through one dispatch
    microbatch: int = 1
    #: decode workers feeding the pipeline
    decode_workers: int = 2
    #: decoded frames buffered ahead of dispatch
    prefetch: int = 8


@dataclass
class FrameTiming:
    """Per-frame phase split handed to the consume closure.

    In streaming mode the dispatch/fetch costs of a micro-batch are split
    evenly over its frames, ``device_s`` is unavailable (measuring it would
    re-serialize the pipeline), and ``e2e_s`` is the retire interval — the
    pipelined per-frame cost whose mean is the reciprocal of end-to-end
    throughput. Sequentially, ``device_s``/``e2e_s`` reproduce the timed
    validator's historical semantics (device forward / predict-call wall).
    """

    data_wait_s: float
    dispatch_s: float
    fetch_s: float
    device_s: Optional[float]
    e2e_s: float
    batch_size: int
    in_flight: int


#: consume(index, sample, flow_pred_hw1, timing) — called in index order
Consume = Callable[[int, Dict[str, np.ndarray], np.ndarray, FrameTiming],
                   None]


def resolve_stream(stream: Union[None, bool, StreamConfig]) -> StreamConfig:
    """Validator-kwarg sugar: None/bool/StreamConfig -> StreamConfig."""
    if stream is None:
        return StreamConfig()
    if isinstance(stream, bool):
        return StreamConfig(enabled=stream)
    return stream


def decodes_in_processes(dataset) -> bool:
    """Whether the streaming loop decodes ``dataset`` in worker processes:
    the port's own datasets, yes; any other, on threads (module
    docstring)."""
    return isinstance(dataset, StereoDataset)


# the dataset a decode worker process samples, set once a worker
_worker_dataset = None


def _init_decode_worker(dataset) -> None:
    global _worker_dataset
    _worker_dataset = dataset


def _decode_in_worker(index: int) -> Dict[str, np.ndarray]:
    return _worker_dataset.sample(index)


# whether stop_decode_server runs when the interpreter exits
_stop_registered = False


def stop_decode_server() -> None:
    """Stop the fork server the decode pools fork from, and the resource
    tracker that multiprocessing started beside it, and wait for both to
    exit. Left alone they outlive this process by the time their
    interpreter takes to shut down (about a second, it has torch
    imported). Runs when the interpreter exits once a process pool was
    made; any later pool starts a new server. Call it only when no decode
    pool is open."""
    stop_worker_server()


def _decode_pool(dataset, workers: int):
    """``(pool, submit)``: ``submit(i)`` returns a future of
    ``dataset.sample(i)``. Worker processes fork from a fork server: a
    fresh single-threaded interpreter (a fork of this process would copy
    its threads and CUDA context) that has imported this module and the
    program's main module once, where a spawned worker would import the
    main module again each (seconds for a test or script that imports
    much). Each worker receives the dataset once."""
    workers = max(1, workers)
    if not decodes_in_processes(dataset):
        pool = ThreadPoolExecutor(workers, thread_name_prefix="eval-decode")
        return pool, lambda i: pool.submit(dataset.sample, i)
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload([__name__])
    global _stop_registered
    if not _stop_registered:
        atexit.register(stop_decode_server)
        _stop_registered = True
    pool = ProcessPoolExecutor(workers, mp_context=ctx,
                               initializer=_init_decode_worker,
                               initargs=(dataset,))
    return pool, lambda i: pool.submit(_decode_in_worker, i)


def run_frames(predictor, dataset, consume: Consume, *, iters: int,
               stream: Union[None, bool, StreamConfig] = None,
               telemetry=None, timed: bool = False,
               source: Optional[str] = None) -> Dict[str, Any]:
    """Drive ``consume`` over every dataset frame, in index order.

    ``timed=True`` asks the sequential path for device-only timing via
    ``predictor.predict_timed`` (the KITTI validator's FPS discipline);
    other validators use the single-dispatch ``__call__``. ``source``
    names the validator on the ``converge`` and ``numerics`` records
    (``"eval:<source>"``). Returns a stats dict (mode, wall seconds,
    frames/sec) for callers that report throughput.
    """
    cfg = resolve_stream(stream)
    use_stream = (hasattr(predictor, "predict_async")
                  if cfg.enabled is None else cfg.enabled)
    if use_stream and not hasattr(predictor, "predict_async"):
        raise ValueError(
            f"stream=on but {type(predictor).__name__} has no predict_async")
    n = len(dataset)
    src = f"eval:{source or 'eval'}"
    t_run0 = time.perf_counter()
    if use_stream:
        _run_streaming(predictor, dataset, consume, iters, cfg, telemetry,
                       src)
    else:
        _run_sequential(predictor, dataset, consume, iters, telemetry, timed,
                        src)
    wall = time.perf_counter() - t_run0
    return {
        "mode": "stream" if use_stream else "sequential",
        "frames": n,
        "wall_s": wall,
        "frames_per_sec": n / wall if wall > 0 else float("inf"),
        "window": cfg.window if use_stream else 1,
        "microbatch": cfg.microbatch if use_stream else 1,
    }


def _emit_step(telemetry, index: int, timing: FrameTiming) -> None:
    if telemetry is not None:
        telemetry.step(index + 1, data_wait_s=timing.data_wait_s,
                       dispatch_s=timing.dispatch_s, fetch_s=timing.fetch_s,
                       batch_size=timing.batch_size,
                       in_flight=timing.in_flight)


def _gt_kwargs(predictor, samples) -> Dict[str, np.ndarray]:
    """The GT and validity kwargs of the iter-EPE output: only when the
    predictor asks for it (``iter_epe``) and every frame has GT."""
    if not getattr(predictor, "iter_epe", False):
        return {}
    if not all("flow" in s for s in samples):
        return {}
    kw = {"flow_gt": np.stack([s["flow"] for s in samples])}
    if all("valid" in s for s in samples):
        kw["valid"] = np.stack([s["valid"] for s in samples])
    return kw


def _emit_numerics(telemetry, source, sample, aux, index) -> None:
    """One dispatch's ``numerics`` record (the statistics are over the
    whole batch); ``frame`` is the group's first dataset index."""
    if telemetry is None or aux is None:
        return
    taps = aux.get("numerics")
    if not taps:
        return
    h, w = sample["image1"].shape[:2]
    numerics_obs.emit(telemetry, numerics_obs.taps_payload(
        source, taps, bucket=f"{h}x{w}", frame=index))


def _emit_converge(telemetry, source, sample, aux, j, index) -> None:
    """Frame ``j`` of a dispatch's ``converge`` record, with its
    ``iters_taken`` when the predictor ran the early exit."""
    if telemetry is None or aux is None or "residual" not in aux:
        return
    residual = np.asarray(aux["residual"])
    res = residual[:, j] if residual.ndim == 2 else residual
    epe = aux.get("epe")
    if epe is not None:
        epe = np.asarray(epe)
        epe = epe[:, j] if epe.ndim == 2 else epe
    extra = {}
    taken = aux.get("iters_taken")
    if taken is not None:
        arr = np.asarray(taken)
        extra["iters_taken"] = int(arr[j] if arr.ndim else arr)
    h, w = sample["image1"].shape[:2]
    converge_obs.emit(telemetry, source, len(res), res, epe=epe,
                      bucket=f"{h}x{w}", frame=index, **extra)


def _run_sequential(predictor, dataset, consume, iters, telemetry, timed,
                    source):
    tracer = getattr(telemetry, "tracer", None) or NULL_TRACER
    take_aux = getattr(predictor, "take_aux", None)
    for i in range(len(dataset)):
        t_load = time.perf_counter()
        sample = dataset.sample(i)
        gt_kw = _gt_kwargs(predictor, [sample])
        t0 = time.perf_counter()
        if timed:
            flow, dt_dev = predictor.predict_timed(
                sample["image1"][None], sample["image2"][None], iters,
                **gt_kw)
        else:
            flow = predictor(sample["image1"][None], sample["image2"][None],
                             iters, **gt_kw)
            dt_dev = None
        t1 = time.perf_counter()
        root = tracer.record("eval/frame", t_load, t1, index=i)
        tracer.record("eval/decode", t_load, t0, parent=root)
        tracer.record("eval/predict", t0, t1, parent=root)
        # historical split (eval/validate.py r5 KITTI loop): dispatch is the
        # device forward where measured, fetch the pad/transfer overhead
        # around it; untimed validators can't split the single blocking call
        dispatch_s = dt_dev if dt_dev is not None else t1 - t0
        timing = FrameTiming(
            data_wait_s=t0 - t_load, dispatch_s=dispatch_s,
            fetch_s=max((t1 - t0) - dispatch_s, 0.0), device_s=dt_dev,
            e2e_s=t1 - t0, batch_size=1, in_flight=1)
        _emit_step(telemetry, i, timing)
        aux = take_aux() if take_aux is not None else None
        _emit_converge(telemetry, source, sample, aux, 0, i)
        _emit_numerics(telemetry, source, sample, aux, i)
        consume(i, sample, flow[0], timing)


def _run_streaming(predictor, dataset, consume, iters, cfg, telemetry,
                   source):
    tracer = getattr(telemetry, "tracer", None) or NULL_TRACER
    n = len(dataset)
    window = max(1, cfg.window)
    microbatch = max(1, cfg.microbatch)
    lookahead = max(cfg.prefetch, microbatch, 1)
    pool, submit = _decode_pool(dataset, cfg.decode_workers)
    pending: "collections.deque" = collections.deque()  # (idx, future)
    decoded: "collections.deque" = collections.deque()  # (idx, sample)
    in_flight: "collections.deque" = collections.deque()
    next_submit = 0
    dispatches = 0
    t_last_retire = time.perf_counter()

    def fill():
        nonlocal next_submit
        while next_submit < n and len(pending) + len(decoded) < lookahead:
            pending.append((next_submit, submit(next_submit)))
            next_submit += 1

    def take_decoded():
        """Next decoded frame in index order; returns (idx, sample, wait_s)."""
        if decoded:
            idx, sample = decoded.popleft()
            return idx, sample, 0.0
        idx, fut = pending.popleft()
        t0 = time.perf_counter()
        sample = fut.result()
        return idx, sample, time.perf_counter() - t0

    def retire():
        nonlocal t_last_retire
        group, handle, dispatch_s, data_wait_s, stamps = in_flight.popleft()
        tr0 = time.perf_counter()
        flows = handle.result()  # (B, H, W, 1); blocks until the device is done
        aux_fn = getattr(handle, "aux_result", None)
        aux = aux_fn() if aux_fn is not None else None
        tr1 = time.perf_counter()
        fetch_s = getattr(handle, "fetch_s", None) or 0.0
        b = len(group)
        # one span tree per micro-batch group, from the first decode pull
        # to the result fetch; decode_wait is the summed future-wait
        # charged at the group's start
        tg0, td0, td1 = stamps
        root = tracer.record("eval/frames", tg0, tr1, frames=b,
                             first_index=group[0][0])
        tracer.record("eval/decode_wait", tg0, tg0 + data_wait_s,
                      parent=root)
        tracer.record("eval/dispatch", td0, td1, parent=root)
        tracer.record("eval/fetch", tr0, tr1, parent=root)
        _emit_numerics(telemetry, source, group[0][1], aux, group[0][0])
        for j, (idx, sample) in enumerate(group):
            now = time.perf_counter()
            timing = FrameTiming(
                data_wait_s=data_wait_s / b, dispatch_s=dispatch_s / b,
                fetch_s=fetch_s / b, device_s=None,
                e2e_s=now - t_last_retire, batch_size=b,
                in_flight=len(in_flight))
            t_last_retire = now
            _emit_step(telemetry, idx, timing)
            _emit_converge(telemetry, source, sample, aux, j, idx)
            consume(idx, sample, flows[j], timing)

    finished = False
    try:
        fill()
        while pending or decoded or next_submit < n or in_flight:
            frames_left = pending or decoded or next_submit < n
            if frames_left and len(in_flight) < window:
                tg0 = time.perf_counter()
                idx0, s0, wait = take_decoded()
                fill()
                # stack consecutive same-shape frames into one dispatch;
                # a shape break is pushed back and starts the next group
                # (serve/batching.py owns the policy, shared with the
                # serving scheduler). The decode wait of a pushed-back
                # frame is still charged to the CURRENT group — it was
                # paid while forming it.
                waits = [wait]

                def pull():
                    if not (decoded or pending):
                        return None
                    idx_k, s_k, wait_k = take_decoded()
                    fill()
                    waits.append(wait_k)
                    return (idx_k, s_k)

                group = collect_group(
                    (idx0, s0), pull, decoded.appendleft, microbatch,
                    key=lambda item: item[1]["image1"].shape)
                wait = sum(waits)
                im1, im2 = stack_pairs([s for _, s in group])
                gt_kw = _gt_kwargs(predictor, [s for _, s in group])
                t0 = time.perf_counter()
                handle = predictor.predict_async(im1, im2, iters, **gt_kw)
                t1 = time.perf_counter()
                dispatch_s = t1 - t0
                in_flight.append((group, handle, dispatch_s, wait,
                                  (tg0, t0, t1)))
                dispatches += 1
                if telemetry is not None and \
                        dispatches % GAUGE_EVERY == 1:
                    telemetry.pipeline(in_flight=len(in_flight),
                                       window=window, microbatch=microbatch)
            else:
                retire()
        finished = True
    finally:
        # every future is consumed on success: wait for the workers to exit
        pool.shutdown(wait=finished, cancel_futures=not finished)
