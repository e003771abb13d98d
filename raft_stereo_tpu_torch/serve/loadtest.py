"""Synthetic many-client load generator for the serving scheduler (the port
of ``raft_stereo_tpu/serve/loadtest.py``).

``python -m raft_stereo_tpu_torch.serve.loadtest`` runs it: N concurrent
client threads, each a stream of same-shape requests and at least one a
video session riding ``flow_init`` warm starts, submit a mixed-shape trace
to one :class:`StereoServer`, after a sequential ``StereoPredictor``
baseline over the same trace. Both phases write a telemetry run directory
(``step`` and ``throughput`` records); the summary line reads
``LOADTEST summary {...}``, and the exit code is 1 when any admitted
request was lost.

It is also the fault-injection rig: ``poison_at=k`` corrupts the
k-th request (global ordinal) with a NaN pixel, the per-request isolation
proof, and a mid-run SIGTERM must drain with no admitted request lost:
every client counts each submit as exactly one of ok / failed / rejected,
and ``lost`` counts admitted requests that never produced a result.

Progress lines (``LOADTEST progress ...``) go to stdout unbuffered, so a
supervising process can time its signals against real completions.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from raft_stereo_tpu_torch.obs.trace import NULL_TRACER
from raft_stereo_tpu_torch.serve.server import (ServerBusy, ServerDraining,
                                                StereoServer)

#: default mixed-shape trace: three distinct /32 buckets
DEFAULT_SHAPES: Tuple[Tuple[int, int], ...] = ((48, 96), (64, 128), (96, 64))


@dataclasses.dataclass
class LoadTestConfig:
    """Trace shape and fault knobs (the loadtest flags)."""

    shapes: Sequence[Tuple[int, int]] = DEFAULT_SHAPES
    #: concurrent client threads (>= video_streams)
    clients: int = 8
    #: requests per client (a video client's frame count)
    requests_per_client: int = 4
    #: how many clients are video sessions (flow_init warm starts)
    video_streams: int = 1
    iters: int = 2
    #: global request ordinal to poison with a NaN pixel (None = off)
    poison_at: Optional[int] = None
    seed: int = 0
    submit_timeout_s: float = 30.0
    result_timeout_s: float = 600.0
    #: print LOADTEST progress lines to stdout
    progress: bool = True

    def trace(self) -> List[List[Dict]]:
        """Per-client request specs (shape, warm flags, poison marker)."""
        per_client = []
        for c in range(self.clients):
            video = c < self.video_streams
            # video sessions keep one shape; batch clients cycle so every
            # bucket sees traffic from several clients
            shape = self.shapes[c % len(self.shapes)]
            reqs = []
            for j in range(self.requests_per_client):
                ordinal = c * self.requests_per_client + j
                reqs.append({
                    "shape": shape, "ordinal": ordinal, "video": video,
                    "stream": f"video{c}" if video else None,
                    "poison": ordinal == self.poison_at,
                })
            per_client.append(reqs)
        return per_client


def synth_pair(rng: np.random.Generator, h: int, w: int,
               poison: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    left = rng.integers(0, 255, (h, w, 3)).astype(np.float32)
    right = rng.integers(0, 255, (h, w, 3)).astype(np.float32)
    if poison:
        left[0, 0, 0] = np.nan
    return left, right


def run_baseline(predictor, lt: LoadTestConfig, telemetry=None) -> Dict:
    """Sequential ``predict()`` over the flattened trace — the throughput
    floor the served run must meet (clean inputs: the baseline's job is
    speed, the drill injects its faults only at the server)."""
    rng = np.random.default_rng(lt.seed)
    flat = [spec for client in lt.trace() for spec in client]
    t0 = time.perf_counter()
    for i, spec in enumerate(flat):
        left, right = synth_pair(rng, *spec["shape"])
        td = time.perf_counter()
        flow = predictor(left[None], right[None], lt.iters)
        dt = time.perf_counter() - td
        assert flow.shape[1:3] == spec["shape"]
        if telemetry is not None:
            telemetry.step(i, data_wait_s=0.0, dispatch_s=dt, fetch_s=0.0,
                           batch_size=1)
    wall = time.perf_counter() - t0
    pps = len(flat) / wall if wall > 0 else 0.0
    if telemetry is not None:
        telemetry.throughput(pps, steps=len(flat), phase="sequential")
    return {"requests": len(flat), "wall_s": round(wall, 3),
            "pairs_per_sec": round(pps, 4)}


def run_clients(server: StereoServer, lt: LoadTestConfig,
                telemetry=None) -> Dict:
    """Drive the trace through ``server`` with ``lt.clients`` threads;
    returns the accounting summary (ok/failed/rejected/lost per total)."""
    lock = threading.Lock()
    tally = {"submitted": 0, "ok": 0, "failed": 0, "rejected": 0,
             "lost": 0, "poisoned_failed": 0}
    done_count = [0]

    def progress(note: str) -> None:
        if lt.progress:
            with lock:
                line = (f"LOADTEST progress done={done_count[0]} "
                        f"ok={tally['ok']} failed={tally['failed']} "
                        f"rejected={tally['rejected']} {note}")
            print(line, flush=True)

    # client-side spans: each request opens a client_request span whose
    # context rides submit(parent=...), so the server's queue_wait/
    # collect_group/dispatch/retire spans join the client's trace — the
    # in-process twin of the HTTP front's traceparent header
    tracer = getattr(telemetry, "tracer", None) or NULL_TRACER

    def client(idx: int, specs: List[Dict]) -> None:
        rng = np.random.default_rng(lt.seed + 1000 + idx)
        for spec in specs:
            left, right = synth_pair(rng, *spec["shape"],
                                     poison=spec["poison"])
            with lock:
                tally["submitted"] += 1
            span = tracer.start("client_request", client=idx,
                                ordinal=spec["ordinal"]) \
                if tracer.enabled else None
            try:
                handle = server.submit(
                    left, right, iters=lt.iters, stream=spec["stream"],
                    warm_start=spec["video"],
                    timeout=lt.submit_timeout_s,
                    parent=span.context if span is not None else None)
            except ServerDraining:
                with lock:
                    tally["rejected"] += 1
                if span is not None:
                    span.set(status="rejected").end()
                progress(f"client{idx} draining")
                break  # admission closed: the rest of this client's trace
            except ServerBusy:
                with lock:
                    tally["rejected"] += 1
                if span is not None:
                    span.set(status="rejected").end()
                progress(f"client{idx} busy")
                continue
            try:
                result = handle.result(timeout=lt.result_timeout_s)
            except TimeoutError:
                with lock:
                    tally["lost"] += 1  # admitted but never retired
                if span is not None:
                    span.set(status="lost").end()
                progress(f"client{idx} LOST {handle.request_id}")
                continue
            if span is not None:
                span.set(status="ok" if result.ok else "error",
                         request_id=result.request_id).end()
            with lock:
                done_count[0] += 1
                if result.ok:
                    tally["ok"] += 1
                else:
                    tally["failed"] += 1
                    if spec["poison"]:
                        tally["poisoned_failed"] += 1
            if telemetry is not None and result.ok:
                # data_wait stays 0.0 so the seq-vs-serve phase columns
                # compare device time to device time; admission queueing
                # is its own field (and the slo rollup's p50/p99 covers
                # the end-to-end story)
                telemetry.step(
                    spec["ordinal"], data_wait_s=0.0,
                    dispatch_s=result.latency_s - result.queue_wait_s,
                    fetch_s=0.0, batch_size=1, bucket=result.bucket,
                    queue_wait_s=result.queue_wait_s,
                    served_batch=result.batch_size)
            status = "ok" if result.ok else "FAILED"
            progress(f"client{idx} {result.request_id} {status} "
                     f"b={result.batch_size}")

    threads = [threading.Thread(target=client, args=(i, specs),
                                name=f"load-client{i}", daemon=True)
               for i, specs in enumerate(lt.trace())]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    # the joins above are the happens-before edge, but take the tally lock
    # anyway: every write to the shared dict stays under the same guard
    with lock:
        served = tally["ok"] + tally["failed"]
        pps = served / wall if wall > 0 else 0.0
        tally.update(wall_s=round(wall, 3), pairs_per_sec=round(pps, 4),
                     slo=server.slo.snapshot())
    if telemetry is not None and served:
        telemetry.throughput(pps, steps=served, phase="served")
    return tally


def main(argv=None) -> None:
    """The entry point: drive the synthetic trace, print the accounting
    summary, exit 1 on any lost admitted request. The card unless
    ``--device cpu``."""
    import json
    import logging
    import os

    from raft_stereo_tpu_torch import cli
    from raft_stereo_tpu_torch.inference import (StereoPredictor,
                                                 resolve_device)
    from raft_stereo_tpu_torch.obs import Telemetry
    from raft_stereo_tpu_torch.obs.trace import Tracer
    from raft_stereo_tpu_torch.training.resilience import SignalGuard
    from raft_stereo_tpu_torch.utils.weights import load_weights

    args = cli.build_loadtest_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(filename)s:%(lineno)d %(message)s")
    serve_cfg = cli.serve_config(args)
    cfg = cli.model_config(args)
    state = load_weights(args.restore_ckpt, cfg)
    lt = LoadTestConfig(
        shapes=cli._parse_shapes(args.shapes), clients=args.clients,
        requests_per_client=args.requests_per_client,
        video_streams=args.video_streams, iters=args.iters,
        poison_at=args.poison_at, seed=args.seed,
        progress=not args.no_progress)
    summary = {"config": {"shapes": args.shapes, "clients": args.clients,
                          "requests_per_client": args.requests_per_client,
                          "video_streams": args.video_streams,
                          "poison_at": args.poison_at,
                          "max_batch": args.max_batch,
                          "window": args.window, "iters": args.iters,
                          "iter_policy": args.iter_policy,
                          "adaptive": args.adaptive,
                          "device": args.device}}
    if not args.no_baseline:
        predictor = StereoPredictor(cfg, state, valid_iters=args.iters,
                                    bucket=args.bucket, device=args.device)
        # unlike the JAX package's (whose first call a shape compiles
        # inside the timed loop), the baseline is warmed up as the served
        # run is: one forward a shape, outside the timed loop
        with Telemetry(os.path.join(args.run_dir, "seq"),
                       stall_deadline_s=None, host_id=args.host_id,
                       fleet=not args.no_fleet,
                       device=predictor.device) as tel_seq:
            tel_seq.run_start(config={"mode": "loadtest-seq"})
            rng = np.random.default_rng(args.seed)
            for h, w in lt.shapes:
                predictor(*(x[None] for x in synth_pair(rng, h, w)),
                          lt.iters)
            summary["sequential"] = run_baseline(predictor, lt, tel_seq)
        del predictor
        print(f"LOADTEST baseline {json.dumps(summary['sequential'])}",
              flush=True)
    device = resolve_device(args.device)
    tel = Telemetry(os.path.join(args.run_dir, "serve"),
                    stall_deadline_s=None, host_id=args.host_id,
                    fleet=not args.no_fleet, device=device)
    Tracer(tel)  # request-lifecycle spans (attaches as tel.tracer)
    tel.run_start(config={"mode": "loadtest-serve"})
    server = StereoServer(cfg, state, serve_cfg, device=device,
                          telemetry=tel)
    tel.start_heartbeat("loadtest", args.heartbeat_every,
                        probe=lambda: {"completed": server.slo.completed})
    # warm every program the trace reaches (each bucket at every batch
    # size, and the video streams' warm flavour), so the timed phase
    # measures serving
    server.warmup(lt.shapes, batch_sizes=range(1, args.max_batch + 1),
                  iters=lt.iters)
    video_shapes = {lt.shapes[c % len(lt.shapes)]
                    for c in range(lt.video_streams)}
    if video_shapes:
        server.warmup(sorted(video_shapes),
                      batch_sizes=range(
                          1, min(lt.video_streams, args.max_batch) + 1),
                      iters=lt.iters, warm=True)
    with SignalGuard() as guard:
        # a mid-drill SIGTERM drains: admission stops, every admitted
        # request finishes (the zero-lost invariant)
        stop = threading.Event()

        def watch():
            while not stop.is_set():
                if guard.requested:
                    server.request_drain()
                    return
                stop.wait(0.05)

        watcher = threading.Thread(target=watch, daemon=True)
        watcher.start()
        try:
            summary["served"] = run_clients(server, lt, tel)
        finally:
            stop.set()
            watcher.join(timeout=2.0)
    server.request_drain()
    drained = server.join(timeout=600.0)
    summary["served"]["drained"] = drained
    summary["served"]["signal"] = guard.signame
    tel.emit("run_end", steps=server.slo.completed, ok=drained)
    tel.close()
    print(f"LOADTEST summary {json.dumps(summary, sort_keys=True)}",
          flush=True)
    lost = summary["served"]["lost"]
    raise SystemExit(0 if drained and lost == 0 else 1)


if __name__ == "__main__":
    main()
