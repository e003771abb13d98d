"""Deterministic prefetching batch loader (the port's copy of
``raft_stereo_tpu/data/loader.py``).

Determinism: sample ``i`` of epoch ``e`` is always decoded and augmented
with ``Philox(key=((seed << 32) + e, perm[i]))``, and the epoch's
permutation with ``Philox(key=((seed << 32) + e, 1 << 48))``: the stream
depends on neither the worker count nor the scheduling.

Workers: the port's datasets decode and augment in numpy, which holds the
GIL for most of a sample, and the training loop's main thread enqueues
thousands of kernels a step; so the samples are made in worker processes
forked from a fork server (the streamed evaluation's scheme,
``eval/stream.py``), and batches are collated in a producer thread of
this process. A dataset must therefore pickle. Worker processes import
the program's main module, as multiprocessing's spawned processes do: a
script that trains calls ``train()`` under ``if __name__ ==
"__main__"``. The workers live from the first epoch to ``close()``. A
worker process ignores SIGINT and SIGTERM: the trainer's preemption
handler finishes the step and closes the loader, which shuts the workers
down, and a stop at exit (:func:`stop_worker_server`) waits for the fork
server too.

Data parallelism: a rank loads only its slice of each global batch
(``process_slice``, from ``parallel.distributed.process_batch_slice``):
batch ``b`` of an epoch is ``perm[b*B:(b+1)*B]`` for the global batch
size ``B``, and a rank decodes entries ``[lo, hi)`` of it. The keys, the
permutation and ``start_batch`` are the global stream's, so the ranks'
batches concatenate to the one-process batches bit for bit.

I/O resilience: a decode failure is retried ``decode_retries`` times with
exponential backoff, then the sample is QUARANTINED: substituted by the
next decodable dataset index, decoded with the original slot's Philox
key, so every other slot of the stream stays bitwise the same and a
resumed run quarantines identically. Quarantines are kept in
``quarantined`` and reported through ``quarantine_hook`` (the trainer
forwards them as ``anomaly`` records with ``kind="loader_quarantine"``).
"""

from __future__ import annotations

import atexit
import concurrent.futures
import logging
import multiprocessing
import multiprocessing.forkserver
import multiprocessing.resource_tracker
import queue
import signal
import threading
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Callable, Dict, Iterator, Optional

import numpy as np

logger = logging.getLogger(__name__)

BATCH_FIELDS = ("image1", "image2", "flow", "valid")

# Producer-side gauge cadence: one `loader` telemetry record per this many
# batches.
GAUGE_EVERY = 16

# How many forward dataset indices a quarantine tries before the original
# decode error propagates (a wholly broken dataset fails fast).
QUARANTINE_SCAN = 64


def collate(samples) -> Dict[str, np.ndarray]:
    """Stack per-sample arrays into one contiguous batch per field; uint8
    images become float32."""
    out: Dict[str, np.ndarray] = {}
    for k in BATCH_FIELDS:
        arrs = [s[k] for s in samples]
        if arrs[0].dtype == np.uint8:
            out[k] = np.stack(arrs).astype(np.float32)
        else:
            out[k] = np.stack(arrs)
    return out


def sample_rng(seed: int, epoch: int, index: int) -> np.random.Generator:
    return np.random.Generator(
        np.random.Philox(key=[(seed << 32) + epoch, index]))


class SampleSource:
    """What a worker needs to make a sample: the dataset, the seed and the
    retry policy. Picklable, so a worker process receives it once."""

    def __init__(self, dataset, seed: int, decode_retries: int,
                 retry_backoff_s: float):
        self.dataset = dataset
        self.seed = seed
        self.decode_retries = decode_retries
        self.retry_backoff_s = retry_backoff_s

    def __call__(self, epoch: int, index: int):
        """``(sample, quarantine)``: the sample of ``(epoch, index)`` with
        retry and backoff, or its substitute; ``quarantine`` is None, or
        ``(record, t0, t1)`` with the substitution's record and the
        perf_counter stamps of its scan."""
        delay = self.retry_backoff_s
        error: Optional[Exception] = None
        for attempt in range(self.decode_retries + 1):
            try:
                return self.dataset.sample(
                    index, sample_rng(self.seed, epoch, index)), None
            except Exception as e:
                error = e
                if attempt < self.decode_retries:
                    time.sleep(delay)
                    delay *= 2
        n = len(self.dataset)
        t0 = time.perf_counter()
        for k in range(1, min(n, QUARANTINE_SCAN)):
            sub = (index + k) % n
            try:
                sample = self.dataset.sample(
                    sub, sample_rng(self.seed, epoch, index))
            except Exception:
                continue
            record = {"epoch": epoch, "index": int(index),
                      "substitute": int(sub),
                      "error": f"{type(error).__name__}: {error}",
                      "retries": self.decode_retries}
            return sample, (record, t0, time.perf_counter())
        raise error


# the source a worker process samples, set once a worker
_worker_source: Optional[SampleSource] = None
_stop_registered = False


def _init_worker(source: SampleSource) -> None:
    global _worker_source
    _worker_source = source
    # the trainer's preemption path stops the loader; a signal to the
    # process group must not kill a worker mid-batch
    signal.signal(signal.SIGINT, signal.SIG_IGN)
    signal.signal(signal.SIGTERM, signal.SIG_IGN)


def _sample_in_worker(epoch: int, index: int):
    return _worker_source(epoch, index)


def stop_worker_server() -> None:
    """Stop the fork server the worker pools fork from, and multiprocessing's
    resource tracker, and wait for both (left alone they outlive this
    process by the time their interpreters take to exit). Registered at
    interpreter exit once a process pool was made; call it only when no
    loader is iterating. A resource tracker this process inherited (a
    spawned process uses its parent's) is its parent's to stop."""
    multiprocessing.forkserver._forkserver._stop()
    tracker = multiprocessing.resource_tracker._resource_tracker
    if getattr(tracker, "_pid", None) is not None:
        tracker._stop()


def _worker_pool(source: SampleSource, workers: int):
    """``(pool, submit)``: ``submit(epoch, index)`` returns a future of
    ``source(epoch, index)``, made in one of ``workers`` processes."""
    ctx = multiprocessing.get_context("forkserver")
    ctx.set_forkserver_preload([__name__,
                                "raft_stereo_tpu_torch.data.datasets"])
    global _stop_registered
    if not _stop_registered:
        atexit.register(stop_worker_server)
        _stop_registered = True
    pool = ProcessPoolExecutor(workers, mp_context=ctx,
                               initializer=_init_worker, initargs=(source,))
    return pool, lambda e, i: pool.submit(_sample_in_worker, e, i)


class Loader:
    """Iterable over batches of stacked numpy arrays.

    Each ``__iter__`` starts a fresh epoch: a seeded permutation of the
    dataset, ``num_workers`` worker processes, and a bounded prefetch
    queue. ``batch_size`` is the global batch; ``process_slice`` (None:
    all of it) the range of each batch this process loads.
    """

    def __init__(self, dataset, batch_size: int, seed: int = 0,
                 num_workers: int = 4, shuffle: bool = True,
                 drop_last: bool = True, prefetch: int = 4,
                 decode_retries: int = 2, retry_backoff_s: float = 0.05,
                 process_slice: Optional[slice] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.process_slice = process_slice or slice(0, batch_size)
        self.seed = seed
        self.num_workers = max(1, num_workers)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.epoch = 0
        self.decode_retries = max(0, decode_retries)
        self.retry_backoff_s = retry_backoff_s
        self.quarantine_hook: Optional[Callable[[Dict], None]] = None
        self.quarantined: list = []  # records of substituted samples
        # telemetry hooks (set by the trainer), called from the producer
        # thread; a hook that raises is dropped, never the pipeline
        self.gauge_hook: Optional[Callable[[Dict], None]] = None
        self.tracer = None
        # consumed by the NEXT __iter__ only (then reset): resume support.
        # Sample (epoch, index) fully determines decode + augment, so
        # skipping the first k batches of the restored epoch reproduces the
        # stream of a run that never stopped.
        self.start_batch = 0
        # the workers, made on the first epoch and kept until close()
        self._pool = None
        self._submit = None
        if len(self) == 0:
            raise ValueError(
                f"dataset of {len(dataset)} samples yields no batches at "
                f"batch_size={batch_size} (drop_last={drop_last})")

    def __len__(self) -> int:
        n = len(self.dataset) // self.batch_size
        if not self.drop_last and len(self.dataset) % self.batch_size:
            n += 1
        return n

    def close(self) -> None:
        """Shut the workers down (a later epoch starts new ones)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True, cancel_futures=True)
            self._pool = self._submit = None

    def _quarantined(self, quarantine) -> None:
        record, t0, t1 = quarantine
        self.quarantined.append(record)
        logger.warning(
            "quarantined sample %d (epoch %d) after %d retries: %s — "
            "substituted index %d", record["index"], record["epoch"],
            record["retries"], record["error"], record["substitute"])
        if self.quarantine_hook is not None:
            try:
                self.quarantine_hook(dict(record))
            except Exception:
                self.quarantine_hook = None  # never break the pipeline
        if self.tracer is not None:
            self.tracer.record(
                "loader/quarantine", t0, t1, epoch=record["epoch"],
                index=record["index"], substitute=record["substitute"])

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        epoch = self.epoch
        self.epoch += 1

        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.Generator(
                np.random.Philox(
                    key=[(self.seed << 32) + epoch, 1 << 48])).shuffle(order)

        n_batches = len(self)
        skip, self.start_batch = self.start_batch, 0
        if skip:
            # the permutation depends only on (seed, epoch), so dropping its
            # first k*B entries resumes mid-epoch exactly
            order = order[skip * self.batch_size:]
            n_batches = max(n_batches - skip, 0)
        # this process's entries of each batch, in stream order
        slots = [order[b * self.batch_size:(b + 1) * self.batch_size][
            self.process_slice] for b in range(n_batches)]
        sizes = [len(s) for s in slots]
        order = np.concatenate(slots) if slots else order[:0]
        out: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        if self._pool is None:
            self._pool, self._submit = _worker_pool(
                SampleSource(self.dataset, self.seed, self.decode_retries,
                             self.retry_backoff_s),
                self.num_workers)
        submit = self._submit

        def produce():
            decode_wait = put_wait = 0.0
            tracer = self.tracer
            futures = []
            try:
                # sample futures run one batch ahead of consumption
                ahead = max(2 * max(sizes, default=0), self.num_workers)
                futures = [submit(epoch, int(i))
                           for i in order[:min(len(order), ahead)]]
                submitted = len(futures)
                for b in range(n_batches):
                    batch_futs = futures[:sizes[b]]
                    futures = futures[sizes[b]:]
                    while submitted < len(order) and len(futures) < ahead:
                        futures.append(submit(epoch, int(order[submitted])))
                        submitted += 1
                    try:
                        tb0 = time.perf_counter()
                        results = [f.result() for f in batch_futs]
                        for _, quarantine in results:
                            if quarantine is not None:
                                self._quarantined(quarantine)
                        batch = collate([s for s, _ in results])
                        td = time.perf_counter()
                        decode_wait += td - tb0
                    except Exception as e:  # propagate to consumer
                        out.put(e)
                        return
                    if stop.is_set():
                        return
                    out.put(batch)
                    tp = time.perf_counter()
                    put_wait += tp - td
                    if tracer is not None:
                        # decode (future wait + collate) and put (blocked
                        # on a full prefetch queue) tile the produce root
                        root = tracer.record("loader/produce", tb0, tp,
                                             batch=b, epoch=epoch)
                        tracer.record("loader/decode", tb0, td, parent=root)
                        tracer.record("loader/put_wait", td, tp,
                                      parent=root)
                    if self.gauge_hook is not None and b % GAUGE_EVERY == 0:
                        try:
                            self.gauge_hook({
                                "queue_depth": out.qsize(),
                                "prefetch": self.prefetch,
                                "decode_wait_s": round(decode_wait, 6),
                                "put_wait_s": round(put_wait, 6),
                                "batches_produced": b + 1,
                                "epoch": epoch,
                            })
                        except Exception:
                            self.gauge_hook = None
                out.put(None)
            finally:
                # an epoch left early leaves no work behind in the pool
                for f in futures:
                    f.cancel()
                concurrent.futures.wait(futures)

        thread = threading.Thread(target=produce, daemon=True,
                                  name="loader-produce")
        thread.start()
        try:
            while True:
                try:
                    # bounded wait, so a producer that died silently cannot
                    # wedge training on a get that never returns
                    item = out.get(timeout=5.0)
                except queue.Empty:
                    if thread.is_alive():
                        continue
                    try:  # item landed between the timeout and the check
                        item = out.get_nowait()
                    except queue.Empty:
                        raise RuntimeError(
                            "loader producer thread died without delivering "
                            "a batch or an exception") from None
                if item is None:
                    break
                if isinstance(item, Exception):
                    raise item
                yield item
        finally:
            stop.set()
            # drain so the producer can observe `stop` and exit
            while thread.is_alive():
                try:
                    out.get_nowait()
                except queue.Empty:
                    thread.join(timeout=0.1)


def infinite_batches(loader: Loader) -> Iterator[Dict[str, np.ndarray]]:
    """Loop epochs forever (the reference's ``while should_keep_training``)."""
    while True:
        yield from loader
