"""Micro-batching primitives shared by the streaming evaluator and the
serving scheduler (the port's copy of ``raft_stereo_tpu/serve/batching.py``).

:func:`collect_group` greedily takes consecutive items while their shape
key matches and pushes the first mismatch back, so that it starts the next
group. :class:`BoundedQueue` is the scheduler's request queue: a plain
``queue.Queue`` can neither push an item back to its front (arrival order
kept across group boundaries) nor close admission for a drain.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Callable, List, Optional, Tuple

import numpy as np


def collect_group(first: Any, pull: Callable[[], Optional[Any]],
                  push_back: Callable[[Any], None], limit: int,
                  key: Callable[[Any], Any]) -> List[Any]:
    """Greedy consecutive same-key grouping — the micro-batch policy.

    Starting from ``first``, keep ``pull()``-ing while each item's ``key``
    equals ``first``'s, up to ``limit`` items total. ``pull`` returns None
    when nothing further is available without blocking. The first item
    whose key differs is handed to ``push_back`` (it starts the next
    group) and collection stops — items are never reordered.
    """
    group = [first]
    k0 = key(first)
    while len(group) < max(1, limit):
        item = pull()
        if item is None:
            break
        if key(item) != k0:
            push_back(item)
            break
        group.append(item)
    return group


def stack_pairs(samples) -> Tuple[np.ndarray, np.ndarray]:
    """Stack a same-shape group's image pairs into batched NHWC arrays."""
    im1 = np.stack([s["image1"] for s in samples])
    im2 = np.stack([s["image2"] for s in samples])
    return im1, im2


class QueueClosed(Exception):
    """put() after close(): the queue is draining and admits nothing new."""


class BoundedQueue:
    """Bounded FIFO with front push-back and a drain-aware close.

    * ``put`` blocks while full (backpressure reaches the client instead of
      a backlog growing) and raises :class:`QueueClosed` after ``close()``;
    * ``get`` blocks up to ``timeout`` and returns None on timeout, or when
      the queue is closed and empty (the scheduler's exit signal);
    * ``get_nowait`` returns None instead of raising (the non-blocking pull
      :func:`collect_group` wants);
    * ``push_front`` re-inserts a pulled item at the head, exempt from the
      bound (the item held a slot when it was admitted).
    """

    def __init__(self, maxsize: int):
        self.maxsize = max(1, int(maxsize))
        self._items: "collections.deque" = collections.deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)
        self._closed = False

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    @property
    def closed(self) -> bool:
        with self._lock:
            return self._closed

    def close(self) -> None:
        """Stop admitting; wakes every blocked producer and consumer."""
        with self._lock:
            self._closed = True
            self._not_empty.notify_all()
            self._not_full.notify_all()

    def put(self, item: Any, timeout: Optional[float] = None) -> bool:
        """Admit one item; False on timeout, QueueClosed after close()."""
        with self._not_full:
            while True:
                if self._closed:
                    raise QueueClosed("queue is closed (draining)")
                if len(self._items) < self.maxsize:
                    self._items.append(item)
                    self._not_empty.notify()
                    return True
                if not self._not_full.wait(timeout=timeout):
                    return False

    def get(self, timeout: Optional[float] = None) -> Optional[Any]:
        with self._not_empty:
            while True:
                if self._items:
                    item = self._items.popleft()
                    self._not_full.notify()
                    return item
                if self._closed:
                    return None
                if not self._not_empty.wait(timeout=timeout):
                    return None

    def get_nowait(self) -> Optional[Any]:
        with self._lock:
            if not self._items:
                return None
            item = self._items.popleft()
            self._not_full.notify()
            return item

    def push_front(self, item: Any) -> None:
        with self._lock:
            self._items.appendleft(item)
            self._not_empty.notify()
