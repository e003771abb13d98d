"""Micro-batching primitives (the port's copy of ``collect_group`` and
``stack_pairs`` from ``raft_stereo_tpu/serve/batching.py``), used by the
streaming evaluator: greedily take consecutive items while their shape key
matches, and push the first mismatch back so that it starts the next group.
The serving queue (``BoundedQueue``) waits for the serving port (ROADMAP
A12).
"""

from __future__ import annotations

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
