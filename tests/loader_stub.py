"""A stub dataset for the loader tests, in a module of its own: the
port's loader samples in worker processes, which import the module that
defines the dataset, and this one imports numpy only (the test module
imports JAX, seconds a worker)."""

import numpy as np


class ArrayDataset:
    """Deterministic rng-consuming stub, the JAX package's test's: sample i
    is f(i, rng)."""

    def __init__(self, n=8, fail=(), fail_times=None):
        self.n = n
        self.fail = set(fail)
        self.fail_times = dict(fail_times or {})

    def __len__(self):
        return self.n

    def sample(self, index, rng):
        if index in self.fail:
            raise IOError(f"decode failed for {index}")
        remaining = self.fail_times.get(index)
        if remaining:
            self.fail_times[index] = remaining - 1
            raise IOError(f"transient failure for {index}")
        jitter = rng.random(3).astype(np.float32)
        return {
            "image1": np.full((4, 6, 3), index, np.float32) + jitter[0],
            "image2": np.full((4, 6, 3), index, np.float32) + jitter[1],
            "flow": np.full((4, 6, 1), -index, np.float32) + jitter[2],
            "valid": np.ones((4, 6), np.float32),
        }
