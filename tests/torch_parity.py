"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Weights come from the JAX package's own variable tree: ``jax.eval_shape``
of the flax init gives the tree's structure without compiling anything,
and every leaf is filled from a seeded numpy generator — conv kernels
He-normal, biases and norm affines small and non-trivial, batch-norm
statistics away from identity — so the weight bridge is exercised on
every kind of leaf. Both frameworks then get the same weights.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def fill_tree(shapes, seed: int):
    """A numpy tree shaped like ``shapes`` (ShapeDtypeStructs), filled from
    ``np.random.default_rng(seed)`` by leaf kind."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        shape = s.shape
        keys = [getattr(p, "key", None) for p in path]
        # The flow head's output conv is scaled by 0.1, so that one
        # iteration moves the disparity by pixels, as a trained model's
        # does; at plain He init it moves it by tens of pixels and the
        # fields reach ~100 px, where fp32 round-off grows with them.
        gain = 0.1 if keys[-3:-1] == ["flow_head", "conv2"] else 1.0
        if name == "kernel":
            kh, kw, _, o = shape
            std = gain * np.sqrt(2.0 / (kh * kw * o))
            return (rng.normal(size=shape) * std).astype(np.float32)
        if name == "bias":
            return (gain * 0.1 * rng.normal(size=shape)).astype(np.float32)
        if name == "scale":
            return (1.0 + 0.1 * rng.normal(size=shape)).astype(np.float32)
        if name == "mean":
            return (0.1 * rng.normal(size=shape)).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, size=shape).astype(np.float32)
        raise KeyError(name)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def jax_variables(cfg, seed: int = 0, image_shape=(1, 64, 128, 3)):
    """Seeded numpy ``{"params", "batch_stats"}`` tree for ``cfg``'s JAX
    model (structure from ``jax.eval_shape`` of its init)."""
    from raft_stereo_tpu.models.raft_stereo import create_model
    model = create_model(cfg)
    dummy = jnp.zeros(image_shape, jnp.float32)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), dummy, dummy, iters=1))
    return fill_tree(dict(shapes), seed)


def module_variables(module, seed: int, *args, **kwargs):
    """Seeded numpy variables for a flax ``module`` applied to ``args``."""
    shapes = jax.eval_shape(
        lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    return fill_tree(dict(shapes), seed)


def max_abs(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def rel_dev(got, want) -> float:
    """Max abs deviation relative to ``max(1, max |want|)``."""
    scale = max(1.0, float(np.max(np.abs(np.asarray(want, np.float64)))))
    return max_abs(got, want) / scale
