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


def port_config(cfg):
    """The port's config with the same field values as a JAX config.
    Raises ``ValueError`` when ``cfg`` sets a field the port lacks away
    from the JAX default: the port would compute something else."""
    import dataclasses

    from raft_stereo_tpu_torch.config import RAFTStereoConfig
    ported = {f.name for f in dataclasses.fields(RAFTStereoConfig)}
    for f in dataclasses.fields(cfg):
        if f.name not in ported and getattr(cfg, f.name) != f.default:
            raise ValueError(f"{f.name}={getattr(cfg, f.name)!r} is not "
                             "ported to PyTorch yet")
    return RAFTStereoConfig(**{name: getattr(cfg, name) for name in ported})


def rel_l2(got, want) -> float:
    """``||got - want|| / ||want||`` in float64 (0 when both are 0)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    num = float(np.linalg.norm(got - want))
    den = float(np.linalg.norm(want))
    return num / den if den > 0 else num


def perturbed(params, seed, rel=1e-6):
    """``params`` with every weight scaled by ``1 + rel * N(0, 1)``: a
    JAX-vs-JAX null run."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (a * (1.0 + rel * rng.standard_normal(a.shape))).astype(
            np.float32), params)


def flat(sd: dict, names) -> np.ndarray:
    return np.concatenate([np.asarray(sd[k], np.float64).ravel()
                           for k in names])


def null_gate(got: dict, want_tree, null_trees, floor: float,
              skip=frozenset()):
    """The null-floor rule over several null runs. ``got`` maps port names
    to arrays; ``want_tree`` and each of ``null_trees`` are JAX params-
    shaped trees. Returns ``(ok, readings)``: the leaves not in ``skip``
    under ``chip_smoke.null_floor_gate`` with ``floor``, and all leaves
    together within the largest null run's aggregate deviation."""
    from chip_smoke import null_floor_gate
    from raft_stereo_tpu_torch.utils.weights import state_dict_from_jax
    names = list(got)
    want = {k: v.numpy() for k, v in state_dict_from_jax(
        {"params": want_tree}).items() if k in got}
    nulls = [{k: v.numpy() for k, v in state_dict_from_jax(
        {"params": t}).items() if k in got} for t in null_trees]

    def devs(tree):
        return {k: rel_l2(tree[k], want[k]) for k in names}
    leaves = null_floor_gate(devs(got), [devs(n) for n in nulls], floor,
                             [k for k in names if k not in skip])
    flat_want = flat(want, names)
    agg = rel_l2(flat(got, names), flat_want)
    agg_null = [rel_l2(flat(n, names), flat_want) for n in nulls]
    readings = dict(leaves, rel_l2_all=agg,
                    rel_l2_all_null=[min(agg_null), max(agg_null)],
                    leaves_roundoff=len(skip))
    return leaves["ok"] and agg <= max(agg_null), readings
