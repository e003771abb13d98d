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
import pytest


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


# ---------------------------------------------------------- synthetic trees
# Every dataset layout the port's datasets read (after the JAX package's
# tests/test_eval_stream.py and tests/test_data.py writers), with seeded
# contents. PNGs go through ``save`` (8-bit, default PIL) and ``save16``
# (16-bit, default cv2), as the JAX tests write them; pass the port's
# ``png.write_png`` to write a tree without either.

EVAL_H, EVAL_W = 48, 96


def pil_png(path, arr):
    """PIL writes a PNG, whatever the file's extension."""
    from PIL import Image
    path.parent.mkdir(parents=True, exist_ok=True)
    Image.fromarray(arr).save(path, format="PNG")


def cv2_png16(path, arr):
    import cv2
    path.parent.mkdir(parents=True, exist_ok=True)
    assert cv2.imwrite(str(path), arr)


def _pair(rng, path_l, path_r, save, h=EVAL_H, w=EVAL_W):
    save(path_l, rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
    save(path_r, rng.integers(0, 255, (h, w, 3), dtype=np.uint8))


def _pfm(path, disp):
    from raft_stereo_tpu.data import frame_utils
    path.parent.mkdir(parents=True, exist_ok=True)
    frame_utils.write_pfm(str(path), disp)


def write_eth3d(ds, rng, n=2, save=pil_png, bad_frames=()):
    for i in range(n):
        scene = ds / "ETH3D" / "two_view_training" / f"scene_{i}"
        gt = ds / "ETH3D" / "two_view_training_gt" / f"scene_{i}"
        _pair(rng, scene / "im0.png", scene / "im1.png", save)
        disp = rng.uniform(0, 8, (EVAL_H, EVAL_W)).astype(np.float32)
        if i in bad_frames:
            disp[:] = 600.0  # >= 512: every pixel fails the validity cut
        _pfm(gt / "disp0GT.pfm", disp)
        save(gt / "mask0nocc.png", (rng.uniform(size=(EVAL_H, EVAL_W))
                                    > 0.3).astype(np.uint8) * 255)


def write_kitti(ds, rng, n=2, save=pil_png, save16=cv2_png16):
    kroot = ds / "KITTI" / "training"
    for i in range(n):
        _pair(rng, kroot / "image_2" / f"00000{i}_10.png",
              kroot / "image_3" / f"00000{i}_10.png", save)
        disp = rng.uniform(0.5, 40, (EVAL_H, EVAL_W))
        disp[rng.uniform(size=(EVAL_H, EVAL_W)) < 0.2] = 0.0  # invalid
        save16(kroot / "disp_occ_0" / f"00000{i}_10.png",
               (disp * 256.0).astype(np.uint16))


def write_things(ds, rng, n=3, save=pil_png, split="TEST",
                 dstype="frames_finalpass"):
    froot = ds / "FlyingThings3D"
    for i in range(n):
        seq = froot / dstype / split / "A" / f"{i:04d}"
        _pair(rng, seq / "left" / "0006.png", seq / "right" / "0006.png",
              save)
        disp = rng.uniform(0, 8, (EVAL_H, EVAL_W)).astype(np.float32)
        _pfm(froot / "disparity" / split / "A" / f"{i:04d}" / "left"
             / "0006.pfm", disp)


def write_middlebury(ds, rng, save=pil_png, splits=("F",)):
    mb = ds / "Middlebury" / "MiddEval3"
    for split in splits:
        scene = mb / f"training{split}" / "SceneA"
        _pair(rng, scene / "im0.png", scene / "im1.png", save)
        _pfm(scene / "disp0GT.pfm",
             rng.uniform(0, 8, (EVAL_H, EVAL_W)).astype(np.float32))
        save(scene / "mask0nocc.png", (rng.uniform(size=(EVAL_H, EVAL_W))
                                       > 0.3).astype(np.uint8) * 255)
    (mb / "official_train.txt").write_text("SceneA\n")


def write_middlebury_2014(ds, rng, save=pil_png):
    scene = ds / "Middlebury" / "2014" / "Scene-perfect"
    for name in ("im0.png", "im1.png", "im1E.png", "im1L.png"):
        save(scene / name, rng.integers(0, 255, (EVAL_H, EVAL_W, 3),
                                        dtype=np.uint8))
    disp = rng.uniform(0, 8, (EVAL_H, EVAL_W)).astype(np.float32)
    disp[0, :5] = np.inf  # invalid: >= 1e3
    _pfm(scene / "disp0.pfm", disp)


def write_sintel(ds, rng, save=pil_png):
    root = ds / "SintelStereo" / "training"
    for scene in ("alley_1", "bamboo_2"):
        for pass_ in ("clean", "final"):
            _pair(rng, root / f"{pass_}_left" / scene / "frame_0001.png",
                  root / f"{pass_}_right" / scene / "frame_0001.png", save)
        save(root / "disparities" / scene / "frame_0001.png",
             rng.integers(0, 255, (EVAL_H, EVAL_W, 3), dtype=np.uint8))
        save(root / "occlusions" / scene / "frame_0001.png",
             (rng.uniform(size=(EVAL_H, EVAL_W)) > 0.8).astype(np.uint8)
             * 255)


def write_falling_things(ds, rng, save=pil_png, save16=cv2_png16):
    """FallingThings' layout. Its images are JPEGs, which the port does not
    decode: here they hold PNG data under the .jpg names (both frameworks'
    readers go by content)."""
    import json
    root = ds / "FallingThings"
    names = []
    for scene in ("kitchen_0", "kitchen_1"):
        d = root / "mixed" / scene
        _pair(rng, d / "000000.left.jpg", d / "000000.right.jpg", save)
        save16(d / "000000.left.depth.png",
               rng.integers(0, 4000, (EVAL_H, EVAL_W), dtype=np.uint16))
        (d / "_camera_settings.json").write_text(json.dumps(
            {"camera_settings": [{"intrinsic_settings": {"fx": 768.16}}]}))
        names.append(f"mixed/{scene}/000000.left.jpg")
    (root / "filenames.txt").write_text("\n".join(names) + "\n")


def write_tartanair(ds, rng, save=pil_png):
    names = []
    for env in ("abandonedfactory", "seasonsforest_winter"):
        seq = ds / env / "Easy" / "P000"
        _pair(rng, seq / "image_left" / "000000_left.png",
              seq / "image_right" / "000000_right.png", save)
        (seq / "depth_left").mkdir(parents=True, exist_ok=True)
        np.save(seq / "depth_left" / "000000_left_depth.npy",
                rng.uniform(1, 50, (EVAL_H, EVAL_W)).astype(np.float32))
        names.append(f"{env}/Easy/P000/image_left/000000_left.png")
    (ds / "tartanair_filenames.txt").write_text("\n".join(names) + "\n")


def write_eval_tree(ds, rng, save=pil_png, save16=cv2_png16):
    """The four validators' trees (ETH3D, KITTI, FlyingThings TEST,
    Middlebury F)."""
    write_eth3d(ds, rng, save=save)
    write_kitti(ds, rng, save=save, save16=save16)
    write_things(ds, rng, save=save)
    write_middlebury(ds, rng, save=save)
    return ds


@pytest.fixture(autouse=True)
def jax_readers_without_native(monkeypatch):
    """The JAX package's readers on their numpy/cv2 path, its reference
    implementation: its native library (``native/libstereodata.so``) is
    rebuilt, and in tests/test_native.py overwritten with a decoy, in place,
    so a test process that has it mapped can crash when another process of
    the same run rewrites it. A test module opts in by importing this
    fixture."""
    from raft_stereo_tpu.data import native
    monkeypatch.setattr(native, "_load", lambda: None)


@pytest.fixture(scope="module", autouse=True)
def torch_one_thread():
    """One intra-op thread for the module's small CPU forwards (restored
    after it): a test run spreads files over several worker processes, and
    each process's default of one thread a core oversubscribes the CPU. A
    test module opts in by importing this fixture."""
    import torch
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
