"""The port's augmentor (``raft_stereo_tpu_torch/data/augment.py``) against
OpenCV and the JAX package's augmentors, on the CPU.

* ``resize_linear`` against ``cv2.resize(..., INTER_LINEAR)`` over a sweep
  of sizes and scales: uint8 with 1 and 3 channels bitwise; float32 with 2
  channels (the flow) within FLOAT_RESIZE_REL of the output's largest
  magnitude (measured 1.6e-5 over the sweep: OpenCV's float kernel sums
  in another order).
* ``rgb_to_hsv``/``hsv_to_rgb`` against ``cv2.cvtColor`` bitwise, on rows
  whose width is a multiple of 16 (OpenCV's vector path; the last pixel of
  a row that is not can differ by a float32 ulp: a row of 97 pixels had
  one such pixel in 50 rows).
* ``FlowAugmentor`` and ``SparseFlowAugmentor`` against the JAX ones on the
  same ``np.random.Generator`` seeds, every ``do_flip`` mode, yjitter on
  and off, gamma and saturation set: images and valid masks bitwise (0
  levels of 10^6 differ), flow within FLOW_REL of its largest magnitude,
  and both generators left in the same state.
"""

import cv2
import numpy as np
import pytest

from raft_stereo_tpu.data import augment as jaug
from raft_stereo_tpu_torch.data import augment as taug

from torch_parity import torch_one_thread  # noqa: F401

FLOAT_RESIZE_REL = 4e-5
FLOW_REL = 4e-5
GAMMA = (0.9, 1.2, 0.8, 1.1)
SATURATION = (0.0, 1.4)


def _sweep(seed, n):
    rng = np.random.default_rng(seed)
    for _ in range(n):
        h, w = (int(x) for x in rng.integers(6, 160, 2))
        fx, fy = (float(2.0 ** rng.uniform(-0.7, 0.8)) for _ in range(2))
        yield rng, h, w, fx, fy


@pytest.mark.parametrize("channels", [1, 3])
def test_resize_linear_uint8_is_opencv(channels, record_property):
    total = 0
    for rng, h, w, fx, fy in _sweep(channels, 60):
        shape = (h, w) if channels == 1 else (h, w, channels)
        img = rng.integers(0, 256, shape, dtype=np.uint8)
        want = cv2.resize(img, None, fx=fx, fy=fy,
                          interpolation=cv2.INTER_LINEAR)
        got = taug.resize_linear(img, fx, fy)
        assert got.shape == want.shape and got.dtype == np.uint8
        assert np.array_equal(got, want), (shape, fx, fy)
        total += want.size
    record_property("values_compared", total)


def test_resize_linear_float32_within_bound(record_property):
    worst = 0.0
    for rng, h, w, fx, fy in _sweep(7, 60):
        flow = (rng.normal(size=(h, w, 2)) * 20).astype(np.float32)
        want = cv2.resize(flow, None, fx=fx, fy=fy,
                          interpolation=cv2.INTER_LINEAR)
        got = taug.resize_linear(flow, fx, fy)
        assert got.shape == want.shape and got.dtype == np.float32
        worst = max(worst, float(np.abs(got - want).max()
                                 / np.abs(want).max()))
    record_property("max_rel_dev", worst)
    assert worst <= FLOAT_RESIZE_REL


@pytest.mark.parametrize("width", [16, 96, 960])
def test_hsv_is_opencv(width):
    rng = np.random.default_rng(width)
    img = (rng.integers(0, 256, (24, width, 3)).astype(np.float32)
           / 255.0).astype(np.float32)
    img[:3] = img[:3, :, :1]  # grays: zero saturation
    want = cv2.cvtColor(img, cv2.COLOR_RGB2HSV)
    got = taug.rgb_to_hsv(img)
    assert np.array_equal(got, want)
    hsv = want.copy()
    hsv[..., 0] = (hsv[..., 0] + np.float32(137.5)) % np.float32(360)
    assert np.array_equal(taug.hsv_to_rgb(hsv),
                          cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB))


def _pair(seed, h=64, w=96):
    rng = np.random.default_rng(seed)
    small = rng.uniform(0, 255, (h // 4 + 1, w // 4 + 1, 3))
    img1 = np.kron(small, np.ones((4, 4, 1)))[:h, :w]
    img1 = np.clip(img1 + rng.normal(0, 8, img1.shape), 0, 255).astype(
        np.uint8)
    img2 = np.roll(img1, -5, axis=1)
    disp = rng.uniform(0.5, 20, (h, w)).astype(np.float32)
    flow = np.stack([-disp, np.zeros_like(disp)], axis=-1)
    valid = rng.uniform(size=(h, w)) > 0.3
    return img1, img2, flow, valid


def _forced(aug, do_flip, force):
    if force:
        aug.h_flip_prob = aug.v_flip_prob = 1.1
    return aug


CASES = [(flip, yjitter, force) for flip in (None, "hf", "h", "v")
         for yjitter in (False, True) for force in (False, True)
         if flip is not None or not force]


@pytest.mark.parametrize("do_flip,yjitter,force", CASES)
def test_flow_augmentor_matches_jax(do_flip, yjitter, force,
                                    record_property):
    kw = dict(crop_size=(32, 48), min_scale=-0.2, max_scale=0.4,
              do_flip=do_flip, yjitter=yjitter, saturation_range=SATURATION,
              gamma=GAMMA)
    jax_aug = _forced(jaug.FlowAugmentor(**kw), do_flip, force)
    port_aug = _forced(taug.FlowAugmentor(**kw), do_flip, force)
    worst = 0.0
    for seed in range(6):
        img1, img2, flow, _ = _pair(seed)
        rj = np.random.default_rng(seed)
        rt = np.random.default_rng(seed)
        want = jax_aug(img1, img2, flow, rj)
        got = port_aug(img1, img2, flow, rt)
        assert np.array_equal(got[0], want[0]), seed
        assert np.array_equal(got[1], want[1]), seed
        assert got[2].shape == want[2].shape and got[2].dtype == \
            want[2].dtype
        worst = max(worst, float(np.abs(got[2] - want[2]).max()
                                 / np.abs(want[2]).max()))
        assert rt.random() == rj.random()  # one stream, consumed alike
    record_property("flow_max_rel_dev", worst)
    assert worst <= FLOW_REL


@pytest.mark.parametrize("do_flip,force", [(None, False), ("hf", True),
                                           ("h", True), ("v", True),
                                           ("v", False)])
def test_sparse_augmentor_matches_jax(do_flip, force):
    kw = dict(crop_size=(32, 48), min_scale=-0.2, max_scale=0.4,
              do_flip=do_flip, saturation_range=SATURATION, gamma=GAMMA)
    jax_aug = _forced(jaug.SparseFlowAugmentor(**kw), do_flip, force)
    port_aug = _forced(taug.SparseFlowAugmentor(**kw), do_flip, force)
    for seed in range(6):
        img1, img2, flow, valid = _pair(seed + 10)
        valid = valid.astype(np.float32)
        rj = np.random.default_rng(seed)
        rt = np.random.default_rng(seed)
        want = jax_aug(img1, img2, flow, valid, rj)
        got = port_aug(img1, img2, flow, valid, rt)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b), seed
        assert rt.random() == rj.random()


def test_resize_sparse_flow_map_matches_jax():
    _, _, flow, valid = _pair(3)
    for f in (0.7, 1.0, 1.37):
        got = taug.SparseFlowAugmentor.resize_sparse_flow_map(flow, valid,
                                                              f, f)
        want = jaug.SparseFlowAugmentor.resize_sparse_flow_map(flow, valid,
                                                               f, f)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and np.array_equal(a, b)
