"""PyTorch port ops vs their JAX twins: geometry, the lookup, correlation.

Inputs are made with numpy from a seed and fed to both frameworks. The
lookup's plain version (the CPU side of the ``windowed_sample`` CUDA
kernel) is held to the JAX Pallas kernel run in interpret mode — as
tests/test_pallas_corr.py runs it — and to the JAX pure sampler, at
<= 1e-6 abs for fp32 and bf16 volumes (the blend is fp32 in both;
measured <= 1.2e-7 against the kernel and 0 against the sampler).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_stereo_tpu.ops import geometry as jgeo
from raft_stereo_tpu.ops.corr import corr_lookup as j_corr_lookup
from raft_stereo_tpu.ops.corr import init_corr as j_init_corr
from raft_stereo_tpu.ops.pallas.corr_kernels import windowed_sample_pallas
from raft_stereo_tpu.ops.sampler import windowed_linear_sample as j_sample

from raft_stereo_tpu_torch.ops import geometry as tgeo
from raft_stereo_tpu_torch.ops.corr import corr_lookup, init_corr
from raft_stereo_tpu_torch.ops.kernels.windowed_sample import (
    windowed_sample, windowed_sample_plain)
from raft_stereo_tpu_torch.ops.sampler import windowed_linear_sample

from torch_parity import max_abs


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ------------------------------------------------------------- geometry


def test_coords_grid():
    np.testing.assert_array_equal(tgeo.coords_grid(2, 3, 5).numpy(),
                                  np.asarray(jgeo.coords_grid(2, 3, 5)))


@pytest.mark.parametrize("window,stride,padding,shape", [
    ((3, 3), (2, 2), (1, 1), (2, 9, 13, 4)),
    ((3, 3), (2, 2), (1, 1), (1, 8, 16, 3)),
    ((1, 2), (1, 2), (0, 0), (1, 4, 7, 2)),
    ((2, 2), (2, 2), (0, 0), (1, 5, 5, 1)),
])
def test_avg_pool2d(window, stride, padding, shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    got = tgeo.avg_pool2d(_t(x), window, stride, padding).numpy()
    want = np.asarray(jgeo.avg_pool2d(jnp.asarray(x), window, stride,
                                      padding))
    assert got.shape == want.shape
    assert max_abs(got, want) <= 1e-6


def test_pool2x():
    x = np.random.default_rng(1).normal(size=(2, 11, 6, 3)).astype(
        np.float32)
    got = tgeo.pool2x(_t(x)).numpy()
    want = np.asarray(jgeo.pool2x(jnp.asarray(x)))
    assert got.shape == want.shape and max_abs(got, want) <= 1e-6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w", [16, 15, 7, 3])
def test_pool_last_axis2(dtype, w):
    x = np.random.default_rng(2).normal(size=(1, 2, 3, w)).astype(np.float32)
    got = tgeo.pool_last_axis2(_t(x).to(getattr(torch, dtype)))
    want = jgeo.pool_last_axis2(jnp.asarray(x, getattr(jnp, dtype)))
    assert tuple(got.shape) == want.shape
    # one rounding of (a+b) in the storage dtype, halving is exact
    assert max_abs(got.float().numpy(), np.asarray(want, np.float32)) == 0.0


@pytest.mark.parametrize("src,dst", [((4, 6), (8, 12)), ((8, 12), (4, 6)),
                                     ((1, 5), (3, 9)), ((5, 7), (5, 7))])
def test_resize_bilinear_align_corners(src, dst):
    x = np.random.default_rng(3).normal(size=(2, *src, 3)).astype(np.float32)
    got = tgeo.resize_bilinear_align_corners(_t(x), dst).numpy()
    want = np.asarray(jgeo.resize_bilinear_align_corners(jnp.asarray(x),
                                                         dst))
    # F.interpolate vs the JAX interpolation matmuls: fp32 round-off
    assert got.shape == want.shape and max_abs(got, want) <= 1e-5


@pytest.mark.parametrize("factor", [4, 8])
def test_convex_upsample(factor):
    rng = np.random.default_rng(4)
    flow = rng.normal(size=(2, 5, 7, 2)).astype(np.float32)
    mask = rng.normal(size=(2, 5, 7, 9 * factor * factor)).astype(np.float32)
    got = tgeo.upsample_disparity_convex(_t(flow), _t(mask), factor).numpy()
    want = np.asarray(jgeo.upsample_disparity_convex(
        jnp.asarray(flow), jnp.asarray(mask), factor))
    assert got.shape == (2, 5 * factor, 7 * factor, 1) == want.shape
    # softmax and the 9-term sum in another order: fp32 round-off
    assert max_abs(got, want) <= 1e-5
    # the generic two-channel JAX upsample agrees on channel 0
    ref = np.asarray(jgeo.upsample_flow_convex(
        jnp.asarray(flow), jnp.asarray(mask), factor))[..., :1]
    assert max_abs(got, ref) <= 1e-5


@pytest.mark.parametrize("shape", [(1, 37, 83, 3), (2, 32, 64, 3)])
@pytest.mark.parametrize("target", [None, (64, 96)])
def test_input_padder(shape, target):
    x = np.random.default_rng(5).uniform(0, 255, shape).astype(np.float32)
    tp = tgeo.InputPadder(x.shape, divis_by=32, target=target)
    jp = jgeo.InputPadder(x.shape, divis_by=32, target=target)
    assert tp._pad == jp._pad
    got = tp.pad(_t(x))
    want = np.asarray(jp.pad(jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(tp.unpad(got).numpy(), x)


def test_input_padder_rejects_small_target():
    with pytest.raises(ValueError):
        tgeo.InputPadder((1, 40, 40, 3), target=(32, 64))


# ------------------------------------------------------------- the lookup

R = 4
# (B, H, W1, W2): a kernel-sized level, the odd pyramid 15 -> 7 -> 3 -> 1,
# and levels with W2 <= 2r+2 (the JAX kernel's pure-JAX branch)
LOOKUP_SHAPES = [(2, 3, 16, 24), (1, 2, 15, 15), (1, 2, 15, 7),
                 (1, 2, 15, 3), (1, 2, 15, 1), (1, 2, 8, 10)]


def _lookup_inputs(shape, seed):
    b, h, w1, w2 = shape
    rng = np.random.default_rng(seed)
    vol = rng.normal(size=shape).astype(np.float32)
    center = rng.uniform(-2 * R - 2, w2 + 2 * R + 2,
                         size=(b, h, w1)).astype(np.float32)
    flat = center.reshape(-1)
    # integer, boundary, negative and far-out centers
    edge = [0.0, -1.0, float(w2 - 1), float(w2), -R - 0.5, w2 + R + 0.25,
            1e9, -1e9, 0.999999, -0.0]
    flat[:len(edge)] = edge[:flat.size]
    return vol, center


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", LOOKUP_SHAPES)
def test_lookup_plain_matches_jax_kernel(dtype, shape, record_property):
    vol, center = _lookup_inputs(shape, seed=sum(shape))
    tvol = _t(vol).to(getattr(torch, dtype))
    got = windowed_sample_plain(tvol, _t(center), R).numpy()
    jvol = jnp.asarray(vol, getattr(jnp, dtype))
    want_kernel = np.asarray(windowed_sample_pallas(jvol,
                                                    jnp.asarray(center), R))
    want_sampler = np.asarray(j_sample(jvol, jnp.asarray(center), R))
    assert got.dtype == np.float32 and got.shape == shape[:3] + (2 * R + 1,)
    record_property("max_abs_vs_kernel", max_abs(got, want_kernel))
    record_property("max_abs_vs_sampler", max_abs(got, want_sampler))
    assert max_abs(got, want_kernel) <= 1e-6
    assert max_abs(got, want_sampler) <= 1e-6
    # far-out centers read nothing: exact zeros
    assert np.all(got.reshape(-1, 2 * R + 1)[6:8] == 0.0)


@pytest.mark.parametrize("radius", [1, 3])
def test_lookup_plain_other_radii(radius):
    vol, center = _lookup_inputs((1, 2, 12, 20), seed=7)
    got = windowed_linear_sample(_t(vol), _t(center), radius).numpy()
    want = np.asarray(windowed_sample_pallas(jnp.asarray(vol),
                                             jnp.asarray(center), radius))
    assert max_abs(got, want) <= 1e-6


def test_lookup_nan_center_gives_nan():
    vol, center = _lookup_inputs((1, 1, 4, 16), seed=8)
    center[0, 0, 1] = np.nan
    got = windowed_linear_sample(_t(vol), _t(center), R).numpy()
    want = np.asarray(j_sample(jnp.asarray(vol), jnp.asarray(center), R))
    assert np.all(np.isnan(got[0, 0, 1])) and np.all(np.isnan(want[0, 0, 1]))
    keep = np.ones(4, bool)
    keep[1] = False
    assert max_abs(got[0, 0, keep], want[0, 0, keep]) <= 1e-6


def test_wrapper_takes_plain_path_on_cpu():
    vol, center = _lookup_inputs((1, 2, 15, 15), seed=9)
    before = windowed_sample.launches
    got = windowed_sample(_t(vol), _t(center), R)
    assert windowed_sample.launches == before  # no kernel launched
    np.testing.assert_array_equal(
        got.numpy(), windowed_linear_sample(_t(vol), _t(center), R).numpy())


def test_wrapper_refuses_grad():
    vol, center = _lookup_inputs((1, 2, 15, 15), seed=10)
    with pytest.raises(NotImplementedError, match="backward"):
        windowed_sample(_t(vol).requires_grad_(), _t(center), R)
    with torch.no_grad():  # no gradient needed: fine
        windowed_sample(_t(vol).requires_grad_(), _t(center), R)


def test_wrapper_never_falls_back_off_cpu():
    # a tensor that is not on the CPU must reach the kernel's checks, not
    # the plain version: meta tensors are refused as not-CUDA
    vol = torch.empty((1, 2, 15, 15), device="meta")
    center = torch.empty((1, 2, 15), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        windowed_sample(vol, center, R)


# ------------------------------------------------------------ correlation


@pytest.mark.parametrize("impl,storage", [("reg", None),
                                          ("reg_pallas", None),
                                          ("reg_pallas", "bfloat16")])
def test_corr_init_and_lookup(impl, storage, record_property):
    rng = np.random.default_rng(11)
    b, h, w, d = 2, 3, 40, 16
    f1 = rng.normal(size=(b, h, w, d)).astype(np.float32)
    f2 = rng.normal(size=(b, h, w, d)).astype(np.float32)
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)[None]
    coords = np.broadcast_to(coords, (b, h, w, 2)).astype(np.float32)
    coords = coords + rng.uniform(-12, 6, size=coords.shape).astype(
        np.float32)
    tstate = init_corr(impl, _t(f1), _t(f2), num_levels=4, radius=R,
                       storage_dtype=getattr(torch, storage or "float32"))
    jstate = j_init_corr(impl, jnp.asarray(f1), jnp.asarray(f2),
                         num_levels=4, radius=R,
                         storage_dtype=getattr(jnp, storage or "float32"))
    assert [tuple(v.shape) for v in tstate.levels] == [
        v.shape for v in jstate.levels] == [(b, h, w, w >> i)
                                            for i in range(4)]
    got = corr_lookup(tstate, _t(coords)).numpy()
    want = np.asarray(j_corr_lookup(jstate, jnp.asarray(coords)))
    assert got.shape == want.shape == (b, h, w, 4 * (2 * R + 1))
    # fp32: matmul summation order; bf16 storage: a volume entry whose
    # fp32 values differ in the last bit may round to adjacent bf16 values
    # (one bf16 ulp, 2**-8 relative, of entries up to ~4 in magnitude)
    tol = 1e-5 if storage is None else 2e-2
    record_property("max_abs", max_abs(got, want))
    assert max_abs(got, want) <= tol
