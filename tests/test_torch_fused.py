"""The memoryless ``fused`` correlation (``alt_cuda``) of the PyTorch port
held to the JAX package's on the CPU.

Inputs are made with numpy from a seed and fed to both frameworks. The
plain versions (the CPU side of the ``fused_corr`` CUDA kernels) are held
to ``fused_windowed_corr_pallas`` run under ``jax.jit`` in interpret mode,
as tests/test_fused_corr.py runs it, and to its hand-written backward by
``jax.vjp``. Each test records its measured deviation as a junit property.
Bounds, with what these inputs measured when the bound was set:

* plain forward: 1e-5 abs in fp32 and bf16 features (taps O(1); the dot
  over D is summed in another order; measured <= 4.8e-7);
* plain backward: ``df1``/``df2`` 1e-5 abs in fp32 (measured <= 2.4e-7);
  in bf16 within one bf16 ulp of the JAX value or 1e-5 abs, whichever is
  larger (both round one fp32 sum once; the 1e-5 covers sums that cancel
  to near 0, where fp32 order moves the rounded value by more than an
  ulp of the result; measured bitwise equal); the center's cotangent is
  None (the port) and 0 (JAX);
* the pyramid (``fused_corr_pyramid``, 1 to 4 levels in one forward
  launch on the card) against the JAX kernel per level at ``center /
  2**i``, at radii 0, 4 and 8 on pyramids whose last level has W2 <= 2r+2:
  the forward 1e-5 abs per level and concatenated (measured <= 9.5e-7);
  its autograd gradients against ``jax.vjp`` of the concatenated JAX
  levels 1e-5 abs in fp32 (measured <= 9.5e-7); in bf16 one bf16 ulp of
  the JAX value or 1e-5 abs (the ``fmap1`` gradient sums the levels' bf16
  values from the last level to the first, as JAX does: measured bitwise
  equal; the levels' gradients within one ulp);
* ``pool_w2``: bitwise (one rounding of ``a+b`` in the input's dtype);
* registry lookup: 1e-5 abs in fp32, and 1e-5 abs with bf16 storage
  (both round the same features to bf16; measured <= 4.8e-7);
* test-mode forward with ``alt_cuda`` against JAX ``fused``: 1e-3 px on
  ``flow_up`` (measured 2.7e-5 px of a 7.5 px field);
* train-mode forward 1e-3 px (measured 2.8e-5), and one step's gradients
  under the null-floor rule of tests/test_torch_training.py (8
  JAX-vs-JAX null runs, weights x (1 + 1e-6 N(0, 1)); measured: all
  gradients 7.4e-5 against null runs of 1.7e-4 to 5.8e-4, leaf score
  1.19 against null scores up to 8.3).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raft_stereo_tpu.config import RAFTStereoConfig as JConfig
from raft_stereo_tpu.inference import StereoPredictor as JPredictor
from raft_stereo_tpu.models.raft_stereo import create_model
from raft_stereo_tpu.ops import geometry as jgeo
from raft_stereo_tpu.ops.corr import corr_lookup as j_corr_lookup
from raft_stereo_tpu.ops.corr import init_corr as j_init_corr
from raft_stereo_tpu.ops.pallas.corr_kernels import (_fused_tiles,
                                                     fused_windowed_corr_pallas)
from raft_stereo_tpu.training import loss as jloss

from raft_stereo_tpu_torch import config as tconfig
from raft_stereo_tpu_torch.inference import StereoPredictor
from raft_stereo_tpu_torch.models import RAFTStereo
from raft_stereo_tpu_torch.ops import geometry as tgeo
from raft_stereo_tpu_torch.ops.corr import corr_lookup, init_corr
from raft_stereo_tpu_torch.ops.kernels.fused_corr import (
    fused_corr, fused_corr_backward_plain, fused_corr_plain,
    fused_corr_pyramid, fused_corr_pyramid_forward, fused_corr_pyramid_plain)
from raft_stereo_tpu_torch.ops.kernels.windowed_sample import windowed_sample
from raft_stereo_tpu_torch.training.state import loss_and_grads
from raft_stereo_tpu_torch.utils.weights import state_dict_from_jax

from torch_parity import (flat, jax_variables, max_abs, null_gate, perturbed,
                          port_config)

SMALL = (32, 32, 32)
B, H, W = 2, 64, 128
ITERS = 2
NULL_RUNS = 8
ROUNDOFF_REL = 1e-7
BF16_ULP = 2.0 ** -7


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# -------------------------------------------------------------- the kernel

# (name, radius, (B, H, W1, W2, D), JAX block_w): radii 1/3/4 on one JAX
# block; a multi-block JAX tiling (block_w 9 < W2, not dividing it); the
# odd pyramid 15 -> 7 -> 3 -> 1, whose narrow levels (W2 <= 2r+2) take the
# JAX package's pure-JAX reference path
CASES = [("r1", 1, (2, 4, 16, 16, 32), 256),
         ("r3", 3, (2, 4, 16, 16, 32), 256),
         ("r4", 4, (2, 4, 16, 16, 32), 256),
         ("r3-multiblock", 3, (2, 4, 16, 16, 32), 9),
         ("w15", 4, (1, 3, 15, 15, 32), 256),
         ("w7", 4, (1, 3, 15, 7, 32), 256),
         ("w3", 4, (1, 3, 15, 3, 32), 256),
         ("w1", 4, (1, 3, 15, 1, 32), 256)]


def _inputs(shape, radius, seed):
    b, h, w1, w2, d = shape
    rng = np.random.default_rng(seed)
    f1 = rng.normal(size=(b, h, w1, d)).astype(np.float32)
    f2 = rng.normal(size=(b, h, w2, d)).astype(np.float32)
    center = rng.uniform(-2 * radius - 2, w2 + 2 * radius + 2,
                         size=(b, h, w1)).astype(np.float32)
    # integer, boundary, negative and far-out centers (finite: JAX's
    # floor(NaN) -> int is implementation-defined)
    edge = [0.0, -1.0, float(w2 - 1), float(w2), -radius - 0.5,
            w2 + radius + 0.25, 1e9, -1e9, 0.999999, -0.0]
    flat_c = center.reshape(-1)
    flat_c[:len(edge)] = edge[:flat_c.size]
    return f1, f2, center


@functools.lru_cache(maxsize=None)
def _jax_fused(radius, block_w):
    return jax.jit(lambda a, b, c: fused_windowed_corr_pallas(
        a, b, c, radius, block_w))


@functools.lru_cache(maxsize=None)
def _jax_fused_vjp(radius, block_w):
    def vjp(a, b, c, ct):
        _, f = jax.vjp(lambda x, y, z: fused_windowed_corr_pallas(
            x, y, z, radius, block_w), a, b, c)
        return f(ct)
    return jax.jit(vjp)


def test_cases_reach_the_jax_paths():
    # the multi-block case tiles W2 into more than one JAX block, and the
    # narrow levels take the JAX reference path
    tiles = {name: _fused_tiles(s[1], s[2], s[3], s[4], 2 * r + 1, bw)
             for name, r, s, bw in CASES}
    assert tiles["r3-multiblock"][2] > 1
    assert tiles["r3-multiblock"][3] > 16  # zero-padded tail block
    assert tiles["r4"] is not None and tiles["r4"][2] == 1
    assert tiles["w7"] is None and tiles["w1"] is None


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,radius,shape,block_w", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_forward_matches_jax(name, radius, shape, block_w, dtype,
                                   record_property):
    f1, f2, center = _inputs(shape, radius, seed=len(name) + radius)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = fused_corr_plain(_t(f1).to(tdt), _t(f2).to(tdt), _t(center),
                           radius).numpy()
    want = np.asarray(_jax_fused(radius, block_w)(
        jnp.asarray(f1, jdt), jnp.asarray(f2, jdt), jnp.asarray(center)))
    k = 2 * radius + 1
    assert got.dtype == np.float32 and got.shape == shape[:3] + (k,)
    record_property("max_abs", max_abs(got, want))
    assert max_abs(got, want) <= 1e-5
    assert np.all(got.reshape(-1, k)[6:8] == 0.0)  # far out: exact zeros


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,radius,shape,block_w", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_backward_matches_jax(name, radius, shape, block_w, dtype,
                                    record_property):
    f1, f2, center = _inputs(shape, radius, seed=len(name) + radius + 1)
    k = 2 * radius + 1
    ct = np.random.default_rng(radius).normal(
        size=shape[:3] + (k,)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    df1, df2 = fused_corr_backward_plain(_t(f1).to(tdt), _t(f2).to(tdt),
                                         _t(center), _t(ct), radius)
    assert df1.dtype == df2.dtype == tdt
    assert tuple(df1.shape) == f1.shape and tuple(df2.shape) == f2.shape
    w1, w2, dc = _jax_fused_vjp(radius, block_w)(
        jnp.asarray(f1, jdt), jnp.asarray(f2, jdt), jnp.asarray(center),
        jnp.asarray(ct))
    assert not np.any(np.asarray(dc))  # JAX: no coords gradient
    errs = []
    for got, want in ((df1, w1), (df2, w2)):
        got = got.float().numpy()
        want = np.asarray(want.astype(jnp.float32))
        errs.append(max_abs(got, want))
        if dtype == "float32":
            assert errs[-1] <= 1e-5
        else:
            bound = np.maximum(np.abs(want) * BF16_ULP, 1e-5)
            assert np.all(np.abs(got - want) <= bound)
    record_property("max_abs_df1", errs[0])
    record_property("max_abs_df2", errs[1])
    assert np.abs(df1.float().numpy()).max() > 0
    if shape[3] > 1:
        assert np.abs(df2.float().numpy()).max() > 0


def test_wrapper_takes_plain_path_on_cpu_and_gives_center_no_grad():
    f1, f2, center = _inputs((1, 2, 12, 12, 16), 4, seed=3)
    tf1, tf2 = _t(f1).requires_grad_(), _t(f2).requires_grad_()
    tc = _t(center).requires_grad_()
    before = (fused_corr.launches, fused_corr.bwd_launches)
    out = fused_corr(tf1, tf2, tc, 4)
    ct = _t(np.random.default_rng(4).normal(size=out.shape).astype(
        np.float32))
    df1, df2, dc = torch.autograd.grad(out, (tf1, tf2, tc), ct,
                                       allow_unused=True)
    assert (fused_corr.launches, fused_corr.bwd_launches) == before
    assert torch.equal(out, fused_corr_plain(_t(f1), _t(f2), _t(center), 4))
    want = fused_corr_backward_plain(_t(f1), _t(f2), _t(center), ct, 4)
    assert torch.equal(df1, want[0]) and torch.equal(df2, want[1])
    assert dc is None


def test_nan_center_follows_windowed_sample():
    # a NaN center takes base -r as windowed_sample does: NaN outputs, NaN
    # gradients on the taps of that base, the rest of the row untouched
    f1, f2, center = _inputs((1, 1, 4, 16, 8), 4, seed=5)
    center[0, 0, 1] = np.nan
    out = fused_corr_plain(_t(f1), _t(f2), _t(center), 4).numpy()
    assert np.all(np.isnan(out[0, 0, 1]))
    assert np.all(np.isfinite(np.delete(out[0, 0], 1, axis=0)))
    ct = np.ones((1, 1, 4, 9), np.float32)
    ct[0, 0, [0, 2, 3]] = 0.0
    df1, df2 = fused_corr_backward_plain(_t(f1), _t(f2), _t(center), _t(ct),
                                         4)
    assert np.all(np.isnan(df1[0, 0, 1].numpy()))
    rows = np.isnan(df2[0, 0].numpy()).all(axis=-1)
    np.testing.assert_array_equal(rows, np.arange(16) < 4 + 2)


def test_wrapper_never_falls_back_off_cpu():
    f = torch.empty((1, 2, 15, 8), device="meta")
    c = torch.empty((1, 2, 15), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_corr(f, f, c, 4)


# ------------------------------------------------------------ the pyramid

# (radius, (B, H, W1, D)): level widths W1 >> i, so the last level (W1 / 8)
# has W2 <= 2r+2 and takes the JAX reference path, the wider ones the
# Pallas kernel in interpret mode
PYRAMIDS = [(0, (2, 3, 16, 32)), (4, (2, 3, 48, 32)), (8, (1, 3, 48, 32))]


def _pyramid_inputs(radius, shape, seed):
    b, h, w1, d = shape
    rng = np.random.default_rng(seed)
    f1 = rng.normal(size=(b, h, w1, d)).astype(np.float32)
    levels = [rng.normal(size=(b, h, w1 >> i, d)).astype(np.float32)
              for i in range(4)]
    center = rng.uniform(-2 * radius - 2, w1 + 2 * radius + 2,
                         size=(b, h, w1)).astype(np.float32)
    flat_c = center.reshape(-1)
    edge = [0.0, -1.0, float(w1 - 1), float(w1), 1e9, -1e9, 0.999999]
    flat_c[:len(edge)] = edge
    return f1, levels, center


@functools.lru_cache(maxsize=None)
def _jax_pyramid(radius):
    def pyr(f1, levels, c):
        return jnp.concatenate([fused_windowed_corr_pallas(
            f1, f2, c / (2 ** i), radius) for i, f2 in enumerate(levels)],
            axis=-1)

    def vjp(f1, levels, c, ct):
        _, f = jax.vjp(lambda a, lv: pyr(a, lv, c), f1, levels)
        return f(ct)
    return jax.jit(pyr), jax.jit(vjp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("radius,shape", PYRAMIDS,
                         ids=[f"r{r}" for r, _ in PYRAMIDS])
def test_pyramid_forward_matches_jax(radius, shape, dtype, record_property):
    f1, levels, center = _pyramid_inputs(radius, shape, seed=20 + radius)
    k = 2 * radius + 1
    assert shape[2] >> 3 <= 2 * radius + 2  # the last level is narrow
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    t_levels = [_t(x).to(tdt) for x in levels]
    before = (fused_corr.launches, fused_corr.bwd_launches)
    got = fused_corr_pyramid(_t(f1).to(tdt), t_levels, _t(center),
                             radius).numpy()
    assert (fused_corr.launches, fused_corr.bwd_launches) == before
    want = np.asarray(_jax_pyramid(radius)[0](
        jnp.asarray(f1, jdt), [jnp.asarray(x, jdt) for x in levels],
        jnp.asarray(center)))
    assert got.dtype == np.float32 and got.shape == shape[:3] + (4 * k,)
    for i in range(4):  # level by level: the per-level entry point too
        one = fused_corr_plain(_t(f1).to(tdt), t_levels[i],
                               _t(center) / (2 ** i), radius).numpy()
        assert np.array_equal(got[..., i * k:(i + 1) * k], one)
        assert max_abs(one, want[..., i * k:(i + 1) * k]) <= 1e-5
    record_property("max_abs", max_abs(got, want))
    assert max_abs(got, want) <= 1e-5
    assert np.all(got.reshape(-1, 4 * k)[4:6] == 0.0)  # far out: zeros
    assert np.array_equal(got, fused_corr_pyramid_plain(
        _t(f1).to(tdt), t_levels, _t(center), radius).numpy())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("radius,shape", PYRAMIDS,
                         ids=[f"r{r}" for r, _ in PYRAMIDS])
def test_pyramid_gradients_match_jax(radius, shape, dtype, record_property):
    f1, levels, center = _pyramid_inputs(radius, shape, seed=30 + radius)
    k = 2 * radius + 1
    ct = np.random.default_rng(radius + 5).normal(
        size=shape[:3] + (4 * k,)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    tf1 = _t(f1).to(tdt).requires_grad_()
    t_levels = [_t(x).to(tdt).requires_grad_() for x in levels]
    out = fused_corr_pyramid(tf1, t_levels, _t(center), radius)
    got = torch.autograd.grad(out, [tf1, *t_levels], _t(ct))
    assert all(g.dtype == tdt for g in got)
    w1, wl = _jax_pyramid(radius)[1](
        jnp.asarray(f1, jdt), [jnp.asarray(x, jdt) for x in levels],
        jnp.asarray(center), jnp.asarray(ct))
    errs = []
    for i, (g, w) in enumerate(zip(got, [w1, *wl])):
        g = g.float().numpy()
        w = np.asarray(w.astype(jnp.float32))
        assert g.shape == w.shape
        errs.append(max_abs(g, w))
        if dtype == "float32":
            assert errs[-1] <= 1e-5
        else:
            bound = np.maximum(np.abs(w) * BF16_ULP, 1e-5)
            assert np.all(np.abs(g - w) <= bound)
    record_property("max_abs_df1", errs[0])
    record_property("max_abs_dlevels", max(errs[1:]))
    assert np.abs(got[0].float().numpy()).max() > 0


def test_pyramid_refusals():
    f1 = torch.zeros((1, 2, 8, 16))
    c = torch.zeros((1, 2, 8))
    with pytest.raises(ValueError, match="levels"):
        fused_corr_pyramid_forward(f1, [f1] * 5, c, 4)
    with pytest.raises(ValueError, match="levels"):
        fused_corr_pyramid_forward(f1, [], c, 4)
    with pytest.raises(ValueError, match="CUDA"):  # never a CPU fallback
        fused_corr_pyramid_forward(f1, [f1], c, 4)
    m = torch.empty((1, 2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fused_corr_pyramid(m, [m, m], torch.empty((1, 2, 8), device="meta"),
                           4)


# -------------------------------------------------------- pool and registry


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("w", [16, 15, 7, 3, 2])
def test_pool_w2(dtype, w):
    x = np.random.default_rng(6).normal(size=(2, 3, w, 5)).astype(np.float32)
    got = tgeo.pool_w2(_t(x).to(getattr(torch, dtype)))
    want = jgeo.pool_w2(jnp.asarray(x, getattr(jnp, dtype)))
    assert tuple(got.shape) == want.shape == (2, 3, w // 2, 5)
    assert got.dtype == getattr(torch, dtype)
    assert max_abs(got.float().numpy(), np.asarray(want, np.float32)) == 0.0


@pytest.mark.parametrize("storage", [None, "bfloat16"])
@pytest.mark.parametrize("w", [40, 15])
def test_corr_registry_matches_jax(storage, w, record_property):
    rng = np.random.default_rng(7)
    b, h, d = 2, 3, 16
    f1 = rng.normal(size=(b, h, w, d)).astype(np.float32)
    f2 = rng.normal(size=(b, h, w, d)).astype(np.float32)
    coords = np.stack(np.meshgrid(np.arange(w), np.arange(h)), -1)[None]
    coords = np.broadcast_to(coords, (b, h, w, 2)).astype(np.float32)
    coords = coords + rng.uniform(-12, 6, size=coords.shape).astype(
        np.float32)
    tdt = None if storage is None else getattr(torch, storage)
    jdt = None if storage is None else getattr(jnp, storage)
    tstate = init_corr("fused", _t(f1), _t(f2), num_levels=4, radius=4,
                       storage_dtype=tdt)
    jstate = j_init_corr("fused", jnp.asarray(f1), jnp.asarray(f2),
                         num_levels=4, radius=4, storage_dtype=jdt)
    assert tstate.impl == "fused" and tstate.fmap1.shape == f1.shape
    assert tstate.fmap1.dtype == (tdt or torch.float32)
    assert [tuple(v.shape) for v in tstate.levels] == [
        v.shape for v in jstate.levels] == [(b, h, w >> i, d)
                                            for i in range(4)]
    for got_l, want_l in zip(tstate.levels, jstate.levels):
        assert max_abs(got_l.float().numpy(),
                       np.asarray(want_l, np.float32)) == 0.0
    got = corr_lookup(tstate, _t(coords)).numpy()
    want = np.asarray(jax.jit(j_corr_lookup)(jstate, jnp.asarray(coords)))
    assert got.shape == want.shape == (b, h, w, 36)
    record_property("max_abs", max_abs(got, want))
    assert max_abs(got, want) <= 1e-5
    # the reg state's fmap1 is None
    assert init_corr("reg", _t(f1), _t(f2)).fmap1 is None


def test_aliases_and_refusals():
    for name in ("fused", "alt_cuda", "fused_cuda", "memoryless"):
        cfg = tconfig.RAFTStereoConfig(corr_implementation=name)
        assert cfg.corr_implementation == "fused"
        assert cfg == port_config(JConfig(corr_implementation=name))
        assert RAFTStereo(cfg).storage_dtype() == torch.float32
    assert RAFTStereo(tconfig.RAFTStereoConfig(
        corr_implementation="alt_cuda",
        mixed_precision=True)).storage_dtype() == torch.bfloat16
    with pytest.raises(ValueError, match="not ported"):
        tconfig.RAFTStereoConfig(corr_implementation="ring")
    # the JAX package's TPU tile width is not a port field
    with pytest.raises(ValueError, match="fused_block_w"):
        port_config(JConfig(corr_implementation="fused", fused_block_w=64))


# ------------------------------------------------------ model and the step


@pytest.fixture(scope="module")
def small():
    jcfg = JConfig(hidden_dims=SMALL, corr_implementation="alt_cuda")
    assert jcfg.corr_implementation == "fused"
    return jcfg, jax_variables(jcfg, seed=41, image_shape=(B, H, W, 3))


def _port_model(jcfg, variables):
    model = RAFTStereo(port_config(jcfg))
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


def _batch(seed):
    rng = np.random.default_rng(seed)
    left = rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32)
    right = np.clip(np.roll(left, -5, axis=2) + rng.normal(0, 4, left.shape),
                    0, 255).astype(np.float32)
    flow = -rng.uniform(0, 12, (B, H, W, 1)).astype(np.float32)
    valid = (rng.uniform(size=(B, H, W)) > 0.1).astype(np.float32)
    return dict(image1=left, image2=right, flow=flow, valid=valid)


def test_test_mode_forward_matches_jax(small, record_property):
    jcfg, v = small
    b = _batch(42)
    left, right = b["image1"][:1, :50, :101], b["image2"][:1, :50, :101]
    want = JPredictor(jcfg, v, valid_iters=3)(left, right)
    pred = StereoPredictor(port_config(jcfg), state_dict_from_jax(v),
                           valid_iters=3, device="cpu")
    got = pred(left, right)
    assert got.shape == want.shape == (1, 50, 101, 1)
    record_property("max_abs_px", max_abs(got, want))
    record_property("max_abs_flow_px", float(np.abs(want).max()))
    assert max_abs(got, want) <= 1e-3


@pytest.fixture(scope="module")
def jax_grads(small):
    jcfg, v = small
    model = create_model(jcfg)
    batch = _batch(43)

    def loss_fn(params):
        preds = model.apply({"params": params,
                             "batch_stats": v["batch_stats"]},
                            batch["image1"], batch["image2"], iters=ITERS)
        loss, _ = jloss.sequence_loss(preds, batch["flow"], batch["valid"])
        return loss, preds

    fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    (loss, preds), grads = fn(v["params"])
    nulls = [to_np(fn(perturbed(v["params"], 51 + i))[1])
             for i in range(NULL_RUNS)]
    return batch, float(loss), np.asarray(preds), to_np(grads), nulls


def test_train_forward_matches_jax(small, jax_grads, record_property):
    jcfg, v = small
    batch, _, want, _, _ = jax_grads
    with torch.no_grad():
        got = _port_model(jcfg, v)(_t(batch["image1"]), _t(batch["image2"]),
                                   iters=ITERS, test_mode=False).numpy()
    assert got.shape == want.shape == (ITERS, B, H, W, 1)
    record_property("max_abs_px", max_abs(got, want))
    assert max_abs(got, want) <= 1e-3


def test_step_gradients_match_jax(small, jax_grads, record_property):
    jcfg, v = small
    batch, want_loss, _, want, null_grads = jax_grads
    model = _port_model(jcfg, v)
    before = (fused_corr.launches, fused_corr.bwd_launches,
              windowed_sample.launches)
    loss, _, grads = loss_and_grads(model, batch, ITERS)
    assert (fused_corr.launches, fused_corr.bwd_launches,
            windowed_sample.launches) == before  # CPU: the plain versions
    named = {n: g.numpy() for (n, _), g in zip(model.named_parameters(),
                                               grads)}
    want_sd = state_dict_from_jax({"params": want})
    norm = float(np.linalg.norm(flat(want_sd, named)))
    roundoff = {k for k in named
                if np.linalg.norm(want_sd[k].numpy()) < ROUNDOFF_REL * norm}
    ok, readings = null_gate(named, want, null_grads, 1e-4, roundoff)
    record_property("loss_rel_dev", abs(float(loss) - want_loss) / want_loss)
    for key, value in readings.items():
        record_property(key, value)
    assert abs(float(loss) - want_loss) <= 1e-6 * want_loss
    assert ok, readings
    # gradients reach the feature encoder through the fused lookup
    fnet = [g for (n, _), g in zip(model.named_parameters(), grads)
            if n.startswith("fnet.")]
    assert fnet and all(float(g.abs().max()) > 0 for g in fnet)


def test_cli_selects_alt_cuda_and_ignores_fused_block_w():
    from raft_stereo_tpu_torch import cli
    args = cli.build_demo_parser().parse_args(
        ["--restore_ckpt", "x.pth", "-l", "a", "-r", "b",
         "--corr_implementation", "alt_cuda", "--fused_block_w", "64"])
    assert cli.model_config(args) == tconfig.RAFTStereoConfig(
        corr_implementation="fused")
