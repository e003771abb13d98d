"""The ``alt`` and ``alt_pallas`` correlation of the PyTorch port held to the
JAX package's on the CPU.

Inputs are made with numpy from a seed and fed to both frameworks. The
plain versions (the CPU side of the ``alt_corr`` CUDA kernels) are held to
``alt_windowed_corr_pallas`` run under ``jax.jit`` in interpret mode, as
tests/test_pallas_corr.py runs it (its pure-JAX branch at ``W2 <= 2r+2``),
and to its hand-written backward by ``jax.vjp``. Each test records its
measured deviation as a junit property. Bounds, with what these inputs
measured when the bound was set:

* plain forward: 1e-6 abs, fp32 and bf16 features (taps O(1); the slab's
  dot over D is summed in another order; measured <= 4.8e-7);
* plain backward: ``df1``/``df2`` 1e-6 abs in fp32 (measured <= 1.2e-7);
  in bf16 within one bf16 ulp of the JAX value or 1e-6 abs, whichever is
  larger (both round one fp32 sum once; measured bitwise equal); the
  center's cotangent is None (the port) and 0 (JAX);
* the plain version against ``fused_corr``'s (one function): 1e-6 abs
  (measured <= 7.2e-7);
* the pyramid (``alt_corr_pyramid``, 1 to 4 levels in one forward launch
  on the card) against the JAX kernel per level at ``center / 2**i``, at
  radii 0, 4 and 8 on pyramids whose last level has W2 <= 2r+2: the
  forward 1e-6 abs per level and concatenated, and bitwise equal to the
  one-level plain lookups; its autograd gradients against ``jax.vjp`` of
  the concatenated JAX levels 1e-5 abs in fp32; in bf16 one bf16 ulp of
  the JAX value or 1e-5 abs (``fmap1``'s gradient sums the levels' bf16
  values from the last level to the first, as JAX does);
* the registry's ``alt`` and ``alt_pallas`` lookups against JAX
  ``_lookup_alt`` and ``_lookup_alt_pallas``: 1e-6 abs, fp32 and bf16
  storage (measured <= 4.8e-7);
* test-mode forward against the JAX model on the same weights: 1e-3 px on
  ``flow_up`` (measured 3.4e-5 px of a 6.1 px field, ``alt`` and
  ``alt_pallas``);
* train-mode forward 1e-3 px (measured 2.3e-5), and one step's gradients
  under the null-floor rule of tests/test_torch_training.py (8 JAX-vs-JAX
  null runs, weights x (1 + 1e-6 N(0, 1)); measured: all gradients 3.9e-4
  against null runs of 4.6e-4 to 6.7e-4, leaf score 1.01 against null
  scores up to 3.98).

The JAX model's ``alt_pallas`` state is built by ``_build_alt`` and looked
up by ``_lookup_alt`` (its ``CorrState.impl`` is ``"alt"``), so the model
tests hold the port's kernel path to JAX's plain ``alt`` lookup: the same
function, scaled after the window instead of before it.
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
from raft_stereo_tpu.ops.corr import _lookup_alt as j_lookup_alt
from raft_stereo_tpu.ops.corr import _lookup_alt_pallas as j_lookup_alt_pallas
from raft_stereo_tpu.ops.corr import init_corr as j_init_corr
from raft_stereo_tpu.ops.pallas.corr_kernels import alt_windowed_corr_pallas
from raft_stereo_tpu.training import loss as jloss

from raft_stereo_tpu_torch import cli
from raft_stereo_tpu_torch import config as tconfig
from raft_stereo_tpu_torch.inference import StereoPredictor
from raft_stereo_tpu_torch.models import RAFTStereo
from raft_stereo_tpu_torch.ops.corr import corr_lookup, init_corr
from raft_stereo_tpu_torch.ops.kernels.alt_corr import (
    alt_corr, alt_corr_backward_plain, alt_corr_plain, alt_corr_pyramid,
    alt_corr_pyramid_forward, alt_corr_pyramid_plain)
from raft_stereo_tpu_torch.ops.kernels.fused_corr import (
    fused_corr, fused_corr_backward_plain, fused_corr_plain)
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
TOL = 1e-6


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# -------------------------------------------------------------- the kernel

# (name, radius, (B, H, W1, W2, D)): radii 1 and 4 on the JAX kernel; the
# odd pyramid 15 -> 7 -> 3 -> 1, whose narrow levels (W2 <= 2r+2) take the
# JAX package's pure-JAX branch
CASES = [("r1", 1, (2, 4, 16, 16, 32)),
         ("r4", 4, (2, 4, 16, 16, 32)),
         ("w15", 4, (1, 3, 15, 15, 32)),
         ("w7", 4, (1, 3, 15, 7, 32)),
         ("w3", 4, (1, 3, 15, 3, 32)),
         ("w1", 4, (1, 3, 15, 1, 32))]


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
def _jax_alt(radius):
    return jax.jit(lambda a, b, c: alt_windowed_corr_pallas(a, b, c, radius))


@functools.lru_cache(maxsize=None)
def _jax_alt_vjp(radius):
    def vjp(a, b, c, ct):
        _, f = jax.vjp(lambda x, y: alt_windowed_corr_pallas(
            x, y, c, radius), a, b)
        return f(ct)
    return jax.jit(vjp)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,radius,shape", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_forward_matches_jax(name, radius, shape, dtype,
                                   record_property):
    f1, f2, center = _inputs(shape, radius, seed=len(name) + radius)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    got = alt_corr_plain(_t(f1).to(tdt), _t(f2).to(tdt), _t(center),
                         radius).numpy()
    want = np.asarray(_jax_alt(radius)(
        jnp.asarray(f1, jdt), jnp.asarray(f2, jdt), jnp.asarray(center)))
    k = 2 * radius + 1
    assert got.dtype == np.float32 and got.shape == shape[:3] + (k,)
    record_property("max_abs", max_abs(got, want))
    assert max_abs(got, want) <= TOL
    assert np.all(got.reshape(-1, k)[6:8] == 0.0)  # far out: exact zeros


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,radius,shape", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_backward_matches_jax(name, radius, shape, dtype,
                                    record_property):
    f1, f2, center = _inputs(shape, radius, seed=len(name) + radius + 1)
    k = 2 * radius + 1
    ct = np.random.default_rng(radius).normal(
        size=shape[:3] + (k,)).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    df1, df2 = alt_corr_backward_plain(_t(f1).to(tdt), _t(f2).to(tdt),
                                       _t(center), _t(ct), radius)
    assert df1.dtype == df2.dtype == tdt
    assert tuple(df1.shape) == f1.shape and tuple(df2.shape) == f2.shape
    w1, w2 = _jax_alt_vjp(radius)(jnp.asarray(f1, jdt), jnp.asarray(f2, jdt),
                                  jnp.asarray(center), jnp.asarray(ct))
    errs = []
    for got, want in ((df1, w1), (df2, w2)):
        got = got.float().numpy()
        want = np.asarray(want.astype(jnp.float32))
        errs.append(max_abs(got, want))
        if dtype == "float32":
            assert errs[-1] <= TOL
        else:
            bound = np.maximum(np.abs(want) * BF16_ULP, TOL)
            assert np.all(np.abs(got - want) <= bound)
    record_property("max_abs_df1", errs[0])
    record_property("max_abs_df2", errs[1])
    assert np.abs(df1.float().numpy()).max() > 0
    assert np.abs(df2.float().numpy()).max() > 0


def test_jax_center_cotangent_is_zero():
    f1, f2, center = _inputs((1, 2, 16, 16, 8), 4, seed=2)
    _, vjp = jax.vjp(lambda c: alt_windowed_corr_pallas(
        jnp.asarray(f1), jnp.asarray(f2), c, 4), jnp.asarray(center))
    (dc,) = vjp(jnp.ones((1, 2, 16, 9), jnp.float32))
    assert not np.any(np.asarray(dc))


@pytest.mark.parametrize("w2", [16, 3])
def test_plain_matches_fused_plain(w2, record_property):
    # B3 and B2 compute one function: the slab's window and the per-tap dot
    f1, f2, center = _inputs((2, 3, 16, w2, 24), 4, seed=w2)
    tf1, tf2, tc = _t(f1), _t(f2), _t(center)
    got = alt_corr_plain(tf1, tf2, tc, 4)
    want = fused_corr_plain(tf1, tf2, tc, 4)
    record_property("max_abs", max_abs(got, want))
    assert max_abs(got, want) <= TOL
    ct = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 3, 16, 9)).astype(np.float32))
    for a, b in zip(alt_corr_backward_plain(tf1, tf2, tc, ct, 4),
                    fused_corr_backward_plain(tf1, tf2, tc, ct, 4)):
        assert max_abs(a, b) <= TOL


def test_wrapper_takes_plain_path_on_cpu_and_gives_center_no_grad():
    f1, f2, center = _inputs((1, 2, 12, 12, 16), 4, seed=3)
    tf1, tf2 = _t(f1).requires_grad_(), _t(f2).requires_grad_()
    tc = _t(center).requires_grad_()
    before = (alt_corr.launches, alt_corr.bwd_launches)
    out = alt_corr(tf1, tf2, tc, 4)
    ct = _t(np.random.default_rng(4).normal(size=out.shape).astype(
        np.float32))
    df1, df2, dc = torch.autograd.grad(out, (tf1, tf2, tc), ct,
                                       allow_unused=True)
    assert (alt_corr.launches, alt_corr.bwd_launches) == before
    assert torch.equal(out, alt_corr_plain(_t(f1), _t(f2), _t(center), 4))
    want = alt_corr_backward_plain(_t(f1), _t(f2), _t(center), ct, 4)
    assert torch.equal(df1, want[0]) and torch.equal(df2, want[1])
    assert dc is None


def test_nan_center_poisons_its_row_and_taps():
    # a NaN center takes base -r: NaN outputs; in the backward NaN in its
    # df1 row and in the df2 rows its window covers, the rest untouched
    f1, f2, center = _inputs((1, 1, 4, 16, 8), 4, seed=5)
    center[0, 0, 1] = np.nan
    out = alt_corr_plain(_t(f1), _t(f2), _t(center), 4).numpy()
    assert np.all(np.isnan(out[0, 0, 1]))
    assert np.all(np.isfinite(np.delete(out[0, 0], 1, axis=0)))
    ct = np.ones((1, 1, 4, 9), np.float32)
    df1, df2 = alt_corr_backward_plain(_t(f1), _t(f2), _t(center), _t(ct), 4)
    assert np.all(np.isnan(df1[0, 0, 1].numpy()))
    rows = np.isnan(df2[0, 0].numpy()).all(axis=-1)
    np.testing.assert_array_equal(rows, np.arange(16) < 4 + 2)


def test_wrapper_never_falls_back_off_cpu():
    f = torch.empty((1, 2, 15, 8), device="meta")
    c = torch.empty((1, 2, 15), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        alt_corr(f, f, c, 4)


# ------------------------------------------------------------ the pyramid

# (radius, (B, H, W1, D)): level widths W1 >> i, so the last level (W1 / 8)
# has W2 <= 2r+2 and takes the JAX package's pure-JAX branch, the wider
# ones the Pallas kernel in interpret mode
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
def _jax_alt_pyramid(radius):
    def pyr(f1, levels, c):
        return jnp.concatenate([alt_windowed_corr_pallas(
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
    before = (alt_corr.launches, alt_corr.bwd_launches)
    got = alt_corr_pyramid(_t(f1).to(tdt), t_levels, _t(center),
                           radius).numpy()
    assert (alt_corr.launches, alt_corr.bwd_launches) == before
    want = np.asarray(_jax_alt_pyramid(radius)[0](
        jnp.asarray(f1, jdt), [jnp.asarray(x, jdt) for x in levels],
        jnp.asarray(center)))
    assert got.dtype == np.float32 and got.shape == shape[:3] + (4 * k,)
    for i in range(4):  # level by level: the one-level entry point too
        one = alt_corr_plain(_t(f1).to(tdt), t_levels[i],
                             _t(center) / (2 ** i), radius).numpy()
        assert np.array_equal(got[..., i * k:(i + 1) * k], one)
        assert max_abs(one, want[..., i * k:(i + 1) * k]) <= TOL
    record_property("max_abs", max_abs(got, want))
    assert max_abs(got, want) <= TOL
    assert np.all(got.reshape(-1, 4 * k)[4:6] == 0.0)  # far out: zeros
    assert np.array_equal(got, alt_corr_pyramid_plain(
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
    out = alt_corr_pyramid(tf1, t_levels, _t(center), radius)
    got = torch.autograd.grad(out, [tf1, *t_levels], _t(ct))
    assert all(g.dtype == tdt for g in got)
    w1, wl = _jax_alt_pyramid(radius)[1](
        jnp.asarray(f1, jdt), [jnp.asarray(x, jdt) for x in levels],
        jnp.asarray(center), jnp.asarray(ct))
    errs = []
    for g, w in zip(got, [w1, *wl]):
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
        alt_corr_pyramid_forward(f1, [f1] * 5, c, 4)
    with pytest.raises(ValueError, match="levels"):
        alt_corr_pyramid_forward(f1, [], c, 4)
    with pytest.raises(ValueError, match="CUDA"):  # never a CPU fallback
        alt_corr_pyramid_forward(f1, [f1], c, 4)
    m = torch.empty((1, 2, 8, 16), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        alt_corr_pyramid(m, [m, m], torch.empty((1, 2, 8), device="meta"),
                         4)


# ---------------------------------------------------------------- registry


@pytest.mark.parametrize("impl", ["alt", "alt_pallas"])
@pytest.mark.parametrize("storage", [None, "bfloat16"])
@pytest.mark.parametrize("w", [40, 15])
def test_corr_registry_matches_jax(impl, storage, w, record_property):
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
    tstate = init_corr(impl, _t(f1), _t(f2), num_levels=4, radius=4,
                       storage_dtype=tdt)
    jstate = j_init_corr(impl, jnp.asarray(f1), jnp.asarray(f2),
                         num_levels=4, radius=4, storage_dtype=jdt)
    assert tstate.impl == impl and tstate.fmap1.dtype == (tdt
                                                          or torch.float32)
    for got_l, want_l in zip((tstate.fmap1,) + tstate.levels,
                             (jstate.fmap1,) + jstate.levels):
        assert max_abs(got_l.float().numpy(),
                       np.asarray(want_l, np.float32)) == 0.0
    j_lookup = {"alt": j_lookup_alt, "alt_pallas": j_lookup_alt_pallas}[impl]
    got = corr_lookup(tstate, _t(coords)).numpy()
    want = np.asarray(jax.jit(j_lookup)(jstate, jnp.asarray(coords[..., 0])))
    assert got.shape == want.shape == (b, h, w, 36)
    record_property("max_abs", max_abs(got, want))
    assert max_abs(got, want) <= TOL


def test_config_storage_and_cli():
    for name in ("alt", "alt_pallas"):
        cfg = tconfig.RAFTStereoConfig(corr_implementation=name)
        assert cfg.corr_implementation == name
        assert cfg == port_config(JConfig(corr_implementation=name))
    # fp32 storage for alt, the compute dtype for the kernel, as JAX
    mixed = dict(mixed_precision=True)
    assert RAFTStereo(tconfig.RAFTStereoConfig(
        corr_implementation="alt", **mixed)).storage_dtype() is None
    assert RAFTStereo(tconfig.RAFTStereoConfig(
        corr_implementation="alt_pallas", **mixed)).storage_dtype() \
        == torch.bfloat16
    args = cli.build_demo_parser().parse_args(
        ["--restore_ckpt", "x.pth", "-l", "a", "-r", "b",
         "--corr_implementation", "alt_pallas"])
    assert cli.model_config(args) == tconfig.RAFTStereoConfig(
        corr_implementation="alt_pallas")
    with pytest.raises(ValueError, match="not ported"):
        tconfig.RAFTStereoConfig(corr_implementation="ring")


# ------------------------------------------------------ model and the step


def _batch(seed):
    rng = np.random.default_rng(seed)
    left = rng.uniform(0, 255, (B, H, W, 3)).astype(np.float32)
    right = np.clip(np.roll(left, -5, axis=2) + rng.normal(0, 4, left.shape),
                    0, 255).astype(np.float32)
    flow = -rng.uniform(0, 12, (B, H, W, 1)).astype(np.float32)
    valid = (rng.uniform(size=(B, H, W)) > 0.1).astype(np.float32)
    return dict(image1=left, image2=right, flow=flow, valid=valid)


@pytest.fixture(scope="module")
def small():
    jcfg = JConfig(hidden_dims=SMALL, corr_implementation="alt_pallas")
    return jcfg, jax_variables(jcfg, seed=61, image_shape=(B, H, W, 3))


def _port_model(jcfg, variables):
    model = RAFTStereo(port_config(jcfg))
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model


@pytest.mark.parametrize("impl", ["alt", "alt_pallas"])
def test_test_mode_forward_matches_jax(small, impl, record_property):
    _, v = small
    jcfg = JConfig(hidden_dims=SMALL, corr_implementation=impl)
    b = _batch(62)
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
    batch = _batch(63)

    def loss_fn(params):
        preds = model.apply({"params": params,
                             "batch_stats": v["batch_stats"]},
                            batch["image1"], batch["image2"], iters=ITERS)
        loss, _ = jloss.sequence_loss(preds, batch["flow"], batch["valid"])
        return loss, preds

    fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    to_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    (loss, preds), grads = fn(v["params"])
    nulls = [to_np(fn(perturbed(v["params"], 71 + i))[1])
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
    before = (alt_corr.launches, alt_corr.bwd_launches,
              fused_corr.launches, windowed_sample.launches)
    loss, _, grads = loss_and_grads(model, batch, ITERS)
    assert (alt_corr.launches, alt_corr.bwd_launches, fused_corr.launches,
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
    # gradients reach the feature encoder through the slab lookup
    fnet = [g for (n, _), g in zip(model.named_parameters(), grads)
            if n.startswith("fnet.")]
    assert fnet and all(float(g.abs().max()) > 0 for g in fnet)
