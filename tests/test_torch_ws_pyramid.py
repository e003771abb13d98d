"""The pyramid lookup ``windowed_sample_pyramid`` on the CPU: its plain
versions against JAX's ``reg_pallas`` lookup and against the per-level
chain it replaces in the ``reg_pallas`` registry entry.

JAX side: ``raft_stereo_tpu/ops/corr.py::_lookup_reg_pallas`` (one
``windowed_sample_pallas`` call a level, its Pallas kernels in interpret
mode on the CPU, as tests/test_pallas_corr.py runs them), forward and
``jax.vjp`` under ``jax.jit`` for every level's ``dvol`` and the center's
gradient. Inputs are made with numpy from a seed; centers include
integers, borders, +-1e9 and NaN.

Bounds against JAX: the forward 1e-6 abs (XLA contracts the blend into one
FMA on the CPU, the port rounds each operation: measured <= 2.4e-7); a
``dvol`` bitwise equal where JAX runs its Pallas backward (W2 > 2r+2; both
round one fp32 value once), else 1e-6 abs in fp32 (JAX differentiates its
pure sampler, blends contracted: measured <= 2.4e-7) and one bf16 ulp in
bf16 (measured bitwise); ``dcoords`` 1e-5 abs (a 2r+1-term sum per level
taken in another order, then summed over levels: measured <= 2.9e-6).
Against the per-level chain (``windowed_sample`` a level, the center
divided by ``2**i``, concatenated): forward and ``dvol`` bitwise equal,
``dcoords`` 1e-6 abs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from raft_stereo_tpu.ops.corr import CorrState as JCorrState
from raft_stereo_tpu.ops.corr import _lookup_reg_pallas

from raft_stereo_tpu_torch.ops.corr import corr_lookup, init_corr
from raft_stereo_tpu_torch.ops.kernels.windowed_sample import (
    MAX_LEVELS, windowed_sample, windowed_sample_pyramid,
    windowed_sample_pyramid_backward_plain, windowed_sample_pyramid_plain)
from raft_stereo_tpu_torch.ops.sampler import windowed_linear_sample

from torch_parity import max_abs

# level-0 widths by radius: each pyramid has a level the JAX kernel takes
# (W2 > 2r+2) and one it hands to its pure sampler (W2 <= 2r+2)
WIDTHS = {0: 15, 4: 24, 8: 24}
B, H, W1 = 1, 3, 15


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _inputs(n, radius, seed):
    rng = np.random.default_rng(seed)
    w0 = WIDTHS[radius]
    widths = [w0 >> i for i in range(n)]
    vols = [rng.normal(size=(B, H, W1, w)).astype(np.float32)
            for w in widths]
    center = rng.uniform(-2 * radius - 2, w0 + 2 * radius + 2,
                         size=(B, H, W1)).astype(np.float32)
    edge = [0.0, -1.0, float(w0 - 1), float(w0), 1e9, -1e9, np.nan, 0.999999,
            float(w0 // 2), -radius - 0.5]
    center.reshape(-1)[:len(edge)] = edge
    ct = rng.normal(size=(B, H, W1, n * (2 * radius + 1))).astype(np.float32)
    return vols, center, ct


def _jax_lookup(vols, center, ct, radius, dtype):
    """JAX's reg_pallas lookup, its value and its VJP under jax.jit."""
    levels = tuple(jnp.asarray(v, getattr(jnp, dtype)) for v in vols)

    def lookup(levels, coords_x):
        state = JCorrState(levels=levels, fmap1=None, impl="reg_pallas",
                           radius=radius, num_levels=len(levels))
        return _lookup_reg_pallas(state, coords_x)

    out, vjp = jax.vjp(jax.jit(lookup), levels, jnp.asarray(center))
    dvols, dcoords = jax.jit(vjp)(jnp.asarray(ct))
    return (np.asarray(out), [np.asarray(d.astype(jnp.float32))
                              for d in dvols], np.asarray(dcoords))


def _same(a, b):
    """Bitwise equal, NaNs in the same places counting as equal."""
    nan = np.isnan(b)
    return np.array_equal(np.isnan(a), nan) and np.array_equal(a[~nan],
                                                               b[~nan])


def _close(a, b, tol):
    nan = np.isnan(b)
    return np.array_equal(np.isnan(a), nan) and (
        not (~nan).any() or max_abs(a[~nan], b[~nan]) <= tol)


@pytest.mark.parametrize("dtype,n,radius",
                         [(d, n, 4) for d in ("float32", "bfloat16")
                          for n in range(1, MAX_LEVELS + 1)]
                         + [(d, 4, r) for d in ("float32", "bfloat16")
                            for r in (0, 8)])
def test_pyramid_plain_matches_jax_reg_pallas(dtype, n, radius,
                                              record_property):
    vols, center, ct = _inputs(n, radius, seed=10 * n + radius)
    tdt = getattr(torch, dtype)
    levels = [_t(v).to(tdt) for v in vols]
    got = windowed_sample_pyramid_plain(levels, _t(center), radius).numpy()
    dvols, dcoords = windowed_sample_pyramid_backward_plain(
        levels, _t(center), _t(ct), radius)
    want, want_dvols, want_dc = _jax_lookup(vols, center, ct, radius, dtype)
    k = 2 * radius + 1
    assert got.shape == want.shape == (B, H, W1, n * k)
    assert _close(got, want, 1e-6)
    # the NaN center poisons its taps; far-out centers give exact zeros
    assert np.isnan(got.reshape(-1, n * k)[6]).all()
    assert np.all(got.reshape(-1, n * k)[4:6] == 0.0)
    record_property("max_abs_fwd", max_abs(np.nan_to_num(got),
                                           np.nan_to_num(want)))
    for v, dv, wdv in zip(levels, dvols, want_dvols):
        assert dv.dtype == tdt and dv.shape == v.shape
        dv = dv.float().numpy()
        if v.shape[-1] > 2 * radius + 2:  # JAX's Pallas backward
            assert _same(dv, wdv)
        elif dtype == "float32":
            assert _close(dv, wdv, 1e-6)
        else:  # one bf16 ulp (2**-7 relative) of each entry
            keep = ~np.isnan(wdv)
            assert np.array_equal(np.isnan(dv), ~keep)
            assert np.all(np.abs(dv - wdv)[keep]
                          <= np.abs(wdv[keep]) * 2.0 ** -7)
        rows = dv.reshape(-1, v.shape[-1])
        assert np.all(rows[4:6] == 0.0)  # far-out centers write nothing
    assert dcoords.dtype == torch.float32
    assert _close(dcoords.numpy(), want_dc, 1e-5)
    record_property("max_abs_dcoords", max_abs(np.nan_to_num(
        dcoords.numpy()), np.nan_to_num(want_dc)))


def _chain(levels, center, radius):
    """The lookup ``reg_pallas`` ran before the pyramid: one
    ``windowed_sample`` a level around ``center / 2**i``, concatenated."""
    return torch.cat([windowed_sample(v, center / (2 ** i), radius)
                      for i, v in enumerate(levels)], dim=-1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_pyramid_matches_per_level_chain(dtype, n):
    vols, center, ct = _inputs(n, 4, seed=30 + n)

    def run(lookup):
        levels = [_t(v).to(dtype).requires_grad_() for v in vols]
        c = _t(center).requires_grad_()
        out = lookup(levels, c, 4)
        grads = torch.autograd.grad(out, [*levels, c], _t(ct))
        return out.detach(), grads[:-1], grads[-1]

    out, dvols, dc = run(windowed_sample_pyramid)
    want, want_dvols, want_dc = run(_chain)
    assert _same(out.numpy(), want.numpy())
    for dv, wdv in zip(dvols, want_dvols):
        assert dv.dtype == dtype
        assert _same(dv.float().numpy(), wdv.float().numpy())
    assert _close(dc.numpy(), want_dc.numpy(), 1e-6)
    # the plain pyramid is the concatenation of the levels' plain lookups
    levels = [_t(v).to(dtype) for v in vols]
    assert _same(windowed_sample_pyramid_plain(levels, _t(center), 4).numpy(),
                 torch.cat([windowed_linear_sample(v, _t(center) / 2 ** i, 4)
                            for i, v in enumerate(levels)], -1).numpy())


@pytest.mark.parametrize("storage", [None, torch.bfloat16])
def test_reg_pallas_lookup_is_reg_on_cpu(storage):
    # the registry's reg_pallas entry takes the pyramid; on CPU tensors its
    # plain version, with the reg lookup's numbers, forward and backward,
    # and no kernel launch
    rng = np.random.default_rng(5)
    f1 = _t(rng.normal(size=(2, 3, 40, 16)).astype(np.float32))
    f2 = _t(rng.normal(size=(2, 3, 40, 16)).astype(np.float32))
    coords = torch.stack(torch.meshgrid(torch.arange(40.), torch.arange(3.),
                                        indexing="xy"), -1)[None]
    coords = (coords.expand(2, 3, 40, 2)
              + _t(rng.uniform(-12, 6, size=(2, 3, 40, 2)).astype(
                  np.float32)))
    ct = _t(rng.normal(size=(2, 3, 40, 36)).astype(np.float32))
    results = []
    before = (windowed_sample.launches, windowed_sample.bwd_launches)
    for impl in ("reg_pallas", "reg"):
        state = init_corr(impl, f1, f2, num_levels=4, radius=4,
                          storage_dtype=storage)
        levels = [v.detach().requires_grad_() for v in state.levels]
        state = type(state)(levels=tuple(levels), impl=impl, radius=4)
        out = corr_lookup(state, coords)
        results.append((out, torch.autograd.grad(out, levels, ct)))
    assert (windowed_sample.launches, windowed_sample.bwd_launches) == before
    (out, dvols), (want, want_dvols) = results
    assert out.shape == (2, 3, 40, 36) and torch.equal(out, want)
    assert all(torch.equal(a, b) for a, b in zip(dvols, want_dvols))


def test_pyramid_of_more_levels_than_a_launch_is_chunked():
    # a 6-level state looks up levels 0-3 in one call and 4-5 in another,
    # the second around coords_x / 16: the reg lookup's numbers
    rng = np.random.default_rng(6)
    f1 = _t(rng.normal(size=(1, 2, 64, 8)).astype(np.float32))
    f2 = _t(rng.normal(size=(1, 2, 64, 8)).astype(np.float32))
    coords = _t(rng.uniform(-4, 70, size=(1, 2, 64, 2)).astype(np.float32))
    got = corr_lookup(init_corr("reg_pallas", f1, f2, num_levels=6,
                                radius=2), coords)
    want = corr_lookup(init_corr("reg", f1, f2, num_levels=6, radius=2),
                       coords)
    assert got.shape == (1, 2, 64, 30) and torch.equal(got, want)


def test_pyramid_refuses_bad_levels():
    vols, center, _ = _inputs(4, 4, seed=7)
    levels = [_t(v) for v in vols]
    c = _t(center)
    with pytest.raises(ValueError, match="5 levels"):
        windowed_sample_pyramid(levels + levels[:1], c, 4)
    with pytest.raises(ValueError, match="0 levels"):
        windowed_sample_pyramid([], c, 4)
    with pytest.raises(TypeError, match="not all float32"):
        windowed_sample_pyramid([levels[0], levels[1].bfloat16()], c, 4)
    with pytest.raises(ValueError, match="want volumes"):
        windowed_sample_pyramid([levels[0], levels[1][:, :2].contiguous()],
                                c, 4)
    with pytest.raises(ValueError, match="want volumes"):
        windowed_sample_pyramid(levels, c[..., :7].contiguous(), 4)
    with pytest.raises(TypeError, match="center dtype"):
        windowed_sample_pyramid(levels, c.double(), 4)
    with pytest.raises(ValueError, match="radius 9"):
        windowed_sample_pyramid(levels, c, 9)
