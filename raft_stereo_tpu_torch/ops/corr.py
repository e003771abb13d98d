"""Pluggable 1-D correlation layer (the port of ``raft_stereo_tpu.ops.corr``).

``init_corr`` builds the correlation state once per pair and
``corr_lookup`` samples a ``2r+1``-tap window per pyramid level around the
current disparity coordinates. Five implementations are registered:

* ``reg`` — the all-pairs volume ``(B, H, W1, W2)``, pooled into a pyramid
  along W2; the lookup is plain PyTorch (``ops/sampler.py``).
* ``reg_pallas`` (``reg_cuda`` on the reference's command line) — the same
  pyramid, looked up by the hand-written ``windowed_sample`` CUDA kernels:
  one forward launch for the four levels, and one backward launch.
* ``alt`` — no persistent volume: the state is ``fmap1`` and a pyramid of
  ``fmap2`` pooled along W; each lookup recomputes every level's volume
  with ``torch.matmul`` and samples its window (plain PyTorch).
* ``alt_pallas`` — the same state; the hand-written ``alt_corr`` CUDA
  kernels take the window of each level's correlation slab, computing only
  the slab entries it reads: one forward launch for the four levels, and a
  backward launch per level.
* ``fused`` (``alt_cuda``, ``fused_cuda``, ``memoryless``) — the same
  state; the hand-written ``fused_corr`` CUDA kernels compute the taps
  from the features: one forward launch for the four levels, and a
  backward launch per level.

On CPU tensors the kernels' wrappers take their plain versions; on CUDA
tensors they launch the kernels or raise.

:func:`corr_lookup_replay` gives a lookup's value from a saved copy while
its backward still writes the volume's (or the features') gradient,
without running the lookup's forward again: the refinement's save
policies use it (``ops/scan_grad.py``).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from raft_stereo_tpu_torch.ops.geometry import pool_last_axis2, pool_w2
from raft_stereo_tpu_torch.ops.kernels.alt_corr import (_AltCorrPyramid,
                                                        alt_corr_pyramid)
from raft_stereo_tpu_torch.ops.kernels.fused_corr import (MAX_LEVELS,
                                                          _FusedCorrPyramid,
                                                          fused_corr_pyramid)
from raft_stereo_tpu_torch.ops.kernels.windowed_sample import (
    windowed_sample_pyramid, windowed_sample_pyramid_vjp)
from raft_stereo_tpu_torch.ops.sampler import windowed_linear_sample


@dataclasses.dataclass(frozen=True)
class CorrState:
    """Correlation state carried through the refinement loop."""

    # per-level volume (B, H, W1, W2_i), or fmap2 pooled (B, H, W2_i, D)
    levels: Tuple[torch.Tensor, ...]
    impl: str
    radius: int
    num_levels: int = 4
    # left features, for the feature-pyramid implementations (not "reg")
    fmap1: Optional[torch.Tensor] = None


def all_pairs_correlation(fmap1: torch.Tensor,
                          fmap2: torch.Tensor) -> torch.Tensor:
    """All-pairs 1-D correlation ``(B, H, W1, W2)`` of NHWC feature maps,
    accumulated in fp32 and scaled by ``1/sqrt(D)``."""
    d = fmap1.shape[-1]
    corr = torch.matmul(fmap1.float(), fmap2.float().transpose(-1, -2))
    return corr / math.sqrt(d)


def _build_reg(fmap1, fmap2, num_levels, radius,
               storage_dtype: Optional[torch.dtype] = None,
               impl: str = "reg") -> CorrState:
    volume = all_pairs_correlation(fmap1, fmap2)
    if storage_dtype is not None:
        # reduced-precision storage; taps are blended in fp32 after the read
        volume = volume.to(storage_dtype)
    levels = [volume.contiguous()]
    for _ in range(num_levels - 1):
        levels.append(pool_last_axis2(levels[-1]).contiguous())
    return CorrState(levels=tuple(levels), impl=impl, radius=radius,
                     num_levels=num_levels)


def _build_features(fmap1, fmap2, num_levels, radius,
                    storage_dtype: Optional[torch.dtype] = None,
                    impl: str = "fused") -> CorrState:
    """Feature-pyramid state (``alt``, ``alt_pallas``, ``fused``): ``fmap1``
    and ``fmap2`` in the storage dtype, and ``fmap2`` pooled along W into
    the pyramid (O(W) per row, no volume)."""
    dt = storage_dtype or torch.float32
    levels = [fmap2.to(dt).contiguous()]
    for _ in range(num_levels - 1):
        levels.append(pool_w2(levels[-1]).contiguous())
    return CorrState(levels=tuple(levels), impl=impl, radius=radius,
                     num_levels=num_levels,
                     fmap1=fmap1.to(dt).contiguous())


def _lookup_alt(state: CorrState, coords_x: torch.Tensor) -> torch.Tensor:
    """Per level, the whole volume ``fmap1 . fmap2_i^T`` (fp32 accumulation)
    sampled at ``coords_x / 2**i``, scaled by ``1/sqrt(D)`` after the
    window (the JAX package's ``_lookup_alt``)."""
    scale = 1.0 / math.sqrt(state.fmap1.shape[-1])
    out = [windowed_linear_sample(
        torch.matmul(state.fmap1.float(), fmap2.float().transpose(-1, -2)),
        coords_x / (2 ** i), state.radius) * scale
        for i, fmap2 in enumerate(state.levels)]
    return torch.cat(out, dim=-1)


def _by_chunks(state: CorrState, coords_x: torch.Tensor,
               lookup_levels: Callable) -> torch.Tensor:
    """``lookup_levels(levels, center)`` (one launch) per MAX_LEVELS levels
    of ``state``, its first level ``i`` at ``center = coords_x / 2**i``,
    concatenated in the ``reg`` channel order."""
    out = [lookup_levels(state.levels[i:i + MAX_LEVELS],
                         coords_x if i == 0 else coords_x / (2 ** i))
           for i in range(0, len(state.levels), MAX_LEVELS)]
    return out[0] if len(out) == 1 else torch.cat(out, dim=-1)


def _lookup_pyramid(corr_pyramid: Callable) -> Callable:
    def lookup(state: CorrState, coords_x: torch.Tensor) -> torch.Tensor:
        """One ``corr_pyramid`` call (one forward launch) per MAX_LEVELS
        levels of the feature pyramid."""
        return _by_chunks(state, coords_x, lambda levels, c: corr_pyramid(
            state.fmap1, levels, c, state.radius))
    return lookup


def _lookup_volume_pyramid(state: CorrState,
                           coords_x: torch.Tensor) -> torch.Tensor:
    """One ``windowed_sample_pyramid`` call (one forward launch) per
    MAX_LEVELS levels of the volume pyramid."""
    return _by_chunks(state, coords_x, lambda levels, c:
                      windowed_sample_pyramid(levels, c, state.radius))


def _lookup_with(sample: Callable) -> Callable:
    def lookup(state: CorrState, coords_x: torch.Tensor) -> torch.Tensor:
        """Per-level window sample at ``coords_x / 2**i``; channel order is
        [level0 taps -r..r, level1 taps, ...]."""
        out = [sample(volume, coords_x / (2 ** i), state.radius)
               for i, volume in enumerate(state.levels)]
        return torch.cat(out, dim=-1)
    return lookup


_BUILDERS: Dict[str, Callable] = {}
_LOOKUPS: Dict[str, Callable] = {}


def register_corr(name: str, builder: Callable, lookup: Callable) -> None:
    """Register a correlation implementation.

    ``builder(fmap1, fmap2, num_levels, radius, storage_dtype=None) ->
    CorrState`` and ``lookup(state, coords_x (B, H, W1)) -> (B, H, W1,
    num_levels*(2r+1))`` float32 features.
    """
    _BUILDERS[name] = builder
    _LOOKUPS[name] = lookup


register_corr("reg", _build_reg, _lookup_with(windowed_linear_sample))
register_corr("reg_pallas", functools.partial(_build_reg, impl="reg_pallas"),
              _lookup_volume_pyramid)
register_corr("alt", functools.partial(_build_features, impl="alt"),
              _lookup_alt)
register_corr("alt_pallas",
              functools.partial(_build_features, impl="alt_pallas"),
              _lookup_pyramid(alt_corr_pyramid))
register_corr("fused", _build_features, _lookup_pyramid(fused_corr_pyramid))


def init_corr(impl: str, fmap1: torch.Tensor, fmap2: torch.Tensor, *,
              num_levels: int = 4, radius: int = 4,
              storage_dtype: Optional[torch.dtype] = None) -> CorrState:
    """Build correlation state from NHWC feature maps ``(B, H, W, D)``.
    ``storage_dtype`` (e.g. ``torch.bfloat16``) selects the storage
    precision of the volume (``reg``) or the features (the others); None
    keeps fp32."""
    if impl not in _BUILDERS:
        raise ValueError(f"unknown corr implementation {impl!r}; "
                         f"registered: {sorted(_BUILDERS)}")
    return _BUILDERS[impl](fmap1, fmap2, num_levels, radius,
                           storage_dtype=storage_dtype)


def corr_lookup(state: CorrState, coords: torch.Tensor) -> torch.Tensor:
    """Correlation features at ``coords (B, H, W, 2)`` (x, y channels; only
    x is used, the search runs along the epipolar line). Returns float32
    ``(B, H, W, num_levels*(2r+1))``."""
    coords_x = coords[..., 0].float().contiguous()
    return _LOOKUPS[state.impl](state, coords_x)


def state_tensors(state: CorrState) -> Tuple[torch.Tensor, ...]:
    """The tensors of ``state``: its levels, then ``fmap1`` where it has
    one."""
    return state.levels + (() if state.fmap1 is None else (state.fmap1,))


def with_tensors(state: CorrState, tensors) -> CorrState:
    """``state`` holding ``tensors`` (in :func:`state_tensors` order)."""
    n = len(state.levels)
    return dataclasses.replace(
        state, levels=tuple(tensors[:n]),
        fmap1=tensors[n] if len(tensors) > n else None)


def _vjp_by_autograd(state, coords_x, ct, needs):
    """The plain lookups' gradients: the lookup recomputed with autograd
    (no kernel runs)."""
    leaves = [t.detach().requires_grad_(n)
              for t, n in zip(state_tensors(state), needs)]
    with torch.enable_grad():
        out = _LOOKUPS[state.impl](with_tensors(state, leaves), coords_x)
        want = [t for t, n in zip(leaves, needs) if n]
        got = iter(torch.autograd.grad(out, want, ct, allow_unused=True)
                   if want else ())
    return tuple(next(got) if n else None for n in needs)


def _vjp_volume_pyramid(state, coords_x, ct, needs):
    """``reg_pallas``: the windowed_sample backward, one launch per
    MAX_LEVELS levels."""
    k = 2 * state.radius + 1
    out = []
    for i in range(0, len(state.levels), MAX_LEVELS):
        levels = state.levels[i:i + MAX_LEVELS]
        center = coords_x if i == 0 else coords_x / (2 ** i)
        _, dvols = windowed_sample_pyramid_vjp(
            levels, center, ct[..., i * k:(i + len(levels)) * k],
            state.radius, False, needs[i:i + len(levels)])
        out.extend(dvols)
    return tuple(out)


def _vjp_features(function):
    def vjp(state, coords_x, ct, needs):
        """``alt_pallas``/``fused``: the kernel's backward per MAX_LEVELS
        levels; ``fmap1``'s gradient summed over the chunks."""
        k = 2 * state.radius + 1
        n = len(state.levels)
        dlevels, df1 = [], None
        for i in range(0, n, MAX_LEVELS):
            levels = state.levels[i:i + MAX_LEVELS]
            center = coords_x if i == 0 else coords_x / (2 ** i)
            d1, dl = function.backward_only(
                state.fmap1, levels, center,
                ct[..., i * k:(i + len(levels)) * k], state.radius,
                needs[n], needs[i:i + len(levels)])
            dlevels.extend(dl)
            if d1 is not None:
                df1 = d1 if df1 is None else df1 + d1
        return tuple(dlevels) + (df1,)
    return vjp


_VJPS: Dict[str, Callable] = {
    "reg": _vjp_by_autograd, "alt": _vjp_by_autograd,
    "reg_pallas": _vjp_volume_pyramid,
    "alt_pallas": _vjp_features(_AltCorrPyramid),
    "fused": _vjp_features(_FusedCorrPyramid)}


class _ReplayLookup(torch.autograd.Function):
    """Returns ``saved`` (in ``dtype``) in place of ``corr_lookup(state,
    coords)``'s value, cast to ``dtype``; the backward is that lookup's,
    computed without its forward (the implementation's backward kernel or
    plain version). ``through``: the value was rounded through that dtype
    in the forward, so the cotangent is too."""

    @staticmethod
    def forward(ctx, meta, coords_x, saved, *tensors):
        ctx.meta = meta
        ctx.save_for_backward(coords_x, *tensors)
        return saved.to(meta[1], copy=True)

    @staticmethod
    def backward(ctx, g):
        state, _, through = ctx.meta
        coords_x, *tensors = ctx.saved_tensors
        if through is not None:
            g = g.to(through)
        needs = ctx.needs_input_grad[3:]
        grads = _VJPS[state.impl](with_tensors(state, tensors), coords_x,
                                  g.float(), needs)
        return (None, None, None, *grads)


def corr_lookup_replay(state: CorrState, coords: torch.Tensor,
                       saved: torch.Tensor, dtype: torch.dtype,
                       through: Optional[torch.dtype] = None
                       ) -> torch.Tensor:
    """``corr_lookup(state, coords).to(dtype)`` with the value of
    ``saved`` (an earlier forward's copy) and no lookup forward run: the
    gradient still flows to the state's tensors, by the implementation's
    backward alone (on ``reg_pallas`` one windowed_sample backward launch
    and no forward launch). ``through``: the saved value was rounded
    through that dtype in the forward; its cotangent is rounded alike."""
    coords_x = coords[..., 0].float().contiguous()
    tensors = state_tensors(state)
    meta = (with_tensors(state, (None,) * len(tensors)), dtype, through)
    return _ReplayLookup.apply(meta, coords_x, saved, *tensors)
