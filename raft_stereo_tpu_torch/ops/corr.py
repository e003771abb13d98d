"""Pluggable 1-D correlation layer (the port of ``raft_stereo_tpu.ops.corr``).

``init_corr`` builds the correlation state once per pair and
``corr_lookup`` samples a ``2r+1``-tap window per pyramid level around the
current disparity coordinates. Five implementations are registered:

* ``reg`` — the all-pairs volume ``(B, H, W1, W2)``, pooled into a pyramid
  along W2; the lookup is plain PyTorch (``ops/sampler.py``).
* ``reg_pallas`` (``reg_cuda`` on the reference's command line) — the same
  pyramid, looked up by the hand-written ``windowed_sample`` CUDA kernel.
* ``alt`` — no persistent volume: the state is ``fmap1`` and a pyramid of
  ``fmap2`` pooled along W; each lookup recomputes every level's volume
  with ``torch.matmul`` and samples its window (plain PyTorch).
* ``alt_pallas`` — the same state; the hand-written ``alt_corr`` CUDA
  kernels build each level's correlation slab tile by tile on-chip and
  take its window, forward and backward.
* ``fused`` (``alt_cuda``, ``fused_cuda``, ``memoryless``) — the same
  state; the hand-written ``fused_corr`` CUDA kernels compute the taps
  from the features: one forward launch for the four levels, and a
  backward launch per level.

On CPU tensors the kernels' wrappers take their plain versions; on CUDA
tensors they launch the kernels or raise.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from raft_stereo_tpu_torch.ops.geometry import pool_last_axis2, pool_w2
from raft_stereo_tpu_torch.ops.kernels.alt_corr import alt_corr
from raft_stereo_tpu_torch.ops.kernels.fused_corr import (MAX_LEVELS,
                                                          fused_corr_pyramid)
from raft_stereo_tpu_torch.ops.kernels.windowed_sample import windowed_sample
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


def _lookup_features(corr: Callable) -> Callable:
    def lookup(state: CorrState, coords_x: torch.Tensor) -> torch.Tensor:
        """Per-level taps of ``fmap1`` against each pooled ``fmap2`` at
        ``coords_x / 2**i``, concatenated in the ``reg`` channel order."""
        out = [corr(state.fmap1, fmap2, coords_x / (2 ** i), state.radius)
               for i, fmap2 in enumerate(state.levels)]
        return torch.cat(out, dim=-1)
    return lookup


def _lookup_fused(state: CorrState, coords_x: torch.Tensor) -> torch.Tensor:
    """The ``fused`` lookup: one ``fused_corr_pyramid`` call (one forward
    launch) per MAX_LEVELS levels, level ``i`` at ``coords_x / 2**i``, in
    the ``reg`` channel order."""
    out = [fused_corr_pyramid(state.fmap1, state.levels[i:i + MAX_LEVELS],
                              coords_x / (2 ** i), state.radius)
           for i in range(0, len(state.levels), MAX_LEVELS)]
    return out[0] if len(out) == 1 else torch.cat(out, dim=-1)


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
              _lookup_with(windowed_sample))
register_corr("alt", functools.partial(_build_features, impl="alt"),
              _lookup_alt)
register_corr("alt_pallas",
              functools.partial(_build_features, impl="alt_pallas"),
              _lookup_features(alt_corr))
register_corr("fused", _build_features, _lookup_fused)


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
