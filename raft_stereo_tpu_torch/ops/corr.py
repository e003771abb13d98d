"""Pluggable 1-D correlation layer (the port of ``raft_stereo_tpu.ops.corr``).

``init_corr`` builds the all-pairs volume ``(B, H, W1, W2)`` once and pools
it into a pyramid along W2; ``corr_lookup`` samples a ``2r+1``-tap window
per level around the current disparity coordinates. Two implementations
are registered:

* ``reg`` — the lookup is plain PyTorch (``ops/sampler.py``).
* ``reg_pallas`` (``reg_cuda`` on the reference's command line) — the same
  pyramid, looked up by the hand-written ``windowed_sample`` CUDA kernel.
  On CPU tensors its wrapper takes the plain version; on CUDA tensors it
  launches the kernel or raises.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Callable, Dict, Optional, Tuple

import torch

from raft_stereo_tpu_torch.ops.geometry import pool_last_axis2
from raft_stereo_tpu_torch.ops.kernels.windowed_sample import windowed_sample
from raft_stereo_tpu_torch.ops.sampler import windowed_linear_sample


@dataclasses.dataclass(frozen=True)
class CorrState:
    """Correlation state carried through the refinement loop."""

    levels: Tuple[torch.Tensor, ...]  # per-level volume (B, H, W1, W2_i)
    impl: str
    radius: int
    num_levels: int = 4


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


def init_corr(impl: str, fmap1: torch.Tensor, fmap2: torch.Tensor, *,
              num_levels: int = 4, radius: int = 4,
              storage_dtype: Optional[torch.dtype] = None) -> CorrState:
    """Build correlation state from NHWC feature maps ``(B, H, W, D)``.
    ``storage_dtype`` (e.g. ``torch.bfloat16``) selects the volume's
    storage precision; None keeps fp32."""
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
