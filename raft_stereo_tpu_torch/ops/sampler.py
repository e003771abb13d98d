"""The correlation lookup's semantics: a 2r+1-tap linear window sample.

Counterpart of ``raft_stereo_tpu.ops.sampler.windowed_linear_sample``. It
is the port's ``reg`` lookup and the plain version beside the
``windowed_sample`` CUDA kernel (``ops/kernels/windowed_sample.py``), which
computes the same numbers.
"""

from __future__ import annotations

from typing import Tuple

import torch


def window(center: torch.Tensor, w: int,
           radius: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(base, frac)`` of the windows around ``center`` in rows of width
    ``w``: ``base = floor(c) - r`` (int64) with ``floor(c)`` clamped to
    ``+-(w + r + 2)`` in float before the cast (a NaN center to 0), and
    ``frac = c - floor(c)`` taken before the clamp, with a trailing unit
    dim. The CUDA kernels' ``window_base`` computes the same."""
    c = center.float()
    base_f = torch.floor(c)
    frac = (c - base_f)[..., None]
    lim = float(w + radius + 2)
    base_f = torch.nan_to_num(base_f, nan=0.0).clamp(-lim, lim)
    return base_f.to(torch.int64) - radius, frac


def windowed_linear_sample(values: torch.Tensor, center: torch.Tensor,
                           radius: int) -> torch.Tensor:
    """Sample a contiguous ``2r+1``-tap window around ``center``.

    With ``base = floor(c) - r`` and ``f = c - floor(c)``, the taps are
    ``g_j = values[..., base + j]`` for ``j in [0, 2r+1]`` (zero outside
    ``[0, W)``) and the output is ``out_k = (1-f)*g_k + f*g_{k+1}``,
    blended in fp32 — ``grid_sample(align_corners=True,
    padding_mode='zeros')`` along the last axis.

    ``floor(c)`` is clamped in float before the integer cast, so centers
    far outside the row (±1e9) give exact zeros; a NaN center gives NaN.

    Args:
      values: ``(..., W)`` volume rows, fp32 or bf16.
      center: ``(...)`` window centers (the leading dims of ``values``).

    Returns:
      ``(..., 2r+1)`` float32 taps in ascending offset order.
    """
    w = values.shape[-1]
    base, frac = window(center, w, radius)
    idx = base[..., None] + torch.arange(2 * radius + 2,
                                         device=values.device)
    valid = (idx >= 0) & (idx < w)
    g = torch.gather(values, -1, idx.clamp(0, w - 1)).float()
    g = torch.where(valid, g, torch.zeros((), device=g.device))
    return (1.0 - frac) * g[..., :-1] + frac * g[..., 1:]


def window_grads(ct: torch.Tensor, frac: torch.Tensor) -> torch.Tensor:
    """The taps' gradients of the blend for the output cotangent ``ct
    (..., 2r+1)``: ``dg_j = (1-f)*ct_j + f*ct_{j-1}`` for ``j in [0, 2r+1]``
    (cotangents outside ``[0, 2r]`` are 0), fp32, each operation rounded
    as the CUDA kernels round it."""
    ct = ct.float()
    zero = torch.zeros_like(ct[..., :1])
    return ((1.0 - frac) * torch.cat([ct, zero], dim=-1)
            + frac * torch.cat([zero, ct], dim=-1))


def scatter_window(dg: torch.Tensor, base: torch.Tensor,
                   w: int) -> torch.Tensor:
    """Dense rows ``(..., w)`` holding ``dg[..., j]`` at ``base + j`` where
    that lies in ``[0, w)`` and 0 everywhere else (the inverse of the
    window's gather)."""
    j = torch.arange(w, device=dg.device) - base[..., None]
    inside = (j >= 0) & (j < dg.shape[-1])
    return torch.where(inside, torch.gather(dg, -1,
                                            j.clamp(0, dg.shape[-1] - 1)),
                       torch.zeros((), device=dg.device))
