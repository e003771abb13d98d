"""The correlation lookup's semantics: a 2r+1-tap linear window sample.

Counterpart of ``raft_stereo_tpu.ops.sampler.windowed_linear_sample``. It
is the port's ``reg`` lookup and the plain version beside the
``windowed_sample`` CUDA kernel (``ops/kernels/windowed_sample.py``), which
computes the same numbers.
"""

from __future__ import annotations

import torch


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
    c = center.float()
    base_f = torch.floor(c)
    frac = (c - base_f)[..., None]
    lim = float(w + radius + 2)
    base_f = torch.nan_to_num(base_f, nan=0.0).clamp(-lim, lim)
    base = base_f.to(torch.int64) - radius
    idx = base[..., None] + torch.arange(2 * radius + 2,
                                         device=values.device)
    valid = (idx >= 0) & (idx < w)
    g = torch.gather(values, -1, idx.clamp(0, w - 1)).float()
    g = torch.where(valid, g, torch.zeros((), device=g.device))
    return (1.0 - frac) * g[..., :-1] + frac * g[..., 1:]
