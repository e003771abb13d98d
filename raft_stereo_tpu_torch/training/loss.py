"""Sequence loss over the iterative predictions (the port of
``raft_stereo_tpu.training.loss``).

Exponentially weighted L1 over every refinement iteration's upsampled
prediction, with the decay adjusted so that schedules with different
iteration counts weigh alike: ``gamma_adj = gamma ** (15 / (n - 1))``, and
iteration ``i`` weighted ``gamma_adj ** (n - 1 - i)``. Pixels count when
valid and when ``|gt| < max_flow``; the sum is normalised by the number of
such pixels. The final iteration's metrics are ``epe`` and the ``1px``,
``3px`` and ``5px`` inlier shares.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def loss_mask(flow_gt: torch.Tensor, valid: torch.Tensor,
              max_flow: float = 700.0) -> torch.Tensor:
    """``(B, H, W, 1)`` float mask: ``valid >= 0.5`` and ``|gt| <
    max_flow``. ``valid`` is ``(B, H, W)`` or ``(B, H, W, 1)``."""
    if valid.dim() == flow_gt.dim() - 1:
        valid = valid[..., None]
    mag = torch.sqrt(torch.sum(flow_gt.float() ** 2, dim=-1, keepdim=True))
    return ((valid >= 0.5) & (mag < max_flow)).float()


def sequence_loss(flow_preds: torch.Tensor, flow_gt: torch.Tensor,
                  valid: torch.Tensor, loss_gamma: float = 0.9,
                  max_flow: float = 700.0
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``flow_preds (iters, B, H, W, 1)``, ``flow_gt (B, H, W, 1)`` ->
    ``(loss, {"epe", "1px", "3px", "5px"})``, all fp32 scalars.

    Masked-out pixels are zeroed with ``where`` before the sum, so a
    non-finite ground truth there (an inf disparity) cannot poison it.
    """
    mask = loss_mask(flow_gt, valid, max_flow)
    gt = flow_gt.float()
    zero = torch.zeros((), device=gt.device)
    abs_err = torch.abs(flow_preds.float() - gt[None])
    abs_err = torch.where(mask[None] > 0, abs_err, zero)
    per_iter = abs_err.sum(dim=(1, 2, 3, 4))
    n = per_iter.shape[0]
    gamma = loss_gamma ** (15.0 / (n - 1)) if n > 1 else 1.0
    weights = gamma ** torch.arange(n - 1, -1, -1, dtype=torch.float32,
                                    device=gt.device)
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = torch.sum(weights * per_iter) / denom

    epe = torch.sqrt(torch.sum((flow_preds[-1].float() - gt) ** 2, dim=-1))
    m = mask[..., 0]
    epe = torch.where(m > 0, epe, zero)
    metrics = {
        "epe": epe.sum() / denom,
        "1px": ((epe < 1.0) * m).sum() / denom,
        "3px": ((epe < 3.0) * m).sum() / denom,
        "5px": ((epe < 5.0) * m).sum() / denom,
    }
    return loss, metrics
