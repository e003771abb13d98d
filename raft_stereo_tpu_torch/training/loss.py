"""Sequence loss over the iterative predictions (the port of
``raft_stereo_tpu.training.loss``).

Exponentially weighted L1 over every refinement iteration's upsampled
prediction, with the decay adjusted so that schedules with different
iteration counts weigh alike: ``gamma_adj = gamma ** (15 / (n - 1))``, and
iteration ``i`` weighted ``gamma_adj ** (n - 1 - i)``. Pixels count when
valid and when ``|gt| < max_flow``; the sum is normalised by the number of
such pixels. The final iteration's metrics are ``epe`` and the ``1px``,
``3px`` and ``5px`` inlier shares. :func:`sequence_loss_fused` takes
the per-iteration sums the model reduced itself (the fused loss) and
applies the same weighting, normalisation and metrics.

Data parallelism (the counterpart of JAX's ``axis_name``): with a
``torch.distributed`` ``group`` the per-iteration error sums, the
valid-pixel count and the metric sums are summed over the group, so the
loss and the metrics are those of the global batch. The gradient counts
each rank's own pixels once: the global sums are constants of the
forward (their backward passes the cotangent to this rank's terms
unchanged), so a rank's gradient is its own numerator over the global
denominator, and the one SUM all-reduce of the gradients after backward
(``training/state.py``) makes the global batch's gradient. A
differentiable all-reduce here would count every cotangent again there:
N times the gradient.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.distributed as dist


def loss_mask(flow_gt: torch.Tensor, valid: torch.Tensor,
              max_flow: float = 700.0) -> torch.Tensor:
    """``(B, H, W, 1)`` float mask: ``valid >= 0.5`` and ``|gt| <
    max_flow``. ``valid`` is ``(B, H, W)`` or ``(B, H, W, 1)``."""
    if valid.dim() == flow_gt.dim() - 1:
        valid = valid[..., None]
    mag = torch.sqrt(torch.sum(flow_gt.float() ** 2, dim=-1, keepdim=True))
    return ((valid >= 0.5) & (mag < max_flow)).float()


class _GroupSum(torch.autograd.Function):
    """The sum over ``group`` of each rank's ``x``; the backward hands the
    cotangent to this rank's ``x`` as it is (the gradients' all-reduce sums
    the ranks' terms)."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.detach().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _weighted_loss_and_metrics(per_iter, final_flow, gt, mask, loss_gamma,
                               group):
    """The exponential weighting and valid-pixel normalisation of the
    per-iteration masked L1 sums ``per_iter (iters,)``, and the final
    iteration's metrics, summed over ``group`` by one all-reduce."""
    zero = torch.zeros((), device=gt.device)
    n = per_iter.shape[0]
    gamma = loss_gamma ** (15.0 / (n - 1)) if n > 1 else 1.0
    weights = gamma ** torch.arange(n - 1, -1, -1, dtype=torch.float32,
                                    device=gt.device)
    epe = torch.sqrt(torch.sum((final_flow.float() - gt) ** 2, dim=-1))
    m = mask[..., 0]
    epe = torch.where(m > 0, epe, zero).detach()
    sums = torch.stack([mask.sum(), epe.sum(), ((epe < 1.0) * m).sum(),
                        ((epe < 3.0) * m).sum(), ((epe < 5.0) * m).sum()])
    if group is not None:
        # one all-reduce for the iterations' error sums and the counts
        both = _GroupSum.apply(torch.cat([per_iter, sums]), group)
        per_iter, sums = both[:n], both[n:]
    denom = torch.clamp(sums[0], min=1.0)
    loss = torch.sum(weights * per_iter) / denom
    metrics = {k: sums[i] / denom
               for i, k in enumerate(("epe", "1px", "3px", "5px"), 1)}
    return loss, metrics


def sequence_loss(flow_preds: torch.Tensor, flow_gt: torch.Tensor,
                  valid: torch.Tensor, loss_gamma: float = 0.9,
                  max_flow: float = 700.0, group: Optional[Any] = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``flow_preds (iters, B, H, W, 1)``, ``flow_gt (B, H, W, 1)`` ->
    ``(loss, {"epe", "1px", "3px", "5px"})``, all fp32 scalars.

    Masked-out pixels are zeroed with ``where`` before the sum, so a
    non-finite ground truth there (an inf disparity) cannot poison it.
    ``group``: sum over the ranks of a process group (module docstring);
    every rank gets the same loss and metrics.
    """
    mask = loss_mask(flow_gt, valid, max_flow)
    gt = flow_gt.float()
    zero = torch.zeros((), device=gt.device)
    abs_err = torch.abs(flow_preds.float() - gt[None])
    abs_err = torch.where(mask[None] > 0, abs_err, zero)
    per_iter = abs_err.sum(dim=(1, 2, 3, 4))
    return _weighted_loss_and_metrics(per_iter, flow_preds[-1], gt, mask,
                                      loss_gamma, group)


def sequence_loss_fused(per_iter_err_sums: torch.Tensor,
                        final_flow: torch.Tensor, flow_gt: torch.Tensor,
                        mask: torch.Tensor, loss_gamma: float = 0.9,
                        group: Optional[Any] = None
                        ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The sequence loss from the model's fused-loss outputs: each
    iteration's masked L1 sum ``per_iter_err_sums (iters,)`` (already
    reduced in the model) and the final ``flow_up (B, H, W, 1)``, against
    ``flow_gt`` and the :func:`loss_mask` ``mask``. The same weighting,
    normalisation, metrics and ``group`` sums as :func:`sequence_loss`."""
    return _weighted_loss_and_metrics(per_iter_err_sums.float(), final_flow,
                                      flow_gt.float(), mask, loss_gamma,
                                      group)
