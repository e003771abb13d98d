"""Training state and one training step (the port of
``raft_stereo_tpu.training.state``).

:func:`make_train_step` builds the step that the JAX package's trainer
drives: the train-mode forward, the sequence loss, the backward, and one
optimizer micro-step (global-norm clip, AdamW at the OneCycle LR, gradient
accumulation) behind the anomaly guard. It updates the model and the
optimizer in place and returns the state for the JAX package's calling
convention.

Data parallelism (JAX's ``axis_name``): with a ``torch.distributed``
``group`` each rank computes the loss and gradients of its slice of the
global batch (the loss normalised over the global batch,
``training/loss.py``), then one SUM all-reduce of one flat buffer holding
every gradient makes the global batch's gradients on every rank. The
guard's norm and decision and the per-leaf norms read the reduced
gradients, so every rank takes the same branch with no other collective.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from raft_stereo_tpu_torch.training.loss import (loss_mask, sequence_loss,
                                                 sequence_loss_fused)
from raft_stereo_tpu_torch.training.optim import Optimizer, global_norm
from raft_stereo_tpu_torch.utils.weights import jax_leaf_names


def loss_and_grads(model: torch.nn.Module, batch: Mapping[str, Any],
                   train_iters: int, group: Optional[Any] = None,
                   fused_loss: bool = False):
    """Train-mode forward, sequence loss and backward on ``batch``:
    ``(loss, metrics, grads)`` with ``metrics`` holding ``loss`` too, all
    detached, and ``grads`` in ``model.parameters()`` order (zeros for a
    parameter the loss does not reach). Leaves every ``.grad`` None.
    ``group``: ``batch`` is this rank's slice of the global batch; loss
    and metrics are the global batch's, ``grads`` this rank's share of its
    gradients (:func:`all_reduce_grads` sums the shares). ``fused_loss``:
    the model reduces each iteration's masked L1 itself (its ``flow_gt``
    and ``loss_mask`` inputs) and :func:`sequence_loss_fused` weighs the
    sums: the same loss without the prediction stack."""
    params = list(model.parameters())
    dev = params[0].device
    b = {k: torch.as_tensor(batch[k]).to(dev)
         for k in ("image1", "image2", "flow", "valid")}
    for p in params:
        p.grad = None
    if fused_loss:
        mask = loss_mask(b["flow"], b["valid"])
        err_sums, final = model(b["image1"], b["image2"], iters=train_iters,
                                test_mode=False, flow_gt=b["flow"],
                                loss_mask=mask)
        loss, metrics = sequence_loss_fused(err_sums, final, b["flow"],
                                            mask, group=group)
    else:
        preds = model(b["image1"], b["image2"], iters=train_iters,
                      test_mode=False)
        loss, metrics = sequence_loss(preds, b["flow"], b["valid"],
                                      group=group)
    loss.backward()
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    for p in params:
        p.grad = None
    metrics = {k: v.detach() for k, v in dict(metrics, loss=loss).items()}
    return metrics["loss"], metrics, grads


def all_reduce_grads(grads: Sequence[torch.Tensor], group: Any,
                     flags: Sequence[float] = ()
                     ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """Sum ``grads`` (one rank's shares) over ``group`` with one all-reduce
    of one flat fp32 buffer; ``flags`` (host numbers, e.g. a stop request)
    ride at its end and come back summed over the ranks, on the device.
    Returns ``(grads, flags)``."""
    flat = torch.cat([g.reshape(-1).float() for g in grads]
                     + [torch.tensor(list(flags), dtype=torch.float32,
                                     device=grads[0].device)])
    dist.all_reduce(flat, group=group)
    out, offset = [], 0
    for g in grads:
        out.append(flat[offset:offset + g.numel()].view_as(g).to(g.dtype))
        offset += g.numel()
    return out, flat[offset:]


@dataclasses.dataclass
class TrainState:
    """The model (parameters and frozen batch-norm statistics), its
    optimizer, and the count of consumed batches."""

    model: torch.nn.Module
    optimizer: Optimizer
    step: int = 0


def make_train_step(model: torch.nn.Module, optimizer: Optimizer,
                    train_iters: int, group: Optional[Any] = None,
                    fused_loss: bool = False, anomaly_guard: bool = True,
                    numerics: bool = False):
    """Build ``train_step(state, batch, stop=False) -> (state, metrics)``.

    ``batch`` holds ``image1``/``image2`` ``(B, H, W, 3)`` uint8-range
    floats, ``flow`` ``(B, H, W, 1)`` and ``valid`` ``(B, H, W)``, as
    tensors or numpy arrays; they are moved to the model's device.
    ``optimizer`` must hold ``model``'s parameters in the order of
    ``model.parameters()``. ``metrics`` are device tensors: ``loss``,
    ``epe``, ``1px``, ``3px``, ``5px`` and, with the guard, ``grad_norm``
    (the global norm of the unclipped gradients) and ``skipped_updates``
    (1.0 when this step's update was skipped). ``numerics`` adds
    ``leaf_grad_norms``: one L2 norm per parameter, in the order of the
    JAX package's parameter leaves.

    ``anomaly_guard``: when the loss or the gradient norm is not finite,
    the update is skipped: parameters, AdamW moments and AdamW's step
    count stay bitwise unchanged and the LR schedule does not advance,
    while ``state.step`` still counts the batch. Deciding that reads one
    boolean back from the device each step (a host sync, where the JAX
    package branches on the device with ``lax.cond``).

    ``group`` (JAX's ``axis_name``): a ``torch.distributed`` process group
    over which the step is data parallel (module docstring); ``batch`` is
    this rank's slice. ``stop`` (a host bool, e.g. this rank's preemption
    signal) rides the gradients' all-reduce: ``metrics["stop"]`` (a host
    bool, with a group only) is True on every rank when any rank asked,
    so all stop after the same step. ``fused_loss``: the model reduces
    each iteration's masked L1 sum itself (:func:`loss_and_grads`).
    """
    params = list(model.parameters())
    if [id(p) for p in optimizer.params] != [id(p) for p in params]:
        raise ValueError("the optimizer does not hold the model's parameters "
                         "in model.parameters() order")
    if numerics:
        index = {name: i for i, (name, _) in
                 enumerate(model.named_parameters())}
        leaf_order = [index[name] for name, _ in jax_leaf_names(model)]

    def train_step(state: TrainState, batch: Mapping[str, Any],
                   stop: bool = False
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        loss, metrics, grads = loss_and_grads(state.model, batch,
                                              train_iters, group=group,
                                              fused_loss=fused_loss)
        # the agreed stop request, read with the guard's decision
        stops = []
        if group is not None:
            grads, flags = all_reduce_grads(grads, group, [float(stop)])
            stops = [flags]
        if numerics:
            metrics["leaf_grad_norms"] = torch.sqrt(torch.stack(
                [torch.sum(grads[i].float() ** 2) for i in leaf_order]))
        if anomaly_guard:
            grad_norm = global_norm(grads)
            finite = torch.isfinite(grad_norm) & torch.isfinite(loss)
            host = torch.cat([finite.float().reshape(1)] + stops).tolist()
            if host[0]:  # the host sync
                state.optimizer.step(grads)
            metrics.update(grad_norm=grad_norm,
                           skipped_updates=1.0 - finite.float())
        else:
            host = [None] + (stops[0].tolist() if stops else [])
            state.optimizer.step(grads)
        if stops:
            metrics["stop"] = host[1] > 0
        state.step += 1
        return state, metrics

    return train_step
