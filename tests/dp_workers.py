"""Rank functions for tests/test_torch_parallel.py, run by
``raft_stereo_tpu_torch.parallel.distributed.launch`` in spawned processes.
This module imports torch, numpy and the port only: each spawned process
imports it, and a JAX import would cost every rank seconds."""

import hashlib

import numpy as np
import torch
import torch.distributed as dist


def _digest(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def _model(cfg, state_dict):
    from raft_stereo_tpu_torch.models import RAFTStereo
    model = RAFTStereo(cfg)
    model.load_state_dict(state_dict, strict=True)
    return model


def parity_rank(dev, cfg, state_dict, batch, iters, loss_inputs, lr,
                num_steps):
    """Every data-parallel check of one rank on the CPU, over one spawn:
    the batch slice and its gather, the grouped sequence loss and its
    gradient, the reduced gradients (of the stacked loss, of the fused
    loss, and of the fused loss over the batched-weight-gradient
    backward), two data-parallel steps, and (rank 0)
    a 1-rank group against the plain step or (rank 1) the one-process
    gradients of the whole batch. Returns a dict of host values."""
    from raft_stereo_tpu_torch.config import TrainConfig
    from raft_stereo_tpu_torch.parallel import distributed as pd
    from raft_stereo_tpu_torch.parallel.data_parallel import (
        make_shardmap_train_step)
    from raft_stereo_tpu_torch.training.loss import sequence_loss
    from raft_stereo_tpu_torch.training.optim import fetch_optimizer
    from raft_stereo_tpu_torch.training.state import (TrainState,
                                                      all_reduce_grads,
                                                      loss_and_grads,
                                                      make_train_step)
    torch.set_num_threads(1)
    rank = dist.get_rank()
    out = {"rank": rank, "backend": dist.get_backend()}
    # every rank makes every subgroup, in one order
    solo = [dist.new_group([r]) for r in range(dist.get_world_size())]
    mesh = pd.global_mesh(device=dev)
    out["coords"] = mesh.coords

    # the batch slice, its placement and the gathered whole
    n = len(batch["image1"])
    sl = pd.process_batch_slice(n)
    out["slice"] = (sl.start, sl.stop)
    local = pd.host_local_to_global(mesh, {k: v[sl] for k, v in
                                           batch.items()})
    gathered = {}
    for k, v in local.items():
        parts = [torch.empty_like(v) for _ in range(mesh.data)]
        dist.all_gather(parts, v)
        gathered[k] = torch.cat(parts).numpy()
    out["gather_equal"] = all(np.array_equal(gathered[k], batch[k])
                              for k in batch)
    try:
        pd.process_batch_slice(n + 1)
    except ValueError as e:
        out["indivisible"] = str(e)

    # the grouped sequence loss on uneven masks, and its gradient
    preds, gt, valid = (torch.from_numpy(a) for a in loss_inputs)
    bs = pd.process_batch_slice(gt.shape[0])
    mine = preds[:, bs].clone().requires_grad_(True)
    loss, metrics = sequence_loss(mine, gt[bs], valid[bs], group=mesh.group)
    loss.backward()
    out["loss_fn"] = dict({k: float(v) for k, v in metrics.items()},
                          loss=float(loss))
    out["loss_fn_grad"] = mine.grad.numpy()

    # this rank's gradient share, then the reduced gradients
    model = _model(cfg, state_dict)
    names = [k for k, _ in model.named_parameters()]
    local_batch = {k: v[sl] for k, v in batch.items()}
    dp_loss, _, grads = loss_and_grads(model, local_batch, iters,
                                       group=mesh.group)
    grads, flags = all_reduce_grads(grads, mesh.group, [float(rank)])
    out["flag_sum"] = flags.tolist()
    out["dp_loss"] = float(dp_loss)
    out["dp_grads_digest"] = _digest(grads)
    if rank == 0:
        out["dp_grads"] = {k: g.numpy() for k, g in zip(names, grads)}

    # the fused loss, and the fused loss over the batched-weight-gradient
    # backward: the reduced gradients of the grouped step
    import dataclasses
    for key, c in (("fused", cfg),
                   ("custom", dataclasses.replace(cfg,
                                                  batched_scan_wgrad=True))):
        f_loss, f_metrics, f_grads = loss_and_grads(
            _model(c, state_dict), local_batch, iters, group=mesh.group,
            fused_loss=True)
        f_grads, _ = all_reduce_grads(f_grads, mesh.group)
        out[key + "_loss"] = float(f_loss)
        out[key + "_epe"] = float(f_metrics["epe"])
        out[key + "_grads_digest"] = _digest(f_grads)
        if rank == 0:
            out[key + "_grads"] = {k: g.numpy()
                                   for k, g in zip(names, f_grads)}

    # two data-parallel steps from rank 0's state: replicas bitwise equal
    tcfg = TrainConfig(num_steps=num_steps, lr=lr, batch_size=n)
    model = _model(cfg, state_dict)
    if rank:  # a replica that differs until the step's broadcast
        with torch.no_grad():
            next(model.parameters()).add_(1.0)
    opt = fetch_optimizer(tcfg, model.parameters())
    state = TrainState(model, opt)
    step = make_shardmap_train_step(model, opt, iters, mesh, state=state)
    step_metrics = []
    for _ in range(2):
        state, m = step(state, local_batch, stop=rank == 1)
        step_metrics.append({k: float(v) for k, v in m.items()
                             if k != "stop"} | {"stop": m["stop"]})
    out["steps"] = step_metrics
    out["params_digest"] = _digest(model.parameters())
    out["moments_digest"] = _digest(
        [t for p in model.parameters()
         for t in (opt.adamw.state[p]["exp_avg"],
                   opt.adamw.state[p]["exp_avg_sq"])])

    if rank == 0:
        # a 1-rank group: bitwise the plain step
        runs = []
        for group in (solo[0], None):
            model = _model(cfg, state_dict)
            opt = fetch_optimizer(tcfg, model.parameters())
            step = make_train_step(model, opt, iters, group=group,
                                   numerics=True)
            st, m = step(TrainState(model, opt), batch)
            runs.append(({k: v for k, v in m.items() if k != "stop"},
                         [p.detach().clone() for p in model.parameters()]))
        (m1, p1), (m0, p0) = runs
        out["solo_bitwise"] = (
            m1.keys() == m0.keys()
            and all(torch.equal(m1[k], m0[k]) for k in m0)
            and all(torch.equal(a, b) for a, b in zip(p1, p0)))
    else:
        # the one-process gradients of the whole batch
        model = _model(cfg, state_dict)
        one_loss, _, grads = loss_and_grads(model, batch, iters)
        out["one_loss"] = float(one_loss)
        out["one_grads"] = {k: g.numpy() for k, g in zip(names, grads)}
    return out


def card_step_rank(dev, cfg, state_dict, batch, iters):
    """One rank of the card test: this rank's slice of ``batch`` through
    the data-parallel loss and gradients on its card, the reduced
    gradients returned on the CPU with the loss and the backend."""
    from raft_stereo_tpu_torch.parallel import distributed as pd
    from raft_stereo_tpu_torch.training.state import (all_reduce_grads,
                                                      loss_and_grads)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = pd.global_mesh(device=dev)
    model = _model(cfg, state_dict).to(dev)
    sl = pd.process_batch_slice(len(batch["image1"]))
    loss, _, grads = loss_and_grads(
        model, {k: v[sl] for k, v in batch.items()}, iters, group=mesh.group)
    grads, _ = all_reduce_grads(grads, mesh.group)
    return {"backend": dist.get_backend(), "device": str(dev),
            "loss": float(loss), "grads": [g.cpu() for g in grads]}
