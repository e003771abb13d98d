"""Data-parallel training steps (the port's
``raft_stereo_tpu/parallel/data_parallel.py``).

* :func:`make_shardmap_train_step` — JAX's explicit-collective step
  (``shard_map`` with a ``psum`` of the gradients): each rank computes the
  gradients of its slice of the batch, and one SUM all-reduce of a flat
  buffer of every gradient gives the global batch's
  (``training/state.py``). Building it broadcasts rank 0's state. The
  fused lookup+convc1 kernel stays on: each rank's shapes are its own.
* :func:`make_pjit_train_step` — JAX's auto-SPMD step over ``(data,
  seq)``. Over ``data`` alone it is the same step with JAX's rule that it
  runs the unfused lookup (the fused kernel has no partitioning rule
  there). Width sharding over ``seq`` needs halo-exchanging convolutions
  and the correlation's ring: ROADMAP A13; ``seq`` above 1 raises.
* :func:`dryrun_train_step` and the flagship shapes — one step of both
  over N ranks (one process a rank; a card each, or the CPU).
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from raft_stereo_tpu_torch.parallel.mesh import (Mesh, replicated,
                                                 require_seq_one)
from raft_stereo_tpu_torch.training.state import make_train_step


def make_shardmap_train_step(model, optimizer, train_iters: int, mesh: Mesh,
                             fused_loss: bool = False,
                             anomaly_guard: bool = True,
                             numerics: bool = False, state=None):
    """The explicit-collective data-parallel step over ``mesh``'s group:
    ``step(state, local_batch, stop=False) -> (state, metrics)`` with
    ``local_batch`` this rank's slice. Building it broadcasts rank 0's
    model (and the optimizer's state, ``state`` being given) to every rank.
    ``fused_loss``: the in-loop reduced loss, its sums over the group
    (``training/loss.py::sequence_loss_fused``)."""
    require_seq_one(mesh.seq)
    replicated(mesh, state if state is not None else model)
    return make_train_step(model, optimizer, train_iters, group=mesh.group,
                           fused_loss=fused_loss,
                           anomaly_guard=anomaly_guard, numerics=numerics)


def unfused_lookup(model):
    """``model`` running the unfused lookup: the same module (parameters,
    buffers and submodules shared) with ``fused_lookup`` off in its
    config; ``model`` itself is left as it is."""
    if not getattr(model.cfg, "fused_lookup", None):
        return model
    clone = copy.copy(model)
    clone.cfg = dataclasses.replace(model.cfg, fused_lookup=False)
    return clone


def make_pjit_train_step(model, optimizer, train_iters: int, mesh: Mesh,
                         fused_loss: bool = False,
                         anomaly_guard: bool = True,
                         numerics: bool = False):
    """JAX's auto-SPMD step over ``mesh``: over ``data`` the data-parallel
    step, with the fused lookup+convc1 kernel forced off as JAX forces it
    (identical semantics, the unfused graph); ``seq`` above 1 raises
    (ROADMAP A13). It does not broadcast the state (JAX's replicated
    placement is the caller's: :func:`~.mesh.replicated`)."""
    require_seq_one(mesh.seq)
    return make_train_step(unfused_lookup(model), optimizer, train_iters,
                           group=mesh.group, fused_loss=fused_loss,
                           anomaly_guard=anomaly_guard, numerics=numerics)


def _dryrun_rank(dev, image_size, batch, train_iters, fused_loss,
                 run_shardmap):
    """One rank of :func:`dryrun_train_step`: the pjit-style step, then the
    shard_map-style one, on the rank's slice of one seeded global batch.
    Returns each step's metrics."""
    from raft_stereo_tpu_torch.config import RAFTStereoConfig, TrainConfig
    from raft_stereo_tpu_torch.models import RAFTStereo, init_weights
    from raft_stereo_tpu_torch.parallel.distributed import global_mesh
    from raft_stereo_tpu_torch.parallel.mesh import shard_batch
    from raft_stereo_tpu_torch.training.optim import fetch_optimizer
    from raft_stereo_tpu_torch.training.state import TrainState

    mesh = global_mesh(device=dev)
    h, w = image_size
    rng = np.random.default_rng(0)
    global_batch = {
        "image1": rng.uniform(0, 255, (batch, h, w, 3)).astype(np.float32),
        "image2": rng.uniform(0, 255, (batch, h, w, 3)).astype(np.float32),
        "flow": rng.uniform(-8, 0, (batch, h, w, 1)).astype(np.float32),
        "valid": np.ones((batch, h, w), np.float32)}
    local = shard_batch(mesh, global_batch)
    tcfg = TrainConfig(num_steps=100, batch_size=batch)
    out = {}
    for name in ("pjit", "shardmap")[:2 if run_shardmap else 1]:
        model = init_weights(RAFTStereo(RAFTStereoConfig(
            mixed_precision=True)), torch.Generator().manual_seed(0)).to(dev)
        opt = fetch_optimizer(tcfg, model.parameters())
        state = TrainState(model, opt)
        if name == "pjit":
            replicated(mesh, state)
            step = make_pjit_train_step(model, opt, train_iters, mesh,
                                        fused_loss=fused_loss)
        else:
            step = make_shardmap_train_step(model, opt, train_iters, mesh,
                                            fused_loss=fused_loss,
                                            state=state)
        state, metrics = step(state, local)
        out[name] = {k: float(v) for k, v in metrics.items() if k != "stop"}
        print(f"rank {mesh.rank}: {name} dp step ok (fused_loss="
              f"{fused_loss}): {out[name]}", flush=True)
    return out


def dryrun_train_step(n_devices: int, seq_parallel: int = 1,
                      image_size=(32, 64), batch: int = 0,
                      train_iters: int = 2, fused_loss: bool = True,
                      run_shardmap: bool = True, device: str = "cuda"):
    """One full data-parallel training step (the pjit-style one, then the
    shard_map-style one) over ``n_devices`` ranks, one process each: on a
    card each (``device="cuda"``; more ranks than cards raises) or on the
    CPU. The default architecture in mixed precision on a seeded batch
    (``batch`` 0: one pair a rank), with the fused loss by default, as
    JAX's dry run. ``seq_parallel`` above 1 raises, as the steps do.
    Returns each rank's metrics."""
    from raft_stereo_tpu_torch.parallel.distributed import (launch,
                                                            rank_device)
    require_seq_one(seq_parallel)
    devices = [rank_device(device, r) for r in range(n_devices)]
    return launch(_dryrun_rank, devices, tuple(image_size),
                  batch if batch > 0 else n_devices, train_iters, fused_loss,
                  run_shardmap)


def dryrun_flagship_shape(n_devices: int, seq_parallel: int = 1,
                          train_iters: int = 2, device: str = "cuda"):
    """The dry run at the SceneFlow recipe's shape: batch 8, 320x720."""
    return dryrun_train_step(n_devices, seq_parallel=seq_parallel,
                             image_size=(320, 720), batch=8,
                             train_iters=train_iters, fused_loss=True,
                             run_shardmap=False, device=device)


def dryrun_flagship_scaled(n_devices: int, seq_parallel: int = 1,
                           train_iters: int = 2, device: str = "cuda"):
    """The flagship's batch (8 over ``data``) at 96x224, the JAX package's
    scaled dry run."""
    return dryrun_train_step(n_devices, seq_parallel=seq_parallel,
                             image_size=(96, 224), batch=8,
                             train_iters=train_iters, fused_loss=True,
                             run_shardmap=False, device=device)
