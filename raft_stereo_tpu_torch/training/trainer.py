"""The training loop (the port's copy of
``raft_stereo_tpu/training/trainer.py``).

:func:`train` wires together the deterministic loader (worker processes,
``data/loader.py``), the train step (``training/state.py``: forward, loss,
backward, the anomaly guard, clip, AdamW at the OneCycle LR), step-windowed
logging, full-state checkpoints and the validate-on-Things hook every
``validation_frequency`` steps. It runs on one device, the card unless
``device="cpu"``.

Data parallelism (JAX's mesh wiring, ``parallel/``): with a process group
initialized (``parallel.distributed.initialize``), ``train()`` runs as one
rank of it. Rank 0's state is broadcast after init and after a restore;
each rank loads its slice of every global batch and the step all-reduces
the gradients. Rank 0 alone writes checkpoints and runs validation while
the others wait at a barrier; every rank restores. A SIGTERM to any rank
rides the next step's gradient all-reduce, so every rank stops after the
same step with one preempt checkpoint; anomaly halts come at the same
step everywhere (the guard reads the reduced gradients). Each rank writes
its own events.jsonl under ``<run_dir>/<name>/rank<r>``, stamped with its
host id and mesh coordinates.

* Checkpoints are full state (exact resume, schedule position included)
  and atomic (``training/resilience.py``); ``restore_ckpt`` also takes a
  reference ``.pth`` (weights only) and ``"auto"`` (the newest checkpoint
  of this run that verifies).
* SIGTERM/SIGINT save a ``reason="preempt"`` checkpoint and return; a
  crash writes a best-effort emergency checkpoint unless the state is not
  finite or the crash is an :class:`~.resilience.AnomalyHalt`.
* The step skips the update on a non-finite loss or gradient norm;
  :class:`~.resilience.AnomalyPolicy` halts after M consecutive skips.

Step records are emitted one step late, as the JAX package's are: the
``step`` record of step *i* (loss, grad_norm, skipped_updates and the
data_wait/dispatch/fetch split) lands after step *i+1* has been dispatched.
The port's step already reads one boolean back from the device (the
guard's decision), so the dispatch leg holds the device's time and the
fetch leg only the conversion of the metrics. The telemetry bus gets the
stall watchdog's deadline, the host identity, fleet stamping and the
trainer's heartbeat, and ``memory`` records from ``torch.cuda`` with each
checkpoint.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from raft_stereo_tpu_torch.config import RAFTStereoConfig, TrainConfig
from raft_stereo_tpu_torch.data.datasets import fetch_dataloader
from raft_stereo_tpu_torch.data.loader import infinite_batches
from raft_stereo_tpu_torch.inference import resolve_device
from raft_stereo_tpu_torch.models import RAFTStereo, init_weights
from raft_stereo_tpu_torch.obs import Telemetry, resolve_host_id, tracer_for
from raft_stereo_tpu_torch.obs import numerics as obs_numerics
from raft_stereo_tpu_torch.parallel.data_parallel import make_pjit_train_step
from raft_stereo_tpu_torch.parallel.distributed import global_mesh
from raft_stereo_tpu_torch.parallel.mesh import (barrier, batch_sharding,
                                                 from_rank0, replicated)
from raft_stereo_tpu_torch.training import resilience
from raft_stereo_tpu_torch.training.checkpoint import (restore_train_state,
                                                       save_train_state)
from raft_stereo_tpu_torch.training.logger import Logger
from raft_stereo_tpu_torch.training.optim import fetch_optimizer
from raft_stereo_tpu_torch.training.state import TrainState
from raft_stereo_tpu_torch.utils.weights import load_reference_checkpoint

logger = logging.getLogger(__name__)


def _restore(path: str, state: TrainState,
             model_cfg: RAFTStereoConfig) -> TrainState:
    """Restore a full checkpoint directory, or a reference ``.pth``
    (weights only: the optimizer and step stay fresh)."""
    if path.endswith(".pth"):
        state.model.load_state_dict(
            load_reference_checkpoint(path, model_cfg), strict=True)
        logger.info("restored reference weights from %s", path)
        return state
    restore_train_state(path, state)
    logger.info("restored full train state from %s (step %d)", path,
                state.step)
    return state


def _emergency_checkpoint(exc: BaseException, state, cfg: TrainConfig,
                          tel, global_step: int,
                          run_digest: Optional[str]) -> Optional[str]:
    """Best-effort crash-path checkpoint (``reason="crash"``), so a crash
    costs no steps; not when the state is not finite (an ``anomaly``
    record ``kind="nonfinite_state"`` instead: the rollback target is the
    last periodic checkpoint) and not for an AnomalyHalt (which rolls back
    by design). Never raises."""
    if isinstance(exc, resilience.AnomalyHalt):
        return None
    try:
        if resilience.state_is_finite(state):
            path = save_train_state(
                cfg.ckpt_dir, cfg.name, state, step=global_step,
                config_digest=run_digest, reason="crash")
            logger.warning("emergency checkpoint after %s: %s",
                           type(exc).__name__, path)
            tel.checkpoint(global_step, path, reason="crash")
            return path
        logger.warning(
            "NOT saving emergency checkpoint: state is non-finite "
            "(resume from the last periodic checkpoint instead)")
        tel.emit("anomaly", kind="nonfinite_state", step=global_step)
    except Exception:
        logger.warning("emergency checkpoint failed", exc_info=True)
    return None


def train(model_cfg: RAFTStereoConfig, cfg: TrainConfig,
          validate_every: Optional[int] = None, device="cuda") -> str:
    """Run training to ``cfg.num_steps`` on ``device``; returns the final
    checkpoint's path (on preemption: the preempt checkpoint's). With a
    process group initialized, as one rank of it (module docstring)."""
    dev = resolve_device(device)
    validation_frequency = validate_every or cfg.validation_frequency
    ckpt_frequency = cfg.checkpoint_frequency or validation_frequency
    mesh = global_mesh(cfg.data_parallel, cfg.seq_parallel, device=dev)
    # this rank's slice of every global batch (raises when B % data != 0)
    rank_slice = batch_sharding(mesh, cfg.batch_size)
    lead = mesh.rank == 0
    logger.info("mesh: %s, rank %d at %s on %s (%s)", mesh.shape, mesh.rank,
                list(mesh.coords), dev, mesh.backend() or "one process")
    os.makedirs(cfg.ckpt_dir, exist_ok=True)

    model = init_weights(RAFTStereo(model_cfg),
                         torch.Generator().manual_seed(cfg.seed)).to(dev)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info("parameter count: %d", n_params)
    optimizer = fetch_optimizer(cfg, model.parameters())
    state = TrainState(model, optimizer)
    # the run-identity stamp: clobber protection + auto-resume filtering
    run_digest = resilience.config_digest(model_cfg, cfg)
    integrity_reports = []
    resume_from = None
    if cfg.restore_ckpt == "auto":
        best, integrity_reports = resilience.find_latest_valid(
            cfg.ckpt_dir, cfg.name, config_digest=run_digest,
            tree_hash=resilience.tree_structure_hash(state))
        if best is not None:
            state = _restore(best, state, model_cfg)
            resume_from = best
        else:
            logger.info("--restore_ckpt auto: no valid checkpoint for %r "
                        "under %s; starting fresh", cfg.name, cfg.ckpt_dir)
    elif cfg.restore_ckpt:
        state = _restore(cfg.restore_ckpt, state, model_cfg)
        resume_from = cfg.restore_ckpt
    # every rank from rank 0's state, after init and after a restore
    replicated(mesh, state)

    loader = fetch_dataloader(cfg, process_slice=rank_slice)
    if state.step:
        # reposition the stream at the restored step exactly: the epoch by
        # division, the batch within it by start_batch
        loader.epoch = state.step // len(loader)
        loader.start_batch = state.step % len(loader)
    schedule = optimizer.schedule
    accum_k = max(cfg.grad_accum_steps, 1)

    run_dir = os.path.join(cfg.run_dir, cfg.name)
    host_id, coords, parallel = cfg.host_id, None, {}
    if mesh.group is not None:
        run_dir = os.path.join(run_dir, f"rank{mesh.rank}")
        if cfg.fleet:
            host_id = f"{resolve_host_id(cfg.host_id)}-r{mesh.rank}"
        coords = list(mesh.coords)
        parallel = {"parallel": {"data": mesh.data, "seq": mesh.seq,
                                 "rank": mesh.rank, "coords": coords,
                                 "backend": mesh.backend()}}
    tel = Telemetry(run_dir, run_name=cfg.name,
                    stall_deadline_s=cfg.stall_deadline_s,
                    host_id=host_id, fleet=cfg.fleet,
                    device=dev if dev.type == "cpu" else None, coords=coords)
    tel.run_start(config={"model": dataclasses.asdict(model_cfg),
                          "train": dataclasses.asdict(cfg),
                          "device": str(dev), **parallel},
                  n_params=int(n_params), resumed_step=int(state.step),
                  config_digest=run_digest)
    for report in integrity_reports:
        tel.emit("ckpt_integrity", **report)
    if resume_from is not None:
        tel.emit("resume", step=int(state.step), path=resume_from)
    tracer = tracer_for(tel, enabled=cfg.trace)
    loader.gauge_hook = tel.loader_gauge
    loader.quarantine_hook = lambda info: tel.emit(
        "anomaly", kind="loader_quarantine", **info)
    loader.tracer = tracer
    policy = resilience.AnomalyPolicy(
        cfg.anomaly_max_skips if cfg.anomaly_guard else 0, telemetry=tel)
    nan_step = resilience.injected_nan_step()
    fault_sleep_s = resilience.injected_sleep_s()
    # fleet liveness: heartbeat records on cadence from a daemon thread
    tel.start_heartbeat("trainer", cfg.heartbeat_every_s)
    leaf_names = obs_numerics.grad_leaf_names(model) if cfg.numerics \
        else None
    step_fn = make_pjit_train_step(model, optimizer, cfg.train_iters, mesh,
                                   anomaly_guard=cfg.anomaly_guard,
                                   numerics=cfg.numerics)

    log = Logger(log_dir=run_dir, total_steps=int(state.step), telemetry=tel)
    validation_predictor = None  # made once, its weights refreshed after
    global_step = start_step = int(state.step)
    # lagged metrics: (step, metrics, timing) of step i are read, and its
    # `step` record emitted, after step i+1 has been dispatched
    pending = None
    batches = infinite_batches(loader)
    preempted = False

    def flush_pending():
        nonlocal pending
        if pending is None:
            return
        step_i, metrics, timing = pending
        pending = None
        metrics = dict(metrics)
        # the per-leaf norms are not a logging scalar: sampled onto the bus
        leaf_norms = metrics.pop("leaf_grad_norms", None)
        vals = {k: float(v) for k, v in metrics.items()}
        top = None
        if leaf_norms is not None:
            norms = leaf_norms.float().cpu().numpy()
            top = obs_numerics.top_leaves(leaf_names, norms)
            # a poisoned vector always emits: the cadence never hides the
            # step that carries the provenance
            if (step_i % max(cfg.numerics_every, 1) == 0
                    or not np.all(np.isfinite(norms))):
                obs_numerics.emit(tel, obs_numerics.grad_payload(
                    step_i, leaf_names, norms))
        log.push(vals, lr=float(schedule((step_i - 1) // accum_k)))
        extras = {k: vals[k] for k in ("loss", "grad_norm", "skipped_updates")
                  if k in vals}
        tel.step(step_i, batch_size=cfg.batch_size, **timing, **extras)
        policy.observe(bool(vals.get("skipped_updates", 0.0)), step_i,
                       grad_norm=vals.get("grad_norm"), top_leaves=top)

    with resilience.SignalGuard() as guard:
        try:
            while global_step < cfg.num_steps:
                # alone, a signal stops the run at once; a rank waits for
                # the step's all-reduce to agree with the others
                if mesh.group is None and guard.requested:
                    preempted = True
                    break
                t0 = time.perf_counter()
                batch = next(batches)
                t1 = time.perf_counter()
                if fault_sleep_s is not None:
                    time.sleep(fault_sleep_s)
                if nan_step is not None and global_step + 1 == nan_step:
                    logger.warning("fault injection: NaN batch at step %d",
                                   nan_step)
                    batch = dict(batch, image1=np.full_like(
                        batch["image1"], np.nan))
                state, metrics = step_fn(state, batch, stop=guard.requested)
                # any rank's stop request, agreed in the gradients'
                # all-reduce (alone: this process's)
                stop = metrics.pop("stop", guard.requested)
                t2 = time.perf_counter()
                flush_pending()  # the previous step's record
                t3 = time.perf_counter()
                pending = (global_step + 1, metrics,
                           {"data_wait_s": t1 - t0, "dispatch_s": t2 - t1,
                            "fetch_s": t3 - t2})
                # the t0..t3 legs tile the step root exactly
                root = tracer.record("step", t0, t3, step=global_step + 1)
                tracer.record("data_wait", t0, t1, parent=root)
                tracer.record("dispatch", t1, t2, parent=root)
                tracer.record("fetch", t2, t3, parent=root)
                global_step += 1
                if global_step == start_step + 1:
                    # the first step builds kernels and plans: its latency
                    tel.emit("compile", duration_s=round(t2 - t1, 3),
                             source="first_step_latency")

                do_ckpt = global_step % ckpt_frequency == 0
                do_val = global_step % validation_frequency == 0
                if do_ckpt or do_val or stop:
                    # validation scalars and the checkpoint agree on the
                    # step axis with the records
                    flush_pending()
                if stop:
                    preempted = True
                    break
                if do_ckpt and lead:
                    ckpt = save_train_state(
                        cfg.ckpt_dir, cfg.name, state, step=global_step,
                        config_digest=run_digest,
                        keep_last=cfg.ckpt_keep_last,
                        keep_every=cfg.ckpt_keep_every)
                    logger.info("saved %s", ckpt)
                    tel.checkpoint(global_step, ckpt)
                if do_val and lead:
                    if validation_predictor is None:
                        from raft_stereo_tpu_torch.inference import (
                            StereoPredictor)
                        validation_predictor = StereoPredictor(
                            model_cfg, model.state_dict(),
                            valid_iters=cfg.valid_iters, device=dev)
                    else:  # keep the predictor, refresh the weights
                        validation_predictor.model.load_state_dict(
                            model.state_dict(), strict=True)
                    results = _maybe_validate_things(validation_predictor,
                                                     cfg)
                    if results:
                        log.write_dict(results)
                    pps = tel.window_throughput()
                    if pps is not None:
                        logger.info("throughput: %.2f pairs/sec over last "
                                    "window", pps)
                if do_ckpt or do_val:
                    barrier(mesh)  # the others wait for rank 0's writes

            flush_pending()
            batches.close()
            loader.close()
            final = None
            if preempted:
                if lead:
                    final = save_train_state(
                        cfg.ckpt_dir, cfg.name, state, step=global_step,
                        config_digest=run_digest,
                        keep_last=cfg.ckpt_keep_last,
                        keep_every=cfg.ckpt_keep_every, reason="preempt")
                final = from_rank0(mesh, final)
                signame = guard.signame or "a peer rank's signal"
                logger.warning(
                    "preempted by %s at step %d: saved %s — resume with "
                    "--restore_ckpt auto", signame, global_step, final)
                tel.emit("preempt", signal=signame, step=global_step)
                if lead:
                    tel.checkpoint(global_step, final, reason="preempt")
            else:
                if lead:
                    final = save_train_state(
                        cfg.ckpt_dir, cfg.name, state,
                        config_digest=run_digest, reason="final")
                    tel.checkpoint(global_step, final, reason="final")
                final = from_rank0(mesh, final)
        except BaseException as e:
            batches.close()
            loader.close()
            tel.error(e)  # also fires the flight recorder ("crash")
            if lead:  # the ranks hold one state: rank 0 saves it
                _emergency_checkpoint(e, state, cfg, tel, global_step,
                                      run_digest)
            tracer.close()  # spans land before run_end
            tel.emit("run_end", steps=global_step - start_step, ok=False,
                     step=global_step)
            tel.close()
            raise
        finally:
            log.close()
    tel.window_throughput()
    tracer.close()
    tel.emit("run_end", steps=global_step - start_step, ok=True,
             step=global_step,
             **({"reason": "preempt"} if preempted else {}))
    tel.close()
    logger.info("training done: %s (telemetry: %s)", final, tel.events_path)
    return final


def _maybe_validate_things(predictor, cfg: TrainConfig) -> Dict[str, float]:
    """The validate-on-Things hook; skipped when the FlyingThings TEST data
    is not on disk. Frames run one after another (no decode workers inside
    the trainer)."""
    import os.path as osp
    if not osp.isdir(osp.join(cfg.data_root, "FlyingThings3D")):
        logger.info("FlyingThings3D not found under %s; skipping validation",
                    cfg.data_root)
        return {}
    from raft_stereo_tpu_torch.eval.validate import validate_things
    try:
        return validate_things(predictor, root=cfg.data_root,
                               iters=cfg.valid_iters, stream=False)
    except ValueError as e:  # e.g. TEST split not downloaded
        logger.info("skipping validation: %s", e)
        return {}
