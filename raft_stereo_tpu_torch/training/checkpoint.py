"""Full-state checkpoints: parameters, frozen batch-norm statistics,
optimizer state and step (the port's ``raft_stereo_tpu/training/
checkpoint.py``).

A checkpoint restores the model, AdamW's moments, the update count (which
positions the OneCycle schedule) and the step (from which the trainer
repositions the loader exactly: epoch and batch within it, the Philox
keying making the resumed stream the uninterrupted run's). Saves go through
the atomic protocol of :mod:`raft_stereo_tpu_torch.training.resilience`:
``<ckpt_dir>/<step>_<name>`` (or ``<ckpt_dir>/<name>`` for the final one)
holds ``state/train_state.pt`` (one ``torch.save``) and its
``MANIFEST.json``. Restores read it with ``torch.load(weights_only=True)``.
Weights-only reference ``.pth`` files are read by
``utils/weights.load_reference_checkpoint``.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import torch

from raft_stereo_tpu_torch.training.resilience import (atomic_save_train_state,
                                                       checkpoint_state_file)


def save_train_state(ckpt_dir: str, name: str, state: Any,
                     step: Optional[int] = None,
                     config_digest: Optional[str] = None,
                     keep_last: int = 0, keep_every: int = 0,
                     reason: str = "periodic") -> str:
    """Save the full TrainState atomically; returns the checkpoint path.
    ``config_digest`` stamps the manifest (and arms the same-name clobber
    protection); ``keep_last``/``keep_every`` run retention over step
    checkpoints."""
    return atomic_save_train_state(
        ckpt_dir, name, state, step=step, config_digest=config_digest,
        keep_last=keep_last, keep_every=keep_every, reason=reason)


def load_payload(path: str) -> dict:
    """A checkpoint's saved state, on the CPU."""
    return torch.load(checkpoint_state_file(os.path.abspath(path)),
                      map_location="cpu", weights_only=True)


def restore_train_state(path: str, target: Any) -> Any:
    """Restore a checkpoint saved by :func:`save_train_state` into
    ``target`` (a TrainState of the same configuration) in place: the
    model's parameters and buffers (strict), the optimizer's state onto
    the parameters' devices, and the step. Returns ``target``."""
    payload = load_payload(path)
    target.model.load_state_dict(payload["model"], strict=True)
    target.optimizer.load_state_dict(payload["optimizer"])
    target.step = int(payload["step"])
    return target
