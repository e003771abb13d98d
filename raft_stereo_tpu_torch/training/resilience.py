"""Fault tolerance for long training runs (the port's copy of
``raft_stereo_tpu/training/resilience.py``): atomic checkpoints with
integrity manifests, auto-resume, preemption signals, and the host side
of the anomaly guard.

* **Atomic writes**: the state is saved into a hidden temp directory next
  to the final path (``state/train_state.pt``, one ``torch.save``), a
  ``MANIFEST.json`` (step, config digest, state-structure hash, per-file
  size and crc32) is written beside it, everything is fsynced, and one
  ``os.rename`` publishes the checkpoint. A reader never sees a partially
  written checkpoint under its final name.
* **Integrity**: :func:`verify_checkpoint` re-walks the files against the
  manifest and checks the digest and structure hash, so
  ``--restore_ckpt auto`` (:func:`find_latest_valid`) resumes from the
  newest checkpoint that is valid, skipping truncated, corrupt and foreign
  ones with a recorded reason (``ckpt_integrity`` records).
* **Retention**: keep the last K step checkpoints and every one whose step
  is a multiple of N (:func:`apply_retention`); the final stepless
  checkpoint and ``.bak`` rotations are never swept.
* **Clobber protection**: a mismatched (or missing) config digest rotates
  an existing target to ``<name>.bak`` instead of deleting it.
* **Preemption**: :class:`SignalGuard` turns SIGTERM/SIGINT into a "save
  and exit" flag the trainer polls once a step.
* **Anomaly policy**: the step skips the optimizer update on a non-finite
  loss or gradient norm (training/state.py); :class:`AnomalyPolicy` counts
  consecutive skips from the step metrics and halts the run
  (:class:`AnomalyHalt`) after M in a row.

The state here is the port's training state: a
:class:`~raft_stereo_tpu_torch.training.state.TrainState` (model,
optimizer, step), or its payload, a nested dict of tensors and numbers
(:func:`state_payload`).
"""

from __future__ import annotations

import dataclasses
import datetime
import hashlib
import json
import logging
import os
import re
import shutil
import signal
import threading
import zlib
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

logger = logging.getLogger(__name__)

MANIFEST_NAME = "MANIFEST.json"
STATE_SUBDIR = "state"
STATE_FILE = "train_state.pt"
MANIFEST_FORMAT = 1

#: TrainConfig fields that identify "the same training run" for the clobber
#: and auto-resume digests: the ones that shape the state, the optimizer
#: trajectory or the data stream. Cosmetic fields (name, directories,
#: cadences, worker counts) are left out: changing them must not orphan a
#: run's checkpoints.
_DIGEST_TRAIN_FIELDS = (
    "batch_size", "train_datasets", "lr", "num_steps", "image_size",
    "train_iters", "wdecay", "seed", "grad_accum_steps", "spatial_scale",
    "saturation_range", "img_gamma", "do_flip", "noyjitter",
)


# --- identity: config digest + state structure hash ---------------------------

def config_digest(model_cfg: Any, train_cfg: Any = None) -> str:
    """Stable 16-hex digest of the model config (and the stream/optimizer-
    defining train fields): the checkpoint's run-identity stamp."""
    doc: Dict[str, Any] = {"model": dataclasses.asdict(model_cfg)}
    if train_cfg is not None:
        t = dataclasses.asdict(train_cfg)
        doc["train"] = {k: t[k] for k in _DIGEST_TRAIN_FIELDS if k in t}
    blob = json.dumps(doc, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def state_payload(state: Any) -> Dict[str, Any]:
    """What a checkpoint holds of a TrainState: the model's state dict
    (parameters and frozen batch-norm statistics), the optimizer's state
    (``Optimizer.state_dict``: AdamW's moments, the update count that
    positions the LR schedule, any gradient accumulation) and the step
    (batches consumed, which positions the data stream). A payload passes
    through unchanged."""
    if isinstance(state, dict):
        return state
    return {"model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": int(state.step)}


def _leaves(tree: Any, path: str = ""):
    """``(path, leaf)`` pairs of a nested dict/list, in a fixed order."""
    if isinstance(tree, dict):
        for k in sorted(tree, key=str):
            yield from _leaves(tree[k], f"{path}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")
    else:
        yield path, tree


def tree_structure_hash(state: Any) -> str:
    """16-hex digest of the state's structure: every leaf's path, shape and
    dtype (metadata only). A restore into a state of another structure
    would fail or mis-map, so the manifest records it and auto-resume
    filters on it."""
    desc = []
    for path, leaf in _leaves(state_payload(state)):
        if isinstance(leaf, (torch.Tensor, np.ndarray)):
            dtype = str(leaf.dtype).replace("torch.", "")
            desc.append(f"{path}:{tuple(leaf.shape)}:{dtype}")
        else:
            desc.append(f"{path}:{type(leaf).__name__}")
    return hashlib.sha256("\n".join(desc).encode()).hexdigest()[:16]


# --- atomic checkpoint protocol ----------------------------------------------

def _file_inventory(root: str) -> Dict[str, Dict[str, int]]:
    """relpath -> {bytes, crc32} for every file under ``root`` (sorted)."""
    out: Dict[str, Dict[str, int]] = {}
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames.sort()
        for fname in sorted(filenames):
            path = os.path.join(dirpath, fname)
            out[os.path.relpath(path, root)] = {
                "bytes": os.path.getsize(path), "crc32": _crc32(path)}
    return out


def _crc32(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 20)
            if not chunk:
                return crc
            crc = zlib.crc32(chunk, crc)


def _fsync_path(path: str) -> None:
    try:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
    except OSError:
        pass


def _fsync_tree(root: str) -> None:
    """fsync every file and directory under ``root`` (then ``root``) so the
    rename that follows publishes durable bytes."""
    for dirpath, _dirnames, filenames in os.walk(root, topdown=False):
        for fname in filenames:
            _fsync_path(os.path.join(dirpath, fname))
        _fsync_path(dirpath)


def load_manifest(ckpt_path: str) -> Optional[Dict[str, Any]]:
    """A checkpoint's manifest; None when absent or unreadable."""
    try:
        with open(os.path.join(ckpt_path, MANIFEST_NAME)) as f:
            doc = json.load(f)
    except (OSError, json.JSONDecodeError):
        return None
    return doc if isinstance(doc, dict) else None


def checkpoint_state_file(ckpt_path: str) -> str:
    return os.path.join(ckpt_path, STATE_SUBDIR, STATE_FILE)


def atomic_save_train_state(ckpt_dir: str, name: str, state: Any,
                            step: Optional[int] = None, *,
                            config_digest: Optional[str] = None,
                            keep_last: int = 0, keep_every: int = 0,
                            reason: str = "periodic") -> str:
    """Write ``<ckpt_dir>/<step>_<name>`` (or ``<ckpt_dir>/<name>`` when
    ``step`` is None) atomically: temp dir -> ``torch.save`` -> manifest ->
    fsync -> rename. Returns the published path.

    When the target exists: a matching ``config_digest`` (the same run,
    e.g. the final save of a resumed run) is replaced in place; a
    mismatched or missing one rotates the stranger to ``<target>.bak``.
    ``keep_last``/``keep_every`` sweep step checkpoints after a publish.
    """
    ckpt_dir = os.path.abspath(ckpt_dir)
    os.makedirs(ckpt_dir, exist_ok=True)
    tag = name if step is None else f"{step}_{name}"
    final = os.path.join(ckpt_dir, tag)
    tmp = os.path.join(ckpt_dir, f".{tag}.tmp.{os.getpid()}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)

    payload = state_payload(state)
    try:
        os.makedirs(os.path.join(tmp, STATE_SUBDIR))
        torch.save(payload, checkpoint_state_file(tmp))
        step_val = int(payload.get("step", -1)) if step is None \
            else int(step)
        manifest = {
            "format": MANIFEST_FORMAT,
            "name": name,
            "step": step_val,
            "config_digest": config_digest,
            "tree_hash": tree_structure_hash(payload),
            "reason": reason,
            "saved_at": datetime.datetime.now().isoformat(
                timespec="seconds"),
            "files": _file_inventory(os.path.join(tmp, STATE_SUBDIR)),
        }
        with open(os.path.join(tmp, MANIFEST_NAME), "w") as f:
            json.dump(manifest, f, indent=2, sort_keys=True)
            f.write("\n")
            f.flush()
            os.fsync(f.fileno())
        _fsync_tree(tmp)

        trash = None
        if os.path.exists(final):
            existing = load_manifest(final)
            existing_digest = (existing or {}).get("config_digest")
            if config_digest is not None and (
                    existing is None or existing_digest != config_digest):
                # another run (or a stranger without a manifest) owns this
                # name: rotate it aside instead of destroying its work
                bak = final + ".bak"
                if os.path.exists(bak):
                    shutil.rmtree(bak)
                os.rename(final, bak)
                logger.warning(
                    "checkpoint %s existed with a different config digest "
                    "(%s != %s); rotated it to %s", final,
                    existing_digest, config_digest, bak)
            else:
                trash = final + f".old.{os.getpid()}"
                if os.path.exists(trash):
                    shutil.rmtree(trash)
                os.rename(final, trash)
        os.rename(tmp, final)
        _fsync_path(ckpt_dir)
        if trash is not None:
            shutil.rmtree(trash, ignore_errors=True)
    finally:
        if os.path.exists(tmp):
            shutil.rmtree(tmp, ignore_errors=True)

    if step is not None and keep_last > 0:
        apply_retention(ckpt_dir, name, keep_last=keep_last,
                        keep_every=keep_every)
    return final


# --- verification + auto-resume ----------------------------------------------

def verify_checkpoint(ckpt_path: str, config_digest: Optional[str] = None,
                      tree_hash: Optional[str] = None
                      ) -> Tuple[bool, Optional[str],
                                 Optional[Dict[str, Any]]]:
    """``(ok, failure reason, manifest)`` for one checkpoint directory:
    manifest present and of a known format, state directory present, every
    listed file present with its size and crc32, and, where given, the
    config digest and structure hash."""
    manifest = load_manifest(ckpt_path)
    if manifest is None:
        return False, "missing or unparseable manifest", None
    if manifest.get("format") != MANIFEST_FORMAT:
        return False, f"unknown manifest format {manifest.get('format')!r}", \
            manifest
    state_dir = os.path.join(ckpt_path, STATE_SUBDIR)
    if not os.path.isdir(state_dir):
        return False, "state directory missing", manifest
    files = manifest.get("files")
    if not isinstance(files, dict) or not files:
        return False, "manifest lists no files", manifest
    for rel, meta in sorted(files.items()):
        path = os.path.join(state_dir, rel)
        if not os.path.isfile(path):
            return False, f"file missing: {rel}", manifest
        size = os.path.getsize(path)
        if size != meta.get("bytes"):
            return False, (f"size mismatch: {rel} is {size} bytes, "
                           f"manifest says {meta.get('bytes')}"), manifest
        if _crc32(path) != meta.get("crc32"):
            return False, f"crc mismatch: {rel}", manifest
    if config_digest is not None \
            and manifest.get("config_digest") is not None \
            and manifest["config_digest"] != config_digest:
        return False, (f"config digest mismatch "
                       f"({manifest['config_digest']} != {config_digest})"), \
            manifest
    if tree_hash is not None and manifest.get("tree_hash") is not None \
            and manifest["tree_hash"] != tree_hash:
        return False, (f"state structure mismatch "
                       f"({manifest['tree_hash']} != {tree_hash})"), manifest
    return True, None, manifest


def scan_checkpoints(ckpt_dir: str, name: str) -> List[str]:
    """Candidate checkpoint paths for one run name, newest first:
    ``<step>_<name>`` by step, the stepless final by its manifest step
    (outranking a step checkpoint at the same step; without a manifest it
    sorts oldest)."""
    if not os.path.isdir(ckpt_dir):
        return []
    pat = re.compile(rf"^(\d+)_{re.escape(name)}$")
    ranked: List[Tuple[int, int, str]] = []
    for entry in os.listdir(ckpt_dir):
        path = os.path.join(ckpt_dir, entry)
        if not os.path.isdir(path):
            continue
        m = pat.match(entry)
        if m:
            ranked.append((int(m.group(1)), 0, path))
        elif entry == name:
            manifest = load_manifest(path) or {}
            ranked.append((int(manifest.get("step", -1)), 1, path))
    ranked.sort(reverse=True)
    return [path for _step, _pri, path in ranked]


def find_latest_valid(ckpt_dir: str, name: str,
                      config_digest: Optional[str] = None,
                      tree_hash: Optional[str] = None
                      ) -> Tuple[Optional[str], List[Dict[str, Any]]]:
    """``--restore_ckpt auto``: the newest checkpoint that verifies, and
    one ``ckpt_integrity`` payload (``path``/``ok``/``step``, ``reason`` on
    failure) for each candidate tried; the scan stops at the first valid
    one."""
    reports: List[Dict[str, Any]] = []
    for path in scan_checkpoints(ckpt_dir, name):
        ok, reason, manifest = verify_checkpoint(
            path, config_digest=config_digest, tree_hash=tree_hash)
        report: Dict[str, Any] = {
            "path": path, "ok": bool(ok),
            "step": (manifest or {}).get("step")}
        if not ok:
            report["reason"] = reason
            logger.warning("skipping checkpoint %s: %s", path, reason)
        reports.append(report)
        if ok:
            return path, reports
    return None, reports


def apply_retention(ckpt_dir: str, name: str, keep_last: int,
                    keep_every: int = 0) -> List[str]:
    """Delete step checkpoints beyond the newest ``keep_last``, sparing any
    whose step is a positive multiple of ``keep_every`` (0: none). Returns
    the deleted paths."""
    if keep_last <= 0:
        return []
    pat = re.compile(rf"^(\d+)_{re.escape(name)}$")
    steps: List[Tuple[int, str]] = []
    for entry in os.listdir(ckpt_dir) if os.path.isdir(ckpt_dir) else []:
        m = pat.match(entry)
        if m and os.path.isdir(os.path.join(ckpt_dir, entry)):
            steps.append((int(m.group(1)), os.path.join(ckpt_dir, entry)))
    steps.sort(reverse=True)
    deleted: List[str] = []
    for step, path in steps[keep_last:]:
        if keep_every > 0 and step % keep_every == 0:
            continue
        shutil.rmtree(path, ignore_errors=True)
        deleted.append(path)
        logger.info("retention: removed %s", path)
    return deleted


# --- preemption --------------------------------------------------------------

class SignalGuard:
    """Cooperative SIGTERM/SIGINT handling for the training loop: entering
    installs handlers that record the signal; the trainer polls
    :attr:`requested` once a step and runs the save-and-exit path. A second
    SIGINT raises ``KeyboardInterrupt``, so a wedged save can still be
    interrupted. Outside the main thread the guard is an inert flag."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = tuple(signals)
        self._prev: Dict[int, Any] = {}
        self._received: Optional[int] = None
        self._lock = threading.Lock()
        self.installed = False

    def _handle(self, signum, frame):
        with self._lock:
            first = self._received is None
            if not first and signum == signal.SIGINT:
                raise KeyboardInterrupt
            self._received = signum
        if first:
            logger.warning(
                "received %s: finishing the current step, then saving a "
                "preemption checkpoint and exiting", self.signame)

    def __enter__(self) -> "SignalGuard":
        try:
            for s in self._signals:
                self._prev[s] = signal.signal(s, self._handle)
            self.installed = True
        except ValueError:
            self._prev.clear()
            logger.warning("SignalGuard inactive (not in main thread); "
                           "preemption signals will use default handling")
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except ValueError:
                pass
        self._prev.clear()
        self.installed = False

    @property
    def requested(self) -> bool:
        return self._received is not None

    @property
    def signame(self) -> Optional[str]:
        if self._received is None:
            return None
        try:
            return signal.Signals(self._received).name
        except ValueError:
            return str(self._received)


# --- anomaly policy (host side of the step's guard) ---------------------------

class AnomalyHalt(RuntimeError):
    """M consecutive optimizer updates were skipped on non-finite gradients.
    The trainer writes no emergency checkpoint for it: the rollback target
    is the last durable checkpoint from before the streak."""


class AnomalyPolicy:
    """Counts consecutive skipped updates and halts past the cap.

    ``observe`` is fed from the step metrics (``skipped_updates``,
    ``grad_norm``); it emits one ``anomaly`` record a skip and raises
    :class:`AnomalyHalt` when ``max_consecutive`` skips land in a row (0:
    never halt)."""

    def __init__(self, max_consecutive: int = 10, telemetry=None):
        self.max_consecutive = int(max_consecutive)
        self.telemetry = telemetry
        self.consecutive = 0
        self.total = 0

    def observe(self, skipped: bool, step: int,
                grad_norm: Optional[float] = None,
                top_leaves=None) -> None:
        """``top_leaves``: the ``[[leaf_name, norm-or-None], ...]`` offender
        ranking from the per-leaf norms, riding the ``anomaly`` record."""
        if not skipped:
            self.consecutive = 0
            return
        self.consecutive += 1
        self.total += 1
        logger.warning(
            "step %d: non-finite gradients (grad_norm=%s%s) — optimizer "
            "update skipped (%d consecutive, %d total)",
            step, grad_norm,
            "" if not top_leaves else f", worst leaves {top_leaves[:3]}",
            self.consecutive, self.total)
        if self.telemetry is not None:
            extra = {} if top_leaves is None else {
                "top_leaves": [[str(n), v] for n, v in top_leaves]}
            self.telemetry.emit(
                "anomaly", kind="nonfinite_grad", step=int(step),
                grad_norm=None if grad_norm is None else float(grad_norm),
                consecutive=self.consecutive, skipped_total=self.total,
                **extra)
        if 0 < self.max_consecutive <= self.consecutive:
            if self.telemetry is not None:
                self.telemetry.emit(
                    "anomaly", kind="halt", step=int(step),
                    consecutive=self.consecutive,
                    skipped_total=self.total)
            raise AnomalyHalt(
                f"{self.consecutive} consecutive non-finite-gradient steps "
                f"at step {step}: halting for rollback to the last valid "
                f"checkpoint (anomaly_max_skips={self.max_consecutive})")


def state_is_finite(state: Any) -> bool:
    """Whether every floating parameter of the state is finite: the crash
    path's gate that keeps a poisoned state out of an emergency
    checkpoint. A TrainState's model parameters, or every floating leaf of
    a payload's ``model`` entry (of the whole tree without one)."""
    if hasattr(state, "model"):
        leaves = [p.detach() for p in state.model.parameters()]
    else:
        tree = state.get("model", state) if isinstance(state, dict) \
            else state
        leaves = [leaf for _, leaf in _leaves(tree)]
    for leaf in leaves:
        if isinstance(leaf, torch.Tensor):
            if leaf.is_floating_point() and \
                    not bool(torch.isfinite(leaf).all()):
                return False
        elif isinstance(leaf, np.ndarray) and \
                np.issubdtype(leaf.dtype, np.floating) and \
                not np.all(np.isfinite(leaf)):
            return False
    return True


# --- fault injection (the drill's hooks) ---------------------------------------

#: at this (1-based) global step the trainer overwrites the batch's images
#: with NaN, forcing a non-finite loss and gradient, so a drill can show
#: that the guard skips the update and the run survives.
FAULT_NAN_STEP_ENV = "RAFT_FAULT_NAN_STEP"


def injected_nan_step() -> Optional[int]:
    val = os.environ.get(FAULT_NAN_STEP_ENV)
    if not val:
        return None
    try:
        return int(val)
    except ValueError:
        logger.warning("ignoring unparseable %s=%r", FAULT_NAN_STEP_ENV, val)
        return None


#: a multi-host drill sets this on one trainer: sleep this many seconds in
#: every step's dispatch leg, making that host a deterministic straggler.
FAULT_SLEEP_ENV = "RAFT_FAULT_SLEEP_S"


def injected_sleep_s() -> Optional[float]:
    val = os.environ.get(FAULT_SLEEP_ENV)
    if not val:
        return None
    try:
        return float(val)
    except ValueError:
        logger.warning("ignoring unparseable %s=%r", FAULT_SLEEP_ENV, val)
        return None
