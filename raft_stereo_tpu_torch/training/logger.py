"""Step-windowed metric logging: console and TensorBoard (the port's copy
of ``raft_stereo_tpu/training/logger.py``).

Running means over ``SUM_FREQ``-step windows go to the console and a
TensorBoard writer, with per-step ``live_loss``/``lr`` scalars and
validation dicts. The writer is optional (torch's, imported when the
logger is made), so training never depends on TensorBoard.
"""

from __future__ import annotations

import logging
from typing import Dict

logger = logging.getLogger(__name__)

SUM_FREQ = 100  # steps per console/TB flush


def _make_writer(log_dir: str):
    try:
        from torch.utils.tensorboard import SummaryWriter
        return SummaryWriter(log_dir=log_dir)
    except Exception:  # tensorboard not installed / not writable
        logger.warning("TensorBoard writer unavailable; console logging only")
        return None


class Logger:
    """The reference Logger's surface, optionally mirrored onto the
    telemetry bus: with ``telemetry`` (a
    :class:`raft_stereo_tpu_torch.obs.Telemetry`) validation dicts become
    ``validation`` records too."""

    def __init__(self, log_dir: str = "runs", total_steps: int = 0,
                 telemetry=None):
        self.total_steps = total_steps
        self.running: Dict[str, float] = {}
        self.window = 0  # pushes since the last flush (< SUM_FREQ on resume)
        self.writer = _make_writer(log_dir)
        self.telemetry = telemetry

    def _flush(self, lr: float):
        keys = sorted(self.running)
        means = {k: self.running[k] / max(self.window, 1) for k in keys}
        stats = ", ".join(f"{k}={means[k]:10.4f}" for k in keys)
        logger.info("[step %6d, lr %10.7f] %s", self.total_steps, lr, stats)
        if self.writer is not None:
            for k in keys:
                self.writer.add_scalar(k, means[k], self.total_steps)
        self.running = {}
        self.window = 0

    def push(self, metrics: Dict[str, float], lr: float = 0.0):
        """Accumulate one step's metrics; flush every SUM_FREQ steps."""
        self.total_steps += 1
        self.window += 1
        for k, v in metrics.items():
            self.running[k] = self.running.get(k, 0.0) + float(v)
        if self.writer is not None:
            if "loss" in metrics:
                self.writer.add_scalar("live_loss", float(metrics["loss"]),
                                       self.total_steps)
            self.writer.add_scalar("lr", lr, self.total_steps)
        if self.total_steps % SUM_FREQ == 0:
            self._flush(lr)

    def write_dict(self, results: Dict[str, float]):
        """Log a validation-results dict."""
        logger.info("validation: %s", results)
        if self.writer is not None:
            for k, v in results.items():
                self.writer.add_scalar(k, float(v), self.total_steps)
        if self.telemetry is not None:
            self.telemetry.validation(results)

    def close(self):
        if self.writer is not None:
            self.writer.close()
