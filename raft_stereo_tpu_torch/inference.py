"""Library-style inference API (the port of ``raft_stereo_tpu.inference``).

:class:`StereoPredictor` pads a stereo pair to /32, runs the test-mode
forward under ``torch.inference_mode()`` and unpads the disparity-flow.
It runs on CUDA unless the caller passes ``device="cpu"``; asking for the
card where there is none raises.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from raft_stereo_tpu_torch.config import RAFTStereoConfig
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.ops.geometry import InputPadder

PAD_DIVIS = 32  # every reference eval call site pads to /32


def bucket_size(n: int, divis: int, bucket: int = 0) -> int:
    """Round ``n`` up to a multiple of ``divis`` (and of ``bucket`` if
    given)."""
    if bucket:
        n = -(-n // bucket) * bucket
    return -(-n // divis) * divis


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``: CUDA when None; a CUDA request
    without a CUDA device raises instead of falling back to the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is not "
                           "available; pass device='cpu' to run on the CPU")
    return dev


class StereoPredictor:
    """Stereo inference on one device.

    ``state_dict`` holds the port's weights, e.g. from
    :func:`raft_stereo_tpu_torch.utils.weights.load_reference_checkpoint`
    or :func:`~raft_stereo_tpu_torch.utils.weights.state_dict_from_jax`;
    it is loaded with ``strict=True``.
    """

    def __init__(self, cfg: RAFTStereoConfig,
                 state_dict: Dict[str, torch.Tensor], *,
                 valid_iters: int = 32, bucket: int = 0, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = RAFTStereo(cfg)
        self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device).eval()
        self.valid_iters = valid_iters
        self.bucket = bucket

    def _prepared(self, image1, image2):
        image1 = torch.as_tensor(np.asarray(image1, np.float32),
                                 device=self.device)
        image2 = torch.as_tensor(np.asarray(image2, np.float32),
                                 device=self.device)
        _, h, w, _ = image1.shape
        padder = InputPadder(
            image1.shape, divis_by=PAD_DIVIS,
            target=(bucket_size(h, PAD_DIVIS, self.bucket),
                    bucket_size(w, PAD_DIVIS, self.bucket)))
        im1, im2 = padder.pad(image1, image2)
        return padder, im1, im2

    def _forward(self, im1, im2, iters):
        iters = self.valid_iters if iters is None else iters
        with torch.inference_mode():
            return self.model(im1, im2, iters=iters, test_mode=True)[1]

    def __call__(self, image1: np.ndarray, image2: np.ndarray,
                 iters: Optional[int] = None) -> np.ndarray:
        """Batched NHWC uint8-range images -> flow-x ``(B, H, W, 1)``
        (negative disparity), as numpy."""
        padder, im1, im2 = self._prepared(image1, image2)
        flow_up = self._forward(im1, im2, iters)
        return padder.unpad(flow_up).cpu().numpy()

    def predict_timed(self, image1: np.ndarray, image2: np.ndarray,
                      iters: Optional[int] = None
                      ) -> Tuple[np.ndarray, float]:
        """Like ``__call__`` but also returns the seconds of the forward
        alone: the inputs are on the device before the clock starts, and
        the clock stops after the device has finished (padding and the
        copy back to the host are outside)."""
        padder, im1, im2 = self._prepared(image1, image2)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        flow_up = self._forward(im1, im2, iters)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        return padder.unpad(flow_up).cpu().numpy(), dt

    def compute_disparity(self, left: np.ndarray, right: np.ndarray,
                          iters: Optional[int] = None) -> np.ndarray:
        """One HWC (or HW grayscale) image pair -> positive disparity
        ``(H, W)``."""
        if left.ndim == 2:
            left = np.tile(left[..., None], (1, 1, 3))
            right = np.tile(right[..., None], (1, 1, 3))
        flow = self(left[None].astype(np.float32),
                    right[None].astype(np.float32), iters)
        return -flow[0, ..., 0]
