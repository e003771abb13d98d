"""Library-style inference API (the port of ``raft_stereo_tpu.inference``).

:class:`StereoPredictor` pads a stereo pair to /32, runs the test-mode
forward under ``torch.inference_mode()`` and unpads the disparity-flow.
It runs on CUDA unless the caller passes ``device="cpu"``; asking for the
card where there is none raises. :meth:`StereoPredictor.predict_async`
enqueues a forward and returns a :class:`PendingPrediction` at once, so a
caller keeps several frames in flight (eval/stream.py).

On the card every input goes through a pinned host buffer and an
asynchronous copy: a copy from pageable memory blocks the host until the
card's queue has drained, which would serialise a streamed evaluation.
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


class PendingPrediction:
    """Handle for an in-flight :meth:`StereoPredictor.predict_async` call.

    On the card the unpadded flow is copied into a pinned host buffer
    without blocking and an event is recorded after the copy; the device
    output and the staged inputs stay referenced here until the result is
    fetched, so no buffer is freed or reused while the card still reads or
    writes it.
    """

    def __init__(self, flow: torch.Tensor, host: torch.Tensor,
                 done: Optional["torch.cuda.Event"], dispatch_s: float,
                 staged: Tuple[torch.Tensor, ...] = ()):
        self._flow = flow
        self._host = host
        self._done = done
        self._staged = staged
        self._result: Optional[np.ndarray] = None
        self._error: Optional[BaseException] = None
        #: host seconds spent inside the dispatching call (enqueue, not
        #: device time)
        self.dispatch_s = dispatch_s
        #: host seconds :meth:`result` spent blocked on the fetch
        self.fetch_s: Optional[float] = None

    def ready(self) -> bool:
        """Non-blocking completion probe: True when :meth:`result` would
        not block."""
        if self._result is not None:
            return True
        if self._error is not None:
            return False
        try:
            return self._done is None or self._done.query()
        except RuntimeError:
            return False

    def exception(self) -> Optional[BaseException]:
        """The deferred device/fetch error this handle captured, if any
        (without re-raising). None while unfetched or on success."""
        return self._error

    def result(self) -> np.ndarray:
        """Block until the dispatch completes; unpadded ``(B, H, W, 1)``
        flow-x as numpy. Idempotent — later calls return the cached fetch.

        A device-side error of the asynchronous forward surfaces HERE: it
        is captured once and re-raised on this and every later call, with
        the buffers released."""
        if self._error is not None:
            raise self._error
        if self._result is None:
            t0 = time.perf_counter()
            try:
                if self._done is not None:
                    self._done.synchronize()
                self._result = self._host.numpy()
            except Exception as exc:
                self._error = exc
                raise
            finally:
                self.fetch_s = time.perf_counter() - t0
                self._flow, self._host, self._staged = None, None, ()
        return self._result

    def aux_result(self) -> None:
        """The convergence/numerics aux outputs: none until the port's
        model has them (ROADMAP A11)."""
        return None


def stage(array, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(float32 tensor on device, host tensor it came from)``. The host
    copy has standard strides whatever the array's (a strided view can
    steer the CPU's convolutions to other kernels); on the card it is
    pinned and the copy to the card asynchronous, so the host tensor must
    live until that copy has run."""
    src = torch.from_numpy(np.ascontiguousarray(array))
    host = torch.empty(src.shape, dtype=src.dtype,
                       pin_memory=device.type == "cuda")
    host.copy_(src)
    return host.to(device, non_blocking=True).float(), host


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
        (image1, staged1), (image2, staged2) = (stage(image1, self.device),
                                                stage(image2, self.device))
        _, h, w, _ = image1.shape
        padder = InputPadder(
            image1.shape, divis_by=PAD_DIVIS,
            target=(bucket_size(h, PAD_DIVIS, self.bucket),
                    bucket_size(w, PAD_DIVIS, self.bucket)))
        im1, im2 = padder.pad(image1, image2)
        return padder, im1, im2, (staged1, staged2)

    def _forward(self, im1, im2, iters):
        iters = self.valid_iters if iters is None else iters
        with torch.inference_mode():
            return self.model(im1, im2, iters=iters, test_mode=True)[1]

    def __call__(self, image1: np.ndarray, image2: np.ndarray,
                 iters: Optional[int] = None) -> np.ndarray:
        """Batched NHWC uint8-range images -> flow-x ``(B, H, W, 1)``
        (negative disparity), as numpy."""
        padder, im1, im2, _ = self._prepared(image1, image2)
        flow_up = self._forward(im1, im2, iters)
        return padder.unpad(flow_up).cpu().numpy()

    def predict_timed(self, image1: np.ndarray, image2: np.ndarray,
                      iters: Optional[int] = None
                      ) -> Tuple[np.ndarray, float]:
        """Like ``__call__`` but also returns the seconds of the forward
        alone: the inputs are on the device before the clock starts, and
        the clock stops after the device has finished (padding and the
        copy back to the host are outside)."""
        padder, im1, im2, _ = self._prepared(image1, image2)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        flow_up = self._forward(im1, im2, iters)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        return padder.unpad(flow_up).cpu().numpy(), dt

    def predict_async(self, image1: np.ndarray, image2: np.ndarray,
                      iters: Optional[int] = None) -> PendingPrediction:
        """Enqueue one batched forward and return without waiting for it.

        On the card the inputs are staged through pinned buffers and copied
        asynchronously, the forward is enqueued, the unpadded flow is copied
        into a pinned host buffer asynchronously and an event is recorded
        after that copy; nothing blocks on the card. On the CPU the forward
        runs here and the handle is complete. The handle's ``result()``
        gives what ``__call__`` gives for the same inputs."""
        t0 = time.perf_counter()
        padder, im1, im2, staged = self._prepared(image1, image2)
        flow = padder.unpad(self._forward(im1, im2, iters))
        done = None
        if self.device.type == "cuda":
            host = torch.empty(flow.shape, dtype=flow.dtype, pin_memory=True)
            host.copy_(flow, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            host = flow
        return PendingPrediction(flow, host, done, time.perf_counter() - t0,
                                 staged)

    def take_aux(self) -> None:
        """The last synchronous call's convergence aux: none until the
        port's model has one (ROADMAP A11)."""
        return None

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
