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

The predictor can also return the forward's per-iteration outputs, as the
JAX package's does: ``converge`` the per-sample residual curves,
``iter_epe`` the EPE curves against a GT the caller passes, ``numerics``
the tap statistics, and ``iter_policy`` runs the early exit with each
padded bucket's recorded ``(tau, budget, min_iters)`` and adds
``iters_taken``. They come back from :meth:`StereoPredictor.take_aux`
after a synchronous call and from :meth:`PendingPrediction.aux_result`
after an asynchronous one; on the card they are copied to pinned host
buffers behind the flow, under the same event, so nothing waits for them
at dispatch.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from raft_stereo_tpu_torch.config import RAFTStereoConfig
from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo
from raft_stereo_tpu_torch.obs.converge import (load_policy, policy_digest,
                                                policy_lookup)
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
                 staged: Tuple[torch.Tensor, ...] = (),
                 aux: Optional[Tuple[Any, Any]] = None):
        self._flow = flow
        self._host = host
        self._done = done
        self._staged = staged
        # (device aux, its host copies): the device half lives until the
        # handle retires, the host half until aux_result() reads it
        self._aux_dev, self._aux_host = aux if aux is not None else (None,
                                                                     None)
        self._aux_np: Optional[Dict[str, Any]] = None
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
                self._aux_dev = None
        return self._result

    def aux_result(self) -> Optional[Dict[str, Any]]:
        """The per-iteration outputs as numpy (``{"residual": (iters, B)``,
        ``"epe"``, ``"iters_taken": (B,)``, ``"numerics": {tap: (iters,
        6)}}``, those the predictor was asked for), or None without them.
        Blocks like :meth:`result` (and raises its error); fetched once."""
        if self._aux_host is not None and self._aux_np is None:
            self.result()
            self._aux_np = {k: host_numpy(v)
                            for k, v in self._aux_host.items()}
            self._aux_host = None
        return self._aux_np


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


def host_copy(t, pinned: bool):
    """A host copy of ``t`` to read once an event recorded after this call
    has completed: a pinned buffer filled by an asynchronous copy (on the
    card, ``pinned``), or ``t`` itself. A dict of tensors (the numerics
    taps) goes as its keys and one stacked copy."""
    if isinstance(t, dict):
        keys = list(t)
        return keys, host_copy(torch.stack([t[k] for k in keys]), pinned)
    if not pinned:
        return t
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t, non_blocking=True)
    return h


def host_numpy(h):
    """:func:`host_copy`'s result as numpy (a tensor still on the card is
    copied here, synchronously)."""
    if isinstance(h, tuple):
        keys, stack = h
        arr = stack.cpu().numpy()
        return {k: arr[i] for i, k in enumerate(keys)}
    return h.cpu().numpy()


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
    it is loaded with ``strict=True``. ``converge``, ``iter_epe``,
    ``numerics``, ``iter_policy`` (a path or a loaded doc; loading lints
    it) and ``adaptive`` (None: on iff a policy is given) select the
    per-iteration outputs, with the JAX package's defaults, implications
    and guards.
    """

    def __init__(self, cfg: RAFTStereoConfig,
                 state_dict: Dict[str, torch.Tensor], *,
                 valid_iters: int = 32, bucket: int = 0, device=None,
                 converge: bool = False, iter_epe: bool = False,
                 numerics: bool = False, iter_policy=None,
                 adaptive: Optional[bool] = None):
        self.cfg = cfg
        self._policy = None
        self.policy_digest: Optional[str] = None
        if iter_policy is not None:
            self._policy = (load_policy(iter_policy)
                            if isinstance(iter_policy, str) else iter_policy)
            self.policy_digest = policy_digest(self._policy)
        self.adaptive = (bool(adaptive) if adaptive is not None
                         else self._policy is not None)
        if self.adaptive and self._policy is None:
            raise ValueError("adaptive=True needs an iter_policy (the "
                             "thresholds and budgets come from a recorded "
                             "policy: python -m "
                             "raft_stereo_tpu_torch.obs.converge "
                             "--emit-policy)")
        if self.adaptive and numerics:
            raise ValueError("numerics taps are not supported on the "
                             "adaptive path (models/raft_stereo.py); "
                             "record numerics with adaptive=False")
        #: per-sample residual curves (implied by adaptive and iter_epe)
        self.converge = converge or self.adaptive or iter_epe
        #: per-iteration EPE against a GT the caller passes
        self.iter_epe = iter_epe
        #: per-iteration tap statistics
        self.numerics = numerics
        self.device = resolve_device(device)
        self.model = RAFTStereo(cfg)
        self.model.load_state_dict(state_dict, strict=True)
        self.model.to(self.device).eval()
        self.valid_iters = valid_iters
        self.bucket = bucket
        self._last_aux: Optional[Dict[str, Any]] = None
        # whether the last dispatch ran a policy entry (an uncovered
        # bucket runs the fixed loop, so the aux layout is per dispatch)
        self._adaptive_used = False

    def policy_entry(self, height: int, width: int) -> Optional[Dict]:
        """The policy entry the padded bucket of a raw ``(height, width)``
        resolves to (``{"tau", "budget", "min_iters", ...}``), or None
        without a policy or when it covers neither the bucket nor a
        default."""
        if self._policy is None:
            return None
        key = "%dx%d" % (bucket_size(height, PAD_DIVIS, self.bucket),
                         bucket_size(width, PAD_DIVIS, self.bucket))
        return policy_lookup(self._policy, key)

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

    def _prepared_gt(self, padder, flow_gt, valid):
        """``((flow_gt, valid) padded on the device, staged host
        tensors)`` for the iter-EPE output, or ``((), ())`` when it is
        off or no GT was given. Zero padding: replicated edges would
        count as valid GT."""
        if not (self.iter_epe and flow_gt is not None):
            return (), ()
        g, hg = stage(flow_gt, self.device)
        if valid is None:
            return tuple(padder.pad_zeros(g, torch.ones_like(g))), (hg,)
        v, hv = stage(np.asarray(valid, np.float32).reshape(g.shape),
                      self.device)
        return tuple(padder.pad_zeros(g, v)), (hg, hv)

    def _forward(self, im1, im2, iters, gt=()):
        """The test-mode forward as this predictor runs it: the policy
        entry of the padded bucket (its budget capping ``iters``) or the
        fixed loop, with the outputs asked for."""
        iters = self.valid_iters if iters is None else iters
        entry = None
        if self.adaptive:
            entry = policy_lookup(self._policy, "%dx%d" % tuple(
                im1.shape[1:3]))
            if entry is not None:
                iters = (min(iters, int(entry["budget"])) if iters
                         else int(entry["budget"]))
        self._adaptive_used = entry is not None
        kw: Dict[str, Any] = {}
        if self.converge:
            kw["iter_metrics"] = "per_sample"
            if gt:
                kw["flow_gt"], kw["loss_mask"] = gt
        if entry is not None:
            kw["adaptive_tau"] = float(entry["tau"])
            kw["adaptive_min_iters"] = int(entry["min_iters"])
        elif self.numerics:
            kw["numerics"] = True
        with torch.inference_mode():
            return self.model(im1, im2, iters=iters, test_mode=True, **kw)

    def _aux_of(self, outs) -> Optional[Dict[str, Any]]:
        """The outputs after ``(flow_lowres, flow_up)`` as a dict, in the
        model's order: residual, epe where GT was given, iters_taken on
        the adaptive path, the numerics dict last."""
        if not (self.converge or self.numerics):
            return None
        rest = list(outs[2:])
        aux: Dict[str, Any] = {}
        if self.numerics:
            aux["numerics"] = rest.pop()
        if self._adaptive_used:
            aux["iters_taken"] = rest.pop()
        if self.converge:
            aux["residual"] = rest[0]
            if len(rest) > 1:
                aux["epe"] = rest[1]
        return aux

    def _stash_aux(self, outs) -> None:
        aux = self._aux_of(outs)
        if aux is not None:
            # after the flow's fetch: the device has finished
            self._last_aux = {k: host_numpy(host_copy(v, False))
                              for k, v in aux.items()}

    def take_aux(self) -> Optional[Dict[str, Any]]:
        """Pop the per-iteration outputs of the last synchronous call
        (``__call__``/``predict_timed``) as numpy, or None without them.
        The asynchronous path carries its own on the handle
        (:meth:`PendingPrediction.aux_result`)."""
        aux, self._last_aux = self._last_aux, None
        return aux

    def __call__(self, image1: np.ndarray, image2: np.ndarray,
                 iters: Optional[int] = None, flow_gt=None,
                 valid=None) -> np.ndarray:
        """Batched NHWC uint8-range images -> flow-x ``(B, H, W, 1)``
        (negative disparity), as numpy. ``flow_gt``/``valid`` feed the
        iter-EPE output (read only with ``iter_epe=True``)."""
        padder, im1, im2, _ = self._prepared(image1, image2)
        gt, _ = self._prepared_gt(padder, flow_gt, valid)
        outs = self._forward(im1, im2, iters, gt)
        flow = padder.unpad(outs[1]).cpu().numpy()
        self._stash_aux(outs)
        return flow

    def predict_timed(self, image1: np.ndarray, image2: np.ndarray,
                      iters: Optional[int] = None, flow_gt=None,
                      valid=None) -> Tuple[np.ndarray, float]:
        """Like ``__call__`` but also returns the seconds of the forward
        alone: the inputs are on the device before the clock starts, and
        the clock stops after the device has finished (padding and the
        copies back to the host are outside)."""
        padder, im1, im2, _ = self._prepared(image1, image2)
        gt, _ = self._prepared_gt(padder, flow_gt, valid)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        outs = self._forward(im1, im2, iters, gt)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        flow = padder.unpad(outs[1]).cpu().numpy()
        self._stash_aux(outs)
        return flow, dt

    def predict_async(self, image1: np.ndarray, image2: np.ndarray,
                      iters: Optional[int] = None, flow_gt=None,
                      valid=None) -> PendingPrediction:
        """Enqueue one batched forward and return without waiting for it.

        On the card the inputs are staged through pinned buffers and copied
        asynchronously, the forward is enqueued, the unpadded flow (and
        the per-iteration outputs) are copied into pinned host buffers
        asynchronously and an event is recorded after those copies;
        nothing blocks on the card (the ``while_loop`` early exit reads
        its freeze mask on the host each iteration, which does). On the
        CPU the forward runs here and the handle is complete. The handle's
        ``result()`` gives what ``__call__`` gives for the same inputs."""
        t0 = time.perf_counter()
        padder, im1, im2, staged = self._prepared(image1, image2)
        gt, staged_gt = self._prepared_gt(padder, flow_gt, valid)
        outs = self._forward(im1, im2, iters, gt)
        flow = padder.unpad(outs[1])
        aux = self._aux_of(outs)
        aux_host = None if aux is None else {
            k: host_copy(v, self.device.type == "cuda")
            for k, v in aux.items()}
        done = None
        if self.device.type == "cuda":
            host = torch.empty(flow.shape, dtype=flow.dtype, pin_memory=True)
            host.copy_(flow, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            host = flow
        return PendingPrediction(
            flow, host, done, time.perf_counter() - t0, staged + staged_gt,
            aux=None if aux is None else (aux, aux_host))

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
