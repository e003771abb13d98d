"""Dataset validators (the port's copy of ``raft_stereo_tpu/eval/validate.py``).

Each validator shares the reference skeleton: load pair -> pad to /32 ->
test-mode forward -> unpad -> EPE against GT flow, with the
dataset-specific metric definitions:

* ETH3D: bad-1px "D1", IMAGE-weighted (each image's scalar D1 mean,
  averaged)
* KITTI: bad-3px PIXEL-weighted (per-pixel outlier masks concatenated),
  plus FPS after a warmup
* FlyingThings: bad-1px over pixels with ``|disp| < 192``, pixel-weighted
* Middlebury: bad-2px, image-weighted; the reference's ``valid >= -0.5``
  check is a NO-OP on the 0/1 nocc mask — replicated faithfully, so the
  effective filter is ``gt > -1000`` alone and occluded pixels are NOT
  excluded

EPE is the mean of per-image means in every validator. The aggregation is
the JAX package's, which is the reference's.

All metric arithmetic happens in numpy on the host — the device computes
only the forward pass, via
:class:`raft_stereo_tpu_torch.inference.StereoPredictor`. The frame loop
lives in eval/stream.py: one driver feeds all four validators, either
sequentially or as a decode/dispatch/fetch pipeline (``stream=``), with
per-frame metric closures applied in index order as results retire — so
streaming changes WHEN metrics are computed, never WHAT they aggregate to.

Frames whose validity mask is empty are skipped with a warning instead of
poisoning the aggregate with a NaN.
"""

from __future__ import annotations

import logging
import os.path as osp
from typing import Dict, Union

import numpy as np

from raft_stereo_tpu_torch.data import datasets
from raft_stereo_tpu_torch.eval.stream import StreamConfig, run_frames
from raft_stereo_tpu_torch.inference import StereoPredictor

logger = logging.getLogger(__name__)

StreamArg = Union[None, bool, StreamConfig]


def _epe(flow_pred: np.ndarray, flow_gt: np.ndarray) -> np.ndarray:
    """Per-pixel endpoint error between (H, W, C) flows (C=1: |dx|)."""
    return np.sqrt(np.sum((flow_pred - flow_gt) ** 2, axis=-1))


def _usable(valid: np.ndarray, dataset: str, index: int) -> bool:
    """Guard the empty-valid-mask NaN: skip-and-warn instead of averaging
    a NaN into the run (see module doc)."""
    if valid.any():
        return True
    logger.warning("%s frame %d: validity mask is empty — frame skipped "
                   "(its per-image mean would be NaN)", dataset, index)
    return False


def _emit(telemetry, dataset: str, results: Dict[str, float]) -> None:
    """Mirror a validator's results onto the telemetry bus (obs/) when the
    caller runs one — eval CLI with --run_dir, or a future eval harness."""
    if telemetry is not None:
        telemetry.validation(results, dataset=dataset)


def validate_eth3d(predictor: StereoPredictor, root: str = "datasets",
                   iters: int = 32, telemetry=None,
                   stream: StreamArg = None) -> Dict[str, float]:
    """ETH3D two-view validation: EPE + bad-1px (evaluate_stereo.py:19-56)."""
    ds = datasets.ETH3D(root=osp.join(root, "ETH3D"))
    if len(ds) == 0:
        raise ValueError(f"no samples found under {root!r}")
    epe_list, out_list = [], []

    def consume(i, sample, flow_pr, timing):
        flow_gt = sample["flow"]
        valid = sample["valid"] >= 0.5
        if not _usable(valid, "eth3d", i):
            return
        epe = _epe(flow_pr, flow_gt)
        epe_list.append(epe[valid].mean().item())
        # image-weighted D1: the reference appends each image's scalar mean
        # (evaluate_stereo.py:43-47) and averages the scalars (:53)
        out_list.append((epe > 1.0)[valid].mean().item())

    run_frames(predictor, ds, consume, iters=iters, stream=stream,
               telemetry=telemetry, source="eth3d")
    epe = float(np.mean(epe_list))
    d1 = 100 * float(np.mean(out_list))
    logger.info("Validation ETH3D: EPE %f, D1 %f", epe, d1)
    results = {"eth3d-epe": epe, "eth3d-d1": d1}
    _emit(telemetry, "eth3d", results)
    return results


def validate_kitti(predictor: StereoPredictor, root: str = "datasets",
                   iters: int = 32,
                   warmup_frames: int = 50, telemetry=None,
                   stream: StreamArg = None) -> Dict[str, float]:
    """KITTI-15 training-split validation: EPE + bad-3px + FPS
    (evaluate_stereo.py:59-108).

    Sequentially, two FPS numbers are reported: ``kitti-fps`` times the
    DEVICE forward only (``StereoPredictor.predict_timed``) — the number
    comparable to the reference, which brackets only the ``model(...)`` call
    (:77-79) — and ``kitti-fps-e2e`` additionally includes padding, H2D
    transfer and the host fetch of the full disparity map. In streaming mode
    the per-frame device sync that ``kitti-fps`` needs would re-serialize
    the pipeline, so only ``kitti-fps-e2e`` is reported — computed from
    retire intervals, the pipelined throughput that converges toward the
    device-side FPS as overlap wins (PERF.md). Frames ``0..warmup_frames``
    are excluded like the reference's ``val_id > 50`` cudnn-autotune warmup
    (:81)."""
    ds = datasets.KITTI(root=osp.join(root, "KITTI"), image_set="training")
    if len(ds) == 0:
        raise ValueError(f"no samples found under {root!r}")
    epe_list, out_list, elapsed_dev, elapsed_e2e = [], [], [], []

    def consume(i, sample, flow_pr, timing):
        if i > warmup_frames:
            if timing.device_s is not None:
                elapsed_dev.append(timing.device_s)
            elapsed_e2e.append(timing.e2e_s)
        flow_gt = sample["flow"]
        valid = sample["valid"] >= 0.5
        if not _usable(valid, "kitti", i):
            return
        epe = _epe(flow_pr, flow_gt)
        epe_list.append(epe[valid].mean().item())
        # pixel-weighted D1: the reference concatenates per-pixel outlier
        # masks here (evaluate_stereo.py:97-103), unlike ETH3D/Middlebury
        out_list.append((epe > 3.0)[valid])

    run_frames(predictor, ds, consume, iters=iters, stream=stream,
               telemetry=telemetry, timed=True, source="kitti")
    epe = float(np.mean(epe_list))
    d1 = 100 * float(np.concatenate(out_list).mean())
    result = {"kitti-epe": epe, "kitti-d1": d1}
    if elapsed_dev:
        result["kitti-fps"] = 1.0 / float(np.mean(elapsed_dev))
    if elapsed_e2e:
        result["kitti-fps-e2e"] = 1.0 / float(np.mean(elapsed_e2e))
        logger.info("Validation KITTI: EPE %f, D1 %f, %s FPS (%f e2e)",
                    epe, d1, result.get("kitti-fps", "n/a (streamed)"),
                    result["kitti-fps-e2e"])
    else:
        logger.info("Validation KITTI: EPE %f, D1 %f", epe, d1)
    _emit(telemetry, "kitti", result)
    return result


def validate_things(predictor: StereoPredictor, root: str = "datasets",
                    iters: int = 32,
                    max_disp: float = 192.0, telemetry=None,
                    stream: StreamArg = None) -> Dict[str, float]:
    """FlyingThings3D TEST split: EPE + bad-1px over ``|disp| < max_disp``
    (evaluate_stereo.py:111-146). Doubles as the in-training validation hook
    (train_stereo.py:188). The test split is a single image shape, so the
    streaming path's micro-batching applies to every frame."""
    ds = datasets.SceneFlow(root=root, dstype="frames_finalpass",
                            things_test=True)
    if len(ds) == 0:
        raise ValueError(f"no samples found under {root!r}")
    epe_list, out_list = [], []

    def consume(i, sample, flow_pr, timing):
        flow_gt = sample["flow"]
        epe = _epe(flow_pr, flow_gt)
        valid = (sample["valid"] >= 0.5) & \
                (np.abs(flow_gt[..., 0]) < max_disp)
        if not _usable(valid, "things", i):
            return
        epe_list.append(epe[valid].mean().item())
        out_list.append((epe > 1.0)[valid])

    run_frames(predictor, ds, consume, iters=iters, stream=stream,
               telemetry=telemetry, source="things")
    epe = float(np.mean(epe_list))
    d1 = 100 * float(np.concatenate(out_list).mean())
    logger.info("Validation FlyingThings: EPE %f, D1 %f", epe, d1)
    results = {"things-epe": epe, "things-d1": d1}
    _emit(telemetry, "things", results)
    return results


def validate_middlebury(predictor: StereoPredictor, root: str = "datasets",
                        iters: int = 32,
                        split: str = "F", telemetry=None,
                        stream: StreamArg = None) -> Dict[str, float]:
    """Middlebury MiddEval3 validation: EPE + bad-2px (evaluate_stereo.py:149-189).

    ``split`` in {'F','H','Q'}. Mask semantics replicate the reference
    EXACTLY: its ``valid_gt >= -0.5`` check (evaluate_stereo.py:173) is a
    no-op on the 0/1 nocc mask, so the effective filter is ``gt > -1000``
    alone — occluded pixels are scored, the nocc mask is loaded but unused.
    Both EPE and D1 are image-weighted (per-image scalar means averaged,
    :176-186).
    """
    ds = datasets.Middlebury(root=osp.join(root, "Middlebury"), split=split)
    if len(ds) == 0:
        raise ValueError(f"no samples found under {root!r}")
    epe_list, out_list = [], []

    def consume(i, sample, flow_pr, timing):
        flow_gt = sample["flow"]
        valid = (sample["valid"] >= -0.5) & (flow_gt[..., 0] > -1000)
        if not _usable(valid, f"middlebury{split}", i):
            return
        epe = _epe(flow_pr, flow_gt)
        epe_list.append(epe[valid].mean().item())
        out_list.append((epe > 2.0)[valid].mean().item())

    run_frames(predictor, ds, consume, iters=iters, stream=stream,
               telemetry=telemetry, source=f"middlebury{split}")
    epe = float(np.mean(epe_list))
    d1 = 100 * float(np.mean(out_list))
    logger.info("Validation Middlebury%s: EPE %f, D1 %f", split, epe, d1)
    results = {f"middlebury{split}-epe": epe, f"middlebury{split}-d1": d1}
    _emit(telemetry, f"middlebury{split}", results)
    return results


VALIDATORS = {
    "eth3d": validate_eth3d,
    "kitti": validate_kitti,
    "things": validate_things,
    "middlebury": validate_middlebury,
}
