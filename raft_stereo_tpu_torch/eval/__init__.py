"""Evaluation: the four dataset validators and the frame driver they share
(sequential or streamed)."""

from raft_stereo_tpu_torch.eval.stream import StreamConfig, run_frames
from raft_stereo_tpu_torch.eval.validate import (VALIDATORS, validate_eth3d,
                                                 validate_kitti,
                                                 validate_middlebury,
                                                 validate_things)

__all__ = ["StreamConfig", "run_frames", "VALIDATORS", "validate_eth3d",
           "validate_kitti", "validate_middlebury", "validate_things"]
