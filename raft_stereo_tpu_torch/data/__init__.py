"""Host-side data for evaluation: PNG/PFM/flow codecs (no PIL or cv2) and
the unaugmented stereo datasets, equal to the JAX package's."""

from raft_stereo_tpu_torch.data import frame_utils, png
from raft_stereo_tpu_torch.data.datasets import (ETH3D, KITTI, FallingThings,
                                                 Middlebury, SceneFlow,
                                                 SintelStereo, StereoDataset,
                                                 TartanAir)

__all__ = ["frame_utils", "png", "StereoDataset", "SceneFlow", "ETH3D",
           "SintelStereo", "FallingThings", "TartanAir", "KITTI",
           "Middlebury"]
