"""The RAFT-Stereo model."""

from raft_stereo_tpu_torch.models.raft_stereo import RAFTStereo, init_weights

__all__ = ["RAFTStereo", "init_weights"]
