"""PyTorch/CUDA port of ``raft_stereo_tpu`` (RAFT-Stereo), for NVIDIA Hopper.

Test-mode inference: encoders, the all-pairs correlation pyramid, the GRU
refinement loop and the convex upsample, with the correlation lookup in a
hand-written CUDA kernel (``corr_implementation="reg_cuda"``). The package
imports torch and numpy, and nothing of JAX or of ``raft_stereo_tpu``.
"""
