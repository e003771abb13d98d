"""Architecture and training-step config for the PyTorch port.

The port's own copies of ``raft_stereo_tpu.config.RAFTStereoConfig`` and
``TrainConfig``, limited to the fields that inference and one training
step read, plus ``sceneflow_config()``. Defaults, validation and the
``CORR_ALIASES`` folding are the same, so a reference command line selects
the same implementation in both packages. Corr implementations the port
does not have yet are refused with a ``ValueError``: the port never
substitutes another implementation. The JAX package's other knobs (remat
modes, save policies, fused loss, parallelism) are not fields here at
all; ROADMAP.md queues them.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Every name the JAX package accepts (the reference's --corr_implementation
# plugin switch plus the JAX package's kernels).
CORR_IMPLEMENTATIONS = ("reg", "alt", "reg_pallas", "alt_pallas", "ring",
                        "fused")
# Reference spellings folded onto the implementation that delivers them.
CORR_ALIASES = {"reg_cuda": "reg_pallas", "alt_cuda": "fused",
                "fused_cuda": "fused", "memoryless": "fused"}
# What the port runs today: "reg" and "alt" are plain PyTorch, "reg_pallas"
# (spelled "reg_cuda" on the reference's command line) is the hand-written
# windowed_sample CUDA kernel, "alt_pallas" the hand-written alt_corr CUDA
# kernels (the correlation slab built on-chip), "fused" (spelled
# "alt_cuda") the hand-written memoryless fused_corr CUDA kernels. "ring"
# (sequence-parallel) is not ported. The JAX package's fused_block_w is a
# TPU tiling knob the CUDA kernels do not read, so it is not a field here.
PORTED_CORR_IMPLEMENTATIONS = ("reg", "alt", "reg_pallas", "alt_pallas",
                               "fused")

NORM_FNS = ("group", "batch", "instance", "none")


@dataclasses.dataclass(frozen=True)
class RAFTStereoConfig:
    """Architecture config (the reference's "Architecture choices" flags)."""

    # Ordered coarse->fine: hidden_dims[0] is the 1/32-resolution GRU,
    # hidden_dims[2] the finest one.
    hidden_dims: Tuple[int, ...] = (128, 128, 128)
    corr_implementation: str = "reg"
    shared_backbone: bool = False
    corr_levels: int = 4
    corr_radius: int = 4
    n_downsample: int = 2
    context_norm: str = "batch"
    slow_fast_gru: bool = False
    n_gru_layers: int = 3
    mixed_precision: bool = False
    # Correlation storage precision (the volume, or fused's features).
    # None = fp32 for "reg", the compute dtype for the kernel
    # implementations.
    corr_storage_dtype: Optional[str] = None
    # Training forward: recompute each refinement iteration in the backward
    # pass (torch.utils.checkpoint) instead of keeping its activations.
    remat_refinement: bool = True
    # The 4-level lookup and the motion encoder's 1x1 convc1 + ReLU as one
    # hand-written fused_lookup CUDA kernel, forward and backward. None
    # (auto) is off, as in the JAX package; True engages it for "reg" and
    # "reg_pallas" where the pyramid fits (4 levels, every level wider than
    # 2r+2), and leaves the unfused path everywhere else.
    fused_lookup: Optional[bool] = None

    def __post_init__(self):
        impl = CORR_ALIASES.get(self.corr_implementation,
                                self.corr_implementation)
        object.__setattr__(self, "corr_implementation", impl)
        object.__setattr__(self, "hidden_dims", tuple(self.hidden_dims))
        if impl not in CORR_IMPLEMENTATIONS:
            aliases = ", ".join(f"{a!r}->{t!r}"
                                for a, t in sorted(CORR_ALIASES.items()))
            raise ValueError(
                f"unknown corr_implementation {impl!r}; registered: "
                f"{list(CORR_IMPLEMENTATIONS)} (aliases: {aliases})")
        if impl not in PORTED_CORR_IMPLEMENTATIONS:
            raise ValueError(
                f"corr_implementation {impl!r} is not ported to PyTorch yet "
                f"(ported: {list(PORTED_CORR_IMPLEMENTATIONS)}; see "
                "ROADMAP.md queue B)")
        if self.context_norm not in NORM_FNS:
            raise ValueError(f"unknown context_norm {self.context_norm!r}")
        if not 1 <= self.n_gru_layers <= 3:
            raise ValueError("n_gru_layers must be in {1,2,3}")
        if self.corr_storage_dtype not in (None, "float32", "bfloat16"):
            raise ValueError(
                f"unknown corr_storage_dtype {self.corr_storage_dtype!r}; "
                "expected None, 'float32' or 'bfloat16'")
        if (len(self.hidden_dims) != 3
                or self.hidden_dims[0] != self.hidden_dims[2]):
            # context conv i (sized hidden_dims[i]) feeds the GRU whose
            # hidden size is hidden_dims[2-i]: consistent only when
            # hidden_dims[0] == hidden_dims[2]
            raise ValueError("hidden_dims must have length 3 with "
                             "hidden_dims[0] == hidden_dims[2] "
                             "(reference GRU/context cross-wiring)")

    @property
    def factor(self) -> int:
        """Resolution factor of the disparity field (2**n_downsample)."""
        return 2 ** self.n_downsample

    @property
    def corr_channels(self) -> int:
        """Channels produced by a correlation lookup."""
        return self.corr_levels * (2 * self.corr_radius + 1)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The fields of the JAX package's ``TrainConfig`` that the optimizer
    and one training step read (reference "Training parameters"), with its
    defaults. The step's own switches (``anomaly_guard``, ``numerics``) are
    arguments of ``make_train_step``; the loader, checkpoint, telemetry and
    parallelism fields belong to the trainer (ROADMAP A10) and are not
    here."""

    batch_size: int = 6
    lr: float = 0.0002
    # micro-steps; the LR schedule's horizon is the number of updates
    num_steps: int = 100000
    image_size: Tuple[int, int] = (320, 720)
    train_iters: int = 16
    wdecay: float = 1e-5
    # average the gradients of k micro-steps before one optimizer update
    grad_accum_steps: int = 1

    def __post_init__(self):
        object.__setattr__(self, "image_size", tuple(self.image_size))
        if self.grad_accum_steps < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, got "
                             f"{self.grad_accum_steps}")
        if self.train_iters < 1 or self.num_steps < 1:
            raise ValueError("train_iters and num_steps must be >= 1")


def sceneflow_config() -> Tuple[RAFTStereoConfig, TrainConfig]:
    """The SceneFlow recipe: batch 8, 22 train iterations, 200k steps, bf16
    compute and bf16 volume storage (the augmentation fields of the JAX
    preset belong to the loader, ROADMAP A10)."""
    return (
        RAFTStereoConfig(mixed_precision=True, corr_storage_dtype="bfloat16"),
        TrainConfig(batch_size=8, train_iters=22, num_steps=200000),
    )


def realtime_config() -> RAFTStereoConfig:
    """The reference's fastest configuration (7 valid iters at 1/8 res)."""
    return RAFTStereoConfig(
        shared_backbone=True, n_downsample=3, n_gru_layers=2,
        slow_fast_gru=True, corr_implementation="reg_pallas",
        mixed_precision=True,
    )


def rvc_config() -> RAFTStereoConfig:
    """iRaftStereo_RVC: instance-normalized context encoder."""
    return RAFTStereoConfig(context_norm="instance")
