"""Architecture and training config for the PyTorch port.

The port's own copies of ``raft_stereo_tpu.config.RAFTStereoConfig`` (the
fields inference and training read) and ``TrainConfig`` (every field of
the JAX package's), and the presets. Defaults, validation and the
``CORR_ALIASES`` folding are the same, so a reference command line selects
the same implementation in both packages. What the port does not have yet
is refused with a ``ValueError`` (corr ``ring``, data and sequence
parallelism): the port never substitutes another implementation. The JAX
package's other architecture knobs (remat modes, save policies, fused
loss) are not fields here at all; ROADMAP.md queues them.
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
    """Training loop config (the reference's "Training parameters"), the
    JAX package's fields with its defaults. ``restore_ckpt`` takes a
    checkpoint directory, a reference ``.pth`` (weights only) or ``"auto"``
    (resume from the newest checkpoint of this run that verifies). The
    port trains on one device: ``data_parallel`` and ``seq_parallel``
    above 1 raise (ROADMAP A10c and A13); 0 and 1 mean one device."""

    name: str = "raft-stereo"
    restore_ckpt: Optional[str] = None
    batch_size: int = 6
    train_datasets: Tuple[str, ...] = ("sceneflow",)
    lr: float = 0.0002
    # micro-steps; the LR schedule's horizon is the number of updates
    num_steps: int = 100000
    image_size: Tuple[int, int] = (320, 720)
    train_iters: int = 16
    valid_iters: int = 32
    wdecay: float = 1e-5
    # data augmentation
    img_gamma: Optional[Tuple[float, ...]] = None
    saturation_range: Optional[Tuple[float, float]] = None
    do_flip: Optional[str] = None  # None/'h'/'v' ('hf' mirrors only)
    spatial_scale: Tuple[float, float] = (0.0, 0.0)
    noyjitter: bool = False
    data_root: str = "datasets"
    seed: int = 1234
    ckpt_dir: str = "checkpoints"
    validation_frequency: int = 10000
    num_workers: int = 4
    data_parallel: int = 0
    seq_parallel: int = 1
    # average the gradients of k micro-steps before one optimizer update
    grad_accum_steps: int = 1
    # observability: events.jsonl and the logs land under <run_dir>/<name>;
    # a `stall` record when no step completes within stall_deadline_s
    # (None/0: no watchdog); trace: step/loader spans on the bus
    run_dir: str = "runs"
    stall_deadline_s: Optional[float] = 300.0
    trace: bool = True
    # checkpoint cadence in steps (None: validation_frequency); retention
    # keeps the newest ckpt_keep_last step checkpoints (0: all) and spares
    # multiples of ckpt_keep_every
    checkpoint_frequency: Optional[int] = None
    ckpt_keep_last: int = 3
    ckpt_keep_every: int = 0
    # skip the update on a non-finite loss or gradient norm; halt after
    # anomaly_max_skips consecutive skips (0: never)
    anomaly_guard: bool = True
    anomaly_max_skips: int = 10
    # per-leaf gradient norms, sampled into `numerics` records every
    # numerics_every steps
    numerics: bool = True
    numerics_every: int = 50
    # host identity on every record, a clock anchor and heartbeats every
    # heartbeat_every_s seconds (fleet=False: none of it)
    fleet: bool = True
    heartbeat_every_s: float = 10.0
    host_id: Optional[str] = None

    def __post_init__(self):
        object.__setattr__(self, "image_size", tuple(self.image_size))
        object.__setattr__(self, "train_datasets",
                           tuple(self.train_datasets))
        object.__setattr__(self, "spatial_scale", tuple(self.spatial_scale))
        for field in ("img_gamma", "saturation_range"):
            value = getattr(self, field)
            if value is not None:
                object.__setattr__(self, field, tuple(value))
        if self.grad_accum_steps < 1:
            raise ValueError(f"grad_accum_steps must be >= 1, got "
                             f"{self.grad_accum_steps}")
        if self.train_iters < 1 or self.num_steps < 1:
            raise ValueError("train_iters and num_steps must be >= 1")
        if self.data_parallel > 1:
            raise ValueError(
                f"data_parallel={self.data_parallel}: data-parallel training "
                "is not ported yet (ROADMAP A10c); the port trains on one "
                "device (data_parallel 0 or 1)")
        if self.seq_parallel > 1:
            raise ValueError(
                f"seq_parallel={self.seq_parallel}: sequence-parallel "
                "correlation is not ported yet (ROADMAP A13)")


def sceneflow_config() -> Tuple[RAFTStereoConfig, TrainConfig]:
    """The SceneFlow recipe: batch 8, 22 train iterations, 200k steps, bf16
    compute and bf16 volume storage, spatial scale (-0.2, 0.4) and
    saturation (0, 1.4)."""
    return (
        RAFTStereoConfig(mixed_precision=True, corr_storage_dtype="bfloat16"),
        TrainConfig(batch_size=8, train_iters=22, num_steps=200000,
                    spatial_scale=(-0.2, 0.4), saturation_range=(0.0, 1.4)),
    )


def middlebury_finetune_config() -> Tuple[RAFTStereoConfig, TrainConfig]:
    """The Middlebury 2014 finetune: 4k steps, lr 2e-5, batch 2, crop
    384x1000, warm-started from the SceneFlow checkpoint."""
    return (
        RAFTStereoConfig(mixed_precision=True),
        TrainConfig(train_datasets=("middlebury_2014",), num_steps=4000,
                    image_size=(384, 1000), lr=2e-5, batch_size=2,
                    train_iters=22, valid_iters=32,
                    spatial_scale=(-0.2, 0.4), saturation_range=(0.0, 1.4),
                    restore_ckpt="models/raftstereo-sceneflow.pth"),
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
