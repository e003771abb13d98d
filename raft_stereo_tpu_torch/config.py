"""Architecture config for the PyTorch port (inference fields only).

The port's own copy of ``raft_stereo_tpu.config.RAFTStereoConfig``, limited
to the fields that test-mode inference reads. Defaults, validation and the
``CORR_ALIASES`` folding are the same, so a reference command line selects
the same implementation in both packages. Names whose implementation the
port does not have yet are refused with a ``ValueError``: the port never
substitutes another implementation.
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
# What the port runs today: "reg" is plain PyTorch, "reg_pallas" (spelled
# "reg_cuda" on the reference's command line) is the hand-written
# windowed_sample CUDA kernel.
PORTED_CORR_IMPLEMENTATIONS = ("reg", "reg_pallas")

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
    # Correlation-volume storage precision. None = fp32 for "reg", the
    # compute dtype for the kernel implementation.
    corr_storage_dtype: Optional[str] = None

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
