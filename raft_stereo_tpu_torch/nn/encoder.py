"""Feature and context encoders (the port of ``raft_stereo_tpu.nn.encoder``).

The stride pattern follows the reference: the stem strides when
``downsample > 2``, layer2 when ``downsample > 1`` and layer3 when
``downsample > 0``, so the finest feature scale is ``1/2**downsample``.
Only the modules a configuration runs are built: no ``layer5``/
``outputs32`` below three GRU levels.

``remat`` (a set of trunk block names, :data:`TRUNK_BLOCKS`) recomputes
those residual blocks in the backward pass (``torch.utils.checkpoint``:
each block's input is saved, its internals are not): the
``remat_encoders="blocks"`` and ``"blocks_hires"`` schedules,
:func:`remat_block_names`.
"""

from __future__ import annotations

from typing import FrozenSet, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from raft_stereo_tpu_torch.nn.layers import Conv, ResidualBlock, make_norm


def _stage(in_planes: int, planes: int, norm_fn: str, stride: int,
           dtype) -> nn.Sequential:
    return nn.Sequential(
        ResidualBlock(in_planes, planes, norm_fn, stride, dtype),
        ResidualBlock(planes, planes, norm_fn, 1, dtype))


TRUNK_BLOCKS = ("layer1_0", "layer1_1", "layer2_0", "layer2_1", "layer3_0",
                "layer3_1")


def remat_block_names(mode, downsample: int) -> FrozenSet[str]:
    """The trunk blocks a ``remat_encoders`` mode recomputes: every block
    under ``"blocks"``; under ``"blocks_hires"`` the blocks that run
    entirely at the post-stem resolution: layer1's, layer2's where layer2
    does not stride (``downsample <= 1``) and layer3's where neither does
    (``downsample == 0``). Other modes: none."""
    if mode == "blocks":
        return frozenset(TRUNK_BLOCKS)
    if mode != "blocks_hires":
        return frozenset()
    names = {"layer1_0", "layer1_1"}
    if downsample <= 1:
        names |= {"layer2_0", "layer2_1"}
        if downsample == 0:
            names |= {"layer3_0", "layer3_1"}
    return frozenset(names)


class _Trunk(nn.Module):
    """Stem + layer1-3, shared by both encoders. The layers sit directly on
    the encoder (no ``trunk.`` prefix), as in the reference's state dict."""

    def __init__(self, norm_fn: str, downsample: int,
                 dtype: Optional[torch.dtype]):
        super().__init__()
        self.conv1 = Conv(3, 64, 7, 1 + (downsample > 2), 3, dtype)
        self.norm1 = make_norm(norm_fn, 64, num_groups=8)
        self.layer1 = _stage(64, 64, norm_fn, 1, dtype)
        self.layer2 = _stage(64, 96, norm_fn, 1 + (downsample > 1), dtype)
        self.layer3 = _stage(96, 128, norm_fn, 1 + (downsample > 0), dtype)

    def trunk(self, x: torch.Tensor,
              remat: FrozenSet[str] = frozenset()) -> torch.Tensor:
        x = F.relu(self.norm1(self.conv1(x)))
        for name in TRUNK_BLOCKS:
            layer, i = name.split("_")
            block = getattr(self, layer)[int(i)]
            x = (checkpoint(block, x, use_reentrant=False) if name in remat
                 else block(x))
        return x


class BasicEncoder(_Trunk):
    """ResNet-style feature encoder: 7x7 stem, three 2-block stages
    (64 -> 96 -> 128) and a 1x1 output conv."""

    def __init__(self, output_dim: int = 128, norm_fn: str = "batch",
                 downsample: int = 3, dtype: Optional[torch.dtype] = None):
        super().__init__(norm_fn, downsample, dtype)
        self.conv2 = Conv(128, output_dim, 1, 1, 0, dtype)

    def forward(self, x: torch.Tensor,
                remat: FrozenSet[str] = frozenset()) -> torch.Tensor:
        return self.conv2(self.trunk(x, remat))


class MultiBasicEncoder(_Trunk):
    """Context encoder with one output head per scale and per entry of
    ``output_dim`` (triples ordered coarse->fine, see config.hidden_dims).

    ``forward`` returns ``(outputs08[, outputs16[, outputs32]])``, each a
    tuple with one tensor per ``output_dim`` entry. With ``dual_inp`` the
    trunk runs on a doubled batch (left + right), the heads see the first
    half only, and the full trunk feature is appended for the shared
    backbone's feature head.
    """

    def __init__(self, output_dim: Sequence[Sequence[int]],
                 norm_fn: str = "batch", downsample: int = 3,
                 num_layers: int = 3, dtype: Optional[torch.dtype] = None):
        super().__init__(norm_fn, downsample, dtype)
        self.num_layers = num_layers

        def res_head(out_dim):
            return nn.Sequential(
                ResidualBlock(128, 128, norm_fn, 1, dtype),
                Conv(128, out_dim, 3, 1, 1, dtype))

        self.outputs08 = nn.ModuleList(res_head(d[2]) for d in output_dim)
        if num_layers >= 2:
            self.layer4 = _stage(128, 128, norm_fn, 2, dtype)
            self.outputs16 = nn.ModuleList(res_head(d[1])
                                           for d in output_dim)
        if num_layers == 3:
            self.layer5 = _stage(128, 128, norm_fn, 2, dtype)
            self.outputs32 = nn.ModuleList(Conv(128, d[0], 3, 1, 1, dtype)
                                           for d in output_dim)

    def forward(self, x: torch.Tensor, dual_inp: bool = False,
                remat: FrozenSet[str] = frozenset()):
        x = self.trunk(x, remat)
        trunk = x
        if dual_inp:
            x = x[: x.shape[0] // 2]
        outs = [tuple(head(x) for head in self.outputs08)]
        if self.num_layers >= 2:
            y = self.layer4(x)
            outs.append(tuple(head(y) for head in self.outputs16))
        if self.num_layers == 3:
            z = self.layer5(y)
            outs.append(tuple(head(z) for head in self.outputs32))
        if dual_inp:
            outs.append(trunk)
        return tuple(outs)
