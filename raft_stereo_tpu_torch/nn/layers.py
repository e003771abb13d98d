"""Convolution and normalization building blocks (NHWC at the interface).

Counterparts of ``raft_stereo_tpu.nn.layers``. Activations are NHWC like
the JAX package; ``Conv`` hands ``F.conv2d`` a channels-first view.
Mixed precision follows the JAX policy rather than ``autocast``: parameters
stay fp32, each conv runs in the compute dtype it was built with, and
instance/group norm statistics are taken in fp32.

Attribute names follow the reference's ``state_dict`` keys, so released
checkpoints and the JAX weight bridge (``utils/weights.py``) load strictly.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

# torch norm-layer epsilon (BatchNorm2d/InstanceNorm2d/GroupNorm all 1e-5)
NORM_EPS = 1e-5


class Conv(nn.Conv2d):
    """``nn.Conv2d`` on NHWC activations, computed in ``dtype`` (fp32 when
    None) with fp32 parameters."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding)
        self.compute_dtype = dtype or torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = F.conv2d(x.permute(0, 3, 1, 2).to(dt), self.weight.to(dt),
                     self.bias.to(dt), self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class FrozenBatchNorm(nn.Module):
    """Batch norm with constant running statistics (the reference always
    runs BN in eval mode). Statistics are buffers, scale and bias are
    parameters; the affine is applied in the activation's dtype."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        inv = torch.rsqrt(self.running_var + NORM_EPS) * self.weight
        shift = self.bias - self.running_mean * inv
        return x * inv.to(x.dtype) + shift.to(x.dtype)


class InstanceNorm(nn.Module):
    """Per-sample, per-channel normalization over H, W (torch
    ``InstanceNorm2d`` defaults: no affine, biased variance, eps 1e-5);
    statistics in fp32."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        mean = x32.mean(dim=(1, 2), keepdim=True)
        var = (x32 - mean).square().mean(dim=(1, 2), keepdim=True)
        return ((x32 - mean) * torch.rsqrt(var + NORM_EPS)).to(x.dtype)


class GroupNorm(nn.Module):
    """GroupNorm with torch defaults (affine, eps 1e-5); statistics in
    fp32."""

    def __init__(self, features: int, num_groups: int):
        super().__init__()
        self.num_groups = num_groups
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        g = x.float().reshape(b, h, w, self.num_groups, c // self.num_groups)
        mean = g.mean(dim=(1, 2, 4), keepdim=True)
        var = (g - mean).square().mean(dim=(1, 2, 4), keepdim=True)
        out = ((g - mean) * torch.rsqrt(var + NORM_EPS)).reshape(b, h, w, c)
        return (out * self.weight + self.bias).to(x.dtype)


def make_norm(norm_fn: str, features: int, *,
              num_groups: Optional[int] = None) -> nn.Module:
    """Norm factory for the reference's selectable norms. ``'none'`` is an
    identity; GroupNorm uses ``features // 8`` groups unless told."""
    if norm_fn == "none":
        return nn.Identity()
    if norm_fn == "batch":
        return FrozenBatchNorm(features)
    if norm_fn == "instance":
        return InstanceNorm()
    if norm_fn == "group":
        return GroupNorm(features, num_groups or features // 8)
    raise ValueError(f"unknown norm_fn {norm_fn!r}")


class ResidualBlock(nn.Module):
    """Two 3x3 convs + norms, with a strided 1x1 projection shortcut when
    the stride or the channel count changes.

    As in the reference, the shortcut's norm is registered twice, as
    ``norm3`` and as ``downsample.1``, so the state dict carries both keys.
    """

    def __init__(self, in_planes: int, planes: int, norm_fn: str = "group",
                 stride: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = Conv(in_planes, planes, 3, stride, 1, dtype)
        self.conv2 = Conv(planes, planes, 3, 1, 1, dtype)
        self.norm1 = make_norm(norm_fn, planes)
        self.norm2 = make_norm(norm_fn, planes)
        self.downsample = None
        if not (stride == 1 and in_planes == planes):
            self.norm3 = make_norm(norm_fn, planes)
            self.downsample = nn.Sequential(
                Conv(in_planes, planes, 1, stride, 0, dtype), self.norm3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.norm1(self.conv1(x)))
        y = F.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)
