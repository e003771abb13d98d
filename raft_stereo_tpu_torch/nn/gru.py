"""Recurrent refinement cell (the port of ``raft_stereo_tpu.nn.gru``).

A coarse-to-fine stack of ConvGRUs with cross-resolution links (pool down,
bilinear up), a motion encoder that turns correlation + flow into 128-d
features, the flow head and the upsampling-mask head. The context biases
``cz, cr, cq`` are computed once outside the loop and added per gate.
The math is upstream's: one conv over the concatenated inputs, where the
JAX package splits its gate convs by input.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from raft_stereo_tpu_torch.config import RAFTStereoConfig
from raft_stereo_tpu_torch.nn.layers import Conv
from raft_stereo_tpu_torch.ops.geometry import (pool2x,
                                                resize_bilinear_align_corners)


class FlowHead(nn.Module):
    """Two 3x3 convs (256 hidden channels) -> delta flow ``(B, h, w, 2)``."""

    def __init__(self, input_dim: int, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv1 = Conv(input_dim, 256, 3, 1, 1, dtype)
        self.conv2 = Conv(256, 2, 3, 1, 1, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv2(F.relu(self.conv1(x)))


class ConvGRU(nn.Module):
    """3x3 convolutional GRU with additive per-gate context biases."""

    def __init__(self, hidden_dim: int, input_dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        c = hidden_dim + input_dim
        self.convz = Conv(c, hidden_dim, 3, 1, 1, dtype)
        self.convr = Conv(c, hidden_dim, 3, 1, 1, dtype)
        self.convq = Conv(c, hidden_dim, 3, 1, 1, dtype)

    def forward(self, h, cz, cr, cq, *x_list):
        x = torch.cat(x_list, dim=-1)
        hx = torch.cat([h, x], dim=-1)
        z = torch.sigmoid(self.convz(hx) + cz)
        r = torch.sigmoid(self.convr(hx) + cr)
        q = torch.tanh(self.convq(torch.cat([r * h, x], dim=-1)) + cq)
        return (1 - z) * h + z * q


class BasicMotionEncoder(nn.Module):
    """Correlation + flow -> 128-d motion features (126 + the 2 flow
    channels passed through)."""

    def __init__(self, cfg: RAFTStereoConfig,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.convc1 = Conv(cfg.corr_channels, 64, 1, 1, 0, dtype)
        self.convc2 = Conv(64, 64, 3, 1, 1, dtype)
        self.convf1 = Conv(2, 64, 7, 1, 3, dtype)
        self.convf2 = Conv(64, 64, 3, 1, 1, dtype)
        self.conv = Conv(128, 128 - 2, 3, 1, 1, dtype)

    def forward(self, flow: torch.Tensor, corr: torch.Tensor) -> torch.Tensor:
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], dim=-1)))
        return torch.cat([out, flow], dim=-1)


def interp_to(x: torch.Tensor, dest: torch.Tensor) -> torch.Tensor:
    """Bilinear align-corners resize of ``x`` to ``dest``'s spatial shape."""
    return resize_bilinear_align_corners(x, (dest.shape[1], dest.shape[2]))


class BasicMultiUpdateBlock(nn.Module):
    """Coarse-to-fine GRU refinement cell with 1-3 levels.

    ``net`` is the hidden-state list ordered fine->coarse; ``inp`` holds the
    per-level ``(cz, cr, cq)`` context biases. ``iter08/16/32`` select which
    levels update in this call; ``update=False`` runs the GRUs only (the
    slow_fast_gru pre-iterations); ``compute_mask=False`` skips the mask
    head (inference needs only the final iteration's mask).
    """

    def __init__(self, cfg: RAFTStereoConfig,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        hd = cfg.hidden_dims
        n = cfg.n_gru_layers
        self.encoder = BasicMotionEncoder(cfg, dtype)
        self.gru08 = ConvGRU(hd[2], 128 + hd[1] * (n > 1), dtype=dtype)
        if n >= 2:
            self.gru16 = ConvGRU(hd[1], hd[0] * (n == 3) + hd[2],
                                 dtype=dtype)
        if n == 3:
            self.gru32 = ConvGRU(hd[0], hd[1], dtype=dtype)
        self.flow_head = FlowHead(hd[2], dtype)
        self.mask = nn.Sequential(
            Conv(hd[2], 256, 3, 1, 1, dtype), nn.ReLU(),
            Conv(256, cfg.factor ** 2 * 9, 1, 1, 0, dtype))

    def forward(self, net: Sequence[torch.Tensor], inp, corr=None, flow=None,
                iter08: bool = True, iter16: bool = True, iter32: bool = True,
                update: bool = True, compute_mask: bool = True):
        n = self.cfg.n_gru_layers
        net = list(net)
        if iter32:
            net[2] = self.gru32(net[2], *inp[2], pool2x(net[1]))
        if iter16:
            if n > 2:
                net[1] = self.gru16(net[1], *inp[1], pool2x(net[0]),
                                    interp_to(net[2], net[1]))
            else:
                net[1] = self.gru16(net[1], *inp[1], pool2x(net[0]))
        if iter08:
            motion = self.encoder(flow, corr)
            if n > 1:
                net[0] = self.gru08(net[0], *inp[0], motion,
                                    interp_to(net[1], net[0]))
            else:
                net[0] = self.gru08(net[0], *inp[0], motion)

        if not update:
            return net
        delta_flow = self.flow_head(net[0])
        if not compute_mask:
            return net, None, delta_flow
        # scale the mask to balance gradients, as upstream
        return net, 0.25 * self.mask(net[0]), delta_flow
