"""RAFT-Stereo test-mode forward (the port of
``raft_stereo_tpu.models.raft_stereo``).

Encoders, the all-pairs correlation pyramid, ``iters`` refinement
iterations (pyramid lookup -> update block) in a Python loop, and one
convex upsample. Only inference exists so far: the training forward is
ROADMAP item A9.

Mixed precision follows the JAX package's policy, not ``autocast``:
parameters stay fp32, convs run in the compute dtype (bf16 under
``mixed_precision``), norm statistics are fp32 and the correlation taps
are blended in fp32. The coordinates stay fp32 throughout.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn

from raft_stereo_tpu_torch.config import RAFTStereoConfig
from raft_stereo_tpu_torch.nn.encoder import BasicEncoder, MultiBasicEncoder
from raft_stereo_tpu_torch.nn.gru import BasicMultiUpdateBlock
from raft_stereo_tpu_torch.nn.layers import Conv, ResidualBlock
from raft_stereo_tpu_torch.ops.corr import corr_lookup, init_corr
from raft_stereo_tpu_torch.ops.geometry import (coords_grid,
                                                upsample_disparity_convex)


class RAFTStereo(nn.Module):
    """The flagship model, NHWC at its interface.

    ``forward(image1, image2, iters, flow_init=None, test_mode=True)``
    takes uint8-range images ``(B, H, W, 3)`` and returns
    ``(flow_lowres (B, H/f, W/f, 2), flow_up (B, H, W, 1))``.
    ``dtype`` overrides the compute dtype that ``cfg.mixed_precision``
    selects (bf16 when set, fp32 otherwise).
    """

    def __init__(self, cfg: RAFTStereoConfig,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.cfg = cfg
        if dtype is None:
            dtype = torch.bfloat16 if cfg.mixed_precision else torch.float32
        self.compute_dtype = dtype
        dt = dtype
        hd = cfg.hidden_dims
        self.cnet = MultiBasicEncoder(
            output_dim=(hd, hd), norm_fn=cfg.context_norm,
            downsample=cfg.n_downsample, num_layers=cfg.n_gru_layers,
            dtype=dt)
        self.update_block = BasicMultiUpdateBlock(cfg, dt)
        self.context_zqr_convs = nn.ModuleList(
            Conv(hd[i], hd[i] * 3, 3, 1, 1, dt)
            for i in range(cfg.n_gru_layers))
        if cfg.shared_backbone:
            self.conv2 = nn.Sequential(
                ResidualBlock(128, 128, "instance", 1, dt),
                Conv(128, 256, 3, 1, 1, dt))
        else:
            self.fnet = BasicEncoder(output_dim=256, norm_fn="instance",
                                     downsample=cfg.n_downsample, dtype=dt)

    def storage_dtype(self) -> Optional[torch.dtype]:
        """Correlation-volume storage: the config's choice, else the compute
        dtype for the kernel implementation and fp32 for ``reg``."""
        cfg = self.cfg
        if cfg.corr_storage_dtype is not None:
            return getattr(torch, cfg.corr_storage_dtype)
        if cfg.corr_implementation == "reg_pallas":
            return self.compute_dtype
        return None

    def forward(self, image1: torch.Tensor, image2: torch.Tensor,
                iters: int = 12, flow_init: Optional[torch.Tensor] = None,
                test_mode: bool = True):
        if not test_mode:
            raise NotImplementedError(
                "the training forward is not ported yet (ROADMAP.md item A9)")
        if iters < 1:
            raise ValueError(f"iters must be >= 1, got {iters}")
        cfg = self.cfg
        dt = self.compute_dtype

        image1 = 2.0 * (image1.float() / 255.0) - 1.0
        image2 = 2.0 * (image2.float() / 255.0) - 1.0

        if cfg.shared_backbone:
            *cnet_list, trunk = self.cnet(torch.cat([image1, image2], 0),
                                          dual_inp=True)
            fmap1, fmap2 = self.conv2(trunk).chunk(2, dim=0)
        else:
            cnet_list = self.cnet(image1)
            fmap1, fmap2 = self.fnet(
                torch.cat([image1, image2], 0)).chunk(2, dim=0)

        net_list = [torch.tanh(x[0]) for x in cnet_list]
        # context gate biases (cz, cr, cq), computed once outside the loop
        inp_list = [tuple(conv(torch.relu(x[1])).chunk(3, dim=-1))
                    for conv, x in zip(self.context_zqr_convs, cnet_list)]

        corr_state = init_corr(cfg.corr_implementation, fmap1, fmap2,
                               num_levels=cfg.corr_levels,
                               radius=cfg.corr_radius,
                               storage_dtype=self.storage_dtype())

        b, h, w, _ = net_list[0].shape
        coords0 = coords_grid(b, h, w, device=image1.device)
        coords1 = coords0.clone()
        if flow_init is not None:
            # keep the flow's y-channel structurally zero
            coords1 = coords1 + torch.stack(
                [flow_init[..., 0], torch.zeros_like(flow_init[..., 0])], -1)

        block = self.update_block
        n = cfg.n_gru_layers
        for itr in range(iters):
            coords1 = coords1.detach()
            corr = corr_lookup(corr_state, coords1).to(dt)
            flow = (coords1 - coords0).to(dt)
            if cfg.slow_fast_gru and n == 3:
                net_list = block(net_list, inp_list, iter32=True,
                                 iter16=False, iter08=False, update=False)
            if cfg.slow_fast_gru and n >= 2:
                net_list = block(net_list, inp_list, iter32=n == 3,
                                 iter16=True, iter08=False, update=False)
            net_list, mask, delta_flow = block(
                net_list, inp_list, corr, flow, iter32=n == 3,
                iter16=n >= 2, compute_mask=itr == iters - 1)
            # stereo: project the update onto the epipolar line
            delta_x = delta_flow[..., 0].float()
            coords1 = coords1 + torch.stack(
                [delta_x, torch.zeros_like(delta_x)], -1)

        flow_lowres = coords1 - coords0
        flow_up = upsample_disparity_convex(flow_lowres, mask.float(),
                                            cfg.factor)
        return flow_lowres, flow_up


def init_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded random weights, as the JAX package initializes them: He-normal
    (fan-out) conv kernels and zero biases; norm scales 1, shifts 0."""
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, nn.Conv2d):
                fan_out = mod.out_channels * mod.kernel_size[0] \
                    * mod.kernel_size[1]
                w = torch.randn(mod.weight.shape, generator=generator,
                                dtype=torch.float32)
                mod.weight.copy_(w * (2.0 / fan_out) ** 0.5)
                mod.bias.zero_()
    return model
