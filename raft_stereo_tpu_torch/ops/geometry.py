"""Geometry / resampling ops, NHWC at every public function.

The port's counterparts of ``raft_stereo_tpu.ops.geometry``: coordinate
grids, average pools, align-corners bilinear resize, convex upsampling and
the input padder. Layout is channel-last like the JAX package; PyTorch ops
that want channels first get a permuted view.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F


def coords_grid(batch: int, ht: int, wd: int, device=None,
                dtype=torch.float32) -> torch.Tensor:
    """Pixel coordinate grid ``(B, H, W, 2)`` with channels ``(x, y)``."""
    ys, xs = torch.meshgrid(torch.arange(ht, device=device, dtype=dtype),
                            torch.arange(wd, device=device, dtype=dtype),
                            indexing="ij")
    grid = torch.stack([xs, ys], dim=-1)
    return grid[None].expand(batch, ht, wd, 2).contiguous()


def avg_pool2d(x: torch.Tensor, window: Tuple[int, int],
               stride: Tuple[int, int],
               padding: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """NHWC average pool with ``count_include_pad=True`` and floor
    semantics (windows that overhang the unpadded input are dropped)."""
    y = F.avg_pool2d(x.permute(0, 3, 1, 2), window, stride, padding,
                     ceil_mode=False, count_include_pad=True)
    return y.permute(0, 2, 3, 1)


def pool2x(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-2 pad-1 average pool (the GRU's downward link)."""
    return avg_pool2d(x, (3, 3), (2, 2), (1, 1))


def pool_last_axis2(x: torch.Tensor) -> torch.Tensor:
    """Window-2 stride-2 average pool along the LAST axis (floor semantics):
    the correlation pyramid's pooling of ``(B, H, W1, W2)`` over W2."""
    w = x.shape[-1] // 2 * 2
    return (x[..., 0:w:2] + x[..., 1:w:2]) / 2.0


def resize_bilinear_align_corners(x: torch.Tensor,
                                  size: Tuple[int, int]) -> torch.Tensor:
    """NHWC bilinear resize with ``align_corners=True`` semantics."""
    if tuple(x.shape[1:3]) == tuple(size):
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(size),
                      mode="bilinear", align_corners=True)
    return y.permute(0, 2, 3, 1)


def extract_3x3_patches(x: torch.Tensor) -> torch.Tensor:
    """Zero-padded 3x3 patches ``(B,H,W,C) -> (B,H,W,9,C)``; patch index
    ``k = 3*dy + dx`` (the channel order of ``F.unfold(x, 3, padding=1)``)."""
    h, w = x.shape[1], x.shape[2]
    padded = F.pad(x, (0, 0, 1, 1, 1, 1))
    shifts = [padded[:, dy:dy + h, dx:dx + w, :]
              for dy in range(3) for dx in range(3)]
    return torch.stack(shifts, dim=3)


def convex_upsample_tiles(flow: torch.Tensor, mask: torch.Tensor,
                          factor: int) -> torch.Tensor:
    """Convex upsampling of the x-flow channel as ``(B, h, w, f, f)`` tiles.

    ``mask`` is ``(B, h, w, 9*f*f)`` with channel index
    ``k*f*f + fy*f + fx``; the softmax runs over the 9 neighbours ``k``.
    """
    b, h, w, _ = flow.shape
    f2 = factor * factor
    m = torch.softmax(mask.reshape(b, h, w, 9, f2), dim=3)
    p = extract_3x3_patches(factor * flow[..., :1])[..., 0]  # (B,h,w,9)
    up = (m * p[..., None]).sum(dim=3)
    return up.reshape(b, h, w, factor, factor)


def upsample_tiles_to_image(up: torch.Tensor) -> torch.Tensor:
    """``(B, h, w, f, f)`` tiles -> ``(B, h*f, w*f, 1)`` image."""
    b, h, w, f, _ = up.shape
    return up.permute(0, 1, 3, 2, 4).reshape(b, h * f, w * f, 1)


def upsample_disparity_convex(flow: torch.Tensor, mask: torch.Tensor,
                              factor: int) -> torch.Tensor:
    """Single-channel convex upsampling: ``(B, h*f, w*f, 1)``."""
    return upsample_tiles_to_image(convex_upsample_tiles(flow, mask, factor))


class InputPadder:
    """Pads NHWC images so H, W are divisible by ``divis_by``, or to an
    explicit ``(H, W)`` bucket ``target``. The padding is split evenly
    left/right and top/bottom (the reference's "sintel" mode); replicate
    padding, exact unpad.
    """

    def __init__(self, dims: Sequence[int], divis_by: int = 8,
                 target: Optional[Tuple[int, int]] = None):
        self.ht, self.wd = dims[-3], dims[-2]
        if target is not None:
            th, tw = target
            if th < self.ht or tw < self.wd:
                raise ValueError(f"target {target} smaller than image "
                                 f"({self.ht}, {self.wd})")
            pad_ht, pad_wd = th - self.ht, tw - self.wd
        else:
            pad_ht = (((self.ht // divis_by) + 1) * divis_by
                      - self.ht) % divis_by
            pad_wd = (((self.wd // divis_by) + 1) * divis_by
                      - self.wd) % divis_by
        self._pad = [pad_wd // 2, pad_wd - pad_wd // 2,
                     pad_ht // 2, pad_ht - pad_ht // 2]

    def pad(self, *inputs: torch.Tensor):
        out = [F.pad(x.permute(0, 3, 1, 2), self._pad,
                     mode="replicate").permute(0, 2, 3, 1)
               for x in inputs]
        return out if len(out) > 1 else out[0]

    def unpad(self, x: torch.Tensor) -> torch.Tensor:
        l, r, t, b = self._pad
        ht, wd = x.shape[-3], x.shape[-2]
        return x[..., t:ht - b, l:wd - r, :]
