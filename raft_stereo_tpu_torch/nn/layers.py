"""Convolution and normalization building blocks (NHWC at the interface).

Counterparts of ``raft_stereo_tpu.nn.layers``. Activations are NHWC like
the JAX package; ``Conv`` hands ``F.conv2d`` a channels-first view, or, for
the convolutions where cuDNN's heuristic takes its FFT path, PyTorch's own
im2col + GEMM convolution (see :func:`cudnn_takes_fft`).
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


def cudnn_takes_fft(conv: nn.Conv2d, x: torch.Tensor,
                    w: Optional[torch.Tensor] = None) -> bool:
    """Whether cuDNN's heuristic takes its FFT path for ``conv`` on the
    channels-first input ``x``, contracting the weight ``w`` (default: the
    module's own; its shape decides, so that a weight stacking several
    convolutions' outputs is judged as the convolution it is). It does
    (cuDNN 9, fp32 with cuDNN's TF32 off, no cudnn.benchmark) for 3x3
    stride-1 convolutions of 256 channels into 128 with N*H*W in about [16384, 50000], e.g. update_block.gru32's
    gate convs at 1/16 of a 2016x2880 pair (1, 126, 180): an FFT of
    ~33,000 kernels, 218-382 ms a call, where PyTorch's own im2col + GEMM
    convolution takes 0.56-1.11 ms; no layout or scoped cuDNN flag moved
    it off FFT. Of the sweep's other shapes, only 64 channels into 64 at
    (2, 126, 180) and (8, 20, 45) took a small FFT (3.2 ms against
    im2col's 0.24; 0.15 ms, faster than im2col's 0.31), at batch sizes no
    path of the port runs at those widths (scripts/profile_torch_main_path.py
    --conv_sweep, NVIDIA H100 80GB HBM3). The flags are read, never
    set."""
    cout, cin = (conv.out_channels, conv.in_channels) if w is None \
        else tuple(w.shape[:2])
    return (x.is_cuda and x.dtype == torch.float32
            and torch.backends.cudnn.enabled
            and not torch.backends.cudnn.allow_tf32
            and conv.kernel_size == (3, 3) and conv.stride == (1, 1)
            and conv.groups == 1 and cin == 256 and cout == 128
            and 16384 <= x.shape[0] * x.shape[2] * x.shape[3] <= 50000)


class Conv(nn.Conv2d):
    """``nn.Conv2d`` on NHWC activations, computed in ``dtype`` (fp32 when
    None) with fp32 parameters. Where cuDNN would take its FFT path
    (:func:`cudnn_takes_fft`) it runs PyTorch's im2col + GEMM convolution
    (``aten::thnn_conv2d``) instead: the same choice in every process, and
    no global flag touched."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, padding: int = 0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_channels, out_channels, kernel_size, stride,
                         padding)
        self.compute_dtype = dtype or torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return self.conv_with(x, self.weight.to(dt), self.bias.to(dt))

    def conv_with(self, x: torch.Tensor, w: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
        """This convolution of ``x`` (NHWC) with the weight ``w`` and bias
        ``b`` given in the compute dtype, on the route :meth:`forward`
        takes (the refinement's custom backward passes detached
        weights)."""
        x = x.permute(0, 3, 1, 2).to(self.compute_dtype)
        if cudnn_takes_fft(self, x, w):
            y = torch.ops.aten.thnn_conv2d(x, w, self.kernel_size, b,
                                           self.stride, self.padding)
        else:
            y = F.conv2d(x, w, b, self.stride, self.padding)
        return y.permute(0, 2, 3, 1)

    def conv_backward(self, x: torch.Tensor, w: torch.Tensor,
                      g: torch.Tensor, mask, groups: int = 1):
        """``(dx, dw, db)`` of :meth:`conv_with` for the output cotangent
        ``g``: ``x`` and ``g`` NHWC (``g`` in ``w``'s dtype; ``w`` may
        stack the weights of several convolutions of the same input along
        its output axis), each None unless ``mask`` asks for it, ``dx``
        NHWC, on the route :meth:`forward` takes for ``x``
        (``aten.convolution_backward``, or the im2col convolution's
        backward where cuDNN would take its FFT path). ``groups``: the
        channels of ``x``, ``g`` and ``w`` split into that many
        independent convolutions (:meth:`weight_grad`'s blocks)."""
        xn = x.permute(0, 3, 1, 2).to(w.dtype)
        gn = g.permute(0, 3, 1, 2)
        mask = [bool(m) for m in mask]
        if groups == 1 and cudnn_takes_fft(self, xn, w):
            dx, dw, db = torch.ops.aten._slow_conv2d_backward.output_mask(
                gn, xn, w, self.kernel_size, self.stride, self.padding,
                mask)
        else:
            dx, dw, db = torch.ops.aten.convolution_backward(
                gn, xn, w, [w.shape[0]] if mask[2] else None, self.stride,
                self.padding, self.dilation, False, [0, 0], groups, mask)
        return (None if dx is None else dx.permute(0, 2, 3, 1)), dw, db

    def weight_grad(self, x: torch.Tensor, g: torch.Tensor,
                    groups: int = 1) -> torch.Tensor:
        """The weight gradient ``(g.shape[-1], Cin, k, k)``, in fp32, for
        the inputs ``x (N, H, W, Cin)`` and the output cotangents ``g (N,
        H, W, Cout')`` of one dtype (Cout' may cover several convolutions
        of the same input), on the route of :meth:`conv_backward`, with
        fp32 sums and an fp32 output. N is split into ``groups`` equal
        blocks (the refinement's iterations) contracted as the groups of
        ONE grouped convolution, so that each fp32 sum runs over a block's
        terms, and the blocks' partial gradients are summed in fp32 after:
        one fp32 sum over all of them (~2.5M terms a weight at the recipe)
        drifted ~7e-3 from a float64 contraction on the card. bf16 inputs
        are widened to fp32 in the same copy: a bf16 value is exact in
        fp32 and in TF32, so each product is exact in whichever fp32 mode
        the process gives cuDNN (PyTorch's default allows TF32; no flag is
        read or set here)."""
        k = tuple(self.kernel_size)
        cin, cout = x.shape[-1], g.shape[-1]
        if groups == 1:
            xs, gs = x.float(), g.float()
        else:
            n = x.shape[0] // groups

            def blocks(t):
                # (groups * n, H, W, C) -> (n, H, W, groups * C), fp32
                out = torch.empty((n,) + tuple(t.shape[1:3])
                                  + (groups, t.shape[-1]),
                                  dtype=torch.float32, device=t.device)
                out.copy_(t.reshape((groups, n) + tuple(t.shape[1:]))
                          .permute(1, 2, 3, 0, 4))
                return out.flatten(3)
            xs, gs = blocks(x), blocks(g)
        w = torch.zeros((groups * cout, cin) + k, dtype=torch.float32,
                        device=g.device)
        dw = self.conv_backward(xs, w, gs, (False, True, False),
                                groups=groups)[1]
        return dw.reshape((groups, cout, cin) + k).sum(0)


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
