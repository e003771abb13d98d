"""``windowed_sample``: the CUDA correlation-lookup kernels and their wrapper.

The kernels (``csrc/windowed_sample.cu``) replace the forward and the
backward of ``raft_stereo_tpu/ops/pallas/corr_kernels.py::
windowed_sample_pallas``. :func:`windowed_sample` is a
``torch.autograd.Function``: CUDA tensors launch the forward kernel, and
the backward kernel when a gradient is taken, or raise; CPU tensors take
the plain PyTorch versions (:func:`windowed_sample_plain` and
:func:`windowed_sample_backward_plain`).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from raft_stereo_tpu_torch.ops.kernels._build import load_library
from raft_stereo_tpu_torch.ops.sampler import (scatter_window, window,
                                               window_grads,
                                               windowed_linear_sample)

KERNEL_NAME = "windowed_sample"
SOURCE = "raft_stereo_tpu_torch/csrc/windowed_sample.cu"
REPLACES = "raft_stereo_tpu/ops/pallas/corr_kernels.py:184"
REPLACES_BWD = "raft_stereo_tpu/ops/pallas/corr_kernels.py:211"

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The plain forward is the port's reference lookup itself.
windowed_sample_plain = windowed_linear_sample


def windowed_sample_backward_plain(
        volume: torch.Tensor, center: torch.Tensor, ct: torch.Tensor,
        radius: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients of :func:`windowed_sample_plain` for the output cotangent
    ``ct (B, H, W1, 2r+1)``: ``(dvol, dcoords)``.

    ``dg_j = (1-f)*ct_j + f*ct_{j-1}`` for ``j in [0, 2r+1]`` (taps
    outside the cotangent are 0) lands at ``dvol[..., base+j]`` where that
    lies in ``[0, W2)``; everything else in the row is 0. ``dg`` is fp32
    and ``dvol`` is rounded once to the volume's dtype. ``dcoords =
    sum_k ct_k*(g_{k+1} - g_k)`` is fp32. Same clamped base as the
    forward (a NaN center takes base ``-r``).
    """
    w = volume.shape[-1]
    k = 2 * radius + 1
    base, frac = window(center, w, radius)
    ct = ct.float()
    dvol = scatter_window(window_grads(ct, frac), base, w)
    idx = base[..., None] + torch.arange(k + 1, device=volume.device)
    g = torch.gather(volume, -1, idx.clamp(0, w - 1)).float()
    g = torch.where((idx >= 0) & (idx < w), g,
                    torch.zeros((), device=g.device))
    dcoords = (ct * (g[..., 1:] - g[..., :-1])).sum(dim=-1)
    return dvol.to(volume.dtype), dcoords


def _library() -> ctypes.CDLL:
    lib = load_library(KERNEL_NAME)
    if lib.windowed_sample_fwd.argtypes is None:
        lib.windowed_sample_fwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.windowed_sample_fwd.restype = ctypes.c_int
        lib.windowed_sample_bwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p]
        lib.windowed_sample_bwd.restype = ctypes.c_int
        lib.windowed_sample_error_string.argtypes = [ctypes.c_int]
        lib.windowed_sample_error_string.restype = ctypes.c_char_p
    return lib


def _check(volume: torch.Tensor, center: torch.Tensor) -> None:
    if volume.device.type != "cuda" or center.device != volume.device:
        raise ValueError(
            f"windowed_sample: volume and center must lie on one CUDA "
            f"device (got {volume.device} and {center.device})")
    if volume.dtype not in _DTYPE_CODES:
        raise TypeError(f"windowed_sample: volume dtype {volume.dtype} is "
                        "not float32 or bfloat16")
    if center.dtype != torch.float32:
        raise TypeError(f"windowed_sample: center dtype {center.dtype} is "
                        "not float32")
    if volume.dim() != 4 or tuple(center.shape) != tuple(volume.shape[:3]):
        raise ValueError(
            f"windowed_sample: want volume (B, H, W1, W2) and center "
            f"(B, H, W1), got {tuple(volume.shape)} and "
            f"{tuple(center.shape)}")
    if not (volume.is_contiguous() and center.is_contiguous()):
        raise ValueError("windowed_sample: volume and center must be "
                         "contiguous")


def _raise_on(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"windowed_sample {what} launch failed: CUDA error {rc} "
            f"({lib.windowed_sample_error_string(rc).decode()})")


def _pixel_stride(ct: torch.Tensor) -> Optional[int]:
    """The one stride between consecutive pixels' cotangent rows when
    ``ct``'s pixel dims collapse to one strided dim with a contiguous last
    dim (a slice of the 4-level concatenation does), else None."""
    if ct.stride(-1) != 1 and ct.shape[-1] > 1:
        return None
    stride = None
    expect = None
    for size, st in zip(reversed(ct.shape[:-1]), reversed(ct.stride()[:-1])):
        if size == 1:
            continue
        if stride is None:
            stride = expect = st
        elif st != expect:
            return None
        expect = expect * size
    return ct.shape[-1] if stride is None else stride


def windowed_sample_forward(volume: torch.Tensor, center: torch.Tensor,
                            radius: int) -> torch.Tensor:
    """Launch the forward kernel on CUDA tensors (counted in
    ``windowed_sample.launches``); no autograd."""
    _check(volume, center)
    out = torch.empty(tuple(volume.shape[:3]) + (2 * radius + 1,),
                      dtype=torch.float32, device=volume.device)
    if out.numel() == 0:
        return out
    n_pix = volume.shape[0] * volume.shape[1] * volume.shape[2]
    stream = torch.cuda.current_stream(volume.device).cuda_stream
    lib = _library()
    rc = lib.windowed_sample_fwd(volume.data_ptr(), center.data_ptr(),
                                 out.data_ptr(), n_pix, volume.shape[3],
                                 radius, _DTYPE_CODES[volume.dtype], stream)
    _raise_on(lib, rc, "forward")
    windowed_sample.launches += 1
    return out


def windowed_sample_backward(volume: torch.Tensor, center: torch.Tensor,
                             ct: torch.Tensor, radius: int,
                             need_dcoords: bool = True
                             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the backward kernel on CUDA tensors (counted in
    ``windowed_sample.bwd_launches``): ``(dvol, dcoords)``, with
    ``dcoords`` None unless ``need_dcoords``."""
    _check(volume, center)
    k = 2 * radius + 1
    if tuple(ct.shape) != tuple(volume.shape[:3]) + (k,):
        raise ValueError(f"windowed_sample backward: cotangent shape "
                         f"{tuple(ct.shape)}, want {tuple(volume.shape[:3])}"
                         f" + ({k},)")
    if ct.device != volume.device:
        raise ValueError("windowed_sample backward: the cotangent lies on "
                         f"{ct.device}, the volume on {volume.device}")
    ct = ct.float()
    stride = _pixel_stride(ct)
    if stride is None:
        ct = ct.contiguous()
        stride = k
    dvol = torch.empty_like(volume, memory_format=torch.contiguous_format)
    dcoords = (torch.empty(center.shape, dtype=torch.float32,
                           device=volume.device) if need_dcoords else None)
    if dvol.numel() == 0:
        if dcoords is not None:
            dcoords.zero_()
        return dvol, dcoords
    if dvol.data_ptr() % 16:
        raise RuntimeError("windowed_sample backward: dvol is not 16-byte "
                           "aligned")
    n_pix = volume.shape[0] * volume.shape[1] * volume.shape[2]
    stream = torch.cuda.current_stream(volume.device).cuda_stream
    lib = _library()
    rc = lib.windowed_sample_bwd(
        volume.data_ptr(), center.data_ptr(), ct.data_ptr(), dvol.data_ptr(),
        dcoords.data_ptr() if dcoords is not None else None, n_pix,
        volume.shape[3], radius, stride, _DTYPE_CODES[volume.dtype], stream)
    _raise_on(lib, rc, "backward")
    windowed_sample.bwd_launches += 1
    return dvol, dcoords


def _on_cpu(volume: torch.Tensor, center: torch.Tensor) -> bool:
    return volume.device.type == "cpu" and center.device.type == "cpu"


class _WindowedSample(torch.autograd.Function):
    """The lookup with its hand-written backward: the kernels for CUDA
    tensors, the plain versions for CPU tensors. The backward recomputes
    only the window base from the saved center."""

    @staticmethod
    def forward(ctx, volume, center, radius):
        ctx.radius = radius
        ctx.save_for_backward(volume, center)
        if _on_cpu(volume, center):
            return windowed_sample_plain(volume, center, radius)
        return windowed_sample_forward(volume, center, radius)

    @staticmethod
    def backward(ctx, ct):
        volume, center = ctx.saved_tensors
        if _on_cpu(volume, center):
            dvol, dcoords = windowed_sample_backward_plain(
                volume, center, ct, ctx.radius)
        else:
            dvol, dcoords = windowed_sample_backward(
                volume, center, ct, ctx.radius,
                need_dcoords=ctx.needs_input_grad[1])
        return (dvol if ctx.needs_input_grad[0] else None,
                dcoords if ctx.needs_input_grad[1] else None, None)


def windowed_sample(volume: torch.Tensor, center: torch.Tensor,
                    radius: int) -> torch.Tensor:
    """2r+1-tap windowed linear sample of ``volume (B, H, W1, W2)`` around
    ``center (B, H, W1)`` -> ``(B, H, W1, 2r+1)`` float32, differentiable
    in both inputs.

    CUDA tensors launch the kernels (forward launches counted in
    ``windowed_sample.launches``, backward launches in
    ``windowed_sample.bwd_launches``) or raise; CPU tensors take the plain
    versions, forward and backward. Same numbers as
    :func:`raft_stereo_tpu_torch.ops.sampler.windowed_linear_sample`.
    """
    return _WindowedSample.apply(volume, center, radius)


#: forward kernel launches since the count was last set to 0
windowed_sample.launches = 0
#: backward kernel launches since the count was last set to 0
windowed_sample.bwd_launches = 0
