"""``windowed_sample``: the CUDA correlation-lookup kernels and their wrapper.

The kernels (``csrc/windowed_sample.cu``) replace the forward and the
backward of ``raft_stereo_tpu/ops/pallas/corr_kernels.py::
windowed_sample_pallas``, which ``raft_stereo_tpu/ops/corr.py::
_lookup_reg_pallas`` calls once a pyramid level. Here one forward launch
looks up 1 to 4 levels (level ``i`` around ``center / 2**i``) and one
backward launch writes every level's dense ``dvol``:

* :func:`windowed_sample_pyramid` — 1 to MAX_LEVELS levels, their taps in
  the ``reg`` lookup's channel order; a ``torch.autograd.Function``;
* :func:`windowed_sample` — one level: :func:`windowed_sample_pyramid` of
  one volume.

CUDA tensors launch the kernels, or raise; CPU tensors take the plain
PyTorch versions (:func:`windowed_sample_pyramid_plain`,
:func:`windowed_sample_pyramid_backward_plain` and their one-level forms),
which give the same numbers.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from raft_stereo_tpu_torch.ops.kernels._build import load_library
from raft_stereo_tpu_torch.ops.sampler import (scatter_window, window,
                                               window_grads,
                                               windowed_linear_sample)

KERNEL_NAME = "windowed_sample"
SOURCE = "raft_stereo_tpu_torch/csrc/windowed_sample.cu"
REPLACES = "raft_stereo_tpu/ops/pallas/corr_kernels.py:184"
REPLACES_BWD = "raft_stereo_tpu/ops/pallas/corr_kernels.py:211"

MAX_LEVELS = 4  # levels one launch takes
MAX_RADIUS = 8  # the kernels' tap counts are compile-time instantiations

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The plain forward of one level is the port's reference lookup itself.
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


def windowed_sample_pyramid_plain(levels: Sequence[torch.Tensor],
                                  center: torch.Tensor,
                                  radius: int) -> torch.Tensor:
    """:func:`windowed_sample_plain` of each level ``levels[i] (B, H, W1,
    W2_i)`` around ``center / 2**i``, concatenated: ``(B, H, W1,
    len(levels) * (2r+1))`` float32."""
    return torch.cat([windowed_sample_plain(v, center / (2 ** i), radius)
                      for i, v in enumerate(levels)], dim=-1)


def windowed_sample_pyramid_backward_plain(
        levels: Sequence[torch.Tensor], center: torch.Tensor,
        ct: torch.Tensor, radius: int
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor]:
    """Gradients of :func:`windowed_sample_pyramid_plain` for the cotangent
    ``ct (B, H, W1, len(levels) * (2r+1))``: ``(dvols, dcoords)``.

    Level ``i``'s ``dvol`` and ``dcoords_i`` are
    :func:`windowed_sample_backward_plain` of its window of ``ct`` around
    ``center / 2**i``; ``dcoords = sum_i dcoords_i / 2**i`` (each term
    exact), summed from the last level to the first: the order the
    kernel follows."""
    k = 2 * radius + 1
    dvols, dcoords = [], None
    for i in reversed(range(len(levels))):
        dvol, dc = windowed_sample_backward_plain(
            levels[i], center / (2 ** i), ct[..., i * k:(i + 1) * k], radius)
        dvols.append(dvol)
        dc = dc / (2 ** i)
        dcoords = dc if dcoords is None else dcoords + dc
    return tuple(reversed(dvols)), dcoords


def _library() -> ctypes.CDLL:
    lib = load_library(KERNEL_NAME)
    if lib.windowed_sample_fwd.argtypes is None:
        ptrs, ints = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(
            ctypes.c_int)
        lib.windowed_sample_fwd.argtypes = [
            ptrs, ints, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.windowed_sample_fwd.restype = ctypes.c_int
        lib.windowed_sample_bwd.argtypes = [
            ptrs, ptrs, ints, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.windowed_sample_bwd.restype = ctypes.c_int
        lib.windowed_sample_error_string.argtypes = [ctypes.c_int]
        lib.windowed_sample_error_string.restype = ctypes.c_char_p
    return lib


def _check_levels(levels: Sequence[torch.Tensor], center: torch.Tensor,
                  radius: int) -> None:
    """Raise unless there are 1 to MAX_LEVELS levels ``(B, H, W1, W2_i)``,
    all float32 or all bfloat16, over the fp32 ``center (B, H, W1)``, and
    ``radius`` is in ``[0, MAX_RADIUS]``: on any device."""
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"windowed_sample: {len(levels)} levels, want 1 to "
                         f"{MAX_LEVELS}")
    if levels[0].dtype not in _DTYPE_CODES or any(
            v.dtype != levels[0].dtype for v in levels):
        raise TypeError(f"windowed_sample: volume dtypes "
                        f"{[v.dtype for v in levels]} are not all float32 "
                        "or all bfloat16")
    if center.dtype != torch.float32:
        raise TypeError(f"windowed_sample: center dtype {center.dtype} is "
                        "not float32")
    prefix = tuple(center.shape)
    if len(prefix) != 3 or any(v.dim() != 4 or tuple(v.shape[:3]) != prefix
                               for v in levels):
        raise ValueError(
            f"windowed_sample: want volumes (B, H, W1, W2_i) and center "
            f"(B, H, W1), got {[tuple(v.shape) for v in levels]} and "
            f"{prefix}")
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"windowed_sample: radius {radius} outside [0, "
                         f"{MAX_RADIUS}]")


def _check(levels: Sequence[torch.Tensor], center: torch.Tensor,
           radius: int) -> None:
    """:func:`_check_levels`, and every tensor contiguous on one CUDA
    device: what the kernels take."""
    dev = center.device
    if dev.type != "cuda" or any(v.device != dev for v in levels):
        raise ValueError(
            f"windowed_sample: the volumes and center must lie on one CUDA "
            f"device (got {[str(v.device) for v in levels]} and {dev})")
    _check_levels(levels, center, radius)
    if not all(t.is_contiguous() for t in (*levels, center)):
        raise ValueError("windowed_sample: the volumes and center must be "
                         "contiguous")


def _raise_on(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"windowed_sample {what} launch failed: CUDA error {rc} "
            f"({lib.windowed_sample_error_string(rc).decode()})")


def _levels_args(levels: Sequence[torch.Tensor]):
    ptrs = (ctypes.c_void_p * MAX_LEVELS)(*[v.data_ptr() for v in levels])
    widths = (ctypes.c_int * MAX_LEVELS)(*[v.shape[-1] for v in levels])
    return ptrs, widths


def _pixel_stride(ct: torch.Tensor) -> Optional[int]:
    """The one stride between consecutive pixels' cotangent rows when
    ``ct``'s pixel dims collapse to one strided dim with a contiguous last
    dim (a slice of the levels' concatenation does), else None."""
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


def windowed_sample_pyramid_forward(levels: Sequence[torch.Tensor],
                                    center: torch.Tensor,
                                    radius: int) -> torch.Tensor:
    """Launch the forward kernel once for 1 to MAX_LEVELS levels on CUDA
    tensors (counted in ``windowed_sample.launches``): ``(B, H, W1,
    len(levels) * (2r+1))`` float32, level ``i`` around ``center /
    2**i``, written in place in that order; no autograd."""
    levels = tuple(levels)
    _check(levels, center, radius)
    k = 2 * radius + 1
    out = torch.empty(tuple(center.shape) + (len(levels) * k,),
                      dtype=torch.float32, device=center.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(center.device).cuda_stream
    lib = _library()
    rc = lib.windowed_sample_fwd(
        *_levels_args(levels), len(levels), center.data_ptr(), out.data_ptr(),
        center.numel(), radius, _DTYPE_CODES[levels[0].dtype], stream)
    _raise_on(lib, rc, "forward")
    windowed_sample.launches += 1
    return out


def windowed_sample_forward(volume: torch.Tensor, center: torch.Tensor,
                            radius: int) -> torch.Tensor:
    """Launch the forward kernel for one level on CUDA tensors (counted in
    ``windowed_sample.launches``); no autograd."""
    return windowed_sample_pyramid_forward((volume,), center, radius)


def windowed_sample_pyramid_backward(
        levels: Sequence[torch.Tensor], center: torch.Tensor,
        ct: torch.Tensor, radius: int, need_dvol: bool = True,
        need_dcoords: bool = True
) -> Tuple[Optional[Tuple[torch.Tensor, ...]], Optional[torch.Tensor]]:
    """Launch the backward kernels on CUDA tensors (one launch counted in
    ``windowed_sample.bwd_launches``): ``(dvols, dcoords)``, every level's
    dense ``dvol`` in the volume dtype written by one kernel, and
    ``dcoords`` (fp32, summed from the last level to the first); each None
    unless asked for. Two runs on the same inputs are bitwise equal."""
    levels = tuple(levels)
    _check(levels, center, radius)
    want = tuple(center.shape) + (len(levels) * (2 * radius + 1),)
    if tuple(ct.shape) != want or ct.device != center.device:
        raise ValueError(f"windowed_sample backward: cotangent "
                         f"{tuple(ct.shape)} on {ct.device}, want {want} on "
                         f"{center.device}")
    ct = ct.float()
    stride = _pixel_stride(ct)
    if stride is None:
        ct = ct.contiguous()
        stride = want[-1]
    dvols = (tuple(torch.empty_like(v, memory_format=torch.contiguous_format)
                   for v in levels) if need_dvol else None)
    dcoords = (torch.empty(center.shape, dtype=torch.float32,
                           device=center.device) if need_dcoords else None)
    if dvols is None and dcoords is None:
        return dvols, dcoords
    if center.numel() == 0:
        return dvols, dcoords
    stream = torch.cuda.current_stream(center.device).cuda_stream
    lib = _library()
    ptrs, widths = _levels_args(levels)
    rc = lib.windowed_sample_bwd(
        ptrs, None if dvols is None else _levels_args(dvols)[0], widths,
        len(levels), center.data_ptr(), ct.data_ptr(), stride,
        None if dcoords is None else dcoords.data_ptr(), center.numel(),
        radius, _DTYPE_CODES[levels[0].dtype], stream)
    _raise_on(lib, rc, "backward")
    windowed_sample.bwd_launches += 1
    return dvols, dcoords


def windowed_sample_backward(volume: torch.Tensor, center: torch.Tensor,
                             ct: torch.Tensor, radius: int,
                             need_dcoords: bool = True
                             ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the backward kernels for one level on CUDA tensors (counted
    in ``windowed_sample.bwd_launches``): ``(dvol, dcoords)``, with
    ``dcoords`` None unless ``need_dcoords``."""
    dvols, dcoords = windowed_sample_pyramid_backward(
        (volume,), center, ct, radius, need_dcoords=need_dcoords)
    return dvols[0], dcoords


def _on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


class _WindowedSamplePyramid(torch.autograd.Function):
    """The pyramid lookup with its hand-written backward: the kernels for
    CUDA tensors, the plain versions for CPU tensors. Only the inputs are
    saved; the backward recomputes the windows from the center."""

    @staticmethod
    def forward(ctx, center, radius, *levels):
        ctx.radius = radius
        ctx.save_for_backward(center, *levels)
        if _on_cpu(center, *levels):
            _check_levels(levels, center, radius)  # as the kernels check them
            return windowed_sample_pyramid_plain(levels, center, radius)
        return windowed_sample_pyramid_forward(levels, center, radius)

    @staticmethod
    def backward(ctx, ct):
        center, *levels = ctx.saved_tensors
        dcoords, dvols = windowed_sample_pyramid_vjp(
            levels, center, ct, ctx.radius, ctx.needs_input_grad[0],
            ctx.needs_input_grad[2:])
        return (dcoords, None, *dvols)


def windowed_sample_pyramid_vjp(levels: Sequence[torch.Tensor],
                                center: torch.Tensor, ct: torch.Tensor,
                                radius: int, need_dcoords: bool,
                                need_dvols: Sequence[bool]):
    """The gradients of :func:`windowed_sample_pyramid` for the cotangent
    ``ct``, computed without its forward: ``(dcoords, dvols)``, each entry
    None unless asked for. CUDA tensors launch the backward kernels once
    (counted in ``windowed_sample.bwd_launches``); CPU tensors take the
    plain version."""
    if _on_cpu(center, *levels):
        dvols, dcoords = windowed_sample_pyramid_backward_plain(
            levels, center, ct, radius)
    else:
        dvols, dcoords = windowed_sample_pyramid_backward(
            levels, center, ct, radius, need_dvol=any(need_dvols),
            need_dcoords=need_dcoords)
    dvols = dvols or (None,) * len(levels)
    return (dcoords if need_dcoords else None,
            tuple(dv if n else None for dv, n in zip(dvols, need_dvols)))


def windowed_sample_pyramid(levels: Sequence[torch.Tensor],
                            center: torch.Tensor,
                            radius: int) -> torch.Tensor:
    """2r+1-tap windowed linear sample of 1 to MAX_LEVELS pyramid levels
    ``levels[i] (B, H, W1, W2_i)`` (all fp32 or all bf16), level ``i``
    around ``center / 2**i`` (``center (B, H, W1)``, level-0 pixels) ->
    ``(B, H, W1, len(levels) * (2r+1))`` float32, level ``i``'s taps at
    ``[i (2r+1), (i+1) (2r+1))``; differentiable in every level and in the
    center.

    CUDA tensors launch the forward kernel once (counted in
    ``windowed_sample.launches``) and the backward kernels once (counted in
    ``windowed_sample.bwd_launches``), or raise; CPU tensors take the plain
    versions, forward and backward. Same numbers as the levels'
    :func:`raft_stereo_tpu_torch.ops.sampler.windowed_linear_sample`
    concatenated.
    """
    return _WindowedSamplePyramid.apply(center, radius, *levels)


def windowed_sample(volume: torch.Tensor, center: torch.Tensor,
                    radius: int) -> torch.Tensor:
    """2r+1-tap windowed linear sample of ``volume (B, H, W1, W2)`` around
    ``center (B, H, W1)`` -> ``(B, H, W1, 2r+1)`` float32, differentiable
    in both inputs: :func:`windowed_sample_pyramid` of one level.

    CUDA tensors launch the kernels (forward launches counted in
    ``windowed_sample.launches``, backward launches in
    ``windowed_sample.bwd_launches``) or raise; CPU tensors take the plain
    versions, forward and backward. Same numbers as
    :func:`raft_stereo_tpu_torch.ops.sampler.windowed_linear_sample`.
    """
    return _WindowedSamplePyramid.apply(center, radius, volume)


#: forward kernel launches since the count was last set to 0
windowed_sample.launches = 0
#: backward launches (dvol and dcoords together) since the count was last
#: set to 0
windowed_sample.bwd_launches = 0
