"""``alt_corr``: the on-chip correlation slab's windowed lookup, its CUDA
kernels and their wrapper.

The kernels (``csrc/alt_corr.cu``) replace the forward and the backward of
``raft_stereo_tpu/ops/pallas/corr_kernels.py::alt_windowed_corr_pallas``:
the correlation slab ``fmap1 . fmap2^T / sqrt(D)`` of one pyramid level,
built tile by tile in shared memory and registers, then the ``2r+1``-tap
window of each pixel's slab row. It computes the same function as
``fused_corr`` (B2) by the TPU kernel's other formulation, a dense product
per row block. :func:`alt_corr` is a ``torch.autograd.Function``: CUDA
tensors launch the forward kernel, and the backward kernels when a gradient
is taken, or raise; CPU tensors take the plain PyTorch versions
(:func:`alt_corr_plain` and :func:`alt_corr_backward_plain`), which follow
the TPU kernel: the slab, scaled before the window. There is no gradient
for the center.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from raft_stereo_tpu_torch.ops.kernels._build import load_library
from raft_stereo_tpu_torch.ops.kernels.fused_corr import (DTYPE_CODES,
                                                          check_feature_inputs,
                                                          on_cpu)
from raft_stereo_tpu_torch.ops.sampler import (scatter_window, window,
                                               window_grads,
                                               windowed_linear_sample)

KERNEL_NAME = "alt_corr"
SOURCE = "raft_stereo_tpu_torch/csrc/alt_corr.cu"
REPLACES = "raft_stereo_tpu/ops/pallas/corr_kernels.py:316"
REPLACES_BWD = "raft_stereo_tpu/ops/pallas/corr_kernels.py:350"


def _slab(fmap1: torch.Tensor, fmap2: torch.Tensor) -> torch.Tensor:
    """``fmap1 . fmap2^T / sqrt(D)`` per row, ``(B, H, W1, W2)`` fp32."""
    scale = 1.0 / math.sqrt(fmap1.shape[-1])
    return torch.matmul(fmap1.float(), fmap2.float().transpose(-1, -2)) \
        * scale


def alt_corr_plain(fmap1: torch.Tensor, fmap2: torch.Tensor,
                   center: torch.Tensor, radius: int) -> torch.Tensor:
    """The lookup in plain PyTorch, as the TPU kernel computes it: the
    level's slab ``vol = fmap1 . fmap2^T / sqrt(D)`` in fp32 (``(B, H, W1,
    W2)``, a transient here), then the ``2r+1``-tap window of
    :func:`~raft_stereo_tpu_torch.ops.sampler.windowed_linear_sample`.
    ``fmap1 (B, H, W1, D)``, ``fmap2 (B, H, W2, D)`` fp32 or bf16, ``center
    (B, H, W1)`` -> ``(B, H, W1, 2r+1)`` float32."""
    return windowed_linear_sample(_slab(fmap1, fmap2), center, radius)


def alt_corr_backward_plain(
        fmap1: torch.Tensor, fmap2: torch.Tensor, center: torch.Tensor,
        ct: torch.Tensor, radius: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients of :func:`alt_corr_plain` in ``fmap1`` and ``fmap2`` for
    the output cotangent ``ct (B, H, W1, 2r+1)``: ``(df1, df2)``.

    ``dg_j = ((1-f)*ct_j + f*ct_{j-1}) / sqrt(D)`` scattered into the dense
    band ``dvol (B, H, W1, W2)`` (fp32), then ``df1 = dvol . fmap2`` and
    ``df2 = dvol^T . fmap1`` in fp32, each rounded once to the feature
    dtype (the TPU kernel's ``_alt_bwd_kernel``)."""
    w2, d = fmap2.shape[2], fmap2.shape[3]
    base, frac = window(center, w2, radius)
    dg = window_grads(ct, frac) * (1.0 / math.sqrt(d))
    dvol = scatter_window(dg, base, w2)
    df1 = torch.matmul(dvol, fmap2.float())
    df2 = torch.matmul(dvol.transpose(-1, -2), fmap1.float())
    return df1.to(fmap1.dtype), df2.to(fmap2.dtype)


def _library() -> ctypes.CDLL:
    lib = load_library(KERNEL_NAME)
    if lib.alt_corr_fwd.argtypes is None:
        lib.alt_corr_fwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.alt_corr_fwd.restype = ctypes.c_int
        lib.alt_corr_bwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.alt_corr_bwd.restype = ctypes.c_int
        lib.alt_corr_error_string.argtypes = [ctypes.c_int]
        lib.alt_corr_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"alt_corr {what} launch failed: CUDA error {rc} "
            f"({lib.alt_corr_error_string(rc).decode()})")


def alt_corr_forward(fmap1: torch.Tensor, fmap2: torch.Tensor,
                     center: torch.Tensor, radius: int) -> torch.Tensor:
    """Launch the forward kernel on CUDA tensors (counted in
    ``alt_corr.launches``); no autograd."""
    check_feature_inputs("alt_corr", fmap1, fmap2, center, radius)
    b, h, w1, d = fmap1.shape
    out = torch.empty((b, h, w1, 2 * radius + 1), dtype=torch.float32,
                      device=fmap1.device)
    if out.numel() == 0:
        return out
    if fmap2.shape[2] == 0 or d == 0:
        return out.zero_()
    stream = torch.cuda.current_stream(fmap1.device).cuda_stream
    lib = _library()
    rc = lib.alt_corr_fwd(fmap1.data_ptr(), fmap2.data_ptr(),
                          center.data_ptr(), out.data_ptr(), b * h, w1,
                          fmap2.shape[2], d, radius, DTYPE_CODES[fmap1.dtype],
                          stream)
    _raise_on(lib, rc, "forward")
    alt_corr.launches += 1
    return out


def alt_corr_backward(fmap1: torch.Tensor, fmap2: torch.Tensor,
                      center: torch.Tensor, ct: torch.Tensor, radius: int,
                      need_df1: bool = True, need_df2: bool = True
                      ) -> Tuple[Optional[torch.Tensor],
                                 Optional[torch.Tensor]]:
    """Launch the backward kernels on CUDA tensors (one launch counted in
    ``alt_corr.bwd_launches``): ``(df1, df2)`` in the feature dtype, each
    None unless asked for. The band (each pixel's window base and tap
    gradients) is computed once into a scratch buffer of ``2r+3`` words a
    pixel. Two runs on the same inputs are bitwise equal."""
    check_feature_inputs("alt_corr", fmap1, fmap2, center, radius)
    b, h, w1, d = fmap1.shape
    w2 = fmap2.shape[2]
    k = 2 * radius + 1
    if tuple(ct.shape) != (b, h, w1, k):
        raise ValueError(f"alt_corr backward: cotangent shape "
                         f"{tuple(ct.shape)}, want {(b, h, w1, k)}")
    if ct.device != fmap1.device:
        raise ValueError("alt_corr backward: the cotangent lies on "
                         f"{ct.device}, the features on {fmap1.device}")
    ct = ct.float().contiguous()
    df1 = torch.empty_like(fmap1) if need_df1 else None
    df2 = torch.empty_like(fmap2) if need_df2 else None
    if df1 is None and df2 is None:
        return df1, df2
    if b * h * w1 == 0 or w2 == 0 or d == 0:
        return (None if df1 is None else df1.zero_(),
                None if df2 is None else df2.zero_())
    stream = torch.cuda.current_stream(fmap1.device).cuda_stream
    lib = _library()
    scratch = torch.empty(b * h * w1 * (k + 2), dtype=torch.int32,
                          device=fmap1.device)
    rc = lib.alt_corr_bwd(
        fmap1.data_ptr(), fmap2.data_ptr(), center.data_ptr(), ct.data_ptr(),
        None if df1 is None else df1.data_ptr(),
        None if df2 is None else df2.data_ptr(), scratch.data_ptr(), b * h,
        w1, w2, d, radius, DTYPE_CODES[fmap1.dtype], stream)
    _raise_on(lib, rc, "backward")
    alt_corr.bwd_launches += 1
    return df1, df2


class _AltCorr(torch.autograd.Function):
    """The slab lookup with its hand-written backward: the kernels for CUDA
    tensors, the plain versions for CPU tensors. Only the inputs are saved;
    the backward recomputes the window from the center."""

    @staticmethod
    def forward(ctx, fmap1, fmap2, center, radius):
        ctx.radius = radius
        ctx.save_for_backward(fmap1, fmap2, center)
        if on_cpu(fmap1, fmap2, center):
            return alt_corr_plain(fmap1, fmap2, center, radius)
        return alt_corr_forward(fmap1, fmap2, center, radius)

    @staticmethod
    def backward(ctx, ct):
        fmap1, fmap2, center = ctx.saved_tensors
        need1, need2 = ctx.needs_input_grad[:2]
        if on_cpu(fmap1, fmap2, center):
            df1, df2 = alt_corr_backward_plain(fmap1, fmap2, center, ct,
                                               ctx.radius)
        else:
            df1, df2 = alt_corr_backward(fmap1, fmap2, center, ct,
                                         ctx.radius, need_df1=need1,
                                         need_df2=need2)
        return (df1 if need1 else None, df2 if need2 else None, None, None)


def alt_corr(fmap1: torch.Tensor, fmap2: torch.Tensor, center: torch.Tensor,
             radius: int) -> torch.Tensor:
    """Windowed lookup of the correlation slab of ``fmap1 (B, H, W1, D)``
    with one pyramid level ``fmap2 (B, H, W2, D)`` around ``center (B, H,
    W1)`` -> ``(B, H, W1, 2r+1)`` float32, differentiable in both feature
    maps (the center gets no gradient).

    CUDA tensors launch the kernels (forward launches counted in
    ``alt_corr.launches``, backward launches in ``alt_corr.bwd_launches``)
    or raise; CPU tensors take the plain versions, forward and backward.
    """
    return _AltCorr.apply(fmap1, fmap2, center, radius)


#: forward kernel launches since the count was last set to 0
alt_corr.launches = 0
#: backward launches (the df1 and df2 kernels together) since the count was
#: last set to 0
alt_corr.bwd_launches = 0
