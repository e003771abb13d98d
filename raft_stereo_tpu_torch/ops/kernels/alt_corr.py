"""``alt_corr``: the correlation slab's windowed lookup, its CUDA kernels
and their wrapper.

The kernels (``csrc/alt_corr.cu``) replace the forward and the backward of
``raft_stereo_tpu/ops/pallas/corr_kernels.py::alt_windowed_corr_pallas``:
the ``2r+1``-tap window of each pixel's row of the correlation slab
``fmap1 . fmap2^T / sqrt(D)`` of one pyramid level. It computes the same
function as ``fused_corr`` (B2). The forward computes only the slab entries
a window reads, one launch for 1 to 4 levels (the staged-span design it
shares with ``fused_corr``); the backward multiplies the band of the slab's
gradient over its nonzeros.

* :func:`alt_corr` — one level, a ``torch.autograd.Function``;
* :func:`alt_corr_pyramid` — 1 to 4 levels in one forward launch, their
  taps concatenated as the ``reg`` lookup orders them; its backward runs
  the per-level backward kernels.

CUDA tensors launch the kernels, or raise; CPU tensors take the plain
PyTorch versions (:func:`alt_corr_plain`, :func:`alt_corr_pyramid_plain`
and :func:`alt_corr_backward_plain`). The plain forward sums each slab
entry in the kernel's order, so the two are bitwise equal; the plain
backward follows the TPU kernel (the dense band, then two products). There
is no gradient for the center.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from raft_stereo_tpu_torch.ops.kernels._build import load_library
from raft_stereo_tpu_torch.ops.kernels.fused_corr import (
    DTYPE_CODES, check_feature_inputs, launch_pyramid, pyramid_function,
    raise_on)
from raft_stereo_tpu_torch.ops.sampler import (scatter_window, window,
                                               window_grads)

KERNEL_NAME = "alt_corr"
SOURCE = "raft_stereo_tpu_torch/csrc/alt_corr.cu"
REPLACES = "raft_stereo_tpu/ops/pallas/corr_kernels.py:316"
REPLACES_BWD = "raft_stereo_tpu/ops/pallas/corr_kernels.py:350"


def _slab_entries(fmap1: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """``<fmap1, rows[..., j, :]>`` for every ``j``: ``fmap1 (..., D)``,
    ``rows (..., J, D)`` -> ``(..., J)`` fp32, summed in the forward
    kernel's order: each product rounded, element ``d`` added (rounded) to
    partial sum ``(d // V) % 4`` in ascending ``d`` (``V`` elements of the
    feature dtype a 16-byte chunk), then ``(s0 + s1) + (s2 + s3)``."""
    v = 16 // fmap1.element_size()
    prod = fmap1.float()[..., None, :] * rows.float()
    pad = (-prod.shape[-1]) % (4 * v)
    if pad:  # zeros leave every partial sum as it is
        prod = F.pad(prod, (0, pad))
    prod = prod.reshape(*prod.shape[:-1], -1, 4, v)
    acc = torch.zeros(prod.shape[:-3] + (4,), dtype=torch.float32,
                      device=prod.device)
    for n in range(prod.shape[-3]):
        for e in range(v):
            acc = acc + prod[..., n, :, e]
    return (acc[..., 0] + acc[..., 1]) + (acc[..., 2] + acc[..., 3])


def alt_corr_plain(fmap1: torch.Tensor, fmap2: torch.Tensor,
                   center: torch.Tensor, radius: int) -> torch.Tensor:
    """The lookup in plain PyTorch: the slab entries ``vol[w1, base + j] =
    <fmap1[w1], fmap2[base + j]> / sqrt(D)`` that the ``2r+1``-tap window
    of :func:`~raft_stereo_tpu_torch.ops.sampler.windowed_linear_sample`
    reads (0 outside ``[0, W2)``), blended in fp32. ``fmap1 (B, H, W1,
    D)``, ``fmap2 (B, H, W2, D)`` fp32 or bf16, ``center (B, H, W1)`` ->
    ``(B, H, W1, 2r+1)`` float32, bitwise equal to the CUDA kernel (the
    same order of summation, scale and blend, each operation rounded)."""
    w2, d = fmap2.shape[2], fmap2.shape[3]
    k = 2 * radius + 1
    base, frac = window(center, w2, radius)
    idx = base[..., None] + torch.arange(k + 1, device=fmap1.device)
    valid = (idx >= 0) & (idx < w2)
    flat = idx.clamp(0, w2 - 1).flatten(2)  # (B, H, W1 (2r+2))
    rows = torch.gather(fmap2, 2, flat[..., None].expand(*flat.shape, d))
    rows = rows.view(*idx.shape, d)
    scale = 1.0 / torch.sqrt(torch.tensor(float(d), device=fmap1.device))
    g = torch.where(valid, _slab_entries(fmap1, rows) * scale,
                    torch.zeros((), device=fmap1.device))
    return (1.0 - frac) * g[..., :k] + frac * g[..., 1:]


def alt_corr_pyramid_plain(fmap1: torch.Tensor, levels, center: torch.Tensor,
                           radius: int) -> torch.Tensor:
    """:func:`alt_corr_plain` of ``fmap1`` with each level ``levels[i] (B,
    H, W2_i, D)`` around ``center / 2**i``, concatenated: ``(B, H, W1,
    len(levels) * (2r+1))`` float32."""
    return torch.cat([alt_corr_plain(fmap1, f2, center / (2 ** i), radius)
                      for i, f2 in enumerate(levels)], dim=-1)


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
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
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


def alt_corr_pyramid_forward(fmap1: torch.Tensor, levels,
                             center: torch.Tensor, radius: int) -> torch.Tensor:
    """Launch the forward kernel once for 1 to MAX_LEVELS levels on CUDA
    tensors (counted in ``alt_corr.launches``): ``fused_corr``'s
    :func:`launch_pyramid`; no autograd."""
    out, launched = launch_pyramid(KERNEL_NAME, _library, fmap1, levels,
                                   center, radius)
    alt_corr.launches += launched
    return out


def alt_corr_forward(fmap1: torch.Tensor, fmap2: torch.Tensor,
                     center: torch.Tensor, radius: int) -> torch.Tensor:
    """Launch the forward kernel for one level on CUDA tensors (counted in
    ``alt_corr.launches``); no autograd."""
    return alt_corr_pyramid_forward(fmap1, (fmap2,), center, radius)


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
    raise_on(lib, KERNEL_NAME, rc, "backward")
    alt_corr.bwd_launches += 1
    return df1, df2


_AltCorrPyramid = pyramid_function(
    "_AltCorrPyramid", alt_corr_pyramid_plain, alt_corr_pyramid_forward,
    alt_corr_backward_plain, alt_corr_backward)


def alt_corr(fmap1: torch.Tensor, fmap2: torch.Tensor, center: torch.Tensor,
             radius: int) -> torch.Tensor:
    """Windowed lookup of the correlation slab of ``fmap1 (B, H, W1, D)``
    with one pyramid level ``fmap2 (B, H, W2, D)`` around ``center (B, H,
    W1)`` -> ``(B, H, W1, 2r+1)`` float32, differentiable in both feature
    maps (the center gets no gradient).

    CUDA tensors launch the kernels (forward launches counted in
    ``alt_corr.launches``, backward launches in ``alt_corr.bwd_launches``)
    or raise; CPU tensors take the plain versions, forward and backward.
    It is :func:`alt_corr_pyramid` of one level.
    """
    return _AltCorrPyramid.apply(fmap1, center, radius, fmap2)


def alt_corr_pyramid(fmap1: torch.Tensor, levels, center: torch.Tensor,
                     radius: int) -> torch.Tensor:
    """Windowed lookup of the correlation slabs of ``fmap1 (B, H, W1, D)``
    with 1 to MAX_LEVELS pyramid levels ``levels[i] (B, H, W2_i, D)``, level
    ``i`` around ``center / 2**i`` -> ``(B, H, W1, len(levels) * (2r+1))``
    float32, level ``i``'s taps at ``[i (2r+1), (i+1) (2r+1))``;
    differentiable in ``fmap1`` and every level (the center gets no
    gradient; ``fmap1``'s gradient sums the levels' from the last to the
    first, in the feature dtype, as JAX does).

    CUDA tensors launch the forward kernel once (counted in
    ``alt_corr.launches``) and the per-level backward kernels (one count
    each in ``alt_corr.bwd_launches``), or raise; CPU tensors take the
    plain versions.
    """
    return _AltCorrPyramid.apply(fmap1, center, radius, *levels)


#: forward kernel launches since the count was last set to 0
alt_corr.launches = 0
#: backward launches (the df1 and df2 kernels together) since the count was
#: last set to 0
alt_corr.bwd_launches = 0
