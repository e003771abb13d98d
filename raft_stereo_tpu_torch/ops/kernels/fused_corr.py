"""``fused_corr``: the memoryless correlation lookup's CUDA kernels and their
wrapper.

The kernels (``csrc/fused_corr.cu``) replace the forward and the backward of
``raft_stereo_tpu/ops/pallas/corr_kernels.py::fused_windowed_corr_pallas``:
the ``2r+1`` windowed taps of the correlation of ``fmap1`` with one pyramid
level of ``fmap2``, computed from the features directly, so no ``(W1, W2)``
volume exists, forward or backward. One forward launch serves 1 to 4
levels (level ``i`` around ``center / 2**i``), reading ``fmap1`` once.

* :func:`fused_corr` — one level, a ``torch.autograd.Function``;
* :func:`fused_corr_pyramid` — 1 to 4 levels in one forward launch, their
  taps concatenated as the ``reg`` lookup orders them; its backward runs
  the per-level backward kernels.

CUDA tensors launch the kernels, or raise; CPU tensors take the plain
PyTorch versions (:func:`fused_corr_plain`, :func:`fused_corr_pyramid_plain`
and :func:`fused_corr_backward_plain`), which gather one tap at a time and
never build a volume either. There is no gradient for the center.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from raft_stereo_tpu_torch.ops.kernels._build import load_library
from raft_stereo_tpu_torch.ops.sampler import window, window_grads

KERNEL_NAME = "fused_corr"
SOURCE = "raft_stereo_tpu_torch/csrc/fused_corr.cu"
REPLACES = "raft_stereo_tpu/ops/pallas/corr_kernels.py:546"
REPLACES_BWD = "raft_stereo_tpu/ops/pallas/corr_kernels.py:575"

MAX_RADIUS = 8  # the kernels keep the 2r+2 taps in registers
MAX_LEVELS = 4  # fmap2 levels one forward launch takes
# shared memory a block may use on an H100 (227 KB, by opt-in)
SMEM_PER_BLOCK = 232448

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _tap_index(base: torch.Tensor, j: int, w2: int, d: int):
    """The feature-row index of tap ``j`` expanded over D (clamped into the
    row), and whether the tap lies in ``[0, W2)``."""
    idx = base + j
    valid = (idx >= 0) & (idx < w2)
    return idx.clamp(0, w2 - 1)[..., None].expand(*idx.shape, d), valid


def fused_corr_plain(fmap1: torch.Tensor, fmap2: torch.Tensor,
                     center: torch.Tensor, radius: int) -> torch.Tensor:
    """Memoryless windowed correlation in plain PyTorch.

    ``fmap1 (B, H, W1, D)``, ``fmap2 (B, H, W2, D)`` (fp32 or bf16) and
    ``center (B, H, W1)`` -> ``(B, H, W1, 2r+1)`` float32: with ``base =
    floor(c) - r`` and ``f = c - floor(c)``, the taps ``g_j = <fmap1,
    fmap2[base + j]> / sqrt(D)`` for ``j in [0, 2r+1]`` (0 outside ``[0,
    W2)``) blended as ``(1-f)*g_k + f*g_{k+1}``. Each tap is one gather of
    fmap2 rows and a dot over D in fp32, as the JAX package's
    ``_fused_reference``; no ``(W1, W2)`` tensor is built.
    """
    w2, d = fmap2.shape[2], fmap2.shape[3]
    k = 2 * radius + 1
    base, frac = window(center, w2, radius)
    f1 = fmap1.float()
    f2 = fmap2.float()
    scale = 1.0 / math.sqrt(d)
    taps = []
    for j in range(k + 1):
        idx, valid = _tap_index(base, j, w2, d)
        tap = (f1 * torch.gather(f2, 2, idx)).sum(dim=-1) * scale
        taps.append(torch.where(valid, tap, torch.zeros((), device=tap.device)))
    g = torch.stack(taps, dim=-1)
    return (1.0 - frac) * g[..., :k] + frac * g[..., 1:]


def fused_corr_pyramid_plain(fmap1: torch.Tensor, levels, center: torch.Tensor,
                             radius: int) -> torch.Tensor:
    """:func:`fused_corr_plain` of ``fmap1`` with each level ``levels[i]
    (B, H, W2_i, D)`` around ``center / 2**i``, concatenated: ``(B, H, W1,
    len(levels) * (2r+1))`` float32."""
    return torch.cat([fused_corr_plain(fmap1, f2, center / (2 ** i), radius)
                      for i, f2 in enumerate(levels)], dim=-1)


def fused_corr_backward_plain(
        fmap1: torch.Tensor, fmap2: torch.Tensor, center: torch.Tensor,
        ct: torch.Tensor, radius: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gradients of :func:`fused_corr_plain` in ``fmap1`` and ``fmap2`` for
    the output cotangent ``ct (B, H, W1, 2r+1)``: ``(df1, df2)``.

    ``dg_j = ((1-f)*ct_j + f*ct_{j-1}) / sqrt(D)`` in fp32 (0 for taps
    outside the row); ``df1 = sum_j dg_j * fmap2[base + j]`` and ``df2``
    gathers ``dg_j * fmap1`` at ``base + j`` (a scatter-add). Both are fp32
    sums rounded once to the feature dtype.
    """
    w2, d = fmap2.shape[2], fmap2.shape[3]
    base, frac = window(center, w2, radius)
    dg = window_grads(ct, frac) * (1.0 / math.sqrt(d))
    f1 = fmap1.float()
    f2 = fmap2.float()
    df1 = torch.zeros_like(f1)
    df2 = torch.zeros(fmap2.shape, dtype=torch.float32, device=fmap2.device)
    for j in range(2 * radius + 2):
        idx, valid = _tap_index(base, j, w2, d)
        dgj = torch.where(valid, dg[..., j],
                          torch.zeros((), device=dg.device))[..., None]
        df1 = df1 + dgj * torch.gather(f2, 2, idx)
        df2.scatter_add_(2, idx, dgj * f1)
    return df1.to(fmap1.dtype), df2.to(fmap2.dtype)


def _library() -> ctypes.CDLL:
    lib = load_library(KERNEL_NAME)
    if lib.fused_corr_fwd.argtypes is None:
        lib.fused_corr_fwd.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p),
            ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.fused_corr_fwd.restype = ctypes.c_int
        lib.fused_corr_bwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        lib.fused_corr_bwd.restype = ctypes.c_int
        lib.fused_corr_error_string.argtypes = [ctypes.c_int]
        lib.fused_corr_error_string.restype = ctypes.c_char_p
    return lib


def df2_smem_bytes(w1: int, w2: int, radius: int) -> int:
    """Shared memory of one ``df2`` block (one ``(b, h)`` row): window
    bases, tap gradients and list entries of the row's W1 pixels, and W2+1
    list offsets, 4 bytes each (the kernel's own formula)."""
    return 4 * (w1 * (2 * (2 * radius + 2) + 1) + w2 + 1)


def check_feature_inputs(name: str, fmap1: torch.Tensor,
                         fmap2: torch.Tensor, center: torch.Tensor,
                         radius: int) -> None:
    """Raise unless ``fmap1 (B, H, W1, D)``, ``fmap2 (B, H, W2, D)`` (both
    fp32 or both bf16) and the fp32 ``center (B, H, W1)`` are contiguous
    on one CUDA device and ``radius`` is in ``[0, MAX_RADIUS]``: what the
    ``fused_corr`` and ``alt_corr`` kernels take. ``name`` heads the
    message."""
    if (fmap1.device.type != "cuda" or fmap2.device != fmap1.device
            or center.device != fmap1.device):
        raise ValueError(
            f"{name}: fmap1, fmap2 and center must lie on one CUDA "
            f"device (got {fmap1.device}, {fmap2.device} and "
            f"{center.device})")
    if fmap1.dtype not in DTYPE_CODES or fmap2.dtype != fmap1.dtype:
        raise TypeError(f"{name}: feature dtypes {fmap1.dtype} and "
                        f"{fmap2.dtype} are not both float32 or bfloat16")
    if center.dtype != torch.float32:
        raise TypeError(f"{name}: center dtype {center.dtype} is not "
                        "float32")
    if (fmap1.dim() != 4 or fmap2.dim() != 4
            or fmap1.shape[:2] != fmap2.shape[:2]
            or fmap1.shape[3] != fmap2.shape[3]
            or tuple(center.shape) != tuple(fmap1.shape[:3])):
        raise ValueError(
            f"{name}: want fmap1 (B, H, W1, D), fmap2 (B, H, W2, D) and "
            f"center (B, H, W1), got {tuple(fmap1.shape)}, "
            f"{tuple(fmap2.shape)} and {tuple(center.shape)}")
    if not (fmap1.is_contiguous() and fmap2.is_contiguous()
            and center.is_contiguous()):
        raise ValueError(f"{name}: fmap1, fmap2 and center must be "
                         "contiguous")
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"{name}: radius {radius} outside [0, "
                         f"{MAX_RADIUS}]")


def _raise_on(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"fused_corr {what} launch failed: CUDA error {rc} "
            f"({lib.fused_corr_error_string(rc).decode()})")


def fused_corr_pyramid_forward(fmap1: torch.Tensor, levels, center: torch.Tensor,
                               radius: int) -> torch.Tensor:
    """Launch the forward kernel once for 1 to MAX_LEVELS levels on CUDA
    tensors (counted in ``fused_corr.launches``): ``(B, H, W1, len(levels)
    * (2r+1))`` float32, level ``i`` around ``center / 2**i``; no
    autograd. Every level must match ``fmap1``'s batch, height, D, dtype
    and device."""
    levels = tuple(levels)
    if not 1 <= len(levels) <= MAX_LEVELS:
        raise ValueError(f"fused_corr: {len(levels)} levels, want 1 to "
                         f"{MAX_LEVELS}")
    for f2 in levels:
        check_feature_inputs("fused_corr", fmap1, f2, center, radius)
    b, h, w1, d = fmap1.shape
    k = 2 * radius + 1
    out = torch.empty((b, h, w1, len(levels) * k), dtype=torch.float32,
                      device=fmap1.device)
    if out.numel() == 0:
        return out
    if d == 0 or all(f2.shape[2] == 0 for f2 in levels):
        return out.zero_()
    stream = torch.cuda.current_stream(fmap1.device).cuda_stream
    lib = _library()
    ptrs = (ctypes.c_void_p * MAX_LEVELS)(*[f2.data_ptr() for f2 in levels])
    widths = (ctypes.c_int * MAX_LEVELS)(*[f2.shape[2] for f2 in levels])
    rc = lib.fused_corr_fwd(fmap1.data_ptr(), ptrs, widths, len(levels),
                            center.data_ptr(), out.data_ptr(), b * h, w1, d,
                            radius, DTYPE_CODES[fmap1.dtype], stream)
    _raise_on(lib, rc, "forward")
    fused_corr.launches += 1
    return out


def fused_corr_forward(fmap1: torch.Tensor, fmap2: torch.Tensor,
                       center: torch.Tensor, radius: int) -> torch.Tensor:
    """Launch the forward kernel for one level on CUDA tensors (counted in
    ``fused_corr.launches``); no autograd."""
    return fused_corr_pyramid_forward(fmap1, (fmap2,), center, radius)


def fused_corr_backward(fmap1: torch.Tensor, fmap2: torch.Tensor,
                        center: torch.Tensor, ct: torch.Tensor, radius: int,
                        need_df1: bool = True, need_df2: bool = True
                        ) -> Tuple[Optional[torch.Tensor],
                                   Optional[torch.Tensor]]:
    """Launch the backward kernels on CUDA tensors (one launch counted in
    ``fused_corr.bwd_launches``): ``(df1, df2)`` in the feature dtype, each
    None unless asked for. ``df2`` is deterministic: two runs on the same
    inputs are bitwise equal."""
    check_feature_inputs("fused_corr", fmap1, fmap2, center, radius)
    b, h, w1, d = fmap1.shape
    w2 = fmap2.shape[2]
    k = 2 * radius + 1
    if tuple(ct.shape) != (b, h, w1, k):
        raise ValueError(f"fused_corr backward: cotangent shape "
                         f"{tuple(ct.shape)}, want {(b, h, w1, k)}")
    if ct.device != fmap1.device:
        raise ValueError("fused_corr backward: the cotangent lies on "
                         f"{ct.device}, the features on {fmap1.device}")
    if need_df2 and df2_smem_bytes(w1, w2, radius) > SMEM_PER_BLOCK:
        raise ValueError(
            f"fused_corr backward: a row of W1={w1}, W2={w2} at radius "
            f"{radius} needs {df2_smem_bytes(w1, w2, radius)} bytes of "
            f"shared memory, more than a block's {SMEM_PER_BLOCK}")
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
    rc = lib.fused_corr_bwd(
        fmap1.data_ptr(), fmap2.data_ptr(), center.data_ptr(), ct.data_ptr(),
        None if df1 is None else df1.data_ptr(),
        None if df2 is None else df2.data_ptr(), b * h, w1, w2, d, radius,
        DTYPE_CODES[fmap1.dtype], stream)
    _raise_on(lib, rc, "backward")
    fused_corr.bwd_launches += 1
    return df1, df2


def on_cpu(*tensors: torch.Tensor) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


class _FusedCorrPyramid(torch.autograd.Function):
    """1 to MAX_LEVELS levels: one forward launch, and the per-level
    backward kernels (``df1`` summed over the levels from the last to the
    first, in the feature dtype). CPU tensors take the plain versions."""

    @staticmethod
    def forward(ctx, fmap1, center, radius, *levels):
        ctx.radius = radius
        ctx.save_for_backward(fmap1, center, *levels)
        if on_cpu(fmap1, center, *levels):
            return fused_corr_pyramid_plain(fmap1, levels, center, radius)
        return fused_corr_pyramid_forward(fmap1, levels, center, radius)

    @staticmethod
    def backward(ctx, ct):
        fmap1, center, *levels = ctx.saved_tensors
        k = 2 * ctx.radius + 1
        need1 = ctx.needs_input_grad[0]
        df1, dlevels = None, [None] * len(levels)
        # from the last level to the first: the order in which JAX's
        # backward sums fmap1's cotangents (bitwise equal in bf16)
        for i in reversed(range(len(levels))):
            f2 = levels[i]
            need2 = ctx.needs_input_grad[3 + i]
            c_i, ct_i = center / (2 ** i), ct[..., i * k:(i + 1) * k]
            if on_cpu(fmap1, f2, center):
                d1, d2 = fused_corr_backward_plain(fmap1, f2, c_i, ct_i,
                                                   ctx.radius)
            elif need1 or need2:
                d1, d2 = fused_corr_backward(fmap1, f2, c_i, ct_i,
                                             ctx.radius, need_df1=need1,
                                             need_df2=need2)
            else:
                d1 = d2 = None
            if need1:
                df1 = d1 if df1 is None else df1 + d1
            dlevels[i] = d2 if need2 else None
        return (df1, None, None, *dlevels)


def fused_corr(fmap1: torch.Tensor, fmap2: torch.Tensor,
               center: torch.Tensor, radius: int) -> torch.Tensor:
    """Memoryless windowed correlation of ``fmap1 (B, H, W1, D)`` with one
    pyramid level ``fmap2 (B, H, W2, D)`` around ``center (B, H, W1)`` ->
    ``(B, H, W1, 2r+1)`` float32, differentiable in both feature maps (the
    center gets no gradient).

    CUDA tensors launch the kernels (forward launches counted in
    ``fused_corr.launches``, backward launches in
    ``fused_corr.bwd_launches``) or raise; CPU tensors take the plain
    versions, forward and backward. It is :func:`fused_corr_pyramid` of
    one level.
    """
    return _FusedCorrPyramid.apply(fmap1, center, radius, fmap2)


def fused_corr_pyramid(fmap1: torch.Tensor, levels, center: torch.Tensor,
                       radius: int) -> torch.Tensor:
    """Memoryless windowed correlation of ``fmap1 (B, H, W1, D)`` with 1 to
    MAX_LEVELS pyramid levels ``levels[i] (B, H, W2_i, D)``, level ``i``
    around ``center / 2**i`` -> ``(B, H, W1, len(levels) * (2r+1))``
    float32, level ``i``'s taps at ``[i (2r+1), (i+1) (2r+1))``;
    differentiable in ``fmap1`` and every level (the center gets no
    gradient).

    CUDA tensors launch the forward kernel once (counted in
    ``fused_corr.launches``) and the per-level backward kernels (one count
    each in ``fused_corr.bwd_launches``), or raise; CPU tensors take the
    plain versions.
    """
    return _FusedCorrPyramid.apply(fmap1, center, radius, *levels)


#: forward kernel launches since the count was last set to 0
fused_corr.launches = 0
#: backward launches (the df1 and df2 kernels together) since the count was
#: last set to 0
fused_corr.bwd_launches = 0
