"""``fused_lookup``: the 4-level pyramid lookup fused with the motion
encoder's ``convc1`` (a 1x1 conv) and its ReLU, its CUDA kernels and their
wrapper.

The kernels (``csrc/fused_lookup.cu``) replace the forward and the backward
of ``raft_stereo_tpu/ops/pallas/lookup_kernels.py::fused_lookup_c1``: the
``2r+1``-tap window of each of the ``reg`` volume pyramid's 4 levels,
concatenated to ``4 (2r+1)`` channels, then ``relu(corr @ k + b)`` -> the
64-channel ``cor1`` activation, with no ``(B, H, W, 36)`` corr tensor in
device memory. :func:`fused_lookup_c1` is a ``torch.autograd.Function``:
CUDA tensors launch the forward kernel, and the backward kernels when a
gradient is taken, or raise; CPU tensors take the plain PyTorch versions
(:func:`fused_lookup_c1_plain` and :func:`fused_lookup_c1_backward_plain`).
There is no gradient for the coordinates.

The JAX package sizes its row block by a VMEM budget (``_pick_hb``) and its
gate refuses shapes whose block does not fit; the CUDA kernels work on tiles
of 16 to 64 consecutive pixels and stage only their windows on-chip, so no
such budget exists here and the gate checks the pyramid's shape alone.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from raft_stereo_tpu_torch.ops.kernels._build import load_library
from raft_stereo_tpu_torch.ops.kernels.fused_corr import DTYPE_CODES, on_cpu
from raft_stereo_tpu_torch.ops.sampler import (scatter_window, window,
                                               window_grads,
                                               windowed_linear_sample)

KERNEL_NAME = "fused_lookup"
SOURCE = "raft_stereo_tpu_torch/csrc/fused_lookup.cu"
REPLACES = "raft_stereo_tpu/ops/pallas/lookup_kernels.py:243"
REPLACES_BWD = "raft_stereo_tpu/ops/pallas/lookup_kernels.py:277"

NUM_LEVELS = 4
OUT_CHANNELS = 64  # convc1's
MAX_RADIUS = 8     # the kernels' tap counts are compile-time instantiations


def fused_lookup_applicable(levels: Sequence[torch.Tensor],
                            radius: int) -> bool:
    """Whether the fused kernel takes this pyramid: 4 levels with equal
    ``(B, H, W)`` prefixes, each wider than the ``2r+2``-tap window (JAX
    ``fused_lookup_applicable`` without its TPU VMEM budget)."""
    if len(levels) != NUM_LEVELS:
        return False
    prefix = tuple(levels[0].shape[:3])
    if any(tuple(v.shape[:3]) != prefix for v in levels):
        return False
    return all(v.shape[-1] > 2 * radius + 2 for v in levels)


def _in_order(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x (..., C) @ w (C, O)`` summed over ``c`` in ascending order, each
    product and sum rounded to fp32: the order the kernels take, so the
    pre-activation (and the ReLU mask) and ``dcorr`` match them bitwise."""
    acc = torch.zeros(x.shape[:-1] + w.shape[1:], dtype=torch.float32,
                      device=x.device)
    for c in range(x.shape[-1]):
        acc = acc + x[..., c:c + 1] * w[c]
    return acc


def _corr_and_pre(levels, coords_x, kernel, bias, radius, dt):
    """The 4 levels' blended windows rounded to ``dt`` (held in fp32), the
    kernel rounded to ``dt`` (fp32) and the fp32 pre-activation."""
    corr = torch.cat([windowed_linear_sample(v, coords_x / (2 ** i), radius)
                      for i, v in enumerate(levels)], dim=-1)
    corr = corr.to(dt).float()
    k = kernel.to(dt).float()
    return corr, k, _in_order(corr, k) + bias.float()


def fused_lookup_c1_plain(levels: Sequence[torch.Tensor],
                          coords_x: torch.Tensor, kernel: torch.Tensor,
                          bias: torch.Tensor, radius: int,
                          dt: Optional[torch.dtype] = None) -> torch.Tensor:
    """The fused lookup in plain PyTorch: ``relu(dt(corr) @ dt(k) + b)`` in
    ``dt`` (fp32 when None), ``(B, H, W1, 64)``.

    ``levels`` are the ``reg`` pyramid ``(B, H, W1, W2_i)`` (fp32 or bf16),
    ``coords_x (B, H, W1)`` lookup centers in level-0 pixels, ``kernel
    (4 (2r+1), 64)`` and ``bias (64,)`` fp32. The corr values are the
    windowed sample's, blended in fp32 and rounded to ``dt``; the product
    accumulates in fp32 (the JAX kernel's ``_fwd_kernel``)."""
    dt = dt or torch.float32
    _, _, pre = _corr_and_pre(levels, coords_x, kernel, bias, radius, dt)
    return torch.relu(pre).to(dt)


def fused_lookup_c1_backward_plain(
        levels: Sequence[torch.Tensor], coords_x: torch.Tensor,
        kernel: torch.Tensor, bias: torch.Tensor, g: torch.Tensor,
        radius: int, dt: Optional[torch.dtype] = None
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor]:
    """Gradients of :func:`fused_lookup_c1_plain` for the cotangent ``g
    (B, H, W1, 64)``: ``(dvols, dk, db)``.

    The pre-activation is recomputed; ``g`` is rounded to ``dt``, masked
    by ``pre > 0`` in fp32; ``dk = corr^T g`` and ``db = sum g`` over every
    pixel in fp32; ``dcorr = g k^T`` (fp32) is scattered per level into a
    dense ``dvol`` like the window's backward (``dg_j = (1-f) dcorr_j +
    f dcorr_{j-1}``) and stored in the volume's dtype (the JAX kernel's
    ``_bwd_kernel``)."""
    dt = dt or torch.float32
    k = 2 * radius + 1
    corr, kt, pre = _corr_and_pre(levels, coords_x, kernel, bias, radius, dt)
    g = g.to(dt).float() * (pre > 0)
    dk = torch.matmul(corr.reshape(-1, corr.shape[-1]).t(),
                      g.reshape(-1, g.shape[-1]))
    db = g.reshape(-1, g.shape[-1]).sum(dim=0)
    dcorr = _in_order(g, kt.t())
    dvols = []
    for i, v in enumerate(levels):
        base, frac = window(coords_x / (2 ** i), v.shape[-1], radius)
        dg = window_grads(dcorr[..., i * k:(i + 1) * k], frac)
        dvols.append(scatter_window(dg, base, v.shape[-1]).to(v.dtype))
    return tuple(dvols), dk, db


def _library() -> ctypes.CDLL:
    lib = load_library(KERNEL_NAME)
    if lib.fused_lookup_fwd.argtypes is None:
        ptrs, ints = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(
            ctypes.c_int)
        lib.fused_lookup_fwd.argtypes = [
            ptrs, ints, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.fused_lookup_fwd.restype = ctypes.c_int
        lib.fused_lookup_bwd.argtypes = [
            ptrs, ptrs, ints, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p]
        lib.fused_lookup_bwd.restype = ctypes.c_int
        lib.fused_lookup_partials.argtypes = [
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_longlong)]
        lib.fused_lookup_partials.restype = ctypes.c_int
        lib.fused_lookup_error_string.argtypes = [ctypes.c_int]
        lib.fused_lookup_error_string.restype = ctypes.c_char_p
    return lib


def _check(levels, coords_x, kernel, bias, radius, dt) -> None:
    if len(levels) != NUM_LEVELS:
        raise ValueError(f"fused_lookup: {len(levels)} levels, want "
                         f"{NUM_LEVELS}")
    dev = coords_x.device
    if dev.type != "cuda" or any(t.device != dev for t in
                                 (*levels, kernel, bias)):
        raise ValueError(
            "fused_lookup: the levels, coords, kernel and bias must lie on "
            f"one CUDA device (got {[str(v.device) for v in levels]}, "
            f"{dev}, {kernel.device} and {bias.device})")
    if levels[0].dtype not in DTYPE_CODES or any(
            v.dtype != levels[0].dtype for v in levels):
        raise TypeError(f"fused_lookup: level dtypes "
                        f"{[v.dtype for v in levels]} are not all float32 "
                        "or all bfloat16")
    if dt not in DTYPE_CODES:
        raise TypeError(f"fused_lookup: compute dtype {dt} is not float32 "
                        "or bfloat16")
    if coords_x.dtype != torch.float32:
        raise TypeError(f"fused_lookup: coords dtype {coords_x.dtype} is "
                        "not float32")
    prefix = tuple(coords_x.shape)
    if len(prefix) != 3 or any(v.dim() != 4 or tuple(v.shape[:3]) != prefix
                               for v in levels):
        raise ValueError(
            f"fused_lookup: want levels (B, H, W1, W2_i) and coords "
            f"(B, H, W1), got {[tuple(v.shape) for v in levels]} and "
            f"{prefix}")
    if not all(t.is_contiguous() for t in (*levels, coords_x)):
        raise ValueError("fused_lookup: the levels and coords must be "
                         "contiguous")
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"fused_lookup: radius {radius} outside [0, "
                         f"{MAX_RADIUS}]")
    channels = NUM_LEVELS * (2 * radius + 1)
    if tuple(kernel.shape) != (channels, OUT_CHANNELS) or tuple(
            bias.shape) != (OUT_CHANNELS,):
        raise ValueError(
            f"fused_lookup: want kernel ({channels}, {OUT_CHANNELS}) and "
            f"bias ({OUT_CHANNELS},), got {tuple(kernel.shape)} and "
            f"{tuple(bias.shape)}")


def _raise_on(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"fused_lookup {what} launch failed: CUDA error {rc} "
            f"({lib.fused_lookup_error_string(rc).decode()})")


def _pointers(tensors):
    return (ctypes.c_void_p * NUM_LEVELS)(*[t.data_ptr() for t in tensors])


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` (contiguous) at a 16-byte aligned address: the kernels copy
    the convc1 kernel and read the cotangent 16 bytes at a time."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def fused_lookup_forward(levels: Sequence[torch.Tensor],
                         coords_x: torch.Tensor, kernel: torch.Tensor,
                         bias: torch.Tensor, radius: int,
                         dt: Optional[torch.dtype] = None) -> torch.Tensor:
    """Launch the forward kernel on CUDA tensors (counted in
    ``fused_lookup_c1.launches``); no autograd."""
    dt = dt or torch.float32
    _check(levels, coords_x, kernel, bias, radius, dt)
    out = torch.empty(tuple(coords_x.shape) + (OUT_CHANNELS,), dtype=dt,
                      device=coords_x.device)
    n_pix = coords_x.numel()
    if n_pix == 0:
        return out
    kernel = _aligned(kernel.float().contiguous())
    bias = bias.float().contiguous()
    stream = torch.cuda.current_stream(coords_x.device).cuda_stream
    lib = _library()
    rc = lib.fused_lookup_fwd(
        _pointers(levels), (ctypes.c_int * NUM_LEVELS)(
            *[v.shape[-1] for v in levels]), coords_x.data_ptr(),
        kernel.data_ptr(), bias.data_ptr(), out.data_ptr(), n_pix, radius,
        DTYPE_CODES[levels[0].dtype], DTYPE_CODES[dt], stream)
    _raise_on(lib, rc, "forward")
    fused_lookup_c1.launches += 1
    return out


def fused_lookup_backward(
        levels: Sequence[torch.Tensor], coords_x: torch.Tensor,
        kernel: torch.Tensor, bias: torch.Tensor, g: torch.Tensor,
        radius: int, dt: Optional[torch.dtype] = None
) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor, torch.Tensor]:
    """Launch the backward kernels on CUDA tensors (one launch counted in
    ``fused_lookup_c1.bwd_launches``): ``(dvols, dk, db)``, the dense
    ``dvols`` in the volume dtype, ``dk (4 (2r+1), 64)`` and ``db (64,)``
    fp32. Two runs on the same inputs are bitwise equal."""
    dt = dt or torch.float32
    _check(levels, coords_x, kernel, bias, radius, dt)
    want = tuple(coords_x.shape) + (OUT_CHANNELS,)
    if tuple(g.shape) != want or g.device != coords_x.device:
        raise ValueError(f"fused_lookup backward: cotangent {tuple(g.shape)} "
                         f"on {g.device}, want {want} on {coords_x.device}")
    channels = kernel.shape[0]
    dvols = tuple(torch.empty_like(v) for v in levels)
    dkdb = torch.zeros(channels * OUT_CHANNELS + OUT_CHANNELS,
                       dtype=torch.float32, device=coords_x.device)
    n_pix = coords_x.numel()
    if n_pix == 0:
        return dvols, dkdb[:-OUT_CHANNELS].view(channels, OUT_CHANNELS), \
            dkdb[-OUT_CHANNELS:]
    g = _aligned(g.to(dt).contiguous())
    kernel = _aligned(kernel.float().contiguous())
    bias = bias.float().contiguous()
    lib = _library()
    codes = (DTYPE_CODES[levels[0].dtype], DTYPE_CODES[dt])
    count = ctypes.c_longlong(0)
    _raise_on(lib, lib.fused_lookup_partials(n_pix, radius, *codes,
                                             ctypes.byref(count)),
              "backward grid")
    partials = torch.empty((count.value, dkdb.numel()), dtype=torch.float32,
                           device=coords_x.device)
    stream = torch.cuda.current_stream(coords_x.device).cuda_stream
    rc = lib.fused_lookup_bwd(
        _pointers(levels), _pointers(dvols), (ctypes.c_int * NUM_LEVELS)(
            *[v.shape[-1] for v in levels]), coords_x.data_ptr(),
        g.data_ptr(), kernel.data_ptr(), bias.data_ptr(), partials.data_ptr(),
        dkdb.data_ptr(), n_pix, radius, *codes, stream)
    _raise_on(lib, rc, "backward")
    fused_lookup_c1.bwd_launches += 1
    return (dvols, dkdb[:-OUT_CHANNELS].view(channels, OUT_CHANNELS),
            dkdb[-OUT_CHANNELS:])


class _FusedLookupC1(torch.autograd.Function):
    """The fused lookup with its hand-written backward: the kernels for
    CUDA tensors, the plain versions for CPU tensors. Only the inputs are
    saved; the backward recomputes the lookup and the pre-activation."""

    @staticmethod
    def forward(ctx, radius, dt, coords_x, kernel, bias, *levels):
        ctx.radius, ctx.dt = radius, dt
        ctx.save_for_backward(coords_x, kernel, bias, *levels)
        if on_cpu(coords_x, *levels):
            return fused_lookup_c1_plain(levels, coords_x, kernel, bias,
                                         radius, dt)
        return fused_lookup_forward(levels, coords_x, kernel, bias, radius,
                                    dt)

    @staticmethod
    def backward(ctx, g):
        coords_x, kernel, bias, *levels = ctx.saved_tensors
        if on_cpu(coords_x, *levels):
            dvols, dk, db = fused_lookup_c1_backward_plain(
                levels, coords_x, kernel, bias, g, ctx.radius, ctx.dt)
        else:
            dvols, dk, db = fused_lookup_backward(
                levels, coords_x, kernel, bias, g, ctx.radius, ctx.dt)
        need = ctx.needs_input_grad
        return (None, None, None, dk if need[3] else None,
                db if need[4] else None,
                *[dv if n else None for dv, n in zip(dvols, need[5:])])


def fused_lookup_c1(levels: Sequence[torch.Tensor], coords_x: torch.Tensor,
                    kernel: torch.Tensor, bias: torch.Tensor, radius: int,
                    dt: Optional[torch.dtype] = None) -> torch.Tensor:
    """``relu(lookup(levels, coords_x) @ kernel + bias)`` -> ``(B, H, W1,
    64)`` in ``dt`` (fp32 when None): the motion encoder's ``cor1``
    activation, differentiable in the levels, the kernel and the bias (the
    coordinates get no gradient).

    ``levels``: the ``reg`` pyramid, 4 x ``(B, H, W1, W2_i)``; ``coords_x
    (B, H, W1)``: level-0 lookup centers; ``kernel (4 (2r+1), 64)``: convc1
    as a matrix; ``bias (64,)``. CUDA tensors launch the kernels (forward
    launches counted in ``fused_lookup_c1.launches``, backward launches in
    ``fused_lookup_c1.bwd_launches``) or raise; CPU tensors take the plain
    versions, forward and backward.
    """
    return _FusedLookupC1.apply(radius, dt, coords_x, kernel, bias, *levels)


#: forward kernel launches since the count was last set to 0
fused_lookup_c1.launches = 0
#: backward launches (the main and the dk/db reduction kernels together)
#: since the count was last set to 0
fused_lookup_c1.bwd_launches = 0
