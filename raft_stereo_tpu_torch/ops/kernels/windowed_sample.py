"""``windowed_sample``: the CUDA correlation-lookup kernel and its wrapper.

The kernel (``csrc/windowed_sample.cu``) replaces the forward of
``raft_stereo_tpu/ops/pallas/corr_kernels.py::windowed_sample_pallas``.
The wrapper launches it for CUDA tensors and takes the plain PyTorch
version (:func:`windowed_sample_plain`) only for CPU tensors. It has no
backward yet: a call that needs a gradient raises.
"""

from __future__ import annotations

import ctypes

import torch

from raft_stereo_tpu_torch.ops.kernels._build import load_library
from raft_stereo_tpu_torch.ops.sampler import windowed_linear_sample

KERNEL_NAME = "windowed_sample"
SOURCE = "raft_stereo_tpu_torch/csrc/windowed_sample.cu"
REPLACES = "raft_stereo_tpu/ops/pallas/corr_kernels.py:129"

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The plain version is the port's reference lookup itself.
windowed_sample_plain = windowed_linear_sample


def _library() -> ctypes.CDLL:
    lib = load_library(KERNEL_NAME)
    if lib.windowed_sample_fwd.argtypes is None:
        lib.windowed_sample_fwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p]
        lib.windowed_sample_fwd.restype = ctypes.c_int
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


def windowed_sample(volume: torch.Tensor, center: torch.Tensor,
                    radius: int) -> torch.Tensor:
    """2r+1-tap windowed linear sample of ``volume (B, H, W1, W2)`` around
    ``center (B, H, W1)`` -> ``(B, H, W1, 2r+1)`` float32.

    CUDA tensors launch the kernel (and count the launch in
    ``windowed_sample.launches``) or raise; CPU tensors take the plain
    version. Same numbers as
    :func:`raft_stereo_tpu_torch.ops.sampler.windowed_linear_sample`.
    """
    if torch.is_grad_enabled() and (volume.requires_grad
                                    or center.requires_grad):
        raise NotImplementedError(
            "windowed_sample has no backward yet (ROADMAP.md queue B, "
            "B1 backward with A9 training)")
    if volume.device.type == "cpu" and center.device.type == "cpu":
        return windowed_sample_plain(volume, center, radius)
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
    if rc != 0:
        raise RuntimeError(
            f"windowed_sample launch failed: CUDA error {rc} "
            f"({lib.windowed_sample_error_string(rc).decode()})")
    windowed_sample.launches += 1
    return out


#: kernel launches since the count was last set to 0
windowed_sample.launches = 0
