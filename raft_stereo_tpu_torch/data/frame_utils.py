"""Image / disparity / flow codecs (the port's copy of
``raft_stereo_tpu/data/frame_utils.py``).

All readers return numpy arrays (images uint8 HWC RGB; disparities float32
HW), equal to the JAX package's readers' on the same file. PNGs are decoded
by :mod:`raft_stereo_tpu_torch.data.png` (zlib and numpy) with the
semantics of the library each JAX reader calls:

* images (:func:`read_image`): PIL's — 16-bit gray stays uint16, 16-bit
  color keeps each sample's high byte, 16-bit gray+alpha becomes RGBA;
* 16-bit disparity and flow PNGs: cv2's — ``IMREAD_UNCHANGED`` gives color
  as BGR(A) and gray+alpha as BGRA; ``IMREAD_COLOR`` gives BGR.

Nothing here imports PIL or cv2. Only PNG images are read: a JPEG or PPM
raises. PFM is read by the numpy path of the JAX package.

Format semantics:

* PFM: Pf/PF header, w h, negative scale = little-endian, rows bottom-up.
* Middlebury .flo: magic 202021.25 float, then w, h int32, then h*w*2
  float32.
* KITTI disparity PNG: 16-bit, value/256.0, 0 = invalid.
* KITTI flow PNG: 16-bit RGB, (value-2^15)/64, third channel validity.
* Sintel stereo disparity: 8-bit RGB packed d = R*4 + G/64 + B/16384, paired
  occlusion mask where 0 = valid.
* FallingThings: uint16 depth PNG + ``_camera_settings.json`` fx;
  disparity = fx * 6.0 * 100 / depth.
* TartanAir: .npy depth; disparity = 80 / depth.
* Middlebury GT: disp0GT.pfm + mask0nocc.png==255 nocc mask; disp0.pfm
  with valid = disp < 1e3.
"""

from __future__ import annotations

import json
import os
import re
from typing import Callable, Dict, Tuple

import numpy as np

from raft_stereo_tpu_torch.data import png

FLO_MAGIC = 202021.25


# --------------------------------------------------------------------------- images

def read_image(path: str) -> np.ndarray:
    """Read a PNG image as PIL does: uint8 (H, W, C) or (H, W) gray, and
    uint16 (H, W) for 16-bit gray (other 16-bit images keep each sample's
    high byte, gray+alpha as RGBA)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:len(png.SIGNATURE)] != png.SIGNATURE:
        raise ValueError(f"{path}: not a PNG file; the port decodes PNG "
                         "images only (no JPEG or PPM decoder)")
    img = png.decode_png(data, path)
    if img.dtype == np.uint16 and img.ndim == 3:
        if img.shape[-1] == 2:  # PIL opens 16-bit gray+alpha as RGBA
            img = img[..., [0, 0, 0, 1]]
        img = (img >> 8).astype(np.uint8)
    return img


def _read_png_cv2(path: str) -> np.ndarray:
    """``cv2.imread(path, IMREAD_ANYDEPTH | IMREAD_UNCHANGED)``: the stored
    samples, color as BGR(A), gray+alpha as BGRA."""
    img = png.read_png(path)
    if img.ndim == 3:
        img = img[..., {2: [0, 0, 0, 1], 3: [2, 1, 0],
                        4: [2, 1, 0, 3]}[img.shape[-1]]]
    return img


def _read_png_rgb(path: str) -> np.ndarray:
    """``cv2.imread(path, IMREAD_ANYDEPTH | IMREAD_COLOR)[..., ::-1]``: the
    stored samples as RGB (gray replicated, alpha dropped)."""
    img = png.read_png(path)
    if img.ndim == 2:
        img = img[..., None]
    return img[..., [0, 0, 0]] if img.shape[-1] < 3 else img[..., :3]


# --------------------------------------------------------------------------- PFM

def read_pfm(path: str) -> np.ndarray:
    """Read a PFM file -> float32 (H, W) or (H, W, 3), top-down row order."""
    with open(path, "rb") as f:
        header = f.readline().rstrip()
        if header == b"PF":
            channels = 3
        elif header == b"Pf":
            channels = 1
        else:
            raise ValueError(f"{path}: not a PFM file (header {header!r})")

        dims = f.readline()
        m = re.match(rb"^(\d+)\s+(\d+)\s*$", dims)
        if not m:
            raise ValueError(f"{path}: malformed PFM dims {dims!r}")
        width, height = int(m.group(1)), int(m.group(2))

        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"

        data = np.fromfile(f, endian + "f4", count=height * width * channels)
    if data.size != height * width * channels:
        raise ValueError(f"{path}: truncated PFM payload")
    shape = (height, width, 3) if channels == 3 else (height, width)
    # PFM stores rows bottom-to-top.
    return np.flipud(data.reshape(shape)).astype(np.float32)


def write_pfm(path: str, array: np.ndarray) -> None:
    """Write a single-channel float32 PFM (little-endian, bottom-up rows)."""
    if array.ndim != 2:
        raise ValueError("write_pfm supports single-channel (H, W) arrays")
    h, w = array.shape
    with open(path, "wb") as f:
        f.write(b"Pf\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1\n")
        f.write(np.flipud(array).astype("<f4").tobytes())


# --------------------------------------------------------------------------- .flo

def read_flo(path: str) -> np.ndarray:
    """Read Middlebury .flo optical flow -> float32 (H, W, 2)."""
    with open(path, "rb") as f:
        magic = np.fromfile(f, np.float32, count=1)
        if magic.size != 1 or magic[0] != np.float32(FLO_MAGIC):
            raise ValueError(f"{path}: bad .flo magic {magic!r}")
        w = int(np.fromfile(f, np.int32, count=1)[0])
        h = int(np.fromfile(f, np.int32, count=1)[0])
        data = np.fromfile(f, np.float32, count=2 * w * h)
    return data.reshape(h, w, 2)


def write_flo(path: str, flow: np.ndarray) -> None:
    flow = np.asarray(flow, np.float32)
    h, w, c = flow.shape
    if c != 2:
        raise ValueError("flow must be (H, W, 2)")
    with open(path, "wb") as f:
        np.float32(FLO_MAGIC).tofile(f)
        np.int32(w).tofile(f)
        np.int32(h).tofile(f)
        flow.tofile(f)


# --------------------------------------------------------------------------- KITTI PNGs

def read_disp_kitti(path: str) -> Tuple[np.ndarray, np.ndarray]:
    disp = _read_png_cv2(path).astype(np.float32) / 256.0
    return disp, disp > 0.0


def read_disp_eth3d(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """ETH3D GT: disp0GT.pfm with the generic dense threshold
    ``disp < 512`` (the reference reads it through plain ``read_gen``; the
    nocc mask on disk is never consulted, unlike Middlebury)."""
    disp = read_pfm(path)
    if disp.ndim == 3:
        disp = disp[..., 0]
    return disp, disp < 512.0


def read_flow_kitti(path: str) -> Tuple[np.ndarray, np.ndarray]:
    raw = _read_png_rgb(path).astype(np.float32)
    flow = (raw[:, :, :2] - 2.0 ** 15) / 64.0
    valid = raw[:, :, 2]
    return flow, valid


def write_flow_kitti(path: str, flow: np.ndarray) -> None:
    enc = 64.0 * np.asarray(flow, np.float64) + 2 ** 15
    valid = np.ones(enc.shape[:2] + (1,))
    png.write_png(path, np.concatenate([enc, valid], axis=-1).astype(
        np.uint16))


# ----------------------------------------------------------------- dataset decoders

def read_disp_sintel(path: str) -> Tuple[np.ndarray, np.ndarray]:
    rgb = read_image(path).astype(np.float32)
    disp = rgb[..., 0] * 4.0 + rgb[..., 1] / 64.0 + rgb[..., 2] / 16384.0
    occ_path = path.replace("disparities", "occlusions")
    occlusion = read_image(occ_path)
    valid = (occlusion == 0) & (disp > 0)
    return disp, valid


def read_disp_falling_things(path: str) -> Tuple[np.ndarray, np.ndarray]:
    depth = read_image(path).astype(np.float32)
    settings = os.path.join(os.path.dirname(path), "_camera_settings.json")
    with open(settings) as f:
        intrinsics = json.load(f)
    fx = intrinsics["camera_settings"][0]["intrinsic_settings"]["fx"]
    with np.errstate(divide="ignore"):
        disp = (fx * 6.0 * 100.0) / depth
    return disp, disp > 0


def read_disp_tartanair(path: str) -> Tuple[np.ndarray, np.ndarray]:
    depth = np.load(path)
    with np.errstate(divide="ignore"):
        disp = 80.0 / depth.astype(np.float32)
    return disp, disp > 0


def read_disp_middlebury(path: str) -> Tuple[np.ndarray, np.ndarray]:
    name = os.path.basename(path)
    disp = read_pfm(path)
    if disp.ndim != 2:
        raise ValueError(f"{path}: expected single-channel disparity")
    if name == "disp0GT.pfm":
        nocc_path = path.replace("disp0GT.pfm", "mask0nocc.png")
        valid = read_image(nocc_path) == 255
        return disp, valid
    return disp, disp < 1e3


def read_disp_pfm(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Generic PFM disparity (SceneFlow): finite values are valid."""
    disp = read_pfm(path)
    if disp.ndim == 3:
        disp = disp[..., 0]
    return disp, np.isfinite(disp)


DISPARITY_READERS: Dict[str, Callable[[str], Tuple[np.ndarray, np.ndarray]]] = {
    "pfm": read_disp_pfm,
    "kitti": read_disp_kitti,
    "sintel": read_disp_sintel,
    "falling_things": read_disp_falling_things,
    "tartanair": read_disp_tartanair,
    "middlebury": read_disp_middlebury,
}


def read_gen(path: str) -> np.ndarray:
    """Extension-dispatched reader: images, .flo, .pfm, .npy."""
    ext = os.path.splitext(path)[-1].lower()
    if ext in (".png", ".jpeg", ".jpg", ".ppm"):
        return read_image(path)
    if ext in (".bin", ".raw", ".npy"):
        return np.load(path)
    if ext == ".flo":
        return read_flo(path)
    if ext == ".pfm":
        data = read_pfm(path)
        return data if data.ndim == 2 else data[:, :, :-1]
    raise ValueError(f"unsupported extension {ext!r} for {path}")
