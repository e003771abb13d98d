"""Photometric and spatial augmentation (the port's copy of
``raft_stereo_tpu/data/augment.py``), in numpy alone.

The augmentors are the JAX package's: ``FlowAugmentor`` for dense ground
truth (SceneFlow, Sintel, FallingThings, TartanAir) and
``SparseFlowAugmentor`` for sparse (KITTI, ETH3D, Middlebury), with every
random draw taken from the caller's ``np.random.Generator`` in the JAX
package's order, so both packages consume one stream the same way.

The JAX package resizes and converts colour with OpenCV. The card's
machine has no OpenCV, so this module computes the same functions itself:

* :func:`resize_linear` is ``cv2.resize(img, None, fx=fx, fy=fy,
  interpolation=cv2.INTER_LINEAR)``: the output size ``round(w * fx)`` by
  ``round(h * fy)``, source coordinates ``(d + 0.5) / f - 0.5`` clamped at
  the borders. uint8 images follow OpenCV's fixed-point scheme (11-bit
  weights, a vertical pass that rounds each product's shifted high half)
  and are bitwise OpenCV's. float32 arrays blend in float32 and come
  within a few float32 ulps of OpenCV's, whose float kernel sums in an
  order this module does not reproduce (tests/test_torch_augment.py holds
  the bound).
* :func:`rgb_to_hsv` and :func:`hsv_to_rgb` are ``cv2.cvtColor``'s float32
  ``COLOR_RGB2HSV`` and ``COLOR_HSV2RGB`` (hue in degrees, [0, 360)),
  operation for operation as OpenCV's vectorised x86 code computes them,
  fused multiply-adds included (taken in float64 and rounded once).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

_F32 = np.float32
_FLT_EPSILON = np.float32(np.finfo(np.float32).eps)
# OpenCV's fixed-point resize: weights in units of 2**-11
_COEF_SCALE = np.float32(2048.0)


# ------------------------------------------------------------------ OpenCV

def _fma(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once: the product of two float32
    values is exact in float64."""
    return (np.asarray(a, np.float64) * np.asarray(b, np.float64)
            + np.asarray(c, np.float64)).astype(_F32)


def _axis_taps(n_in: int, n_out: int, scale: float, clamp: bool,
               exact_fraction: bool = False):
    """First tap and the float32 fraction of each output index along one
    axis, as OpenCV computes them for INTER_LINEAR: the source coordinate
    ``(d + 0.5) / scale - 0.5`` in double, rounded to float32 (the uint8
    kernel's), or only its fraction rounded (``exact_fraction``: the float
    kernel's); with ``clamp`` (the horizontal axis) a coordinate before
    the first pixel or at or past the last takes that pixel whole."""
    d = np.arange(n_out, dtype=np.float64)
    f = (d + 0.5) * (1.0 / scale) - 0.5
    if not exact_fraction:
        f = f.astype(_F32)
    s = np.floor(f).astype(np.int64)
    f = (f - s).astype(_F32)
    if clamp:
        edge = (s < 0) | (s >= n_in - 1)
        f[edge] = 0.0
        s = np.clip(s, 0, n_in - 1)
    return s, f


def resize_linear(img: np.ndarray, fx: float, fy: float) -> np.ndarray:
    """``cv2.resize(img, None, fx=fx, fy=fy,
    interpolation=cv2.INTER_LINEAR)`` for a uint8 or float32 ``(H, W)`` or
    ``(H, W, C)`` array (module doc)."""
    h, w = img.shape[:2]
    oh, ow = int(round(h * fy)), int(round(w * fx))
    if oh <= 0 or ow <= 0:
        raise ValueError(f"resize of {img.shape} by ({fx}, {fy}) is empty")
    x = img if img.ndim == 3 else img[..., None]
    if img.dtype == np.uint8:
        out = _resize_u8(x, h, w, oh, ow, fx, fy)
    elif img.dtype == np.float32:
        out = _resize_f32(x, h, w, oh, ow, fx, fy)
    else:
        raise TypeError(f"resize_linear takes uint8 or float32, not "
                        f"{img.dtype}")
    return out.reshape((oh, ow) + img.shape[2:])


def _source_rows(sy, h):
    """The source rows the vertical pass reads (each horizontally resized
    once) and, for each output row, the positions of its two rows among
    them."""
    top, bottom = np.clip(sy, 0, h - 1), np.clip(sy + 1, 0, h - 1)
    rows = np.unique(np.concatenate([top, bottom]))
    return rows, np.searchsorted(rows, top), np.searchsorted(rows, bottom)


def _resize_u8(x, h, w, oh, ow, fx, fy):
    sx, ax = _axis_taps(w, ow, fx, clamp=True)
    sy, ay = _axis_taps(h, oh, fy, clamp=False)
    # each weight rounded on its own: the two need not sum to 2048
    a0 = np.rint((_F32(1) - ax) * _COEF_SCALE).astype(np.int32)[:, None]
    a1 = np.rint(ax * _COEF_SCALE).astype(np.int32)[:, None]
    b0 = np.rint((_F32(1) - ay) * _COEF_SCALE).astype(np.int32)[:, None,
                                                                 None]
    b1 = np.rint(ay * _COEF_SCALE).astype(np.int32)[:, None, None]
    rows, top, bottom = _source_rows(sy, h)
    src = np.take(x, rows, axis=0).astype(np.int32)
    horiz = np.take(src, sx, axis=1)
    horiz *= a0
    right = np.take(src, np.minimum(sx + 1, w - 1), axis=1)
    right *= a1
    horiz += right
    horiz >>= 4
    out = np.take(horiz, top, axis=0)
    out *= b0
    out >>= 16
    low = np.take(horiz, bottom, axis=0)
    low *= b1
    low >>= 16
    out += low
    out += 2
    out >>= 2
    return np.clip(out, 0, 255, out=out).astype(np.uint8)


def _resize_f32(x, h, w, oh, ow, fx, fy):
    sx, ax = _axis_taps(w, ow, fx, clamp=True, exact_fraction=True)
    sy, ay = _axis_taps(h, oh, fy, clamp=False, exact_fraction=True)
    rows, top, bottom = _source_rows(sy, h)
    src = np.take(x, rows, axis=0)
    left = np.take(src, sx, axis=1)
    horiz = np.take(src, np.minimum(sx + 1, w - 1), axis=1)
    horiz -= left
    horiz *= ax[:, None]
    horiz += left
    out = np.take(horiz, top, axis=0)
    low = np.take(horiz, bottom, axis=0)
    low -= out
    low *= ay[:, None, None]
    out += low
    return out


# the hue's offset by (largest channel, green < blue)
_HUE_OFFSET = np.array([0, 360, 120, 120, 240, 240], dtype=_F32)


def _hsv_planes(r, g, b):
    """:func:`rgb_to_hsv` on contiguous float32 planes: ``(h, s, v)``."""
    vmax = np.maximum(np.maximum(r, g), b)
    diff = vmax - np.minimum(np.minimum(r, g), b)
    # which channel is the largest: 0 red, 1 green, 2 blue (red first)
    arg = (r != vmax).astype(np.intp)
    arg += arg & (g != vmax)
    n = arg.size
    pick = arg * n
    pick += np.arange(n, dtype=np.intp).reshape(arg.shape)
    h = np.take(np.stack([g - b, b - r, r - g]).reshape(-1), pick)
    arg *= 2
    arg += g < b
    h = _fma(h, _F32(60) / (diff + _FLT_EPSILON), np.take(_HUE_OFFSET, arg))
    return h, diff / (np.abs(vmax) + _FLT_EPSILON), vmax


def rgb_to_hsv(img: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(img, cv2.COLOR_RGB2HSV)`` for float32 RGB in [0, 1]:
    H in degrees [0, 360), S and V in [0, 1]."""
    return np.stack(_hsv_planes(*np.moveaxis(img, -1, 0).copy()), axis=-1)


# which of (v, v(1 - s), v(1 - s f), v(1 - s(1 - f))) is r, g and b in
# each sixth of the hue circle
_SECTOR_RGB = np.array([[0, 3, 1], [2, 0, 1], [1, 0, 3], [1, 2, 0],
                        [3, 1, 0], [0, 1, 2]], dtype=np.intp)


def _rgb_planes(h, s, v, out, scale=None):
    """:func:`hsv_to_rgb` on contiguous float32 planes, each channel
    written into ``out[..., c]``, times ``scale`` where given."""
    one = _F32(1)
    h = h * _F32(6.0 / 360.0)
    pre = np.trunc(h)
    frac = h - pre
    sector = (pre - np.trunc(pre * _F32(1.0 / 6.0)) * _F32(6)).astype(
        np.int8)
    s64 = s.astype(np.float64)
    tab = (v, v * (one - s), v * (1.0 - s64 * frac).astype(_F32),
           v * (1.0 - s64 * (one - frac)).astype(_F32))
    # each channel gathers its tab entry: (tab index) * n + pixel
    n = sector.size
    tabs = np.stack(tab).reshape(-1)
    pixel = np.arange(n, dtype=np.intp).reshape(sector.shape)
    for c in range(3):
        pick = np.take(_SECTOR_RGB[:, c] * n, sector)
        pick += pixel
        chan = np.take(tabs, pick)
        out[..., c] = chan if scale is None else chan * scale
    return out


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """``cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)`` for float32 HSV (H in
    degrees)."""
    return _rgb_planes(*np.moveaxis(hsv, -1, 0).copy(),
                       out=np.empty(hsv.shape, _F32))


# ------------------------------------------------------------------ photometric

def _blend(a: np.ndarray, b, factor: float) -> np.ndarray:
    """``clip(f*a + (1-f)*b)`` with minimal temporaries; ``b`` may be a
    scalar or a broadcastable array."""
    out = np.multiply(a, np.float32(factor), dtype=np.float32)
    if isinstance(b, np.ndarray):
        out += (1.0 - factor) * b
    elif b:
        out += np.float32((1.0 - factor) * b)
    return np.clip(out, 0.0, 255.0, out=out)


def _grayscale(img: np.ndarray) -> np.ndarray:
    # ITU-R 601-2 luma, matching PIL's L conversion used by ColorJitter.
    return img @ np.array([0.299, 0.587, 0.114], np.float32)


def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    return _blend(img, 0.0, factor)


def adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    mean = float(_grayscale(img).mean())
    return _blend(img, mean, factor)


def adjust_saturation(img: np.ndarray, factor: float) -> np.ndarray:
    gray = _grayscale(img)[..., None]
    return _blend(img, gray, factor)


def adjust_hue(img: np.ndarray, shift: float) -> np.ndarray:
    """Shift hue by ``shift`` (fraction of a full turn, in [-0.5, 0.5]):
    ``hsv_to_rgb`` of ``rgb_to_hsv(img / 255)`` with the hue moved, times
    255, computed on channel planes."""
    rgb = np.ascontiguousarray(np.moveaxis(img, -1, 0), dtype=np.float32)
    rgb /= _F32(255.0)
    h, s, v = _hsv_planes(*rgb)
    h = (h + shift * 360.0) % 360.0
    return _rgb_planes(h, s, v, out=np.empty(img.shape, _F32),
                       scale=255.0)


def adjust_gamma(img: np.ndarray, gamma: float, gain: float = 1.0) -> np.ndarray:
    if gamma == 1.0:
        out = np.multiply(img, np.float32(gain), dtype=np.float32)
        return np.clip(out, 0.0, 255.0, out=out)
    out = np.multiply(img, np.float32(1.0 / 255.0), dtype=np.float32)
    np.power(out, np.float32(gamma), out=out)
    out *= np.float32(255.0 * gain)
    return np.clip(out, 0.0, 255.0, out=out)


class PhotometricAugment:
    """ColorJitter-equivalent: random factors, random op order, then gamma.

    ``brightness``/``contrast`` give factor ranges [max(0,1-x), 1+x];
    ``saturation`` is an explicit (lo, hi) range; ``hue`` a turn fraction
    drawn from [-hue, hue]; ``gamma`` is (gamma_min, gamma_max, gain_min,
    gain_max) as in the reference's AdjustGamma.
    """

    def __init__(self, brightness: float = 0.4, contrast: float = 0.4,
                 saturation: Tuple[float, float] = (0.6, 1.4),
                 hue: float = 0.5 / 3.14,
                 gamma: Sequence[float] = (1, 1, 1, 1)):
        self.brightness = (max(0.0, 1.0 - brightness), 1.0 + brightness)
        self.contrast = (max(0.0, 1.0 - contrast), 1.0 + contrast)
        self.saturation = tuple(saturation)
        self.hue = hue
        self.gamma = tuple(gamma)

    def __call__(self, img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        out = img.astype(np.float32)
        ops = [
            lambda x: adjust_brightness(x, rng.uniform(*self.brightness)),
            lambda x: adjust_contrast(x, rng.uniform(*self.contrast)),
            lambda x: adjust_saturation(x, rng.uniform(*self.saturation)),
            lambda x: adjust_hue(x, rng.uniform(-self.hue, self.hue)),
        ]
        for i in rng.permutation(4):
            out = ops[i](out)
        g_min, g_max, gain_min, gain_max = self.gamma
        # the draws happen whether or not gamma is an identity, so the
        # stream is the same either way
        gamma = rng.uniform(g_min, g_max)
        gain = rng.uniform(gain_min, gain_max)
        if not (gamma == 1.0 and gain == 1.0):
            out = adjust_gamma(out, gamma, gain)
        return out.astype(np.uint8)


# ------------------------------------------------------------------ shared pieces

def _eraser(img2: np.ndarray, rng: np.random.Generator,
            bounds: Tuple[int, int] = (50, 100), prob: float = 0.5) -> np.ndarray:
    """Occlusion simulation: paint mean-color rectangles into the right image."""
    ht, wd = img2.shape[:2]
    if rng.random() < prob:
        img2 = img2.copy()
        mean_color = img2.reshape(-1, 3).mean(axis=0)
        for _ in range(rng.integers(1, 3)):
            x0 = rng.integers(0, wd)
            y0 = rng.integers(0, ht)
            dx = rng.integers(bounds[0], bounds[1])
            dy = rng.integers(bounds[0], bounds[1])
            img2[y0:y0 + dy, x0:x0 + dx, :] = mean_color
    return img2


def _flips(img1, img2, flow, rng, do_flip, h_flip_prob, v_flip_prob,
           valid=None):
    """The reference's three flip modes: 'hf' mirrors both images and
    negates x-flow; 'h' is the stereo-consistent flip (mirror AND swap
    left/right, flow unchanged); 'v' flips vertically with prob
    ``v_flip_prob`` and negates y-flow. ``valid`` (sparse GT) is flipped
    together with ``flow``; dense callers pass ``valid=None`` (their
    validity is recomputed from the flipped flow afterwards)."""
    if do_flip:
        if rng.random() < h_flip_prob and do_flip == "hf":
            img1 = img1[:, ::-1]
            img2 = img2[:, ::-1]
            flow = flow[:, ::-1] * [-1.0, 1.0]
            if valid is not None:
                valid = valid[:, ::-1]
        if rng.random() < h_flip_prob and do_flip == "h":
            img1, img2 = img2[:, ::-1], img1[:, ::-1]
        if rng.random() < v_flip_prob and do_flip == "v":
            img1 = img1[::-1, :]
            img2 = img2[::-1, :]
            flow = flow[::-1, :] * [1.0, -1.0]
            if valid is not None:
                valid = valid[::-1, :]
    if valid is None:
        return img1, img2, flow
    return img1, img2, flow, valid


class FlowAugmentor:
    """Dense-GT augmentor (SceneFlow/Sintel/FallingThings/TartanAir)."""

    def __init__(self, crop_size: Tuple[int, int], min_scale: float = -0.2,
                 max_scale: float = 0.5, do_flip: Optional[str] = None,
                 yjitter: bool = False,
                 saturation_range: Tuple[float, float] = (0.6, 1.4),
                 gamma: Sequence[float] = (1, 1, 1, 1)):
        self.crop_size = tuple(crop_size)
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_aug_prob = 1.0
        self.stretch_prob = 0.8
        self.max_stretch = 0.2
        self.yjitter = yjitter
        self.do_flip = do_flip
        self.h_flip_prob = 0.5
        self.v_flip_prob = 0.1
        self.photo = PhotometricAugment(0.4, 0.4, saturation_range,
                                        0.5 / 3.14, gamma)
        self.asymmetric_color_aug_prob = 0.2

    def color_transform(self, img1, img2, rng):
        if rng.random() < self.asymmetric_color_aug_prob:
            return self.photo(img1, rng), self.photo(img2, rng)
        stack = self.photo(np.concatenate([img1, img2], axis=0), rng)
        out1, out2 = np.split(stack, 2, axis=0)
        return out1, out2

    def spatial_transform(self, img1, img2, flow, rng):
        ch, cw = self.crop_size
        ht, wd = img1.shape[:2]
        # never scale below what the crop (plus an 8-px guard) needs
        min_scale = max((ch + 8) / float(ht), (cw + 8) / float(wd))

        scale = 2.0 ** rng.uniform(self.min_scale, self.max_scale)
        scale_x = scale_y = scale
        if rng.random() < self.stretch_prob:
            scale_x *= 2 ** rng.uniform(-self.max_stretch, self.max_stretch)
            scale_y *= 2 ** rng.uniform(-self.max_stretch, self.max_stretch)
        scale_x = max(scale_x, min_scale)
        scale_y = max(scale_y, min_scale)

        if rng.random() < self.spatial_aug_prob:
            img1 = resize_linear(img1, scale_x, scale_y)
            img2 = resize_linear(img2, scale_x, scale_y)
            flow = resize_linear(flow, scale_x, scale_y)
            flow = flow * [scale_x, scale_y]

        img1, img2, flow = _flips(img1, img2, flow, rng, self.do_flip,
                                  self.h_flip_prob, self.v_flip_prob)

        if self.yjitter:
            y0 = rng.integers(2, img1.shape[0] - ch - 2)
            x0 = rng.integers(2, img1.shape[1] - cw - 2)
            y1 = y0 + rng.integers(-2, 3)  # imperfect-rectification jitter
            img1 = img1[y0:y0 + ch, x0:x0 + cw]
            img2 = img2[y1:y1 + ch, x0:x0 + cw]
            flow = flow[y0:y0 + ch, x0:x0 + cw]
        else:
            y0 = rng.integers(0, img1.shape[0] - ch)
            x0 = rng.integers(0, img1.shape[1] - cw)
            img1 = img1[y0:y0 + ch, x0:x0 + cw]
            img2 = img2[y0:y0 + ch, x0:x0 + cw]
            flow = flow[y0:y0 + ch, x0:x0 + cw]
        return img1, img2, flow

    def __call__(self, img1, img2, flow, rng: np.random.Generator):
        img1, img2 = self.color_transform(img1, img2, rng)
        img2 = _eraser(img2, rng)
        img1, img2, flow = self.spatial_transform(img1, img2, flow, rng)
        return (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                np.ascontiguousarray(flow))


class SparseFlowAugmentor:
    """Sparse-GT augmentor (KITTI/ETH3D/Middlebury): scatter-resized flow maps."""

    def __init__(self, crop_size: Tuple[int, int], min_scale: float = -0.2,
                 max_scale: float = 0.5, do_flip: Optional[str] = None,
                 yjitter: bool = False,
                 saturation_range: Tuple[float, float] = (0.7, 1.3),
                 gamma: Sequence[float] = (1, 1, 1, 1)):
        del yjitter  # accepted for interface parity; sparse crops never jitter
        self.crop_size = tuple(crop_size)
        self.min_scale = min_scale
        self.max_scale = max_scale
        self.spatial_aug_prob = 0.8
        self.do_flip = do_flip
        self.h_flip_prob = 0.5
        self.v_flip_prob = 0.1
        self.photo = PhotometricAugment(0.3, 0.3, saturation_range,
                                        0.3 / 3.14, gamma)

    def color_transform(self, img1, img2, rng):
        stack = self.photo(np.concatenate([img1, img2], axis=0), rng)
        out1, out2 = np.split(stack, 2, axis=0)
        return out1, out2

    @staticmethod
    def resize_sparse_flow_map(flow, valid, fx: float, fy: float):
        """Resize a sparse flow field by scattering its valid samples."""
        ht, wd = flow.shape[:2]
        xx, yy = np.meshgrid(np.arange(wd), np.arange(ht))
        coords = np.stack([xx, yy], axis=-1).reshape(-1, 2).astype(np.float32)
        flow_flat = flow.reshape(-1, 2).astype(np.float32)
        keep = valid.reshape(-1) >= 1

        coords1 = coords[keep] * [fx, fy]
        flow1 = flow_flat[keep] * [fx, fy]

        ht1, wd1 = int(round(ht * fy)), int(round(wd * fx))
        xi = np.round(coords1[:, 0]).astype(np.int32)
        yi = np.round(coords1[:, 1]).astype(np.int32)
        inb = (xi > 0) & (xi < wd1) & (yi > 0) & (yi < ht1)

        flow_img = np.zeros([ht1, wd1, 2], dtype=np.float32)
        valid_img = np.zeros([ht1, wd1], dtype=np.int32)
        flow_img[yi[inb], xi[inb]] = flow1[inb]
        valid_img[yi[inb], xi[inb]] = 1
        return flow_img, valid_img

    def spatial_transform(self, img1, img2, flow, valid, rng):
        ch, cw = self.crop_size
        ht, wd = img1.shape[:2]
        min_scale = max((ch + 1) / float(ht), (cw + 1) / float(wd))
        scale = max(2.0 ** rng.uniform(self.min_scale, self.max_scale),
                    min_scale)

        if rng.random() < self.spatial_aug_prob or \
                img1.shape[0] <= ch or img1.shape[1] <= cw:
            img1 = resize_linear(img1, scale, scale)
            img2 = resize_linear(img2, scale, scale)
            flow, valid = self.resize_sparse_flow_map(flow, valid, scale, scale)

        img1, img2, flow, valid = _flips(img1, img2, flow, rng, self.do_flip,
                                         self.h_flip_prob, self.v_flip_prob,
                                         valid=valid)

        # margin-biased crop: favors the lower / interior image regions where
        # sparse GT (LiDAR) actually lives
        margin_y, margin_x = 20, 50
        y0 = rng.integers(0, img1.shape[0] - ch + margin_y)
        x0 = rng.integers(-margin_x, img1.shape[1] - cw + margin_x)
        y0 = int(np.clip(y0, 0, img1.shape[0] - ch))
        x0 = int(np.clip(x0, 0, img1.shape[1] - cw))

        img1 = img1[y0:y0 + ch, x0:x0 + cw]
        img2 = img2[y0:y0 + ch, x0:x0 + cw]
        flow = flow[y0:y0 + ch, x0:x0 + cw]
        valid = valid[y0:y0 + ch, x0:x0 + cw]
        return img1, img2, flow, valid

    def __call__(self, img1, img2, flow, valid, rng: np.random.Generator):
        img1, img2 = self.color_transform(img1, img2, rng)
        img2 = _eraser(img2, rng)
        img1, img2, flow, valid = self.spatial_transform(img1, img2, flow,
                                                         valid, rng)
        return (np.ascontiguousarray(img1), np.ascontiguousarray(img2),
                np.ascontiguousarray(flow), np.ascontiguousarray(valid))
