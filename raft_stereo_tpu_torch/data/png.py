"""PNG decoding and encoding with zlib and numpy (no PIL, no cv2).

:func:`read_png` decodes a non-interlaced PNG of bit depth 8 or 16 in gray,
gray+alpha, RGB or RGBA, with any of the five row filters, and returns the
stored samples: uint8 or uint16, ``(H, W)`` for gray, else ``(H, W, C)`` in
the file's channel order. Any other PNG — a palette image, interlacing, a
depth below 8, a transparency chunk — and a damaged file (bad signature,
bad CRC, truncated data) raise ``ValueError`` naming the file.

:func:`write_png` stores such an array, every row with one filter (0, none,
by default; 4, Paeth, makes files that decode as costly as photographs
written by libpng or PIL, whose adaptive choice is mostly Paeth).

Undoing the filters: an image of None, Sub and Up rows only is undone a
row at a time (Sub is a running sum along the row modulo 256, Up one add
of the row above). Average and Paeth make each byte depend on the
reconstructed pixels to its left and above at once, so no row can be
undone in one array operation. Pixel ``(y, x)`` needs only ``(y, x-1)``,
``(y-1, x)`` and ``(y-1, x-1)``, so every pixel of one anti-diagonal
``x + y = t`` can be undone together: the bytes are stored skewed
(diagonal-major), which makes each anti-diagonal contiguous, and ``H + W -
1`` vectorised steps undo the image, each prediction one lookup in a table
of every filter's predictor over all byte triples.
"""

from __future__ import annotations

import struct
import threading
import zlib
from typing import Tuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> samples a pixel, and back
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}
_ZLIB_LEVEL = 6  # zlib's default, as PIL and libpng write


def read_png(path: str) -> np.ndarray:
    """Decode the PNG at ``path`` (see the module docstring)."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def _chunks(data: bytes, name: str):
    """Yield ``(type, body)`` of every chunk up to IEND, CRCs checked."""
    pos = len(SIGNATURE)
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{name}: truncated PNG (no IEND chunk)")
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"{name}: truncated PNG ({ctype!r} chunk)")
        body = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(ctype + body) != crc:
            raise ValueError(f"{name}: CRC mismatch in {ctype!r} chunk")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos = end + 4


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Decode PNG file contents; ``name`` labels errors."""
    if data[:len(SIGNATURE)] != SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    header, idat = None, []
    for ctype, body in _chunks(data, name):
        if ctype == b"IHDR":
            if len(body) != 13:
                raise ValueError(f"{name}: malformed IHDR chunk")
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"tRNS":
            raise ValueError(f"{name}: PNG transparency chunks are not "
                             "supported")
    if header is None:
        raise ValueError(f"{name}: PNG without an IHDR chunk")
    width, height, depth, color, compression, filtering, interlace = header
    if color not in _CHANNELS:
        raise ValueError(f"{name}: PNG color type {color} (palette) is not "
                         "supported; gray, gray+alpha, RGB and RGBA are")
    if depth not in (8, 16):
        raise ValueError(f"{name}: PNG bit depth {depth} is not supported; "
                         "8 and 16 are")
    if interlace != 0:
        raise ValueError(f"{name}: interlaced PNGs are not supported")
    if compression != 0 or filtering != 0:
        raise ValueError(f"{name}: unknown PNG compression or filter method")
    channels = _CHANNELS[color]
    bpp = channels * depth // 8  # bytes a pixel
    stride = width * bpp
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as exc:
        raise ValueError(f"{name}: corrupt PNG image data ({exc})") from exc
    if len(raw) < height * (stride + 1):
        raise ValueError(f"{name}: truncated PNG image data")
    rows = np.frombuffer(raw, np.uint8, count=height * (stride + 1)
                         ).reshape(height, stride + 1)
    ftype = rows[:, 0]
    if (ftype > 4).any():
        raise ValueError(f"{name}: unknown PNG row filter "
                         f"{int(ftype.max())}")
    pixels = _unfilter(rows[:, 1:].reshape(height, width, bpp), ftype)
    if depth == 16:
        pixels = pixels.reshape(height, width * bpp).view(">u2").astype(
            np.uint16)
    pixels = pixels.reshape(height, width, channels)
    return pixels[..., 0] if channels == 1 else pixels


def _unfilter(filt: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Undo the row filters: ``filt (H, W, bpp)`` uint8 filtered bytes,
    ``ftype (H,)`` each row's filter -> the reconstructed bytes."""
    if not ftype.any():
        return np.ascontiguousarray(filt)
    if ftype.max() <= 2:
        return _unfilter_rows(filt, ftype)
    return _unfilter_diagonals(filt, ftype)


def _unfilter_rows(filt: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """None, Sub and Up rows only: a row at a time, Sub as a running sum
    along the row and Up as one add of the row above (uint8 arithmetic
    wraps modulo 256, as PNG's does)."""
    out = np.empty_like(filt)
    prev = np.zeros_like(filt[0])
    for y, t in enumerate(ftype):
        if t == 0:
            out[y] = filt[y]
        elif t == 1:
            np.cumsum(filt[y], axis=0, dtype=np.uint8, out=out[y])
        else:
            np.add(filt[y], prev, out=out[y])
        prev = out[y]
    return out


_TABLES: dict = {}
_TABLES_LOCK = threading.Lock()


def _predictor_tables() -> Tuple[np.ndarray, np.ndarray]:
    """``(simple, paeth)`` predictor tables, built once a process (16 MiB).
    ``simple[t << 16 | a << 8 | b]`` is filter ``t``'s prediction (0-3;
    4 maps to 0) from the bytes to the left (``a``) and above (``b``);
    ``paeth[a << 16 | b << 8 | c]`` is Paeth's, ``c`` the byte above-left.
    """
    with _TABLES_LOCK:
        if not _TABLES:
            a = np.arange(256, dtype=np.int16)[:, None]
            b = np.arange(256, dtype=np.int16)[None, :]
            simple = np.zeros((5, 256, 256), np.uint8)
            simple[1], simple[2] = a, b
            simple[3] = (a + b) >> 1
            paeth = np.empty((256, 256, 256), np.uint8)
            c = np.arange(256, dtype=np.int16)
            for i in range(256):
                pa, pb = np.abs(b.T - c), np.abs(i - c)
                pc = np.abs(i + b.T - 2 * c)
                paeth[i] = np.where((pa <= pb) & (pa <= pc), i,
                                    np.where(pb <= pc, b.T, c))
            for name, table in (("simple", simple), ("paeth", paeth)):
                table.setflags(write=False)  # shared by every decode
                _TABLES[name] = table.reshape(-1)
    return _TABLES["simple"], _TABLES["paeth"]


def _unfilter_diagonals(filt: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Any mix of filters, one anti-diagonal at a time (module docstring),
    each prediction a lookup in :func:`_predictor_tables`."""
    h, w, bpp = filt.shape
    simple, paeth = _predictor_tables()
    # diagonal-major: recon[y, x] lives at rec[x + y + 2, y + 1], so each
    # anti-diagonal is contiguous; rec[., 0] and the entries before each
    # row's start stay 0, the PNG's padding above and to the left
    rec = np.zeros((h + w + 2, h + 1, bpp), np.int32)
    skew = np.zeros((h + w, h, bpp), np.uint8)  # filt[y, x] at [x + y, y]
    for y in range(h):
        skew[y:y + w, y] = filt[y]
    kind = (ftype.astype(np.int32) << 16)[:, None]
    is_paeth = (ftype == 4)[:, None]
    only_paeth, any_paeth = bool(is_paeth.all()), bool(is_paeth.any())
    byte = np.empty((h, bpp), np.uint8)
    for t in range(h + w - 1):
        lo, hi = max(0, t - w + 1), min(h - 1, t) + 1
        a = rec[t + 1, lo + 1:hi + 1]  # left
        ab = (a << 8) | rec[t + 1, lo:hi]  # | up
        if only_paeth:
            pred = np.take(paeth, (ab << 8) | rec[t, lo:hi])  # | up-left
        else:
            pred = np.take(simple, kind[lo:hi] | ab)
            if any_paeth:
                pred = np.where(is_paeth[lo:hi], np.take(
                    paeth, (ab << 8) | rec[t, lo:hi]), pred)
        out = byte[:hi - lo]
        np.add(skew[t, lo:hi], pred, out=out)
        rec[t + 2, lo + 1:hi + 1] = out
    out = np.empty((h, w, bpp), np.uint8)
    for y in range(h):
        out[y] = rec[y + 2:y + 2 + w, y + 1]
    return out


def _filter_rows(raw: np.ndarray, bpp: int, filter_type: int) -> np.ndarray:
    """Filter every row of ``raw (H, stride)`` uint8 with ``filter_type``."""
    cur = raw.astype(np.int16)
    left = np.zeros_like(cur)
    left[:, bpp:] = cur[:, :-bpp]
    up = np.zeros_like(cur)
    up[1:] = cur[:-1]
    upleft = np.zeros_like(cur)
    upleft[1:, bpp:] = cur[:-1, :-bpp]
    if filter_type == 0:
        pred = 0
    elif filter_type == 1:
        pred = left
    elif filter_type == 2:
        pred = up
    elif filter_type == 3:
        pred = (left + up) >> 1
    else:
        pa, pb = np.abs(up - upleft), np.abs(left - upleft)
        pc = np.abs(left + up - 2 * upleft)
        pred = np.where((pa <= pb) & (pa <= pc), left,
                        np.where(pb <= pc, up, upleft))
    return ((cur - pred) & 0xFF).astype(np.uint8)


def encode_png(array: np.ndarray, filter_type: int = 0) -> bytes:
    """PNG file contents for a uint8 or uint16 ``(H, W)`` or ``(H, W, C)``
    array, C in 1..4 (gray, gray+alpha, RGB, RGBA), every row filtered
    with ``filter_type`` (0-4)."""
    a = np.asarray(array)
    if a.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png takes uint8 or uint16, not {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    if a.ndim != 3 or a.shape[-1] not in _COLOR_TYPE:
        raise ValueError(f"write_png takes (H, W) or (H, W, 1..4) arrays, "
                         f"not {a.shape}")
    if filter_type not in range(5):
        raise ValueError(f"PNG row filter {filter_type} is not one of 0-4")
    h, w, c = a.shape
    depth = 8 * a.itemsize
    rows = a.astype(">u2" if depth == 16 else np.uint8).view(
        np.uint8).reshape(h, -1)
    raw = np.empty((h, 1 + rows.shape[1]), np.uint8)
    raw[:, 0] = filter_type
    raw[:, 1:] = _filter_rows(rows, c * a.itemsize, filter_type)

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body)))

    ihdr = struct.pack(">IIBBBBB", w, h, depth, _COLOR_TYPE[c], 0, 0, 0)
    return (SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), _ZLIB_LEVEL))
            + chunk(b"IEND", b""))


def write_png(path: str, array: np.ndarray, filter_type: int = 0) -> None:
    """Write ``array`` as a PNG file (see :func:`encode_png`)."""
    with open(path, "wb") as f:
        f.write(encode_png(array, filter_type))
