"""A PNG codec on numpy and ``zlib`` (the card's machine has no OpenCV).

:func:`decode_png` reads 8-bit gray, gray+alpha, RGB and RGBA files,
non-interlaced, with all five scanline filters; the unfiltering runs in
``csrc/png_unfilter.c`` (host C, built at first use by ``ops/_build.py``),
since Average and Paeth go byte by byte along a row. :func:`encode_png`
writes gray and RGB with filter 0 (None), through
:func:`png_from_scanlines`. Anything else (palette, 16-bit, interlaced)
raises ``NotImplementedError``.

:func:`to_gray` converts colour to gray as ``cv2.imread(...,
IMREAD_GRAYSCALE)`` does for a PNG: libpng's ``png_set_rgb_to_gray`` with
OpenCV's weights 0.299 / 0.587, which libpng turns into the 15-bit fixed
point taps 9797, 19234 and 32768 - 9797 - 19234 = 3737, truncated
(``tests/test_torch_eval.py`` holds it bit-exact to cv2). Alpha is dropped,
not composited.
"""

from __future__ import annotations

import ctypes
import struct
import zlib

import numpy as np

from . import _build

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels of an 8-bit pixel
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_GRAY_TAPS = (9797, 19234, 3737)    # libpng's fixed point of 0.299, 0.587


def _chunks(data: bytes):
    if data[:8] != SIGNATURE:
        raise ValueError("not a PNG file (bad signature)")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise ValueError(f"truncated PNG chunk {kind!r}")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f"PNG chunk {kind!r} fails its CRC")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError("truncated PNG file (no IEND chunk)")


def _unfilter_fn():
    fn = _build.load("png_unfilter").png_unfilter
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int]
        fn.restype = ctypes.c_longlong
    return fn


def _unfilter(data: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters: [h, stride] uint8."""
    if len(data) < h * (stride + 1):
        raise ValueError("PNG image data is shorter than its header says")
    rows = np.frombuffer(data, np.uint8, h * (stride + 1))
    out = np.empty((h, stride), np.uint8)
    bad = _unfilter_fn()(rows.ctypes.data, out.ctypes.data, h, stride, bpp)
    if bad:
        raise ValueError(f"PNG scanline {bad - 1} has unknown filter "
                         f"{rows[(bad - 1) * (stride + 1)]}")
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> HWC uint8 with the file's channels (1 gray, 2 gray +
    alpha, 3 RGB, 4 RGBA), in the file's (RGB) order."""
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG file has no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS:
        raise NotImplementedError(
            f"PNG with bit depth {depth} and colour type {ctype}: the codec "
            "reads 8-bit gray, gray+alpha, RGB and RGBA only")
    if interlace:
        raise NotImplementedError("interlaced PNG is not supported")
    c = _CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * c, c)
    return px.reshape(h, w, c)


def chunk(kind: bytes, body: bytes) -> bytes:
    """One PNG chunk: length, type, body, CRC."""
    return (struct.pack(">I", len(body)) + kind + body +
            struct.pack(">I", zlib.crc32(kind + body)))


def png_from_scanlines(rows: np.ndarray, width: int, channels: int) -> bytes:
    """[H, 1 + width * channels] uint8 filtered scanlines (each a filter
    byte, then the row) -> an 8-bit PNG file with 1-4 channels."""
    ctype = {c: t for t, c in _CHANNELS.items()}[channels]
    ihdr = struct.pack(">IIBBBBB", width, rows.shape[0], 8, ctype, 0, 0, 0)
    return (SIGNATURE + chunk(b"IHDR", ihdr) +
            chunk(b"IDAT", zlib.compress(rows.tobytes())) +
            chunk(b"IEND", b""))


def encode_png(img: np.ndarray) -> bytes:
    """HW or HWC uint8 (C 1 gray or 3 RGB) -> PNG bytes, filter 0."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in (1, 3):
        raise ValueError(f"encode_png takes HW or HWC with C 1 or 3, got "
                         f"{img.shape}")
    h, w, c = img.shape
    rows = np.zeros((h, w * c + 1), np.uint8)      # filter byte 0 per row
    rows[:, 1:] = img.reshape(h, w * c)
    return png_from_scanlines(rows, w, c)


def to_gray(img: np.ndarray) -> np.ndarray:
    """HWC uint8 with 1-4 channels (file order) -> HW1 gray, as
    ``cv2.IMREAD_GRAYSCALE`` reads a PNG."""
    if img.shape[-1] <= 2:
        return img[..., :1].copy()
    r, g, b = (img[..., k].astype(np.int32) for k in range(3))
    rc, gc, bc = _GRAY_TAPS
    return ((rc * r + gc * g + bc * b) >> 15).astype(np.uint8)[..., None]


def to_rgb(img: np.ndarray) -> np.ndarray:
    """HWC uint8 with 1-4 channels (file order) -> HW3 RGB, alpha dropped,
    gray replicated (``cv2.IMREAD_COLOR``, before its BGR order)."""
    if img.shape[-1] <= 2:
        return np.repeat(img[..., :1], 3, axis=-1)
    return img[..., :3].copy()
