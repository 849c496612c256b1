"""8-bit, non-interlaced PNG read and written with zlib and numpy.

The dataset loaders decode images through Pillow where it is importable
(as the JAX package does) and through this module where it is not: the
card's machine has no Pillow. ``PngImage`` offers the few image methods
the loaders, ``scene/cameras.py`` and the apps call (``size``, ``mode``,
``convert``, ``resize`` to the same size, ``save``, and the numpy array
view).

Colour types: gray (0), RGB (2) and RGBA (6), bit depth 8. The reader
takes all five row filters; the writer writes filter 0 (none). Palette,
16-bit and interlaced files raise, as does every JPEG (Pillow only).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
MODES = {0: "L", 2: "RGB", 6: "RGBA"}  # colour type -> mode
CHANNELS = {"L": 1, "RGB": 3, "RGBA": 4}


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters of a decompressed image -> [height, stride]
    uint8 (PNG specification, section 9)."""
    rows = np.frombuffer(raw, np.uint8)
    if rows.size != height * (stride + 1):
        raise ValueError(f"PNG data holds {rows.size} bytes, expected {height * (stride + 1)}")
    rows = rows.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        ftype, line = rows[y, 0], rows[y, 1:]
        if ftype == 0:  # none
            cur = line.copy()
        elif ftype == 1:  # sub: a running sum per channel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif ftype == 2:  # up
            cur = line + prev
        elif ftype in (3, 4):  # average, paeth: serial along the row
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for i in range(stride):
                a = cur[i - bpp] if i >= bpp else 0
                b = up[i]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[i - bpp] if i >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[i] = (cur[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """[H, W] (gray), [H, W, 3] (RGB) or [H, W, 4] (RGBA) uint8."""
    with open(path, "rb") as fh:
        data = fh.read()
    if not data.startswith(SIGNATURE):
        raise ValueError(f"{path}: not a PNG file (JPEG and other formats need Pillow)")
    pos, header, idat = len(SIGNATURE), None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in MODES or interlace != 0:
        raise ValueError(f"{path}: only 8-bit, non-interlaced gray, RGB or RGBA PNG is "
                         f"read without Pillow (bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace})")
    ch = CHANNELS[MODES[ctype]]
    img = _unfilter(zlib.decompress(b"".join(idat)), height, width * ch, ch)
    return img.reshape(height, width) if ch == 1 else img.reshape(height, width, ch)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, arr: np.ndarray) -> None:
    """Write [H, W], [H, W, 3] or [H, W, 4] uint8 as an 8-bit PNG."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, not {arr.dtype}")
    ch = 1 if arr.ndim == 2 else arr.shape[2]
    ctype = {1: 0, 3: 2, 4: 6}.get(ch)
    if ctype is None or arr.ndim not in (2, 3):
        raise ValueError(f"write_png takes [H, W], [H, W, 3] or [H, W, 4], not {arr.shape}")
    height, width = arr.shape[:2]
    rows = np.concatenate([np.zeros((height, 1), np.uint8), arr.reshape(height, -1)], axis=1)
    with open(path, "wb") as fh:
        fh.write(SIGNATURE)
        fh.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, ctype, 0, 0, 0)))
        fh.write(_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)))
        fh.write(_chunk(b"IEND", b""))


class PngImage:
    """An 8-bit image with the methods of a Pillow image that the loaders
    use; ``np.array(image)`` gives its pixels."""

    def __init__(self, pixels: np.ndarray, mode: str):
        if mode not in CHANNELS:
            raise ValueError(f"mode {mode!r}: L, RGB or RGBA")
        self._pixels = pixels
        self.mode = mode

    @classmethod
    def open(cls, path: str) -> "PngImage":
        pixels = read_png(path)
        ch = 1 if pixels.ndim == 2 else pixels.shape[2]
        return cls(pixels, {1: "L", 3: "RGB", 4: "RGBA"}[ch])

    @property
    def size(self):
        """(width, height), as Pillow gives it."""
        return self._pixels.shape[1], self._pixels.shape[0]

    def convert(self, mode: str) -> "PngImage":
        """Gray to colour, adding or dropping alpha, as Pillow converts
        (RGBA -> RGB drops alpha; a new alpha is 255)."""
        px, src = self._pixels, self.mode
        if mode == src:
            return PngImage(px.copy(), mode)
        if src == "L":
            px = np.repeat(px[..., None], 3, axis=2)
        elif mode == "L":
            raise NotImplementedError("colour to gray needs Pillow")
        if mode == "RGB":
            return PngImage(np.ascontiguousarray(px[..., :3]), mode)
        alpha = np.full(px.shape[:2] + (1,), 255, np.uint8)
        return PngImage(np.concatenate([px[..., :3], alpha], axis=2), mode)

    def resize(self, size) -> "PngImage":
        """Only to the image's own size: there is no resampler without
        Pillow."""
        if tuple(size) != self.size:
            raise NotImplementedError(f"resizing {self.size} to {tuple(size)} needs Pillow")
        return self

    def save(self, path: str) -> None:
        write_png(path, self._pixels)

    def __array__(self, dtype=None, copy=None):
        return self._pixels if dtype is None else self._pixels.astype(dtype)
