"""Image read/write.

``write_image`` is the RenderTarget2D.SaveAsPng analog (Game1.cs:156-161);
``read_image`` replaces RayTracerTexture's GDI+ bitmap load
(RayTracerTexture.cs:24-33) returning (H, W, 3) uint8 top-down rows, the
layout Material.LookupUV indexes.

PNG is encoded and decoded here with the standard library (``zlib`` and
``struct``).  Other formats (JPEG or BMP textures) go through PIL, which is
then an optional dependency of that path only.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _to_uint8(image) -> np.ndarray:
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    return arr


def encode_png(arr: np.ndarray) -> bytes:
    """(H, W, 3) or (H, W) uint8 -> PNG bytes (8-bit RGB or gray, filter 0)."""
    arr = np.ascontiguousarray(arr, np.uint8)
    h, w = arr.shape[:2]
    color = 2 if arr.ndim == 3 else 0
    rows = arr.reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data)))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0)
    return (_PNG_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + chunk(b"IEND", b""))


def _unfilter(data: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG scanline filters (None, Sub, Up, Average, Paeth)."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    rows = data.reshape(h, stride + 1)
    for y in range(h):
        ftype = rows[y, 0]
        line = rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype in (1, 3, 4):
            cur = line.copy()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + prev[x]) >> 1
                else:
                    b = prev[x]
                    c = prev[x - bpp] if x >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def decode_png(blob: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 (8/16-bit gray, RGB, palette, +alpha;
    non-interlaced)."""
    if blob[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, palette = 8, [], None
    while pos < len(blob):
        n, tag = struct.unpack(">I4s", blob[pos:pos + 8])
        data = blob[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            w, h, depth, color, _, _, interlace = struct.unpack(
                ">IIBBBBB", data)
        elif tag == b"PLTE":
            palette = np.frombuffer(data, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    if interlace or depth not in (8, 16) or (color == 3 and depth != 8):
        raise ValueError("unsupported PNG layout (interlaced or bit depth "
                         f"{depth})")
    bpp = channels * depth // 8
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _unfilter(raw, h, w * bpp, bpp)
    if depth == 16:
        px = px.reshape(h, w * channels, 2)[..., 0]  # high byte
    px = px.reshape(h, w, channels)
    if color == 3:
        return palette[px[..., 0]]
    if channels in (1, 2):
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def write_image(path: str, image) -> None:
    """Write (H, W, 3) float [0,1] or uint8 image; PNG unless the suffix
    names another format (which needs PIL)."""
    arr = _to_uint8(image)
    if path.lower().endswith(".png"):
        with open(path, "wb") as f:
            f.write(encode_png(arr))
        return
    from PIL import Image

    Image.fromarray(arr).save(path)


def read_image(path: str) -> np.ndarray:
    """Read an image file to (H, W, 3) uint8."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] == _PNG_SIGNATURE:
        return decode_png(blob)
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im.convert("RGB"))
