"""PNG reading and writing on zlib (no Pillow): what the KAIST reader and
its synthetic fixture need.

`read_gray` decodes non-interlaced 8-bit grayscale (color type 0) and RGB
(color type 2) images with any of the five row filters; RGB converts to
one channel as Pillow's `convert("L")` does (ITU-R 601-2 luma in 16-bit
fixed point, L = (19595 R + 38470 G + 7471 B + 2^15) >> 16); `read_rgb`
returns an RGB image's three channels.  `write_gray` and `write_rgb` encode
8-bit grayscale and RGB images with filter 0 (none) on every row.  Any
other format raises ValueError naming it.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPES = {0: "grayscale", 2: "RGB", 3: "palette", 4: "grayscale+alpha", 6: "RGBA"}
_CHANNELS = {0: 1, 2: 3}


def _chunks(data: bytes, path):
    if data[:8] != SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = data[pos + 8 + n:pos + 12 + n]
        if len(body) != n or len(crc) != 4:
            raise ValueError(f"{path}: truncated {kind!r} chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body):
            raise ValueError(f"{path}: bad CRC in the {kind!r} chunk")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + n
    raise ValueError(f"{path}: no IEND chunk")


def _unfilter(raw: np.ndarray, H: int, W: int, bpp: int, path) -> np.ndarray:
    """Undo the row filters of (H, 1 + W bpp) filtered bytes -> (H, W, bpp)
    uint8.  Rows that are all filter 0 are the bytes themselves; otherwise
    the pixels are reconstructed along anti-diagonals (pixel (y, x) needs
    (y, x-1), (y-1, x) and (y-1, x-1)), all filters at once."""
    ftype = raw[:, 0].astype(np.int64)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown row filter {int(ftype.max())}")
    filt = raw[:, 1:].reshape(H, W, bpp)
    if not ftype.any():
        return filt.copy()
    rec = np.zeros((H + 1, W + 1, bpp), dtype=np.int64)  # a zero row above, a zero column left
    filt = filt.astype(np.int64)
    for k in range(H + W - 1):
        y = np.arange(max(0, k - W + 1), min(H - 1, k) + 1)
        x = k - y
        a, b, c = rec[y + 1, x], rec[y, x + 1], rec[y, x]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        t = ftype[y][:, None]
        pred = np.select([t == 1, t == 2, t == 3, t == 4], [a, b, (a + b) >> 1, paeth], 0)
        rec[y + 1, x + 1] = (filt[y, x] + pred) & 0xFF
    return rec[1:, 1:].astype(np.uint8)


def _decode(path) -> np.ndarray:
    """An 8-bit grayscale or RGB PNG's pixels, (H, W, channels) uint8."""
    with open(path, "rb") as f:
        data = f.read()
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    W, H, depth, color, compression, filter_method, interlace = header
    what = f"{depth}-bit {_COLOR_TYPES.get(color, f'color type {color}')}"
    if color not in _CHANNELS or depth != 8:
        raise ValueError(f"{path}: {what} PNG; only 8-bit grayscale and RGB are read")
    if interlace:
        raise ValueError(f"{path}: interlaced (Adam7) {what} PNG; only non-interlaced is read")
    if compression or filter_method:
        raise ValueError(f"{path}: unknown compression {compression} / filter method "
                         f"{filter_method}")
    bpp = _CHANNELS[color]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
    if raw.size != H * (1 + W * bpp):
        raise ValueError(f"{path}: {raw.size} image bytes for {W} x {H} {what}")
    return _unfilter(raw.reshape(H, 1 + W * bpp), H, W, bpp, path)


def read_gray(path) -> np.ndarray:
    """An 8-bit grayscale or RGB PNG as an (H, W) uint8 luma image."""
    px = _decode(path)
    if px.shape[-1] == 1:
        return px[..., 0]
    rgb = px.astype(np.uint32)
    return ((19595 * rgb[..., 0] + 38470 * rgb[..., 1] + 7471 * rgb[..., 2] + 0x8000)
            >> 16).astype(np.uint8)


def read_rgb(path) -> np.ndarray:
    """An 8-bit RGB PNG as an (H, W, 3) uint8 image."""
    px = _decode(path)
    if px.shape[-1] != 3:
        raise ValueError(f"{path}: a grayscale PNG; read_rgb reads RGB")
    return px


def _write(path, img, color: int) -> None:
    H, W = img.shape[:2]
    raw = np.concatenate([np.zeros((H, 1), dtype=np.uint8), img.reshape(H, -1)],
                         axis=1).tobytes()

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(
            ">I", zlib.crc32(kind + body))

    with open(path, "wb") as f:
        f.write(SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, color, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def write_gray(path, img) -> None:
    """Write an (H, W) uint8 image as an 8-bit grayscale PNG, filter 0."""
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim != 2:
        raise ValueError(f"write_gray: needs an (H, W) uint8 image, got {img.dtype} "
                         f"{img.shape}")
    _write(path, img, 0)


def write_rgb(path, img) -> None:
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG, filter 0."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[-1] != 3:
        raise ValueError(f"write_rgb: needs an (H, W, 3) uint8 image, got {img.dtype} "
                         f"{img.shape}")
    _write(path, img, 2)
