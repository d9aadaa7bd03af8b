"""Image IO: PNG write/read for render output.

The reference's "Write images to disk" is an unimplemented TODO
(Readme.md:74); the windowed viewer (renderer/src/main.rs:113-131) is its
only output path. Headless accelerator rendering needs files instead.

A dependency-free PNG encoder is provided (zlib + struct from the stdlib)
so the framework works in hermetic environments; if the native runtime
extension (pathtracer_tpu.utils.native) is built, its fused
tonemap+encode path is used automatically for large frames.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from .buffer import to_u8


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (
        struct.pack(">I", len(data))
        + tag
        + data
        + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
    )


def encode_png(rgba_u8: np.ndarray) -> bytes:
    """Encode [H, W, 3|4] uint8 to PNG bytes (RGB/RGBA, 8-bit)."""
    a = np.ascontiguousarray(rgba_u8)
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] not in (3, 4):
        raise ValueError(f"expected [H,W,3|4] uint8, got {a.shape} {a.dtype}")
    h, w, c = a.shape
    color_type = 2 if c == 3 else 6
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    # filter byte 0 per scanline
    raw = b"".join(b"\x00" + a[y].tobytes() for y in range(h))
    return (
        b"\x89PNG\r\n\x1a\n"
        + _png_chunk(b"IHDR", ihdr)
        + _png_chunk(b"IDAT", zlib.compress(raw, 6))
        + _png_chunk(b"IEND", b"")
    )


def write_png(path: str, rgba_u8: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(rgba_u8))


def save_render(path: str, pixels, gamma: bool = True) -> None:
    """Save a linear [H, W, 4] buffer as PNG.

    gamma=True applies the reference's ^0.4545 encode (buffer.rs:46);
    False writes linear*255 (its convert_to_u8_at variant, buffer.rs:85).
    """
    try:
        from .native import tonemap_encode_png  # C runtime fast path

        data = tonemap_encode_png(np.asarray(pixels, np.float32), gamma)
        with open(path, "wb") as f:
            f.write(data)
        return
    except Exception:
        pass
    if gamma:
        u8 = to_u8(pixels)
    else:
        u8 = np.clip(np.asarray(pixels, np.float64) * 255.0, 0, 255).astype(np.uint8)
    write_png(path, u8)


def ansi_preview(pixels, max_cols: int = 100, gamma: bool = True) -> str:
    """Render a linear [H, W, 3|4] buffer as a 24-bit-color ANSI string.

    The live-progressive-view counterpart of the reference's windowed
    viewer (renderer/src/main.rs:113-131) for headless GPU hosts: each
    character cell shows two vertical pixels via the upper-half-block
    glyph (fg = top pixel, bg = bottom pixel). Box-filter downsampled to
    at most `max_cols` columns.
    """
    a = np.asarray(pixels, np.float64)[..., :3]
    if gamma:
        a = np.power(np.maximum(a, 0.0), 0.4545)
    a = np.clip(np.nan_to_num(a) * 255.0, 0.0, 255.0)
    h, w = a.shape[:2]
    cols = min(max_cols, w)
    # terminal cells are ~2:1 tall; half-blocks give 2 subpixels per cell
    sx = max(1, w // cols)
    sy = sx
    hh, ww = (h // (2 * sy)) * 2 * sy, (w // sx) * sx
    if hh == 0 or ww == 0:
        return ""
    ds = a[:hh, :ww].reshape(hh // sy, sy, ww // sx, sx, 3).mean(axis=(1, 3))
    ds = ds.astype(np.int32)
    lines = []
    for y in range(0, ds.shape[0] - 1, 2):
        cells = []
        for x in range(ds.shape[1]):
            tr, tg, tb = ds[y, x]
            br, bg_, bb = ds[y + 1, x]
            cells.append(
                f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg_};{bb}m▀"
            )
        lines.append("".join(cells) + "\x1b[0m")
    return "\n".join(lines)


def read_png(path: str) -> np.ndarray:
    """Minimal PNG reader for round-trip tests (8-bit RGB/RGBA, no
    interlace)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos = 8
    idat = b""
    w = h = c = None
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + ln]
        if tag == b"IHDR":
            w, h, depth, color_type = struct.unpack(">IIBB", body[:10])
            if depth != 8 or color_type not in (2, 6):
                raise ValueError("unsupported PNG variant")
            c = 3 if color_type == 2 else 4
        elif tag == b"IDAT":
            idat += body
        elif tag == b"IEND":
            break
        pos += 12 + ln
    raw = zlib.decompress(idat)
    stride = w * c
    out = np.empty((h, w, c), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        filt = raw[y * (stride + 1)]
        line = np.frombuffer(
            raw[y * (stride + 1) + 1 : (y + 1) * (stride + 1)], np.uint8
        ).copy()
        if filt == 0:
            pass
        elif filt == 1:  # Sub
            for i in range(c, stride):
                line[i] = (int(line[i]) + int(line[i - c])) & 0xFF
        elif filt == 2:  # Up
            line = (line.astype(np.int32) + prev).astype(np.uint8)
        elif filt == 3:  # Average
            for i in range(stride):
                left = int(line[i - c]) if i >= c else 0
                line[i] = (int(line[i]) + ((left + int(prev[i])) >> 1)) & 0xFF
        elif filt == 4:  # Paeth
            for i in range(stride):
                left = int(line[i - c]) if i >= c else 0
                up = int(prev[i])
                ul = int(prev[i - c]) if i >= c else 0
                p = left + up - ul
                pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
                pred = left if (pa <= pb and pa <= pc) else (up if pb <= pc else ul)
                line[i] = (int(line[i]) + pred) & 0xFF
        else:
            raise ValueError(f"bad filter {filt}")
        out[y] = line.reshape(w, c)
        prev = line
    return out
