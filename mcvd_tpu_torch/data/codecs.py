"""Image codecs without PIL: `decode_image` gives what
`np.asarray(Image.open(BytesIO(data)).convert("RGB"))` gives, bit for bit,
for the formats the image datasets store, and `encode_png` / `encode_gif`
write the sample grids.

Decoded here:

- JPEG: baseline and extended-sequential Huffman, 8-bit, grey, YCbCr at any
  integer sampling (4:4:4, 4:2:2, 4:4:0, 4:2:0, 4:1:1), RGB, Adobe CMYK,
  restart intervals; host C++ (`csrc/host/jpeg.cpp`) that follows
  libjpeg-turbo's islow IDCT, fancy upsampling and colour tables. Adobe
  YCCK is converted by jdcolor.c's formula, but no encoder at hand writes
  one, so it is not held against PIL.
- WebP: lossy (a VP8 key frame, alpha dropped); host C++
  (`csrc/host/webp.cpp`) that follows libwebp's decoder and RGB output.
- PNG: every colour type and depth, Adam7; chunks and inflate (stdlib zlib)
  here, the scanline filters undone in host C++ (`csrc/host/png.cpp`: Sub,
  Average and Paeth chain along a row), then Pillow's rules for RGB: grey
  and grey+alpha replicate the grey value (1-bit as 0/255, 2- and 4-bit
  scaled by 85 and 17, 16-bit clipped to 255 as Pillow's I;16 is), 16-bit
  colour keeps its high byte, alpha is dropped without compositing, a
  palette is applied.
- BMP: 1-, 4- and 8-bit palettes, 24-bit, 32-bit (BI_RGB, or BI_BITFIELDS
  with byte-aligned masks), bottom-up or top-down.

Anything else raises `FormatError` naming what it is: progressive,
arithmetic-coded, lossless or 12-bit JPEG, lossless (VP8L) or animated
WebP, GIF, and unknown bytes. Nothing falls back to another decoder; without
g++ the host library does not build and the JPEG, WebP and PNG paths raise.
ctypes releases the GIL for each call, so loader threads decode in parallel.
"""

from __future__ import annotations

import struct
import zlib
from typing import Sequence

import numpy as np

from . import native


class FormatError(ValueError):
    """An image the port does not decode; the message names the format."""


_JPEG_ERRORS = {-1: "a corrupt or truncated JPEG", -2: "a progressive JPEG",
                -3: "an arithmetic-coded JPEG", -4: "a JPEG of other than 8-bit precision",
                -5: "a lossless JPEG", -6: "a JPEG whose sampling factors are not integer ratios",
                -7: "a JPEG of 2 or more than 4 components", -8: "a JPEG too large to decode",
                -9: "a JPEG with no frame header"}
_WEBP_ERRORS = {-1: "a corrupt or truncated WebP", -2: "a lossless (VP8L) WebP",
                -3: "an animated WebP", -4: "a WebP whose VP8 frame is not a key frame"}


def image_format(data: bytes) -> str:
    """'jpeg', 'png', 'bmp', 'webp', 'gif' or 'unknown', from the magic bytes."""
    if data[:3] == b"\xff\xd8\xff":
        return "jpeg"
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return "png"
    if data[:2] == b"BM":
        return "bmp"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "webp"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "gif"
    return "unknown"


def decode_image(data: bytes) -> np.ndarray:
    """(H, W, 3) uint8 RGB of an encoded image, as PIL's convert("RGB")."""
    data = bytes(data)
    fmt = image_format(data)
    if fmt == "jpeg":
        return _decode_native(data, "jpeg", 3, _JPEG_ERRORS)
    if fmt == "webp":
        return _decode_native(data, "webp", 2, _WEBP_ERRORS)
    if fmt == "png":
        return decode_png(data)
    if fmt == "bmp":
        return decode_bmp(data)
    if fmt == "gif":
        raise FormatError("a GIF: the port decodes JPEG, PNG, BMP and lossy WebP")
    raise FormatError(f"not an image the port decodes (starts {data[:12]!r})")


def _decode_native(data: bytes, name: str, ninfo: int, errors) -> np.ndarray:
    lib = native.load_library()
    src = np.frombuffer(data, np.uint8)
    info = np.zeros(ninfo, np.int32)
    e = getattr(lib, f"{name}_info")(src.ctypes.data, src.size, info.ctypes.data)
    if e:
        raise FormatError(errors.get(e, f"{name} error {e}"))
    w, h = int(info[0]), int(info[1])
    out = np.empty((h, w, 3), np.uint8)
    e = getattr(lib, f"{name}_decode")(src.ctypes.data, src.size, out.ctypes.data, out.size)
    if e:
        raise FormatError(errors.get(e, f"{name} error {e}"))
    return out


# ------------------------------------------------------------------ PNG

_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))   # (x0, y0, dx, dy)
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


def unfilter(raw: np.ndarray, rows: int, row_bytes: int, bpp: int) -> np.ndarray:
    """PNG's scanline filters undone: `raw` holds `rows` rows of a filter
    byte and `row_bytes` bytes; returns (rows, row_bytes) uint8."""
    out = np.empty((rows, row_bytes), np.uint8)
    if rows == 0 or row_bytes == 0:
        return out
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size < rows * (row_bytes + 1):
        raise FormatError("a truncated PNG (the image data ends early)")
    e = native.load_library().png_unfilter(raw.ctypes.data, out.ctypes.data, rows, row_bytes,
                                           bpp)
    if e:
        raise FormatError("a corrupt PNG (a scanline filter type past 4)")
    return out


def _unpack(rows: np.ndarray, width: int, channels: int, depth: int) -> np.ndarray:
    """(h, row_bytes) unfiltered bytes -> (h, width, channels) samples."""
    h = rows.shape[0]
    if depth == 8:
        return rows[:, :width * channels].reshape(h, width, channels)
    if depth == 16:
        v = rows[:, :width * channels * 2].reshape(h, width * channels, 2).astype(np.uint16)
        return ((v[..., 0] << 8) | v[..., 1]).reshape(h, width, channels)
    bits = np.unpackbits(rows, axis=1)[:, :width * depth].reshape(h, width, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)[..., None]


def decode_png(data: bytes) -> np.ndarray:
    pos, idat, plte, hdr = 8, [], None, None
    while pos + 8 <= len(data):
        n, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if len(body) < n or pos + 12 + n > len(data):
            raise FormatError("a truncated PNG")
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(ctype + body) & 0xFFFFFFFF != crc:
            raise FormatError(f"a corrupt PNG (bad CRC in {ctype!r})")
        pos += 12 + n
        if ctype == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if hdr is None or not idat:
        raise FormatError("a corrupt PNG (no IHDR or no IDAT)")
    width, height, depth, color, comp, filt, interlace = hdr
    if color not in _PNG_CHANNELS or depth not in _PNG_DEPTHS[color] or comp or filt \
            or interlace > 1 or width == 0 or height == 0:
        raise FormatError(f"a PNG of colour type {color}, depth {depth}, interlace {interlace}")
    if color == 3 and plte is None:
        raise FormatError("a corrupt PNG (palette image without PLTE)")
    try:
        raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    except zlib.error as err:
        raise FormatError(f"a corrupt PNG (inflate: {err})") from None
    ch = _PNG_CHANNELS[color]
    bpp = max(1, ch * depth // 8)
    dtype = np.uint16 if depth == 16 else np.uint8
    if not interlace:
        rb = (width * ch * depth + 7) // 8
        img = _unpack(unfilter(raw, height, rb, bpp), width, ch, depth)
    else:
        img = np.zeros((height, width, ch), dtype)
        off = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = (width - x0 + dx - 1) // dx, (height - y0 + dy - 1) // dy
            if pw <= 0 or ph <= 0:
                continue
            rb = (pw * ch * depth + 7) // 8
            n = ph * (rb + 1)
            img[y0::dy, x0::dx] = _unpack(unfilter(raw[off:off + n], ph, rb, bpp), pw, ch,
                                          depth)
            off += n
    return _png_to_rgb(img, color, depth, plte)


def _png_to_rgb(img: np.ndarray, color: int, depth: int, plte) -> np.ndarray:
    if color == 3:
        pal = np.zeros((256, 3), np.uint8)
        pal[:len(plte)] = plte[:256]
        return pal[img[..., 0]]
    if depth == 16:
        if color == 0:   # Pillow's I;16 -> RGB clips at 255
            return np.repeat(np.minimum(img, 255).astype(np.uint8), 3, axis=-1)
        img = (img >> 8).astype(np.uint8)
    elif depth < 8:      # grey at 1, 2, 4 bits: Pillow's "1", "L;2", "L;4"
        img = (img * (255 // ((1 << depth) - 1))).astype(np.uint8)
    if color in (0, 4):
        return np.repeat(img[..., :1], 3, axis=-1)
    return np.ascontiguousarray(img[..., :3])


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """An 8-bit RGB ((H, W, 3)) or grey ((H, W) or (H, W, 1)) uint8 image as
    PNG bytes: filter None on every row, stdlib zlib."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"encode_png takes uint8, got {img.dtype}")
    if img.ndim == 3 and img.shape[-1] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        color, ch = 0, 1
    elif img.ndim == 3 and img.shape[-1] == 3:
        color, ch = 2, 3
    else:
        raise ValueError(f"encode_png takes (H, W), (H, W, 1) or (H, W, 3), got {img.shape}")
    h, w = img.shape[:2]
    rows = np.zeros((h, w * ch + 1), np.uint8)
    rows[:, 1:] = img.reshape(h, w * ch)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return struct.pack(">I", len(body)) + kind + body + \
            struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + chunk(b"IEND", b""))


# ------------------------------------------------------------------ BMP

def decode_bmp(data: bytes) -> np.ndarray:
    if len(data) < 26:
        raise FormatError("a truncated BMP")
    (offset,) = struct.unpack_from("<I", data, 10)
    (hsize,) = struct.unpack_from("<I", data, 14)
    if hsize == 12:
        w, h, _planes, bits = struct.unpack_from("<HHHH", data, 18)
        compression, n_colors, pal_entry = 0, 0, 3
    elif hsize >= 40:
        w, h, _planes, bits, compression = struct.unpack_from("<iiHHI", data, 18)
        (n_colors,) = struct.unpack_from("<I", data, 46)
        pal_entry = 4
    else:
        raise FormatError(f"a BMP with a {hsize}-byte header")
    top_down = h < 0
    h = abs(h)
    if w <= 0 or h == 0:
        raise FormatError("a corrupt BMP (empty)")
    masks = None
    if compression == 3 and bits == 32:   # BI_BITFIELDS
        masks = struct.unpack_from("<III", data, 14 + 40)   # after, or inside, the header
    elif compression != 0:
        raise FormatError(f"a BMP with compression {compression} (RLE or other)")
    if bits not in (1, 4, 8, 24, 32):
        raise FormatError(f"a {bits}-bit BMP")
    stride = ((w * bits + 31) // 32) * 4
    pix = np.frombuffer(data, np.uint8, count=stride * h, offset=offset)
    rows = pix.reshape(h, stride)
    if not top_down:
        rows = rows[::-1]
    if bits <= 8:
        n = n_colors or (1 << bits)
        pal = np.frombuffer(data, np.uint8, count=n * pal_entry, offset=14 + hsize)
        pal = pal.reshape(n, pal_entry)
        table = np.zeros((256, 3), np.uint8)
        table[:n] = pal[:256, 2::-1]
        idx = rows[:, :w] if bits == 8 else _unpack(np.ascontiguousarray(rows), w, 1, bits)[..., 0]
        return table[idx]
    if bits == 24:
        return np.ascontiguousarray(rows[:, :w * 3].reshape(h, w, 3)[..., ::-1])
    px = rows[:, :w * 4].reshape(h, w, 4)
    if masks is None:
        return np.ascontiguousarray(px[..., 2::-1])
    out = np.empty((h, w, 3), np.uint8)
    for c, m in enumerate(masks):
        if m not in (0xFF, 0xFF00, 0xFF0000, 0xFF000000):
            raise FormatError(f"a 32-bit BMP with bit mask {m:#x}")
        out[..., c] = px[..., (m.bit_length() - 1) // 8]
    return out


# ------------------------------------------------------------------ GIF

def gif_palette() -> np.ndarray:
    """The GIF encoder's 256 colours: 6 levels of red, 7 of green, 6 of
    blue (252 entries), then black."""
    r, g, b = np.meshgrid(np.arange(6), np.arange(7), np.arange(6), indexing="ij")
    pal = np.stack([r * 51, np.round(g * 255 / 6), b * 51], -1).reshape(-1, 3)
    return np.concatenate([pal, np.zeros((4, 3))]).astype(np.uint8)


GIF_STEP = (51.0, 255 / 6, 51.0)   # the palette's step in each channel


def _gif_indices(frame: np.ndarray) -> np.ndarray:
    f = frame.astype(np.int32)
    r = (f[..., 0] * 5 + 127) // 255
    g = (f[..., 1] * 6 + 127) // 255
    b = (f[..., 2] * 5 + 127) // 255
    return ((r * 7 + g) * 6 + b).astype(np.uint8)


def _lzw(indices: bytes, min_size: int = 8) -> bytes:
    clear, eoi = 1 << min_size, (1 << min_size) + 1
    out = bytearray()
    acc = nacc = 0
    size = min_size + 1
    table = {}
    nxt = eoi + 1

    def emit(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += size
        while nacc >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nacc -= 8

    emit(clear)
    prefix = indices[0]
    for c in indices[1:]:
        key = (prefix << 8) | c
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        if nxt < 4096:
            table[key] = nxt
            nxt += 1
            if nxt > (1 << size) and size < 12:
                size += 1
        else:
            emit(clear)
            table.clear()
            nxt, size = eoi + 1, min_size + 1
        prefix = c
    emit(prefix)
    emit(eoi)
    if nacc:
        out.append(acc & 0xFF)
    return bytes(out)


def encode_gif(frames: Sequence[np.ndarray], duration_ms: int, loop: int = 0) -> bytes:
    """An animated GIF of (H, W, 3) uint8 frames of one size, each shown
    `duration_ms` (stored in hundredths of a second), looping `loop` times
    (0: forever), on `gif_palette()`'s colours (the nearest in each channel)."""
    frames = [np.asarray(f) for f in frames]
    h, w = frames[0].shape[:2]
    pal = gif_palette()
    out = [b"GIF89a", struct.pack("<HHBBB", w, h, 0xF7, 0, 0), pal.tobytes(),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01" + struct.pack("<H", loop) + b"\x00"]
    delay = int(round(duration_ms / 10))
    for f in frames:
        if f.shape[:2] != (h, w):
            raise ValueError("encode_gif: frames differ in size")
        out.append(b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00")
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, w, h, 0) + b"\x08")
        data = _lzw(_gif_indices(f).tobytes())
        for i in range(0, len(data), 255):
            block = data[i:i + 255]
            out.append(bytes([len(block)]) + block)
        out.append(b"\x00")
    out.append(b"\x3b")
    return b"".join(out)
