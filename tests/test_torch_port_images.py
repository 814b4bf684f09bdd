"""The port's image codecs and resizes (`mcvd_tpu_torch/data/codecs.py`,
`resize.py`, the host C++ `csrc/host/{jpeg,webp,png}.cpp`) held bit for bit
against PIL (Pillow 12 with libjpeg-turbo and libwebp) and cv2 on this host,
on images made from a seed: JPEG at several qualities and samplings, grey,
optimised tables, restart markers, CMYK; PNG in every colour type and depth,
Adam7 built by hand here; BMP's three kinds both ways up; lossy WebP with
and without alpha and with libwebp's filter options; Pillow's BILINEAR
resize on drawn sizes and cv2's INTER_AREA; the PNG and GIF encoders; what
the decoders refuse; and the committed goldens `tests/golden/images.npz`
that `chip_smoke.py` holds the card machine's decoders to.

Remake the goldens on a host with PIL:  python -m tests.test_torch_port_images
"""

import ctypes
import glob
import io
import os
import struct
import zlib

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st
from PIL import Image

from mcvd_tpu_torch.data import codecs
from mcvd_tpu_torch.data.resize import resize_area, resize_bilinear

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(REPO, "tests", "golden", "images.npz")


def smooth_image(h, w, seed=0, noise=4.0):
    """Gradients, a disc and a bar, mild noise: photographs' statistics
    closely enough that the encoded sizes are realistic."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([x * 255 / max(w - 1, 1), y * 255 / max(h - 1, 1),
                    128 + 100 * np.sin((x + 2 * y) / max(h, w) * 6)], -1)
    cy, cx, r = rng.uniform(0, h), rng.uniform(0, w), rng.uniform(0.1, 0.4) * min(h, w)
    img[(y - cy) ** 2 + (x - cx) ** 2 < r * r] = rng.uniform(0, 255, 3)
    y0, x0 = rng.integers(0, max(h - 2, 1)), rng.integers(0, max(w - 2, 1))
    img[y0:y0 + max(h // 6, 1), x0:] = rng.uniform(0, 255, 3)
    return np.clip(img + rng.normal(0, noise, img.shape), 0, 255).astype(np.uint8)


def pil_rgb(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def pil_bytes(img, fmt, mode=None, **kw):
    im = Image.fromarray(img)
    if mode:
        im = im.convert(mode)
    buf = io.BytesIO()
    im.save(buf, fmt, **kw)
    return buf.getvalue()


def check(data):
    got, want = codecs.decode_image(data), pil_rgb(data)
    assert got.shape == want.shape and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------------ JPEG

JPEG_SIZES = [(1, 1), (17, 33), (218, 178)]


@pytest.mark.parametrize("subsampling", [0, 1, 2])
@pytest.mark.parametrize("quality", [50, 75, 95])
def test_jpeg_matches_pil(quality, subsampling):
    """RGB at 4:4:4 / 4:2:2 / 4:2:0, grey, optimised Huffman tables and
    restart markers, at 1x1, 17x33 and CelebA's 178x218."""
    for i, (h, w) in enumerate(JPEG_SIZES):
        img = smooth_image(h, w, seed=quality + subsampling + i)
        for kw in ({}, {"optimize": True}, {"restart_marker_blocks": 2}):
            check(pil_bytes(img, "JPEG", quality=quality, subsampling=subsampling, **kw))
        check(pil_bytes(img, "JPEG", mode="L", quality=quality))


@pytest.mark.parametrize("factor", ["440", "411", "422"])
def test_jpeg_other_samplings_match_pil(factor):
    """4:4:0 (libjpeg-turbo's h1v2 fancy upsampling) and 4:1:1 (box), cv2's
    encoder, with a restart interval of 3 MCUs."""
    import cv2

    for h, w in [(375, 500), (5, 2), (17, 33)]:
        for q in (60, 95):
            ok, enc = cv2.imencode(".jpg", smooth_image(h, w, seed=q), [
                cv2.IMWRITE_JPEG_QUALITY, q, cv2.IMWRITE_JPEG_RST_INTERVAL, 3,
                cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{factor}")])
            assert ok
            check(enc.tobytes())


def test_jpeg_cmyk_matches_pil():
    """Adobe CMYK, read inverted and turned into RGB as Pillow does."""
    for q in (75, 95):
        check(pil_bytes(smooth_image(40, 30, seed=q), "JPEG", mode="CMYK", quality=q))


def _patch(data, marker, offset, value):
    i = data.index(marker)
    return data[:i + offset] + bytes([value]) + data[i + offset + 1:]


def test_jpeg_refusals_name_the_format():
    img = smooth_image(24, 40)
    with pytest.raises(codecs.FormatError, match="progressive"):
        codecs.decode_image(pil_bytes(img, "JPEG", progressive=True))
    base = pil_bytes(img, "JPEG", quality=80)
    with pytest.raises(codecs.FormatError, match="arithmetic"):
        codecs.decode_image(_patch(base, b"\xff\xc0", 1, 0xC9))
    with pytest.raises(codecs.FormatError, match="lossless"):
        codecs.decode_image(_patch(base, b"\xff\xc0", 1, 0xC3))
    with pytest.raises(codecs.FormatError, match="8-bit"):
        codecs.decode_image(_patch(base, b"\xff\xc0", 4, 12))
    with pytest.raises(codecs.FormatError, match="truncated"):
        codecs.decode_image(base[:40])


# ------------------------------------------------------------------ PNG

def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _pack(samples, depth):
    """(h, w, ch) samples -> list of raw row bytes at `depth`."""
    rows = []
    for row in samples:
        flat = row.reshape(-1).astype(np.uint32)
        if depth == 16:
            rows.append(flat.astype(">u2").tobytes())
        elif depth == 8:
            rows.append(flat.astype(np.uint8).tobytes())
        else:
            bits = ((flat[:, None] >> np.arange(depth - 1, -1, -1)) & 1).astype(np.uint8)
            rows.append(np.packbits(bits.reshape(-1)).tobytes())
    return rows


def _filter(rows, bpp, rng):
    out, prev = [], bytes(len(rows[0]))
    for row in rows:
        ft = int(rng.integers(0, 5))
        f = bytearray([ft])
        for i, x in enumerate(row):
            a = row[i - bpp] if i >= bpp else 0
            b, c = prev[i], (prev[i - bpp] if i >= bpp else 0)
            pred = [0, a, b, (a + b) >> 1, _paeth(a, b, c)][ft]
            f.append((x - pred) & 0xFF)
        out.append(bytes(f))
        prev = row
    return b"".join(out)


def png_bytes(samples, color, depth, interlace=0, palette=None, seed=0):
    """A PNG written here, not by PIL: every row's filter drawn at random,
    Adam7 passes cut and filtered one by one."""
    rng = np.random.default_rng(seed)
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    if interlace:
        raw = b"".join(_filter(_pack(samples[y0::dy, x0::dx], depth), bpp, rng)
                       for x0, y0, dx, dy in codecs._ADAM7
                       if samples[y0::dy, x0::dx].size)
    else:
        raw = _filter(_pack(samples, depth), bpp, rng)

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + \
            struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)

    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color,
                                                              0, 0, interlace))
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    return out + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b"")


PNG_KINDS = [(c, d) for c, ds in codecs._PNG_DEPTHS.items() for d in ds]


def png_case(color, depth, h, w, interlace, seed):
    rng = np.random.default_rng(seed)
    ch = codecs._PNG_CHANNELS[color]
    top = (1 << depth) if color != 3 else min(1 << depth, 200)
    samples = rng.integers(0, top, (h, w, ch))
    palette = rng.integers(0, 256, (200 if depth == 8 else 1 << depth, 3)) if color == 3 \
        else None
    return png_bytes(samples, color, depth, interlace, palette, seed)


@pytest.mark.parametrize("color,depth", PNG_KINDS)
def test_png_matches_pil(color, depth):
    """Every colour type and depth, plain and Adam7, at sizes that leave
    Adam7 passes empty (1x1, 3x2) and not (33x17)."""
    for i, (h, w) in enumerate([(1, 1), (3, 2), (33, 17)]):
        for interlace in (0, 1):
            check(png_case(color, depth, h, w, interlace, seed=10 * i + interlace + depth))


def test_png_from_pil_modes_match():
    """PNGs that PIL writes: 1, L, LA, RGB, RGBA, I;16, P at 1-8 bits with
    transparency; cv2's 16-bit RGB and RGBA."""
    import cv2

    rng = np.random.default_rng(3)
    rgba = rng.integers(0, 256, (23, 37, 4), np.uint8)
    for mode in ("1", "L", "LA", "RGB", "RGBA", "P"):
        check(pil_bytes(rgba, "PNG", mode=mode))
    check(pil_bytes(rng.integers(0, 65536, (9, 11), np.uint16), "PNG"))
    for bits in (1, 2, 4, 8):
        im = Image.fromarray(rng.integers(0, 1 << bits, (19, 21), np.uint8), "P")
        im.putpalette(rng.integers(0, 256, 3 << bits).tolist())
        buf = io.BytesIO()
        im.save(buf, "PNG", bits=bits, transparency=0)
        check(buf.getvalue())
    for ch in (3, 4):
        check(cv2.imencode(".png", rng.integers(0, 65536, (11, 9, ch), np.uint16))[1].tobytes())


def test_png_refusals():
    good = png_case(2, 8, 5, 5, 0, 0)
    with pytest.raises(codecs.FormatError, match="CRC"):
        codecs.decode_image(good[:20] + bytes([good[20] ^ 1]) + good[21:])
    with pytest.raises(codecs.FormatError, match="filter"):
        codecs.unfilter(np.array([7, 1, 2, 3], np.uint8), 1, 3, 3)
    with pytest.raises(codecs.FormatError, match="colour type 1"):
        codecs.decode_image(good[:25] + b"\x01" + good[26:29] + struct.pack(
            ">I", zlib.crc32(good[12:25] + b"\x01" + good[26:29]) & 0xFFFFFFFF) + good[33:])


# ------------------------------------------------------------------ BMP

def _top_down(data):
    """Pillow's bottom-up BMP rewritten top-down (negative height)."""
    off, = struct.unpack_from("<I", data, 10)
    w, h, _, bits = struct.unpack_from("<iiHH", data, 18)
    stride = ((w * bits + 31) // 32) * 4
    rows = [data[off + i * stride:off + (i + 1) * stride] for i in range(h)]
    return data[:22] + struct.pack("<i", -h) + data[26:off] + b"".join(rows[::-1])


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "P", "L", "1"])
def test_bmp_matches_pil(mode):
    """24-bit (RGB), 32-bit (RGBA), 8-bit palette (P, L) and 1-bit, bottom-up
    as PIL writes them and top-down."""
    for h, w in [(1, 1), (13, 15), (7, 33)]:
        data = pil_bytes(smooth_image(h, w, seed=w), "BMP", mode=mode)
        check(data)
        down = _top_down(data)
        np.testing.assert_array_equal(codecs.decode_image(down), pil_rgb(data))


# ------------------------------------------------------------------ WebP

def _libwebp():
    """libwebp's encoder, from PIL's own copy, for the options PIL does not
    pass on (filter type, sharpness, partitions, segments)."""
    import PIL

    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)), "pillow.libs")
    found = sorted(glob.glob(os.path.join(libs, "libwebp-*.so*")))
    if not found:
        pytest.skip("PIL's bundled libwebp is not on this host")
    for dep in glob.glob(os.path.join(libs, "libsharpyuv-*.so*")):
        ctypes.CDLL(dep, mode=ctypes.RTLD_GLOBAL)
    lib = ctypes.CDLL(found[0])
    vp = ctypes.c_void_p
    lib.WebPConfigInitInternal.argtypes = [vp, ctypes.c_int, ctypes.c_float, ctypes.c_int]
    lib.WebPPictureInitInternal.argtypes = [vp, ctypes.c_int]
    lib.WebPPictureImportRGB.argtypes = [vp, vp, ctypes.c_int]
    lib.WebPEncode.argtypes = [vp, vp]
    for f in (lib.WebPMemoryWriterInit, lib.WebPMemoryWriterClear, lib.WebPPictureFree):
        f.argtypes = [vp]
    return lib


class _Writer(ctypes.Structure):
    _fields_ = [("mem", ctypes.c_void_p), ("size", ctypes.c_size_t),
                ("max_size", ctypes.c_size_t), ("pad", ctypes.c_uint32 * 1)]


class _Picture(ctypes.Structure):   # libwebp's WebPPicture (encode.h)
    _fields_ = [("use_argb", ctypes.c_int), ("colorspace", ctypes.c_int),
                ("width", ctypes.c_int), ("height", ctypes.c_int), ("y", ctypes.c_void_p),
                ("u", ctypes.c_void_p), ("v", ctypes.c_void_p), ("y_stride", ctypes.c_int),
                ("uv_stride", ctypes.c_int), ("a", ctypes.c_void_p), ("a_stride", ctypes.c_int),
                ("pad1", ctypes.c_uint32 * 2), ("argb", ctypes.c_void_p),
                ("argb_stride", ctypes.c_int), ("pad2", ctypes.c_uint32 * 3),
                ("writer", ctypes.c_void_p), ("custom_ptr", ctypes.c_void_p),
                ("extra_info_type", ctypes.c_int), ("extra_info", ctypes.c_void_p),
                ("stats", ctypes.c_void_p), ("error_code", ctypes.c_int),
                ("progress_hook", ctypes.c_void_p), ("user_data", ctypes.c_void_p),
                ("pad3", ctypes.c_uint32 * 3), ("pad4", ctypes.c_void_p),
                ("pad5", ctypes.c_void_p), ("pad6", ctypes.c_uint32 * 8),
                ("memory_", ctypes.c_void_p), ("memory_argb_", ctypes.c_void_p),
                ("pad7", ctypes.c_void_p * 2)]


# WebPConfig's leading fields, each 4 bytes (encode.h)
_CONFIG = ["lossless", "quality", "method", "image_hint", "target_size", "target_PSNR",
           "segments", "sns_strength", "filter_strength", "filter_sharpness", "filter_type",
           "autofilter", "alpha_compression", "alpha_filtering", "alpha_quality", "pass",
           "show_compressed", "preprocessing", "partitions"]
_ABI = 0x0210


def libwebp_encode(rgb, quality=75, **options):
    lib = _libwebp()
    cfg = (ctypes.c_int32 * 64)()
    assert lib.WebPConfigInitInternal(cfg, 0, ctypes.c_float(quality), _ABI)
    for k, v in options.items():
        cfg[_CONFIG.index(k)] = v
    pic = _Picture()
    assert lib.WebPPictureInitInternal(ctypes.byref(pic), _ABI)
    rgb = np.ascontiguousarray(rgb)
    pic.height, pic.width = rgb.shape[:2]
    assert lib.WebPPictureImportRGB(ctypes.byref(pic), rgb.ctypes.data, rgb.shape[1] * 3)
    wr = _Writer()
    lib.WebPMemoryWriterInit(ctypes.byref(wr))
    pic.writer = ctypes.cast(lib.WebPMemoryWrite, ctypes.c_void_p).value
    pic.custom_ptr = ctypes.addressof(wr)
    ok = lib.WebPEncode(cfg, ctypes.byref(pic))
    out = ctypes.string_at(wr.mem, wr.size)
    lib.WebPPictureFree(ctypes.byref(pic))
    lib.WebPMemoryWriterClear(ctypes.byref(wr))
    assert ok, pic.error_code
    return out


@pytest.mark.parametrize("quality", [10, 30, 50, 75, 90, 100])
def test_webp_matches_pil(quality):
    """PIL's lossy WebP, with and without alpha, at sizes that are and are
    not multiples of 16, smooth and noisy."""
    rng = np.random.default_rng(quality)
    for h, w in [(1, 1), (17, 33), (96, 128), (73, 100)]:
        for noise in (4.0, 60.0):
            img = smooth_image(h, w, seed=quality + h, noise=noise)
            check(pil_bytes(img, "WEBP", quality=quality))
            rgba = np.dstack([img, rng.integers(0, 256, (h, w), np.uint8)])
            check(pil_bytes(rgba, "WEBP", quality=quality))


@pytest.mark.parametrize("options", [
    {"filter_type": 0, "filter_strength": 60},
    {"filter_type": 0, "filter_strength": 100, "filter_sharpness": 5},
    {"filter_type": 1, "filter_strength": 100, "filter_sharpness": 7},
    {"partitions": 3}, {"segments": 1}, {"segments": 2, "sns_strength": 100},
    {"filter_strength": 0}, {"autofilter": 1, "method": 6}], ids=str)
def test_webp_libwebp_options_match_pil(options):
    """Both loop filters (simple and normal) at several sharpnesses, 8 token
    partitions, 1 and 2 segments, no filter."""
    for i, (h, w) in enumerate([(17, 33), (64, 64), (50, 90)]):
        for q in (5, 40, 90):
            check(libwebp_encode(smooth_image(h, w, seed=q + i, noise=20.0), q, **options))


def test_webp_refusals_name_the_format():
    img = smooth_image(20, 20)
    with pytest.raises(codecs.FormatError, match="lossless"):
        codecs.decode_image(pil_bytes(img, "WEBP", lossless=True))
    frames = [Image.fromarray(img), Image.fromarray(img[::-1])]
    buf = io.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:], duration=100)
    with pytest.raises(codecs.FormatError, match="animated"):
        codecs.decode_image(buf.getvalue())
    with pytest.raises(codecs.FormatError, match="GIF"):
        codecs.decode_image(pil_bytes(img, "GIF"))
    with pytest.raises(codecs.FormatError, match="not an image"):
        codecs.decode_image(b"\x00" * 64)


# ------------------------------------------------------------------ resizes

@settings(max_examples=80, deadline=None)
@given(st.integers(1, 260), st.integers(1, 260), st.integers(1, 260), st.integers(1, 260),
       st.integers(0, 2 ** 31 - 1))
def test_resize_bilinear_matches_pillow(h, w, oh, ow, seed):
    img = np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)
    want = np.asarray(Image.fromarray(img).resize((ow, oh), Image.BILINEAR))
    np.testing.assert_array_equal(resize_bilinear(img, (ow, oh)), want)


@pytest.mark.parametrize("factor", [1, 2, 3, 4, 8])
def test_resize_area_matches_cv2(factor):
    import cv2

    rng = np.random.default_rng(factor)
    for shape in [(16 * factor, 24 * factor, 3), (8 * factor, 8 * factor)]:
        img = rng.integers(0, 256, shape, np.uint8)
        want = cv2.resize(img, (shape[1] // factor, shape[0] // factor),
                          interpolation=cv2.INTER_AREA)
        np.testing.assert_array_equal(resize_area(img, (shape[1] // factor,
                                                        shape[0] // factor)), want)
    with pytest.raises(ValueError, match="integer factor"):
        resize_area(np.zeros((10, 10, 3), np.uint8), (3, 3))


# ------------------------------------------------------------------ encoders

def test_encode_png_and_gif_read_back_by_pil():
    rng = np.random.default_rng(5)
    for img in (rng.integers(0, 256, (30, 41, 3), np.uint8),
                rng.integers(0, 256, (7, 9), np.uint8)):
        data = codecs.encode_png(img)
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data))), img)
        np.testing.assert_array_equal(codecs.decode_image(data)[..., 0],
                                      img if img.ndim == 2 else img[..., 0])
    # a frame of 70,000 pixels fills the LZW table past 4,096 codes
    frames = [rng.integers(0, 256, (128, 550, 3), np.uint8) for _ in range(3)]
    gif = Image.open(io.BytesIO(codecs.encode_gif(frames, duration_ms=250)))
    assert gif.n_frames == 3 and gif.info["duration"] == 250 and gif.info["loop"] == 0
    step = np.asarray(codecs.GIF_STEP) / 2
    for i, f in enumerate(frames):
        gif.seek(i)
        err = np.abs(np.asarray(gif.convert("RGB")).astype(float) - f).max(axis=(0, 1))
        assert (err <= step + 0.5).all(), err


# ------------------------------------------------------------------ goldens

def golden_images():
    """name -> encoded bytes: one image at each dataset's real size (CelebA's
    178x218 JPEG, an LSUN WebP of 341x256, a 500x375 ImageNet JPEG) and small
    ones for every codec and mode the tests above cover."""
    import cv2

    out = {"celeba": pil_bytes(smooth_image(218, 178, 1), "JPEG", quality=90),
           "lsun": pil_bytes(smooth_image(256, 341, 2), "WEBP", quality=75),
           "imagenet": pil_bytes(smooth_image(375, 500, 3), "JPEG", quality=90)}
    small = smooth_image(17, 33, 4)
    for q in (50, 75, 95):
        for ss in (0, 1, 2):
            out[f"jpeg_q{q}_ss{ss}"] = pil_bytes(small, "JPEG", quality=q, subsampling=ss)
    out["jpeg_grey"] = pil_bytes(small, "JPEG", mode="L")
    out["jpeg_optimize_restart"] = pil_bytes(small, "JPEG", optimize=True,
                                             restart_marker_blocks=1)
    out["jpeg_cmyk"] = pil_bytes(small, "JPEG", mode="CMYK")
    for f in ("440", "411"):
        out[f"jpeg_{f}"] = cv2.imencode(".jpg", smooth_image(33, 17, 5), [
            cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
            getattr(cv2, f"IMWRITE_JPEG_SAMPLING_FACTOR_{f}")])[1].tobytes()
    for c, d in PNG_KINDS:
        out[f"png_c{c}_d{d}"] = png_case(c, d, 9, 13, 0, seed=c + d)
    out["png_adam7"] = png_case(6, 8, 9, 13, 1, seed=1)
    for mode in ("RGB", "RGBA", "P"):
        out[f"bmp_{mode}"] = pil_bytes(small, "BMP", mode=mode)
    out["bmp_topdown"] = _top_down(out["bmp_RGB"])
    out["webp_alpha"] = pil_bytes(np.dstack([small, small[..., 0]]), "WEBP", quality=50)
    out["webp_q100"] = pil_bytes(small, "WEBP", quality=100)
    out["webp_simple"] = libwebp_encode(smooth_image(40, 50, 6), 60, filter_type=0)
    out["webp_partitions"] = libwebp_encode(smooth_image(40, 50, 7), 30, partitions=3,
                                            filter_sharpness=4)
    return out


# (name, dataset transform, size): PIL's resizes at the datasets' sizes
GOLDEN_RESIZES = [("celeba", "crop140", 64), ("lsun", "short", 64), ("lsun", "short", 128),
                  ("imagenet", "short", 64)]


def pil_dataset_resize(rgb, kind, size):
    """The JAX package's dataset transforms, in PIL."""
    if kind == "crop140":
        h, w = rgb.shape[:2]
        top, left = (h - 140) // 2, (w - 140) // 2
        return np.asarray(Image.fromarray(rgb[top:top + 140, left:left + 140]).resize(
            (size, size), Image.BILINEAR))
    img = Image.fromarray(rgb)
    w, h = img.size
    scale = size / min(w, h)
    arr = np.asarray(img.resize((max(size, round(w * scale)), max(size, round(h * scale))),
                                Image.BILINEAR))
    top, left = (arr.shape[0] - size) // 2, (arr.shape[1] - size) // 2
    return arr[top:top + size, left:left + size]


def port_dataset_resize(rgb, kind, size):
    """The port's dataset transforms (what `chip_smoke.py` runs)."""
    from mcvd_tpu_torch.data import image_datasets

    if kind == "crop140":
        return resize_bilinear(image_datasets._center_crop(rgb, 140), (size, size))
    return image_datasets._resize_short_side_crop(rgb, size)


def make_goldens():
    arrays = {}
    for name, data in golden_images().items():
        arrays[f"enc:{name}"] = np.frombuffer(data, np.uint8)
        arrays[f"dec:{name}"] = pil_rgb(data)
    for name, kind, size in GOLDEN_RESIZES:
        arrays[f"rsz:{name}:{kind}:{size}"] = pil_dataset_resize(arrays[f"dec:{name}"], kind,
                                                                 size)
    return arrays


def test_goldens_match_pil_and_the_port():
    """The committed goldens are what PIL gives on this host, and the port
    decodes and resizes them to the same arrays (what `chip_smoke.py` then
    checks on the card machine)."""
    with np.load(GOLDEN) as z:
        stored = {k: z[k] for k in z.files}
    assert os.path.getsize(GOLDEN) < 1 << 20
    for key, arr in stored.items():
        kind, name = key.split(":", 1)
        if kind == "dec":
            data = stored[f"enc:{name}"].tobytes()
            np.testing.assert_array_equal(pil_rgb(data), arr, err_msg=name)
            np.testing.assert_array_equal(codecs.decode_image(data), arr, err_msg=name)
    for name, kind, size in GOLDEN_RESIZES:
        want = stored[f"rsz:{name}:{kind}:{size}"]
        np.testing.assert_array_equal(pil_dataset_resize(stored[f"dec:{name}"], kind, size),
                                      want)
        np.testing.assert_array_equal(port_dataset_resize(stored[f"dec:{name}"], kind, size),
                                      want)
    assert {"enc:celeba", "enc:lsun", "enc:imagenet"} <= set(stored)
    assert stored["dec:celeba"].shape == (218, 178, 3)
    assert stored["dec:imagenet"].shape == (375, 500, 3)


if __name__ == "__main__":
    arrays = make_goldens()
    os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
    np.savez_compressed(GOLDEN, **arrays)
    print(GOLDEN, os.path.getsize(GOLDEN), "bytes,", len(arrays), "arrays")
