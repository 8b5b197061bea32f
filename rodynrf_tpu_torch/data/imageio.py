"""Image I/O and resampling without image libraries.

The JAX package reads frames and masks with PIL, resizes them with PIL's
LANCZOS and BILINEAR filters, resizes disparity and flow with cv2 and writes
its PNGs with PIL (rodynrf_tpu/data/video_dataset.py:28-39, :69-81,
data/llff.py:84-87, eval/evaluation.py:120-124). The card's machine has
none of those libraries, so the port carries its own:

- a PNG codec on zlib + numpy: 8-bit gray, gray + alpha, RGB, RGBA and
  palette images, filters 0-4, not interlaced. Decoding is bit-identical to
  PIL's; written files decode to the input under PIL;
- PIL's antialiased resize of 8-bit images (`pil_resize`: LANCZOS and
  BILINEAR), the separable filter of Pillow's Resample.c with its 22-bit
  fixed-point coefficients and rounding, horizontal pass first;
- cv2's INTER_LINEAR (half-pixel centres, no antialias) and INTER_NEAREST
  (floor of dst·in/out) resizes of float arrays (`resize_linear`,
  `resize_nearest`).

Other formats (JPEG frames) go through PIL when it can be imported and
raise otherwise.
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np

_SIG = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # PNG colour type -> samples per pixel


# ---------------------------------------------------------------------------
# PNG
# ---------------------------------------------------------------------------

def _unfilter(raw: np.ndarray, H: int, W: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters of a decompressed image stream.

    The Average and Paeth filters read the reconstructed left, upper and
    upper-left pixels, so pixels are reconstructed one anti-diagonal of the
    image at a time (all of a diagonal's pixels depend only on earlier
    diagonals), each diagonal as one vector operation."""
    rows = raw.reshape(H, 1 + W * bpp)
    ftype = rows[:, 0].astype(np.int32)
    if np.any(ftype > 4):
        raise ValueError(f"PNG: unknown row filter {int(ftype.max())}")
    filt = rows[:, 1:].reshape(H, W, bpp).astype(np.int32)
    if np.all(ftype <= 2):  # None, Sub and Up only: row by row, vectorised
        out = np.zeros((H, W, bpp), np.uint8)
        prior = np.zeros((W, bpp), np.uint8)
        for r in range(H):
            f = filt[r].astype(np.uint8)
            if ftype[r] == 1:
                f = np.cumsum(f, axis=0, dtype=np.uint8)
            elif ftype[r] == 2:
                f = f + prior
            out[r] = prior = f
        return out
    P = np.zeros((H + 1, W + 1, bpp), np.int32)  # row/column -1 read as zero
    for d in range(H + W - 1):
        rs = np.arange(max(0, d - W + 1), min(H - 1, d) + 1)
        xs = d - rs
        a = P[rs + 1, xs]
        b = P[rs, xs + 1]
        c = P[rs, xs]
        ft = ftype[rs][:, None]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        pred = np.select([ft == 1, ft == 2, ft == 3, ft == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        P[rs + 1, xs + 1] = (filt[rs, xs] + pred) & 255
    return P[1:, 1:].astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Decode a PNG: [H, W] uint8 for gray, [H, W, C] for gray + alpha (2),
    RGB (3), RGBA (4); palette images expand to RGB or RGBA."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, plte, trns, hdr = 8, [], None, None, None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    W, H, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"{path}: PNG of bit depth {depth}, colour type {ctype}, interlace "
                         f"{interlace} is not supported (8-bit, not interlaced only)")
    bpp = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(raw[: H * (1 + W * bpp)], H, W, bpp)
    if ctype == 3:
        if plte is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        idx = img[..., 0]
        rgb = plte[idx]
        if trns is None:
            return rgb
        alpha = np.full(len(plte), 255, np.uint8)
        alpha[: len(trns)] = trns
        return np.concatenate([rgb, alpha[idx][..., None]], -1)
    return img[..., 0] if bpp == 1 else img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """Write a uint8 image ([H, W] gray, [H, W, 1|2|3|4]) as a PNG with the
    Sub filter on every row."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 images, not {img.dtype}")
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    if img.ndim == 2:
        ctype, bpp = 0, 1
    elif img.ndim == 3 and img.shape[2] in (2, 3, 4):
        bpp = img.shape[2]
        ctype = {2: 4, 3: 2, 4: 6}[bpp]
    else:
        raise ValueError(f"write_png: unsupported image shape {img.shape}")
    H, W = img.shape[:2]
    px = img.reshape(H, W, bpp)
    sub = px.copy()
    sub[:, 1:] = px[:, 1:] - px[:, :-1]  # uint8 arithmetic wraps mod 256
    raw = np.concatenate([np.ones((H, 1), np.uint8), sub.reshape(H, W * bpp)], 1)
    ihdr = struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIG + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
                + _chunk(b"IEND", b""))


def read_image_rgb(path: str) -> np.ndarray:
    """[H, W, 3] uint8, as PIL's `Image.open(path).convert("RGB")`: gray is
    repeated, alpha dropped. PNG needs no library; other formats need PIL."""
    with open(path, "rb") as f:
        is_png = f.read(8) == _SIG
    if is_png:
        img = read_png(path)
    else:
        try:
            from PIL import Image
        except ImportError as e:
            raise RuntimeError(
                f"{path}: only PNG images are read without PIL, which is not installed"
            ) from e
        return np.asarray(Image.open(path).convert("RGB"))
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, -1)
    if img.shape[2] == 2:  # gray + alpha
        return np.repeat(img[..., :1], 3, -1)
    return np.ascontiguousarray(img[..., :3])


def image_size(path: str):
    """(width, height) of an image file (the PNG header; PIL otherwise)."""
    with open(path, "rb") as f:
        head = f.read(24)
    if head[:8] == _SIG:
        return struct.unpack(">II", head[16:24])
    return read_image_rgb(path).shape[1::-1]


# ---------------------------------------------------------------------------
# PIL's antialiased resize of 8-bit images (Pillow libImaging/Resample.c)
# ---------------------------------------------------------------------------

_PRECISION_BITS = 32 - 8 - 2


def _sinc(x):
    x = np.asarray(x, np.float64)
    with np.errstate(invalid="ignore", divide="ignore"):
        y = np.sin(x * math.pi) / (x * math.pi)
    return np.where(x == 0.0, 1.0, y)


def _lanczos(x):
    return np.where((-3.0 <= x) & (x < 3.0), _sinc(x) * _sinc(x / 3.0), 0.0)


def _triangle(x):
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


_FILTERS = {"lanczos": (_lanczos, 3.0), "bilinear": (_triangle, 1.0)}


def _pil_coeffs(in_size: int, out_size: int, filt: str):
    """(first input index [out], fixed-point weights [out, ksize]) of one
    axis, as Resample.c's precompute_coeffs + normalize_coeffs_8bpc."""
    fn, support = _FILTERS[filt]
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = support * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    centers = (np.arange(out_size) + 0.5) * scale
    # C casts truncate toward zero
    xmin = np.maximum(np.trunc(centers - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(centers + support + 0.5).astype(np.int64), in_size) - xmin
    x = np.arange(ksize)[None, :]
    w = fn((x + xmin[:, None] - centers[:, None] + 0.5) / filterscale)
    w = np.where(x < xmax[:, None], w, 0.0)
    ww = w.sum(1, keepdims=True)
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    half = np.where(w < 0, -0.5, 0.5)
    kk = np.trunc(half + w * (1 << _PRECISION_BITS)).astype(np.int64)
    return xmin, kk


def _pil_pass(img: np.ndarray, out_size: int, axis: int, filt: str) -> np.ndarray:
    in_size = img.shape[axis]
    xmin, kk = _pil_coeffs(in_size, out_size, filt)
    idx = np.minimum(xmin[:, None] + np.arange(kk.shape[1])[None, :], in_size - 1)
    src = np.moveaxis(img, axis, 0).astype(np.int64)  # [in, ...]
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int64)
    for k in range(kk.shape[1]):
        wk = kk[:, k].reshape((-1,) + (1,) * (src.ndim - 1))
        acc += src[idx[:, k]] * wk
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def pil_resize(img: np.ndarray, wh, filt: str = "lanczos") -> np.ndarray:
    """PIL's `Image.resize(wh, LANCZOS | BILINEAR)` of a uint8 [H, W] or
    [H, W, C] image; an axis whose size is kept is not resampled."""
    W, H = int(wh[0]), int(wh[1])
    out = np.asarray(img, np.uint8)
    if out.shape[1] != W:
        out = _pil_pass(out, W, 1, filt)
    if out.shape[0] != H:
        out = _pil_pass(out, H, 0, filt)
    return out


# ---------------------------------------------------------------------------
# cv2's INTER_LINEAR and INTER_NEAREST of float arrays
# ---------------------------------------------------------------------------

def _linear_axis(a: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    n = a.shape[axis]
    if n == out_size:
        return a
    src = (np.arange(out_size, dtype=np.float64) + 0.5) * (n / out_size) - 0.5
    i0 = np.floor(src).astype(np.int64)
    f = src - i0
    f = np.where(i0 < 0, 0.0, f)
    i0 = np.clip(i0, 0, n - 1)
    f = np.where(i0 >= n - 1, 0.0, f)
    i1 = np.minimum(i0 + 1, n - 1)
    shape = [1] * a.ndim
    shape[axis] = out_size
    f = f.reshape(shape).astype(np.float32)
    return np.take(a, i0, axis) * (1.0 - f) + np.take(a, i1, axis) * f


def resize_linear(a: np.ndarray, wh) -> np.ndarray:
    """cv2.resize(a, wh, interpolation=cv2.INTER_LINEAR) of a float [H, W]
    or [H, W, C] array: half-pixel centres, edge-clamped, no antialias."""
    out = np.asarray(a, np.float32)
    out = _linear_axis(out, int(wh[0]), 1)
    return _linear_axis(out, int(wh[1]), 0).astype(np.float32)


def resize_nearest(a: np.ndarray, wh) -> np.ndarray:
    """cv2.resize(a, wh, interpolation=cv2.INTER_NEAREST): the source pixel
    floor(dst · in / out), clamped."""
    a = np.asarray(a)
    W, H = int(wh[0]), int(wh[1])
    # cv2 steps by 1 / (out / in), not in / out
    xs = np.minimum(np.floor(np.arange(W) * (1.0 / (W / a.shape[1]))).astype(np.int64),
                    a.shape[1] - 1)
    ys = np.minimum(np.floor(np.arange(H) * (1.0 / (H / a.shape[0]))).astype(np.int64),
                    a.shape[0] - 1)
    return a[ys][:, xs]
