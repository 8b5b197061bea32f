"""Image I/O and resampling without image libraries.

The JAX package reads frames and masks with PIL, resizes them with PIL's
LANCZOS and BILINEAR filters, resizes disparity and flow with cv2 and writes
its PNGs with PIL (rodynrf_tpu/data/video_dataset.py:28-39, :69-81,
data/llff.py:84-87, eval/evaluation.py:120-124). The card's machine has
none of those libraries, so the port carries its own:

- a PNG codec on zlib + numpy: 8-bit gray, gray + alpha, RGB, RGBA and
  palette images, filters 0-4, not interlaced. Decoding is bit-identical to
  PIL's; written files decode to the input under PIL. 16-bit images (the
  depth preprocessing writes 16-bit gray, as cv2.imwrite of a uint16 array
  does) are read and written as uint16 arrays;
- PIL's antialiased resize of 8-bit images (`pil_resize`: LANCZOS and
  BILINEAR), the separable filter of Pillow's Resample.c with its 22-bit
  fixed-point coefficients and rounding, horizontal pass first;
- cv2's INTER_LINEAR (half-pixel centres, no antialias) and INTER_NEAREST
  (floor of dst·in/out) resizes of float arrays (`resize_linear`,
  `resize_nearest`);
- on torch tensors, so that the preprocessing runs them on the card:
  cv2's INTER_AREA and INTER_CUBIC resizes of float images (`resize_area`,
  `resize_cubic`) and its `remap` with INTER_CUBIC and BORDER_CONSTANT 0
  (`remap_cubic`), with cv2's coefficients and edge rules.

Baseline JPEG frames (DAVIS ships its frames as JPEG) decode through
data/jpeg.py, bit for bit as PIL's, as hand-written kernels on the card or
their plain versions on the CPU (`read_frames` decodes a list of frames as
one batch). Other formats raise, naming the file.
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np
import torch

from ..device import check_device

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
    """Decode a PNG: [H, W] for gray, [H, W, C] for gray + alpha (2), RGB
    (3), RGBA (4); palette images expand to RGB or RGBA. uint8 for 8-bit
    files, uint16 for 16-bit ones."""
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
    if (depth, ctype) not in ((8, 0), (8, 2), (8, 3), (8, 4), (8, 6), (16, 0), (16, 2),
                              (16, 4), (16, 6)) or interlace:
        raise ValueError(f"{path}: PNG of bit depth {depth}, colour type {ctype}, interlace "
                         f"{interlace} is not supported (8 or 16 bits, not interlaced only)")
    bpp = _CHANNELS[ctype] * depth // 8  # bytes per pixel, the filters' unit
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    img = _unfilter(raw[: H * (1 + W * bpp)], H, W, bpp)
    if depth == 16:  # samples are big-endian
        img = np.ascontiguousarray(img).view(">u2").astype(np.uint16)
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
    return img[..., 0] if _CHANNELS[ctype] == 1 else img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """Write a uint8 or uint16 image ([H, W] gray, [H, W, 1|2|3|4]) as an
    8- or 16-bit PNG with the Sub filter on every row."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png takes uint8 or uint16 images, not {img.dtype}")
    depth = 8 * img.dtype.itemsize
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
    if depth == 16:  # big-endian samples; the filters work on bytes
        img = img.astype(">u2").view(np.uint8)
        bpp *= 2
    px = img.reshape(H, W, bpp)
    sub = px.copy()
    sub[:, 1:] = px[:, 1:] - px[:, :-1]  # uint8 arithmetic wraps mod 256
    raw = np.concatenate([np.ones((H, 1), np.uint8), sub.reshape(H, W * bpp)], 1)
    ihdr = struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIG + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
                + _chunk(b"IEND", b""))


def _kind(path: str) -> str:
    with open(path, "rb") as f:
        head = f.read(8)
    if head == _SIG:
        return "png"
    if head[:2] == b"\xff\xd8":
        return "jpeg"
    raise ValueError(f"{path}: not a PNG or JPEG file (no other image format is read)")


def _png_rgb(path: str) -> np.ndarray:
    img = read_png(path)
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, -1)
    if img.shape[2] == 2:  # gray + alpha
        return np.repeat(img[..., :1], 3, -1)
    return np.ascontiguousarray(img[..., :3])


def read_image_rgb(path: str, device="cuda") -> np.ndarray:
    """[H, W, 3] uint8, as PIL's `Image.open(path).convert("RGB")`: gray is
    repeated, alpha dropped. PNG decodes on the host; a JPEG decodes on
    `device` (data/jpeg.decode_jpegs: the card unless the caller asks for the
    CPU)."""
    if _kind(path) == "png":
        return _png_rgb(path)
    from .jpeg import decode_jpegs

    return decode_jpegs([path], device)[0].cpu().numpy()


def read_frames(paths, device="cuda") -> list:
    """Every frame as an [H, W, 3] uint8 tensor on `device`, as
    `read_image_rgb` reads it: the JPEG files decoded as one batch, each file
    once. Raises RuntimeError when the card is asked for and there is none."""
    from .jpeg import decode_jpegs

    device = check_device(device)
    kinds = [_kind(p) for p in paths]
    jpegs = iter(decode_jpegs([p for p, k in zip(paths, kinds) if k == "jpeg"], device))
    return [next(jpegs) if k == "jpeg" else torch.from_numpy(_png_rgb(p)).to(device)
            for p, k in zip(paths, kinds)]


def image_size(path: str):
    """(width, height) of a PNG or JPEG file, from its header."""
    if _kind(path) == "png":
        with open(path, "rb") as f:
            return struct.unpack(">II", f.read(24)[16:24])
    from .jpeg import jpeg_size

    return jpeg_size(path)


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
    # int32 sums, as Resample.c's (8-bit samples times 22-bit weights fit)
    src = img.astype(np.int32)
    shape = [1] * src.ndim
    shape[axis] = out_size
    acc = np.full(src.shape[:axis] + (out_size,) + src.shape[axis + 1:],
                  1 << (_PRECISION_BITS - 1), np.int32)
    for k in range(kk.shape[1]):
        acc += np.take(src, idx[:, k], axis=axis) * kk[:, k].astype(np.int32).reshape(shape)
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


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


# ---------------------------------------------------------------------------
# cv2's INTER_AREA and INTER_CUBIC resizes and its cubic remap, on tensors
# ---------------------------------------------------------------------------

def _cubic_coeffs(x):
    """cv2's interpolateCubic (imgproc/src/resize.cpp, A = -0.75) of float32
    offsets x in [0, 1): the four tap weights [..., 4], in float32."""
    x = np.asarray(x, np.float32)
    A = np.float32(-0.75)
    one = np.float32(1.0)
    c0 = ((A * (x + one) - 5 * A) * (x + one) + 8 * A) * (x + one) - 4 * A
    c1 = ((A + 2) * x - (A + 3)) * x * x + one
    c2 = ((A + 2) * (one - x) - (A + 3)) * (one - x) * (one - x) + one
    c3 = one - c0 - c1 - c2
    return np.stack([c0, c1, c2, c3], -1).astype(np.float32)


def _cubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] weights of cv2's INTER_CUBIC along one axis: half-pixel
    centres, taps sx-1..sx+2 clamped to the edge (BORDER_REPLICATE). The
    source position and its fractional part are taken in float64, the
    weights in float32 (as the installed cv2 does)."""
    scale = 1.0 / (n_out / n_in)
    fx = (np.arange(n_out) + 0.5) * scale - 0.5
    sx = np.floor(fx).astype(np.int64)
    coeffs = _cubic_coeffs(fx - sx)
    m = np.zeros((n_out, n_in), np.float64)
    for k in range(4):
        np.add.at(m, (np.arange(n_out), np.clip(sx - 1 + k, 0, n_in - 1)), coeffs[:, k])
    return m.astype(np.float32)


def _area_tab_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] weights of cv2's INTER_AREA decimation along one axis
    (computeResizeAreaTab): each output cell averages the input pixels it
    covers, the partly covered ones by their covered share."""
    scale = 1.0 / (n_out / n_in)
    m = np.zeros((n_out, n_in), np.float64)
    for dx in range(n_out):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, n_in - fsx1)
        sx2 = min(math.floor(fsx2), n_in - 1)
        sx1 = min(math.ceil(fsx1), sx2)
        if sx1 - fsx1 > 1e-3:
            m[dx, sx1 - 1] += np.float32((sx1 - fsx1) / cell)
        for sx in range(sx1, sx2):
            m[dx, sx] += np.float32(1.0 / cell)
        if fsx2 - sx2 > 1e-3:
            m[dx, sx2] += np.float32(min(min(fsx2 - sx2, 1.0), cell) / cell)
    return m.astype(np.float32)


def _area_linear_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] weights of cv2's INTER_AREA when an axis is enlarged:
    two taps at floor(dx · in/out), the second weighted by the fractional
    part of (dx + 1) - (sx + 1) · out/in (resizeGeneric's area mode)."""
    scale = 1.0 / (n_out / n_in)
    inv = n_out / n_in
    m = np.zeros((n_out, n_in), np.float64)
    for dx in range(n_out):
        sx = math.floor(dx * scale)
        fx = (dx + 1) - (sx + 1) * inv
        fx = 0.0 if fx <= 0 else float(np.float32(fx - math.floor(fx)))
        if sx >= n_in - 1:
            fx, sx = 0.0, n_in - 1
        m[dx, sx] += np.float32(1.0 - fx)
        m[dx, min(sx + 1, n_in - 1)] += np.float32(fx)
    return m.astype(np.float32)


def _separable(img: torch.Tensor, mh: np.ndarray, mw: np.ndarray) -> torch.Tensor:
    x = img.float()
    mh = torch.from_numpy(mh).to(x.device)
    mw = torch.from_numpy(mw).to(x.device)
    if x.ndim == 2:
        return mh @ x @ mw.T
    return torch.einsum("hH,HWc,wW->hwc", mh, x, mw)


def resize_area(img: torch.Tensor, wh) -> torch.Tensor:
    """cv2.resize(img, wh, interpolation=cv2.INTER_AREA) of a float [H, W] or
    [H, W, C] tensor: area averaging when neither axis grows (960 → 768 is a
    non-integer 0.8, with partly covered pixels weighted by their share),
    cv2's area-mode two-tap rule on both axes otherwise."""
    W, H = int(wh[0]), int(wh[1])
    h0, w0 = img.shape[:2]
    if w0 / W >= 1 and h0 / H >= 1:
        return _separable(img, _area_tab_matrix(h0, H), _area_tab_matrix(w0, W))
    return _separable(img, _area_linear_matrix(h0, H), _area_linear_matrix(w0, W))


def resize_cubic(img: torch.Tensor, wh) -> torch.Tensor:
    """cv2.resize(img, wh, interpolation=cv2.INTER_CUBIC) of a float [H, W]
    or [H, W, C] tensor: a = -0.75, half-pixel centres, edge pixels
    repeated."""
    W, H = int(wh[0]), int(wh[1])
    h0, w0 = img.shape[:2]
    return _separable(img, _cubic_matrix(h0, H), _cubic_matrix(w0, W))


def remap_cubic(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """cv2.remap(img, xy, None, cv2.INTER_CUBIC, borderMode=BORDER_CONSTANT)
    with border value 0: img [H, W] or [H, W, C] float, xy [h, w, 2] float32
    absolute source coordinates (x, y). The 4×4 taps around floor(xy) are
    weighted by interpolateCubic of the float32 fractional parts (the
    installed cv2 takes the map's coordinates as they are, with no 1/32
    pixel table); taps outside the image read 0."""
    x = img.float()
    squeeze = x.ndim == 2
    if squeeze:
        x = x[..., None]
    H, W, C = x.shape
    pos = xy.float()
    base = torch.floor(pos)
    frac = pos - base
    base = base.clamp(-2.0**30, 2.0**30).to(torch.int64) - 1  # [h, w, 2]: first tap
    A = -0.75

    def coeffs(t):
        c0 = ((A * (t + 1) - 5 * A) * (t + 1) + 8 * A) * (t + 1) - 4 * A
        c1 = ((A + 2) * t - (A + 3)) * t * t + 1
        c2 = ((A + 2) * (1 - t) - (A + 3)) * (1 - t) * (1 - t) + 1
        return (c0, c1, c2, 1 - c0 - c1 - c2)

    wx, wy = coeffs(frac[..., 0]), coeffs(frac[..., 1])
    flat = x.reshape(H * W, C)
    out = torch.zeros(xy.shape[:2] + (C,), dtype=torch.float32, device=x.device)
    for j in range(4):
        yj = base[..., 1] + j
        for i in range(4):
            xi = base[..., 0] + i
            inside = (xi >= 0) & (xi < W) & (yj >= 0) & (yj < H)
            idx = (yj.clamp(0, H - 1) * W + xi.clamp(0, W - 1)).reshape(-1)
            v = flat[idx].reshape(out.shape)
            out = out + v * (wy[j] * wx[i] * inside)[..., None]
    return out[..., 0] if squeeze else out
