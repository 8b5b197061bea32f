"""The port's image I/O (rodynrf_tpu_torch/data/imageio.py) against the
libraries the JAX package uses, and the port's scene and output paths with
none of them importable. JAX-free.

- PNG: decoding a PIL-written file gives PIL's pixels bit for bit, and PIL
  decodes the port's file to the input, for gray, gray + alpha, RGB and RGBA
  images of odd sizes, noisy and smooth (PIL's writer then uses the None,
  Sub, Up and Paeth row filters), and palette images; a file written with
  the Average filter on every row decodes as PIL decodes it; sub-byte
  depths (1-bit gray and palette images of 1, 2 and 4 bits written by PIL,
  2- and 4-bit gray written here) and Adam7-interlaced files of every
  colour type and depth (written here: PIL writes no interlaced PNG) read
  as PIL's `convert("RGB")` reads them, bit for bit.
- PIL's LANCZOS and BILINEAR resizes of uint8 images: equal to PIL's
  (the contract allows one level of 255; the measured gap is 0).
- cv2's INTER_LINEAR resize of float arrays within 1e-5 of scale, its
  INTER_NEAREST resize exactly.
- The golden fixture loads, and the reference's .th pair renders and
  writes its PNGs, with `sys.modules` entries for PIL, cv2 and imageio set
  to None (the videos are skipped with a line each); the output PNGs decode
  under PIL to what the port wrote. A JPEG frame needs PIL and says so.
"""

import os
import sys

import cv2
import numpy as np
import pytest
from PIL import Image

from rodynrf_tpu_torch.data import imageio as io
from rodynrf_tpu_torch.testing import torch_threads

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
OUT = os.path.join(REPO, "golden", "out")
SHAPES = {"gray": (23, 37), "gray_alpha": (13, 11, 2), "rgb": (17, 29, 3), "rgba": (19, 31, 4)}

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def _images(shape, seed):
    rng = np.random.default_rng(seed)
    noisy = rng.integers(0, 256, shape, dtype=np.uint8)
    smooth = np.cumsum(np.cumsum(rng.integers(0, 3, shape), 0), 1).astype(np.uint8)
    return noisy, smooth


@pytest.mark.parametrize("kind", list(SHAPES))
def test_png_decode_and_encode_match_pil(kind, tmp_path):
    path = str(tmp_path / "x.png")
    for img in _images(SHAPES[kind], len(kind)):
        Image.fromarray(img).save(path)
        np.testing.assert_array_equal(io.read_png(path), img)
        io.write_png(path, img)
        np.testing.assert_array_equal(np.asarray(Image.open(path)), img)


def test_png_average_filter_matches_pil(tmp_path):
    import struct
    import zlib

    img = _images((15, 21, 3), 5)[1].astype(np.int32)
    H, W, C = img.shape
    left = np.concatenate([np.zeros((H, 1, C), np.int32), img[:, :-1]], 1)
    up = np.concatenate([np.zeros((1, W, C), np.int32), img[:-1]], 0)
    filt = ((img - (left + up) // 2) & 255).astype(np.uint8).reshape(H, W * C)
    raw = np.concatenate([np.full((H, 1), 3, np.uint8), filt], 1).tobytes()
    path = str(tmp_path / "avg.png")
    with open(path, "wb") as f:
        ihdr = struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)
        f.write(b"\x89PNG\r\n\x1a\n" + io._chunk(b"IHDR", ihdr)
                + io._chunk(b"IDAT", zlib.compress(raw)) + io._chunk(b"IEND", b""))
    np.testing.assert_array_equal(np.asarray(Image.open(path)), img)
    np.testing.assert_array_equal(io.read_png(path), img)


def test_png_palette_matches_pil(tmp_path):
    path = str(tmp_path / "p.png")
    rgb = _images((21, 33, 3), 7)[1]
    Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE, colors=17).save(path)
    want = np.asarray(Image.open(path).convert("RGB"))
    np.testing.assert_array_equal(io.read_png(path), want)
    np.testing.assert_array_equal(io.read_image_rgb(path), want)


@pytest.mark.parametrize("kind", ["1", "P1", "P2", "P4"])
def test_png_sub_byte_depths_written_by_pil_match_pil(kind, tmp_path):
    path = str(tmp_path / "s.png")
    rgb = _images((19, 29, 3), 11)[1]
    if kind == "1":
        Image.fromarray(rgb).convert("1").save(path)
    else:
        bits = int(kind[1])
        Image.fromarray(rgb).convert("P", palette=Image.ADAPTIVE, colors=1 << bits).save(
            path, bits=bits)
    with open(path, "rb") as f:
        assert f.read(25)[24] == (1 if kind == "1" else int(kind[1]))  # IHDR bit depth
    np.testing.assert_array_equal(io.read_image_rgb(path), np.asarray(
        Image.open(path).convert("RGB")))


def _adam7_png(path, samples, depth, ctype, plte=None, interlace=True, seed=0):
    """Write samples [H, W, C] (values < 2**depth) as a PNG, Adam7-interlaced
    or not, each row with a seeded filter of 0-4 (the encoder's side of
    the filters over the bytes, sub-byte samples packed most significant
    first)."""
    import struct
    import zlib

    rng = np.random.default_rng(seed)
    H, W, C = samples.shape
    passes = ([(0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4), (2, 0, 4, 2),
               (0, 1, 2, 2), (1, 0, 2, 1)] if interlace else [(0, 0, 1, 1)])
    bpp = max(1, C * depth // 8)
    raw = b""
    for y0, x0, dy, dx in passes:
        sub = samples[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        h, w = sub.shape[:2]
        if depth == 16:
            rows = sub.astype(">u2").view(np.uint8).reshape(h, -1)
        elif depth == 8:
            rows = sub.astype(np.uint8).reshape(h, -1)
        else:
            bits = (sub.reshape(h, w)[..., None] >> np.arange(depth - 1, -1, -1)) & 1
            rows = np.packbits(bits.reshape(h, -1).astype(np.uint8), axis=1)
        rows = rows.astype(np.int32)
        prior = np.zeros(rows.shape[1], np.int32)
        for r in range(h):
            f = int(rng.integers(0, 5))
            x = rows[r]
            a = np.concatenate([np.zeros(bpp, np.int32), x[:-bpp]])
            c = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
            b = prior
            pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
            paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
            pred = [0 * x, a, b, (a + b) >> 1, paeth][f]
            raw += bytes([f]) + ((x - pred) & 255).astype(np.uint8).tobytes()
            prior = x
    with open(path, "wb") as fh:
        ihdr = struct.pack(">IIBBBBB", W, H, depth, ctype, 0, 0, int(interlace))
        fh.write(b"\x89PNG\r\n\x1a\n" + io._chunk(b"IHDR", ihdr)
                 + (io._chunk(b"PLTE", plte.tobytes()) if plte is not None else b"")
                 + io._chunk(b"IDAT", zlib.compress(raw)) + io._chunk(b"IEND", b""))


@pytest.mark.parametrize("interlace", [True, False], ids=["adam7", "plain"])
@pytest.mark.parametrize("ctype,depth", [(0, 1), (0, 2), (0, 4), (0, 8), (0, 16), (2, 8),
                                         (2, 16), (3, 1), (3, 2), (3, 4), (3, 8), (4, 8),
                                         (6, 8), (6, 16)])
def test_png_depths_and_adam7_match_pil(ctype, depth, interlace, tmp_path):
    rng = np.random.default_rng(depth * 10 + ctype)
    C = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    plte = rng.integers(0, 256, (1 << min(depth, 8), 3), dtype=np.uint8) if ctype == 3 else None
    for i, (H, W) in enumerate([(1, 1), (3, 5), (9, 7), (17, 30)]):
        samples = rng.integers(0, 1 << depth, (H, W, C))
        path = str(tmp_path / f"{i}.png")
        _adam7_png(path, samples, depth, ctype, plte, interlace, seed=i)
        want = Image.open(path)
        if depth == 16 and ctype == 0:  # 16-bit gray stays uint16, as PIL's I;16
            np.testing.assert_array_equal(io.read_png(path), np.asarray(want))
        elif depth == 16:  # PIL keeps the high byte of 16-bit colour samples
            got = (io.read_png(path) >> 8).astype(np.uint8)[..., :3]
            np.testing.assert_array_equal(got, np.asarray(want.convert("RGB")))
        else:
            np.testing.assert_array_equal(io.read_image_rgb(path),
                                          np.asarray(want.convert("RGB")), err_msg=f"{H}x{W}")


@pytest.mark.parametrize("filt", ["lanczos", "bilinear"])
@pytest.mark.parametrize("sizes", [(540, 960, 270, 480), (37, 53, 17, 29), (20, 30, 40, 45),
                                   (31, 33, 31, 16)])
def test_pil_resize_matches_pil(filt, sizes):
    h, w, H, W = sizes
    rng = np.random.default_rng(h * w)
    img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    want = np.asarray(Image.fromarray(img).resize(
        (W, H), {"lanczos": Image.LANCZOS, "bilinear": Image.BILINEAR}[filt]))
    got = io.pil_resize(img, (W, H), filt)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    np.testing.assert_array_equal(got, want)  # measured: bit for bit


@pytest.mark.parametrize("sizes", [(540, 960, 270, 480), (37, 53, 17, 29), (20, 30, 40, 45),
                                   (7, 9, 7, 9)])
def test_cv2_resizes_match_cv2(sizes):
    h, w, H, W = sizes
    rng = np.random.default_rng(h + w)
    for a in (rng.normal(size=(h, w)).astype(np.float32),
              rng.normal(size=(h, w, 2)).astype(np.float32)):
        want = cv2.resize(a, (W, H), interpolation=cv2.INTER_LINEAR)
        got = io.resize_linear(a, (W, H))
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
        np.testing.assert_array_equal(
            io.resize_nearest(a, (W, H)), cv2.resize(a, (W, H), interpolation=cv2.INTER_NEAREST))


def test_jpeg_frames_need_pil(monkeypatch, tmp_path):
    """JPEG frames no longer need PIL: with PIL blocked the port decodes
    them (data/jpeg.py) to PIL's own pixels; a file that is neither PNG nor
    JPEG raises, naming it."""
    path = str(tmp_path / "f.jpg")
    img = _images((12, 20, 3), 9)[1]
    Image.fromarray(img).save(path, quality=95)
    want = np.asarray(Image.open(path))
    other = tmp_path / "f.bmp"
    Image.fromarray(img).save(str(other))
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(io.read_image_rgb(path, device="cpu"), want)
    assert io.image_size(path) == (20, 12)
    with pytest.raises(ValueError, match="f.bmp: not a PNG or JPEG"):
        io.read_image_rgb(str(other), device="cpu")


def test_port_reads_and_writes_pngs_without_image_libraries(monkeypatch, tmp_path, capsys):
    for name in ("PIL", "PIL.Image", "cv2", "imageio"):
        monkeypatch.setitem(sys.modules, name, None)
    from rodynrf_tpu_torch.cli import main
    from rodynrf_tpu_torch.data.video_dataset import load_nvidia_scene

    scene = load_nvidia_scene(os.path.join(OUT, "fixture"), downsample=1.0, use_disp=True,
                              use_foreground_mask="motion_masks", with_gt_poses=True,
                              ray_type="ndc", device="cpu")
    assert scene.rgbs_stack.shape == (4, 24, 32, 3) and scene.fg_masks.max() > 0
    rep = main(["--config", os.path.join(REPO, "golden", "tiny.txt"),
                "--datadir", os.path.join(OUT, "fixture"), "--basedir", str(tmp_path),
                "--render_only", "1", "--render_test", "1",
                "--ckpt", os.path.join(OUT, "ref_log", "golden_tiny", "golden_tiny.th")],
               device="cpu")
    assert len(rep["psnrs"]) == 4
    # no mp4 writer: one line for each of the three videos it could not write
    assert capsys.readouterr().out.count("[video]") == 3
    monkeypatch.undo()
    written = tmp_path / "golden_tiny" / "imgs_test_all" / "000.png"
    np.testing.assert_array_equal(np.asarray(Image.open(written)), io.read_png(str(written)))
