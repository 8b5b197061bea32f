"""The port's baseline JPEG decoder (rodynrf_tpu_torch/data/jpeg.py) on the
CPU, where its three stages run their plain versions (progressive frames:
tests/test_torch_jpeg_progressive.py):

- it equals Pillow's `np.asarray(Image.open(p).convert("RGB"))` bit for bit
  on every committed fixture (tests/data/jpeg, written by Pillow: 4:4:4,
  4:2:2, 4:2:0, gray, Adobe RGB, quality 50 to 95, optimized Huffman
  tables, restart intervals, sizes that are not multiples of the MCU, a
  chroma plane two samples wide) and on `testing.write_jpeg` output over a seeded set of
  sizes, qualities and subsamplings, 4:4:0 (h1v2) included, which Pillow
  decodes but cannot write;
- `decode_jpegs(..., device="cpu")` equals the plain stages run by hand;
- the DAVIS loader on a JPEG scene equals the JAX package's (PIL + LANCZOS):
  frames bit for bit, sidecars under test_torch_data.py's tolerances;
- unsupported kinds (progressive arithmetic-coded frames, progressive
  scripts that leave coefficients short of full precision, ...) and broken
  files raise ValueError naming the marker;
- the port reads JPEG scenes with PIL blocked; without a card the decoder
  and the loader refuse their default device;
- chip_smoke.py phase 14 rehearses on the CPU at a small size.
The kernels against these plain versions on the card:
tests/test_torch_kernels.py.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from rodynrf_tpu.data.video_dataset import load_davis_scene as jload_davis
from rodynrf_tpu_torch.data import jpeg as J
from rodynrf_tpu_torch.data.imageio import image_size, read_frames
from rodynrf_tpu_torch.data.video_dataset import load_davis_scene
from rodynrf_tpu_torch.testing import torch_threads, write_jpeg, write_video_scene

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "data" / "jpeg"
BASELINE = sorted(p.name for p in FIXTURES.glob("*.jpg") if "progressive" not in p.name)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def _pil(path):
    return np.asarray(Image.open(path).convert("RGB"))


def test_fixtures_cover_what_the_decoder_takes():
    assert len(BASELINE) == 10 and sum(p.stat().st_size for p in FIXTURES.iterdir()) < 200_000
    frames = [J.read_jpeg(str(FIXTURES / n)) for n in BASELINE]
    kinds = {(f.comps[0].h, f.comps[0].v, len(f.comps), f.restart > 0) for f in frames}
    assert {(1, 1, 3, False), (2, 1, 3, False), (2, 2, 3, False), (1, 1, 1, False),
            (2, 2, 3, True), (2, 1, 3, True)} <= kinds
    assert {f.color for f in frames} == {J.COLOR_GRAY, J.COLOR_YCC, J.COLOR_RGB}


@pytest.mark.parametrize("name", BASELINE)
def test_plain_decoder_equals_pil_on_the_fixtures(name):
    path = str(FIXTURES / name)
    got = J.decode_jpegs([path], device="cpu")[0]
    want = _pil(path)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert image_size(path) == Image.open(path).size


@pytest.mark.parametrize("subsampling", ["444", "422", "420", "440", "gray"])
def test_plain_decoder_equals_pil_on_write_jpeg(subsampling, tmp_path):
    rng = np.random.default_rng(["444", "422", "420", "440", "gray"].index(subsampling))
    paths = []
    for i, (h, w) in enumerate([(1, 1), (3, 4), (17, 23), (33, 9), (16, 16), (24, 40)]):
        yy, xx = np.mgrid[:h, :w]
        img = np.stack([xx * 9 + yy * 4, yy * 7, (xx * yy) % 256], -1)
        img = np.clip(img + rng.normal(0, 25, (h, w, 3)), 0, 255).astype(np.uint8)
        if subsampling == "gray":
            img = img[..., 0]
        quality = (50, 95, 75)[i % 3]
        restart = (0, 1, 3)[i % 3]
        paths.append(str(tmp_path / f"{i}.jpg"))
        write_jpeg(paths[-1], img, quality, "444" if subsampling == "gray" else subsampling,
                   restart)
    for path, got in zip(paths, J.decode_jpegs(paths, device="cpu")):
        np.testing.assert_array_equal(got.numpy(), _pil(path), err_msg=path)


def test_decode_jpegs_on_the_cpu_is_the_plain_path():
    paths = [str(FIXTURES / n) for n in BASELINE]
    host = J.pack([J.read_jpeg(p) for p in paths])
    coef, status = J.entropy_decode_plain(host)
    assert coef.dtype == torch.int16 and coef.shape == (host.n_blocks, 64) and not status.any()
    rgb = J.color_plain(J.idct_plain(coef, host), host)
    got = J.decode_jpegs(paths, device="cpu")
    for f_i, (f, img) in enumerate(zip(host.frames, got)):
        o = int(host.frame_pix0[f_i]) * 3
        assert torch.equal(img.reshape(-1), rgb[o:o + f.H * f.W * 3])
    # read_frames batches the JPEG files and reads PNGs on the host, in order
    png = str(REPO / "golden" / "out" / "fixture" / "images" / "000.png")
    mixed = read_frames([paths[0], png, paths[1]], "cpu")
    assert torch.equal(mixed[0], got[0]) and torch.equal(mixed[2], got[1])
    np.testing.assert_array_equal(mixed[1].numpy(), _pil(png))


@pytest.mark.parametrize("downsample", [1.0, 2.0])
def test_davis_jpeg_scene_loads_as_in_jax(tmp_path, downsample):
    root = str(tmp_path / "davis")
    write_video_scene(root, T=4, H=48, W=64, seed=3, layout="davis", fmt="jpg")
    assert sorted(os.listdir(os.path.join(root, "images")))[0] == "00000.jpg"
    kw = dict(downsample=downsample, use_disp=True, use_foreground_mask="epipolar_error_png",
              with_gt_poses=False, ray_type="contract")
    ours, ref = load_davis_scene(root, **kw, device="cpu"), jload_davis(root, **kw)
    assert ours.img_wh == ref.img_wh == (int(64 / downsample), int(48 / downsample))
    np.testing.assert_array_equal(np.rint(ours.rgbs_stack * 255), np.rint(ref.rgbs_stack * 255))
    np.testing.assert_array_equal(ours.rgbs, ref.rgbs)
    pix = 1.0 / 255 + 1e-7
    for k, tol in (("fg_masks", pix), ("disps", 1e-5), ("flows_f", 1e-5), ("flows_b", 1e-5),
                   ("flow_masks_f", 1e-6), ("flow_masks_b", 1e-6), ("ts", 1e-6)):
        a, b = getattr(ours, k), getattr(ref, k)
        scale = float(np.abs(b).max()) if k in ("disps", "flows_f", "flows_b") else 1.0
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale, err_msg=k)
    assert ours.near_far == ref.near_far and ours.n_frames == ref.n_frames == 4


def _patched(tmp_path, name, edit):
    data = bytearray((FIXTURES / name).read_bytes())
    edit(data)
    path = tmp_path / ("patched_" + name)
    path.write_bytes(bytes(data))
    return str(path)


def _sof(data):
    return bytes(data).index(b"\xff\xc0")


def _scan(data):
    i = bytes(data).index(b"\xff\xda")
    return i + 2 + int.from_bytes(data[i + 2:i + 4], "big")


@pytest.mark.parametrize("case,match", [
    ("progressive arithmetic", "SOF10: progressive arithmetic-coded"),
    ("incomplete progressive script", "EOI: an incomplete progressive script: component 0 "
                                      "coefficients 1-63 left 1 bits short"),
    ("arithmetic", "SOF9: arithmetic-coded"),
    ("12-bit", "SOF0: 12-bit samples"),
    ("four components", "SOF0: 4 components"),
    ("truncated", "truncated"),
    ("corrupt", "corrupt entropy-coded data"),
])
def test_unsupported_and_broken_files_raise(tmp_path, case, match):
    name = "rgb420_q95_48x64.jpg"
    edits = {  # SOF0's marker byte, its precision, its component count
        "arithmetic": lambda d: d.__setitem__(_sof(d) + 1, 0xC9),
        "12-bit": lambda d: d.__setitem__(_sof(d) + 4, 12),
        "four components": lambda d: d.__setitem__(_sof(d) + 9, 4),
        "truncated": lambda d: d.__delitem__(slice(_scan(d) + 200, None)),
        "corrupt": lambda d: d.__setitem__(slice(_scan(d), _scan(d) + 64), b"\xff\x00" * 32),
    }
    prog = bytes((FIXTURES / "progressive_q90_24x32.jpg").read_bytes())
    edits["progressive arithmetic"] = lambda d: d.__setitem__(prog.index(b"\xff\xc2") + 1, 0xCA)
    # the standard script without its last scan (Y AC 1-63, Ah 1 -> Al 0)
    edits["incomplete progressive script"] = lambda d: d.__setitem__(
        slice(prog.rindex(b"\xff\xda"), len(d) - 2), b"")
    path = _patched(tmp_path, "progressive_q90_24x32.jpg" if "progressive" in case else name,
                    edits[case])
    with pytest.raises(ValueError, match=match) as err:
        J.decode_jpegs([path], device="cpu")
    assert os.path.basename(path) in str(err.value)


def test_the_port_reads_jpeg_scenes_without_pil(tmp_path):
    root = str(tmp_path / "davis")
    write_video_scene(root, T=3, H=24, W=32, layout="davis", fmt="jpg")
    code = (
        "import sys\n"
        "for m in ('PIL', 'PIL.Image', 'cv2', 'imageio'): sys.modules[m] = None\n"
        "from rodynrf_tpu_torch.data.video_dataset import load_davis_scene\n"
        f"s = load_davis_scene({root!r}, downsample=2.0, use_foreground_mask="
        "'epipolar_error_png', ray_type='contract', device='cpu')\n"
        "assert s.rgbs_stack.shape == (3, 12, 16, 3) and s.rgbs_stack.max() > 0\n"
        "assert not any(m.startswith(('PIL', 'cv2', 'imageio')) for m in sys.modules\n"
        "               if sys.modules[m] is not None)\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, PYTHONPATH=str(REPO)))
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_the_card_is_the_default(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    root = str(tmp_path / "davis")
    write_video_scene(root, T=2, H=16, W=16, layout="davis", fmt="jpg")
    frames = sorted(str(p) for p in Path(root, "images").iterdir())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        J.decode_jpegs(frames)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        read_frames(frames)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_davis_scene(root, use_foreground_mask="epipolar_error_png")


def test_chip_smoke_davis_phase_rehearses_on_the_cpu(monkeypatch):
    """chip_smoke.py phase 14 at a small size on the CPU (4 frames of 64×64,
    a progressive scene of 4 frames of 48×32, batch 128, 32³ in place of
    256³; the card's memory calls stubbed, the table-gradient counters set
    to what the CPU's plain versions count, the JPEG wrappers counted as the
    card counts them: one per call, the progressive decode one per round):
    the fixtures and frames through the stages, the preprocessing commands
    with --zfill 5, the recipe through cli.main, the timed trainers, the
    progressive scene through load_scene and cli.main, and its checkpoint
    through --render_only."""
    import chip_smoke as cs
    from rodynrf_tpu_torch.ops import jpeg as K

    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(cs, "DAVIS_SCENE", dict(T=4, H=64, W=64))
    monkeypatch.setattr(cs, "DAVIS_PROGRESSIVE", dict(T=4, H=32, W=48))
    monkeypatch.setattr(cs, "DAVIS_VOXELS_256", "32768")
    monkeypatch.setattr(cs, "DAVIS_RECIPE", cs.DAVIS_RECIPE + ["--batch_size", "128"])
    monkeypatch.setattr(cs, "PRE_LONG_SIDE", 64)
    monkeypatch.setattr(cs, "PRE_ITERS", 2)
    monkeypatch.setattr(cs, "PRE_DPT", cs.NARROW_DPT)
    zero = {k: 0 for k in cs.KERNELS}
    monkeypatch.setattr(cs, "launches_per_step", lambda S, layouts: dict(zero))
    monkeypatch.setattr(cs, "counters", lambda: dict(zero))
    for name in cs.JPEG_KERNELS:
        def counted(*a, _fn=getattr(K, name), _name=name, **kw):
            batch = a[-1]  # every wrapper takes the batch last
            getattr(K, _name).launches += (int(batch.seg.shape[0] > 0) if _name == "jpeg_entropy"
                                           else len(batch.rounds)
                                           if _name == "jpeg_progressive" else 1)
            return _fn(*a, **kw)
        counted.launches = 0
        monkeypatch.setattr(K, name, counted)
    records, davis = cs.drive_davis("cpu", device="cpu")
    assert [r["path"] for r in records] == ["davis_cli", "davis_16", "davis_256",
                                            "davis_progressive"]
    one = cs.one_batch_launches()
    assert one == {"jpeg_entropy": 1, "jpeg_progressive": 0, "jpeg_idct": 1, "jpeg_color": 1}
    assert records[0]["launches"] == records[1]["launches"] == {**zero, **one}
    assert records[2]["launches"] == {**zero, **{k: 0 for k in one}}
    assert records[3]["launches"] == {**zero, **cs.one_batch_launches(False, 10)}
    assert davis["steps"]["davis_256"]["grid"] == [31, 31, 31]
    assert all(np.isfinite(davis["cli"]["losses"])) and len(davis["cli"]["psnrs"]) == 4
    assert len(davis["progressive"]["losses"]) == 1 and len(davis["progressive"]["psnrs"]) == 4
    assert davis["progressive"]["render_only_psnrs_equal"]
    # the scene's 4 frames as the loader's one batch, a restart frame, every
    # fixture (10 baseline + 8 progressive), the progressive scene's frames
    cases = [(c["frames"], c["segments"], c["progressive_frames"], c["rounds"])
             for c in davis["jpeg_cases"]]
    assert cases[1:] == [(4, 4, 0, 0), (1, 2, 0, 0), (18, 24, 8, 10), (4, 0, 4, 10)]
