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
- the model of the baseline kernel's algorithm (`entropy_decode_model`: the
  self-synchronising parallel decode, its sync rounds, block and DC scans
  and write pass) equals the plain version bit for bit, blocks and status
  words, on every fixture and on restart-marker frames at subsequences of
  32 bits up (every decoder syncs many times), and on damaged files (the
  corrupt file of the refusal cases, flipped bytes, segments cut short,
  runs of all-ones bits);
- the models of the sample-reconstruction kernels' designs equal the plain
  versions bit for bit: `color_tiled_model` (tile by tile from
  `JpegBatch.color_tiles` and halo-staged windows) on every fixture,
  progressive ones included, and on a mixed batch of `testing.edge_jpegs`
  frames (854×480, a frame smaller than a tile, widths 16k ± 1, the 3×4
  box case; 4:2:0, 4:2:2, 4:4:4, 4:4:0, gray); `idct_int32_model` (32-bit
  islow where exact, with an overflow check) on the fixtures, the edge
  frames, seeded extreme blocks (`testing.extreme_idct_blocks`: ±32767
  under quantisers up to 255) and damaged files' blocks, with its route
  at the bound derived from islow's matrix: the largest column under it
  stays in 32 bits, one just past it goes to 64 and would have wrapped;
- chip_smoke.py phase 14 rehearses on the CPU at a small size.
The kernels against these plain versions on the card:
tests/test_torch_kernels.py.
"""

import os
import re
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
from rodynrf_tpu_torch.testing import (edge_jpegs, extreme_idct_blocks, torch_threads,
                                       write_jpeg, write_video_scene)

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
    card counts them: the baseline decode's three passes, the progressive
    decode's launches by the kinds of its rounds, one IDCT, one colour pass):
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
            getattr(K, _name).launches += (
                3 * int(batch.seg.shape[0] > 0) if _name == "jpeg_entropy"
                else cs.one_batch_launches(False, batch.round_kinds)["jpeg_progressive"]
                if _name == "jpeg_progressive"
                else 1)
            return _fn(*a, **kw)
        counted.launches = 0
        monkeypatch.setattr(K, name, counted)
    records, davis = cs.drive_davis("cpu", device="cpu")
    assert [r["path"] for r in records] == ["davis_cli", "davis_16", "davis_256",
                                            "davis_progressive"]
    one = cs.one_batch_launches()
    assert one == {"jpeg_entropy": 3, "jpeg_progressive": 0, "jpeg_idct": 1, "jpeg_color": 1}
    assert records[0]["launches"] == records[1]["launches"] == {**zero, **one}
    assert records[2]["launches"] == {**zero, **{k: 0 for k in one}}
    # libjpeg's standard script in three rounds: its five first scans (sync,
    # scan, write); the DC refinement and three AC refinements (Y to Al 1,
    # Cb, Cr); the Y refinement to Al 0
    kinds = davis["jpeg_cases"][4]["round_kinds"]
    assert [[bool(n) for n in k] for k in kinds] == [[True, False, False],
                                                     [False, True, True], [False, False, True]]
    assert records[3]["launches"] == {**zero, **cs.one_batch_launches(False, kinds)}
    assert records[3]["launches"]["jpeg_progressive"] == 6
    assert davis["steps"]["davis_256"]["grid"] == [31, 31, 31]
    assert all(np.isfinite(davis["cli"]["losses"])) and len(davis["cli"]["psnrs"]) == 4
    assert len(davis["progressive"]["losses"]) == 1 and len(davis["progressive"]["psnrs"]) == 4
    assert davis["progressive"]["render_only_psnrs_equal"]
    # damaged copies of every fixture and of a frame of each scene, with and
    # without restart markers: the plain versions flag corrupt and short
    # segments (the models equal them: test_decode_models_on_damaged_files)
    assert davis["jpeg_damaged"][0]["frames"] == 3 * 22
    # the scene's 4 frames as the loader's one batch, a restart frame, every
    # fixture (10 baseline + 8 progressive), the progressive scene's frames
    cases = [(c["frames"], c["segments"], c["progressive_frames"], c["rounds"])
             for c in davis["jpeg_cases"]]
    assert cases[1:] == [(4, 4, 0, 0), (1, 2, 0, 0), (18, 24, 8, 3), (4, 0, 4, 3),
                         (35, 35, 0, 0)]
    # decode_jpegs by part on the loader's two batches
    for key in ("frames", "progressive"):
        split = davis["jpeg_batch"][key]["split_ms"]
        assert set(split) == {"read_jpeg", "pack", "to_device", "jpeg_entropy",
                              "jpeg_progressive", "jpeg_idct", "jpeg_color", "check_status",
                              "total"}
        assert all(v >= 0 for v in split.values())


@pytest.mark.parametrize("subseq_bits", [32, 96, 1024, J.SUBSEQ_BITS],
                         ids=["32", "96", "1024", "default"])
def test_parallel_decode_model_equals_plain(subseq_bits, tmp_path):
    paths = [str(FIXTURES / n) for n in BASELINE]
    rng = np.random.default_rng(subseq_bits)
    for i, (sub, restart) in enumerate([("420", 0), ("422", 1), ("444", 2), ("440", 3)]):
        img = rng.integers(0, 256, (24 + 8 * i, 40, 3), dtype=np.uint8)
        paths.append(str(tmp_path / f"{i}.jpg"))
        write_jpeg(paths[-1], img, 80, sub, restart)
    host = J.pack([J.read_jpeg(p) for p in paths])
    coef, status = J.entropy_decode_plain(host)
    got, got_status, info = J.entropy_decode_model(host, subseq_bits)
    assert torch.equal(got, coef) and torch.equal(got_status, status) and not status.any()
    assert info["subsequences"] >= host.seg.shape[0]
    if subseq_bits == 32:  # many decoders a segment, each syncing with its predecessor
        assert info["subsequences"] > 20 * host.seg.shape[0] and info["rounds"] > 10


def test_decode_models_on_damaged_files(tmp_path):
    """Both kernels' models on damaged baseline and progressive files, at a
    short and the default subsequence length: the status words and the
    blocks equal the plain versions'."""
    from rodynrf_tpu_torch.testing import damaged_jpegs

    name = "rgb420_q95_48x64.jpg"
    corrupt = _patched(tmp_path, name, lambda d: d.__setitem__(
        slice(_scan(d), _scan(d) + 64), b"\xff\x00" * 32))  # the refusal case "corrupt"
    paths = [corrupt] + damaged_jpegs(sorted(str(p) for p in FIXTURES.glob("*.jpg")),
                                      str(tmp_path), seed=3)
    host = J.pack([J.read_jpeg(p) for p in paths])
    coef, status = J.entropy_decode_plain(host)
    base = coef.clone()
    pstatus = J.progressive_decode_plain(coef, host)
    assert status[0] == J.STATUS_BAD_CODE
    assert {J.STATUS_BAD_CODE, J.STATUS_SHORT} <= set(status.tolist()) & set(pstatus.tolist())
    for subseq_bits in (64, J.SUBSEQ_BITS):
        got, got_status, _ = J.entropy_decode_model(host, subseq_bits)
        assert torch.equal(got_status, status) and torch.equal(got, base)
        got_p, _ = J.progressive_decode_model(got, host, subseq_bits)
        assert torch.equal(got_p, pstatus) and torch.equal(got, coef)


def _decoded(paths):
    """(host batch, blocks, planes) of `paths` by the plain versions."""
    host = J.pack([J.read_jpeg(p) for p in paths])
    coef, status = J.entropy_decode_plain(host)
    pstatus = J.progressive_decode_plain(coef, host)
    return host, coef, J.idct_plain(coef, host), bool(status.any() or pstatus.any())


@pytest.fixture(scope="module")
def edge_batch(tmp_path_factory):
    return _decoded(edge_jpegs(str(tmp_path_factory.mktemp("edge")), seed=14))


def test_kernel_constants_are_the_sources():
    """data/jpeg.py's IDCT_RUN, COLOR_TILE and IDCT32_MAX are the #defines of
    csrc/jpeg_idct.cu, and IDCT32_MAX is the bound derived from islow's
    pass-1 matrix: the largest max |x| with 61214·max |x| + 1024 < 2^31."""
    src = (REPO / "rodynrf_tpu_torch" / "csrc" / "jpeg_idct.cu").read_text()
    defined = {k: int(v) for k, v in re.findall(r"#define (\w+) (\d+)\n", src)}
    assert (defined["IDCT_RUN"], defined["COLOR_TH"], defined["COLOR_TW"]) == (
        J.IDCT_RUN, *J.COLOR_TILE)
    assert J.islow_pass1_l1() == 61214
    assert defined["IDCT32_MAX"] == J.IDCT32_MAX == (2 ** 31 - 1 - 1024) // 61214
    assert 61214 * (J.IDCT32_MAX + 1) + 1024 >= 2 ** 31


@pytest.mark.parametrize("case", ["fixtures", "edge frames"])
def test_color_tiled_model_equals_plain(case, edge_batch):
    """The colour kernel's design (tiles of COLOR_TILE, each component's
    window with a one-sample halo replicated at its real edges, the h2v2
    column sums) equals color_plain bit for bit: the fixtures (baseline and
    progressive, one batch) and the edge frames (one mixed batch)."""
    if case == "fixtures":
        host, _, planes, bad = _decoded(sorted(str(p) for p in FIXTURES.glob("*.jpg")))
    else:
        host, _, planes, bad = edge_batch
        fancy = {(rh, rv, fancy) for _, _, _, _, rh, rv, fancy, _ in host.plane.tolist()}
        assert {(1, 1, 1), (2, 2, 1), (2, 1, 1), (1, 2, 1), (2, 2, 0), (2, 1, 0)} <= fancy
    assert not bad
    n_tiles = sum(-(-H // J.COLOR_TILE[0]) * -(-W // J.COLOR_TILE[1])
                  for H, W, *_ in host.frame.tolist())
    assert host.color_tiles.shape == (n_tiles, J.COLOR_TILE_WORDS)
    assert torch.equal(J.color_tiled_model(planes, host), J.color_plain(planes, host))


@pytest.mark.parametrize("case", ["fixtures", "edge frames", "extreme blocks", "damaged files"])
def test_idct_int32_model_equals_plain(case, edge_batch, tmp_path):
    """The IDCT kernel's design (runs along block rows, pass 1 in 32 bits
    for columns under IDCT32_MAX and in 64 above, pass 2 in 32 bits) equals
    idct_plain bit for bit; no column of the 32-bit route leaves int32, and
    pass 2's 32-bit digits are int64's."""
    from rodynrf_tpu_torch.testing import damaged_jpegs

    if case == "edge frames":
        host, coef, planes, _ = edge_batch
    else:
        paths = sorted(str(p) for p in FIXTURES.glob("*.jpg"))
        if case == "damaged files":
            paths = damaged_jpegs(paths, str(tmp_path), seed=14)
        host, coef, planes, bad = _decoded(paths)
        assert bad == (case == "damaged files")
        if case == "extreme blocks":
            coef, host = extreme_idct_blocks(host, seed=14)
            planes = J.idct_plain(coef, host)
    got, info = J.idct_int32_model(coef, host)
    assert torch.equal(got, planes)
    assert info["overflow32"] == 0 and info["wrong_pass2"] == 0
    assert info["columns32"] + info["columns64"] == 8 * host.n_blocks
    if case == "extreme blocks":  # both routes taken, and the 64-bit one needed
        assert info["columns32"] > 0 and info["wrong32"] > 0
    elif case != "damaged files":  # valid 8-bit data stays far below the bound
        assert info["columns64"] == 0


def test_idct_int32_route_at_the_bound():
    """Columns at the route's edge alone (every other coefficient 0): the
    largest product under IDCT32_MAX in the signs of pass 1's worst row
    stays in 32 bits and is exact; one just past it goes to 64 bits, where
    the 32-bit sums would have wrapped; the planes equal idct_plain's."""
    host, *_ = _decoded([str(FIXTURES / BASELINE[0])])
    coef, host = extreme_idct_blocks(host, seed=1)
    edge = torch.zeros_like(coef)
    firsts = [b for b, b1 in zip(host.plane_block0.tolist(), host.plane_block0.tolist()[1:])
              if b1 - b >= 2]
    for b in firsts:
        edge[b:b + 2, 0::8] = coef[b:b + 2, 0::8]
    assert {int(edge[b, 0::8].abs().max()) for b in firsts} == {17540}
    got, info = J.idct_int32_model(edge, host)
    assert torch.equal(got, J.idct_plain(edge, host))
    assert info["columns64"] == info["wrong32"] == len(firsts) and info["overflow32"] == 0
