"""The port's progressive (SOF2) JPEG decoding (rodynrf_tpu_torch/data/
jpeg.py) on the CPU, where the stages run their plain versions:

- it equals Pillow's `np.asarray(Image.open(p).convert("RGB"))` bit for bit
  on every committed progressive fixture (tests/data/jpeg, written by
  Pillow with libjpeg's standard scan script and optimised tables per
  scan: gray, 4:4:4, 4:2:2, 4:2:0 at odd sizes, 3×4, restart intervals in
  4:2:0 and 4:2:2) and on `testing.write_jpeg(progressive=...)` output under
  three scan scripts (libjpeg's standard one, spectral selection only, DC
  successive approximation from Al = 2), where it also equals the baseline
  encoding of the same image (the same quantised coefficients);
- a batch that mixes baseline and progressive frames decodes as Pillow
  decodes each, with the rounds of scans laid out as the kernel takes them;
- the DAVIS loader on a scene of progressive frames equals the JAX
  package's (PIL + LANCZOS), and `read_frames` / `image_size` read them;
- invalid progressions and scans that refer to undefined tables raise
  ValueError naming the file (the incomplete script and SOF10:
  test_torch_jpeg.py's refusal cases).
The kernel against the plain version on the card: tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch
from PIL import Image

from rodynrf_tpu.data.video_dataset import load_davis_scene as jload_davis
from rodynrf_tpu_torch.data import jpeg as J
from rodynrf_tpu_torch.data.imageio import image_size, read_frames
from rodynrf_tpu_torch.data.video_dataset import load_davis_scene
from rodynrf_tpu_torch.testing import torch_threads, write_jpeg, write_video_scene
from test_torch_jpeg import BASELINE, FIXTURES, _pil

PROGRESSIVE = sorted(p.name for p in FIXTURES.glob("progressive*.jpg"))
SCRIPTS = [True, "spectral", "dc_sa"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def test_progressive_fixtures_cover_what_the_decoder_takes():
    frames = [J.read_jpeg(str(FIXTURES / n)) for n in PROGRESSIVE]
    assert len(frames) == 8 and all(f.progressive and not f.segments for f in frames)
    kinds = {(f.comps[0].h, f.comps[0].v, len(f.comps), f.scans[0].restart > 0)
             for f in frames}
    assert {(1, 1, 1, False), (1, 1, 3, False), (2, 1, 3, False), (2, 2, 3, False),
            (2, 2, 3, True), (2, 1, 3, True)} <= kinds
    # all four scan kinds, and a 4:2:0 frame whose width is no multiple of 16
    # (luma blocks the interleaved DC scans visit and the AC scans do not)
    scans = [s for f in frames for s in f.scans]
    assert {(s.ss == 0, s.ah > 0) for s in scans} == {(True, False), (True, True),
                                                      (False, False), (False, True)}
    odd = [f for f in frames if f.comps[0].h == 2 and f.W % 16 and f.comps[0].bw * 8 > f.W]
    assert odd and any(s.units_x < f.comps[0].bw for f in odd for s in f.scans
                       if len(s.comps) == 1 and s.comps[0] == 0)


@pytest.mark.parametrize("name", PROGRESSIVE)
def test_plain_decoder_equals_pil_on_progressive_fixtures(name):
    path = str(FIXTURES / name)
    got = J.decode_jpegs([path], device="cpu")[0]
    want = _pil(path)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    assert image_size(path) == Image.open(path).size


@pytest.mark.parametrize("script", SCRIPTS, ids=["standard", "spectral", "dc_sa"])
@pytest.mark.parametrize("subsampling", ["444", "422", "420", "440", "gray"])
def test_plain_decoder_equals_pil_on_write_jpeg_progressive(subsampling, script, tmp_path):
    rng = np.random.default_rng(SCRIPTS.index(script) * 5 + ["444", "422", "420", "440",
                                                             "gray"].index(subsampling))
    paths, base = [], []
    for i, (h, w) in enumerate([(1, 1), (3, 4), (17, 23), (33, 9), (24, 40)]):
        yy, xx = np.mgrid[:h, :w]
        img = np.stack([xx * 9 + yy * 4, yy * 7, (xx * yy) % 256], -1)
        img = np.clip(img + rng.normal(0, 25, (h, w, 3)), 0, 255).astype(np.uint8)
        if subsampling == "gray":
            img = img[..., 0]
        quality, restart = (50, 95, 75)[i % 3], (0, 1, 3)[i % 3]
        sub = "444" if subsampling == "gray" else subsampling
        paths.append(str(tmp_path / f"{i}.jpg"))
        base.append(str(tmp_path / f"{i}_baseline.jpg"))
        write_jpeg(paths[-1], img, quality, sub, restart, progressive=script)
        write_jpeg(base[-1], img, quality, sub, restart)
    frames = [J.read_jpeg(p) for p in paths]
    assert all(f.progressive for f in frames)
    for path, b, got in zip(paths, base, J.decode_jpegs(paths, device="cpu")):
        np.testing.assert_array_equal(got.numpy(), _pil(path), err_msg=path)
        np.testing.assert_array_equal(got.numpy(), _pil(b), err_msg=b)


def test_mixed_batch_equals_pil():
    paths = [str(FIXTURES / n) for n in sorted(BASELINE + PROGRESSIVE)]
    host = J.pack([J.read_jpeg(p) for p in paths])
    n_prog = sum(1 for p in paths if "progressive" in p)
    # baseline segments on their own path; round k holds scan k of every
    # progressive frame (the gray fixture has 6 scans, the others 10)
    assert host.seg.shape[0] == sum(len(f.segments) for f in host.frames)
    assert len(host.rounds) == 10 and host.rounds[0][1] >= n_prog
    assert int(host.pscan.shape[0]) == sum(len(f.scans) for f in host.frames)
    rows = [int(host.pseg[s, 2]) for s in range(host.pseg.shape[0])]
    for k, (s0, n) in enumerate(host.rounds):
        f_scan = {}
        for r in rows[s0:s0 + n]:
            f_scan.setdefault(int(host.pscan[r, 0]), set()).add(r)
        for f_i, rs in f_scan.items():
            first = int((host.pscan[:, 0] == f_i).nonzero()[0])
            assert rs == {first + k}
    for path, got in zip(paths, J.decode_jpegs(paths, device="cpu")):
        np.testing.assert_array_equal(got.numpy(), _pil(path), err_msg=path)


def test_davis_progressive_scene_loads_as_in_jax(tmp_path):
    root = str(tmp_path / "davis")
    write_video_scene(root, T=4, H=48, W=64, seed=5, layout="davis", fmt="jpg",
                      progressive=True)
    frames = sorted(str(p) for p in (tmp_path / "davis" / "images").iterdir())
    assert all(J.read_jpeg(p).progressive for p in frames)
    for p, got in zip(frames, read_frames(frames, "cpu")):
        np.testing.assert_array_equal(got.numpy(), _pil(p))
        assert image_size(p) == (64, 48)
    kw = dict(downsample=2.0, use_disp=True, use_foreground_mask="epipolar_error_png",
              with_gt_poses=False, ray_type="contract")
    ours, ref = load_davis_scene(root, **kw, device="cpu"), jload_davis(root, **kw)
    assert ours.img_wh == ref.img_wh == (32, 24)
    np.testing.assert_array_equal(np.rint(ours.rgbs_stack * 255), np.rint(ref.rgbs_stack * 255))
    np.testing.assert_array_equal(ours.rgbs, ref.rgbs)


def _sos(data, k):
    """(start, end) of the k-th SOS segment's body."""
    i = -1
    for _ in range(k + 1):
        i = bytes(data).index(b"\xff\xda", i + 1)
    return i + 4, i + 2 + int.from_bytes(data[i + 2:i + 4], "big")


def _with_sos(data, k, body):
    """The file with the k-th SOS body replaced (its length field too)."""
    a, b = _sos(data, k)
    return data[:a - 2] + (len(body) + 2).to_bytes(2, "big") + body + data[b:]


@pytest.mark.parametrize("case,match", [
    ("DC scan with Se > 0", "invalid progression Ss=0 Se=5"),
    ("AC scan of two components", "invalid progression Ss=1 Se=5"),
    ("Ah not Al + 1", "invalid progression Ss=1 Se=5 Ah=3 Al=1"),
    ("Al above 13", "invalid progression Ss=1 Se=5 Ah=0 Al=14"),
    ("undefined AC table", r"Huffman table 3 \(AC\) is not defined"),
])
def test_invalid_progressions_raise(tmp_path, case, match):
    name = "progressive_rgb420_q85_37x41.jpg"
    data = bytearray((FIXTURES / name).read_bytes())
    dc = bytes(data[slice(*_sos(data, 0))])  # the interleaved DC scan: 3 components
    ac = bytes(data[slice(*_sos(data, 1))])  # Y AC 1-5, Al 2
    assert (dc[0], dc[7:]) == (3, b"\x00\x00\x01") and (ac[0], ac[3:]) == (1, b"\x01\x05\x02")
    if case == "DC scan with Se > 0":
        data = _with_sos(data, 0, dc[:8] + b"\x05" + dc[9:])
    elif case == "AC scan of two components":
        data = _with_sos(data, 1, b"\x02" + ac[1:3] + dc[3:5] + ac[3:])
    elif case == "Ah not Al + 1":
        data = _with_sos(data, 1, ac[:5] + b"\x31")
    elif case == "Al above 13":
        data = _with_sos(data, 1, ac[:5] + b"\x0e")
    else:
        data = _with_sos(data, 1, ac[:2] + bytes([(ac[2] & 0xF0) | 3]) + ac[3:])
    path = tmp_path / ("patched_" + name)
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match=match) as err:
        J.decode_jpegs([str(path)], device="cpu")
    assert path.name in str(err.value)


def test_preprocessing_commands_read_progressive_frames(tmp_path):
    """`preprocess flow | depth | mask` with --zfill 5 on a DAVIS video of
    progressive frames (random RAFT and narrow DPT checkpoints in the
    official layouts, as chip_smoke.py phase 14b writes them): every
    command reads the frames through decode_jpegs and writes what the
    loader reads, and load_scene trains on it."""
    import chip_smoke as cs
    from rodynrf_tpu_torch.data.video_dataset import load_scene
    from rodynrf_tpu_torch.preprocess import generate_depth
    from rodynrf_tpu_torch.preprocess import main as preprocess
    from rodynrf_tpu_torch.preprocess.dpt import DPTConfig
    from rodynrf_tpu_torch.train import config_parser

    root = tmp_path / "davis"
    write_video_scene(str(root), T=3, H=64, W=64, seed=6, layout="davis", fmt="jpg",
                      frames_only=True, progressive=True)
    raft = cs.write_raft_checkpoint(tmp_path / "raft.pth")
    cfg = DPTConfig(**cs.NARROW_DPT)
    cs.write_dpt_checkpoint(tmp_path / "dpt.pt", cfg, "cpu")
    data = ["--dataset_path", str(root), "--zfill", "5"]
    preprocess(["flow", *data, "--model", str(raft), "--iters", "2", "--long_side", "64"], "cpu")
    generate_depth.main([*data, "--model", str(tmp_path / "dpt.pt"), "--out_dir", "dpt"], "cpu",
                        cfg)
    preprocess(["mask", *data], "cpu")
    for sub, n in (("flow", 4), ("dpt", 3), ("epipolar_error_png", 3)):
        names = sorted(p.name for p in (root / sub).iterdir())
        assert len(names) == n and names[0].startswith("00000"), (sub, names)
    args = config_parser([*cs.DAVIS_RECIPE, "--datadir", str(root), "--N_voxel_t", "3"])
    scene = load_scene(args, "cpu")
    assert scene.n_frames == 3 and scene.img_wh == (32, 32)
    assert np.isfinite(scene.rgbs_stack).all() and np.isfinite(scene.disps).all()
