"""The port's command line (rodynrf_tpu_torch/cli.py) end to end on the CPU,
at the golden fixture's size (4 frames of 24×32, golden/tiny.txt).

- Training writes what the JAX package's train.py writes: the .npz, the .th
  pair, imgs_test_all{,_static,_dynamic}/ with PNGs, depth .npys and
  mean.txt, and poses_bounds_RoDynRF.npy in the data directory; the
  train-time vis and the pose diagnostics run on the way.
- --render_only from the saved .npz reproduces the final evaluation's
  per-frame PSNRs exactly, and --render_path 1 writes the five path
  families.
- What the port does not have yet is refused with NotImplementedError
  naming its ROADMAP item: --export_mesh 1, --compact_eval 1 and
  --alpha_mask (an occupancy mask to render with), an update_AlphaMask_list
  entry inside n_iters. `python -m rodynrf_tpu_torch` refuses without a card.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from rodynrf_tpu_torch.cli import main
from rodynrf_tpu_torch.testing import torch_threads

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FIXTURE = os.path.join(REPO, "golden", "out", "fixture")
PATHS = ("dolly", "zoom", "spiral", "fix_view", "change_view_time")

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def _argv(tmp, *extra):
    return ["--config", os.path.join(REPO, "golden", "tiny.txt"), "--datadir", str(tmp / "data"),
            "--basedir", str(tmp / "log"), "--n_iters", "4", "--progress_refresh_rate", "2",
            "--no_tensorboard", "1", *extra]


@pytest.fixture(autouse=True)
def videos_by_cv2(monkeypatch):
    """mp4s through cv2's in-process writer: imageio's starts an ffmpeg
    process per video (the outputs are the same files, written faster)."""
    monkeypatch.setitem(sys.modules, "imageio", None)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli")
    shutil.copytree(FIXTURE, tmp / "data")  # the run writes poses_bounds_RoDynRF.npy there
    saved = sys.modules.get("imageio")
    sys.modules["imageio"] = None
    try:
        rep = main(_argv(tmp, "--N_vis", "2", "--vis_train_every", "4"), device="cpu")
    finally:
        if saved is None:
            del sys.modules["imageio"]
        else:
            sys.modules["imageio"] = saved
    return tmp, rep


def test_training_writes_the_reference_outputs(run):
    tmp, rep = run
    exp = tmp / "log" / "golden_tiny"
    for f in ("golden_tiny.npz", "golden_tiny.th", "golden_tiny_static.th",
              "imgs_test_all/mean.txt", "imgs_test_all/003.png", "imgs_test_all/rgbd/003.npy",
              "imgs_test_all_static/003.png", "imgs_test_all_static/rgbd/003.npy",
              "imgs_test_all_dynamic/003.png", "imgs_test_all_dynamic/003_blending.png"):
        assert (exp / f).is_file(), f
    pb = np.load(tmp / "data" / "poses_bounds_RoDynRF.npy")
    assert pb.shape == (4, 17) and np.all(np.isfinite(pb))
    assert len(rep["losses"]) == 2 and all(np.isfinite(rep["losses"]))
    assert len(rep["psnrs"]) == 4
    np.testing.assert_allclose(np.loadtxt(exp / "imgs_test_all" / "mean.txt")[0],
                               np.mean(rep["psnrs"]))


def test_render_only_reproduces_the_final_evaluation(run):
    tmp, rep = run
    again = main(_argv(tmp, "--render_only", "1", "--render_test", "1", "--render_path", "1"),
                 device="cpu")
    assert again["psnrs"] == rep["psnrs"]
    exp = tmp / "log" / "golden_tiny"
    for name in PATHS:
        n = 30 if name in ("dolly", "zoom", "spiral") else 4
        assert (exp / name / f"{n - 1:03d}.png").is_file(), name
        assert (exp / name / "video.mp4").is_file() and (exp / name / "depthvideo.mp4").is_file()
        assert len(os.listdir(exp / name / "rgbd_npy")) == n, name


@pytest.mark.parametrize("extra,match", [
    (("--export_mesh", "1"), "export_mesh"),
    (("--update_AlphaMask_list", "3"), "occupancy-mask update"),
    (("--render_only", "1", "--render_test", "1", "--compact_eval", "1", "--alpha_mask", "m.npz"),
     "compact_eval"),
    (("--render_only", "1", "--render_test", "1", "--compact_eval", "0", "--alpha_mask", "m.npz"),
     "occupancy mask"),
])
def test_unported_options_are_refused(run, extra, match):
    tmp, _ = run
    with pytest.raises(NotImplementedError, match=match) as e:
        main(_argv(tmp, *extra), device="cpu")
    assert "ROADMAP.md queue 1, item" in str(e.value)


def test_module_entry_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", "rodynrf_tpu_torch", "--config",
                          os.path.join(REPO, "golden", "tiny.txt")],
                         cwd=REPO, capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr


def test_chip_smoke_cli_and_golden_phases_rehearse_on_the_cpu(monkeypatch):
    """chip_smoke.py phases 7 and 8 at a small size on the CPU (the card's
    memory and launch counters stubbed): the CLI, render_only and resume
    path of phase 7 and the golden gates of phase 8 run and pass here."""
    import chip_smoke as cs

    for fn in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(cs, "CLI_SCENE", dict(T=12, H=36, W=64))
    monkeypatch.setattr(cs, "CLI_VOXELS", "4096")
    per_step = {"coalesce": 15, "segsum": 0}
    monkeypatch.setattr(cs, "counters", lambda: {k: v * cs.CLI_STEPS for k, v in per_step.items()})
    rec = cs.drive_cli("cpu", per_step, (16, 16, 16), 10, device="cpu")
    assert rec["launches"] == {"coalesce": 45, "segsum": 0}
    golden = cs.golden_gates("cpu", device="cpu")
    assert golden["grad_worst_rel"] < 1e-3 and min(golden["th_render_psnr"]) >= 50.0
