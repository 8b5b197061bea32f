"""The port's command line (rodynrf_tpu_torch/cli.py) end to end on the CPU,
at the golden fixture's size (4 frames of 24×32, golden/tiny.txt).

- Training writes what the JAX package's train.py writes: the .npz, the .th
  pair, imgs_test_all{,_static,_dynamic}/ with PNGs, depth .npys and
  mean.txt, and poses_bounds_RoDynRF.npy in the data directory; the
  train-time vis and the pose diagnostics run on the way.
- --render_only from the saved .npz reproduces the final evaluation's
  per-frame PSNRs exactly, and --render_path 1 writes the five path
  families.
- With an update_AlphaMask_list entry and --compact_train 1 (a 32³ grid,
  28 samples per ray, a threshold inside the random fields' alpha) the
  mask is built mid-run, the step compacts against it, the checkpoints
  carry it, and --render_only from the .npz reproduces the in-training
  evaluation's PSNRs exactly; --alpha_mask <npz> of the same mask gives
  them too with --compact_eval 1, and renders the dense masked path with
  --compact_eval 0.
- `python -m rodynrf_tpu_torch` refuses without a card. Training over
  several processes (--n_devices, --shard_grids): test_torch_parallel_cli.py.
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


MASKED = ("--update_AlphaMask_list", "2", "--compact_train", "1", "--N_voxel_init", "32768",
          "--N_voxel_final", "32768", "--nSamples", "64", "--alpha_mask_thre", "0.04",
          "--compact_quantile", "0.5", "--expname", "masked")


@pytest.fixture(scope="module")
def masked_run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli_masked")
    shutil.copytree(FIXTURE, tmp / "data")
    return tmp, main(_argv(tmp, *MASKED), device="cpu")


def test_mask_update_compacts_the_step_and_rides_the_checkpoints(masked_run):
    from rodynrf_tpu_torch.train.checkpoints import import_th, load_checkpoint

    tmp, rep = masked_run
    assert rep["compaction"]["mask"] and 0 < rep["compaction"]["k"] < 28
    assert len(rep["losses"]) == 2 and all(np.isfinite(rep["losses"]))
    assert len(rep["psnrs"]) == 4 and all(np.isfinite(rep["psnrs"]))
    exp = tmp / "log" / "masked"
    *_, mask = load_checkpoint(str(exp / "masked.npz"), return_alpha=True)
    assert mask is not None and 0 < float(mask.alpha_volume.float().mean()) < 1
    _, meta = import_th(str(exp / "masked.th"))
    assert torch.equal(meta["alpha_mask"].alpha_volume, mask.alpha_volume)


@pytest.mark.parametrize("compact", ["1", "0"])
def test_masked_checkpoint_renders_its_evaluation(masked_run, compact):
    """--render_only of the .npz (its own mask) and with --alpha_mask of the
    same mask as a standalone .npz: the evaluation's PSNRs exactly with
    --compact_eval 1 (the evaluation's own path); the dense masked path with
    --compact_eval 0."""
    from rodynrf_tpu_torch.train.checkpoints import load_checkpoint

    tmp, rep = masked_run
    exp = tmp / "log" / "masked"
    *_, mask = load_checkpoint(str(exp / "masked.npz"), return_alpha=True)
    standalone = tmp / "mask.npz"
    vol = mask.alpha_volume.numpy() > 0
    np.savez(standalone, alphaMask_shape=np.asarray(vol.shape),
             alphaMask_mask=np.packbits(vol.reshape(-1)), alphaMask_aabb=mask.aabb.numpy())
    render = ("--render_only", "1", "--render_test", "1", "--compact_eval", compact)
    own = main(_argv(tmp, *MASKED, *render), device="cpu")
    given = main(_argv(tmp, *MASKED, *render, "--alpha_mask", str(standalone)), device="cpu")
    assert own["psnrs"] == given["psnrs"]
    if compact == "1":
        assert own["psnrs"] == rep["psnrs"]
        assert own["flat_log"] and all(n < rs for n, _, rs in own["flat_log"])
    else:
        assert not own["flat_log"] and all(np.isfinite(own["psnrs"]))


def test_memory_options_through_the_cli(run, capsys):
    """--fused_passes 1 --grad_accum 2 through cli.main: the trainer takes
    the batched passes on two micro-batches of 32 rays and trains."""
    tmp, _ = run
    rep = main(_argv(tmp, "--fused_passes", "1", "--grad_accum", "2", "--expname", "fused"),
               device="cpu")
    assert len(rep["losses"]) == 2 and all(np.isfinite(rep["losses"]))  # every 2nd of 4
    assert "grad_accum 2, remat off, fused_passes 1" in capsys.readouterr().out
    assert (tmp / "log" / "fused" / "fused.npz").is_file()


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
    path of phase 7, the mesh export and LPIPS of phase 12 inside it (32×32
    frames: AlexNet's pools need 31 pixels) and the golden gates of phase 8
    run and pass here."""
    import chip_smoke as cs

    for fn in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(cs, "CLI_SCENE", dict(T=12, H=64, W=64))
    monkeypatch.setattr(cs, "CLI_VOXELS", "4096")
    per_step = {"coalesce": 15, "segsum": 0}
    monkeypatch.setattr(cs, "counters", lambda: {k: v * cs.CLI_STEPS for k, v in per_step.items()})
    rec = cs.drive_cli("cpu", per_step, (16, 16, 16), 10, device="cpu")
    assert rec["launches"] == {"coalesce": 45, "segsum": 0}
    golden = cs.golden_gates("cpu", device="cpu")
    assert golden["grad_worst_rel"] < 1e-3 and min(golden["th_render_psnr"]) >= 50.0
