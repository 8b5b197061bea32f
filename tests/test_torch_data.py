"""The port's scene loader and LLFF helpers against the JAX package's.

- `load_nvidia_scene` on the committed golden fixture (downsample 1, GT
  poses): every SceneData field equal to the JAX loader's (floats to 1e-6,
  measured equal).
- A synthetic scene written at twice the size (48×64 -> 24×32 with
  downsample 2, so every resize of the loader runs: LANCZOS frames,
  BILINEAR masks, INTER_LINEAR disparity and flow, INTER_NEAREST flow
  masks): images and masks within 1/255, disparity and flow within 1e-5 of
  scale; the DAVIS naming (dpt/, 5-digit names) through `load_scene`.
- The LLFF pose helpers to 1e-6.
"""

import os
import shutil

import numpy as np
import pytest

from rodynrf_tpu.data import llff as jllff
from rodynrf_tpu.data.video_dataset import load_nvidia_scene as jload_nvidia
from rodynrf_tpu.data.video_dataset import load_davis_scene as jload_davis
from rodynrf_tpu_torch.data import llff as tllff
from rodynrf_tpu_torch.data.video_dataset import load_nvidia_scene, load_scene
from rodynrf_tpu_torch.testing import write_video_scene, torch_threads
from rodynrf_tpu_torch.train import config_parser

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FIXTURE = os.path.join(REPO, "golden", "out", "fixture")
FIELDS = ("rgbs", "ts", "flows_f", "flow_masks_f", "flows_b", "flow_masks_b", "disps",
          "fg_masks", "poses", "rgbs_stack", "scene_bbox")

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def _same_scene(ours, ref, tol=None):
    assert ours.img_wh == ref.img_wh and ours.n_frames == ref.n_frames
    assert ours.near_far == ref.near_far and ours.white_bg == ref.white_bg
    np.testing.assert_allclose(ours.focal, ref.focal, rtol=1e-6)
    for k in FIELDS:
        a, b = getattr(ours, k), getattr(ref, k)
        if b is None:
            assert a is None, k
            continue
        assert a.shape == b.shape and a.dtype == b.dtype, k
        atol = (tol or {}).get(k, 1e-6) * (float(np.abs(b).max()) if tol and k in tol else 1.0)
        np.testing.assert_allclose(a, b, rtol=0, atol=atol, err_msg=k)


def test_golden_fixture_loads_as_in_jax():
    kw = dict(downsample=1.0, use_disp=True, use_foreground_mask="motion_masks",
              with_gt_poses=True, ray_type="ndc")
    _same_scene(load_nvidia_scene(FIXTURE, **kw, device="cpu"), jload_nvidia(FIXTURE, **kw))


@pytest.mark.parametrize("gt_poses", [0, 1])
def test_downsampled_scene_loads_as_in_jax(tmp_path, gt_poses):
    root = str(tmp_path / "scene")
    write_video_scene(root, T=4, H=48, W=64, seed=gt_poses)
    kw = dict(downsample=2.0, use_disp=True, use_foreground_mask="motion_masks",
              with_gt_poses=bool(gt_poses), ray_type="ndc")
    ours, ref = load_nvidia_scene(root, **kw, device="cpu"), jload_nvidia(root, **kw)
    assert ours.img_wh == (32, 24)
    pix = 1.0 / 255 + 1e-7
    _same_scene(ours, ref, tol={"rgbs": pix, "rgbs_stack": pix, "fg_masks": pix,
                                "disps": 1e-5, "flows_f": 1e-5, "flows_b": 1e-5})


def test_davis_layout_through_load_scene(tmp_path):
    src = str(tmp_path / "nv")
    write_video_scene(src, T=3, H=24, W=32)
    root = tmp_path / "davis"
    shutil.copytree(os.path.join(src, "images"), root / "images")
    shutil.copytree(os.path.join(src, "motion_masks"), root / "motion_masks")
    os.makedirs(root / "dpt")
    os.makedirs(root / "flow")
    for t in range(3):
        shutil.copy(os.path.join(src, "disp", f"{t:03d}.npy"), root / "dpt" / f"{t:05d}.npy")
        for kind in ("fwd", "bwd"):
            f = os.path.join(src, "flow", f"{t:03d}_{kind}.npz")
            if os.path.exists(f):
                shutil.copy(f, root / "flow" / f"{t:05d}_{kind}.npz")
    args = config_parser(["--dataset_name", "davis", "--datadir", str(root),
                          "--downsample_train", "1", "--N_voxel_t", "3", "--use_disp", "1"])
    ours = load_scene(args, "cpu")
    ref = jload_davis(str(root), downsample=1.0, use_disp=True,
                      use_foreground_mask="motion_masks", with_gt_poses=False, ray_type="ndc")
    _same_scene(ours, ref)


def test_llff_helpers_match_jax():
    rng = np.random.default_rng(0)
    R, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    poses = np.stack([np.concatenate([R @ np.linalg.qr(rng.normal(size=(3, 3)) * 0.05
                                                       + np.eye(3))[0],
                                      rng.normal(size=(3, 1))], 1) for _ in range(6)])
    np.testing.assert_allclose(tllff.average_poses(poses), jllff.average_poses(poses), atol=1e-6)
    for a, b in zip(tllff.center_poses(poses, np.eye(4)), jllff.center_poses(poses, np.eye(4))):
        np.testing.assert_allclose(a, b, atol=1e-6)
    nf = rng.uniform(0.5, 4.0, (6, 2))
    np.testing.assert_allclose(tllff.get_spiral(poses, nf, N_views=9),
                               jllff.get_spiral(poses, nf, N_views=9), atol=1e-6)
    np.testing.assert_allclose(tllff.viewmatrix(*poses[0].T[[2, 1, 3]]),
                               jllff.viewmatrix(*poses[0].T[[2, 1, 3]]), atol=1e-6)
    flow = rng.normal(0, 2, (18, 26, 2)).astype(np.float32)
    np.testing.assert_allclose(tllff.resize_flow(flow, 9, 13), jllff.resize_flow(flow, 9, 13),
                               atol=1e-6 * np.abs(flow).max())
