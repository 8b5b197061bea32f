"""The port's motion masks (rodynrf_tpu_torch/preprocess/motion_masks.py)
against the JAX package's (rodynrf_tpu/preprocess/motion_masks.py, which
fits F with cv2's LMedS and cleans with cv2's morphology), on the CPU.

- The Sampson error of the same points and F within 1e-6 of scale.
- The opening (3×3 ellipse) and the 5×5 dilation equal cv2's bit for bit
  on random masks that touch every border (cv2 does not erode from the
  border).
- On synthetic two-view scenes (a smooth depth map seen by two cameras, an
  independently moving patch) the port's card-side LMedS gives a mask that
  agrees with the JAX package's on >= 99% of pixels, and its F leaves every
  static pixel's Sampson error under 1e-6; with every hypothesis degenerate
  (all flow equal on a 7-pixel image) no model is accepted and the error
  map is all zero, as cv2 returns no F.
- cv2's hypothesis count: RANSACUpdateNumIters(0.99, 0.45, 7, 1000) = 300.
- The semantic half: None without a Mask-RCNN model (the command line's
  case: no weights in the repository); with one (a stand-in returning
  torchvision's detection dict) the mask of the confident movable-class
  instances, as the JAX package's, and the union in the frame's mask.
"""

import cv2
import numpy as np
import pytest
import torch

from rodynrf_tpu.preprocess import motion_masks as jm
from rodynrf_tpu_torch.preprocess import motion_masks as pm
from rodynrf_tpu_torch.testing import torch_threads


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def test_uv_grid_and_sampson_error_match_jax():
    H, W = 30, 50
    np.testing.assert_array_equal(pm.get_uv_grid(H, W).numpy(), jm.get_uv_grid(H, W))
    rng = np.random.default_rng(0)
    x1 = rng.uniform(-1, 1, (500, 2)).astype(np.float32)
    x2 = (x1 + rng.normal(0, 0.05, x1.shape)).astype(np.float32)
    F = rng.normal(size=(3, 3)).astype(np.float32)
    want = jm.compute_sampson_error(x1, x2, F)
    got = pm.compute_sampson_error(torch.from_numpy(x1), torch.from_numpy(x2),
                                   torch.from_numpy(F)).numpy()
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("density", [0.3, 0.6, 0.9])
def test_morphology_matches_cv2(density):
    m = np.random.default_rng(int(10 * density)).random((31, 45)) < density
    m[0, :], m[:, -1] = True, True  # runs along the borders
    k3 = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (3, 3))
    k5 = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (5, 5))
    opened = cv2.morphologyEx(m.astype(np.uint8), cv2.MORPH_OPEN, k3).astype(bool)
    np.testing.assert_array_equal(pm.binary_opening_disk1(torch.from_numpy(m)).numpy(), opened)
    dilated = cv2.dilate(m.astype(np.uint8), k5).astype(np.float32)
    np.testing.assert_array_equal(pm.dilation_disk2(torch.from_numpy(m)).numpy(), dilated)
    for offsets, k in ((pm.ELLIPSE_3, k3), (pm.ELLIPSE_5, k5)):
        r = k.shape[0] // 2
        assert sorted(offsets) == sorted((y - r, x - r) for y, x in zip(*np.nonzero(k)))


def _two_view(H, W, seed):
    """Flow of a static scene (smooth depth, rotation + translation) with an
    independently moving patch, in pixels, and the patch's mask."""
    rng = np.random.default_rng(seed)
    uv = jm.get_uv_grid(H, W).astype(np.float64)
    yy, xx = np.meshgrid(np.linspace(0, 1, H), np.linspace(0, 1, W), indexing="ij")
    depth = 2.0 + 0.5 * np.sin(3 * xx + seed) * np.cos(2 * yy) + 0.3 * yy
    X = np.concatenate([uv * depth[..., None], depth[..., None]], -1)
    a = 0.03 + 0.02 * rng.random()
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    X2 = X @ R.T + np.array([0.06 + 0.04 * rng.random(), 0.01 * rng.random(), 0.03])
    d = X2[..., :2] / X2[..., 2:] - uv
    flow = np.stack([d[..., 0] * (W - 1) / 2, d[..., 1] * (H - 1) / 2], -1)
    moving = np.zeros((H, W), bool)
    moving[H // 3:H // 3 + H // 4, W // 2:W // 2 + W // 5] = True
    flow[moving, 1] += 6.0  # across the (near horizontal) epipolar lines
    return flow.astype(np.float32), moving


@pytest.mark.parametrize("shape", [(48, 64, 0), (72, 96, 1)])
def test_lmeds_masks_match_jax(shape):
    H, W, seed = shape
    flow, moving = _two_view(H, W, seed)
    want = jm.motion_mask_for_frame([jm.epipolar_error_map(flow, H, W)], H, W)
    err = pm.epipolar_error_map(torch.from_numpy(flow), H, W, torch.Generator().manual_seed(0))
    got = pm.motion_mask_for_frame([err], H, W).numpy()
    assert want[moving].mean() > 0.9 and want[~moving].mean() < 0.1
    assert (got == want).mean() >= 0.99

    ft = torch.from_numpy(flow)
    x1 = pm.get_uv_grid(H, W).reshape(-1, 2)
    x2 = x1 + torch.stack([2 * ft[..., 0] / (W - 1), 2 * ft[..., 1] / (H - 1)], -1).reshape(-1, 2)
    F = pm.find_fundamental_lmeds(x1, x2, torch.Generator().manual_seed(1))
    assert F.dtype == torch.float64 and abs(float(F[2, 2]) - 1.0) < 1e-12
    sampson = pm.compute_sampson_error(x1, x2, F.float()).reshape(H, W).numpy()
    assert sampson[~moving].max() < 1e-6


def test_no_model_gives_a_zero_map():
    # seven pixels in one row: every sample is collinear, no hypothesis is kept
    flow = torch.full((1, 7, 2), 1.5)
    gen = torch.Generator().manual_seed(0)
    assert pm.find_fundamental_lmeds(pm.get_uv_grid(1, 7).reshape(-1, 2),
                                     pm.get_uv_grid(1, 7).reshape(-1, 2) + 0.1, gen) is None
    err = pm.epipolar_error_map(flow, 1, 7, gen)
    assert err.shape == (1, 7) and not err.any()


def test_hypothesis_count_is_cv2s():
    assert pm.lmeds_iterations() == 300
    assert pm.lmeds_iterations(0.999999, 0.9, 7) == 1000


def test_semantic_mask_takes_the_confident_movable_instances(tmp_path):
    from rodynrf_tpu_torch.data.imageio import write_png

    path = str(tmp_path / "f.png")
    write_png(path, np.zeros((9, 16, 3), np.uint8))  # landscape: a 576 × 1024 input
    assert pm.run_semantic_segmentation(path) is None

    masks = torch.zeros(3, 1, 576, 1024)
    masks[0, 0, :10], masks[1, 0, 20:30], masks[2, 0, 40:50] = 1.0, 1.0, 1.0
    seen = []

    def model(batch):
        seen.append(tuple(batch[0].shape))
        return [{"masks": masks, "scores": torch.tensor([0.9, 0.4, 0.9]),
                 "labels": torch.tensor([1, 3, 10])}]  # person, a weak car, a traffic light

    sem = pm.run_semantic_segmentation(path, model)
    assert seen == [(3, 576, 1024)]
    assert sem[:10].all() and not sem[10:].any()
    frame = pm.motion_mask_for_frame([torch.zeros(576, 1024)], 576, 1024, torch.from_numpy(sem))
    assert frame[:10].all() and not frame[13:].any()
