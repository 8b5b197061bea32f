"""The preprocessing's resamplers on torch tensors (rodynrf_tpu_torch/data/
imageio.py) against cv2, which the JAX package's preprocessing calls, and
the flow consistency masks (rodynrf_tpu_torch/preprocess/flow_utils.py)
against the JAX package's (cv2's remap).

- resize_area (cv2 INTER_AREA: the 960 -> 768 flow input, a non-integer
  0.8, other decimations, and enlargements) and resize_cubic (INTER_CUBIC:
  DPT's 540x960 -> 384x704 input and back) within 1e-4 of scale, gray and
  colour;
- remap_cubic (cv2.remap INTER_CUBIC, BORDER_CONSTANT 0) within 1e-4 of
  scale, with flows that push taps across every border;
- warp_flow and compute_fwdbwd_mask against rodynrf_tpu.preprocess.
  flow_utils: the warp within 1e-4 of scale, the masks equal on >= 99.9%
  of pixels;
- a uint16 image round-trips through write_png and read_png and decodes
  under cv2 (the JAX package writes its depth PNGs with cv2.imwrite) to
  the same values.
"""

import cv2
import numpy as np
import pytest
import torch

from rodynrf_tpu.preprocess import flow_utils as jflow
from rodynrf_tpu_torch.data import imageio as io
from rodynrf_tpu_torch.preprocess import flow_utils as pflow
from rodynrf_tpu_torch.testing import torch_threads

RTOL = 1e-4  # of max|cv2|: float32 sums of up to 16 taps in another order


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def _close(got, want):
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= RTOL * np.abs(want).max()


@pytest.mark.parametrize("sizes", [(540, 960, 432, 768), (540, 960, 384, 704),
                                   (37, 53, 20, 31), (33, 33, 11, 11), (20, 30, 45, 70),
                                   (40, 30, 20, 60)])
def test_area_and_cubic_resizes_match_cv2(sizes):
    h, w, H, W = sizes
    rng = np.random.default_rng(h * w + H)
    for a in (rng.uniform(0, 255, (h, w, 3)).astype(np.float32),
              rng.normal(size=(h, w)).astype(np.float32)):
        for fn, flag in ((io.resize_area, cv2.INTER_AREA), (io.resize_cubic, cv2.INTER_CUBIC)):
            _close(fn(torch.from_numpy(a), (W, H)).numpy(),
                   cv2.resize(a, (W, H), interpolation=flag))


def _flows(H, W, scale, seed):
    rng = np.random.default_rng(seed)
    fwd = rng.normal(0, scale, (H, W, 2)).astype(np.float32)
    bwd = (-fwd + rng.normal(0, 0.5 * scale, (H, W, 2))).astype(np.float32)
    return fwd, bwd


@pytest.mark.parametrize("shape", [(48, 64, 6.0), (432, 768, 30.0), (20, 24, 100.0)])
def test_remap_cubic_matches_cv2(shape):
    H, W, scale = shape
    fwd, bwd = _flows(H, W, scale, H)
    xy = fwd.copy()
    xy[..., 0] += np.arange(W)
    xy[..., 1] += np.arange(H)[:, None]
    for img in (bwd, bwd[..., 0]):
        want = cv2.remap(img, xy, None, cv2.INTER_CUBIC, borderMode=cv2.BORDER_CONSTANT)
        _close(io.remap_cubic(torch.from_numpy(img), torch.from_numpy(xy)).numpy(), want)


@pytest.mark.parametrize("shape", [(48, 64, 4.0), (270, 480, 12.0)])
def test_fwdbwd_masks_match_jax(shape):
    H, W, scale = shape
    fwd, bwd = _flows(H, W, scale, W)
    _close(pflow.warp_flow(torch.from_numpy(bwd), torch.from_numpy(fwd)).numpy(),
           jflow.warp_flow(bwd, fwd))
    want = jflow.compute_fwdbwd_mask(fwd, bwd)
    got = pflow.compute_fwdbwd_mask(torch.from_numpy(fwd), torch.from_numpy(bwd))
    for g, w in zip(got, want):
        assert g.dtype == torch.bool and 0.05 < w.mean() < 0.95
        assert (g.numpy() == w).mean() >= 0.999


def test_uint16_png_round_trips(tmp_path):
    rng = np.random.default_rng(0)
    d16 = rng.integers(0, 65536, (23, 37), dtype=np.uint16)
    d16[0, :3] = (0, 255, 65535)  # both bytes of a sample in use
    path = str(tmp_path / "d.png")
    io.write_png(path, d16)
    got = io.read_png(path)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, d16)
    np.testing.assert_array_equal(cv2.imread(path, cv2.IMREAD_UNCHANGED), d16)
    cv2_path = str(tmp_path / "cv2.png")
    cv2.imwrite(cv2_path, d16)
    np.testing.assert_array_equal(io.read_png(cv2_path), d16)
