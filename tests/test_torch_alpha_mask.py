"""The port's occupancy mask (rodynrf_tpu_torch/fields/alpha_mask.py and the
unfused samplers of ops/grid_sample.py) against the JAX package's, on the
same inputs made from a seed.

- The unfused samplers (plane, line, VM, VM sum, trilinear volume) agree to
  1e-6 of scale in f32.
- The nearest-voxel test (4-D and flat), the dilation, the 3³ max pool and
  update_alpha_mask agree exactly (integer outputs; the pool picks an
  input).
- pack/unpack round-trips, and load_alpha_npz of the committed
  converged-scene mask equals the JAX package's load bit for bit.
- The dual-field mask build at TINY: the dense alpha agrees to 1e-5
  absolute (f32 sums in another order), and the thresholded volume agrees
  everywhere except voxels whose JAX alpha lies within that tolerance of
  the threshold (their count is printed and must be small).
- The superset property: on the dilated volume the nearest-voxel test keeps
  every sample the trilinear test keeps on the original one.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rodynrf_tpu.fields import alpha_mask as jam
from rodynrf_tpu.ops import grid_sample as jgs
from rodynrf_tpu_torch.fields import alpha_mask as tam
from rodynrf_tpu_torch.ops import grid_sample as tgs

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
COMMITTED_MASK = os.path.join(REPO, "golden", "out_quality", "no_poses", "alpha_mask.npz")
ALPHA_TOL = 1e-5


def _rel(a, ref):
    return float(np.abs(np.asarray(a) - np.asarray(ref)).max()) / max(
        float(np.abs(np.asarray(ref)).max()), 1e-30)


def _pts(rng, n, lo=-1.2, hi=1.2):
    return rng.uniform(lo, hi, (n, 3)).astype(np.float32)


@pytest.mark.parametrize("stride", [1, 2, 4])
def test_unfused_samplers_match_jax(stride):
    rng = np.random.default_rng(stride)
    planes = [rng.normal(size=(c, h, w)).astype(np.float32)
              for c, h, w in ((3, 9, 7), (2, 11, 9), (2, 11, 7))]
    lines = [rng.normal(size=(c, n)).astype(np.float32) for c, n in ((3, 11), (2, 7), (2, 9))]
    xyz = _pts(rng, 300)
    j = jgs.sample_vm([jnp.asarray(p) for p in planes], [jnp.asarray(x) for x in lines],
                      jnp.asarray(xyz), strides=(stride,))
    t = tgs.sample_vm([torch.from_numpy(p) for p in planes],
                      [torch.from_numpy(x) for x in lines], torch.from_numpy(xyz),
                      strides=(stride,))
    assert _rel(t.numpy(), j) <= 1e-6
    js = jgs.sample_vm_sum([jnp.asarray(p) for p in planes], [jnp.asarray(x) for x in lines],
                           jnp.asarray(xyz), gather_dtype=jnp.bfloat16)
    ts = tgs.sample_vm_sum([torch.from_numpy(p) for p in planes],
                           [torch.from_numpy(x) for x in lines], torch.from_numpy(xyz),
                           gather_dtype=torch.bfloat16)
    assert _rel(ts.numpy(), js) <= 1e-6


def test_sample_grid3d_matches_jax():
    rng = np.random.default_rng(0)
    vol = rng.integers(0, 2, (5, 6, 7, 3)).astype(np.uint8)
    xyz = _pts(rng, 500, -1.4, 1.4)
    j = np.asarray(jgs.sample_grid3d(jnp.asarray(vol), jnp.asarray(xyz)))
    t = tgs.sample_grid3d(torch.from_numpy(vol), torch.from_numpy(xyz)).numpy()
    np.testing.assert_allclose(t, j, atol=1e-6)
    volf = rng.normal(size=(4, 5, 6, 2)).astype(np.float32)
    j = np.asarray(jgs.sample_grid3d(jnp.asarray(volf), jnp.asarray(xyz)))
    t = tgs.sample_grid3d(torch.from_numpy(volf), torch.from_numpy(xyz)).numpy()
    assert _rel(t, j) <= 1e-6


def _mask_inputs(seed, D=9, H=7, W=11, T=5, n=2000):
    rng = np.random.default_rng(seed)
    vol = rng.integers(0, 2, (D, H, W, T)).astype(np.uint8)
    aabb = np.array([[-1.2, -0.8, -1.0], [1.1, 0.9, 1.3]], np.float32)
    xyz = rng.uniform(-1.4, 1.4, (n, 3)).astype(np.float32)
    t = rng.uniform(-1.2, 1.2, (n,)).astype(np.float32)
    return vol, aabb, xyz, t


@pytest.mark.parametrize("flat", [False, True])
def test_occupancy_nearest_matches_jax(flat):
    vol, aabb, xyz, t = _mask_inputs(1)
    shape = vol.shape if flat else None
    v = vol.reshape(-1) if flat else vol
    j = np.asarray(jam.occupancy_nearest(jnp.asarray(v), jnp.asarray(aabb), jnp.asarray(xyz),
                                         jnp.asarray(t), shape=shape))
    got = tam.occupancy_nearest(torch.from_numpy(v), torch.from_numpy(aabb),
                                torch.from_numpy(xyz), torch.from_numpy(t), shape=shape)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), j)
    assert 0 < j.sum() < j.size


def test_dilate_and_max_pool_match_jax():
    vol, *_ = _mask_inputs(2)
    sparse = (vol * (np.random.default_rng(3).random(vol.shape) > 0.8)).astype(np.uint8)
    j = np.asarray(jam.dilate_occupancy(jnp.asarray(sparse)))
    t = tam.dilate_occupancy(torch.from_numpy(sparse))
    assert t.dtype == torch.uint8
    np.testing.assert_array_equal(t.numpy(), j)
    f = np.random.default_rng(4).normal(size=(6, 5, 4, 3)).astype(np.float32)
    np.testing.assert_array_equal(tam.max_pool3d_same(torch.from_numpy(f)).numpy(),
                                  np.asarray(jam.max_pool3d_same(jnp.asarray(f))))


def test_update_alpha_mask_matches_jax():
    rng = np.random.default_rng(5)
    alpha = (rng.random((8, 7, 6, 3)) ** 40).astype(np.float32)  # mostly near 0
    aabb = np.array([[-1.5, -1.67, -1.0], [1.5, 1.67, 1.0]], np.float32)
    jm, jaabb = jam.update_alpha_mask(jnp.asarray(alpha), jnp.asarray(aabb), 0.5)
    tm, taabb = tam.update_alpha_mask(torch.from_numpy(alpha), torch.from_numpy(aabb), 0.5)
    assert tm.alpha_volume.dtype == torch.uint8
    np.testing.assert_array_equal(tm.alpha_volume.numpy(), np.asarray(jm.alpha_volume))
    np.testing.assert_allclose(taabb.numpy(), np.asarray(jaabb), rtol=1e-6)
    assert 0 < tm.alpha_volume.numpy().mean() < 1


def test_sample_alpha_matches_jax():
    vol, aabb, xyz, t = _mask_inputs(6)
    t = np.clip(t, -1, 1)
    j = np.asarray(jam.AlphaGridMask(aabb=jnp.asarray(aabb), alpha_volume=jnp.asarray(vol))
                   .sample_alpha(jnp.asarray(xyz), jnp.asarray(t)))
    got = tam.AlphaGridMask(torch.from_numpy(aabb), torch.from_numpy(vol)).sample_alpha(
        torch.from_numpy(xyz), torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(got, j, atol=1e-6)
    np.testing.assert_array_equal(got > 0, j > 0)


def test_pack_round_trip_and_committed_mask():
    vol, aabb, *_ = _mask_inputs(7)
    m = tam.AlphaGridMask(torch.from_numpy(aabb), torch.from_numpy(vol))
    packed = tam.pack_alpha(m)
    jpacked = jam.pack_alpha(jam.AlphaGridMask(aabb=jnp.asarray(aabb),
                                               alpha_volume=jnp.asarray(vol)))
    for k in packed:
        np.testing.assert_array_equal(np.asarray(packed[k]), np.asarray(jpacked[k]))
    back = tam.unpack_alpha(packed)
    np.testing.assert_array_equal(back.alpha_volume.numpy(), vol)
    np.testing.assert_array_equal(back.aabb.numpy(), aabb)

    got = tam.load_alpha_npz(COMMITTED_MASK)
    want = jam.load_alpha_npz(COMMITTED_MASK)
    assert tuple(got.alpha_volume.shape) == (192, 192, 192, 12)
    assert got.alpha_volume.dtype == torch.uint8
    np.testing.assert_array_equal(got.alpha_volume.numpy(), np.asarray(want.alpha_volume))
    np.testing.assert_array_equal(got.aabb.numpy(), np.asarray(want.aabb))
    print(f"committed mask: occupancy {got.alpha_volume.float().mean():.4f}")


@pytest.fixture(scope="module")
def tiny_pair():
    """The JAX and port TINY trainers (bf16 auto, the default recipe's
    gather dtype) on the same weights."""
    from test_torch_step_merged import _trainers
    from rodynrf_tpu_torch.testing import tiny_cmd

    return _trainers(tiny_cmd("ndc", 1) + " --bf16 1")


def test_dual_mask_build_matches_jax(tiny_pair):
    jtr, ttr = tiny_pair
    T = ttr.scene.n_frames
    gs = list(ttr.dynamic_cfg.grid_size)
    ts = np.linspace(-1.0, 1.0, T)
    params_j = {"static": jtr.params["static"], "dynamic": jtr.params["dynamic"]}
    ja = jam.dual_dense_alpha(params_j, jtr.static_cfg, jtr.dynamic_cfg,
                              np.asarray(jtr.aabb), ts, gs)
    ta = tam.dual_dense_alpha(ttr.params, ttr.static_cfg, ttr.dynamic_cfg,
                              ttr.aabb.numpy(), ts, gs).numpy()
    assert ta.shape == ja.shape == tuple(gs) + (T,)
    np.testing.assert_allclose(ta, ja, atol=ALPHA_TOL)

    # random TINY weights put every voxel above the recipe's 1e-4, so the
    # build is held at a threshold inside the alpha distribution instead
    thres = 0.12
    jm = jam.build_dual_alpha_mask(params_j, jtr.static_cfg, jtr.dynamic_cfg,
                                   np.asarray(jtr.aabb), T, thres)
    tm = tam.build_dual_alpha_mask(ttr.params, ttr.static_cfg, ttr.dynamic_cfg,
                                   ttr.aabb.numpy(), T, thres)
    jv, tv = np.asarray(jm.alpha_volume), tm.alpha_volume.numpy()
    # a voxel may flip only where the pooled JAX alpha lies within the
    # tolerance of the threshold
    pooled = np.asarray(jam.max_pool3d_same(
        jnp.clip(jnp.asarray(ja), 0, 1).transpose(2, 1, 0, 3), 3))
    band = np.abs(pooled - thres) <= ALPHA_TOL
    print(f"mask build: {tv.size} voxels, occupancy {tv.mean():.3f}, {int(band.sum())} "
          f"within {ALPHA_TOL:g} of the threshold, {int((jv != tv).sum())} differ")
    np.testing.assert_array_equal(tv[~band], jv[~band])
    assert band.sum() <= 0.01 * band.size
    assert 0.05 < tv.mean() < 0.95


def test_nearest_occupancy_superset():
    vol, aabb, xyz, t = _mask_inputs(8)
    t = np.clip(t, -1, 1)
    m = tam.AlphaGridMask(torch.from_numpy(aabb), torch.from_numpy(vol))
    x, tt = torch.from_numpy(xyz), torch.from_numpy(t)
    tri = m.sample_alpha(x, tt) > 0
    near = tam.occupancy_nearest(tam.dilate_occupancy(m.alpha_volume), m.aabb, x, tt)
    assert not bool((tri & ~near).any()), "the nearest test dropped a trilinear-kept sample"
    assert bool(tri.any()) and not bool(near.all())
    zeros = torch.zeros_like(m.alpha_volume)
    assert not bool(tam.occupancy_nearest(tam.dilate_occupancy(zeros), m.aabb, x, tt).any())
