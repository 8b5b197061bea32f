"""The port's renderer, metrics, paths and camera helpers against the JAX
package's, on the same inputs at the TINY shapes.

- The chunk renderer (`render_image`, all 8 RenderMaps) on weights made by
  the port's trainer and converted to the JAX package: f32 tables with both
  fields strided agree to 1e-5 of each map's scale, or to twice what the
  JAX renderer itself moves when the camera pose changes by one float32 ulp,
  where that is larger. The dynamic maps need it: the sample points enter
  the warp and heads through a positional encoding of up to 2^9 times the
  coordinate, and depth_d renormalizes the dynamic weights by their sum, so
  a one-ulp difference in a point moves depth_d by ~2.7e-5 and the
  blending and full rgb by ~1.4e-5 of scale in the JAX package alone (the
  port's gap is 2.6e-5 and 1.2e-5). With bf16 tables (the dynamic field
  merged, the render path's 'auto') both round the same f32 tables to bf16;
  the measured gap is at most 1.3e-5 of scale outside depth_d (2.6e-5), so
  the same rule with a base of 3e-5.
- The vis renderer (`render_image_vis`, 12 maps, the induced flows among
  them) the same way.
- psnr, rgb_ssim, flow_to_image and the depth colormap against the JAX
  package's numpy versions; generate_path, generate_follow_spiral, the
  full-image rays and the Procrustes camera alignment to 1e-6 (1e-5 for the
  alignment's float32 SVD products).
- Masked and compact rendering: test_torch_render_compact.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rodynrf_tpu.core import se3 as jse3
from rodynrf_tpu.core.rays import get_ray_directions_blender as jdirs, get_rays as jget_rays
from rodynrf_tpu.eval import metrics as jmetrics
from rodynrf_tpu.eval.paths import generate_follow_spiral as jfollow, generate_path as jpath
from rodynrf_tpu.fields.config import FieldConfig as JFieldConfig
from rodynrf_tpu.render import renderer as jrend
from rodynrf_tpu.utils.flow_viz import flow_to_image as jflow_to_image
from rodynrf_tpu_torch.core import se3 as tse3
from rodynrf_tpu_torch.core.rays import get_ray_directions_blender, get_rays
from rodynrf_tpu_torch.eval import metrics as tmetrics
from rodynrf_tpu_torch.eval.paths import generate_follow_spiral, generate_path
from rodynrf_tpu_torch.render import renderer as trend
from rodynrf_tpu_torch.testing import TINY, tiny_cmd, tiny_scene, torch_threads
from rodynrf_tpu_torch.train import Trainer, parse_cmd
from rodynrf_tpu_torch.train.convert import params_to_numpy
from rodynrf_tpu_torch.utils.flow_viz import flow_to_image

H, W = TINY["H"], TINY["W"]
TOL = {"f32_strided": 1e-5, "bf16_auto": 3e-5}

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def _setup(flags):
    tr = Trainer(parse_cmd(tiny_cmd("ndc", 1) + flags), tiny_scene("ndc"), device="cpu")
    jcfg = [JFieldConfig(**dataclasses.asdict(c)) for c in (tr.static_cfg, tr.dynamic_cfg)]
    tparams = {k: tr.params[k] for k in ("static", "dynamic")}
    jparams = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(tparams))
    rng = np.random.default_rng(0)
    poses = np.asarray(tse3.pose_to_mtx(tr.params["pose"].detach()))
    poses = poses + rng.normal(0, 0.01, poses.shape).astype(np.float32)
    return tr, jcfg, tparams, jparams, poses


@pytest.fixture(scope="module", params=["f32_strided", "bf16_auto"])
def setup(request):
    flags = {"f32_strided": " --vm_layout strided", "bf16_auto": " --bf16 1"}[request.param]
    return (request.param, *_setup(flags))


ULP = np.float32(1 + 2.0 ** -23)


def _compare(name, ours, ref, ref_ulp, base):
    """Each map within max(base, 2 × the JAX renderer's own change under a
    one-ulp change of the pose) of its scale."""
    for k in ref:
        r, o = np.asarray(ref[k]), np.asarray(ours[k])
        assert r.shape == o.shape, k
        scale = max(float(np.abs(r).max()), 1e-6)
        tol = max(base, 2 * float(np.abs(np.asarray(ref_ulp[k]) - r).max()) / scale)
        err = float(np.abs(r - o).max())
        print(f"{name} {k}: max|Δ| {err / scale:.2e} of scale (limit {tol:.2e})")
        assert err <= tol * scale, f"{name} {k}: max|Δ| {err:.3e} > {tol:.2e} × {scale:.3e}"


def test_chunk_renderer_matches_jax(setup):
    name, tr, (jst, jdy), tparams, jparams, poses = setup
    if name == "bf16_auto":
        layouts = {"static": "strided", "dynamic": "merged"}
        assert {k: v.meta["layout"] for k, v in
                zip(("static", "dynamic"), trend.make_chunk_renderer(
                    tr.static_cfg, tr.dynamic_cfg, "ndc", tr.n_samples, 0.1).pack(tparams))
                } == layouts
    step = tr.static_cfg.step_size(np.asarray(tr.scene.scene_bbox))
    ours = trend.render_image(
        trend.make_chunk_renderer(tr.static_cfg, tr.dynamic_cfg, "ndc", tr.n_samples, step),
        tparams, tr.aabb, poses[1], 20.0, -0.25, H, W, "ndc", chunk=96)
    jrender = jrend.make_chunk_renderer(jst, jdy, "ndc", tr.n_samples, step)
    ref, ref_ulp = (jrend.render_image(jrender, jparams, jnp.asarray(tr.scene.scene_bbox),
                                       jnp.asarray(pose), 20.0, -0.25, H, W, "ndc", chunk=256)
                    for pose in (poses[1], poses[1] * ULP))
    assert set(ours) == set(ref) and len(ref) == 8
    _compare(name, ours, ref, ref_ulp, TOL[name])


def test_vis_renderer_matches_jax(setup):
    name, tr, (jst, jdy), tparams, jparams, poses = setup
    step = tr.static_cfg.step_size(np.asarray(tr.scene.scene_bbox))
    rest = (poses[2], poses[0], 20.0, 0.3, H, W, "ndc")
    ours = trend.render_image_vis(
        trend.make_vis_chunk_renderer(tr.static_cfg, tr.dynamic_cfg, "ndc", tr.n_samples,
                                      step, H, W),
        tparams, tr.aabb, poses[1], *rest, chunk=96)
    jrender = jrend.make_vis_chunk_renderer(jst, jdy, "ndc", tr.n_samples, step, H, W)
    ref, ref_ulp = (jrend.render_image_vis(jrender, jparams, jnp.asarray(tr.scene.scene_bbox),
                                           pose, *rest, chunk=256)
                    for pose in (poses[1], poses[1] * ULP))
    assert set(ours) == set(ref) and len(ref) == 12
    _compare(name, ours, ref, ref_ulp, TOL[name])



@pytest.mark.parametrize("seed", [0, 1])
def test_metrics_match_jax(seed):
    rng = np.random.default_rng(seed)
    a = rng.random((23, 31, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    assert tmetrics.psnr(a, b) == jmetrics.psnr(a, b)
    assert tmetrics.rgb_ssim(a, b, 1) == jmetrics.rgb_ssim(a, b, 1)
    depth = rng.random((17, 29)).astype(np.float32) * 3
    for mm in (None, (0.5, 2.0)):
        ours, mm_o = tmetrics.visualize_depth_numpy(depth, mm)
        ref, mm_r = jmetrics.visualize_depth_numpy(depth, mm)
        assert np.allclose(mm_o, mm_r)
        # the port carries cv2's JET table (test_jet_table_matches_cv2)
        assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1
    flow = rng.normal(0, 3, (19, 27, 2)).astype(np.float32)
    np.testing.assert_array_equal(flow_to_image(flow), jflow_to_image(flow))


def test_jet_table_matches_cv2():
    """The port's JET colormap is cv2's at all 256 levels (the JAX package
    colours depth with cv2.applyColorMap), without importing cv2 itself."""
    cv2 = pytest.importorskip("cv2")
    levels = np.arange(256, dtype=np.uint8)
    want = cv2.applyColorMap(levels.reshape(256, 1), cv2.COLORMAP_JET)[:, 0, ::-1]
    np.testing.assert_array_equal(tmetrics.jet_colormap(levels), want)
    img = levels.reshape(16, 16)
    np.testing.assert_array_equal(tmetrics.jet_colormap(img),
                                  cv2.applyColorMap(img, cv2.COLORMAP_JET)[..., ::-1])


def test_lpips_without_weights_is_none(capsys):
    assert tmetrics.rgb_lpips(np.zeros((8, 8, 3)), np.zeros((8, 8, 3)), "alex") is None
    assert tmetrics.rgb_lpips(np.zeros((8, 8, 3)), np.zeros((8, 8, 3)), "alex") is None
    assert capsys.readouterr().out.count("[lpips]") <= 1


def test_paths_match_jax():
    rng = np.random.default_rng(3)
    c2ws = np.asarray(jse3.pose_to_mtx(jnp.asarray(rng.normal(size=(5, 9)).astype(np.float32))))
    for c2w in c2ws[:2]:
        ours, ref = generate_path(c2w, 400.0, 0.7, 7), jpath(c2w, 400.0, 0.7, 7)
        assert set(ours) == set(ref) == {"dolly", "zoom", "spiral", "fix_view",
                                         "change_view_time"}
        for k in ref:
            np.testing.assert_allclose(ours[k][0], ref[k][0], atol=1e-6)
            np.testing.assert_allclose(ours[k][1], ref[k][1], atol=1e-6)
    np.testing.assert_allclose(np.stack(generate_follow_spiral(c2ws, 400.0, 0.7)),
                               np.stack(jfollow(c2ws, 400.0, 0.7)), atol=1e-6)


def test_full_image_rays_match_jax():
    rng = np.random.default_rng(4)
    c2w = np.asarray(jse3.pose_to_mtx(jnp.asarray(rng.normal(size=9).astype(np.float32))))
    d_ref = jdirs(H, W + 3, (21.0, 21.0))
    d_ours = get_ray_directions_blender(H, W + 3, (21.0, 21.0))
    np.testing.assert_allclose(d_ours.numpy(), np.asarray(d_ref), atol=1e-6)
    for a, b in zip(get_rays(d_ours, torch.from_numpy(c2w)), jget_rays(d_ref, jnp.asarray(c2w))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6)


def test_camera_alignment_matches_jax():
    rng = np.random.default_rng(5)
    gt = np.asarray(jse3.pose_to_mtx(jnp.asarray(rng.normal(size=(6, 9)).astype(np.float32))))
    pred = gt + rng.normal(0, 0.05, gt.shape).astype(np.float32)
    a_ref, sim_ref = jse3.prealign_cameras(jnp.asarray(pred), jnp.asarray(gt))
    a_ours, sim_ours = tse3.prealign_cameras(torch.from_numpy(pred), torch.from_numpy(gt))
    np.testing.assert_allclose(a_ours.numpy(), np.asarray(a_ref), atol=1e-5)
    for k in ("t0", "t1", "s0", "s1", "R"):
        np.testing.assert_allclose(np.asarray(sim_ours[k]), np.asarray(sim_ref[k]), atol=1e-5)
    for o, r in zip(tse3.evaluate_camera_alignment(a_ours, torch.from_numpy(gt)),
                    jse3.evaluate_camera_alignment(a_ref, jnp.asarray(gt))):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), atol=1e-5)
