"""The JAX package's public helpers that the training and render paths do
not reach, ported to rodynrf_tpu_torch, against their JAX counterparts on
the same seeded inputs (the cases of tests/test_core.py, test_extras.py and
test_ops.py), on the CPU.

Tolerances: 1e-6 of each output's scale (max |x|, at least 1) for the
float32 maps (closed forms; the two libraries' sin, cos, arccos and matrix
inverse may differ in the last bits); 1e-5 where a map inverts another
(the log maps, R_to_q) or accumulates O(S²) pairs (distloss_naive);
exact for the integer and copy paths (read_pfm, temp_weights, export
lists).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rodynrf_tpu.core as jcore
import rodynrf_tpu.ops as jops
import rodynrf_tpu.render as jrender
from rodynrf_tpu.core import rays_extra as jrx
from rodynrf_tpu.core import se3 as jse3
from rodynrf_tpu.fields import dynamic as jdyn
from rodynrf_tpu.fields import static as jstat
from rodynrf_tpu.fields.config import FieldConfig as JFieldConfig
from rodynrf_tpu.ops.distortion import distloss_naive as jdistloss_naive
from rodynrf_tpu.render import flow as jflow
from rodynrf_tpu.train.schedule import temp_weights as jtemp_weights
import rodynrf_tpu_torch.core as tcore
import rodynrf_tpu_torch.eval as teval
import rodynrf_tpu_torch.fields as tfields
import rodynrf_tpu_torch.ops as tops
import rodynrf_tpu_torch.parallel as tparallel
import rodynrf_tpu_torch.render as trender
import rodynrf_tpu_torch.train as ttrain
from rodynrf_tpu_torch.core import rays_extra as trx
from rodynrf_tpu_torch.core import se3 as tse3
from rodynrf_tpu_torch.fields import dynamic as tdyn
from rodynrf_tpu_torch.fields import static as tstat
from rodynrf_tpu_torch.fields.config import FieldConfig
from rodynrf_tpu_torch.ops.distortion import distloss_naive, eff_distloss
from rodynrf_tpu_torch.render import flow as tflow
from rodynrf_tpu_torch.testing import torch_threads
from rodynrf_tpu_torch.train.convert import params_to_numpy
from rodynrf_tpu_torch.train.schedule import temp_weights

TOL, TOL_INV = 1e-6, 1e-5


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def rng():
    return np.random.default_rng(1)


def f32(a):
    return np.array(a, np.float32)


def close(ours, ref, tol=TOL):
    ours = ours.detach().numpy() if torch.is_tensor(ours) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()) if ref.size else 1.0)
    err = float(np.abs(ours - ref).max()) / scale if ref.size else 0.0
    assert np.isfinite(ours).all() and err <= tol, err


def both(fn_t, fn_j, *arrays, **kw):
    """(port output, JAX output) of the same numpy inputs."""
    return (fn_t(*[torch.from_numpy(a) for a in arrays], **kw),
            fn_j(*[jnp.asarray(a) for a in arrays], **kw))


@pytest.mark.parametrize("pkg", ["core", "ops", "render", "fields", "train", "eval",
                                 "parallel"])
def test_exports_match_jax(pkg):
    """Each subpackage exports the JAX package's public names."""
    jax_mod = __import__(f"rodynrf_tpu.{pkg}", fromlist=["_"])
    port = {"core": tcore, "ops": tops, "render": trender, "fields": tfields, "train": ttrain,
            "eval": teval, "parallel": tparallel}[pkg]
    names = [n for n in vars(jax_mod) if not n.startswith("_")
             and not isinstance(vars(jax_mod)[n], type(jcore))]
    missing = [n for n in names if not hasattr(port, n)]
    assert not missing


def _rotations(n, seed=2):
    w = f32(np.random.default_rng(seed).uniform(-1.0, 1.0, (n, 3)))
    return w, jse3.so3_to_SO3(jnp.asarray(w))


def test_pose_algebra_matches_jax():
    r = rng()
    pose9 = f32(r.standard_normal((6, 9)))
    m_t, m_j = both(tse3.pose_to_mtx, jse3.pose_to_mtx, pose9)
    close(tse3.mtx_to_pose(m_t), jse3.mtx_to_pose(m_j))
    close(tse3.pose_to_mtx(tse3.mtx_to_pose(m_t)), m_t.numpy(), TOL_INV)
    a, b, c = (f32(np.asarray(jse3.make_pose(_rotations(4, s)[1], r.standard_normal((4, 3)))))
               for s in (3, 4, 5))
    close(*both(tse3.pose_compose_pair, jse3.pose_compose_pair, a, b))
    close(tse3.pose_compose([torch.from_numpy(x) for x in (a, b, c)]),
          jse3.pose_compose([jnp.asarray(x) for x in (a, b, c)]))
    close(*both(tse3.skew, jse3.skew, f32(r.standard_normal((5, 3)))))


@pytest.mark.parametrize("scale", [1.0, 1e-5, 0.0])
def test_lie_maps_match_jax(scale):
    """exp/log on random vectors, and at and below the Taylor branch
    (θ² < 1e-8; θ = 0 exactly)."""
    r = rng()
    w = f32(r.uniform(-1.5, 1.5, (16, 3)) * scale)
    wu = np.concatenate([w, f32(r.uniform(-1, 1, (16, 3)))], -1)
    R_t, R_j = both(tse3.so3_to_SO3, jse3.so3_to_SO3, w)
    close(R_t, R_j)
    close(tse3.SO3_to_so3(R_t), jse3.SO3_to_so3(R_j), TOL_INV)
    Rt_t, Rt_j = both(tse3.se3_to_SE3, jse3.se3_to_SE3, wu)
    close(Rt_t, Rt_j)
    close(tse3.SE3_to_se3(Rt_t), jse3.SE3_to_se3(Rt_j), TOL_INV)
    for name in ("_sinc_A", "_sinc_B", "_sinc_C"):
        th = f32(np.concatenate([np.linalg.norm(w, axis=-1), [0.0, 1e-5, 1e-4, 0.5]]))
        close(*both(getattr(tse3, name), getattr(jse3, name), th))
    if scale == 1.0:  # the round trips of tests/test_core.py
        close(tse3.SO3_to_so3(R_t), w, 1e-4)
        close(tse3.SE3_to_se3(Rt_t), wu, 1e-4)


def test_quaternions_match_jax():
    R = np.concatenate([np.asarray(_rotations(8)[1]), np.eye(3, dtype=np.float32)[None]])
    q_t, q_j = both(tse3.R_to_q, jse3.R_to_q, f32(R))
    close(q_t, q_j, TOL_INV)
    assert (q_t[-1, 1:] == 0).all()  # sign(0) = 0 for the identity
    close(*both(tse3.q_to_R, jse3.q_to_R, f32(np.asarray(q_j))))
    close(tse3.q_to_R(q_t), R, 1e-4)
    q2 = f32(rng().standard_normal((9, 4)))
    close(*both(tse3.q_invert, jse3.q_invert, q2))
    close(*both(tse3.q_product, jse3.q_product, f32(np.asarray(q_j)), q2))


def test_transforms_match_jax():
    r = rng()
    pose = f32(np.asarray(jse3.make_pose(_rotations(4)[1], r.standard_normal((4, 3)))))
    X = f32(r.standard_normal((4, 10, 3)))
    close(*both(tse3.world2cam, jse3.world2cam, X, pose))
    close(tse3.world2cam(tse3.cam2world(torch.from_numpy(X), torch.from_numpy(pose)),
                         torch.from_numpy(pose)), X, 1e-5)
    intr = f32(np.tile([[100.0, 0, 16], [0, 110.0, 12], [0, 0, 1]], (4, 1, 1)))
    intr[:, 0, 0] += f32(r.uniform(0, 5, 4))
    close(*both(tse3.cam2img, jse3.cam2img, X, intr))
    close(*both(tse3.img2cam, jse3.img2cam, X, intr))
    a = f32(r.uniform(-3, 3, 7))
    for axis in "XYZ":
        close(*both(tse3.angle_to_rotation_matrix, jse3.angle_to_rotation_matrix, a, axis=axis))


def test_novel_views_and_pixel_rays_match_jax():
    r = rng()
    anchor = f32(np.asarray(jse3.make_pose(_rotations(1)[1][0], r.standard_normal(3))))
    close(tse3.get_novel_view_poses(torch.from_numpy(anchor), N=12, scale=0.7),
          jse3.get_novel_view_poses(jnp.asarray(anchor), N=12, scale=0.7))
    pose = f32(np.asarray(jse3.make_pose(_rotations(2)[1], r.standard_normal((2, 3)))))
    intr = f32(np.tile([[100.0, 0, 16], [0, 100.0, 12], [0, 0, 1]], (2, 1, 1)))
    c_t, ray_t = tse3.get_center_and_ray(24, 32, torch.from_numpy(pose), torch.from_numpy(intr))
    c_j, ray_j = jse3.get_center_and_ray(24, 32, jnp.asarray(pose), jnp.asarray(intr))
    close(c_t, c_j)
    close(ray_t, ray_j)
    depth = f32(r.uniform(1, 3, (2, 24 * 32, 1)))
    close(tse3.get_3d_points_from_depth(c_t, ray_t, torch.from_numpy(depth)),
          jse3.get_3d_points_from_depth(c_j, ray_j, jnp.asarray(depth)))
    depths = f32(r.uniform(1, 3, (2, 24 * 32, 5, 1)))
    close(tse3.get_3d_points_from_depth(c_t, ray_t, torch.from_numpy(depths), multi_samples=True),
          jse3.get_3d_points_from_depth(c_j, ray_j, jnp.asarray(depths), multi_samples=True))
    c2 = c_t + torch.tensor([0.0, 0.0, 2.0])
    cn_t, rn_t = tse3.convert_ndc(c2, ray_t, torch.from_numpy(intr), near=1.0)
    cn_j, rn_j = jse3.convert_ndc(jnp.asarray(c2.numpy()), ray_j, jnp.asarray(intr), near=1.0)
    close(cn_t, cn_j)
    close(rn_t, rn_j)


@pytest.mark.parametrize("ray_type", ["ndc", "contract"])
def test_make_rays_matches_jax(ray_type):
    r = rng()
    i, j = r.integers(0, 32, 50), r.integers(0, 24, 50)
    c2w = f32(np.asarray(jse3.make_pose(_rotations(50)[1], r.standard_normal((50, 3)))))
    focal = (f32(120.0), f32(118.0))
    ours = tcore.make_rays(torch.from_numpy(i), torch.from_numpy(j),
                           tuple(torch.tensor(f) for f in focal), (16.0, 12.0),
                           torch.from_numpy(c2w), 24, 32, ray_type)
    ref = jcore.make_rays(i, j, focal, (16.0, 12.0), jnp.asarray(c2w), 24, 32, ray_type)
    close(ours, ref)


def test_rays_extra_match_jax(tmp_path):
    r = rng()
    z = np.sort(f32(r.uniform(0, 4, (6, 9))), -1)
    cos = f32(r.uniform(0.5, 1, 6))
    close(*both(trx.depth2dist, jrx.depth2dist, z, cos))
    close(*both(trx.ndc2dist, jrx.ndc2dist, f32(r.standard_normal((6, 9, 3))), cos))

    bbox = f32([[-1, -1, -1], [1, 1, 1]])
    o = f32(r.uniform(-3, 3, (20, 3)))
    d = f32(r.standard_normal((20, 3)))
    for ours, ref in zip(trx.dda(*map(torch.from_numpy, (o, d, bbox))),
                         jrx.dda(*map(jnp.asarray, (o, d, bbox)))):
        close(ours, ref)
    rays = np.concatenate([o, d, f32(np.ones((20, 1))), f32(np.full((20, 1), 4.0))], -1)
    for kw in ({}, {"lindisp": True}, {"bbox_3d": bbox}):
        ours = trx.ray_marcher(torch.from_numpy(rays), n_samples=8,
                               **{k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v
                                  for k, v in kw.items()})
        ref = jrx.ray_marcher(jnp.asarray(rays), n_samples=8,
                              **{k: jnp.asarray(v) if isinstance(v, np.ndarray) else v
                                 for k, v in kw.items()})
        for a, b in zip(ours, ref):
            close(a, b)
    # jittered: the draws differ (generator vs key), the bins hold them
    xyz, _, _, zj = trx.ray_marcher(torch.from_numpy(rays), n_samples=8, perturb=1.0,
                                    generator=torch.Generator().manual_seed(0))
    z0 = np.asarray(jrx.ray_marcher(jnp.asarray(rays), n_samples=8)[3])
    mids = 0.5 * (z0[:, :-1] + z0[:, 1:])
    lo, hi = np.concatenate([z0[:, :1], mids], -1), np.concatenate([mids, z0[:, -1:]], -1)
    assert xyz.shape == (20, 8, 3) and ((zj.numpy() >= lo - 1e-6) & (zj.numpy() <= hi + 1e-6)).all()
    assert not np.allclose(zj.numpy(), z0)

    all_rays = f32(r.standard_normal((4, 10, 6)))
    close(*both(trx.ndc_bbox, jrx.ndc_bbox, all_rays))

    for tag, data in ((b"Pf", f32(r.standard_normal((3, 4)))),
                      (b"PF", f32(r.standard_normal((3, 4, 3))))):
        path = str(tmp_path / "x.pfm")
        with open(path, "wb") as f:
            f.write(tag + b"\n4 3\n-1.0\n")
            np.flipud(data).astype("<f4").tofile(f)
        (ours, s_t), (ref, s_j) = trx.read_pfm(path), jrx.read_pfm(path)
        np.testing.assert_array_equal(ours, ref)
        np.testing.assert_array_equal(ours, data)
        assert s_t == s_j == 1.0


def test_sample_pdf_matches_jax():
    r = rng()
    bins = np.sort(f32(r.uniform(0, 1, (5, 9))), -1)
    weights = f32(r.uniform(0, 1, (5, 8)))
    close(trx.sample_pdf(torch.from_numpy(bins), torch.from_numpy(weights), 16, det=True),
          jrx.sample_pdf(jnp.asarray(bins), jnp.asarray(weights), 16, det=True))
    # all mass in bin 6 (tests/test_extras.py), deterministic and drawn
    heavy_bins = f32(np.tile(np.linspace(0, 1, 9), (4, 1)))
    heavy = np.zeros((4, 8), np.float32)
    heavy[:, 6] = 1.0
    for kw in ({"det": True}, {"generator": torch.Generator().manual_seed(3)}):
        s = trx.sample_pdf(torch.from_numpy(heavy_bins), torch.from_numpy(heavy), 64, **kw)
        assert s.shape == (4, 64) and ((s > 0.7) & (s < 0.9)).float().mean() > 0.8


def test_distloss_naive_equals_eff_distloss_and_jax():
    r = rng()
    w = f32(r.uniform(0, 1, (6, 24)))
    w = w / w.sum(-1, keepdims=True)
    m = np.sort(f32(r.uniform(0, 1, (6, 24))), -1)
    naive = distloss_naive(torch.from_numpy(w), torch.from_numpy(m), 1.0 / 24)
    close(naive, jdistloss_naive(jnp.asarray(w), jnp.asarray(m), 1.0 / 24), TOL_INV)
    close(eff_distloss(torch.from_numpy(w), torch.from_numpy(m), 1.0 / 24), naive.numpy(), 1e-4)


def test_fused_vm_sums_match_jax_and_the_unfused_sampler():
    r = rng()
    gs, n_comp = (7, 9, 11), (4, 2, 2)
    mat, vec = ((0, 1), (0, 2), (1, 2)), (2, 1, 0)
    planes = [f32(r.standard_normal((n_comp[i], gs[mat[i][1]], gs[mat[i][0]]))) for i in range(3)]
    lines = [f32(r.standard_normal((n_comp[i], gs[vec[i]]))) for i in range(3)]
    xyz = f32(r.uniform(-1.1, 1.1, (64, 3)))
    tp, tl = [torch.from_numpy(p) for p in planes], [torch.from_numpy(x) for x in lines]
    jp, jl = [jnp.asarray(p) for p in planes], [jnp.asarray(x) for x in lines]
    fused = tops.sample_vm_sum_fused(tp, tl, torch.from_numpy(xyz), strides=(1, 2))
    close(fused, jops.sample_vm_sum_fused(jp, jl, jnp.asarray(xyz), strides=(1, 2)))
    close(fused, torch.sum(tops.sample_vm(tp, tl, torch.from_numpy(xyz), strides=(1, 2)), -1)
          .numpy(), 1e-5)
    close(tops.vm_axis_sum(tp[1], tl[1], torch.from_numpy(xyz[:, (0, 2)]),
                           torch.from_numpy(xyz[:, 1]), strides=(1, 2, 4)),
          jops.vm_axis_sum(jp[1], jl[1], jnp.asarray(xyz[:, (0, 2)]), jnp.asarray(xyz[:, 1]),
                           strides=(1, 2, 4)))


@pytest.fixture(scope="module")
def fields():
    """Random static and dynamic fields from the port's init (TINY-like
    widths), and the same trees for the JAX package."""
    cfg = FieldConfig(grid_size=(9, 10, 8), t_size=4, density_n_comp=(4, 2, 2),
                      app_n_comp=(8, 4, 4), app_dim=27, shading_mode="MLP_Fea",
                      fea2dense_act="relu", view_pe=0, fea_pe=0, featureC=32)
    gen = torch.Generator().manual_seed(0)
    st, dy = tstat.init_static_field(gen, cfg), tdyn.init_dynamic_field(gen, cfg)
    jcfg = JFieldConfig(**dataclasses.asdict(cfg))
    st_j, dy_j = (jax.tree_util.tree_map(jnp.asarray, params_to_numpy(p)) for p in (st, dy))
    return cfg, jcfg, st, dy, st_j, dy_j


def test_field_helpers_match_jax(fields):
    cfg, jcfg, st, dy, st_j, dy_j = fields
    r = rng()
    xyz_n = f32(r.uniform(-1, 1, (40, 3)))
    warped_n = f32(np.clip(xyz_n + r.normal(0, 0.05, xyz_n.shape), -1, 1))
    t = f32(r.uniform(-1, 1, 40))
    with torch.no_grad():
        close(tstat.app_feature(st, torch.from_numpy(xyz_n)),
              jstat.app_feature(st_j, jnp.asarray(xyz_n)))
        close(tstat.vector_comp_diffs(st), jstat.vector_comp_diffs(st_j))
        close(tdyn.blending_feature(dy, cfg, *map(torch.from_numpy, (xyz_n, t, warped_n))),
              jdyn.blending_feature(dy_j, jcfg, *map(jnp.asarray, (xyz_n, t, warped_n))))
        close(tdyn.app_feature(dy, cfg, torch.from_numpy(warped_n)),
              jdyn.app_feature(dy_j, jcfg, jnp.asarray(warped_n)))
        close(tdyn.blending_l1(dy, cfg), jdyn.blending_l1(dy_j, jcfg))
    aabb = f32([[-1.5, -1.7, -1.0], [1.5, 1.6, 1.2]])
    close(*both(tdyn.unnormalize_coord, jdyn.unnormalize_coord, xyz_n, aabb))
    close(tdyn.normalize_coord(tdyn.unnormalize_coord(torch.from_numpy(xyz_n),
                                                      torch.from_numpy(aabb)),
                               torch.from_numpy(aabb)), xyz_n, 1e-6)


def test_single_point_flow_matches_jax():
    r = rng()
    H, W, f = 24, 32, 30.0
    c2w = f32(np.asarray(jse3.make_pose(_rotations(10)[1], r.normal(0, 0.1, (10, 3)))))
    pt = f32(np.concatenate([r.uniform(-0.5, 0.5, (10, 2)), r.uniform(-0.5, 0.5, (10, 1))], -1))
    plane_t, disp_t = tflow.render_single_3d_point(H, W, f, torch.from_numpy(c2w),
                                                   torch.from_numpy(pt))
    plane_j, disp_j = jflow.render_single_3d_point(H, W, f, jnp.asarray(c2w), jnp.asarray(pt))
    close(plane_t, plane_j)
    close(disp_t, disp_j)
    pts_2d = f32(r.uniform(0, 32, (10, 2)))
    close(trender.induce_flow_single(H, W, f, torch.from_numpy(c2w), torch.from_numpy(pt),
                                     torch.from_numpy(pts_2d)),
          jrender.induce_flow_single(H, W, f, jnp.asarray(c2w), jnp.asarray(pt),
                                     jnp.asarray(pts_2d)))


def test_temp_weights_match_jax():
    for it in (0, 1, 999, 49999, 50000, 99999, 100000, 150000, 250001):
        assert temp_weights(it) == jtemp_weights(it)
