"""The port's fields (rodynrf_tpu_torch/fields) against the JAX package's,
with the JAX weights converted by `train.convert.params_from_numpy`:
static and dynamic `all_features_fused` (values, and the dynamic one's
parameter gradients), the deformation warp, scene flow, and the dense
field evaluations of render/pipeline.py. Tolerance 1e-5 (f32 sums in
another order; the line factors are a lerp in the port, a hat-weight matmul
in the JAX package). The voxel upsample of both fields (align_corners
resize by interpolation matrices, f32 in both) at 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rodynrf_tpu.fields import FieldConfig as JCfg
from rodynrf_tpu.fields import dynamic as jdyn
from rodynrf_tpu.fields import static as jstat
from rodynrf_tpu.render import pipeline as jpipe
from rodynrf_tpu.render.sampling import sample_xyz as jsample
from rodynrf_tpu_torch.fields import FieldConfig as TCfg
from rodynrf_tpu_torch.fields import dynamic as tdyn
from rodynrf_tpu_torch.fields import static as tstat
from rodynrf_tpu_torch.render import pipeline as tpipe
from rodynrf_tpu_torch.render.sampling import sample_xyz as tsample
from rodynrf_tpu_torch.train.convert import params_from_numpy, params_to_numpy

TOL = dict(rtol=1e-5, atol=1e-5)
CFG = dict(grid_size=(8, 9, 5), t_size=4, density_n_comp=(4, 2, 2), app_n_comp=(8, 4, 4),
           fea2dense_act="relu", view_pe=0, near_far=(0.0, 1.0), vm_layout="strided")
AABB = np.array([[-1.5, -1.67, -1.0], [1.5, 1.67, 1.0]], np.float32)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def fields():
    jst_cfg = JCfg(shading_mode="MLP_Fea", fea_pe=2, **CFG)
    jdn_cfg = JCfg(shading_mode="MLP_Fea_late_view", fea_pe=0, **CFG)
    k1, k2 = jax.random.split(jax.random.PRNGKey(3))
    jst = jstat.init_static_field(k1, jst_cfg)
    jdn = jdyn.init_dynamic_field(k2, jdn_cfg)
    return dict(
        jst_cfg=jst_cfg, jdn_cfg=jdn_cfg, jst=jst, jdn=jdn,
        tst_cfg=TCfg(shading_mode="MLP_Fea", fea_pe=2, **CFG),
        tdn_cfg=TCfg(shading_mode="MLP_Fea_late_view", fea_pe=0, **CFG),
        tst=params_from_numpy(_np(jst), "cpu"), tdn=params_from_numpy(_np(jdn), "cpu"),
    )


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


def test_static_all_features_fused(fields):
    xyz = np.random.default_rng(1).uniform(-1.2, 1.2, (301, 3)).astype(np.float32)
    ws, wa = jstat.all_features_fused(fields["jst"], fields["jst_cfg"], jnp.asarray(xyz))
    gs, ga = tstat.all_features_fused(fields["tst"], fields["tst_cfg"], torch.from_numpy(xyz))
    _close(gs, ws)
    _close(ga, wa)


def test_dynamic_all_features_fused_values_and_grads(fields):
    rng = np.random.default_rng(2)
    xyz = rng.uniform(-1.0, 1.0, (211, 3)).astype(np.float32)
    xyzw = (xyz + 0.1 * rng.standard_normal(xyz.shape)).astype(np.float32)
    t = rng.uniform(-1, 1, 211).astype(np.float32)
    cts = [rng.standard_normal(s).astype(np.float32) for s in ((211,), (211,), (211, 27))]

    def jf(p):
        return jdyn.all_features_fused(p, fields["jdn_cfg"], jnp.asarray(xyz), jnp.asarray(t),
                                       jnp.asarray(xyzw))

    want, vjp = jax.vjp(jf, fields["jdn"])
    (want_g,) = vjp(tuple(jnp.asarray(c) for c in cts))
    tp = params_from_numpy(_np(fields["jdn"]), "cpu")
    got = tdyn.all_features_fused(tp, fields["tdn_cfg"], torch.from_numpy(xyz),
                                  torch.from_numpy(t), torch.from_numpy(xyzw))
    for g, w in zip(got, want):
        _close(g, w)
    torch.autograd.backward(got, [torch.from_numpy(c) for c in cts])
    got_g = params_to_numpy(jax.tree_util.tree_map(
        lambda x: torch.zeros_like(x) if x.grad is None else x.grad, tp, is_leaf=torch.is_tensor))
    for g, w in zip(jax.tree_util.tree_leaves(got_g), jax.tree_util.tree_leaves(_np(want_g))):
        scale = max(float(np.abs(w).max()), 1e-12)
        assert float(np.abs(g - w).max()) <= 1e-5 * scale + 1e-8


def test_warp_and_scene_flow(fields):
    rng = np.random.default_rng(4)
    xyz = rng.uniform(-1.5, 1.5, (6, 7, 3)).astype(np.float32)
    t = rng.uniform(-1, 1, 6).astype(np.float32)
    aabb_j, aabb_t = jnp.asarray(AABB), torch.from_numpy(AABB)
    tt = np.repeat(t, 7)
    _close(tdyn.warp_coordinate(fields["tdn"], torch.from_numpy(xyz.reshape(-1, 3)),
                                torch.from_numpy(tt), aabb_t),
           jdyn.warp_coordinate(fields["jdn"], jnp.asarray(xyz.reshape(-1, 3)),
                                jnp.asarray(tt), aabb_j))
    for g, w in zip(tdyn.scene_flow(fields["tdn"], torch.from_numpy(xyz), torch.from_numpy(t),
                                    aabb_t),
                    jdyn.scene_flow(fields["jdn"], jnp.asarray(xyz), jnp.asarray(t), aabb_j)):
        _close(g, w)
    for g, w in zip(tdyn.scene_flow_point(fields["tdn"], torch.from_numpy(xyz[:, 0]),
                                          torch.from_numpy(t), aabb_t),
                    jdyn.scene_flow_point(fields["jdn"], jnp.asarray(xyz[:, 0]),
                                          jnp.asarray(t), aabb_j)):
        _close(g, w)


def test_dense_field_evals(fields):
    """eval_static_field / eval_dynamic_field over NDC samples (render/pipeline)."""
    rng = np.random.default_rng(5)
    rays = np.concatenate([rng.uniform(-0.5, 0.5, (12, 2)), np.full((12, 1), -1.0),
                           rng.uniform(-0.3, 0.3, (12, 2)), np.full((12, 1), 2.0)],
                          -1).astype(np.float32)
    ts = rng.uniform(-1, 1, 12).astype(np.float32)
    aabb_j, aabb_t = jnp.asarray(AABB), torch.from_numpy(AABB)
    jx, jz, jv = jsample(jnp.asarray(rays), 9, "ndc", (0.0, 1.0), aabb_j, 0.1, det_jitter=True)
    tx, tz, tv = tsample(torch.from_numpy(rays), 9, "ndc", (0.0, 1.0), aabb_t, 0.1,
                         det_jitter=True)
    _close(tx, jx)
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    for name, jfn, tfn, jp, tp, jc, tc in (
        ("static", jpipe.eval_static_field, tpipe.eval_static_field,
         fields["jst"], fields["tst"], fields["jst_cfg"], fields["tst_cfg"]),
        ("dynamic", jpipe.eval_dynamic_field, tpipe.eval_dynamic_field,
         fields["jdn"], fields["tdn"], fields["jdn_cfg"], fields["tdn_cfg"]),
    ):
        want = jfn(jp, jc, aabb_j, jnp.asarray(rays), jnp.asarray(ts), jx, jz, jv, "ndc")
        got = tfn(tp, tc, aabb_t, torch.from_numpy(rays), torch.from_numpy(ts), tx, tz, tv,
                  "ndc")
        for field in got._fields:
            g, w = getattr(got, field), getattr(want, field)
            assert (g is None) == (w is None), (name, field)
            if g is not None:
                _close(g, w)


@pytest.mark.parametrize("which", ["static", "dynamic"])
def test_upsample_field_matches_jax(fields, which):
    res = (11, 14, 7)  # every axis grows, by uneven factors
    jup = {"static": jstat.upsample_static_field, "dynamic": jdyn.upsample_dynamic_field}[which]
    tup = {"static": tstat.upsample_static_field, "dynamic": tdyn.upsample_dynamic_field}[which]
    key = {"static": "st", "dynamic": "dn"}[which]
    jp, tp = fields["j" + key], fields["t" + key]
    want = _np(jup(jp, res))
    with torch.no_grad():
        got = params_to_numpy(tup(tp, res))
    got_l, want_l = jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)
    assert len(got_l) == len(want_l)
    for g, w in zip(got_l, want_l):
        assert g.shape == w.shape
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)
    assert got["density_plane"][0].shape[1:] == (res[1], res[0])
