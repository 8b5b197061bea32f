"""Appearance top-K compaction of the port (rodynrf_tpu_torch/ops/compaction.py
and the app_topk branches of render/pipeline.py) against the JAX package's
(the counterparts of tests/test_app_compaction.py), on the same weights and
rays made from a seed.

- topk_select: the same kept values and keep flags (indices may differ
  among equal weights: those carry equal values or keep = 0).
- compact_rows / expand_rows: forward bit-exact, backward each the other's
  forward.
- The compacted static and dynamic evaluations (split packs, K = 24 of 40
  samples) equal the JAX package's compacted ones: rgb, sigma and blending
  to 1e-5 of scale, weights to 4 ulps of 1.0 absolute (alpha = 1 -
  exp(-σδ) is formed next to 1, where the two libraries' f32 exp may differ
  by an ulp, 2^-23, which is large against these small weights). The
  gradient of a dual-compositor loss with respect to every parameter and
  to the rays: float64 against the JAX x64 run to 1e-6 of scale, float32
  to 1e-4 plus twice the JAX package's own float32 error on the leaf.
- Whenever every ray's above-threshold count fits the bucket, the
  compacted evaluation equals the port's own dense one, gradients too; past
  it, rgb keeps exactly the top-K rows.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rodynrf_tpu.fields.config import FieldConfig as JConfig
from rodynrf_tpu.fields.dynamic import init_dynamic_field
from rodynrf_tpu.fields.static import init_static_field
from rodynrf_tpu.ops import compaction as jc
from rodynrf_tpu.ops.compositing import raw2outputs as jraw2outputs
from rodynrf_tpu.render import pipeline as jpipe
from rodynrf_tpu_torch.fields.config import FieldConfig as TConfig
from rodynrf_tpu_torch.ops import compaction as tc
from rodynrf_tpu_torch.ops.compositing import raw2outputs as traw2outputs
from rodynrf_tpu_torch.render import pipeline as tpipe
from rodynrf_tpu_torch.train.convert import params_from_numpy, params_to_numpy

AABB = np.array([[-1.5, -1.67, -1.0], [1.5, 1.67, 1.0]], np.float32)


def _cfgs(cls, app_frac):
    base = cls(grid_size=(24, 20, 16), t_size=4, near_far=(0.0, 1.0), app_frac=app_frac)
    return (dataclasses.replace(base, shading_mode="MLP_Fea", fea_pe=2),
            dataclasses.replace(base, shading_mode="MLP_Fea_late_view", fea_pe=0))


def _batch(seed, R=48, S=40):
    rng = np.random.default_rng(seed)
    rays = np.concatenate([rng.normal(size=(R, 3)) * 0.1, rng.normal(size=(R, 3))],
                          -1).astype(np.float32)
    ts = rng.uniform(-1, 1, R).astype(np.float32)
    z = np.sort(rng.uniform(size=(R, S)), axis=-1).astype(np.float32)
    xyz = (rays[:, None, :3] + rays[:, None, 3:] * z[..., None]).astype(np.float32)
    return rays, ts, xyz, z, np.ones((R, S), bool)


def _params(seed):
    key = jax.random.PRNGKey(seed)
    st, dn = _cfgs(JConfig, 0.0)
    return {"s": jax.tree_util.tree_map(np.asarray, init_static_field(key, st)),
            "d": jax.tree_util.tree_map(np.asarray, init_dynamic_field(
                jax.random.fold_in(key, 1), dn))}


def _rel(a, ref):
    return float(np.abs(np.asarray(a) - np.asarray(ref)).max()) / max(
        float(np.abs(np.asarray(ref)).max()), 1e-12)


def test_topk_select_matches_jax():
    rng = np.random.default_rng(0)
    w = rng.random((16, 40)).astype(np.float32) ** 4
    w[:, ::7] = 0.0  # ties at zero
    ji, jk = jc.topk_select(jnp.asarray(w), 16, 1e-2)
    ti, tk = tc.topk_select(torch.from_numpy(w), 16, 1e-2)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(np.take_along_axis(w, ti.numpy(), 1),
                                  np.take_along_axis(w, np.asarray(ji), 1))
    small = np.array([[0.5, 0.0, 0.2, 1e-6, 0.3]], np.float32)
    idx, keep = tc.topk_select(torch.from_numpy(small), 3, 1e-4)
    assert set(idx[0].tolist()) == {0, 4, 2} and keep.tolist() == [[1.0, 1.0, 1.0]]
    assert float(tc.topk_select(torch.from_numpy(small), 5, 1e-4)[1].sum()) == 3.0


def test_compact_expand_forward_and_backward():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(5, 11, 3)).astype(np.float32)
    idx = np.tile(np.array([9, 0, 4, 2]), (5, 1))
    xt = torch.tensor(x, requires_grad=True)
    it = torch.from_numpy(idx)
    xk = tc.compact_rows(xt, it)
    np.testing.assert_array_equal(xk.detach().numpy(), np.asarray(
        jc.compact_rows(jnp.asarray(x), jnp.asarray(idx))))
    dense = tc.expand_rows(xk, it, 11)
    np.testing.assert_array_equal(dense.detach().numpy(), np.asarray(
        jc.expand_rows(jnp.asarray(x[:, [9, 0, 4, 2]]), jnp.asarray(idx), 11)))
    # gradients: d/dx Σ compact(x)² = expand(2 xk); d/dxk Σ expand(xk)² = 2 xk
    (g,) = torch.autograd.grad((tc.compact_rows(xt, it) ** 2).sum(), xt)
    jg = jax.grad(lambda a: jnp.sum(jc.compact_rows(a, jnp.asarray(idx)) ** 2))(jnp.asarray(x))
    np.testing.assert_array_equal(g.numpy(), np.asarray(jg))
    xk2 = torch.tensor(x[:, :4], requires_grad=True)
    (gk,) = torch.autograd.grad((tc.expand_rows(xk2, it, 11) ** 2).sum(), xk2)
    np.testing.assert_array_equal(gk.numpy(), 2 * x[:, :4])


def _loss_parts(raw2outputs, st, dn, rays):
    out = raw2outputs(st.rgb, st.sigma, dn.rgb, dn.sigma, dn.dists, dn.blending, dn.z_vals,
                      rays, is_train=False, ray_type="ndc")
    return (out.rgb_full ** 2).sum() + out.rgb_d.sum() * 0.3 + out.rgb_s.sum() * 0.7 \
        + out.depth_full.sum()


def _cast(tree, dtype):
    return jax.tree_util.tree_map(
        lambda a: a.astype(dtype) if np.issubdtype(a.dtype, np.floating) else a, tree)


def _jax_run(params, app_frac, batch, dtype=np.float32):
    """The JAX package's compacted static + dynamic evaluation and the
    gradient of the loss with respect to (params, rays), in `dtype`
    (float64 under jax.enable_x64)."""
    from rodynrf_tpu.fields.dynamic import pack_tables as dpack
    from rodynrf_tpu.fields.static import pack_tables as spack

    with jax.enable_x64(dtype == np.float64):
        rays, ts, xyz, z, rv = (jnp.asarray(a) for a in _cast(list(batch), dtype))
        aabb = jnp.asarray(AABB.astype(dtype))
        st_cfg, dn_cfg = _cfgs(JConfig, app_frac)

        def run(p, rays_in):
            st = jpipe.eval_static_field(p["s"], st_cfg, aabb, rays_in, ts, xyz, z, rv, "ndc",
                                         packed=spack(p["s"], st_cfg))
            dn = jpipe.eval_dynamic_field(p["d"], dn_cfg, aabb, rays_in, ts, xyz, z, rv, "ndc",
                                          packed=dpack(p["d"], dn_cfg))
            return st, dn

        def loss(p, r):
            st, dn = run(p, r)
            return _loss_parts(jraw2outputs, st, dn, r), (st, dn)

        jp = jax.tree_util.tree_map(jnp.asarray, _cast(params, dtype))
        g, (st, dn) = jax.jit(jax.grad(loss, argnums=(0, 1), has_aux=True))(jp, rays)
        return st, dn, jax.tree_util.tree_map(np.asarray, g)


def _port_run(params, app_frac, batch, dtype=torch.float32):
    rays, ts, xyz, z, rv = (torch.from_numpy(a) for a in batch)
    rays, ts, xyz, z = (a.to(dtype) for a in (rays, ts, xyz, z))
    rays = rays.clone().requires_grad_(True)
    st_cfg, dn_cfg = _cfgs(TConfig, app_frac)
    p = jax.tree_util.tree_map(lambda t: t.to(dtype).detach().requires_grad_(True),
                               params_from_numpy(params, "cpu"), is_leaf=torch.is_tensor)
    aabb = torch.from_numpy(AABB).to(dtype)
    st = tpipe.eval_static_field(p["s"], st_cfg, aabb, rays, ts, xyz, z, rv, "ndc")
    dn = tpipe.eval_dynamic_field(p["d"], dn_cfg, aabb, rays, ts, xyz, z, rv, "ndc")
    _loss_parts(traw2outputs, st, dn, rays).backward()
    grads = params_to_numpy(jax.tree_util.tree_map(
        lambda t: t.grad if t.grad is not None else torch.zeros_like(t), p,
        is_leaf=torch.is_tensor))
    return st, dn, (grads, rays.grad.numpy())


def _leaves(tree):
    return jax.tree_util.tree_leaves(tree)


APP_FRAC = 0.5  # K = 24 of 40: holds every above-threshold sample of the fixture


@pytest.fixture(scope="module")
def runs():
    params, batch = _params(0), _batch(0)
    return {"jax": _jax_run(params, APP_FRAC, batch),
            "jax64": _jax_run(params, APP_FRAC, batch, np.float64),
            "port": _port_run(params, APP_FRAC, batch),
            "port64": _port_run(params, APP_FRAC, batch, torch.float64),
            "dense": _port_run(params, 0.0, batch), "K": _cfgs(TConfig, APP_FRAC)[0].app_topk(40)}


@pytest.mark.parametrize("field", ["static", "dynamic"])
def test_compacted_eval_matches_jax(runs, field):
    i = 0 if field == "static" else 1
    j, t = runs["jax"][i], runs["port"][i]
    names = ["rgb", "sigma"] + (["blending"] if field == "dynamic" else [])
    for name in names:
        assert _rel(getattr(t, name).detach().numpy(), getattr(j, name)) <= 1e-5, name
    np.testing.assert_allclose(t.weights.detach().numpy(), np.asarray(j.weights), rtol=0,
                               atol=4 * 2.0 ** -23)
    assert runs["K"] == 24


def test_compacted_gradients_match_jax(runs):
    """float64: the same function, to 1e-6 of scale. float32: 1e-4 of scale
    plus twice the JAX package's own f32 error on the leaf (its f32 run
    against its x64 run): at random init the densities are thin (weights
    ~1e-4), so 1 - exp(-σδ) keeps few f32 digits and a few leaves sum
    cancelling terms."""
    (jgp, jgr), (tgp, tgr) = runs["jax"][2], runs["port"][2]
    (jgp64, jgr64), (tgp64, tgr64) = runs["jax64"][2], runs["port64"][2]
    j, t, j64, t64 = (_leaves(x) + [r] for x, r in
                      ((jgp, jgr), (tgp, tgr), (jgp64, jgr64), (tgp64, tgr64)))
    assert len(j) == len(t) == len(j64) == len(t64) > 30
    worst64 = max(_rel(b, a) for a, b in zip(j64, t64))
    worst = max(_rel(b, a) / (1e-4 + 2 * _rel(a, a64)) for a, b, a64 in zip(j, t, j64))
    print(f"compacted eval gradients: float64 worst {worst64:.2e} of scale; float32 worst "
          f"{worst:.2f} of its bound")
    assert worst64 <= 1e-6
    assert worst <= 1.0


def test_compacted_equals_dense_when_the_bucket_holds_every_sample(runs):
    for i in (0, 1):
        d, c = runs["dense"][i], runs["port"][i]
        occ = (d.weights > 1e-4).sum(-1)
        assert int(occ.max()) <= runs["K"], "fixture must fit the bucket"
        np.testing.assert_allclose(c.rgb.detach().numpy(), d.rgb.detach().numpy(), atol=1e-6)
        np.testing.assert_allclose(c.weights.detach().numpy(), d.weights.detach().numpy(),
                                   rtol=1e-5, atol=1e-9)
    (dg, dr), (cg, cr) = runs["dense"][2], runs["port"][2]
    for a, b in zip(_leaves(dg), _leaves(cg)):
        assert _rel(b, a) <= 1e-5
    assert _rel(cr, dr) <= 1e-5


def test_truncation_keeps_the_highest_weight_samples():
    params, batch = _params(2), _batch(2)
    rays, ts, xyz, z, rv = (torch.from_numpy(a) for a in batch)
    p = params_from_numpy(params, "cpu")["s"]
    dense_cfg, _ = _cfgs(TConfig, 0.0)
    cfg, _ = _cfgs(TConfig, 0.1)  # K = 8 of 40
    aabb = torch.from_numpy(AABB)
    with torch.no_grad():
        d = tpipe.eval_static_field(p, dense_cfg, aabb, rays, ts, xyz, z, rv, "ndc")
        c = tpipe.eval_static_field(p, cfg, aabb, rays, ts, xyz, z, rv, "ndc")
    K = cfg.app_topk(40)
    assert K == 8
    kept = np.zeros(d.rgb.shape[:2], bool)
    np.put_along_axis(kept, torch.topk(d.weights, K, dim=1).indices.numpy(), True, axis=1)
    np.testing.assert_allclose(c.rgb.numpy()[kept], d.rgb.numpy()[kept], atol=1e-6)
    assert np.all(c.rgb.numpy()[~kept] == 0.0)


def test_trainer_app_compaction_takes_the_jax_layouts():
    """--app_frac 0.25 --app_start 1 through the trainer (bf16 auto, the
    default recipe, TINY 32³ so that K = 8 < 16 samples): iteration 0 runs
    dense and its end turns compaction on and rebuilds the step; the split
    packs then take the JAX package's layouts, pack by pack, at the JAX
    package's weights. (The compacted evaluations themselves are held to
    the JAX package's above.)"""
    from rodynrf_tpu.fields import dynamic as jdyn
    from rodynrf_tpu.fields import static as jstat
    from rodynrf_tpu_torch.testing import tiny_cmd
    from test_torch_step_merged import _trainers

    jtr, ttr = _trainers(tiny_cmd("ndc", 1) + " --bf16 1 --N_voxel_init 32768 "
                         "--N_voxel_final 32768 --app_frac 0.25 --app_start 1")
    assert ttr.static_cfg.app_frac == 0.0 and ttr.step_fn.S.static_cfg.app_frac == 0.0
    m = ttr.run_step()
    assert all(np.isfinite(float(v)) for v in m.values())
    assert ttr.static_cfg.app_frac == ttr.step_fn.S.dynamic_cfg.app_frac == 0.25
    assert ttr.step_fn.S.dynamic_cfg.app_topk(ttr.n_samples) == 8 < ttr.n_samples
    jtr.iteration = 1
    assert jtr._refresh_app_frac()
    ttr.set_params(params_from_numpy(jax.tree_util.tree_map(np.asarray, jtr.params), "cpu"))
    jl = {"static": {k: v.meta["layout"] for k, v in
                     jstat.pack_tables(jtr.params["static"], jtr.static_cfg).items()},
          "dynamic": {k: v.meta["layout"] for k, v in
                      jdyn.pack_tables(jtr.params["dynamic"], jtr.dynamic_cfg).items()}}
    assert ttr.table_layouts() == jl
    print(f"split-pack layouts: {jl}")
    m = ttr.run_step()  # the compacted step
    assert all(np.isfinite(float(v)) for v in m.values())
