"""Train-time occupancy compaction of the port (the masked step of
rodynrf_tpu_torch/train/step.py, the flat-bucket branches of
render/pipeline.py, Trainer.update_alpha_mask and its probe) against the
JAX package's, at the TINY shapes (32³ grid), golden_det, on the same
weights and ray batches.

- `update_alpha_mask()` with --compact_train 1: the same mask and the same
  bucket sizes K and F as the JAX package's trainer on the same scene and
  weights (the probe's random times come from np.random.default_rng(0) in
  both), with compaction enabled.
- The compacted step (that mask, that K, the flat bucket on) against the
  JAX package's compacted sequential step: f32 strided — every loss to
  1e-5 relative, every gradient of a float64 run to 1e-6 of scale of the
  JAX x64 run, every float32 gradient to 1e-4 of scale plus twice the JAX
  package's own f32 error on the leaf (its f32 run against its x64 run).
  That allowance is what test_torch_step.py gives its eight ill-conditioned
  leaves; here it applies to every leaf, because the masked step at 32³
  has its own set of them: the dynamic density and warp leaves whose JAX
  f32 error reaches 1e-4-1e-3 of scale (density_line 2, density_plane 1
  among them), while a well-conditioned leaf's is ~1e-7, which leaves its
  bound at 1e-4. bf16 auto — the bounds of test_torch_step_merged.py:
  losses 1e-4, tables 3e-2, every other leaf 1e-3 plus twice the JAX
  package's f32 error.
- The port's own contracts: an all-ones mask reproduces the dense step; the
  [R, K] step equals the dense-masked step when K holds every ray's
  occupied samples; the flat bucket equals the [R, K] bucket when it holds
  them all; samples past an undersized flat bucket read as empty (sigma =
  blending = 0, not feature2density(0)) and the step stays finite.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rodynrf_tpu.testing import tiny_cmd
from rodynrf_tpu.train.schedule import PermutationSampler
from rodynrf_tpu.train.step import make_train_step as jmake_step
from rodynrf_tpu_torch.fields.config import FieldConfig
from rodynrf_tpu_torch.render import pipeline as tpipe
from rodynrf_tpu_torch.testing import torch_threads
from rodynrf_tpu_torch.train.convert import params_to_numpy
from rodynrf_tpu_torch.train.step import make_train_step
from test_torch_step import IT, _jax_grads, _leaves, _rel, _to_f64
from test_torch_step_merged import _is_table, _trainers

# 32³ grid, up to 28 samples per ray; the threshold sits inside the random
# TINY fields' alpha distribution (every voxel passes the recipe's 1e-4)
CMD = (tiny_cmd("ndc", 1) + " --N_voxel_init 32768 --N_voxel_final 32768 --nSamples 64"
       " --compact_train 1 --alpha_mask_thre 0.04 --compact_quantile 0.5")
CMDS = {"f32": CMD + " --vm_layout strided", "bf16": CMD + " --bf16 1",
        # appearance compaction on the flat bucket: the flat branch of the
        # field evaluations runs on the split {"db", "app"} packs
        "app_frac": CMD + " --vm_layout strided --app_frac 0.25 --app_start 0"}
F32 = ("f32", "app_frac")  # the float32 configurations, with float64 runs


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def _batch(tr):
    ps = PermutationSampler(tr.scene.n_rays, tr.args.batch_size, 7)
    return ps.nextids(), ps.nextids()


def _port_grads(S, ttr, params, aabb, data, ri, rr):
    sc = {"iteration": IT, "focal_fixed": ttr.focal_fixed, **ttr.schedule.scalars(IT)}
    g, m = make_train_step(S, "cpu").grads_and_metrics(
        params, aabb, data, torch.as_tensor(ri), torch.as_tensor(rr), None, sc)
    return params_to_numpy(g), {k: float(v) for k, v in m.items()}


@functools.lru_cache(maxsize=None)
def _masked(name):
    """JAX and port trainers on the same weights, each after its own
    update_alpha_mask(); then one compacted step of each on the same batch,
    with the flat bucket on at the probe's F. The f32 run adds the float64
    runs of both packages; the JAX package's own f32 error per leaf
    ("noise", its f32 run against its x64 run) comes from it for both."""
    jtr, ttr = _trainers(CMDS[name])
    jtr.update_alpha_mask()
    ttr.update_alpha_mask()
    F = ttr.compact_flat or _probe_flat(ttr)
    jS = dataclasses.replace(jtr._statics(), compact_flat=F)
    tS = dataclasses.replace(ttr.step_fn.S, compact_flat=F)
    ri, rr = _batch(ttr)
    jstep = jmake_step(jS, donate=False)
    jg, jm = _jax_grads(jtr, jstep, ri, rr, jnp.float32)
    tg, tm = _port_grads(tS, ttr, ttr.params, ttr.aabb, ttr.data, ri, rr)
    out = dict(name=name, jtr=jtr, ttr=ttr, F=F, jg=dict(_leaves(jg)), tg=dict(_leaves(tg)),
               jm={k: float(v) for k, v in jm.items()}, tm=tm)
    if name in F32:
        with jax.enable_x64(True):
            jg64, _ = _jax_grads(jtr, jstep, ri, rr, jnp.float64)
        out["noise"] = {p: _rel(out["jg"][p], v) for p, v in _leaves(jg64)}
        data64 = {k: v.double() if v.is_floating_point() else v for k, v in ttr.data.items()}
        g64, _ = _port_grads(tS, ttr, _to_f64(params_to_numpy(ttr.params)), ttr.aabb.double(),
                             data64, ri, rr)
        out["jg64"], out["g64"] = dict(_leaves(jg64)), dict(_leaves(g64))
    else:
        out["noise"] = _masked("f32")["noise"]
    return out


# the app_frac case runs in test_torch_compact_train_app.py (its own f32 and
# float64 runs: a file of its own spreads the suite over the workers)
@pytest.fixture(scope="module", params=["f32", "bf16"])
def masked(request):
    return _masked(request.param)


def _probe_flat(tr):
    return tr._probe_compact_k()[1]


def test_update_alpha_mask_gives_the_jax_mask_and_buckets(masked):
    jtr, ttr = masked["jtr"], masked["ttr"]
    jv = np.asarray(jtr.alpha_mask.alpha_volume)
    tv = ttr.alpha_mask.alpha_volume.numpy()
    np.testing.assert_array_equal(tv, jv)
    assert 0.05 < tv.mean() < 0.95
    assert (ttr.compact_k, ttr.compact_flat) == (jtr.compact_k, jtr.compact_flat)
    assert 0 < ttr.compact_k < ttr.n_samples
    assert ttr.step_fn.S.use_alpha_mask and ttr.step_fn.S.alpha_shape == jtr.alpha_shape
    np.testing.assert_array_equal(ttr.data["alpha_volume"].numpy(),
                                  np.asarray(jtr.data["alpha_volume"]))
    if masked["name"] == "app_frac":  # the split packs feed the flat bucket
        assert all(isinstance(v, dict) for v in ttr.table_layouts().values())
        assert masked["F"] > 0
    # the probe itself, at a quantum of 1: every count equal
    assert ttr._probe_compact_k(quantum=1) == jtr._probe_compact_k(quantum=1)
    print(f"{masked['name']}: occupancy {tv.mean():.3f}, K={ttr.compact_k} "
          f"flat={ttr.compact_flat} (step held at flat={masked['F']}) of {ttr.n_samples}")


def test_compacted_step_losses_match_jax(masked):
    jm, tm = masked["jm"], masked["tm"]
    rtol = 1e-5 if masked["name"] in F32 else 1e-4
    assert set(jm) == set(tm) and len(jm) > 30
    for k in sorted(jm):
        np.testing.assert_allclose(tm[k], jm[k], rtol=rtol, atol=1e-9, err_msg=k)


def test_compacted_step_gradients_match_jax(masked):
    name, jg, tg, noise = masked["name"], masked["jg"], masked["tg"], masked["noise"]
    assert set(jg) == set(tg) == set(noise)
    assert {p[0] for p in jg} == {"static", "dynamic", "pose", "fov"}
    if name in F32:
        worst64 = max(_rel(masked["g64"][p], masked["jg64"][p]) for p in masked["jg64"])
        print(f"compacted step, float64: worst gradient difference {worst64:.3e} of scale")
        assert worst64 <= 1e-6
    base = 1e-4 if name in F32 else 1e-3
    worst = []
    for path in sorted(jg, key=str):
        rel = _rel(tg[path], jg[path])
        if name == "bf16" and _is_table(path):
            bound = 3e-2
        else:
            # the JAX package's own f32 error sets each leaf's allowance:
            # ~1e-7 of scale on a well-conditioned leaf, so the bound is base
            bound = base + 2.0 * noise[path]
        worst.append((rel / bound, path, rel, bound))
        assert rel <= bound, (path, rel, bound)
    for frac, path, rel, bound in sorted(worst, key=lambda x: x[0], reverse=True)[:5]:
        print(f"{name} {path}: rel {rel:.3e}, bound {bound:.3e} ({frac:.2f} of it)")
    ill = sorted((p for p in noise if noise[p] > 1e-4), key=str)
    print(f"{name}: leaves whose JAX f32 error exceeds 1e-4 of scale: {ill}")


# ---- the port's own exactness contracts (f32 strided, 16 samples per ray)

SMALL = tiny_cmd("ndc", 1) + " --N_voxel_init 32768 --N_voxel_final 32768 --vm_layout strided"


@pytest.fixture(scope="module")
def small():
    from rodynrf_tpu_torch.testing import tiny_scene
    from rodynrf_tpu_torch.train import Trainer, parse_cmd

    args = parse_cmd(SMALL)
    args.golden_det = 1
    tr = Trainer(args, tiny_scene("ndc"), device="cpu")
    ri, rr = _batch(tr)
    return tr, torch.as_tensor(ri), torch.as_tensor(rr)


def _run(small, volume, K=0, F=0, use_mask=True):
    tr, ri, rr = small
    data = dict(tr.data)
    if use_mask:
        data["alpha_volume"] = torch.as_tensor(volume, dtype=torch.uint8)
        data["alpha_aabb"] = tr.aabb
    S = dataclasses.replace(tr.step_fn.S, use_alpha_mask=use_mask, compact_k=K, compact_flat=F)
    sc = {"iteration": 5, "focal_fixed": tr.focal_fixed, **tr.schedule.scalars(5)}
    g, m = make_train_step(S, "cpu").grads_and_metrics(tr.params, tr.aabb, data, ri, rr, None,
                                                       sc)
    return {k: float(v) for k, v in m.items()}, dict(_leaves(params_to_numpy(g)))


def _slab_volume(tr, seed=3):
    """Random occupancy in the z-slices 3-5 of 8, empty elsewhere. Every NDC
    ray shares one z per sample, so no ray has more occupied samples than
    the count of samples whose nearest z voxel lies in the slab: K =
    that count holds every pass's rays."""
    T = tr.args.N_voxel_t
    vol = np.random.default_rng(seed).integers(0, 2, (8, 8, 8, T)).astype(np.uint8)
    vol[:3] = 0
    vol[6:] = 0
    z = np.linspace(-1.0, 1.0, tr.n_samples) + 1.0 / tr.n_samples  # golden_det half-bin
    gz = np.clip(np.round((z + 1.0) * 0.5 * 7), 0, 7)
    return vol, int(((gz >= 3) & (gz <= 5)).sum())


def _assert_close(a, b, rtol, grad_atol):
    (ma, ga), (mb, gb) = a, b
    for k in mb:
        np.testing.assert_allclose(ma[k], mb[k], rtol=rtol, atol=1e-7, err_msg=k)
    for p in gb:
        scale = max(float(np.abs(gb[p]).max()), 1e-8)
        np.testing.assert_allclose(ga[p] / scale, gb[p] / scale, atol=grad_atol, err_msg=str(p))


def test_ones_mask_matches_dense(small):
    tr = small[0]
    ones = np.ones((6, 6, 6, tr.args.N_voxel_t), np.uint8)
    _assert_close(_run(small, ones), _run(small, None, use_mask=False), 1e-6, 1e-5)


def test_compacted_matches_dense_masked(small):
    vol, K = _slab_volume(small[0])
    assert 0 < K < small[0].n_samples
    _assert_close(_run(small, vol, K=K), _run(small, vol), 2e-5, 5e-4)


def test_flat_matches_bucket(small):
    vol, K = _slab_volume(small[0])
    _assert_close(_run(small, vol, K=K, F=K), _run(small, vol, K=K), 2e-6, 5e-5)


def test_flat_overflow_reads_as_empty_and_stays_finite(small):
    tr = small[0]
    metrics, grads = _run(small, np.ones((8, 8, 8, tr.args.N_voxel_t), np.uint8),
                          K=tr.n_samples - 2, F=2)
    assert all(np.isfinite(v) for v in metrics.values())
    assert all(np.isfinite(g).all() for g in grads.values())
    # at the field: with softplus density (feature2density(0) > 0), the
    # samples past the bucket read sigma = blending = 0
    cfg = FieldConfig(grid_size=(8, 8, 8), t_size=4, fea2dense_act="softplus", near_far=(0, 1),
                      shading_mode="MLP_Fea_late_view", fea_pe=0)
    from rodynrf_tpu_torch.fields.dynamic import init_dynamic_field

    gen = torch.Generator().manual_seed(0)
    p = init_dynamic_field(gen, cfg)
    R, S = 6, 10
    rays = torch.cat([torch.randn((R, 3), generator=gen) * 0.1, torch.randn((R, 3),
                                                                            generator=gen)], -1)
    z = torch.sort(torch.rand((R, S), generator=gen), dim=-1).values
    xyz = rays[:, None, :3] + rays[:, None, 3:] * z[..., None]
    valid = torch.ones((R, S), dtype=torch.bool)
    aabb = torch.tensor([[-1.5, -1.67, -1.0], [1.5, 1.67, 1.0]])
    ts = torch.zeros(R)
    with torch.no_grad():
        full = tpipe.eval_dynamic_field(p, cfg, aabb, rays, ts, xyz, z, valid, flat_n=R * S)
        cut = tpipe.eval_dynamic_field(p, cfg, aabb, rays, ts, xyz, z, valid, flat_n=7)
    kept = torch.zeros(R * S, dtype=torch.bool)
    kept[:7] = True
    kept = kept.reshape(R, S)
    assert bool((cut.sigma[~kept] == 0).all()) and bool((cut.blending[~kept] == 0).all())
    assert bool((full.sigma[~kept] > 0).all())
    np.testing.assert_allclose(cut.sigma[kept].numpy(), full.sigma[kept].numpy(), rtol=1e-6)
