"""The port's masked and compact renderer (rodynrf_tpu_torch/render/renderer.py
with an AlphaGridMask) against the JAX package's, at the TINY shapes, f32
tables (32³ grid, 16 samples per ray), weights made by the port's trainer
and converted to the JAX package.

- The masked dense render (`compact=False`: the trilinear early-out) and
  the compact render (the flat bucket behind the nearest-voxel selector on
  the dilated volume) of a whole frame agree with the JAX renderer's maps
  under the rule of test_torch_render.py (1e-5 of each map's scale, or
  twice what the JAX renderer itself moves under a one-ulp pose change).
- The compact render of a chunk equals the superset-masked dense oracle
  (same selector, no compaction) bit for bit, every map but delta_xyz
  (which averages over the kept samples only). A pinned bucket that holds
  every sample agrees with it to 2e-5 relative and 2e-6 absolute, the JAX
  package's bound for this contract; one of 2 slots overflows and stays
  finite. `compact` without a mask renders
  dense.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rodynrf_tpu.fields.alpha_mask import AlphaGridMask as JMask
from rodynrf_tpu.render import renderer as jrend
from rodynrf_tpu_torch.fields.alpha_mask import AlphaGridMask
from rodynrf_tpu_torch.render import renderer as trend
from rodynrf_tpu_torch.testing import TINY, torch_threads
from test_torch_render import ULP, _compare, _setup

H, W = TINY["H"], TINY["W"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def setup():
    # the 32³ grid: 16 samples per ray
    tr, jcfg, tparams, jparams, poses = _setup(
        " --vm_layout strided --N_voxel_init 32768 --N_voxel_final 32768")
    # occupancy in a z-slab of the box: every ray keeps some samples, none
    # keeps all, even after the selector's dilation
    D = 12
    vol = np.zeros((D, D, D, TINY["T"]), np.uint8)
    vol[5:7] = 1
    vol[:, :5, :, 1] = 0  # and a time slice that differs
    aabb = np.asarray(tr.scene.scene_bbox, np.float32)
    masks = (AlphaGridMask(torch.from_numpy(aabb), torch.from_numpy(vol)),
             JMask(aabb=jnp.asarray(aabb), alpha_volume=jnp.asarray(vol)))
    step = tr.static_cfg.step_size(aabb)
    return tr, jcfg, tparams, jparams, poses, masks, step


@pytest.mark.parametrize("compact", [False, True])
def test_masked_render_matches_jax(setup, compact):
    tr, (jst, jdy), tparams, jparams, poses, (tmask, jmask), step = setup
    ours_fn = trend.make_chunk_renderer(tr.static_cfg, tr.dynamic_cfg, "ndc", tr.n_samples,
                                        step, alpha_mask=tmask, compact=compact, flat_quantum=16)
    ours = trend.render_image(ours_fn, tparams, tr.aabb, poses[1], 20.0, -0.25, H, W, "ndc",
                              chunk=96)
    jrender = jrend.make_chunk_renderer(jst, jdy, "ndc", tr.n_samples, step, alpha_mask=jmask,
                                        compact=compact, flat_quantum=16)
    ref, ref_ulp = (jrend.render_image(jrender, jparams, jnp.asarray(tr.scene.scene_bbox),
                                       jnp.asarray(pose), 20.0, -0.25, H, W, "ndc", chunk=256)
                    for pose in (poses[1], poses[1] * ULP))
    if compact:  # the flat bucket ran, smaller than the chunk
        assert ours_fn.flat_log and all(n < rs for n, _, rs in ours_fn.flat_log)
    _compare(f"masked compact={compact}", ours, ref, ref_ulp, 1e-5)
    # the mask took effect: the unmasked render differs
    plain = trend.render_image(
        trend.make_chunk_renderer(tr.static_cfg, tr.dynamic_cfg, "ndc", tr.n_samples, step),
        tparams, tr.aabb, poses[1], 20.0, -0.25, H, W, "ndc", chunk=96)
    assert np.abs(plain["rgb"] - ours["rgb"]).max() > 1e-3


def _chunk(setup):
    tr, _, tparams, _, poses, (tmask, _), step = setup
    rays = trend.rays_for_view(poses[0], tr.focal_fixed, H, W, "ndc")[:128]
    ts = torch.full((rays.shape[0],), -0.5)
    comp = trend.make_chunk_renderer(tr.static_cfg, tr.dynamic_cfg, "ndc", tr.n_samples, step,
                                     alpha_mask=tmask, compact=True, flat_quantum=2)
    return tr, tparams, comp, comp.pack(tparams), rays, ts


def _maps_close(a, b, skip=("delta_xyz",), exact=False):
    for name in a._fields:
        if name in skip:
            continue
        x, y = getattr(a, name).numpy(), getattr(b, name).numpy()
        if exact:
            np.testing.assert_array_equal(x, y, err_msg=name)
        else:
            np.testing.assert_allclose(x, y, rtol=2e-5, atol=2e-6, err_msg=name)


def test_compact_equals_the_superset_oracle(setup):
    tr, tparams, comp, packs, rays, ts = _chunk(setup)
    oracle = comp.dense_superset(tparams, packs, tr.aabb, rays, ts)
    out = comp(tparams, packs, tr.aabb, rays, ts)
    N, total, RS = comp.flat_log[-1]
    assert 0 < total <= N < RS
    print(f"compact chunk: N {N} for {total} occupied of {RS}")
    _maps_close(out, oracle, exact=True)
    assert np.isfinite(out.delta_xyz.numpy()).all()


def test_pinned_buckets_exact_and_overflow(setup):
    tr, tparams, comp, packs, rays, ts = _chunk(setup)
    oracle = comp.dense_superset(tparams, packs, tr.aabb, rays, ts)
    RS = rays.shape[0] * tr.n_samples
    _maps_close(comp.flat_fn(RS)(tparams, packs, tr.aabb, rays, ts), oracle)
    small = comp.flat_fn(2)(tparams, packs, tr.aabb, rays, ts)
    for name in small._fields:
        assert np.isfinite(getattr(small, name).numpy()).all(), name


def test_compact_without_a_mask_renders_dense(setup):
    tr, _, tparams, _, poses, _, step = setup
    rays = trend.rays_for_view(poses[0], tr.focal_fixed, H, W, "ndc")[:128]
    ts = torch.full((rays.shape[0],), -0.5)
    comp = trend.make_chunk_renderer(tr.static_cfg, tr.dynamic_cfg, "ndc", tr.n_samples, step,
                                     compact=True)
    dense = trend.make_chunk_renderer(tr.static_cfg, tr.dynamic_cfg, "ndc", tr.n_samples, step)
    packs = dense.pack(tparams)
    a, b = comp(tparams, packs, tr.aabb, rays, ts), dense(tparams, packs, tr.aabb, rays, ts)
    for name in a._fields:
        np.testing.assert_array_equal(getattr(a, name).numpy(), getattr(b, name).numpy())


def test_chip_smoke_compaction_phases_rehearse_on_the_cpu(monkeypatch):
    """chip_smoke.py phases 9a-9c at a small size on the CPU (32³ grid,
    batch 64, a 12-frame 16×24 scene; the card's timers, memory and
    profiler stubbed, the kernel wrappers counted where their plain versions
    run): the mask build, the compacted step on the committed mask with its
    kernel checks at the compacted shapes, and the split packs of
    --app_frac run and pass here."""
    import time

    import chip_smoke as cs
    from rodynrf_tpu_torch.data import make_synthetic_scene
    from rodynrf_tpu_torch.ops import coalesced, segsum

    def counting(fn):
        def shim(*a, **k):
            shim.launches += 1
            return fn(*a, **k)
        shim.launches = 0
        return shim

    shim = counting(segsum.segment_rows_sum_factored)
    monkeypatch.setattr(segsum, "segment_rows_sum_factored", shim)
    monkeypatch.setattr(coalesced, "segment_rows_sum_factored", shim)
    monkeypatch.setattr(coalesced, "coalesce_table_grad",
                        counting(coalesced.coalesce_table_grad))
    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)

    def once(fn, *a, **k):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3, 0.0

    monkeypatch.setattr(cs, "median_ms", once)
    monkeypatch.setattr(cs, "profile_step", lambda tr: {
        "profiled_wall_ms": 1.0, "device_busy_ms": 0.0, "device_launches": 0,
        "table_grad_device_ms": 0.0})
    monkeypatch.setattr(cs, "WARM_STEPS", 1)
    monkeypatch.setattr(cs, "TIMED_STEPS", 1)
    small = ["--N_voxel_init", "32768", "--N_voxel_final", "32768", "--batch_size", "64",
             "--compact_quantile", "0.5"]
    for name in ("CONFIG_DEFAULT", "CONFIG_COMPACT", "CONFIG_APP"):
        monkeypatch.setattr(cs, name, getattr(cs, name) + small)
    scene = make_synthetic_scene(T=12, H=16, W=24, ray_type="ndc")
    records, info = cs.drive_compaction(scene, "cpu", device="cpu")
    compact, app = records
    assert compact["path"] == "compact" and 0 < compact["compact_k"] < compact["n_samples"]
    assert compact["launches"] == {k: 2 * v for k, v in compact["launches_per_step"].items()}
    assert all(v > 0 for v in compact["launches"].values())
    # density parts in every evaluation with a gradient, appearance parts in
    # static E and dynamic A only (the passes whose losses read rgb)
    assert app["launches_per_step"] == {"coalesce": 15 + 3, "segsum": 12 + 3}
    assert {c["field"] for c in info["compact_cases"]} == {"static", "dynamic"}
    assert len(info["compact_cases"]) == 6


def test_chip_smoke_memory_phases_rehearse_on_the_cpu(monkeypatch):
    """chip_smoke.py phases 10a-10d at a small size on the CPU (the card's
    timers, memory and profiler stubbed, the kernel wrappers counted where
    their plain versions run): the three memory paths with their resolved
    policies and launch counts, the upsample walk over the recipe's seven
    upsamples (to 32³ here, four micro-batches) with its single-batch steps,
    its save and its kernel checks, and the TINY accumulated, batched and
    rematerialized steps."""
    import chip_smoke as cs
    from rodynrf_tpu_torch.data import make_synthetic_scene
    from rodynrf_tpu_torch.ops import coalesced, segsum

    def counting(fn):
        def shim(*a, **k):
            shim.launches += 1
            return fn(*a, **k)
        shim.launches = 0
        return shim

    shim = counting(segsum.segment_rows_sum_factored)
    monkeypatch.setattr(segsum, "segment_rows_sum_factored", shim)
    monkeypatch.setattr(coalesced, "segment_rows_sum_factored", shim)
    monkeypatch.setattr(coalesced, "coalesce_table_grad",
                        counting(coalesced.coalesce_table_grad))
    for fn in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(cs, "median_ms", lambda fn, *a, **k: (fn(), (0.0, 0.0))[1])
    monkeypatch.setattr(cs, "profile_step", lambda tr: {
        "profiled_wall_ms": 1.0, "device_busy_ms": 0.0, "device_launches": 0,
        "table_grad_device_ms": 0.0})
    monkeypatch.setattr(cs, "WARM_STEPS", 1)
    monkeypatch.setattr(cs, "TIMED_STEPS", 1)
    # 4 micro-batches of 64 rays over 4 frames: every frame keeps rays (the
    # monodepth normalisation of a frame without rays has no finite
    # gradient, in the JAX package as in the port)
    small = ["--N_voxel_init", "32768", "--batch_size", "256", "--N_voxel_t", "4"]
    monkeypatch.setattr(cs, "CONFIG_MEMORY", {k: v + small for k, v in cs.CONFIG_MEMORY.items()})
    scene = make_synthetic_scene(T=4, H=16, W=24, ray_type="ndc")
    accum4, fused, remat = cs.drive_memory_paths(scene, "cpu", device="cpu")
    assert (accum4["grad_accum"], fused["fused_passes"], remat["remat"]) == (4, True, True)
    for rec in (accum4, fused, remat):
        assert rec["launches"] == {k: 2 * v for k, v in rec["launches_per_step"].items()}
    # one static and one dynamic evaluation carry gradients in a batched step
    assert fused["pass_chunk"] >= 4 and fused["launches_per_step"] == {"coalesce": 3, "segsum": 3}
    assert accum4["launches_per_step"] == {"coalesce": 4 * 15, "segsum": 4 * 12}

    monkeypatch.setattr(cs, "CONFIG_WALK", cs.CONFIG_WALK + [
        "--N_voxel_final", "32768", "--batch_size", "256", "--grad_accum", "4",
        "--N_voxel_t", "4"])
    monkeypatch.setattr(cs, "WALK_FINAL_GRID", (35, 39, 23))
    monkeypatch.setattr(cs, "WALK_STEPS", 1)
    walk, cases = cs.walk_schedule(scene, "cpu", device="cpu")
    assert len(walk["sizes"]) == 8 and walk["grad_accum"] == 4
    assert [s["grid"] for s in walk["sizes"]][::7] == [[17, 19, 11], [35, 39, 23]]
    assert walk["save_full_bytes"] > 0 and walk["launches"]["coalesce"] > 0
    assert [(r["grad_accum"], r["remat"]) for r in walk["one_batch_640"]] == [(1, True),
                                                                            (1, False)]
    assert {c["case"].split()[0] for c in cases} == {"static", "dynamic"} and len(cases) == 6
    assert all(c["M"] == 64 * walk["sizes"][-1]["n_samples"] for c in cases)

    tiny = cs.small_input_reference(device="cpu")
    assert {"accum", "fused", "remat"} <= set(tiny)
