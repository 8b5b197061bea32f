"""Batched passes (StepStatics.fused_passes, train/step.py _batched_passes)
and rematerialization (StepStatics.remat) of the port, at the TINY shapes.

The batched path concatenates the passes' rows into shared field
evaluations; every op is row-wise, so values and gradients equal the
sequential path's up to float reassociation (one table-gradient call sums
what the sequential path sums over several). The tolerances are the JAX
package's own for the same contract (tests/test_fused_passes.py): loss
rtol 2e-5; metrics rtol 5e-4, atol 1e-6; every gradient 5e-4 of scale.

- The port's batched step against its sequential step, with the generator's
  draws (jitter, white-fill coins) on, for ndc with pose optimisation and
  contract without; against the JAX package's batched step in golden_det
  (float64 gradients to 1e-6 of scale as well, and the eight
  ill-conditioned leaves under test_torch_step.py's rule).
- Chunked (pass_chunk 1 and 2) against one dynamic evaluation.
- share_forward on against off in golden_det, batched and sequential (the
  JAX test's tolerances: loss 1e-6, metrics 1e-5 / 1e-8, gradients 1e-5).
- debug_nan_fill (the unread RenderOutputs fields NaN) keeps the loss and
  every gradient finite, batched and sequential.
- Batched with train-time compaction on the flat bucket against the
  sequential compacted step.
- --remat on: every gradient equals the store-mode one to 1e-6 of scale,
  sequential and batched, dense (both table-gradient Functions: the TINY
  auto layout puts the static field strided, the dynamic one merged) and
  compacted on the flat bucket (the compaction Functions).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rodynrf_tpu.train.schedule import PermutationSampler
from rodynrf_tpu.train.step import make_train_step as jmake_step
from rodynrf_tpu_torch.testing import tiny_cmd, tiny_scene, torch_threads
from rodynrf_tpu_torch.train import Trainer, parse_cmd
from rodynrf_tpu_torch.train.convert import params_to_numpy
from rodynrf_tpu_torch.train.step import make_train_step
from test_torch_compact_train import _slab_volume
from test_torch_step import ILL_CONDITIONED, IT, _jax_grads, _leaves, _rel, _to_f64, _trainers


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def _trainer(ray_type="ndc", optimize=1, golden_det=1, extra=""):
    args = parse_cmd(tiny_cmd(ray_type, optimize) + extra)
    args.golden_det = golden_det
    tr = Trainer(args, tiny_scene(ray_type), device="cpu")
    ps = PermutationSampler(tr.scene.n_rays, args.batch_size, 7)
    return tr, torch.as_tensor(ps.nextids()), torch.as_tensor(ps.nextids())


def _step(tr, ri, rr, data=None, seed=None, params=None, aabb=None, **statics):
    """(metrics as floats, {leaf path: gradient}) of one step with the
    trainer's statics replaced by `statics`; draws from a generator seeded
    `seed` (None: no generator)."""
    S = dataclasses.replace(tr.step_fn.S, **statics)
    gen = None if seed is None else torch.Generator().manual_seed(seed)
    sc = {"iteration": IT, "focal_fixed": tr.focal_fixed, **tr.schedule.scalars(IT)}
    g, m = make_train_step(S, "cpu").grads_and_metrics(
        tr.params if params is None else params, tr.aabb if aabb is None else aabb,
        tr.data if data is None else data, ri, rr, gen, sc)
    return {k: float(v) for k, v in m.items()}, dict(_leaves(params_to_numpy(g)))


def _assert_close(got, want, loss_rtol=2e-5, rtol=5e-4, atol=1e-6, grad_atol=5e-4):
    (mg, gg), (mw, gw) = got, want
    assert set(mg) == set(mw) and set(gg) == set(gw)
    np.testing.assert_allclose(mg["total_loss"], mw["total_loss"], rtol=loss_rtol)
    for k in mw:
        np.testing.assert_allclose(mg[k], mw[k], rtol=rtol, atol=atol, err_msg=k)
    worst = 0.0
    for p in gw:
        scale = max(float(np.abs(gw[p]).max()), 1e-8)
        worst = max(worst, float(np.abs(gg[p] - gw[p]).max()) / scale)
        np.testing.assert_allclose(gg[p] / scale, gw[p] / scale, atol=grad_atol, err_msg=str(p))
    return worst


@pytest.mark.parametrize("ray_type,optimize", [("ndc", 1), ("contract", 0)])
def test_fused_matches_sequential(ray_type, optimize):
    tr, ri, rr = _trainer(ray_type, optimize, golden_det=0)
    fused = _step(tr, ri, rr, seed=3, fused_passes=True)
    seq = _step(tr, ri, rr, seed=3, fused_passes=False)
    print(f"{ray_type}: batched vs sequential, worst gradient {_assert_close(fused, seq):.2e}")


def test_fused_matches_jax():
    """Against the JAX package's batched step (golden_det, the weights and
    batch of test_torch_step.py): losses and metrics at the tolerances
    above, every float64 gradient to 1e-6 of scale of the JAX x64 run, every
    float32 gradient to 5e-4 of scale; the ILL_CONDITIONED leaves of
    test_torch_step.py to 5e-4 plus twice the JAX package's own float32
    error on the leaf (its batched f32 run against its x64 run)."""
    jtr, ttr = _trainers()
    ps = PermutationSampler(jtr.scene.n_rays, jtr.args.batch_size, 7)
    ri, rr = ps.nextids(), ps.nextids()
    jstep = jmake_step(dataclasses.replace(jtr._statics(), fused_passes=True, pass_chunk=0),
                       donate=False)
    jg, jm = _jax_grads(jtr, jstep, ri, rr, jnp.float32)
    with jax.enable_x64(True):
        jg64, _ = _jax_grads(jtr, jstep, ri, rr, jnp.float64)
    jg, jg64 = dict(_leaves(jg)), dict(_leaves(jg64))
    ri_t, rr_t = torch.as_tensor(ri), torch.as_tensor(rr)
    tm, tg = _step(ttr, ri_t, rr_t, fused_passes=True, pass_chunk=0)
    data64 = {k: v.double() if v.is_floating_point() else v for k, v in ttr.data.items()}
    _, g64 = _step(ttr, ri_t, rr_t, data64, params=_to_f64(params_to_numpy(ttr.params)),
                   aabb=ttr.aabb.double(), fused_passes=True, pass_chunk=0)
    assert set(jg) == set(tg) == set(g64)
    for p in jg64:
        assert _rel(g64[p], jg64[p]) <= 1e-6, p
    jm = {k: float(v) for k, v in jm.items()}
    # the gradients are checked leaf by leaf below: give _assert_close the
    # JAX values on the ill-conditioned leaves so that it checks the rest
    close = {p: (jg[p] if p not in ILL_CONDITIONED else tg[p]) for p in jg}
    worst = _assert_close((tm, tg), (jm, close))
    for p in ILL_CONDITIONED:
        bound = 5e-4 + 2.0 * _rel(jg[p], jg64[p])
        assert _rel(tg[p], jg[p]) <= bound, (p, _rel(tg[p], jg[p]), bound)
    print(f"batched step against the JAX package's: worst well-conditioned gradient "
          f"{worst:.2e} of scale")


def test_chunked_matches_unchunked():
    tr, ri, rr = _trainer(golden_det=0)
    whole = _step(tr, ri, rr, seed=11, fused_passes=True, pass_chunk=0)
    for chunk in (1, 2):
        _assert_close(_step(tr, ri, rr, seed=11, fused_passes=True, pass_chunk=chunk), whole)


@pytest.mark.parametrize("fused", [False, True])
def test_share_forward_exact_in_det_mode(fused):
    tr, ri, rr = _trainer()
    on = _step(tr, ri, rr, fused_passes=fused, share_forward=True)
    off = _step(tr, ri, rr, fused_passes=fused, share_forward=False)
    _assert_close(on, off, loss_rtol=1e-6, rtol=1e-5, atol=1e-8, grad_atol=1e-5)


@pytest.mark.parametrize("fused", [False, True])
def test_debug_nan_fill(fused):
    """The production losses read no unfilled RenderOutputs field: with
    those fields NaN the loss, every metric and every gradient stay finite."""
    tr, ri, rr = _trainer(golden_det=0)
    metrics, grads = _step(tr, ri, rr, seed=21, fused_passes=fused, debug_nan_fill=True)
    assert np.isfinite(metrics["total_loss"])
    assert all(np.isfinite(v) for v in metrics.values())
    for path, g in grads.items():
        assert np.isfinite(g).all(), path


@pytest.fixture(scope="module")
def compacted():
    """A 32³ TINY trainer with a slab occupancy volume in `data` and K that
    holds every ray's occupied samples (test_torch_compact_train.py)."""
    tr, ri, rr = _trainer(extra=" --N_voxel_init 32768 --N_voxel_final 32768"
                                " --vm_layout strided")
    vol, K = _slab_volume(tr)
    data = dict(tr.data, alpha_volume=torch.as_tensor(vol, dtype=torch.uint8),
                alpha_aabb=tr.aabb)
    return tr, ri, rr, data, dict(use_alpha_mask=True, compact_k=K, compact_flat=K)


def test_fused_compacted_flat_matches_sequential(compacted):
    tr, ri, rr, data, masked = compacted
    _assert_close(_step(tr, ri, rr, data, fused_passes=True, **masked),
                  _step(tr, ri, rr, data, fused_passes=False, **masked))


def _remat_case(case, compacted):
    if case == "compact_flat":
        tr, ri, rr, data, masked = compacted
        return tr, ri, rr, data, masked
    tr, ri, rr = _trainer(golden_det=0)
    return tr, ri, rr, None, {}


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("case", ["dense", "compact_flat"])
def test_remat_matches_store(case, fused, compacted):
    tr, ri, rr, data, extra = _remat_case(case, compacted)
    if case == "dense":
        assert tr.table_layouts() == {"static": "strided", "dynamic": "merged"}
    store = _step(tr, ri, rr, data, seed=5, fused_passes=fused, remat=False, **extra)
    remat = _step(tr, ri, rr, data, seed=5, fused_passes=fused, remat=True, **extra)
    worst = _assert_close(remat, store, loss_rtol=1e-6, rtol=1e-6, atol=1e-9, grad_atol=1e-6)
    print(f"{case}, fused {fused}: remat against store, worst gradient {worst:.2e} of scale")

