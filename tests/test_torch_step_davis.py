"""Whole-step parity for the DAVIS recipe's flags (configs/DAVIS.txt): the
port's train step against the JAX `train_loss` at the TINY shapes with
contract rays, `--fea_pe 6`, the default time-embedded static shading
(`MLP_Fea_TimeEmbedding`) and `--monodepth_weight_static 0.04`, pose and
focal optimised (f32 tables, strided layout, golden_det, identical weights
and ray batches). test_torch_step.py holds the Nvidia recipe's `ndc` step.

- Every loss term and the total agree to 1e-5 relative.
- Every parameter gradient of a float64 run of the port agrees with a
  float64 (x64) run of the JAX package to max|Δ|/max|ref| ≤ 1e-6.
- The same holds with an empty dynamic field (the density head's output
  bias lowered until relu gives σ = 0 on every sample), where each dynamic
  disparity pair |disp_A − disp_C|, |disp_A − disp_D| ties on every ray:
  the tie's subgradient reaches no parameter.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rodynrf_tpu.testing import tiny_cmd, tiny_scene as jtiny_scene
from rodynrf_tpu.train import Trainer as JTrainer, parse_cmd as jparse
from rodynrf_tpu.train.schedule import PermutationSampler
from rodynrf_tpu.train.step import make_train_step as jmake_step
import rodynrf_tpu_torch.train.step as tstep
from rodynrf_tpu_torch.testing import tiny_scene as ttiny_scene, torch_threads
from rodynrf_tpu_torch.train import Trainer as TTrainer, parse_cmd as tparse
from rodynrf_tpu_torch.train.convert import params_from_numpy, params_to_numpy

from test_torch_step import IT, _jax_grads, _leaves, _rel, _to_f64

# TINY's flags with DAVIS's in their place: fea_pe 6 (TINY: 0), the default
# static shading (TINY: MLP_Fea), monodepth_weight_static 0.04 stated
CMD = (tiny_cmd("contract", 1).replace("--shadingModeStatic MLP_Fea ", "")
       + " --fea_pe 6 --monodepth_weight_static 0.04 --vm_layout strided")
# added to the dynamic density head's output bias: relu then gives σ = 0 on
# every sample of the TINY batch, so every dynamic ray is empty
EMPTY_SHIFT = -1.0


@pytest.fixture(scope="module")
def step_pair():
    ja, ta = jparse(CMD), tparse(CMD)
    assert (ja.shadingModeStatic, ja.fea_pe, ja.ray_type) == ("MLP_Fea_TimeEmbedding", 6,
                                                              "contract")
    assert (ta.shadingModeStatic, ta.fea_pe, ta.monodepth_weight_static) == (
        "MLP_Fea_TimeEmbedding", 6, 0.04)
    ja.golden_det = ta.golden_det = 1
    jtr = JTrainer(ja, jtiny_scene("contract"))
    with torch_threads(1):
        ttr = TTrainer(ta, ttiny_scene("contract"), device="cpu")
        ttr.set_params(params_from_numpy(jax.tree_util.tree_map(np.asarray, jtr.params), "cpu"))
    ps = PermutationSampler(jtr.scene.n_rays, jtr.args.batch_size, 7)
    ri, rr = ps.nextids(), ps.nextids()

    jstep = jmake_step(jtr._statics(), donate=False)
    _, jm = _jax_grads(jtr, jstep, ri, rr, jnp.float32)
    with jax.enable_x64(True):
        jg64, _ = _jax_grads(jtr, jstep, ri, rr, jnp.float64)

    tsc = {"iteration": IT, "focal_fixed": ttr.focal_fixed, **ttr.schedule.scalars(IT)}
    ri_t, rr_t = torch.as_tensor(ri), torch.as_tensor(rr)
    data64 = {k: v.double() if v.is_floating_point() else v for k, v in ttr.data.items()}
    with torch_threads(1):
        _, tm = ttr.step_fn.grads_and_metrics(ttr.params, ttr.aabb, ttr.data, ri_t, rr_t, None,
                                              tsc)
        g64, _ = ttr.step_fn.grads_and_metrics(
            _to_f64(params_to_numpy(ttr.params)), ttr.aabb.double(), data64, ri_t, rr_t, None,
            tsc)

    # the same step with an empty dynamic field; the port's induced
    # disparities recorded in call order (pass A forward, backward; C; D; ...)
    p = jax.tree_util.tree_map(np.asarray, jtr.params)
    p["dynamic"]["density_head"][-1]["b"] = p["dynamic"]["density_head"][-1]["b"] + EMPTY_SHIFT
    jtr.params = jax.tree_util.tree_map(jnp.asarray, p)
    with jax.enable_x64(True):
        jg64_empty, _ = _jax_grads(jtr, jstep, ri, rr, jnp.float64)
    disps = []

    def recorded(*a, **k):
        out = induce_flow(*a, **k)
        disps.append(out[1].detach().clone())
        return out

    induce_flow = tstep.induce_flow
    with torch_threads(1), pytest.MonkeyPatch.context() as mp:
        mp.setattr(tstep, "induce_flow", recorded)
        ttr.set_params(params_from_numpy(p, "cpu"))
        g64_empty, tm_empty = ttr.step_fn.grads_and_metrics(
            _to_f64(params_to_numpy(ttr.params)), ttr.aabb.double(), data64, ri_t, rr_t, None,
            tsc)
    return dict(jm={k: float(v) for k, v in jm.items()},
                tm={k: float(v) for k, v in tm.items()},
                jg64=jg64, g64=params_to_numpy(g64), sc=tsc,
                jg64_empty=jg64_empty, g64_empty=params_to_numpy(g64_empty),
                tm_empty={k: float(v) for k, v in tm_empty.items()}, disps_empty=disps)


def test_every_gated_term_is_live(step_pair):
    sc, tm = step_pair["sc"], step_pair["tm"]
    assert IT > 20  # past TINY's last upsample
    for k in ("TV_weight_density", "TV_weight_app", "L1_reg_weight"):
        if k in sc:
            assert float(sc[k]) > 0.0, k
    live = [k for k, v in tm.items() if v != 0.0]
    print(f"{len(live)} of {len(tm)} metrics nonzero")
    for k in tm:
        if "monodepth" in k or "tv" in k.lower() or "l1" in k.lower():
            assert tm[k] != 0.0, k


def test_every_loss_term_matches(step_pair):
    jm, tm = step_pair["jm"], step_pair["tm"]
    assert set(jm) == set(tm)
    assert len(jm) > 30
    for k in sorted(jm):
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-9, err_msg=k)


def test_every_param_gradient_matches_in_float64(step_pair):
    jg64 = dict(_leaves(step_pair["jg64"]))
    g64 = dict(_leaves(step_pair["g64"]))
    assert set(jg64) == set(g64)
    assert {p[0] for p in jg64} == {"static", "dynamic", "pose", "fov"}
    assert {str(v.dtype) for v in jg64.values()} == {"float64"}
    worst = max(_rel(g64[path], jg64[path]) for path in jg64)
    print(f"worst float64 gradient difference: {worst:.3e} of scale")
    for path in sorted(jg64, key=str):
        assert _rel(g64[path], jg64[path]) <= 1e-6, path


def test_dynamic_disparity_ties_carry_no_gradient(step_pair):
    disp_f, disp_b, disp_ff, disp_bb = step_pair["disps_empty"][:4]
    assert torch.equal(disp_f, disp_ff) and torch.equal(disp_b, disp_bb)
    assert step_pair["tm_empty"]["disp_f_loss"] == step_pair["tm_empty"]["disp_b_loss"] == 0.0
    jg64 = dict(_leaves(step_pair["jg64_empty"]))
    g64 = dict(_leaves(step_pair["g64_empty"]))
    assert set(jg64) == set(g64)
    worst = max(_rel(g64[path], jg64[path]) for path in jg64)
    print(f"empty dynamic field: worst float64 gradient difference {worst:.3e} of scale")
    for path in sorted(jg64, key=str):
        assert _rel(g64[path], jg64[path]) <= 1e-6, path
