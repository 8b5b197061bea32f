"""Gradient accumulation of the port (StepStatics.grad_accum,
TrainStep.grads_and_metrics) against the JAX package's scan
(rodynrf_tpu/train/step.py make_train_step), and the port's auto rule
against the JAX trainer's (Trainer._grad_accum), at the TINY shapes.

- Accumulation of 2 and (test_torch_grad_accum_4.py) of 4 micro-batches,
  golden_det, identical weights and ray batch: every metric (the mean over the micro-batches) to 1e-5
  relative; every gradient of a float64 run to 1e-6 of scale of the JAX
  x64 run; every float32 gradient to 1e-4 of scale, the ILL_CONDITIONED
  leaves of test_torch_step.py to 1e-4 plus twice the JAX package's own
  float32 error on the leaf: the bounds of test_torch_step.py.
- The port's accumulation equals its own average of the micro-batch
  gradients, each micro-batch run alone on the same generator in turn, to
  1e-6 of scale: the micro-batches take rows i of the reshaped batches and
  draw from the step's generator in order.
- `--grad_accum 0` resolves to the JAX trainer's value over a grid of
  (N_voxel_final, batch_size) and for the three configs/: 4 for
  Nvidia_no_poses (640³), 1 for Nvidia and DAVIS. So do `--remat auto` and
  the pass chunk, which change no number.
"""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rodynrf_tpu.fields.config import FieldConfig as JFieldConfig
from rodynrf_tpu.train import Trainer as JTrainer
from rodynrf_tpu.train.config import config_parser as jconfig_parser
from rodynrf_tpu.train.schedule import PermutationSampler
from rodynrf_tpu.train.step import make_train_step as jmake_step
from rodynrf_tpu_torch.fields.config import FieldConfig as TFieldConfig
from rodynrf_tpu_torch.testing import tiny_scene, torch_threads
from rodynrf_tpu_torch.train import Trainer as TTrainer, parse_cmd as tparse
from rodynrf_tpu_torch.train.config import config_parser as tconfig_parser
from rodynrf_tpu_torch.train.convert import params_to_numpy
from rodynrf_tpu_torch.train.step import make_train_step
from test_torch_step import CMD, ILL_CONDITIONED, IT, _jax_grads, _leaves, _rel, _to_f64, _trainers

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def _sc(tr):
    return {"iteration": IT, "focal_fixed": tr.focal_fixed, **tr.schedule.scalars(IT)}


# one trainer pair for both micro-batch counts (nothing here steps them)
_pair = functools.lru_cache(maxsize=None)(_trainers)


@functools.lru_cache(maxsize=None)
def _accumulated(A):
    """Both packages' accumulated step over A micro-batches on the same
    weights and batch: JAX f32 and x64, port f32 and f64."""
    jtr, ttr = _pair()
    ps = PermutationSampler(jtr.scene.n_rays, jtr.args.batch_size, 7)
    ri, rr = ps.nextids(), ps.nextids()
    jstep = jmake_step(dataclasses.replace(jtr._statics(), grad_accum=A), donate=False)
    jg, jm = _jax_grads(jtr, jstep, ri, rr, jnp.float32)
    with jax.enable_x64(True):
        jg64, _ = _jax_grads(jtr, jstep, ri, rr, jnp.float64)
    tstep = make_train_step(dataclasses.replace(ttr.step_fn.S, grad_accum=A), "cpu")
    ri_t, rr_t = torch.as_tensor(ri), torch.as_tensor(rr)
    tg, tm = tstep.grads_and_metrics(ttr.params, ttr.aabb, ttr.data, ri_t, rr_t, None, _sc(ttr))
    data64 = {k: v.double() if v.is_floating_point() else v for k, v in ttr.data.items()}
    g64, _ = tstep.grads_and_metrics(_to_f64(params_to_numpy(ttr.params)), ttr.aabb.double(),
                                     data64, ri_t, rr_t, None, _sc(ttr))
    return dict(
        jm={k: float(v) for k, v in jm.items()}, tm={k: float(v) for k, v in tm.items()},
        jg=dict(_leaves(jg)), jg64=dict(_leaves(jg64)),
        tg=dict(_leaves(params_to_numpy(tg))), g64=dict(_leaves(params_to_numpy(g64))),
    )


# 4 micro-batches run in test_torch_grad_accum_4.py (a file of its own spreads
# the two JAX compilations over the test workers)
@pytest.fixture(params=[2])
def A(request):
    return request.param


def test_accumulated_metrics_match_jax(A):
    r = _accumulated(A)
    jm, tm = r["jm"], r["tm"]
    assert set(jm) == set(tm) and len(jm) > 30
    for k in sorted(jm):
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-9, err_msg=k)


def test_accumulated_gradients_match_jax(A):
    r = _accumulated(A)
    jg, jg64, tg, g64 = r["jg"], r["jg64"], r["tg"], r["g64"]
    assert set(jg) == set(tg) == set(jg64) == set(g64)
    assert {p[0] for p in jg} == {"static", "dynamic", "pose", "fov"}
    worst64 = max(_rel(g64[p], jg64[p]) for p in jg64)
    print(f"accum {A}: worst float64 gradient difference {worst64:.3e} of scale")
    for path in sorted(jg64, key=str):
        assert _rel(g64[path], jg64[path]) <= 1e-6, path
    for path in sorted(jg, key=str):
        rel = _rel(tg[path], jg[path])
        bound = 1e-4 + 2.0 * _rel(jg[path], jg64[path]) if path in ILL_CONDITIONED else 1e-4
        assert rel <= bound, (path, rel, bound)


@pytest.mark.parametrize("golden_det", [1, 0])
def test_accumulation_is_the_mean_of_its_micro_batches(golden_det):
    """grad_accum 2 against the port's own micro-batches run one after the
    other at grad_accum 1 on the same generator; with golden_det 0 the
    sampler jitter and the white-fill coins come from that generator, so
    the micro-batches must draw in order."""
    args = tparse(CMD)
    args.golden_det = golden_det
    tr = TTrainer(args, tiny_scene("ndc"), device="cpu")
    ps = PermutationSampler(tr.scene.n_rays, args.batch_size, 7)
    ri, rr = torch.as_tensor(ps.nextids()), torch.as_tensor(ps.nextids())
    S = tr.step_fn.S
    g2, m2 = make_train_step(dataclasses.replace(S, grad_accum=2), "cpu").grads_and_metrics(
        tr.params, tr.aabb, tr.data, ri, rr, torch.Generator().manual_seed(5), _sc(tr))
    g2 = dict(_leaves(params_to_numpy(g2)))
    one = make_train_step(dataclasses.replace(S, grad_accum=1), "cpu")
    gen = torch.Generator().manual_seed(5)
    micro = [one.grads_and_metrics(tr.params, tr.aabb, tr.data, a, b, gen, _sc(tr))
             for a, b in zip(ri.reshape(2, -1), rr.reshape(2, -1))]
    leaves = [dict(_leaves(params_to_numpy(g))) for g, _ in micro]
    for path, v in g2.items():
        want = (leaves[0][path] + leaves[1][path]) / 2.0
        assert _rel(v, want) <= 1e-6, path
    for k, v in m2.items():
        want = (float(micro[0][1][k]) + float(micro[1][1][k])) / 2.0
        np.testing.assert_allclose(float(v), want, rtol=1e-6, atol=1e-9, err_msg=k)


# ---- the auto rules (they touch only args, configs and sizes)

POLICIES = ("_grad_accum", "_gather_row_bytes", "_pass_chunk", "_remat_policy")


def _policy_host(trainer_cls, args, cfg_cls, n_samples=270, compact_k=0):
    """An object carrying the trainer's policy methods and the state they
    read: args, both field configs, the sample count, the bucket size."""
    host = type("PolicyHost", (), {k: getattr(trainer_cls, k) for k in POLICIES})()
    cfg = cfg_cls(grid_size=(64, 64, 64), t_size=12, density_n_comp=tuple(args.n_lamb_sigma),
                  app_n_comp=tuple(args.n_lamb_sh), app_frac=float(args.app_frac),
                  grid_sample_dtype="bfloat16" if int(args.bf16) else "float32")
    host.__dict__.update(args=args, static_cfg=cfg, dynamic_cfg=cfg, n_samples=n_samples,
                         compact_k=compact_k, mesh=None)
    return host


def _resolved(extra, n_samples=270, compact_k=0):
    jargs, targs = jconfig_parser(extra), tconfig_parser(extra)
    j = _policy_host(JTrainer, jargs, JFieldConfig, n_samples, compact_k)
    t = _policy_host(TTrainer, targs, TFieldConfig, n_samples, compact_k)
    return ({k: getattr(j, k)() for k in POLICIES}, {k: getattr(t, k)() for k in POLICIES})


@pytest.mark.parametrize("config,want", [
    ("Nvidia_no_poses.txt", 4), ("Nvidia.txt", 1), ("DAVIS.txt", 1),
])
def test_auto_rule_resolves_the_configs_as_jax(config, want):
    j, t = _resolved(["--config", os.path.join(REPO, "configs", config)])
    assert t == j
    assert t["_grad_accum"] == want


def test_auto_rules_match_jax_over_a_grid():
    seen = set()
    for n_voxel in (64 ** 3, 300 ** 3, 351 ** 3, 500 ** 3, 500 ** 3 + 1, 640 ** 3):
        for batch in (1024, 1022, 1023, 4096, 6, 7):
            for extra in ([], ["--fused_passes", "1"], ["--bf16", "1", "--app_frac", "0.25"],
                          ["--grad_accum", "3"], ["--remat", "on"], ["--remat", "off"]):
                argv = ["--N_voxel_final", str(n_voxel), "--batch_size", str(batch), *extra]
                for n_samples, compact_k in ((270, 0), (577, 0), (270, 96)):
                    j, t = _resolved(argv, n_samples, compact_k)
                    assert t == j, (argv, n_samples, compact_k)
                    seen.add((t["_grad_accum"], t["_remat_policy"]))
    # the grid reaches every branch: 1, 4 and raised-to-divide counts, both
    # remat answers
    assert {a for a, _ in seen} >= {1, 3, 4, 6, 7, 11} and {r for _, r in seen} == {True, False}
