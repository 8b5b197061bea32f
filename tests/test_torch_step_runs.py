"""Trainer-level runs of the port's step at the TINY shapes (f32, strided),
beside the single-step parity of tests/test_torch_step.py (a file of its
own so that the test workers run it beside that one).

- Two `Trainer.run_step` calls of both packages give the same losses at
  1e-4. Parameters are not compared after Adam, whose scale-free update
  turns ulp-level gradient differences into lr-sized steps (GOLDEN.md §4).
- --share_forward 0 gives the shared path's losses and gradients in
  golden_det mode.
- --fused_passes 1, --remat on and --grad_accum 2 reach the port's step and
  train: two run_steps with finite losses.
"""

import numpy as np
import pytest
import torch

from rodynrf_tpu.testing import tiny_cmd
from rodynrf_tpu.train.schedule import PermutationSampler
from rodynrf_tpu_torch.testing import tiny_scene as ttiny_scene
from rodynrf_tpu_torch.train import Trainer as TTrainer, parse_cmd as tparse
from rodynrf_tpu_torch.train.convert import params_to_numpy
from test_torch_step import CMD, IT, _leaves, _trainers


def test_two_run_steps_match():
    jtr, ttr = _trainers()
    for _ in range(2):
        jm = {k: float(v) for k, v in jtr.run_step().items()}
        tm = {k: float(v) for k, v in ttr.run_step().items()}
        assert set(jm) == set(tm)
        for k in sorted(jm):
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=1e-7, err_msg=k)
    assert jtr.iteration == ttr.iteration == 2


def test_shared_and_unshared_forward_agree():
    """--share_forward 0 evaluates A/B's static field on their own (detached)
    samples; in golden_det mode those are E's samples, so losses and
    gradients equal the shared path's (the JAX package's contract)."""
    out = []
    for share in (1, 0):
        args = tparse(CMD + f" --share_forward {share}")
        args.golden_det = 1
        tr = TTrainer(args, ttiny_scene("ndc"), device="cpu")
        ps = PermutationSampler(tr.scene.n_rays, args.batch_size, 7)
        ri, rr = torch.as_tensor(ps.nextids()), torch.as_tensor(ps.nextids())
        sc = {"iteration": IT, "focal_fixed": tr.focal_fixed, **tr.schedule.scalars(IT)}
        out.append(tr.step_fn.grads_and_metrics(tr.params, tr.aabb, tr.data, ri, rr, None, sc))
    (g1, m1), (g0, m0) = out
    for k in m1:
        np.testing.assert_allclose(float(m0[k]), float(m1[k]), rtol=1e-6, atol=1e-9, err_msg=k)
    for (path, a), (_, b) in zip(_leaves(params_to_numpy(g1)), _leaves(params_to_numpy(g0))):
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-6 * float(np.abs(a).max()),
                                   err_msg=str(path))



@pytest.mark.parametrize("flag,field,value", [
    ("--fused_passes 1", "fused_passes", True),
    ("--remat on", "remat", True),
    ("--grad_accum 2", "grad_accum", 2),
])
def test_memory_options_run_through_the_trainer(flag, field, value):
    """The JAX package's single-card memory options reach the port's step
    and train: two run_steps with finite losses."""
    tr = TTrainer(tparse(tiny_cmd("ndc", 1) + " " + flag), ttiny_scene("ndc"), device="cpu")
    assert getattr(tr.step_fn.S, field) == value
    for _ in range(2):
        metrics = tr.run_step()
        assert all(np.isfinite(float(v)) for v in metrics.values())
    assert tr.iteration == 2
