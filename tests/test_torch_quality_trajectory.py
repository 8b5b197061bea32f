"""The port's training trajectory against the JAX package's through every
schedule event of the `quality_run` recipe, on the CPU.

Both trainers take the recipe of tools/quality_run.py (the JAX script's
command line) at n_iters = 24, so that every event lies inside the run:
the upsamples at 4, 8, 12 and 16 (each resets the fields' Adam and the
learning rates and rebuilds the step), the pose freeze at 13 and the focal
optimizer's activation at 16. The widths are narrowed (4/2/2 density and
8/4/4 appearance components, 16 samples, 64 rays, a 4×16×16 scene) and
the grid grows once, from 512 voxels (N_VOXEL_FINAL): each new grid
compiles the JAX x64 step anew, ~40 s on a small CPU, and the resize alone
is held at 1e-6 by test_torch_upsample.py. The draws are pinned
(golden_det), the tables are float32 (--bf16 0) and the port starts from
the JAX package's initial parameters.
Both run in float64 (the JAX package under x64): in float32 the two part
within a few iterations, because Adam's normalised first step after each
reset turns the ill-conditioned leaves' float32 noise (test_torch_step.py)
into whole learning-rate steps.

The bounds are fixed, set from the readings with a few times headroom
(PERF.md §6.13): at every iteration each loss term of the port lies
within 1e-4 (ndc) or 1e-3 (contract) of the JAX run's, relative, and the
final parameters within 1e-3 (ndc) or 2e-2 (contract) of scale, leaf by
leaf; the grids, sample counts and learning rates agree at every
iteration and the events fire where the recipe puts them. A wrong
upsample, pose freeze or focal activation parts the runs by far more.
The contract run is the more sensitive one: its losses leave the ndc
run's 1e-5 agreement after the upsamples. `-s` prints the readings. The
contract rays: test_torch_quality_trajectory_contract.py, a file of its
own so that the test workers run the two side by side.

The JAX x64 run keeps the contract sampler's float32 `arange`
(rodynrf_tpu/render/sampling.py:86, ROADMAP "kept differences"); the test
lifts it to float64 through the module's `jnp` name, without editing the
JAX package, so that both compute the same function.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rodynrf_tpu.render.sampling as jsampling
from rodynrf_tpu.data import make_synthetic_scene as jscene
from rodynrf_tpu.train import Trainer as JTrainer, parse_cmd as jparse
from rodynrf_tpu_torch.data import make_synthetic_scene as tscene
from rodynrf_tpu_torch.testing import torch_threads
from rodynrf_tpu_torch.tools.quality_run import Events, expected_events, recipe
from rodynrf_tpu_torch.train import Trainer as TTrainer, parse_cmd as tparse
from rodynrf_tpu_torch.train.convert import params_to_numpy
from rodynrf_tpu_torch.train.step import init_opt_state
from test_torch_step import _jnp64, _leaves, _to_f64

N_ITERS = 24
SCENE = dict(T=4, H=16, W=16)
NARROW = {r"--batch_size \d+": "--batch_size 64",
          r"--N_voxel_init \d+": "--N_voxel_init 512",
          r"(--n_lamb_sigma \d+ ?){3}": "--n_lamb_sigma 4 --n_lamb_sigma 2 --n_lamb_sigma 2 ",
          r"(--n_lamb_sh \d+ ?){3}": "--n_lamb_sh 8 --n_lamb_sh 4 --n_lamb_sh 4 "}
# the grid grows once: ndc (8, 9, 5) -> (9, 10, 6) at the first upsample,
# contract (8, 8, 8) -> (9, 9, 9) at the fourth
N_VOXEL_FINAL = {"ndc": 700, "contract": 729}
LOSS_TOL = {"ndc": 1e-4, "contract": 1e-3}  # relative, every loss term, every iteration
LEAF_TOL = {"ndc": 1e-3, "contract": 2e-2}  # max |port - JAX| / max |JAX|, final leaves


def _cmd(ray_type: str) -> str:
    cmd = recipe(ray_type, N_ITERS, T=SCENE["T"])
    cmd = re.sub(r"--N_voxel_final \d+", f"--N_voxel_final {N_VOXEL_FINAL[ray_type]}", cmd)
    for pat, sub in NARROW.items():
        cmd, n = re.subn(pat, sub, cmd)
        assert n == 1, pat
    return cmd + " --nSamples 16 --bf16 0"


class _Jnp64Arange:
    """The JAX sampling module's `jnp`, with float32 aranges made float64."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    def arange(self, *a, dtype=None, **k):
        return jnp.arange(*a, dtype=jnp.float64 if dtype == jnp.float32 else dtype, **k)


def _jax_to64(tr):
    tr.params = jax.tree_util.tree_map(_jnp64, tr.params)
    tr.opt_state = jax.tree_util.tree_map(_jnp64, tr.opt_state)


def _jax_trainer(cmd, ray_type):
    a = jparse(cmd)
    a.golden_det = 1
    a.n_devices = 1  # one device, as the port's trainer: no mesh over the host's CPU devices
    tr = JTrainer(a, jscene(**SCENE, ray_type=ray_type))
    _jax_to64(tr)
    tr.data = jax.tree_util.tree_map(_jnp64, tr.data)
    tr.aabb = _jnp64(tr.aabb)
    return tr


def _jax_step(tr, compiled):
    """Trainer.run_step with float64 schedule scalars (run_step passes
    float32 ones), the upsample's new leaves cast back to float64. After an
    upsample the trainer takes the step already compiled for its statics
    from `compiled`, if there is one: each grid compiles once."""
    i = tr.iteration
    ri, rr = jnp.asarray(tr.sampler.nextids()), jnp.asarray(tr.sampler2.nextids())
    tr.key, sub = jax.random.split(tr.key)
    sc = {"iteration": jnp.asarray(i, jnp.int32),
          "focal_fixed": jnp.asarray(tr.focal_fixed, jnp.float64)}
    sc.update({k: jnp.asarray(v, jnp.float64) for k, v in tr.schedule.scalars(i).items()})
    tr.params, tr.opt_state, m = tr.step_fn(tr.params, tr.opt_state, tr.aabb, tr.data, ri, rr,
                                            sub, sc)
    tr.schedule.after_step(i)
    tr.iteration += 1
    if i in tr.args.upsamp_list:
        tr._upsample(i)
        _jax_to64(tr)
        tr.step_fn = compiled.setdefault(tr._statics(), tr.step_fn)
    return {k: float(v) for k, v in m.items()}


def _port_trainer(cmd, ray_type, jtr):
    a = tparse(cmd)
    a.golden_det = 1
    tr = TTrainer(a, tscene(**SCENE, ray_type=ray_type), device="cpu")
    tr.params = _to_f64(jax.tree_util.tree_map(np.asarray, jtr.params))
    tr.opt_state = init_opt_state(tr.params)
    tr.data = {k: v.double() if v.is_floating_point() else v for k, v in tr.data.items()}
    tr.aabb = tr.aabb.double()
    tr._build_step()
    return tr


def _loss_gap(m, ref):
    """(the largest relative gap of a loss term, that term)"""
    return max((abs(m[k] - ref[k]) / max(abs(ref[k]), 1e-6), k) for k in ref)


def _param_gaps(params, ref):
    got, want = dict(_leaves(params)), dict(_leaves(ref))
    assert got.keys() == want.keys()
    return {p: float(np.abs(got[p] - want[p]).max() / (np.abs(want[p]).max() + 1e-30))
            for p in want}


@pytest.fixture(params=["ndc"])
def ray_type(request):
    return request.param


def test_trajectory_through_every_event_matches_jax(ray_type, monkeypatch):
    monkeypatch.setattr(jsampling, "jnp", _Jnp64Arange())
    cmd = _cmd(ray_type)
    with jax.enable_x64(True), torch_threads(1):
        jtr = _jax_trainer(cmd, ray_type)
        compiled = {jtr._statics(): jtr.step_fn}
        ttr = _port_trainer(cmd, ray_type, jtr)
        events = {"jax": Events(jtr), "port": Events(ttr)}
        gaps = []
        for i in range(N_ITERS):
            assert ttr.schedule.scalars(i) == pytest.approx(jtr.schedule.scalars(i), rel=1e-12)
            jm = _jax_step(jtr, compiled)
            tm = {k: float(v) for k, v in ttr.run_step().items()}
            assert tm.keys() == jm.keys()
            gaps.append(_loss_gap(tm, jm))
            events["jax"].after(jtr, i)
            events["port"].after(ttr, i)
            assert tuple(ttr.static_cfg.grid_size) == tuple(jtr.static_cfg.grid_size)
            assert ttr.n_samples == jtr.n_samples
        final = _param_gaps(params_to_numpy(ttr.params),
                            jax.tree_util.tree_map(np.asarray, jtr.params))
    print(f"\n{ray_type}: loss gap by iteration (bound {LOSS_TOL[ray_type]:.0e}):")
    for i, (g, k) in enumerate(gaps):
        print(f"  {i:2d} {g:.2e} {k}")
    worst = max(final, key=final.get)
    print(f"final parameters: worst {worst} {final[worst]:.2e} of scale "
          f"(bound {LEAF_TOL[ray_type]:.0e})")

    want_events = expected_events(jtr.args)
    assert want_events == {"upsample": [4, 8, 12, 16], "focal_on": 16, "pose_freeze": 13}
    assert events["port"].as_dict() == events["jax"].as_dict() == want_events
    for i, (g, k) in enumerate(gaps):
        assert g <= LOSS_TOL[ray_type], f"iteration {i}: {k} gap {g:.2e}"
    for p in final:
        assert final[p] <= LEAF_TOL[ray_type], (p, final[p])
