"""Whole-step parity of the JAX package's default recipe: the merged-stride
table layout ('auto' picks it for the TINY dynamic field in both packages),
in f32 and with bf16 gather tables. Same TINY
shapes, golden_det, weights, ray batches and iteration as
test_torch_step.py.

- f32: every loss to 1e-5 relative, every gradient to 1e-4 of scale; the
  eight ILL_CONDITIONED leaves of test_torch_step.py to 1e-4 plus twice the
  JAX package's own f32 error on the leaf (its f32 run against its x64 run).
- bf16: the packed tables round the same way in both packages, but the
  table gradients accumulate in f32 in the port and in bf16 in the JAX
  package's default routes. Every loss to 1e-4 relative; plane and line
  leaves to 3e-2 of scale (the JAX package's own bf16-accumulation bound,
  tests/test_coalesced.py); every other leaf to 1e-3 of scale, the eight
  ILL_CONDITIONED ones to 1e-3 plus twice the JAX f32 error.
  The camera leaves (pose, fov) are reached only through the sample
  coordinates, whose cotangents pass the bf16 rounding of the line weights'
  cotangent: f32-level differences upstream flip single roundings there, and
  the JAX bf16 step alone moves its fov gradient by 1.4e-3 of scale when its
  parameters move by one f32 ulp. They are held to the larger of 1e-3 and
  half of what bf16 itself changes in the JAX package's gradient (its bf16
  run against its f32 run): a port that dropped bf16 would sit a whole such
  change away. No bound comes from the code under test; `-s` prints the
  worst readings.

The upsample: test_torch_upsample.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rodynrf_tpu.fields import dynamic as jdyn
from rodynrf_tpu.fields import static as jstat
from rodynrf_tpu.testing import tiny_cmd, tiny_scene as jtiny_scene
from rodynrf_tpu.train import Trainer as JTrainer, parse_cmd as jparse
from rodynrf_tpu.train.schedule import PermutationSampler
from rodynrf_tpu.train.step import make_train_step as jmake_step
from rodynrf_tpu_torch.testing import tiny_scene as ttiny_scene
from rodynrf_tpu_torch.train import Trainer as TTrainer, parse_cmd as tparse
from rodynrf_tpu_torch.train.convert import params_from_numpy, params_to_numpy
from test_torch_step import ILL_CONDITIONED, IT, _jax_grads, _leaves, _rel

CMD = tiny_cmd("ndc", 1)  # --vm_layout auto
CMD_BF16 = CMD + " --bf16 1"


def _trainers(cmd):
    ja = jparse(cmd)
    ja.golden_det = 1
    jtr = JTrainer(ja, jtiny_scene("ndc"))
    ta = tparse(cmd)
    ta.golden_det = 1
    ttr = TTrainer(ta, ttiny_scene("ndc"), device="cpu")
    ttr.set_params(params_from_numpy(jax.tree_util.tree_map(np.asarray, jtr.params), "cpu"))
    return jtr, ttr


def _jax_layouts(jtr):
    return {
        "static": jstat.pack_tables(jtr.params["static"], jtr.static_cfg).meta["layout"],
        "dynamic": jdyn.pack_tables(jtr.params["dynamic"], jtr.dynamic_cfg).meta["layout"],
    }


def _port_grads(ttr, ri, rr):
    tsc = {"iteration": IT, "focal_fixed": ttr.focal_fixed, **ttr.schedule.scalars(IT)}
    g, m = ttr.step_fn.grads_and_metrics(ttr.params, ttr.aabb, ttr.data, torch.as_tensor(ri),
                                         torch.as_tensor(rr), None, tsc)
    return params_to_numpy(g), {k: float(v) for k, v in m.items()}


@pytest.fixture(scope="module")
def steps():
    out = {}
    for name, cmd in (("f32", CMD), ("bf16", CMD_BF16)):
        jtr, ttr = _trainers(cmd)
        ps = PermutationSampler(jtr.scene.n_rays, jtr.args.batch_size, 7)
        ri, rr = ps.nextids(), ps.nextids()
        jstep = jmake_step(jtr._statics(), donate=False)
        jg, jm = _jax_grads(jtr, jstep, ri, rr, jnp.float32)
        tg, tm = _port_grads(ttr, ri, rr)
        out[name] = dict(jg=dict(_leaves(jg)), jm={k: float(v) for k, v in jm.items()},
                         tg=dict(_leaves(tg)), tm=tm,
                         layouts=(_jax_layouts(jtr), ttr.table_layouts()))
        if name == "f32":
            with jax.enable_x64(True):
                jg64, _ = _jax_grads(jtr, jstep, ri, rr, jnp.float64)
            # the JAX package's own float32 error per leaf, at this layout
            out["noise"] = {p: _rel(out[name]["jg"][p], v) for p, v in _leaves(jg64)}
    return out


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_auto_picks_merged_for_the_dynamic_field(steps, name):
    jl, tl = steps[name]["layouts"]
    assert jl == tl == {"static": "strided", "dynamic": "merged"}


@pytest.mark.parametrize("name,rtol", [("f32", 1e-5), ("bf16", 1e-4)])
def test_every_loss_term_matches(steps, name, rtol):
    jm, tm = steps[name]["jm"], steps[name]["tm"]
    assert set(jm) == set(tm) and len(jm) > 30
    for k in sorted(jm):
        np.testing.assert_allclose(tm[k], jm[k], rtol=rtol, atol=1e-9, err_msg=k)


def _is_table(path):
    return any("plane" in str(n) or "line" in str(n) for n in path)


@pytest.mark.parametrize("name", ["f32", "bf16"])
def test_every_param_gradient_matches(steps, name):
    jg, tg, noise = steps[name]["jg"], steps[name]["tg"], steps["noise"]
    assert set(jg) == set(tg) == set(noise)
    assert {p[0] for p in jg} == {"static", "dynamic", "pose", "fov"}
    assert ILL_CONDITIONED <= set(jg)
    base = 1e-4 if name == "f32" else 1e-3
    worst = []
    for path in sorted(jg, key=str):
        rel = _rel(tg[path], jg[path])
        if name == "bf16" and _is_table(path):
            bound = 3e-2
        elif path in ILL_CONDITIONED:
            bound = base + 2.0 * noise[path]
        elif name == "bf16" and path[0] in ("pose", "fov"):
            # half of bf16's own change to the JAX gradient (module docstring)
            bound = max(base, 0.5 * _rel(jg[path], steps["f32"]["jg"][path]))
        else:
            bound = base
        worst.append((rel / bound, path, rel, bound))
        assert rel <= bound, (path, rel, bound)
    for frac, path, rel, bound in sorted(worst, key=lambda x: x[0], reverse=True)[:10]:
        print(f"{name} {path}: rel {rel:.3e}, JAX f32 noise {noise[path]:.3e}, "
              f"bound {bound:.3e} ({frac:.2f} of it)")
