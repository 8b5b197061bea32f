"""Whole-step parity: the port's train step against the JAX `train_loss` at
the TINY shapes (f32, strided layout, golden_det, identical weights and ray
batches). The merged layout, bf16 and the upsample: test_torch_step_merged.py.

- Every loss term and the total agree to 1e-5 relative.
- Every parameter gradient (both fields, pose, fov) of a float64 run of the
  port agrees with a float64 (x64) run of the JAX package to
  max|Δ|/max|ref| ≤ 1e-6: the two compute the same function.
- In float32 every gradient agrees to max|Δ|/max|ref| ≤ 1e-4, except the
  leaves named in ILL_CONDITIONED. Those dynamic density and warp leaves
  are reached through the distortion and dynamic monodepth losses, on rays
  whose dynamic alpha 1 - exp(-σδ) is so small that float32 keeps few of
  its digits and the weights are then renormalized by their tiny sums: the
  JAX package's own float32 gradient lies up to 4e-4 of scale off its
  float64 one there. Each of them is held to 1e-4 plus twice that
  reference noise, which the JAX package alone sets.
- Two `Trainer.run_step` calls, the unshared forward and the memory options
  through the trainer: tests/test_torch_step_runs.py.
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
from rodynrf_tpu_torch.testing import tiny_scene as ttiny_scene
from rodynrf_tpu_torch.train import Trainer as TTrainer, parse_cmd as tparse
from rodynrf_tpu_torch.train.convert import params_from_numpy, params_to_numpy

CMD = tiny_cmd("ndc", 1) + " --vm_layout strided"
IT = 25  # past upsamp3 = 20: every gated loss term is live
# the only leaves allowed past 1e-4 in float32 (see the module docstring)
ILL_CONDITIONED = {
    ("dynamic", "density_head", 0, "b"),
    ("dynamic", "density_head", 1, "b"),
    ("dynamic", "density_head", 1, "w"),
    ("dynamic", "density_line", 0),
    ("dynamic", "density_plane", 0),
    ("dynamic", "density_plane", 1),
    ("dynamic", "warp_t2", "w"),
    ("dynamic", "warp_xyz", 2, "w"),
}


def _trainers():
    ja = jparse(CMD)
    ja.golden_det = 1
    jtr = JTrainer(ja, jtiny_scene("ndc"))
    ta = tparse(CMD)
    ta.golden_det = 1
    ttr = TTrainer(ta, ttiny_scene("ndc"), device="cpu")
    ttr.set_params(params_from_numpy(jax.tree_util.tree_map(np.asarray, jtr.params), "cpu"))
    return jtr, ttr


def _leaves(tree):
    if isinstance(tree, dict):
        for k, v in tree.items():
            for p, x in _leaves(v):
                yield (k,) + p, x
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            for p, x in _leaves(v):
                yield (i,) + p, x
    else:
        yield (), tree


def _to_f64(tree):
    if isinstance(tree, dict):
        return {k: _to_f64(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_f64(v) for v in tree]
    return torch.tensor(np.asarray(tree, np.float64), requires_grad=True)


def _jnp64(x):
    x = np.asarray(x)
    return jnp.asarray(x.astype(np.float64) if np.issubdtype(x.dtype, np.floating) else x)


def _jax_grads(jtr, jstep, ri, rr, dtype):
    sc = {"iteration": jnp.asarray(IT, jnp.int32),
          "focal_fixed": jnp.asarray(jtr.focal_fixed, dtype)}
    sc.update({k: jnp.asarray(v, dtype) for k, v in jtr.schedule.scalars(IT).items()})
    params, aabb, data = jtr.params, jtr.aabb, jtr.data
    if dtype == jnp.float64:
        params, data = (jax.tree_util.tree_map(_jnp64, t) for t in (params, data))
        aabb = _jnp64(aabb)
    g, m = jax.jit(jstep.grads_and_metrics)(
        params, aabb, data, jnp.asarray(ri), jnp.asarray(rr), jax.random.PRNGKey(0), sc
    )
    return jax.tree_util.tree_map(np.asarray, g), m


@pytest.fixture(scope="module")
def step_pair():
    jtr, ttr = _trainers()
    ps = PermutationSampler(jtr.scene.n_rays, jtr.args.batch_size, 7)
    ri, rr = ps.nextids(), ps.nextids()

    jstep = jmake_step(jtr._statics(), donate=False)
    jg, jm = _jax_grads(jtr, jstep, ri, rr, jnp.float32)
    with jax.enable_x64(True):
        jg64, _ = _jax_grads(jtr, jstep, ri, rr, jnp.float64)

    tsc = {"iteration": IT, "focal_fixed": ttr.focal_fixed, **ttr.schedule.scalars(IT)}
    ri_t, rr_t = torch.as_tensor(ri), torch.as_tensor(rr)
    tg, tm = ttr.step_fn.grads_and_metrics(ttr.params, ttr.aabb, ttr.data, ri_t, rr_t, None, tsc)
    data64 = {k: v.double() if v.is_floating_point() else v for k, v in ttr.data.items()}
    g64, _ = ttr.step_fn.grads_and_metrics(
        _to_f64(params_to_numpy(ttr.params)), ttr.aabb.double(), data64, ri_t, rr_t, None, tsc
    )
    return dict(
        jm={k: float(v) for k, v in jm.items()},
        tm={k: float(v) for k, v in tm.items()},
        jg=jg,
        jg64=jg64,
        tg=params_to_numpy(tg),
        g64=params_to_numpy(g64),
        port=(ttr, ri_t, rr_t, tsc),
    )


def test_every_loss_term_matches(step_pair):
    jm, tm = step_pair["jm"], step_pair["tm"]
    assert set(jm) == set(tm)
    assert len(jm) > 30
    for k in sorted(jm):
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-9, err_msg=k)


def _rel(a, ref):
    return float(np.abs(a - ref).max()) / max(float(np.abs(ref).max()), 1e-30)


def test_every_param_gradient_matches_in_float64(step_pair):
    jg64 = dict(_leaves(step_pair["jg64"]))
    g64 = dict(_leaves(step_pair["g64"]))
    assert set(jg64) == set(g64)
    assert {str(v.dtype) for v in jg64.values()} == {"float64"}
    worst = max(_rel(g64[path], jg64[path]) for path in jg64)
    print(f"worst float64 gradient difference: {worst:.3e} of scale")
    for path in sorted(jg64, key=str):
        assert _rel(g64[path], jg64[path]) <= 1e-6, path


def test_every_param_gradient_matches(step_pair):
    jg = dict(_leaves(step_pair["jg"]))
    jg64 = dict(_leaves(step_pair["jg64"]))
    tg = dict(_leaves(step_pair["tg"]))
    g64 = dict(_leaves(step_pair["g64"]))
    assert set(jg) == set(tg) == set(jg64) == set(g64)
    assert {p[0] for p in jg} == {"static", "dynamic", "pose", "fov"}
    assert ILL_CONDITIONED <= set(jg)
    for path in sorted(jg, key=str):
        rel = _rel(tg[path], jg[path])
        if path in ILL_CONDITIONED:
            # the reference's own float32 error on this leaf
            ref_noise = _rel(jg[path], jg64[path])
            bound = 1e-4 + 2.0 * ref_noise
            print(f"{path}: rel {rel:.3e}, JAX f32 noise {ref_noise:.3e}, bound {bound:.3e}, "
                  f"port f32 vs its f64 {_rel(tg[path], g64[path]):.3e}")
            assert rel <= bound, (path, rel, ref_noise)
        else:
            assert rel <= 1e-4, (path, rel)


def _promoted(fn):
    """fn computed in float64 inside the float32 step: every floating
    tensor argument (nested in dicts, lists and packed tables) cast up, the
    results cast back down."""
    from rodynrf_tpu_torch.ops.fused_vm import PackedVM

    def cast(x, dtype):
        if torch.is_tensor(x):
            return x.to(dtype) if x.is_floating_point() else x
        if isinstance(x, dict):
            return {k: cast(v, dtype) for k, v in x.items()}
        if isinstance(x, PackedVM):
            return PackedVM(cast(x.tables, dtype), cast(x.line_tables, dtype), x.meta)
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(cast(v, dtype) for v in x))
        if isinstance(x, (list, tuple)):
            return type(x)(cast(v, dtype) for v in x)
        return x

    def run(*args, **kwargs):
        out = fn(*cast(list(args), torch.float64), **cast(kwargs, torch.float64))
        return cast(out, torch.float32)
    return run


def test_float32_error_sits_in_the_dynamic_field_evaluation(step_pair, monkeypatch):
    """Where the port's float32 error on the ill-conditioned leaves comes
    from (ROADMAP queue 3.2): computing the whole dynamic field evaluation
    in float64 inside the float32 step removes most of it; computing the
    compositors (the cumprod transmittance and its backward, the weight
    renormalisation) or the distortion loss in float64 moves it by no more
    than a tenth. So no single op carries it: it is the float32 rounding of
    the evaluation as a whole, not an op-order difference to match."""
    from rodynrf_tpu_torch.train import step as tstep

    ttr, ri, rr, sc = step_pair["port"]
    g64 = dict(_leaves(step_pair["g64"]))
    leaf = ("dynamic", "density_head", 1, "b")

    def error(**promote):
        with monkeypatch.context() as m:
            for name in promote:
                m.setattr(tstep, name, _promoted(getattr(tstep, name)))
            g, _ = ttr.step_fn.grads_and_metrics(ttr.params, ttr.aabb, ttr.data, ri, rr, None, sc)
        return _rel(dict(_leaves(params_to_numpy(g)))[leaf], g64[leaf])

    base = error()
    field = error(eval_dynamic_field=1)
    ops = {name: error(**{name: 1}) for name in
           ("raw2outputs", "dynamic_side_weights", "static_side_outputs", "eff_distloss")}
    print(f"{leaf}: port f32 error {base:.3e} of scale; dynamic field evaluation in float64 "
          f"{field:.3e}; " + ", ".join(f"{k} in float64 {v:.3e}" for k, v in ops.items()))
    assert field < 0.2 * base
    for name, e in ops.items():
        assert abs(e - base) <= 0.1 * base, (name, e, base)


@pytest.mark.parametrize("flag", [
    "--n_devices 2", "--ckpt some.npz", "--grad_impl csum", "--shard_grids 1",
])
def test_unported_options_raise(flag):
    # resuming is ported: a checkpoint that is not there is a missing file
    error = FileNotFoundError if flag.startswith("--ckpt") else NotImplementedError
    with pytest.raises(error):
        TTrainer(tparse(tiny_cmd("ndc", 1) + " " + flag), ttiny_scene("ndc"), device="cpu")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError):
        TTrainer(tparse(CMD), ttiny_scene("ndc"))
