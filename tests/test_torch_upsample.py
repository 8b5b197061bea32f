"""The voxel upsample of the port's trainer against the JAX package's, at
the TINY shapes of test_torch_step.py with the default 'auto' layout.

Both trainers take one step (so every Adam has moments), then get the same
parameters, then `_upsample` at upsamp_list[0]. The port must give the same
parameters (1e-6: align_corners resize by f32 interpolation matrices in
both), grid, sample count, table layout per field and learning rates; the
fields' Adam starts fresh over the new leaves while the pose and fov Adams
keep their moments, as in the reference (train.py:2589-2606). The next
step's losses agree to 1e-4.
"""

import jax
import numpy as np
import pytest
import torch

from rodynrf_tpu_torch.train.convert import params_to_numpy
from rodynrf_tpu_torch.train.step import named_leaves
from test_torch_step import _leaves
from test_torch_step_merged import CMD, _jax_layouts, _trainers


@pytest.fixture(scope="module")
def upsampled():
    """Both trainers one step in (so every Adam has moments), then the same
    parameters in both, then `_upsample` at upsamp_list[0]."""
    jtr, ttr = _trainers(CMD)
    jtr.run_step()
    ttr.run_step()
    want = dict(_leaves(jax.tree_util.tree_map(np.asarray, jtr.params)))
    with torch.no_grad():
        for path, t in named_leaves(ttr.params):
            t.copy_(torch.as_tensor(np.array(want[path])))
    it = jtr.args.upsamp_list[0]
    jtr.iteration = ttr.iteration = it
    kept = {k: (ttr.opt_state[k], {n: v.clone() for n, v in
                                   ttr.opt_state[k].state[ttr.params[k]].items()},
                jtr.opt_state[k]) for k in ("pose", "fov")}
    for tr in (jtr, ttr):
        n_before = len(tr.n_voxel_list)
        tr._upsample(it)
        assert len(tr.n_voxel_list) == n_before - 1
        tr.iteration = it + 1
    return jtr, ttr, kept


def test_upsample_matches_jax(upsampled):
    jtr, ttr, kept = upsampled
    want = dict(_leaves(jax.tree_util.tree_map(np.asarray, jtr.params)))
    got = dict(_leaves(params_to_numpy(ttr.params)))
    assert set(got) == set(want)
    for path in want:
        assert got[path].shape == want[path].shape, path
        np.testing.assert_allclose(got[path], want[path], rtol=1e-6, atol=1e-6,
                                   err_msg=str(path))
    assert tuple(ttr.static_cfg.grid_size) == tuple(jtr.static_cfg.grid_size)
    assert tuple(ttr.dynamic_cfg.grid_size) == tuple(jtr.dynamic_cfg.grid_size)
    assert ttr.n_samples == jtr.n_samples
    # the step was rebuilt for the new grid and sample count
    S = ttr.step_fn.S
    assert (S.static_cfg, S.dynamic_cfg, S.n_samples) == (
        ttr.static_cfg, ttr.dynamic_cfg, ttr.n_samples)
    assert ttr.table_layouts() == _jax_layouts(jtr)
    i = ttr.iteration
    assert ttr.schedule.scalars(i) == pytest.approx(jtr.schedule.scalars(i), rel=1e-12)
    # the fields' Adam starts fresh over the new leaves; pose and fov keep theirs
    fields = ttr.opt_state["fields"]
    assert fields.state == {}
    new_leaves = {id(t) for _, t in named_leaves({"s": ttr.params["static"],
                                                  "d": ttr.params["dynamic"]})}
    assert {id(t) for g in fields.param_groups for t in g["params"]} == new_leaves
    for _, leaf in jax.tree_util.tree_flatten_with_path(jtr.opt_state["fields"])[0]:
        assert not np.asarray(leaf).any()
    for k, (opt, state, jstate) in kept.items():
        assert ttr.opt_state[k] is opt and jtr.opt_state[k] is jstate
        now = opt.state[ttr.params[k]]
        assert set(now) == set(state)
        for n in state:
            assert torch.equal(now[n], state[n]), (k, n)
        assert float(state["exp_avg_sq"].abs().max()) > 0


def test_step_after_upsample_matches_jax(upsampled):
    jtr, ttr, _ = upsampled
    jm = {k: float(v) for k, v in jtr.run_step().items()}
    tm = {k: float(v) for k, v in ttr.run_step().items()}
    assert set(jm) == set(tm)
    for k in sorted(jm):
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=1e-7, err_msg=k)
