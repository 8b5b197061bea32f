"""The port's train step on 2 gloo ranks against the JAX package's step on
its 2-device data mesh (`make_mesh(2)`, `shard_train_inputs`,
`shard_batch_indices`): the same converted weights, ray batches and
golden_det draws, f32 strided tables, iteration 25.

- Every loss term agrees to 1e-5 relative.
- Every float32 gradient agrees under tests/test_torch_step.py's rule: 1e-4
  of scale, the ILL_CONDITIONED leaves 1e-4 plus twice the JAX package's
  own float32 error on the leaf (its mesh step's float32 run against its
  x64 run).

The one place the JAX mesh step is compiled for the port's tests (twice:
f32 and x64), so it has a file of its own.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rodynrf_tpu.parallel import make_mesh, shard_batch_indices, shard_train_inputs
from rodynrf_tpu.testing import tiny_scene as jtiny_scene
from rodynrf_tpu.train import Trainer as JTrainer, parse_cmd as jparse
from rodynrf_tpu.train.schedule import PermutationSampler
from rodynrf_tpu.train.step import make_train_step as jmake_step
from rodynrf_tpu_torch.parallel.launch import run_ranks
from rodynrf_tpu_torch.testing import torch_threads
from test_torch_step import CMD, ILL_CONDITIONED, IT, _jnp64, _leaves, _rel
from torch_parallel_ranks import STRIDED, step_cases


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def _mesh_grads(jtr, mesh, ri, rr, dtype):
    jstep = jmake_step(jtr._statics(), donate=False)
    sc = {"iteration": jnp.asarray(IT, jnp.int32),
          "focal_fixed": jnp.asarray(jtr.focal_fixed, dtype)}
    sc.update({k: jnp.asarray(v, dtype) for k, v in jtr.schedule.scalars(IT).items()})
    params, aabb, data = jtr.params, jtr.aabb, jtr.data
    if dtype == jnp.float64:
        params, data = (jax.tree_util.tree_map(_jnp64, t) for t in (params, data))
        aabb = _jnp64(aabb)
    params, _, aabb, data = shard_train_inputs(mesh, params, jtr.opt_state, aabb, data)
    with mesh:
        g, m = jax.jit(jstep.grads_and_metrics)(
            params, aabb, data, shard_batch_indices(mesh, jnp.asarray(ri)),
            shard_batch_indices(mesh, jnp.asarray(rr)), jax.random.PRNGKey(0), sc)
    return jax.tree_util.tree_map(np.asarray, g), {k: float(v) for k, v in m.items()}


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    assert CMD == STRIDED
    ja = jparse(CMD + " --n_devices 2")
    ja.golden_det = 1
    jtr = JTrainer(ja, jtiny_scene("ndc"))
    mesh = jtr.mesh
    assert mesh is not None and mesh.size == 2 and mesh == make_mesh(2)
    ps = PermutationSampler(jtr.scene.n_rays, jtr.args.batch_size, 7)
    ri, rr = ps.nextids(), ps.nextids()
    jg, jm = _mesh_grads(jtr, mesh, ri, rr, jnp.float32)
    with jax.enable_x64(True):
        jg64, _ = _mesh_grads(jtr, mesh, ri, rr, jnp.float64)

    path = tmp_path_factory.mktemp("weights") / "params.pkl"
    with open(path, "wb") as f:
        pickle.dump(jax.tree_util.tree_map(np.asarray, jtr.params), f)
    out, loaded = run_ranks(step_cases, 2, "cpu", ([("f32", False)], str(path)))
    tg, tm, _ = out[("f32", False)]
    return dict(jg=dict(_leaves(jg)), jg64=dict(_leaves(jg64)), jm=jm, tg=dict(_leaves(tg)),
                tm=tm, loaded=loaded)


def test_every_loss_term_matches_the_jax_mesh_step(pair):
    jm, tm = pair["jm"], pair["tm"]
    assert not pair["loaded"]
    assert set(jm) == set(tm) and len(jm) > 30
    for k in sorted(jm):
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-9, err_msg=k)


def test_every_param_gradient_matches_the_jax_mesh_step(pair):
    jg, jg64, tg = pair["jg"], pair["jg64"], pair["tg"]
    assert set(jg) == set(tg) == set(jg64)
    assert {p[0] for p in jg} == {"static", "dynamic", "pose", "fov"}
    for path in sorted(jg, key=str):
        rel = _rel(tg[path], jg[path])
        bound = 1e-4
        if path in ILL_CONDITIONED:
            bound += 2.0 * _rel(jg[path], jg64[path])
        assert rel <= bound, (path, rel, bound)
