"""The sample-sharded dual compositor (rodynrf_tpu_torch/parallel/
sample_shard.py) on a (2 ray × 2 sample) mesh of four gloo ranks, against
the JAX package's `make_sample_sharded_raw2outputs` on `make_2d_mesh(2, 2)`
and against the port's dense `raw2outputs`, on tests/test_sample_shard.py's
inputs and at its tolerances: outputs rtol 2e-5 / atol 1e-4 (ndc and
contract rays, and the white fill), the gradients of sum(rgb_full) +
0.1 sum(depth_full) to both sigmas rtol 5e-5 / atol 5e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rodynrf_tpu.parallel.sample_shard import (
    make_2d_mesh,
    make_sample_sharded_raw2outputs,
    shard_compositor_inputs,
)
from rodynrf_tpu_torch.ops.compositing import raw2outputs
from rodynrf_tpu_torch.parallel.launch import run_ranks
from rodynrf_tpu_torch.parallel.sample_shard import make_2d_mesh as tmake_2d_mesh
from test_sample_shard import R, _inputs
from torch_parallel_ranks import compositor_run

SEEDS = {"ndc": 0, "contract": 0, "white": 1, "grads": 2}
WHITE = np.asarray([i % 2 == 0 for i in range(R)])
OUT_TOL = dict(rtol=2e-5, atol=1e-4)
GRAD_TOL = dict(rtol=5e-5, atol=5e-6)


def _assemble(ranks, case, key):
    """The whole [R] or [R, S] array of `key` from every rank's block."""
    blocks = {(i, k): res[key] if key.startswith("grad") else res[case][key]
              for i, k, res, _ in ranks}
    if not key.startswith(("weights", "grad")):  # per-ray: whole on a sample group
        for i in range(2):
            np.testing.assert_array_equal(blocks[(i, 0)], blocks[(i, 1)])
        return np.concatenate([blocks[(i, 0)] for i in range(2)], 0)
    return np.concatenate([np.concatenate([blocks[(i, k)] for k in range(2)], 1)
                           for i in range(2)], 0)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    path = tmp_path_factory.mktemp("compositor") / "inputs.npz"
    arrays = {f"{case}_{i}": a for case, seed in SEEDS.items()
              for i, a in enumerate(_inputs(seed))}
    np.savez(path, white=WHITE, **arrays)
    return run_ranks(compositor_run, 4, "cpu", (str(path),))


def test_ranks_import_no_jax(ranks):
    assert len(ranks) == 4 and not any(r[3] for r in ranks)
    assert sorted((i, k) for i, k, _, _ in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]


def _jax_outputs(case):
    args = _inputs(SEEDS[case])
    mesh = make_2d_mesh(2, 2)
    ray_type = "contract" if case == "contract" else "ndc"
    fn = make_sample_sharded_raw2outputs(mesh, is_train=case == "white", ray_type=ray_type)
    placed = shard_compositor_inputs(mesh, *args)
    if case == "white":
        w = jax.device_put(jnp.asarray(WHITE), jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec("ray")))
        return jax.jit(fn)(*placed, w)
    return jax.jit(fn)(*placed)


@pytest.mark.parametrize("case", ["ndc", "contract", "white"])
def test_outputs_match_jax_and_the_dense_compositor(ranks, case):
    ref_jax = _jax_outputs(case)
    args = [torch.from_numpy(a) for a in _inputs(SEEDS[case])]
    ref_dense = raw2outputs(*args, is_train=case == "white",
                            ray_type="contract" if case == "contract" else "ndc",
                            white=torch.from_numpy(WHITE) if case == "white" else None)
    for name in ref_jax._fields:
        ours = _assemble(ranks, case, name)
        np.testing.assert_allclose(ours, np.asarray(getattr(ref_jax, name)), **OUT_TOL,
                                   err_msg=f"{name} vs JAX")
        np.testing.assert_allclose(ours, getattr(ref_dense, name).numpy(), **OUT_TOL,
                                   err_msg=f"{name} vs dense")


def test_sigma_gradients_match_jax_and_the_dense_compositor(ranks):
    args = _inputs(SEEDS["grads"])
    mesh = make_2d_mesh(2, 2)
    fn = make_sample_sharded_raw2outputs(mesh, is_train=False, ray_type="ndc")
    placed = shard_compositor_inputs(mesh, *args)

    def loss_sharded(sigma_s, sigma_d):
        out = fn(placed[0], sigma_s, placed[2], sigma_d, *placed[4:])
        return jnp.sum(out.rgb_full) + jnp.sum(out.depth_full * 0.1)

    g_jax = jax.jit(jax.grad(loss_sharded, (0, 1)))(placed[1], placed[3])
    t = [torch.from_numpy(a) for a in args]
    t[1].requires_grad_(True)
    t[3].requires_grad_(True)
    out = raw2outputs(*t, is_train=False, ray_type="ndc")
    (out.rgb_full.sum() + (out.depth_full * 0.1).sum()).backward()
    for key, j, dense in (("grad_sigma_s", g_jax[0], t[1].grad),
                          ("grad_sigma_d", g_jax[1], t[3].grad)):
        ours = _assemble(ranks, "grads", key)
        np.testing.assert_allclose(ours, np.asarray(j), **GRAD_TOL, err_msg=f"{key} vs JAX")
        np.testing.assert_allclose(ours, dense.numpy(), **GRAD_TOL, err_msg=f"{key} vs dense")


def test_too_few_ranks_raise_as_in_jax():
    with pytest.raises(ValueError, match=r"needs 4 devices, but only 0 are available"):
        tmake_2d_mesh(2, 2, "cpu")
