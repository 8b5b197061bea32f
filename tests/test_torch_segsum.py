"""The port's segment row-sum (rodynrf_tpu_torch/ops/segsum.py) against the
JAX package's Pallas kernel `segment_rows_sum`, run in interpret mode as
tests/test_pallas_segsum.py runs it on the CPU.

On CPU tensors the port takes its plain `index_add_` version. Both sum in
f32 (bf16 updates are widened exactly), in another order: tolerance 1e-5 of
max|ref|. The CUDA kernel is held to the plain version on the card by
tests/test_torch_kernels.py, which imports no JAX.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rodynrf_tpu.ops.pallas_segsum import segment_rows_sum as jsegsum
from rodynrf_tpu.ops.pallas_segsum import sorted_segment_rows_sum as jsorted
from rodynrf_tpu_torch.ops import segsum as tseg


def _idx(pattern, M, R, rng):
    if pattern == "hot":  # one row takes most entries (a ray's o0 cell)
        idx = rng.integers(0, R, M)
        idx[: 3 * M // 4] = R // 3
    elif pattern == "empty":  # a few clusters, most rows untouched
        idx = np.concatenate([rng.integers(0, 4, M // 2), rng.integers(R - 6, R, M - M // 2)])
    elif pattern == "trash":  # entries on the trash bin n_rows are dropped
        idx = rng.integers(0, R + 1, M)
        idx[::5] = R
    else:
        idx = rng.integers(0, R, M)
    return idx.astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pattern", ["random", "hot", "empty", "trash"])
def test_plain_matches_jax_pallas(pattern, dtype):
    M, R, C = 1500, 300, 48
    rng = np.random.default_rng(len(pattern))
    idx = _idx(pattern, M, R, rng)
    upd32 = rng.standard_normal((M, C)).astype(np.float32)
    jupd = jnp.asarray(upd32).astype(dtype)
    want = np.asarray(jsegsum(jnp.asarray(idx), jupd, R, interpret=True))
    tupd = torch.from_numpy(upd32).to(getattr(torch, dtype))
    got = tseg.segment_rows_sum(torch.from_numpy(idx), tupd, R)
    assert got.dtype == torch.float32 and got.shape == (R, C)
    scale = float(np.abs(want).max())
    assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * scale
    untouched = np.setdiff1d(np.arange(R), idx)
    assert np.all(got.numpy()[untouched] == 0.0)


def test_sorted_form_with_and_without_permutation():
    """sorted_segment_rows_sum on sorted keys, reading upd in key order or
    through a permutation, against the JAX sorted kernel."""
    M, R, C = 1100, 130, 16
    rng = np.random.default_rng(3)
    idx = _idx("trash", M, R, rng)
    upd = rng.standard_normal((M, C)).astype(np.float32)
    order = np.argsort(idx, kind="stable")
    keys = idx[order]
    want = np.asarray(jsorted(jnp.asarray(keys), jnp.asarray(upd[order]), R, interpret=True))
    scale = float(np.abs(want).max())
    direct = tseg.sorted_segment_rows_sum(torch.from_numpy(keys), torch.from_numpy(upd[order]), R)
    through = tseg.sorted_segment_rows_sum(torch.from_numpy(keys), torch.from_numpy(upd), R,
                                           perm=torch.from_numpy(order.astype(np.int32)))
    for got in (direct, through):
        assert float(np.abs(got.numpy() - want).max()) <= 1e-5 * scale
    assert torch.equal(direct, through)


def test_cpu_route_checks_inputs_and_counts_nothing():
    idx = torch.tensor([0, 2, 2, 5], dtype=torch.int32)
    upd = torch.randn(4, 8)
    before = tseg.sorted_segment_rows_sum.launches
    with pytest.raises(TypeError):
        tseg.segment_rows_sum(idx.long(), upd, 6)
    with pytest.raises(ValueError):
        tseg.segment_rows_sum(idx[:3], upd, 6)
    with pytest.raises(RuntimeError):  # past the trash bin
        tseg.segment_rows_sum(idx, upd, 4)
    got = tseg.segment_rows_sum(idx, upd, 6)
    np.testing.assert_array_equal(got[2].numpy(), (upd[1] + upd[2]).numpy())
    assert tseg.sorted_segment_rows_sum.launches == before
