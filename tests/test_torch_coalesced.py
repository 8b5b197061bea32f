"""The port's plane-table gradient (rodynrf_tpu_torch/ops/coalesced.py)
against the JAX package's.

The plain `coalesce_table_grad` is held to the JAX Pallas kernel
`_coalesce_pallas` run in interpret mode (as tests/test_coalesced.py runs
it on the CPU) and to the XLA scatter `_coalesce_xla`, at 1e-4 as there
(f32 sums in another order). `planes_sample` and its autograd gradients are
held to `jax.vjp` of the JAX `planes_sample` at 1e-5. The CUDA kernel is
held to the plain version on the card by tests/test_torch_kernels.py, which
imports no JAX so that it runs on a machine with a card.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import rodynrf_tpu.ops.coalesced as jco
from rodynrf_tpu_torch.ops import coalesced as tco


def _data(seed, M, R, C, dup_hot=True):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, R, M)
    if dup_hot:  # stride-4 style duplication hot spots
        rows[: M // 3] = rng.integers(0, max(R // 40, 2), M // 3)
    table = rng.standard_normal((R, 4 * C)).astype(np.float32)
    w4 = rng.uniform(0, 1, (M, 4)).astype(np.float32)
    ct = rng.standard_normal((M, C)).astype(np.float32)
    return table, rows.astype(np.int32), w4, ct


def _pallas_interpret(rows, w4, ct, R):
    orig = pl.pallas_call

    def interp_call(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    with mock.patch.object(pl, "pallas_call", interp_call):
        return np.asarray(jco._coalesce_pallas(jnp.asarray(rows), jnp.asarray(w4),
                                               jnp.asarray(ct), R))


def _plain(rows, w4, ct, R):
    return tco.coalesce_table_grad(
        torch.from_numpy(rows), torch.from_numpy(w4), torch.from_numpy(ct), R
    ).numpy()


def _empty_blocks_rows(seed, R, M):
    """Keys concentrated in a few blocks far apart, as in
    tests/test_coalesced.py: empty-block walking and the final-flush tail."""
    rng = np.random.default_rng(seed)
    return np.concatenate([
        rng.integers(0, 10, M // 3),
        rng.integers(2000, 2010, M // 3),
        rng.integers(R - 5, R, M - 2 * (M // 3)),
    ]).astype(np.int32)


@pytest.mark.parametrize("M,R,C", [(3000, 257, 12), (2048, 64, 8), (100, 1000, 4)])
def test_plain_matches_jax_pallas_and_xla(M, R, C):
    _, rows, w4, ct = _data(M + R + C, M, R, C)
    got = _plain(rows, w4, ct, R)
    np.testing.assert_allclose(got, _pallas_interpret(rows, w4, ct, R), rtol=1e-4, atol=1e-4)
    want_xla = np.asarray(jco._coalesce_xla(jnp.asarray(rows), jnp.asarray(w4),
                                            jnp.asarray(ct), R))
    np.testing.assert_allclose(got, want_xla, rtol=1e-4, atol=1e-4)


def test_plain_matches_jax_pallas_empty_blocks():
    R, C, M = 4096, 8, 600
    rng = np.random.default_rng(11)
    rows = _empty_blocks_rows(11, R, M)
    w4 = rng.uniform(0, 1, (M, 4)).astype(np.float32)
    ct = rng.standard_normal((M, C)).astype(np.float32)
    got = _plain(rows, w4, ct, R)
    np.testing.assert_allclose(got, _pallas_interpret(rows, w4, ct, R), rtol=1e-4, atol=1e-4)
    # rows no sample reaches are exact zeros
    untouched = np.setdiff1d(np.arange(R), rows)
    assert np.all(got[untouched] == 0.0)


def test_planes_sample_value_and_grads_match_jax():
    table, rows, w4, ct = _data(5, 3000, 257, 12)
    want, vjp = jax.vjp(
        lambda t, w: jco.planes_sample(t, jnp.asarray(rows), w),
        jnp.asarray(table), jnp.asarray(w4),
    )
    want_gt, want_gw = vjp(jnp.asarray(ct))

    t = torch.from_numpy(table).requires_grad_(True)
    w = torch.from_numpy(w4).requires_grad_(True)
    got = tco.planes_sample(t, torch.from_numpy(rows), w)
    got.backward(torch.from_numpy(ct))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_gt), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(w.grad.numpy(), np.asarray(want_gw), rtol=1e-5, atol=1e-5)


def test_planes_sample_saves_no_gathered_block():
    """The backward re-gathers: autograd keeps (table, rows, w4) and no
    [M, 4C] gathered block."""
    table, rows, w4, _ = _data(6, 500, 64, 8)
    t = torch.from_numpy(table).requires_grad_(True)
    w = torch.from_numpy(w4).requires_grad_(True)
    out = tco.planes_sample(t, torch.from_numpy(rows), w)
    saved = out.grad_fn.saved_tensors
    assert [tuple(s.shape) for s in saved] == [table.shape, rows.shape, w4.shape]


def test_kernel_input_checks_on_cpu_route():
    _, rows, w4, ct = _data(7, 64, 16, 4)
    with pytest.raises(TypeError):
        tco.coalesce_table_grad(torch.from_numpy(rows).long(), torch.from_numpy(w4),
                                torch.from_numpy(ct), 16)
    with pytest.raises(ValueError):
        tco.coalesce_table_grad(torch.from_numpy(rows), torch.from_numpy(w4[:, :3]),
                                torch.from_numpy(ct), 16)
