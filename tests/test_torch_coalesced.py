"""The port's plane sampling and table gradients
(rodynrf_tpu_torch/ops/coalesced.py) against the JAX package's.

The plain `coalesce_table_grad` is held to the JAX Pallas kernel
`_coalesce_pallas` run in interpret mode (as tests/test_coalesced.py runs
it on the CPU) and to the XLA scatter `_coalesce_xla`, at 1e-4 as there
(f32 sums in another order). `planes_sample` and `merged_sample` and their
autograd gradients are held to `jax.vjp` of the JAX functions at 1e-5 in
f32. With bf16 tables the port accumulates the table gradient in f32 and
rounds once: within 1 bf16 ulp of the JAX f32-accumulating routes (the
Pallas kernels in interpret mode), and within 3e-2 of the gradient's scale
of the JAX package's default bf16-accumulating routes, the bound of
tests/test_coalesced.py. The CUDA kernels are held to their plain versions
on the card by tests/test_torch_kernels.py, which imports no JAX so that it
runs on a machine with a card.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import rodynrf_tpu.ops.coalesced as jco
from rodynrf_tpu.ops.pallas_segsum import segment_rows_sum as jsegsum
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


def _within_bf16_ulp(got, want, scale):
    """|got - want| ≤ 1 bf16 ulp of the larger magnitude, elementwise. Both
    are f32 sums rounded once to bf16; the 1e-6 × scale slack covers entries
    whose f32 sums cancel to near zero, where the two summation orders leave
    f32 noise larger than a bf16 ulp of the tiny result."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    mag = np.maximum(np.abs(got), np.abs(want))
    ulp = np.where(mag > 0, 2.0 ** (np.floor(np.log2(np.maximum(mag, 1e-38))) - 7), 0.0)
    bad = np.abs(got - want) > ulp + 1e-6 * scale
    assert not bad.any(), (int(bad.sum()), float(np.abs(got - want).max()))


def _merged_data(seed, M=1500, R=97, nS=3, C=8, dtype=np.float32):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, R, M)
    rows[: M // 3] = rng.integers(0, 4, M // 3)  # hot rows, as a ray's o0 cells
    table = rng.standard_normal((R, nS * 4 * C)).astype(np.float32)
    w = rng.uniform(0, 1, (M, nS, 4)).astype(np.float32)
    ct = rng.standard_normal((M, nS, C)).astype(np.float32)
    return table, rows.astype(np.int32), w, ct


def _merged_port(table, rows, w, ct, dtype):
    t = torch.from_numpy(table).to(dtype).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    got = tco.merged_sample(t, torch.from_numpy(rows), tw)
    got.backward(torch.from_numpy(ct))
    return got.detach().numpy(), t.grad, tw.grad.numpy()


def test_merged_sample_f32_matches_jax():
    """f32 table: forward equal to the JAX `_merged_fwd_math`; the table and
    weight gradients against `jax.vjp` of it (the JAX inline merged take,
    the train step's route) at 1e-5."""
    table, rows, w, ct = _merged_data(8)
    want, vjp = jax.vjp(lambda t, ww: jco._merged_fwd_math(t, jnp.asarray(rows), ww),
                        jnp.asarray(table), jnp.asarray(w))
    want_gt, want_gw = vjp(jnp.asarray(ct))
    got, gt, gw = _merged_port(table, rows, w, ct, torch.float32)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert gt.dtype == torch.float32
    np.testing.assert_allclose(gt.numpy(), np.asarray(want_gt), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gw, np.asarray(want_gw), rtol=1e-5, atol=1e-5)


def test_merged_sample_bf16_table():
    table, rows, w, ct = _merged_data(9)
    R, M = table.shape[0], rows.shape[0]
    jt = jnp.asarray(table).astype(jnp.bfloat16)
    want, vjp = jax.vjp(lambda t: jco._merged_fwd_math(t, jnp.asarray(rows), jnp.asarray(w)), jt)
    (want_auto,) = vjp(jnp.asarray(ct))
    # the f32-accumulation reference: the same bf16 u through the JAX Pallas
    # segment sum (interpret mode), cast to bf16
    u = (jnp.asarray(w)[..., None] * jnp.asarray(ct)[:, :, None, :]).astype(jnp.bfloat16)
    want_f32acc = jsegsum(jnp.asarray(rows), u.reshape(M, -1), R, interpret=True).astype(
        jnp.bfloat16)

    got, gt, _ = _merged_port(table, rows, w, ct, torch.bfloat16)
    assert gt.dtype == torch.bfloat16
    scale = float(np.abs(np.asarray(want)).max())
    assert float(np.abs(got - np.asarray(want)).max()) <= 1e-6 * scale
    gt = gt.float().numpy()
    gscale = float(np.abs(np.asarray(want_f32acc, np.float32)).max())
    _within_bf16_ulp(gt, want_f32acc, gscale)
    want_auto = np.asarray(want_auto, np.float32)
    assert float(np.abs(gt - want_auto).max()) <= 3e-2 * float(np.abs(want_auto).max())


def test_merged_sample_saves_no_gathered_block():
    table, rows, w, _ = _merged_data(10, M=200)
    out = tco.merged_sample(torch.from_numpy(table).requires_grad_(True),
                            torch.from_numpy(rows), torch.from_numpy(w).requires_grad_(True))
    saved = out.grad_fn.saved_tensors
    assert [tuple(s.shape) for s in saved] == [table.shape, rows.shape, w.shape]


def test_planes_sample_bf16_table():
    """bf16 table (the static field): the gradient accumulates in f32 —
    within 1 bf16 ulp of the JAX `impl='pallas'` route in interpret mode,
    within 3e-2 of scale of the JAX default ('auto', bf16 accumulation)."""
    table, rows, w4, ct = _data(12, 2000, 131, 8)
    jt = jnp.asarray(table).astype(jnp.bfloat16)

    def jax_grad(impl):
        _, vjp = jax.vjp(lambda t: jco.planes_sample(t, jnp.asarray(rows), jnp.asarray(w4), impl),
                         jt)
        return np.asarray(vjp(jnp.asarray(ct))[0], np.float32)

    orig = pl.pallas_call
    with mock.patch.object(pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True})):
        want_pallas = jax_grad("pallas")
    want_auto = jax_grad("auto")
    t = torch.from_numpy(table).to(torch.bfloat16).requires_grad_(True)
    tco.planes_sample(t, torch.from_numpy(rows), torch.from_numpy(w4)).backward(
        torch.from_numpy(ct))
    assert t.grad.dtype == torch.bfloat16
    got = t.grad.float().numpy()
    _within_bf16_ulp(got, want_pallas, float(np.abs(want_pallas).max()))
    assert float(np.abs(got - want_auto).max()) <= 3e-2 * float(np.abs(want_auto).max())
