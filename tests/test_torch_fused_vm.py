"""The port's fused VM sampler (rodynrf_tpu_torch/ops/fused_vm.py, strided
layout) against the JAX package's `pack_vm(..., layout="strided")` +
`sample_vm_fused`: values and gradients with respect to the planes, the
lines (through the packed tables) and the coordinates, at 1e-5. The port's
line factors are the 2-tap lerp where the JAX package runs a hat-weight
matmul; the two agree to float rounding.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rodynrf_tpu.ops import fused_vm as jvm
from rodynrf_tpu_torch.ops import fused_vm as tvm
from rodynrf_tpu_torch.ops.grid_sample import MAT_MODE, VEC_MODE

GRID = (13, 17, 11)


def _grids(rng, comps):
    out = []
    for n_comp in comps:
        planes = [rng.standard_normal((n_comp[i], GRID[MAT_MODE[i][1]], GRID[MAT_MODE[i][0]]))
                  .astype(np.float32) for i in range(3)]
        lines = [rng.standard_normal((n_comp[i], GRID[VEC_MODE[i]])).astype(np.float32)
                 for i in range(3)]
        out.append((planes, lines))
    return out


@pytest.mark.parametrize("strides", [(1,), (1, 2), (1, 2, 4)])
def test_sample_vm_fused_matches_jax(strides):
    rng = np.random.default_rng(len(strides))
    grids = _grids(rng, [(5, 2, 3), (4, 4, 2)])
    # out-of-range samples exercise the zero-padding bands
    xyz = rng.uniform(-1.3, 1.3, (257, 3)).astype(np.float32)

    def jax_fn(gr, x):
        packed = jvm.pack_vm(gr, strides=strides, layout="strided")
        return jvm.sample_vm_fused(packed, x)

    jgr = [([jnp.asarray(p) for p in ps], [jnp.asarray(l) for l in ls]) for ps, ls in grids]
    want, vjp = jax.vjp(jax_fn, jgr, jnp.asarray(xyz))
    cts = [rng.standard_normal(np.shape(w)).astype(np.float32) for w in want]
    want_ggr, want_gx = vjp([jnp.asarray(c) for c in cts])

    tgr = [([torch.from_numpy(p).requires_grad_(True) for p in ps],
            [torch.from_numpy(l).requires_grad_(True) for l in ls]) for ps, ls in grids]
    tx = torch.from_numpy(xyz).requires_grad_(True)
    got = tvm.sample_vm_fused(tvm.pack_vm(tgr, strides=strides, layout="strided"), tx)
    torch.autograd.backward(got, [torch.from_numpy(c) for c in cts])

    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_gx), rtol=1e-5, atol=1e-5)
    for (tps, tls), (wps, wls) in zip(tgr, want_ggr):
        for t, w in zip(tps + tls, list(wps) + list(wls)):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_merged_layout_raises():
    grids = _grids(np.random.default_rng(0), [(2, 2, 2)])
    tgr = [([torch.from_numpy(p) for p in ps], [torch.from_numpy(l) for l in ls])
           for ps, ls in grids]
    with pytest.raises(NotImplementedError):
        tvm.pack_vm(tgr, strides=(1, 2, 4), layout="merged")
    # small multiscale tables: 'auto' resolves to merged, as in the JAX package
    with pytest.raises(NotImplementedError):
        tvm.pack_vm(tgr, strides=(1, 2, 4), layout="auto")
    assert tvm.pack_vm(tgr, strides=(1,), layout="auto").meta["layout"] == "strided"


@pytest.mark.parametrize("n", [1, 2, 5, 8, 17, 220, 331, 368])
def test_auto_layout_rule_matches_jax(n):
    strides = (1, 2, 4)
    assert tvm._merged_axis_len(n, strides) == len(jvm._axis_seg_maps(n, strides)[0][0])


def test_auto_layout_at_300_cubed_f32_is_strided():
    """The f32 300³ dynamic field resolves to the strided layout (its merged
    tables exceed the byte limit), as the JAX package decides."""
    shapes = [(16, 4, 4), (16, 4, 4), (48, 12, 12)]
    reso = (331, 368, 220)
    meta = [([np.empty((c[i], reso[MAT_MODE[i][1]], reso[MAT_MODE[i][0]]), np.float32)
              for i in range(3)], None) for c in shapes]
    tb = tvm.merged_table_bytes([([torch.from_numpy(p) for p in ps], None) for ps, _ in meta],
                                (1, 2, 4))
    jb = jvm.merged_table_bytes(meta, (1, 2, 4), None)
    assert tb == jb > tvm.MERGED_BYTES_LIMIT

