"""The port's fused VM sampler (rodynrf_tpu_torch/ops/fused_vm.py) against
the JAX package's `pack_vm` + `sample_vm_fused`, in both table layouts:
values and gradients with respect to the planes, the lines (through the
packed tables) and the coordinates, at 1e-5. The port's line factors are the
2-tap lerp where the JAX package runs a hat-weight matmul; the two agree to
float rounding in f32, and to 1e-6 of scale in bf16, where the port rounds
the two hat weights as the JAX bf16 dot does.

Also: f32 merged features equal strided ones bit for bit; the merge's
backward equals the JAX `_merge_bwd` (the same sums in the same order); the
merged row maps and the 'auto' byte rule equal the JAX package's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rodynrf_tpu.ops import fused_vm as jvm
from rodynrf_tpu.train.schedule import n_voxel_schedule as jschedule
from rodynrf_tpu_torch.data import make_synthetic_scene
from rodynrf_tpu_torch.fields import n_to_reso
from rodynrf_tpu_torch.ops import fused_vm as tvm
from rodynrf_tpu_torch.ops.grid_sample import MAT_MODE, VEC_MODE, _strided_len
from rodynrf_tpu_torch.train.schedule import n_voxel_schedule

GRID = (13, 17, 11)


def _grids(rng, comps, grid=GRID):
    out = []
    for n_comp in comps:
        planes = [rng.standard_normal((n_comp[i], grid[MAT_MODE[i][1]], grid[MAT_MODE[i][0]]))
                  .astype(np.float32) for i in range(3)]
        lines = [rng.standard_normal((n_comp[i], grid[VEC_MODE[i]])).astype(np.float32)
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


@pytest.mark.parametrize("grid", [(13, 17, 11), (5, 4, 6)])
def test_merged_sample_vm_fused_matches_jax(grid):
    """Merged layout: values and gradients (planes, lines, xyz) against the
    JAX merged path at 1e-5, and f32 features equal to the port's strided
    ones bit for bit."""
    rng = np.random.default_rng(sum(grid))
    grids = _grids(rng, [(5, 2, 3), (4, 4, 2)], grid)
    xyz = rng.uniform(-1.3, 1.3, (257, 3)).astype(np.float32)
    strides = (1, 2, 4)

    def jax_fn(gr, x):
        packed = jvm.pack_vm(gr, strides=strides, layout="merged")
        assert packed.meta["layout"] == "merged"
        return jvm.sample_vm_fused(packed, x)

    jgr = [([jnp.asarray(p) for p in ps], [jnp.asarray(l) for l in ls]) for ps, ls in grids]
    cts = [rng.standard_normal((257, sum(c) * 3)).astype(np.float32)
           for c in ((5, 2, 3), (4, 4, 2))]
    # one compiled program: the merged path's many small ops are slow eagerly
    want, want_ggr, want_gx = jax.jit(lambda gr, x, c: (
        jax_fn(gr, x), *jax.vjp(jax_fn, gr, x)[1](c)))(jgr, jnp.asarray(xyz), cts)

    tgr = [([torch.from_numpy(p).requires_grad_(True) for p in ps],
            [torch.from_numpy(l).requires_grad_(True) for l in ls]) for ps, ls in grids]
    tx = torch.from_numpy(xyz).requires_grad_(True)
    packed = tvm.pack_vm(tgr, strides=strides, layout="merged")
    assert packed.meta["layout"] == "merged"
    got = tvm.sample_vm_fused(packed, tx)
    with torch.no_grad():
        strided = tvm.sample_vm_fused(tvm.pack_vm(tgr, strides=strides, layout="strided"), tx)
    for g, st in zip(got, strided):
        assert torch.equal(g, st)
    torch.autograd.backward(got, [torch.from_numpy(c) for c in cts])

    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(want_gx), rtol=1e-5, atol=1e-5)
    for (tps, tls), (wps, wls) in zip(tgr, want_ggr):
        for t, w in zip(tps + tls, list(wps) + list(wls)):
            np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


def test_merge_backward_matches_jax():
    """merge_strided_tables' backward (bounded-width axis sums) against the
    JAX `_merge_bwd` on the same per-stride tables and cotangent, f32."""
    rng = np.random.default_rng(21)
    H, W, C4, strides = 9, 13, 8, (1, 2, 4)
    ym, ys, yc = jvm._axis_seg_maps(H, strides)
    xm, xs, xc = jvm._axis_seg_maps(W, strides)
    Ly, Lx = len(ym[0]), len(xm[0])
    tables, rows_static, y_red, x_red = [], [], [], []
    for si, s in enumerate(strides):
        Hs, Ws = _strided_len(H, s), _strided_len(W, s)
        tables.append(rng.standard_normal(((Hs + 1) * (Ws + 1), C4)).astype(np.float32))
        rows_static.append((ym[si], xm[si], Ws + 1))
        y_red.append((ys[si], yc[si], Ly))
        x_red.append((xs[si], xc[si], Lx))
    static = (tuple(rows_static), tuple(y_red), tuple(x_red))
    ct = rng.standard_normal((Ly * Lx, len(strides) * C4)).astype(np.float32)

    want_fwd, vjp = jax.vjp(lambda ts: jvm.merge_strided_tables(ts, jvm._HashableStatic(static)),
                            tuple(jnp.asarray(t) for t in tables))
    (want,) = vjp(jnp.asarray(ct))
    tts = [torch.from_numpy(t).requires_grad_(True) for t in tables]
    got_fwd = tvm.merge_strided_tables(tts, tvm._merge_plan(H, W, strides, torch.device("cpu")))
    np.testing.assert_array_equal(got_fwd.detach().numpy(), np.asarray(want_fwd))
    got = torch.autograd.grad(got_fwd, tts, torch.from_numpy(ct))
    for g, w in zip(got, want):
        scale = float(np.abs(np.asarray(w)).max())
        assert float(np.abs(g.numpy() - np.asarray(w)).max()) <= 1e-6 * scale


def test_bf16_line_feats_match_jax_hat_dot():
    """The bf16 two-tap lerp against the JAX package's bf16 hat-weight dot:
    values and the coordinate gradient to 1e-6 of scale."""
    rng = np.random.default_rng(5)
    Ls, C, N = 23, 12, 401
    table = rng.standard_normal((Ls, C)).astype(np.float32)
    u = rng.uniform(-1.2, 1.2, N).astype(np.float32)
    ct = rng.standard_normal((N, C)).astype(np.float32)
    jt = jnp.asarray(table).astype(jnp.bfloat16)
    want, vjp = jax.vjp(lambda x: jvm._line_feats(jt, x, Ls), jnp.asarray(u))
    (want_gu,) = vjp(jnp.asarray(ct))
    tu = torch.from_numpy(u).requires_grad_(True)
    got = tvm._line_feats(torch.from_numpy(table).to(torch.bfloat16), tu, Ls)
    assert got.dtype == torch.float32
    got.backward(torch.from_numpy(ct))
    for g, w in ((got.detach().numpy(), want), (tu.grad.numpy(), want_gu)):
        w = np.asarray(w, np.float32)
        assert float(np.abs(g - w).max()) <= 1e-6 * float(np.abs(w).max())


@pytest.mark.parametrize("n", [1, 2, 5, 8, 17, 220, 331, 368])
def test_auto_layout_rule_matches_jax(n):
    """The merged row maps (which also size the 'auto' byte rule) equal the
    JAX package's, array for array."""
    strides = (1, 2, 4)
    got, want = tvm._axis_seg_maps(n, strides), jvm._axis_seg_maps(n, strides)
    for g_part, w_part in zip(got, want):
        assert len(g_part) == len(w_part) == len(strides)
        for g, w in zip(g_part, w_part):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_auto_layout_at_300_cubed_f32_is_strided():
    """The f32 300³ dynamic field resolves to the strided layout (its merged
    tables exceed the byte limit), as the JAX package decides."""
    shapes = [(16, 4, 4), (16, 4, 4), (48, 12, 12)]
    reso = (331, 368, 220)
    meta = [([np.empty((c[i], reso[MAT_MODE[i][1]], reso[MAT_MODE[i][0]]), np.float32)
              for i in range(3)], None) for c in shapes]
    tb = tvm.merged_table_bytes([([torch.from_numpy(p) for p in ps], None) for ps, _ in meta],
                                (1, 2, 4), None)
    jb = jvm.merged_table_bytes(meta, (1, 2, 4), None)
    assert tb == jb > tvm.MERGED_BYTES_LIMIT


def _recipe_grids(reso):
    """Shape-only stand-ins of the dynamic field's three grids at `reso`
    (the recipe's channels), for the port (meta tensors) and the JAX
    package (numpy arrays that are never filled)."""
    shapes = [(16, 4, 4), (16, 4, 4), (48, 12, 12)]
    dims = [[(c[i], reso[MAT_MODE[i][1]], reso[MAT_MODE[i][0]]) for i in range(3)]
            for c in shapes]
    port = [([torch.empty(d, device="meta") for d in ds], None) for ds in dims]
    ref = [([np.broadcast_to(np.float32(0), d) for d in ds], None) for ds in dims]
    return port, ref


@pytest.mark.parametrize("step", [0, 1])
@pytest.mark.parametrize("bf16", [True, False])
def test_merged_table_bytes_match_jax(bf16, step):
    """At 300³ (331×368×220) and at the next grid of the recipe's upsample
    schedule, in bf16 and f32: the same byte count as the JAX package, so
    'auto' picks the same layout (bf16 merged, f32 strided at both)."""
    bbox = make_synthetic_scene(T=2, H=8, W=8, ray_type="ndc").scene_bbox
    n_vox = [27_000_000] + n_voxel_schedule(27_000_000, 262_144_000, 7)
    assert n_vox[1:] == jschedule(27_000_000, 262_144_000, 7)
    reso = n_to_reso(n_vox[step], bbox)
    assert reso == ((331, 368, 220), (369, 411, 246))[step]
    port, ref = _recipe_grids(reso)
    tb = tvm.merged_table_bytes(port, (1, 2, 4), torch.bfloat16 if bf16 else None)
    jb = jvm.merged_table_bytes(ref, (1, 2, 4), jnp.bfloat16 if bf16 else None)
    assert tb == jb
    want = "merged" if bf16 else "strided"
    assert tvm.resolve_layout(port, (1, 2, 4), torch.bfloat16 if bf16 else None, "auto") == want
