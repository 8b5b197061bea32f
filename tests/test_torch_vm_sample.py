"""The fused VM sampler's one-launch forward (rodynrf_tpu_torch/ops/vm_sample.py,
csrc/vm_sample.cu) and the rule that routes `sample_vm_fused` to it.

On the CPU:
- the route: the kernel is taken only when nothing needs a gradient (grad
  mode off or inference mode, or no table and not xyz requiring one); the
  CPU always takes the plain path and launches nothing; gradients still flow
  through `sample_vm_fused` under grad; a train step whose every pass is
  differentiable routes no call to the kernel, one with detached static
  passes routes those;
- `vm_sample_model`, a numpy model of the kernel kept here (its channel
  groups, index math and order of operations, read from the kernel's
  `layout`), equals the
  plain path bit for bit: both layouts, f32 and bf16 tables, 1 and 3
  strides, split packs, every channel-group width, samples in the zero-halo
  band and out of band, ragged N and N = 0.

On the card (skipped without one): the kernel equals the autograd path's
forward bit for bit at the two recipes' widths, in both layouts, and counts
one launch a call.

Imports torch and numpy only, so it runs on a machine with a card:

    python -m pytest tests/test_torch_vm_sample.py --noconftest
"""

import numpy as np
import pytest
import torch

from rodynrf_tpu_torch.ops import fused_vm as tvm
from rodynrf_tpu_torch.ops import vm_sample as tvs
from rodynrf_tpu_torch.ops.grid_sample import MAT_MODE, VEC_MODE

DENSITY, APP = (16, 4, 4), (48, 12, 12)  # the recipes' n_lamb_sigma, n_lamb_sh


# ---------------------------------------------------------------------------
# the kernel's model
# ---------------------------------------------------------------------------

F32 = np.float32


def _f32_values(t: torch.Tensor) -> np.ndarray:
    """A table's values as f32, flat; bf16 widened by its bits."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().astype(np.uint16).astype(np.uint32) << 16
        return bits.view(F32).reshape(-1)
    return t.numpy().astype(F32).reshape(-1)


def _round_bf16(x: np.ndarray) -> np.ndarray:
    u = x.view(np.uint32)
    r = ((u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) >> 16) << 16
    return np.where(np.isnan(x), np.uint32(0x7FC00000), r).astype(np.uint32).view(F32)


def _axis(u: np.ndarray, n: int):
    g = (u + F32(1.0)) * F32(0.5) * F32(n - 1)
    i0f = np.floor(g)
    i0 = i0f.astype(np.int32)
    return np.clip(i0, -1, n - 1), g - i0f, (i0 >= -1) & (i0 <= n - 1)


def vm_sample_model(packed, xyz: torch.Tensor) -> list:
    """The kernel's arithmetic in numpy: per channel group u of the layout
    (one thread a sample on the card), the rows and weights of every stride,
    the four-corner sum, the line lerp and the product, in the kernel's
    order, each operation rounded to f32."""
    L = tvs.layout(packed)
    x = xyz.detach().cpu().numpy().astype(F32)
    N, V = x.shape[0], L.vec
    bf16 = packed.tables[0].dtype == torch.bfloat16
    tables = [_f32_values(t) for t in packed.tables]
    lines = [[_f32_values(t) for t in lt] for lt in packed.line_tables]
    outs = [np.zeros((N, f), F32) for f in L.widths()]
    j = np.arange(V)
    for u in range(L.units):
        o = 0 if u < L.unit_start[1] else (1 if u < L.unit_start[2] else 2)
        c, cp = (u - L.unit_start[o]) * V, L.cp[o]
        g = max(k for k in range(L.n_grids) if L.c0[o][k] <= c)
        xu, yu, zu = x[:, 1 if o == 2 else 0], x[:, 1 if o == 0 else 2], x[:, 2 - o]
        if L.merged:
            seg_x = sum(_axis(xu, L.dims[o][si][1])[0] + 1 for si in range(L.n_strides))
            seg_y = sum(_axis(yu, L.dims[o][si][0])[0] + 1 for si in range(L.n_strides))
            row_base = (seg_y * L.seg_lx[o] + seg_x).astype(np.int64) * (L.n_strides * 4 * cp)
        for si in range(L.n_strides):
            Hs, Ws = L.dims[o][si]
            x0, wx, vx = _axis(xu, Ws)
            y0, wy, vy = _axis(yu, Hs)
            if L.merged:
                base = row_base + si * 4 * cp + c
            else:
                row = (y0 + 1) * (Ws + 1) + (x0 + 1) + L.row_offsets[o][si]
                base = row.astype(np.int64) * (4 * cp) + c
            v = [tables[o][(base + k * cp)[:, None] + j] for k in range(4)]

            Ls = L.line_dims[o][si]
            gl = (zu + F32(1.0)) * F32(0.5) * F32(Ls - 1)
            i0f = np.floor(gl)
            i0 = i0f.astype(np.int64)
            i1 = i0 + 1
            ib0 = ((i0 >= 0) & (i0 <= Ls - 1)).astype(F32)
            ib1 = ((i1 >= 0) & (i1 <= Ls - 1)).astype(F32)
            t0 = lines[o][si][(np.clip(i0, 0, Ls - 1) * cp + c)[:, None] + j]
            t1 = lines[o][si][(np.clip(i1, 0, Ls - 1) * cp + c)[:, None] + j]
            if bf16:
                lw0 = _round_bf16(np.clip(F32(1.0) - np.abs(i0f - gl), F32(0), F32(1)))
                lw1 = _round_bf16(np.clip(F32(1.0) - np.abs((i0f + F32(1.0)) - gl), F32(0),
                                          F32(1)))
            else:
                lw1 = gl - i0f
                lw0 = F32(1.0) - lw1

            valid = (vx & vy).astype(F32)
            ox, oy = F32(1.0) - wx, F32(1.0) - wy
            w = [oy * ox * valid, oy * wx * valid, wy * ox * valid, wy * wx * valid]
            f = v[0] * w[0][:, None] + v[1] * w[1][:, None]
            f = f + v[2] * w[2][:, None]
            f = f + v[3] * w[3][:, None]
            line = t0 * ib0[:, None] * lw0[:, None] + t1 * ib1[:, None] * lw1[:, None]
            col = si * L.pitch[g] + L.col_base[o][g] + (c - L.c0[o][g])
            outs[g][:, col:col + V] = f * line
    return [torch.from_numpy(a) for a in outs]


def _grids(rng, comps, grid):
    out = []
    for n_comp in comps:
        planes = [torch.from_numpy(
            rng.standard_normal((n_comp[i], grid[MAT_MODE[i][1]], grid[MAT_MODE[i][0]]))
            .astype(np.float32)) for i in range(3)]
        lines = [torch.from_numpy(rng.standard_normal((n_comp[i], grid[VEC_MODE[i]]))
                                  .astype(np.float32)) for i in range(3)]
        out.append((planes, lines))
    return out


def _xyz(rng, n, grid):
    """Samples in [-1.3, 1.3] (inside, in the zero-halo band, out of band),
    with the corners, the faces and texel boundaries of each axis exactly."""
    xyz = rng.uniform(-1.3, 1.3, (n, 3))
    for i in range(min(n, 24)):
        axis, k = i % 3, i // 3
        m = grid[axis] - 1
        xyz[i, axis] = [-1.0, 1.0, -1.0 - 1.0 / m, 1.0 + 1.0 / m, -1.0 - 0.5 / m,
                        2.0 * k / m - 1.0, -1.0 - 2.0 / m, 0.0][k % 8]
    return torch.from_numpy(xyz.astype(np.float32))


def _pack(grids, strides, dtype, layout, split):
    """One pack, or the split pack of appearance compaction: the last grid
    (appearance) apart from the others."""
    if split:
        return [tvm.pack_vm(grids[:-1], strides, dtype, layout),
                tvm.pack_vm(grids[-1:], strides, dtype, layout)]
    return [tvm.pack_vm(grids, strides, dtype, layout)]


def _bits(t):
    return t.contiguous().view(torch.int32)


# (layout, gather dtype, strides, grid channels, split pack, N)
MODEL_CASES = [
    ("strided", None, (1,), [DENSITY, APP], False, 257),
    ("strided", "bf16", (1,), [DENSITY, APP], False, 257),
    ("strided", "bf16", (1,), [DENSITY, DENSITY, APP], True, 65),
    ("strided", None, (1, 2, 4), [DENSITY, DENSITY, APP], False, 100),
    ("strided", "bf16", (1, 2, 4), [DENSITY, DENSITY, APP], False, 31),
    ("merged", "bf16", (1, 2, 4), [DENSITY, DENSITY, APP], False, 257),
    ("merged", None, (1, 2, 4), [DENSITY, DENSITY, APP], False, 257),
    ("merged", "bf16", (1, 2, 4), [DENSITY, DENSITY, APP], True, 65),
    ("merged", "bf16", (1, 2), [(16, 8, 8)], False, 50),     # 8 bf16 channels a load
    ("strided", None, (1,), [(5, 2, 3), (4, 4, 2)], False, 77),  # one channel a load
    ("merged", None, (1, 2, 4), [(6, 2, 4)], False, 77),         # two channels a load
    ("merged", "bf16", (1, 2, 4), [DENSITY, DENSITY, APP], False, 1),
    ("strided", "bf16", (1,), [DENSITY, APP], False, 0),
]


@pytest.mark.parametrize("layout,dtype,strides,comps,split,n", MODEL_CASES)
def test_model_matches_plain_bit_for_bit(layout, dtype, strides, comps, split, n):
    rng = np.random.default_rng(n + len(comps) + len(strides))
    grid = (13, 17, 11)
    dtype = torch.bfloat16 if dtype == "bf16" else None
    xyz = _xyz(rng, n, grid)
    for packed in _pack(_grids(rng, comps, grid), strides, dtype, layout, split):
        assert packed.meta["layout"] == layout
        with torch.no_grad():
            want = tvm.sample_vm_fused_plain(packed, xyz)
        got = vm_sample_model(packed, xyz)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype == torch.float32
            assert torch.equal(_bits(g), _bits(w))


def test_layout_channel_groups():
    """The thread count a sample and the channels a load at the recipes'
    widths: 8-byte bf16 loads (4 channels), 30 groups at the dynamic
    field's merged pack and 24 at the static field's."""
    rng = np.random.default_rng(0)
    grid = (9, 10, 11)
    dyn = tvm.pack_vm(_grids(rng, [DENSITY, DENSITY, APP], grid), (1, 2, 4), torch.bfloat16,
                      "merged")
    st = tvm.pack_vm(_grids(rng, [DENSITY, APP], grid), (1,), torch.bfloat16, "strided")
    ld, ls = tvs.layout(dyn), tvs.layout(st)
    assert (ld.vec, ld.units, ld.widths()) == (4, 30, [72, 72, 216])
    assert (ls.vec, ls.units, ls.widths()) == (4, 24, [24, 72])
    assert tvs.layout(tvm.pack_vm(_grids(rng, [DENSITY, APP], grid))).vec == 4  # f32: 16 B


@pytest.mark.parametrize("mode,needs", [
    ("grad, nothing requires grad", False),
    ("grad, a plane table requires grad", True),
    ("grad, a line table requires grad", True),
    ("grad, xyz requires grad", True),
    ("no_grad, tables and xyz require grad", False),
    ("inference_mode, tables and xyz require grad", False),
])
def test_route_follows_what_needs_a_gradient(mode, needs):
    rng = np.random.default_rng(1)
    grads = "tables and xyz" in mode
    grids = [([p.requires_grad_(grads or "plane" in mode) for p in ps],
              [ln.requires_grad_(grads or "line" in mode) for ln in ls])
             for ps, ls in _grids(rng, [DENSITY, APP], (5, 6, 7))]
    xyz = _xyz(rng, 9, (5, 6, 7)).requires_grad_(grads or "xyz" in mode)
    packed = tvm.pack_vm(grids, (1,), torch.bfloat16)
    ctx = {"no_grad": torch.no_grad, "inference_mode": torch.inference_mode}.get(
        mode.split(",")[0], torch.enable_grad)
    before = tvs.vm_sample.launches
    with ctx():
        assert tvm._needs_grad(packed, xyz) is needs
        out = tvm.sample_vm_fused(packed, xyz)  # the CPU: always the plain path
    assert tvs.vm_sample.launches == before
    assert out[0].requires_grad is needs


def test_gradients_flow_under_grad():
    rng = np.random.default_rng(2)
    grids = [([p.requires_grad_(True) for p in ps], [ln.requires_grad_(True) for ln in ls])
             for ps, ls in _grids(rng, [DENSITY, DENSITY, APP], (9, 10, 11))]
    xyz = _xyz(rng, 40, (9, 10, 11)).requires_grad_(True)
    packed = tvm.pack_vm(grids, (1, 2, 4), torch.bfloat16, "merged")
    out = tvm.sample_vm_fused(packed, xyz)
    sum(o.square().sum() for o in out).backward()
    leaves = [t for ps, ls in grids for t in ps + ls] + [xyz]
    assert all(t.grad is not None and bool(t.grad.abs().sum() > 0) for t in leaves)


@pytest.mark.parametrize("share_forward,kernel_calls", [(1, "none"), (0, "some")])
def test_train_step_routes_only_detached_passes(monkeypatch, share_forward, kernel_calls):
    """A step whose every static evaluation is differentiable (share_forward:
    A/B reuse E's) routes no sampler call to the kernel; without it the
    detached static evaluations of A/B need no gradient and would take it."""
    from rodynrf_tpu_torch.testing import tiny_cmd, tiny_scene, torch_threads
    from rodynrf_tpu_torch.train import Trainer, parse_cmd

    seen = []
    plain = tvm.sample_vm_fused_plain

    def record(packed, xyz):  # every call on the CPU; the card would route by this
        seen.append(tvm._needs_grad(packed, xyz))
        return plain(packed, xyz)

    monkeypatch.setattr(tvm, "sample_vm_fused_plain", record)
    with torch_threads(1):
        tr = Trainer(parse_cmd(tiny_cmd() + f" --share_forward {share_forward}"), tiny_scene(),
                     device="cpu")
        tr.run_step()
    assert seen and any(seen)
    assert (seen.count(False) > 0) is (kernel_calls == "some")


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


# the recipes' fields at a small grid: the dynamic field merged (1/2/4), the
# static one strided; both split as appearance compaction packs them
CARD_CASES = [
    ("merged", (1, 2, 4), [DENSITY, DENSITY, APP], False),
    ("strided", (1, 2, 4), [DENSITY, DENSITY, APP], False),
    ("strided", (1,), [DENSITY, APP], False),
    ("merged", (1, 2, 4), [DENSITY, DENSITY, APP], True),
    ("strided", (1,), [DENSITY, APP], True),
    ("merged", (1, 2, 4), [(5, 2, 3), (4, 4, 2)], False),
    ("merged", (1, 2), [(16, 8, 8)], False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("layout,strides,comps,split", CARD_CASES)
def test_kernel_matches_autograd_forward_bit_for_bit(layout, strides, comps, split, dtype):
    dev = _card()
    rng = np.random.default_rng(len(comps) * 10 + len(strides))
    grid = (61, 67, 43)
    grids = [([p.to(dev) for p in ps], [ln.to(dev) for ln in ls])
             for ps, ls in _grids(rng, comps, grid)]
    xyz = _xyz(rng, 100_003, grid).to(dev)
    dt = torch.bfloat16 if dtype == "bf16" else None
    for packed in _pack(grids, strides, dt, layout, split):
        before = tvs.vm_sample.launches
        with torch.inference_mode():
            got = tvm.sample_vm_fused(packed, xyz)
        assert tvs.vm_sample.launches == before + 1
        with torch.no_grad():
            want = tvm.sample_vm_fused_plain(packed, xyz)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.is_contiguous()
            assert torch.equal(_bits(g), _bits(w))
        # a strided view of xyz (the compacted renderer's warped half)
        wide = torch.cat([xyz, xyz], 1)[:, :3]
        with torch.no_grad():
            again = tvs.vm_sample(packed, wide)
        assert all(torch.equal(_bits(a), _bits(g)) for a, g in zip(again, got))


@pytest.mark.cuda
def test_kernel_route_on_the_card():
    """Under grad with tables that require it the plain path runs (no
    launch); an empty batch launches nothing; inputs the kernel does not
    take raise."""
    dev = _card()
    rng = np.random.default_rng(3)
    grids = [([p.to(dev).requires_grad_(True) for p in ps], [ln.to(dev) for ln in ls])
             for ps, ls in _grids(rng, [DENSITY, APP], (9, 10, 11))]
    packed = tvm.pack_vm(grids, (1,), torch.bfloat16)
    xyz = _xyz(rng, 50, (9, 10, 11)).to(dev)
    before = tvs.vm_sample.launches
    out = tvm.sample_vm_fused(packed, xyz)
    assert out[0].requires_grad and tvs.vm_sample.launches == before
    with torch.no_grad():
        empty = tvm.sample_vm_fused(packed, xyz[:0])
        assert [tuple(e.shape) for e in empty] == [(0, 24), (0, 72)]
        assert tvs.vm_sample.launches == before
        with pytest.raises(ValueError):
            tvs.vm_sample(packed, xyz.double())
        with pytest.raises(ValueError):
            tvs.vm_sample(packed, xyz.t().contiguous().t())  # column stride N
