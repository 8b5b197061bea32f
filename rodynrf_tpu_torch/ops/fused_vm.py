"""Fused VM sampling (port of rodynrf_tpu/ops/fused_vm.py).

Each orientation's planes pack into corner-packed tables: row (y, x) holds
the four bilinear corners of virtual texel (y, x) for the channels of every
grid sampled at the same coordinates, over a one-texel zero halo (so
out-of-bounds corners read exact zeros). Two layouts of the multiscale
strides:

- 'strided': one table per stride, concatenated along the rows; a sample
  gathers one row per stride and orientation (`ops/coalesced.planes_sample`,
  table gradient by the coalesce kernel);
- 'merged': one row per joint multiscale cell (`_axis_seg_maps`), holding
  every stride's corners; a sample gathers one row per orientation
  (`ops/coalesced.merged_sample`, table gradient by the segment-sum kernel).

With a gather dtype (bf16) the tables are cast inside the pack, so the f32
parameters take their gradient through the cast; interpolation, MLPs and
optimizers stay f32.

Line factors use the 2-tap lerp of `rodynrf_tpu/ops/grid_sample.sample_line`
rather than the JAX package's hat-weight matmul: the two are the same
function (tests/test_fused_vm.py holds them equal to 1e-6), and in eager
PyTorch the hat form would save an [N, Ls] weight matrix and its clip/abs
intermediates for backward per orientation and stride, where the lerp saves
two [N, C] corner blocks. In bf16 the two taps take the hat formula's
weights rounded to bf16, which gives the values of the JAX package's bf16
dot (see `_line_feats`).
"""

from __future__ import annotations

import functools
from fractions import Fraction
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .coalesced import merged_sample, planes_sample
from .grid_sample import MAT_MODE, VEC_MODE, _strided_len

# 'auto' picks the merged layout when its tables fit this byte budget (the
# JAX package's rule, kept so that one command resolves to one layout in both
# packages): it admits the bf16 300³ dynamic field (~0.95 GB) and rejects the
# f32 one (~1.9 GB).
MERGED_BYTES_LIMIT = 1_200_000_000

Grid = Tuple[Sequence[torch.Tensor], Sequence[torch.Tensor]]  # (planes, lines)


def _pack_plane_corners(plane: torch.Tensor, stride: int,
                        dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """[C, H, W] plane -> corner-packed strided table [(Hs+1)*(Ws+1), 4*C].

    Row (y, x) holds [P(y,x) | P(y,x+1) | P(y+1,x) | P(y+1,x+1)] read from
    the stride-s virtual grid, zero outside it, with a +1 halo offset so
    corner y0 = -1 queries resolve to the right rows. `dtype` (the gather
    dtype) casts inside the pack.
    """
    if stride != 1:
        plane = plane[:, ::stride, ::stride]
    if dtype is not None:
        plane = plane.to(dtype)
    C, Hs, Ws = plane.shape
    z = torch.nn.functional.pad(plane, (1, 1, 1, 1))  # zero halo
    c00 = z[:, :-1, :-1]
    c01 = z[:, :-1, 1:]
    c10 = z[:, 1:, :-1]
    c11 = z[:, 1:, 1:]
    packed = torch.cat([c00, c01, c10, c11], dim=0)  # [4C, Hs+1, Ws+1]
    return packed.reshape(4 * C, (Hs + 1) * (Ws + 1)).t().contiguous()


def _pack_line(lines: Sequence[torch.Tensor], stride: int,
               dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Concat per-grid [C_g, L] lines -> strided [Ls, sum C_g] (channel-last)."""
    cat = torch.cat(list(lines), dim=0)
    if stride != 1:
        cat = cat[:, ::stride]
    if dtype is not None:
        cat = cat.to(dtype)
    return cat.t().contiguous()


class PackedVM:
    """Per-orientation corner-packed plane tables + line tables."""

    def __init__(self, tables, line_tables, meta):
        self.tables = tables            # [o] -> [R_o, 4*Cp_o] or [R_o, nS*4*Cp_o]
        self.line_tables = line_tables  # [o][si] -> [Ls, Cp_o]
        self.meta = meta                # static layout info


# ---------------------------------------------------------------------------
# merged-stride row maps (static, exact-rational breakpoint walk)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _axis_seg_maps(n: int, strides: tuple):
    """Static per-axis merge maps for multiscale align_corners sampling (the
    JAX package's, numpy and fractions only).

    All strided grids along one axis are sampled at the same normalized u;
    each stride's cell index i_s = clip(floor((u+1)/2*(n_s-1)), -1, n_s-1)
    is a monotone step function of u, so seg = Σ_s (i_s + 1) is monotone and
    identifies the joint cell uniquely (double breakpoints skip seg values:
    those rows are unreachable).

    Returns (maps, starts, counts):
      maps[s]   int32 [L] — halo-shifted index (i_s + 1) ∈ [0, n_s] per seg
      starts[s] int32 [n_s + 1] — first seg with maps[s] == h (contiguous)
      counts[s] int32 [n_s + 1] — number of segs with maps[s] == h
    computed with exact rational breakpoints (no float ties).
    """
    ns = [_strided_len(n, s) for s in strides]
    cur = [0 if h == 1 else -1 for h in ns]
    events = []
    for si, h in enumerate(ns):
        if h > 1:
            for k in range(h):
                events.append((Fraction(k, h - 1), si))
    events.sort()
    seg0 = sum(c + 1 for c in cur)  # value of seg before the first event
    states = [tuple(cur)] * (seg0 + 1)  # unreachable lead-in + initial state
    for _, si in events:
        cur[si] += 1
        states.append(tuple(cur))
    maps, starts, counts = [], [], []
    for si, h in enumerate(ns):
        m = np.array([st[si] + 1 for st in states], np.int32)
        maps.append(m)
        hh = np.arange(h + 2, dtype=np.int32)
        left = np.searchsorted(m, hh[:-1], side="left").astype(np.int32)
        right = np.searchsorted(m, hh[:-1], side="right").astype(np.int32)
        starts.append(left)
        counts.append(right - left)
    return tuple(maps), tuple(starts), tuple(counts)


def merged_table_bytes(grids, strides, gather_dtype: Optional[torch.dtype]) -> int:
    """Bytes of the merged-layout tables for `grids` (the JAX package's
    'auto' rule): one row per joint multiscale cell, 2 bytes an element in
    bf16 and 4 in f32."""
    itemsize = 2 if gather_dtype == torch.bfloat16 else 4
    total = 0
    for o in range(3):
        planes_o = [g[0][o] for g in grids]
        Cp = sum(int(p.shape[0]) for p in planes_o)
        H, W = planes_o[0].shape[1], planes_o[0].shape[2]
        Ly = len(_axis_seg_maps(int(H), tuple(strides))[0][0])
        Lx = len(_axis_seg_maps(int(W), tuple(strides))[0][0])
        total += Ly * Lx * len(strides) * 4 * Cp * itemsize
    return total


@functools.lru_cache(maxsize=16)
def _merge_plan(H: int, W: int, strides: tuple, device: torch.device):
    """The merge's index tensors for one [H, W] plane shape, built once on
    `device` (so a step copies no index from the host; 3 entries per grid,
    a few MB each at 300³):

      (Ly, Lx): merged rows per axis;
      rows[s]: the stride-s table row of each merged row, [Ly·Lx] int64,
        the outer product ymap·(Ws+1) + xmap of the per-axis maps;
      y_sums[s], x_sums[s]: per j, (sel [Hp] int64, mask [Hp] bool) of the
        bounded-width axis sums of the backward.
    """
    ym, ys, yc = _axis_seg_maps(H, strides)
    xm, xs, xc = _axis_seg_maps(W, strides)
    Ly, Lx = len(ym[0]), len(xm[0])

    def dev(a):
        return torch.as_tensor(a, device=device)

    def sums(starts, counts, L):
        return tuple((dev(np.minimum(starts + j, L - 1)).long(), dev(j < counts))
                     for j in range(int(counts.max())))

    rows, y_sums, x_sums = [], [], []
    for si, s in enumerate(strides):
        wp = _strided_len(W, s) + 1
        rows.append((dev(ym[si]).long()[:, None] * wp + dev(xm[si]).long()[None, :]).reshape(-1))
        y_sums.append(sums(ys[si], yc[si], Ly))
        x_sums.append(sums(xs[si], xc[si], Lx))
    return (Ly, Lx), tuple(rows), tuple(y_sums), tuple(x_sums)


def _bounded_axis_sum(ct3: torch.Tensor, sums) -> torch.Tensor:
    """out[h] = Σ_{j<counts[h]} ct3[starts[h]+j], ct3 [L, ...] -> [Hp, ...]:
    exact bounded-width sums over static indices (`sums` from `_merge_plan`),
    added in j order in the cotangent's dtype (the JAX package's
    `_bounded_axis_sum`)."""
    Hp = sums[0][0].shape[0]
    out = ct3.new_zeros((Hp,) + tuple(ct3.shape[1:]))
    mshape = (Hp,) + (1,) * (ct3.dim() - 1)
    for sel, mask in sums:
        out = out + torch.where(mask.view(mshape), ct3.index_select(0, sel), 0.0)
    return out


class _MergeStridedTables(torch.autograd.Function):
    """Per-stride corner tables -> one merged table [Ly*Lx, nS*4*Cp].

    Forward: static-index row selects. Backward: the exact bounded-width
    axis sums of the JAX package's `_merge_bwd`, in the cotangent's dtype
    and the same order; not index_add_, whose atomics on the card sum in an
    order that changes from run to run."""

    @staticmethod
    def forward(ctx, plan, *tables):
        ctx.plan = plan
        _, rows, _, _ = plan
        return torch.cat([t.index_select(0, r) for t, r in zip(tables, rows)], dim=1)

    @staticmethod
    def backward(ctx, ct):
        (Ly, Lx), rows, y_sums, x_sums = ctx.plan
        nS = len(rows)
        C4 = ct.shape[1] // nS
        grads = []
        for si in range(nS):
            ct3 = ct[:, si * C4:(si + 1) * C4].reshape(Ly, Lx, C4)
            red_y = _bounded_axis_sum(ct3, y_sums[si])
            red_yx = _bounded_axis_sum(red_y.transpose(0, 1), x_sums[si])
            grads.append(red_yx.transpose(0, 1).reshape(-1, C4))
        return (None, *grads)


def merge_strided_tables(tables: Sequence[torch.Tensor], plan) -> torch.Tensor:
    """Gather per-stride corner tables into one merged table; `plan` from
    `_merge_plan(H, W, strides, device)`."""
    return _MergeStridedTables.apply(plan, *tables)


def resolve_layout(grids, strides, gather_dtype, layout: str) -> str:
    """'auto' -> 'merged' when there are several strides and the merged
    tables fit MERGED_BYTES_LIMIT, else 'strided' (the JAX package's rule,
    rodynrf_tpu/ops/fused_vm.py:303-310)."""
    if layout == "auto":
        return (
            "merged"
            if len(strides) > 1
            and merged_table_bytes(grids, strides, gather_dtype) <= MERGED_BYTES_LIMIT
            else "strided"
        )
    if layout not in ("strided", "merged"):
        raise ValueError(f"unknown vm layout {layout!r}")
    return layout


def pack_vm(
    grids: Sequence[Grid],
    strides: Sequence[int] = (1,),
    gather_dtype: Optional[torch.dtype] = None,
    layout: str = "auto",
) -> PackedVM:
    """Build the fused tables for one or more VM grids sampled at shared xyz.

    grids: list of (planes, lines), planes[i] [C_g_i, H_i, W_i] and lines[i]
    [C_g_i, L_i] in MAT_MODE/VEC_MODE orientation order, one spatial
    resolution for all grids. gather_dtype: torch.bfloat16 or None (f32).
    layout: 'strided', 'merged' or 'auto' (`resolve_layout`).
    """
    strides = tuple(strides)
    if resolve_layout(grids, strides, gather_dtype, layout) == "merged":
        return _pack_vm_merged(grids, strides, gather_dtype)
    tables, line_tables = [], []
    dims, line_dims, row_offsets, c_splits = [], [], [], []
    for o in range(3):
        planes_o = [g[0][o] for g in grids]
        lines_o = [g[1][o] for g in grids]
        c_splits.append(tuple(int(p.shape[0]) for p in planes_o))
        H, W = planes_o[0].shape[1], planes_o[0].shape[2]
        L = lines_o[0].shape[1]
        segs, offs, dd, ld, lt = [], [], [], [], []
        off = 0
        cat_planes = torch.cat(planes_o, dim=0)
        for s in strides:
            # grid channels concatenated first: the packed row layout is
            # [c00(Cp) | c01(Cp) | c10(Cp) | c11(Cp)] (corner-major)
            seg = _pack_plane_corners(cat_planes, s, gather_dtype)
            segs.append(seg)
            offs.append(off)
            off += seg.shape[0]
            dd.append((_strided_len(H, s), _strided_len(W, s)))
            ld.append(_strided_len(L, s))
            lt.append(_pack_line(lines_o, s, gather_dtype))
        tables.append(torch.cat(segs, dim=0))
        line_tables.append(lt)
        dims.append(tuple(dd))
        line_dims.append(tuple(ld))
        row_offsets.append(tuple(offs))
    meta = {
        "layout": "strided",
        "strides": strides,
        "dims": tuple(dims),
        "line_dims": tuple(line_dims),
        "row_offsets": tuple(row_offsets),
        "c_splits": tuple(c_splits),
        "n_grids": len(grids),
    }
    return PackedVM(tables, line_tables, meta)


def _pack_vm_merged(grids: Sequence[Grid], strides, gather_dtype) -> PackedVM:
    """Merged-stride layout: one row per joint multiscale cell.

    Row channels: [stride₁: c00|c01|c10|c11 | stride₂: ... | stride₃: ...],
    each corner block Cp = Σ_g C_g wide: the strided layout's corner values,
    so f32 features equal the strided ones bit for bit."""
    tables, line_tables = [], []
    dims, line_dims, c_splits, seg_dims = [], [], [], []
    for o in range(3):
        planes_o = [g[0][o] for g in grids]
        lines_o = [g[1][o] for g in grids]
        c_splits.append(tuple(int(p.shape[0]) for p in planes_o))
        H, W = int(planes_o[0].shape[1]), int(planes_o[0].shape[2])
        cat_planes = torch.cat(planes_o, dim=0)
        plan = _merge_plan(H, W, tuple(strides), cat_planes.device)
        per_stride, dd, ld, lt = [], [], [], []
        for s in strides:
            per_stride.append(_pack_plane_corners(cat_planes, s, gather_dtype))
            dd.append((_strided_len(H, s), _strided_len(W, s)))
            ld.append(_strided_len(lines_o[0].shape[1], s))
            lt.append(_pack_line(lines_o, s, gather_dtype))
        tables.append(merge_strided_tables(per_stride, plan))
        line_tables.append(lt)
        dims.append(tuple(dd))
        line_dims.append(tuple(ld))
        seg_dims.append(plan[0])
    meta = {
        "layout": "merged",
        "strides": tuple(strides),
        "dims": tuple(dims),
        "line_dims": tuple(line_dims),
        "seg_dims": tuple(seg_dims),
        "c_splits": tuple(c_splits),
        "n_grids": len(grids),
    }
    return PackedVM(tables, line_tables, meta)


def _axis_lerp(u: torch.Tensor, n: int):
    """align_corners index math for one axis (grid_sample._lerp_weights_1d).

    Returns (i0 in [-1, n-1] clipped, w1, valid) where valid covers the
    partial zero-padding band; out-of-band queries are zeroed via `valid`.
    """
    g = (u + 1.0) * 0.5 * (n - 1)
    i0f = torch.floor(g)
    w1 = g - i0f
    i0 = i0f.to(torch.int32)
    valid = (i0 >= -1) & (i0 <= n - 1)
    return torch.clamp(i0, -1, n - 1), w1, valid


def _line_feats(table: torch.Tensor, u: torch.Tensor, Ls: int) -> torch.Tensor:
    """[Ls, C] line table sampled at u [N] -> [N, C] f32: align_corners
    linear interpolation with zero padding, as the 2-tap lerp of
    grid_sample.sample_line (see the module docstring for why not the hat
    matmul).

    A bf16 table reproduces the JAX package's bf16 hat dot (bf16 weights,
    f32 accumulation): the two taps take the hat weights clip(1 - |l - g|,
    0, 1) at l = i0 and i0 + 1, rounded to bf16; each bf16 × bf16 product is
    exact in f32 and the two-term sum rounds once, as the dot's does. The
    round trip to bf16 stays in the autograd graph, so the weights'
    cotangent is rounded to bf16 as the JAX `astype` transpose rounds it.
    The gather reads an f32 copy of the table, so the table's cotangent is
    summed in f32 and cast once, as the dot's transpose does."""
    g = (u + 1.0) * 0.5 * (Ls - 1)
    i0f = torch.floor(g)
    i0 = i0f.to(torch.int64)
    i1 = i0 + 1
    ib0 = ((i0 >= 0) & (i0 <= Ls - 1)).to(u.dtype)[:, None]
    ib1 = ((i1 >= 0) & (i1 <= Ls - 1)).to(u.dtype)[:, None]
    t32 = table.to(u.dtype)
    v0 = t32.index_select(0, i0.clamp(0, Ls - 1)) * ib0
    v1 = t32.index_select(0, i1.clamp(0, Ls - 1)) * ib1
    if table.dtype == torch.bfloat16:
        w0 = torch.clamp(1.0 - torch.abs(i0f - g), 0.0, 1.0)
        w1 = torch.clamp(1.0 - torch.abs((i0f + 1.0) - g), 0.0, 1.0)
        w0 = w0.to(torch.bfloat16).to(u.dtype)[:, None]
        w1 = w1.to(torch.bfloat16).to(u.dtype)[:, None]
        return v0 * w0 + v1 * w1
    w1 = (g - i0f)[:, None]
    return v0 * (1 - w1) + v1 * w1


def _corner_weights(wx, wy, valid):
    """The four bilinear corner weights × valid, in the table's corner order."""
    return [
        (1 - wy) * (1 - wx) * valid,
        (1 - wy) * wx * valid,
        wy * (1 - wx) * valid,
        wy * wx * valid,
    ]


def plane_rows_weights(packed: PackedVM, xyz: torch.Tensor, o: int):
    """Orientation o's gather rows and corner weights at xyz [N, 3], strided
    layout: per stride, rows [N] int32 into packed.tables[o] and w4 [N, 4]
    (bilinear corner weights × the zero-padding band mask)."""
    meta = packed.meta
    m0, m1 = MAT_MODE[o]
    x_u, y_u = xyz[:, m0], xyz[:, m1]
    idx_list, w_list = [], []
    for si in range(len(meta["strides"])):
        Hs, Ws = meta["dims"][o][si]
        x0, wx, vx = _axis_lerp(x_u, Ws)
        y0, wy, vy = _axis_lerp(y_u, Hs)
        idx_list.append((y0 + 1) * (Ws + 1) + (x0 + 1) + meta["row_offsets"][o][si])
        w_list.append(torch.stack(_corner_weights(wx, wy, (vx & vy).to(xyz.dtype)), dim=-1))
    return idx_list, w_list


def merged_rows_weights(packed: PackedVM, xyz: torch.Tensor, o: int):
    """Orientation o's gather rows and corner weights at xyz [N, 3], merged
    layout: rows [N] int32 (seg_y · Lx + seg_x, seg = Σ_s (i_s + 1) per axis)
    and w [N, nS, 4]."""
    meta = packed.meta
    m0, m1 = MAT_MODE[o]
    x_u, y_u = xyz[:, m0], xyz[:, m1]
    Lx = meta["seg_dims"][o][1]
    seg_y = torch.zeros(xyz.shape[0], dtype=torch.int32, device=xyz.device)
    seg_x = torch.zeros_like(seg_y)
    w_strides = []
    for si in range(len(meta["strides"])):
        Hs, Ws = meta["dims"][o][si]
        x0, wx, vx = _axis_lerp(x_u, Ws)
        y0, wy, vy = _axis_lerp(y_u, Hs)
        seg_x = seg_x + x0 + 1
        seg_y = seg_y + y0 + 1
        w_strides.append(torch.stack(_corner_weights(wx, wy, (vx & vy).to(xyz.dtype)), dim=-1))
    return seg_y * Lx + seg_x, torch.stack(w_strides, dim=1)


def sample_vm_fused(packed: PackedVM, xyz: torch.Tensor) -> List[torch.Tensor]:
    """Sample every grid of `packed` at xyz [N, 3] (normalized [-1, 1]).

    Returns one [N, sum_o C_g_o * n_strides] tensor per grid, channels
    ordered stride-major then orientation (reference cat order,
    tensoRF.py:670-721). One gather and one table-gradient launch per
    orientation cover every stride, in either layout.
    """
    meta = packed.meta
    nS = len(meta["strides"])
    N = xyz.shape[0]
    merged = meta["layout"] == "merged"
    per_grid = [[None] * (nS * 3) for _ in range(meta["n_grids"])]

    for o in range(3):
        if merged:
            rows, w = merged_rows_weights(packed, xyz, o)
            feats = merged_sample(packed.tables[o], rows, w)  # [N, nS, Cp]
            stride_feats = [feats[:, si] for si in range(nS)]
        else:
            idx_list, w_list = plane_rows_weights(packed, xyz, o)
            feats = planes_sample(packed.tables[o], torch.cat(idx_list), torch.cat(w_list))
            stride_feats = [feats[si * N:(si + 1) * N] for si in range(nS)]
        z_u = xyz[:, VEC_MODE[o]]
        for si in range(nS):
            line = _line_feats(packed.line_tables[o][si], z_u, meta["line_dims"][o][si])
            prod = stride_feats[si] * line  # [N, Cp]
            c0 = 0
            for gi, cg in enumerate(meta["c_splits"][o]):
                per_grid[gi][si * 3 + o] = prod[:, c0:c0 + cg]
                c0 += cg

    return [torch.cat(chunks, dim=-1) for chunks in per_grid]
