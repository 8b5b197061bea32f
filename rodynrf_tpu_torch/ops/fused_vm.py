"""Fused VM sampling, strided layout (port of rodynrf_tpu/ops/fused_vm.py).

Each orientation's planes pack into one corner-packed table: row (y, x)
holds the four bilinear corners of virtual texel (y, x) for the channels of
every grid sampled at the same coordinates, over a one-texel zero halo (so
out-of-bounds corners read exact zeros), with one table per multiscale
stride concatenated along the rows. A sample then needs one gathered row per
stride and orientation (`ops/coalesced.planes_sample`).

Line factors use the 2-tap lerp of `rodynrf_tpu/ops/grid_sample.sample_line`
rather than the JAX package's hat-weight matmul: the two are the same
function (tests/test_fused_vm.py holds them equal to 1e-6), and in eager
PyTorch the hat form would save an [N, Ls] weight matrix and its clip/abs
intermediates for backward per orientation and stride, where the lerp saves
two [N, C] corner blocks.

The merged-stride layout is the next slice of the port; asking for it (or an
'auto' choice that resolves to it) raises NotImplementedError.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from .coalesced import planes_sample
from .grid_sample import MAT_MODE, VEC_MODE, _strided_len

# 'auto' picks the merged layout when its tables fit this byte budget (the
# JAX package's rule, kept so that one command resolves to one layout in both
# packages).
MERGED_BYTES_LIMIT = 1_200_000_000

Grid = Tuple[Sequence[torch.Tensor], Sequence[torch.Tensor]]  # (planes, lines)


def _pack_plane_corners(plane: torch.Tensor, stride: int) -> torch.Tensor:
    """[C, H, W] plane -> corner-packed strided table [(Hs+1)*(Ws+1), 4*C].

    Row (y, x) holds [P(y,x) | P(y,x+1) | P(y+1,x) | P(y+1,x+1)] read from
    the stride-s virtual grid, zero outside it, with a +1 halo offset so
    corner y0 = -1 queries resolve to the right rows.
    """
    if stride != 1:
        plane = plane[:, ::stride, ::stride]
    C, Hs, Ws = plane.shape
    z = torch.nn.functional.pad(plane, (1, 1, 1, 1))  # zero halo
    c00 = z[:, :-1, :-1]
    c01 = z[:, :-1, 1:]
    c10 = z[:, 1:, :-1]
    c11 = z[:, 1:, 1:]
    packed = torch.cat([c00, c01, c10, c11], dim=0)  # [4C, Hs+1, Ws+1]
    return packed.reshape(4 * C, (Hs + 1) * (Ws + 1)).t().contiguous()


def _pack_line(lines: Sequence[torch.Tensor], stride: int) -> torch.Tensor:
    """Concat per-grid [C_g, L] lines -> strided [Ls, sum C_g] (channel-last)."""
    cat = torch.cat(list(lines), dim=0)
    if stride != 1:
        cat = cat[:, ::stride]
    return cat.t().contiguous()


class PackedVM:
    """Per-orientation corner-packed plane tables + line tables."""

    def __init__(self, tables, line_tables, meta):
        self.tables = tables            # [o] -> [R_o, 4*Cp_o]
        self.line_tables = line_tables  # [o][si] -> [Ls, Cp_o]
        self.meta = meta                # static layout info


def merged_table_bytes(grids, strides) -> int:
    """Bytes of the f32 merged-layout tables (the JAX package's 'auto' rule):
    one row per joint multiscale cell, `_merged_axis_len` cells per axis."""
    total = 0
    for o in range(3):
        planes_o = [g[0][o] for g in grids]
        Cp = sum(int(p.shape[0]) for p in planes_o)
        H, W = planes_o[0].shape[1], planes_o[0].shape[2]
        Ly = _merged_axis_len(H, tuple(strides))
        Lx = _merged_axis_len(W, tuple(strides))
        total += Ly * Lx * len(strides) * 4 * Cp * 4
    return total


def _merged_axis_len(n: int, strides: tuple) -> int:
    """len(_axis_seg_maps(n, strides)[0][0]) of the JAX package: the lead-in
    states (Σ_s (i_s + 1) before the first breakpoint, plus one) followed by
    one state per breakpoint (each stride of length h > 1 has h)."""
    ns = [_strided_len(n, s) for s in strides]
    seg0 = sum(1 if h == 1 else 0 for h in ns)
    events = sum(h for h in ns if h > 1)
    return seg0 + 1 + events


def pack_vm(
    grids: Sequence[Grid],
    strides: Sequence[int] = (1,),
    layout: str = "auto",
) -> PackedVM:
    """Build the fused tables for one or more VM grids sampled at shared xyz.

    grids: list of (planes, lines), planes[i] [C_g_i, H_i, W_i] and lines[i]
    [C_g_i, L_i] in MAT_MODE/VEC_MODE orientation order, one spatial
    resolution for all grids.

    layout: 'strided' (this slice), 'merged' (raises), or 'auto' — 'merged'
    when len(strides) > 1 and the merged tables fit MERGED_BYTES_LIMIT, else
    'strided' (rodynrf_tpu/ops/fused_vm.py:303-310).
    """
    strides = tuple(strides)
    if layout == "auto":
        layout = (
            "merged"
            if len(strides) > 1
            and merged_table_bytes(grids, strides) <= MERGED_BYTES_LIMIT
            else "strided"
        )
    if layout == "merged":
        raise NotImplementedError(
            "the merged-stride table layout is not ported yet (ROADMAP.md, next "
            "slice: bf16 gather with the merged layout and the segment-sum "
            "kernel); pass --vm_layout strided"
        )
    if layout != "strided":
        raise ValueError(f"unknown vm layout {layout!r}")
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
            seg = _pack_plane_corners(cat_planes, s)
            segs.append(seg)
            offs.append(off)
            off += seg.shape[0]
            dd.append((_strided_len(H, s), _strided_len(W, s)))
            ld.append(_strided_len(L, s))
            lt.append(_pack_line(lines_o, s))
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
    """[Ls, C] line table sampled at u [N] -> [N, C]: align_corners linear
    interpolation with zero padding, as the 2-tap lerp of
    grid_sample.sample_line (see the module docstring for why not the hat
    matmul)."""
    g = (u + 1.0) * 0.5 * (Ls - 1)
    i0f = torch.floor(g)
    w1 = (g - i0f)[:, None]
    i0 = i0f.to(torch.int64)
    i1 = i0 + 1
    ib0 = ((i0 >= 0) & (i0 <= Ls - 1)).to(u.dtype)[:, None]
    ib1 = ((i1 >= 0) & (i1 <= Ls - 1)).to(u.dtype)[:, None]
    v0 = table.index_select(0, i0.clamp(0, Ls - 1)).to(u.dtype) * ib0
    v1 = table.index_select(0, i1.clamp(0, Ls - 1)).to(u.dtype) * ib1
    return v0 * (1 - w1) + v1 * w1


def plane_rows_weights(packed: PackedVM, xyz: torch.Tensor, o: int):
    """Orientation o's gather rows and corner weights at xyz [N, 3]: per
    stride, rows [N] int32 into packed.tables[o] and w4 [N, 4] (bilinear
    corner weights × the zero-padding band mask)."""
    meta = packed.meta
    m0, m1 = MAT_MODE[o]
    x_u, y_u = xyz[:, m0], xyz[:, m1]
    idx_list, w_list = [], []
    for si in range(len(meta["strides"])):
        Hs, Ws = meta["dims"][o][si]
        x0, wx, vx = _axis_lerp(x_u, Ws)
        y0, wy, vy = _axis_lerp(y_u, Hs)
        idx_list.append((y0 + 1) * (Ws + 1) + (x0 + 1) + meta["row_offsets"][o][si])
        valid = (vx & vy).to(xyz.dtype)
        w_list.append(torch.stack(
            [
                (1 - wy) * (1 - wx) * valid,
                (1 - wy) * wx * valid,
                wy * (1 - wx) * valid,
                wy * wx * valid,
            ],
            dim=-1,
        ))
    return idx_list, w_list


def sample_vm_fused(packed: PackedVM, xyz: torch.Tensor) -> List[torch.Tensor]:
    """Sample every grid of `packed` at xyz [N, 3] (normalized [-1, 1]).

    Returns one [N, sum_o C_g_o * n_strides] tensor per grid, channels
    ordered stride-major then orientation (reference cat order,
    tensoRF.py:670-721).
    """
    meta = packed.meta
    nS = len(meta["strides"])
    N = xyz.shape[0]
    per_grid = [[None] * (nS * 3) for _ in range(meta["n_grids"])]

    for o in range(3):
        idx_list, w_list = plane_rows_weights(packed, xyz, o)
        # one gather (and one table-gradient launch) per orientation covers
        # every stride
        feats = planes_sample(packed.tables[o], torch.cat(idx_list), torch.cat(w_list))
        z_u = xyz[:, VEC_MODE[o]]
        for si in range(nS):
            line = _line_feats(packed.line_tables[o][si], z_u, meta["line_dims"][o][si])
            prod = feats[si * N:(si + 1) * N] * line  # [N, Cp]
            c0 = 0
            for gi, cg in enumerate(meta["c_splits"][o]):
                per_grid[gi][si * 3 + o] = prod[:, c0:c0 + cg]
                c0 += cg

    return [torch.cat(chunks, dim=-1) for chunks in per_grid]
