"""Mesh export: dense alpha grid -> isosurface -> PLY (port of
rodynrf_tpu/eval/mesh.py; reference train.py:106-118 export_mesh,
tensorBase.py:564-589 getDenseAlpha, utils.py:188-248
convert_sdf_samples_to_ply).

The reference extracts the surface with skimage's marching cubes and writes
it with plyfile; the JAX package replaced both with a marching-tetrahedra
extractor and a minimal PLY writer, and this module carries those on
tensors: the alpha volume is evaluated on the parameters' device and the
surface is extracted on the volume's device.

The arithmetic keeps numpy's dtypes (NEP 50), so that a volume gives the
JAX package's vertices and faces bit for bit: the interpolant `t` is in the
volume's dtype, the vertex positions in float64 (an integer corner plus `t`
times an integer edge), the vertex dedup rounds to 1e-4 voxel half to even
and orders the unique rows as `np.unique(axis=0)` does.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..fields import dynamic as dyn
from ..fields.static import feature2density
from ..train.checkpoints import load_checkpoint
from ..train.convert import params_from_numpy
from ..train.step import check_device

LEVEL = 0.005  # the reference's export level (train.py:115)


def dense_alpha(params, cfg, aabb, t_value: float = -1.0, grid_size=None,
                chunk: int = 65536) -> torch.Tensor:
    """The dynamic field's alpha at time `t_value` on a `grid_size` (default
    `cfg.grid_size`) lattice spanning the aabb, on the parameters' device
    (reference: tensorBase.py:564-589). `params` is the dynamic field's tree
    of tensors; returns an f32 volume of shape `grid_size`."""
    gs = tuple(int(g) for g in (grid_size or cfg.grid_size))
    dev = params["density_plane"][0].device
    aabb_np = np.asarray(aabb.detach().cpu() if torch.is_tensor(aabb) else aabb)
    box = torch.as_tensor(aabb_np, device=dev)
    # each axis as the JAX package builds the [N, 3] lattice: float64
    # linspace cast to f32, then aabb0 · (1 − p) + aabb1 · p in the aabb's
    # dtype, cast to f32
    axes = []
    for a, n in enumerate(gs):
        p = torch.from_numpy(np.linspace(0, 1, n).astype(np.float32)).to(dev)
        axes.append((box[0, a] * (1 - p) + box[1, a] * p).float())
    aabb_t = box.float()
    step = cfg.step_size(aabb_np)
    ny, nz = gs[1], gs[2]
    n = gs[0] * ny * nz
    out = torch.empty(n, dtype=torch.float32, device=dev)
    with torch.no_grad():
        for s in range(0, n, chunk):
            idx = torch.arange(s, min(s + chunk, n), device=dev)
            xyz = torch.stack([axes[0][idx // (ny * nz)], axes[1][(idx // nz) % ny],
                               axes[2][idx % nz]], -1)
            t = torch.full((xyz.shape[0],), t_value, dtype=torch.float32, device=dev)
            xyz_n = dyn.normalize_coord(xyz, aabb_t)
            xyz_prime_n = dyn.normalize_coord(dyn.warp_coordinate(params, xyz, t, aabb_t), aabb_t)
            sigma = feature2density(dyn.density_feature(params, cfg, xyz_n, t, xyz_prime_n), cfg)
            out[s:s + xyz.shape[0]] = 1.0 - torch.exp(-sigma * step)
    return out.reshape(gs)


# 6-tetrahedra decomposition of a cube (corner indices into the 8-corner cube)
_TETS = ((0, 5, 1, 6), (0, 1, 2, 6), (0, 2, 3, 6), (0, 3, 7, 6), (0, 7, 4, 6), (0, 4, 5, 6))
_CUBE = ((0, 0, 0), (1, 0, 0), (1, 1, 0), (0, 1, 0), (0, 0, 1), (1, 0, 1), (1, 1, 1), (0, 1, 1))
_OTHERS = ((1, 2, 3), (0, 2, 3), (0, 1, 3), (0, 1, 2))  # the tet corners besides each one


def marching_tetrahedra(volume, level: float):
    """Isosurface of a 3-D scalar field by marching tetrahedra, on the
    volume's device. Returns (vertices [V, 3] f32 in voxel coordinates,
    faces [F, 3] int64). Cases go tet by tet: one corner apart (1 in, then
    3 in: one triangle), then two in and two out (a quad as two
    triangles)."""
    vol = torch.as_tensor(volume)
    dev = vol.device
    nx, ny, nz = vol.shape
    # corner values of every cube: [(nx-1)(ny-1)(nz-1), 8]
    vals = torch.stack([vol[dx:nx - 1 + dx, dy:ny - 1 + dy, dz:nz - 1 + dz]
                        for dx, dy, dz in _CUBE], -1).reshape(-1, 8)
    cube = torch.tensor(_CUBE, dtype=torch.int64, device=dev)
    others = torch.tensor(_OTHERS, dtype=torch.int64, device=dev)
    rounded = []
    for tet_l in _TETS:
        tet = torch.tensor(tet_l, dtype=torch.int64, device=dev)
        inside = vals[:, tet] > level
        n_in = inside.sum(-1)

        def interp(sel, a, b):
            # the cube's integer base corner, from its flat index
            base = torch.stack([sel // ((ny - 1) * (nz - 1)), (sel // (nz - 1)) % (ny - 1),
                                sel % (nz - 1)], -1)
            ca, cb = tet[a], tet[b]
            pa, pb = base + cube[ca], base + cube[cb]
            va, vb = vals[sel, ca], vals[sel, cb]
            t = (level - va) / (vb - va + 1e-12)
            return pa.double() + t.double()[:, None] * (pb - pa).double()

        def keep(tri):
            # dedup key: the vertex rounded to 1e-4 voxel (half to even)
            rounded.append(torch.round(tri.reshape(-1, 3) * 1e4).to(torch.int64))

        for iso in (1, 3):
            sel = torch.nonzero(n_in == iso)[:, 0]
            if len(sel) == 0:
                continue
            ins = inside[sel] if iso == 1 else ~inside[sel]
            corner = torch.argmax(ins.to(torch.uint8), -1)  # the one isolated corner
            o = others[corner]
            keep(torch.stack([interp(sel, corner, o[:, k]) for k in range(3)], 1))

        sel = torch.nonzero(n_in == 2)[:, 0]
        if len(sel):
            # inside corners first, each pair in index order (numpy's insertion
            # sort of 4 keeps ties in order); distinct keys make any sort agree
            key = (~inside[sel]).to(torch.int64) * 4 + torch.arange(4, device=dev)
            order = torch.argsort(key, dim=-1)
            a0, a1, b0, b1 = order.unbind(-1)
            p00, p01 = interp(sel, a0, b0), interp(sel, a0, b1)
            p10, p11 = interp(sel, a1, b0), interp(sel, a1, b1)
            keep(torch.stack([p00, p01, p10], 1))
            keep(torch.stack([p01, p11, p10], 1))
            del p00, p01, p10, p11

    if not rounded:
        return (torch.zeros((0, 3), dtype=torch.float32, device=dev),
                torch.zeros((0, 3), dtype=torch.int64, device=dev))
    rows = torch.cat(rounded)
    rounded.clear()
    uniq, inv = _unique_rows(rows)
    del rows
    vertices = uniq.double() / 1e4
    faces = inv.reshape(-1, 3)
    good = ((faces[:, 0] != faces[:, 1]) & (faces[:, 1] != faces[:, 2])
            & (faces[:, 0] != faces[:, 2]))
    return vertices.float(), faces[good]


def _unique_rows(rows: torch.Tensor):
    """(unique rows in lexicographic order, the inverse index of each row),
    as `np.unique(rows, axis=0, return_inverse=True)` gives them: three
    stable sorts of one column each, from the last."""
    order = torch.arange(len(rows), device=rows.device)
    for col in (2, 1, 0):
        order = order[torch.sort(rows[order, col], stable=True).indices]
    srt = rows[order]
    new = torch.ones(len(rows), dtype=torch.bool, device=rows.device)
    new[1:] = (srt[1:] != srt[:-1]).any(-1)
    inv = torch.empty_like(order)
    inv[order] = torch.cumsum(new, 0) - 1
    return srt[new], inv


def write_ply(path: str, vertices, faces):
    """Binary little-endian PLY of float vertices and triangle faces, the
    JAX package's writer byte for byte (replaces plyfile)."""
    vertices = np.asarray(vertices.cpu() if torch.is_tensor(vertices) else vertices)
    faces = np.asarray(faces.cpu() if torch.is_tensor(faces) else faces)
    with open(path, "wb") as f:
        header = (
            "ply\nformat binary_little_endian 1.0\n"
            f"element vertex {len(vertices)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            f"element face {len(faces)}\n"
            "property list uchar int vertex_indices\nend_header\n"
        )
        f.write(header.encode())
        vertices.astype("<f4").tofile(f)
        face_rec = np.empty(len(faces), dtype=[("n", "u1"), ("idx", "<i4", 3)])
        face_rec["n"] = 3
        face_rec["idx"] = faces
        face_rec.tofile(f)


def _to_world(verts: torch.Tensor, shape, aabb) -> torch.Tensor:
    """Voxel -> world coordinates in float64, as numpy promotes them."""
    aabb = torch.as_tensor(np.asarray(aabb.detach().cpu() if torch.is_tensor(aabb) else aabb),
                           device=verts.device)
    gs = torch.tensor(shape, dtype=torch.float64, device=verts.device) - 1
    return aabb[0] + verts / gs * (aabb[1] - aabb[0])


def convert_alpha_to_ply(alpha, aabb, path: str, level: float = LEVEL):
    """Surface of an alpha volume at `level`, written to `path` in world
    coordinates (reference: utils.py:188-248 convert_sdf_samples_to_ply).
    Returns (world vertices [V, 3] float64, faces [F, 3])."""
    verts, faces = marching_tetrahedra(alpha, level)
    world = _to_world(verts, tuple(alpha.shape), aabb)
    write_ply(path, world.float(), faces)
    return world, faces


def _seconds(dev, t0: float) -> float:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter() - t0


def export_mesh_from_ckpt(ckpt_path: str, out_path: str, level: float = LEVEL,
                          device="cuda") -> dict:
    """The dynamic field's surface at t = -1 from a native `.npz`
    checkpoint, as a PLY at `out_path`, computed on `device` (the card
    unless the caller asks for the CPU). Returns {ply, vertices, faces,
    ply_bytes, alpha_max, alpha_share (of voxels above `level`), grid,
    dense_alpha_s, marching_s, write_s}."""
    dev = check_device(device)
    params, _, dynamic_cfg, aabb, _ = load_checkpoint(ckpt_path)
    t0 = time.perf_counter()
    alpha = dense_alpha(params_from_numpy(params["dynamic"], dev), dynamic_cfg, aabb)
    report = {"ply": out_path, "grid": list(alpha.shape), "dense_alpha_s": _seconds(dev, t0)}
    report["alpha_max"] = float(alpha.max())
    report["alpha_share"] = float((alpha > level).double().mean())
    t0 = time.perf_counter()
    verts, faces = marching_tetrahedra(alpha, level)
    report["marching_s"] = _seconds(dev, t0)
    del alpha
    t0 = time.perf_counter()
    write_ply(out_path, _to_world(verts, report["grid"], aabb).float(), faces)
    report["write_s"] = _seconds(dev, t0)
    report.update(vertices=len(verts), faces=len(faces), ply_bytes=os.path.getsize(out_path))
    return report
