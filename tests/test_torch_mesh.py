"""The port's mesh export (rodynrf_tpu_torch/eval/mesh.py) against the JAX
package's (rodynrf_tpu/eval/mesh.py), on the CPU.

- `marching_tetrahedra` gives the JAX function's vertices and faces bit for
  bit on seeded volumes: a random field, a smooth sphere, a level no corner
  crosses (the empty result), and a volume whose corners sit exactly at the
  level; `write_ply` writes the same bytes.
- `dense_alpha` of the reference's trained basin field
  (golden/out_basin/.../golden_basin.th, 2,000 iterations of
  golden/basin.txt), imported by each package's `import_th`, agrees with
  the JAX function to 1e-6 absolute plus twice the JAX function's own
  float32 error against a float64 evaluation of the same lattice (alpha
  lies in [0, 1]; the warp and the heads read positional encodings of up to
  2^9 times the coordinate, so both packages' f32 results sit 2.5e-6 to
  3.9e-6 from float64 and 3.8e-6 from each other).
- The slice end to end: that field saved as .npz, then `cli.main([...,
  "--export_mesh", "1", "--ckpt", X.npz], device="cpu")` against the JAX
  package's `export_mesh_from_ckpt` of the same file: a non-empty surface,
  the same faces, vertices within one 1e-4-voxel rounding step of the
  dedup (in world units), and no training.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from rodynrf_tpu.eval import mesh as jmesh
from rodynrf_tpu.fields.config import FieldConfig as JFieldConfig
from rodynrf_tpu.train.checkpoints import import_th as jimport_th
from rodynrf_tpu_torch.cli import _load_reference_th_pair, main
from rodynrf_tpu_torch.eval import mesh
from rodynrf_tpu_torch.fields import dynamic as dyn
from rodynrf_tpu_torch.fields.static import feature2density
from rodynrf_tpu_torch.testing import torch_threads
from rodynrf_tpu_torch.train.checkpoints import save_checkpoint
from rodynrf_tpu_torch.train.convert import params_from_numpy

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
BASIN = os.path.join(REPO, "golden", "out_basin", "ref_log", "golden_basin", "golden_basin.th")
ALPHA_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def _volume(kind):
    rng = np.random.default_rng(3)
    if kind == "random":
        return rng.uniform(0, 1, (12, 14, 10)).astype(np.float32), 0.5
    if kind == "sphere":
        g = np.mgrid[0:16, 0:16, 0:16].astype(np.float32)
        return np.exp(-np.sqrt(((g - 7.5) ** 2).sum(0)) / 4).astype(np.float32), 0.25
    if kind == "no_crossing":
        return rng.uniform(0, 0.4, (8, 9, 7)).astype(np.float32), 0.5
    # corners exactly at the level: quarter steps, level 0.5
    return (np.round(rng.uniform(0, 1, (9, 9, 9)) * 4) / 4).astype(np.float32), 0.5


@pytest.mark.parametrize("kind", ["random", "sphere", "no_crossing", "corner_at_level"])
def test_marching_tetrahedra_equals_jax(kind, tmp_path):
    vol, level = _volume(kind)
    jv, jf = jmesh.marching_tetrahedra(vol, level)
    tv, tf = mesh.marching_tetrahedra(torch.from_numpy(vol), level)
    assert tv.dtype == torch.float32 and tf.dtype == torch.int64
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(tf.numpy(), jf)
    if kind == "no_crossing":
        assert len(jf) == 0
    else:
        assert len(jf) > 50
    jmesh.write_ply(str(tmp_path / "j.ply"), jv, jf)
    mesh.write_ply(str(tmp_path / "t.ply"), tv, tf)
    assert (tmp_path / "t.ply").read_bytes() == (tmp_path / "j.ply").read_bytes()


@pytest.fixture(scope="module")
def basin():
    """The basin pair imported by the port; the dynamic field by both."""
    params, st_cfg, dy_cfg, aabb, _, focal, _ = _load_reference_th_pair(BASIN)
    jparams, _ = jimport_th(BASIN)
    return params, st_cfg, dy_cfg, aabb, focal, jparams


def _alpha_float64(params, cfg, aabb):
    """dense_alpha's lattice (f32, as both packages build it) evaluated in
    float64."""
    xs = [np.linspace(0, 1, n).astype(np.float32) for n in cfg.grid_size]
    pts = np.stack(np.meshgrid(*xs, indexing="ij"), -1).reshape(-1, 3)
    pts = aabb[0] * (1 - pts) + aabb[1] * pts
    p64 = _double(params_from_numpy(params, "cpu"))
    xyz, box = torch.from_numpy(pts).double(), torch.from_numpy(aabb).double()
    t = torch.full((len(xyz),), -1.0, dtype=torch.float64)
    with torch.no_grad():
        xyz_n = dyn.normalize_coord(xyz, box)
        warped_n = dyn.normalize_coord(dyn.warp_coordinate(p64, xyz, t, box), box)
        sigma = feature2density(dyn.density_feature(p64, cfg, xyz_n, t, warped_n), cfg)
        return (1 - torch.exp(-sigma * cfg.step_size(aabb))).numpy().reshape(cfg.grid_size)


def _double(tree):
    if isinstance(tree, dict):
        return {k: _double(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_double(v) for v in tree]
    return tree.detach().double()


def test_dense_alpha_matches_jax(basin):
    params, _, dy_cfg, aabb, _, jparams = basin
    ours = mesh.dense_alpha(params_from_numpy(params["dynamic"], "cpu"), dy_cfg, aabb)
    ref = jmesh.dense_alpha(jparams, JFieldConfig(**dataclasses.asdict(dy_cfg)), aabb)
    assert ours.dtype == torch.float32 and ours.shape == ref.shape == tuple(dy_cfg.grid_size)
    jax_err = float(np.abs(ref - _alpha_float64(params["dynamic"], dy_cfg, aabb)).max())
    err = float(np.abs(ours.numpy() - ref).max())
    limit = ALPHA_ATOL + 2 * jax_err
    print(f"basin dense_alpha: max |port - JAX| {err:.3e} (limit {limit:.3e}; JAX's own f32 "
          f"error {jax_err:.3e})")
    assert err <= limit
    assert 0 < (ref > mesh.LEVEL).mean() < 1  # the surface crosses the grid


def test_export_mesh_through_the_cli_matches_jax(basin, tmp_path, capsys):
    params, st_cfg, dy_cfg, aabb, focal, _ = basin
    ckpt = str(tmp_path / "basin.npz")
    save_checkpoint(ckpt, {"static": params["static"], "dynamic": params["dynamic"],
                           "pose": np.zeros((4, 9), np.float32),
                           "fov": np.zeros((1, 1), np.float32)},
                    st_cfg, dy_cfg, aabb, extra={"focal": focal})
    rep = main(["--config", os.path.join(REPO, "golden", "basin.txt"), "--export_mesh", "1",
                "--ckpt", ckpt, "--basedir", str(tmp_path / "log")], device="cpu")
    assert "iter " not in capsys.readouterr().out  # nothing trained
    assert not (tmp_path / "log").exists()
    m = rep["mesh"]
    assert m["ply"] == str(tmp_path / "basin.ply") and os.path.getsize(m["ply"]) == m["ply_bytes"]

    jworld, jfaces = jmesh.export_mesh_from_ckpt(ckpt, str(tmp_path / "jax.ply"))
    tworld, tfaces = _read_ply(m["ply"])
    assert m["faces"] == len(tfaces) == len(jfaces) > 0 and m["vertices"] == len(tworld)
    np.testing.assert_array_equal(tfaces, jfaces)
    # one dedup rounding step (1e-4 voxel) in world units, plus f32 output
    step = 1e-4 * float(np.max((aabb[1] - aabb[0]) / (np.asarray(m["grid"]) - 1)))
    err = float(np.abs(tworld - jworld.astype(np.float32)).max())
    print(f"basin mesh: V {len(tworld)}, F {len(tfaces)}, max |port - JAX| vertex {err:.3e} "
          f"(limit {step:.3e} + 1e-6)")
    assert err <= step + 1e-6


def _read_ply(path):
    """(vertices [V, 3] f32, faces [F, 3]) of a write_ply file."""
    data = open(path, "rb").read()
    head, body = data.split(b"end_header\n", 1)
    lines = head.decode().splitlines()
    nv = int(next(x for x in lines if x.startswith("element vertex")).split()[-1])
    nf = int(next(x for x in lines if x.startswith("element face")).split()[-1])
    verts = np.frombuffer(body[:12 * nv], "<f4").reshape(nv, 3)
    rec = np.frombuffer(body[12 * nv:], dtype=[("n", "u1"), ("idx", "<i4", 3)], count=nf)
    assert (rec["n"] == 3).all()
    return verts, rec["idx"].astype(np.int64)
