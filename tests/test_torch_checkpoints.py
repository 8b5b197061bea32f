"""Checkpoints of the port (rodynrf_tpu_torch/train/checkpoints.py and
Trainer.save_full / --ckpt) against the JAX package's format.

- A native .npz written and read back by the port: every array equal, the
  configs and `extra` equal, the occupancy mask (an AlphaGridMask) equal.
- A checkpoint the JAX package writes loads into the port with every array
  equal (a mask included), and one the port writes loads into the JAX
  package the same way.
- export_th -> import_th round trip in the port; a masked .th crosses both
  ways between the packages with the mask equal; the port's import_th of
  the reference's own golden/out/init_{static,dynamic}.th equal, array for
  array, to the JAX package's; the port's .th export equal to the JAX
  package's state dict.
- Resume: on the TINY scene, n steps + save_full + a new Trainer with
  --ckpt + 3 steps equals n + 3 straight steps bit for bit (every metric of
  every step and every parameter after), also across the upsample at
  iteration 8; a plain checkpoint resumes at its iteration and grid. A
  full checkpoint with an occupancy mask and --compact_train 1 resumes with
  the mask, the compaction buckets and the trajectory bit for bit.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from rodynrf_tpu.fields.alpha_mask import AlphaGridMask
from rodynrf_tpu.fields.config import FieldConfig as JFieldConfig
from rodynrf_tpu.train import checkpoints as jck
from rodynrf_tpu_torch.fields.alpha_mask import AlphaGridMask as TMask
from rodynrf_tpu_torch.testing import tiny_cmd, tiny_scene, torch_threads
from rodynrf_tpu_torch.train import Trainer, parse_cmd
from rodynrf_tpu_torch.train import checkpoints as tck
from rodynrf_tpu_torch.train.convert import params_to_numpy

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
GOLDEN = os.path.join(REPO, "golden", "out")
CMD = tiny_cmd("ndc", 1) + " --bf16 1"

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, np.asarray(tree)


def _assert_trees_equal(a, b):
    la, lb = dict(_leaves(a)), dict(_leaves(b))
    assert la.keys() == lb.keys()
    for k in la:
        assert la[k].dtype == lb[k].dtype, k
        np.testing.assert_array_equal(la[k], lb[k], err_msg=str(k))


@pytest.fixture(scope="module")
def trained():
    tr = Trainer(parse_cmd(CMD), tiny_scene("ndc"), device="cpu")
    for _ in range(2):
        tr.run_step()
    return tr


def _params(tr):
    return params_to_numpy({k: tr.params[k] for k in ("static", "dynamic", "pose", "fov")})


def _mask(seed=0):
    rng = np.random.default_rng(seed)
    vol = (rng.random((5, 6, 4, 3)) > 0.5).astype(np.uint8)
    aabb = np.array([[-1.5, -1.67, -1.0], [1.5, 1.67, 1.0]], np.float32)
    return vol, aabb


def _tmask(vol, aabb):
    return TMask(torch.from_numpy(aabb), torch.from_numpy(vol))


def test_npz_round_trip(trained, tmp_path):
    tr = trained
    vol, aabb = _mask()
    path = str(tmp_path / "c.npz")
    extra = {"focal": 12.5, "iteration": tr.iteration, "nested": {"a": [1, 2]}}
    tck.save_checkpoint(path, {k: tr.params[k] for k in ("static", "dynamic", "pose", "fov")},
                        tr.static_cfg, tr.dynamic_cfg, tr.aabb, extra=extra,
                        alpha_mask=_tmask(vol, aabb))
    params, st, dy, ab, ex, al = tck.load_checkpoint(path, return_alpha=True)
    _assert_trees_equal(params, _params(tr))
    assert (st, dy, ex) == (tr.static_cfg, tr.dynamic_cfg, extra)
    np.testing.assert_array_equal(ab, tr.aabb.numpy())
    assert al.alpha_volume.dtype == torch.uint8
    np.testing.assert_array_equal(al.alpha_volume.numpy(), vol)
    np.testing.assert_array_equal(al.aabb.numpy(), aabb)


def test_checkpoints_cross_between_packages(trained, tmp_path):
    tr = trained
    jst, jdy = (JFieldConfig(**dataclasses.asdict(c)) for c in (tr.static_cfg, tr.dynamic_cfg))
    vol, aabb = _mask(1)
    extra = {"focal": 30.0, "iteration": 2}
    # JAX -> port
    jpath = str(tmp_path / "jax.npz")
    jck.save_checkpoint(jpath, _params(tr), jst, jdy, tr.scene.scene_bbox, extra=extra,
                        alpha_mask=AlphaGridMask(aabb=aabb, alpha_volume=vol))
    params, st, dy, ab, ex, al = tck.load_checkpoint(jpath, return_alpha=True)
    _assert_trees_equal(params, _params(tr))
    assert (st, dy, ex) == (tr.static_cfg, tr.dynamic_cfg, extra)
    np.testing.assert_array_equal(ab, tr.scene.scene_bbox)
    # port -> JAX, the mask carried through the port as its AlphaGridMask
    tpath = str(tmp_path / "port.npz")
    tck.save_checkpoint(tpath, params, st, dy, ab, extra=ex, alpha_mask=al)
    jparams, jst2, jdy2, jab, jex, jal = jck.load_checkpoint(tpath, return_alpha=True)
    _assert_trees_equal(jparams, _params(tr))
    assert (jst2, jdy2, jex) == (jst, jdy, extra)
    np.testing.assert_array_equal(np.asarray(jal.alpha_volume), vol)
    np.testing.assert_array_equal(np.asarray(jal.aabb), aabb)


def test_th_round_trip_and_export_match_jax(trained, tmp_path):
    tr = trained
    poses = np.asarray(torch.rand((4, 3, 4), generator=torch.Generator().manual_seed(0)))
    for name, dynamic in (("dynamic", True), ("static", False)):
        cfg = tr.dynamic_cfg if dynamic else tr.static_cfg
        path = str(tmp_path / f"{name}.th")
        tck.export_th(path, tr.params[name], cfg, tr.aabb, poses, 23.5, dynamic=dynamic)
        params, meta = tck.import_th(path)
        _assert_trees_equal(params, params_to_numpy(tr.params[name]))
        assert meta["dynamic"] is dynamic
        assert list(meta["kwargs"]["gridSize"]) == list(cfg.grid_size)
        np.testing.assert_array_equal(meta["kwargs"]["se3_poses"], poses)
        ours = (tck.dynamic_state_dict if dynamic else tck.static_state_dict)(
            tr.params[name], cfg)
        ref = (jck.dynamic_state_dict if dynamic else jck.static_state_dict)(
            params_to_numpy(tr.params[name]), JFieldConfig(**dataclasses.asdict(cfg)))
        assert ours.keys() == ref.keys()
        for k in ref:
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_masked_th_crosses_between_packages(trained, tmp_path):
    tr = trained
    poses = np.tile(np.eye(4, dtype=np.float32)[:3], (4, 1, 1))
    vol, aabb = _mask(2)
    cfg = tr.dynamic_cfg
    jcfg = JFieldConfig(**dataclasses.asdict(cfg))
    jmask = AlphaGridMask(aabb=aabb, alpha_volume=vol)
    # port -> JAX
    tpath = str(tmp_path / "port.th")
    tck.export_th(tpath, tr.params["dynamic"], cfg, tr.aabb, poses, 20.0, dynamic=True,
                  alpha_mask=_tmask(vol, aabb))
    _, jmeta = jck.import_th(tpath)
    np.testing.assert_array_equal(np.asarray(jmeta["alpha_mask"].alpha_volume), vol)
    np.testing.assert_array_equal(np.asarray(jmeta["alpha_mask"].aabb), aabb)
    # JAX -> port, and the two files hold the same mask entries
    jpath = str(tmp_path / "jax.th")
    jck.export_th(jpath, params_to_numpy(tr.params["dynamic"]), jcfg, tr.aabb.numpy(), poses,
                  20.0, dynamic=True, alpha_mask=jmask)
    _, meta = tck.import_th(jpath)
    np.testing.assert_array_equal(meta["alpha_mask"].alpha_volume.numpy(), vol)
    np.testing.assert_array_equal(meta["alpha_mask"].aabb.numpy(), aabb)
    a, b = (torch.load(p, map_location="cpu", weights_only=False) for p in (tpath, jpath))
    assert tuple(a["alphaMask.shape"]) == tuple(b["alphaMask.shape"]) == (1, 1) + vol.shape
    np.testing.assert_array_equal(a["alphaMask.mask"], b["alphaMask.mask"])


@pytest.mark.parametrize("name", ["static", "dynamic"])
def test_import_th_of_reference_init_matches_jax(name):
    path = os.path.join(GOLDEN, f"init_{name}.th")
    ours, meta = tck.import_th(path)
    ref, jmeta = jck.import_th(path)
    _assert_trees_equal(ours, jax.tree_util.tree_map(np.asarray, ref))
    assert meta["dynamic"] == jmeta["dynamic"] == (name == "dynamic")
    assert set(meta["kwargs"]) == set(jmeta["kwargs"])


def _run(tr, n):
    return [{k: float(v) for k, v in tr.run_step().items()} for _ in range(n)]


@pytest.mark.parametrize("head", [3, 7])
def test_resume_from_a_full_checkpoint_is_exact(tmp_path, head):
    straight = Trainer(parse_cmd(CMD), tiny_scene("ndc"), device="cpu")
    want = _run(straight, head + 3)

    first = Trainer(parse_cmd(CMD), tiny_scene("ndc"), device="cpu")
    assert _run(first, head) == want[:head]
    path = str(tmp_path / "full.npz")
    first.save_full(path)

    resumed = Trainer(parse_cmd(CMD + f" --ckpt {path}"), tiny_scene("ndc"), device="cpu")
    assert resumed.iteration == head
    assert resumed.static_cfg.grid_size == first.static_cfg.grid_size
    assert _run(resumed, 3) == want[head:]
    _assert_trees_equal(params_to_numpy(resumed.params), params_to_numpy(straight.params))
    assert resumed.static_cfg == straight.static_cfg
    assert resumed.table_layouts() == straight.table_layouts()


def test_resume_with_a_mask_is_exact(tmp_path):
    """A full checkpoint of a trainer whose step compacts against its mask
    resumes with the mask and the bucket sizes: the next steps equal the
    straight run's bit for bit."""
    cmd = (CMD + " --N_voxel_init 32768 --N_voxel_final 32768 --nSamples 64 --compact_train 1"
           " --alpha_mask_thre 0.04 --compact_quantile 0.5 --upsamp_list 100")

    def start():
        tr = Trainer(parse_cmd(cmd), tiny_scene("ndc"), device="cpu")
        _run(tr, 1)
        tr.update_alpha_mask()
        return tr

    straight = start()
    assert straight.compact_k > 0
    want = _run(straight, 3)
    first = start()
    assert _run(first, 1) == want[:1]
    path = str(tmp_path / "masked.npz")
    first.save_full(path)
    resumed = Trainer(parse_cmd(cmd + f" --ckpt {path}"), tiny_scene("ndc"), device="cpu")
    assert (resumed.compact_k, resumed.compact_flat) == (straight.compact_k,
                                                         straight.compact_flat)
    assert torch.equal(resumed.alpha_mask.alpha_volume, straight.alpha_mask.alpha_volume)
    assert _run(resumed, 2) == want[1:]


def test_resume_from_a_plain_checkpoint(tmp_path):
    """A plain checkpoint (the CLI's) restarts the optimizers at its
    iteration and grid, past the upsample it records."""
    tr = Trainer(parse_cmd(CMD), tiny_scene("ndc"), device="cpu")
    _run(tr, 9)
    path = str(tmp_path / "plain.npz")
    tck.save_checkpoint(path, {k: tr.params[k] for k in ("static", "dynamic", "pose", "fov")},
                        tr.static_cfg, tr.dynamic_cfg, tr.aabb, extra={"iteration": 9})
    resumed = Trainer(parse_cmd(CMD + f" --ckpt {path}"), tiny_scene("ndc"), device="cpu")
    assert resumed.iteration == 9 and resumed.static_cfg.grid_size == tr.static_cfg.grid_size
    assert resumed.n_voxel_list == tr.n_voxel_list
    _assert_trees_equal(params_to_numpy(resumed.params), _params(tr))
    last = resumed.train(2)  # Trainer.train: to n_iters by default, host floats back
    assert resumed.iteration == 11 and all(np.isfinite(v) for v in last.values())
