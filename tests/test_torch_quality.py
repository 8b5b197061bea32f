"""The port's quality tools (rodynrf_tpu_torch/tools/) against the JAX
package's scripts, on the CPU.

- (a) Schedule parity, no step compiled: each recipe of both tools (ndc and
  contract at 3,000 iterations; no_poses, gt_poses and gt_poses_compact at
  10,000) is the JAX script's command line, read out of the script itself;
  over the whole plan the port's LrSchedule and voxel plan equal the JAX
  package's: n_voxel_schedule, the grid and the samples per ray after each
  upsample, scalars(i) at every iteration within 1e-12 relative, the
  iterations of the focal activation and the pose freeze (and the tools'
  expected_events give them).
- (b) chip_smoke.py phase 15 rehearsed: quality_run.run on a 4×24×32 scene
  for 12 iterations (the recipe's upsamples at 2, 4, 6 and 8), narrowed by
  flags, then export_alpha of its checkpoint; the record has the JAX
  script's keys and the port's, every event fires at its iteration, the
  losses are finite, the kernels' launches read 0 on the CPU.
- (c) export_alpha on a TINY checkpoint written by the JAX trainer against
  the functions scripts/export_alpha.py calls on the same weights: the same
  npz keys, occupancy and new_aabb within 1e-6, the packed bits equal
  except at voxels whose pooled alpha lies within 1e-5 of the threshold.
- (d) quality_full's gt_poses_compact at TINY across its alpha-mask
  updates (threshold raised as test_torch_compact_train.py raises it):
  stopped halfway and resumed, it equals the straight run (which writes
  its full state every 3 iterations) bit for bit.
"""

import ast
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rodynrf_tpu.fields.config as jfc
import rodynrf_tpu.train.schedule as jsched
from rodynrf_tpu.data.scene import default_bbox as jdefault_bbox
from rodynrf_tpu.testing import tiny_cmd as jtiny_cmd
from rodynrf_tpu.testing import tiny_scene as jtiny_scene
from rodynrf_tpu.train import parse_cmd as jparse_cmd
from rodynrf_tpu_torch.data import make_synthetic_scene
from rodynrf_tpu_torch.data.scene import default_bbox
from rodynrf_tpu_torch.fields import config as tfc
from rodynrf_tpu_torch.testing import torch_threads
from rodynrf_tpu_torch.tools import export_alpha, quality_full, quality_run
from rodynrf_tpu_torch.train import parse_cmd
from rodynrf_tpu_torch.train import schedule as tsched
from rodynrf_tpu_torch.train.checkpoints import load_checkpoint

ROOT = Path(__file__).resolve().parents[1]
SCRIPTS = ROOT / "scripts"

RECIPES = [("quality_run", "ndc", 3000), ("quality_run", "contract", 3000),
           ("quality_full", "no_poses", 10000), ("quality_full", "gt_poses", 10000),
           ("quality_full", "gt_poses_compact", 10000)]


def _assigned(node):
    targets = node.targets[0]
    elts = targets.elts if isinstance(targets, ast.Tuple) else [targets]
    return {e.id for e in elts if isinstance(e, ast.Name)}


def _script_namespace(script: str, n_iters: int):
    """The JAX script's module-level constants, N_ITERS set to n_iters."""
    tree = ast.parse((SCRIPTS / f"{script}.py").read_text())
    ns = {"N_ITERS": n_iters}
    for node in tree.body:
        if isinstance(node, ast.Assign) and _assigned(node) & {"T", "H", "W", "RUNS",
                                                               "PSNR_FLOOR"}:
            exec(compile(ast.Module([node], []), script, "exec"), ns)
    return tree, ns


def _script_cmd(script: str, which: str, n_iters: int) -> str:
    """The command line `run(which)` of scripts/<script>.py hands to
    parse_cmd, evaluated from the script's own source."""
    tree, ns = _script_namespace(script, n_iters)
    ns.update(ray_type=which, name=which)
    run = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "run")
    for stmt in run.body:
        if not isinstance(stmt, ast.Assign):
            continue
        call = stmt.value
        if (isinstance(call, ast.Call) and isinstance(call.func, ast.Name)
                and call.func.id == "parse_cmd"):
            return eval(compile(ast.Expression(call.args[0]), script, "eval"), ns)
        if _assigned(stmt) <= {"T", "H", "W", "cfg", "up", "alpha_up"}:
            exec(compile(ast.Module([stmt], []), script, "exec"), ns)
    raise AssertionError(f"no parse_cmd call in {script}.run")


def test_tools_carry_the_scripts_constants():
    _, qr = _script_namespace("quality_run", 3000)
    _, qf = _script_namespace("quality_full", 10000)
    assert quality_run.PSNR_FLOOR == qr["PSNR_FLOOR"]
    assert quality_full.RUNS == qf["RUNS"]
    assert (quality_full.T, quality_full.H, quality_full.W) == (qf["T"], qf["H"], qf["W"])
    assert quality_run.SCENE == dict(T=8, H=96, W=128)  # scripts/quality_run.py:42
    assert quality_run.DEFAULT_SEED == jparse_cmd("--expname x").seed


def _plan(args, bbox, LrSchedule, n_voxel_schedule, n_to_reso, cal_n_samples):
    """One package's schedule over the whole run, stepped as its trainer
    steps it (the scalars of iteration i, then after_step(i), then the
    upsample that ends i)."""
    if args.lr_decay_iters > 0:
        lr_factor = args.lr_decay_target_ratio ** (1.0 / args.lr_decay_iters)
    else:
        lr_factor = args.lr_decay_target_ratio ** (1.0 / args.n_iters)
    sched = LrSchedule(lr_init=args.lr_init, lr_basis=args.lr_basis, lr_factor=lr_factor,
                       n_iters=args.n_iters, upsamp_list=list(args.upsamp_list),
                       optimize_poses=bool(args.optimize_poses),
                       optimize_focal=bool(args.optimize_focal_length),
                       lr_upsample_reset=bool(args.lr_upsample_reset),
                       lr_decay_target_ratio=args.lr_decay_target_ratio)
    voxels = n_voxel_schedule(args.N_voxel_init, args.N_voxel_final, len(args.upsamp_list))
    left = list(voxels)
    grids = [n_to_reso(args.N_voxel_init, bbox)]
    scal = np.zeros((args.n_iters, 4))
    events = {"upsample": [], "focal_on": None, "pose_freeze": None}
    for i in range(args.n_iters):
        s = sched.scalars(i)
        scal[i] = [s["lr_spatial"], s["lr_network"], s["lr_pose"], s["lr_focal"]]
        sched.after_step(i)
        if i in args.upsamp_list:
            grids.append(n_to_reso(left.pop(0), bbox))
            sched.on_upsample(i)
            events["upsample"].append(i)
        if events["focal_on"] is None and sched.lr_focal > 0:
            events["focal_on"] = i
        if (events["pose_freeze"] is None and sched.optimize_poses
                and i > args.n_iters // 2 and sched.lr_pose == 0):
            events["pose_freeze"] = i
    samples = [min(args.nSamples, cal_n_samples(g, args.step_ratio)) for g in grids]
    return {"voxels": voxels, "grids": grids, "samples": samples, "scalars": scal,
            "events": events}


@pytest.mark.parametrize("tool,which,n_iters", RECIPES)
def test_schedule_matches_jax(tool, which, n_iters):
    mod = quality_run if tool == "quality_run" else quality_full
    cmd = mod.recipe(which, n_iters)
    assert cmd == _script_cmd(tool, which, n_iters)
    ray_type = which if tool == "quality_run" else "ndc"
    np.testing.assert_array_equal(default_bbox(ray_type), jdefault_bbox(ray_type))
    args, jargs = parse_cmd(cmd), jparse_cmd(cmd)
    ours = _plan(args, default_bbox(ray_type), tsched.LrSchedule, tsched.n_voxel_schedule,
                 tfc.n_to_reso, tfc.cal_n_samples)
    ref = _plan(jargs, jdefault_bbox(ray_type), jsched.LrSchedule, jsched.n_voxel_schedule,
                jfc.n_to_reso, jfc.cal_n_samples)
    for k in ("voxels", "grids", "samples", "events"):
        assert ours[k] == ref[k], k
    assert len(ours["grids"]) == len(args.upsamp_list) + 1
    np.testing.assert_allclose(ours["scalars"], ref["scalars"], rtol=1e-12, atol=0)
    assert ours["events"] == quality_run.expected_events(args)
    if args.optimize_poses:
        assert ours["events"]["pose_freeze"] == n_iters // 2 + 1
        assert ours["events"]["focal_on"] == args.upsamp_list[3]
    else:
        assert ours["events"]["pose_freeze"] is None and ours["events"]["focal_on"] is None
        assert not ours["scalars"][:, 2:].any()


# (b) the recipe narrowed for the CPU: an 8³ -> 16³ grid, 16 samples, 64 rays
NARROW = "--N_voxel_init 512 --N_voxel_final 4096 --nSamples 16 --batch_size 64"
JAX_RUN_KEYS = {"ray_type", "n_iters", "grid_final", "train_psnr_curve", "eval_psnr_mean",
                "eval_ssim_mean", "wall_s", "floor"}  # scripts/quality_run.py:89-98
PORT_RUN_KEYS = {"seed", "n_samples", "ms_per_step_median", "ms_per_step_by_grid", "peak_gib",
                 "events", "events_expected", "launches", "jax", "card"}


def test_phase_15_rehearsal(tmp_path, monkeypatch):
    import chip_smoke as cs

    records = []
    real_run = quality_run.run

    def spy(*a, **k):
        records.append(real_run(*a, **k))
        return records[-1]

    monkeypatch.setattr(quality_run, "run", spy)
    monkeypatch.setattr(cs, "KERNELS", ())  # no kernel launches on the CPU
    scene = make_synthetic_scene(T=4, H=24, W=32, ray_type="ndc")
    with torch_threads(2):
        rec, info = cs.drive_quality("cpu", device="cpu", scene=scene, n_iters=12, extra=NARROW,
                                     export_dim=16)
    (run,) = records
    assert JAX_RUN_KEYS | PORT_RUN_KEYS <= set(run)
    assert run["events"] == {"upsample": [2, 4, 6, 8], "focal_on": 8, "pose_freeze": 7}
    assert run["events_expected"] == run["events"]
    assert len(run["train_psnr_curve"]) == 12 and run["grid_final"] == [17, 19, 11]
    assert all(np.isfinite(list(run["final_metrics"].values())))
    assert run["launches"] == {"coalesce_table_grad": 0, "segment_rows_sum_factored": 0}
    assert info["launches"] == {"coalesce": 0, "segsum": 0} and rec["path"] == "quality"
    assert run["jax"]["eval_psnr"] == 36.98 and run["card"] is None
    assert 0.0 < info["mask_occupancy"] <= 1.0
    assert info["card_vs_cpu"]["differ_off_threshold"] == 0
    json.dumps(info)  # the `quality` line


def test_tools_refuse_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for main in (quality_run.main, quality_full.main, export_alpha.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--out", str(tmp_path)] if main is not export_alpha.main else ["x.npz"])


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A TINY checkpoint written by the JAX trainer (its initial fields)."""
    from rodynrf_tpu.train import Trainer as JTrainer
    from rodynrf_tpu.train.checkpoints import save_checkpoint as jsave

    args = jparse_cmd(jtiny_cmd("ndc", 1))
    tr = JTrainer(args, jtiny_scene("ndc"))
    path = str(tmp_path_factory.mktemp("jax_ckpt") / "ckpt.npz")
    jsave(path, tr.params, tr.static_cfg, tr.dynamic_cfg, np.asarray(tr.aabb),
          extra={"n_iters": 0, "run": "tiny", "n_frames": tr.scene.n_frames})
    return path


@pytest.mark.parametrize("thres", [1e-4, 0.04])
def test_export_alpha_matches_jax(jax_checkpoint, tmp_path, thres):
    from rodynrf_tpu.fields.alpha_mask import dual_dense_alpha, pack_alpha, update_alpha_mask
    from rodynrf_tpu.train.checkpoints import load_checkpoint as jload

    out = str(tmp_path / "port.npz")
    with torch_threads(2):
        rec = export_alpha.main([jax_checkpoint, out, "192", str(thres)], device="cpu")
        alpha, _, _ = export_alpha.checkpoint_alpha(jax_checkpoint, 192, "cpu")

    # the JAX script's steps (scripts/export_alpha.py), on the same weights
    params, static_cfg, dynamic_cfg, aabb, extra = jload(jax_checkpoint)
    gs = [min(int(g), 192) for g in dynamic_cfg.grid_size]
    jalpha = dual_dense_alpha(params, static_cfg, dynamic_cfg, aabb,
                              np.linspace(-1.0, 1.0, int(extra["n_frames"])), gs)
    mask, new_aabb = update_alpha_mask(jnp.asarray(jalpha), aabb, thres)
    occ = float(np.asarray(mask.alpha_volume).mean())
    ref = str(tmp_path / "jax.npz")
    np.savez_compressed(ref, **{k.replace(".", "_"): v for k, v in pack_alpha(mask).items()},
                        occupancy=np.float32(occ),
                        meta=json.dumps({"ckpt": "ckpt.npz", "grid": gs, "thres": thres}))

    with np.load(out) as a, np.load(ref) as b:
        assert sorted(a.files) == sorted(b.files)
        np.testing.assert_array_equal(a["alphaMask_shape"], b["alphaMask_shape"])
        np.testing.assert_array_equal(a["alphaMask_aabb"], b["alphaMask_aabb"])
        assert abs(float(a["occupancy"]) - float(b["occupancy"])) <= 1e-6
        assert json.loads(str(a["meta"])) == json.loads(str(b["meta"]))
    assert rec["grid"] == gs and abs(rec["occupancy"] - round(occ, 4)) <= 1e-6
    np.testing.assert_allclose(rec["new_aabb"], np.asarray(new_aabb), rtol=0, atol=1e-6)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(jalpha), rtol=0, atol=1e-5)
    pooled = export_alpha.pooled_alpha(torch.from_numpy(np.asarray(jalpha))).numpy()
    cmp = export_alpha.compare_masks(out, ref, pooled, thres, 1e-5)
    assert cmp["differ_off_threshold"] == 0 and cmp["aabb_equal"]
    assert 0.0 < occ <= 1.0


# (d) gt_poses_compact at TINY: a 32³ grid (upsamples to the same grid), 64
# rays, the quantile of test_torch_compact_train.py and its threshold raised
# further (at the recipe's 16/48-component widths 0.04 leaves every ray's
# samples occupied; 0.07 leaves ~1% of the volume and the flat bucket on)
TINY_COMPACT = ("--N_voxel_init 32768 --N_voxel_final 32768 --nSamples 64 --batch_size 64"
                " --alpha_mask_thre 0.07 --compact_quantile 0.5")
FULL_ITERS = 8  # upsamples at 1, masks after 2 and 4


def _params_equal(a: str, b: str):
    pa, *_, ea, ma = load_checkpoint(a, return_alpha=True)
    pb, *_, eb, mb = load_checkpoint(b, return_alpha=True)
    fa = {k: np.asarray(v) for k, v in _flat(pa)}
    fb = {k: np.asarray(v) for k, v in _flat(pb)}
    assert fa.keys() == fb.keys()
    for k in fa:
        np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)
    assert ea == eb
    np.testing.assert_array_equal(ma.alpha_volume.numpy(), mb.alpha_volume.numpy())


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_quality_full_resume_is_exact(tmp_path):
    scene = make_synthetic_scene(T=4, H=16, W=16)
    kw = dict(scene=scene, device="cpu", extra=TINY_COMPACT, log=lambda *a: None)
    with torch_threads(2):
        # the straight run also writes its full state every 3 iterations:
        # saving must leave the trajectory as it is
        straight = quality_full.run("gt_poses_compact", FULL_ITERS, out=tmp_path / "a",
                                    save_every=3, **kw)
        part = quality_full.run("gt_poses_compact", FULL_ITERS, out=tmp_path / "b",
                                stop_at=FULL_ITERS // 2, **kw)
        resumed = quality_full.run("gt_poses_compact", FULL_ITERS, out=tmp_path / "b",
                                   resume=True, **kw)
    assert part["stopped_at"] == 4 and part["iteration"] == 4
    assert resumed["resumed_at"] == [4] and straight["resumed_at"] == []
    assert [m[0] for m in straight["alpha_masks"]] == [2, 4]
    assert straight["compact_k"] > 0 and straight["compact_flat"] > 0
    assert straight["mask_occupancy"] is not None
    for k in ("psnr_curve", "eval_psnrs", "events", "alpha_masks", "compact_k", "compact_flat",
              "mask_occupancy", "grid_final", "launches"):
        assert resumed[k] == straight[k], k
    assert straight["events"] == straight["events_expected"] == {
        "upsample": [1], "focal_on": None, "pose_freeze": None}
    _params_equal(straight["ckpt"], resumed["ckpt"])
    for name in ("strip_rgb.png", "strip_depth.png", "strip_dynamicness.png"):
        assert (Path(straight["ckpt"]).parent / name).stat().st_size > 0
    book = json.loads((tmp_path / "b" / "quality_full.json").read_text())
    assert book["gt_poses_compact"]["eval_psnrs"] == straight["eval_psnrs"]
    *_, extra = load_checkpoint(str(tmp_path / "a" / "gt_poses_compact" / "full.npz"))
    assert extra["iteration"] == 6 and extra["full_state"]
