"""The preprocessing commands end to end on the CPU, and the port's COLMAP
readers and profiling hooks.

- chip_smoke.py phase 11 at a small size (4 frames of 64×64 written by
  `testing.write_video_scene`, their synthetic flow, disparity and masks
  removed): `python -m rodynrf_tpu_torch.preprocess`'s flow, depth and
  mask mains with device="cpu", from random checkpoints in the official
  layouts (RAFT at a 64 long side, 2 refinements; the narrow DPT), write
  every file the loader reads; load_scene reads them and a step of the
  recipe on them is finite; LMedS accepts an F on the flows; the
  card-vs-CPU comparisons of 11e run (CPU against CPU here), the
  scene-size one on a two-view flow whose moving patch the mask covers.
- Each command refuses without a card unless device="cpu" is passed, and
  `python -m rodynrf_tpu_torch.preprocess` says so; so do the library
  entry points under them (`generate_motion_masks`, `load_raft`,
  `load_dpt`) and `StepTimer`.
- rodynrf_tpu_torch/data/colmap.py reads tests/test_extras.py's synthetic
  sparse model as the JAX package's colmap.py does, and converts it to the
  same transforms and poses_bounds.
- rodynrf_tpu_torch/utils/profiling.py: `trace` writes a Chrome trace that
  holds an `annotate` region, and `StepTimer` reports its statistics.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from rodynrf_tpu.data import colmap as jcolmap
from rodynrf_tpu_torch.data import colmap as pcolmap
from rodynrf_tpu_torch.preprocess import generate_depth, generate_flow, generate_mask
from rodynrf_tpu_torch.testing import torch_threads
from rodynrf_tpu_torch.utils import profiling
from test_extras import _write_fake_colmap

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def test_chip_smoke_preprocess_phase_rehearses_on_the_cpu(monkeypatch):
    import chip_smoke as cs

    for fn in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, fn, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(cs, "CLI_SCENE", dict(T=4, H=64, W=64))
    monkeypatch.setattr(cs, "CLI_VOXELS", "4096")
    monkeypatch.setattr(cs, "CLI_STEPS", 1)
    monkeypatch.setattr(cs, "PRE_LONG_SIDE", 64)
    monkeypatch.setattr(cs, "PRE_ITERS", 2)
    monkeypatch.setattr(cs, "PRE_DPT", cs.NARROW_DPT)
    per_step = {"coalesce": 15, "segsum": 0}
    monkeypatch.setattr(cs, "counters", lambda: {k: v * cs.CLI_STEPS for k, v in per_step.items()})
    rec, info = cs.drive_preprocess("cpu", per_step, device="cpu")
    assert rec["launches"] == per_step
    assert info["flow"]["pairs"] == 3 and info["flow"]["size"] == [64, 64]
    assert info["depth"]["frames"] == 4 and info["depth"]["size"] == [384, 384]
    assert len(info["masks"]["frame_s"]) == 4
    assert info["masks"]["maps"] == 6 and info["masks"]["maps_with_f"] >= 1
    assert all(np.isfinite(info["train"]["losses"]))
    cmp = info["card_vs_cpu"]
    assert cmp["raft_max_epe_px"] == 0.0 and cmp["dpt_max_rel"] == 0.0
    assert cmp["lmeds_mask_agreement"] == 1.0
    full = info["lmeds_full_size"]
    assert full["size"] == [64, 64] and full["f_found"]
    assert full["patch_hit"] >= cs.PATCH_HIT_MIN and full["static_hit"] <= cs.STATIC_HIT_MAX
    json.dumps(info)  # the `preprocess` line


@pytest.mark.parametrize("main", [generate_flow.main, generate_depth.main, generate_mask.main])
def test_commands_refuse_without_a_card(main, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    argv = ["--dataset_path", str(tmp_path)]
    if main is not generate_mask.main:
        argv += ["--model", str(tmp_path / "none.pth")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(argv)
    if main is generate_flow.main:
        out = subprocess.run([sys.executable, "-m", "rodynrf_tpu_torch.preprocess", "flow", *argv],
                             cwd=REPO, capture_output=True, text=True, timeout=300,
                             env=dict(os.environ, PYTHONPATH=REPO))
        assert out.returncode != 0 and "no CUDA device" in out.stderr


@pytest.mark.parametrize("entry", ["generate_motion_masks", "load_raft", "load_dpt",
                                   "StepTimer"])
def test_library_entry_points_refuse_without_a_card(entry, tmp_path):
    from rodynrf_tpu_torch.preprocess import dpt, motion_masks, raft

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    call = {"generate_motion_masks": lambda: motion_masks.generate_motion_masks(str(tmp_path)),
            "load_raft": lambda: raft.load_raft(str(tmp_path / "none.pth")),
            "load_dpt": lambda: dpt.load_dpt(str(tmp_path / "none.pt")),
            "StepTimer": lambda: profiling.StepTimer()}[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


def test_colmap_matches_jax(tmp_path):
    d = str(tmp_path / "sparse")
    _write_fake_colmap(d)
    jm, pm = jcolmap.read_model(d), pcolmap.read_model(d)
    for jpart, ppart in zip(jm, pm):
        assert jpart.keys() == ppart.keys()
        for k in jpart:
            for field, value in vars(jpart[k]).items():
                np.testing.assert_array_equal(np.asarray(vars(ppart[k])[field]), np.asarray(value))
    assert pcolmap.colmap_to_transforms(d) == jcolmap.colmap_to_transforms(d)
    np.testing.assert_array_equal(pcolmap.colmap_to_poses_bounds(d),
                                  jcolmap.colmap_to_poses_bounds(d))
    np.testing.assert_array_equal(pcolmap.qvec2rotmat(np.array([0.5, 0.5, 0.5, 0.5])),
                                  jcolmap.qvec2rotmat(np.array([0.5, 0.5, 0.5, 0.5])))


def test_profiling_on_the_cpu(tmp_path):
    x = torch.randn(64, 64)
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("matmul_region"):
            (x @ x).sum()
    assert "matmul_region" in {e.key for e in prof.key_averages()}
    assert "matmul_region" in (tmp_path / "trace.json").read_text()
    timer = profiling.StepTimer(window=3, device="cpu")
    for _ in range(5):
        with timer:
            (x @ x).sum()
    stats = timer.stats()
    assert len(timer.samples) == 3 and set(stats) == {"mean_ms", "p50_ms", "p95_ms",
                                                      "steps_per_sec"}
