"""The golden contract (GOLDEN.md §1-§4) on the port: the committed
recordings of the actual PyTorch reference (golden/out/) replayed through
rodynrf_tpu_torch, on the CPU. JAX-free, like the port.

- The 15-iteration trajectory of golden/tiny.txt on the committed fixture,
  from the reference's initial fields, on its recorded ray streams, with the
  stochastic draws pinned (golden_det): the 19 loss tags of
  tests/test_golden.py within 5e-3 relative of the reference's per
  iteration (measured worst ~7e-6).
- The first-step gradients of all 72 parameter tensors against the
  reference's backward (grads_ref.npz) within 1e-3 relative to each
  tensor's scale; the worst is printed (measured 5.5e-06 on the CPU, the
  JAX package's 2.34e-05, GOLDEN.md §4).
- The reference's final .th pair rendered by the port against the
  reference's own evaluation PNGs: >= 50 dB per frame (measured 52.89).
- The evaluation of that .th pair through `--render_only` scores the
  reference's own mean.txt PSNR (15.890) within 0.01 dB.
"""

import json
import os

import numpy as np
import pytest
import torch

from rodynrf_tpu_torch.cli import _load_reference_th_pair, main
from rodynrf_tpu_torch.data.imageio import read_png
from rodynrf_tpu_torch.eval.metrics import psnr
from rodynrf_tpu_torch.render.renderer import make_chunk_renderer, render_image
from rodynrf_tpu_torch.testing import golden_trainer, torch_threads
from rodynrf_tpu_torch.train.checkpoints import dynamic_state_dict, static_state_dict
from rodynrf_tpu_torch.train.convert import params_from_numpy

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
OUT = os.path.join(REPO, "golden", "out")
EXP = os.path.join(OUT, "ref_log", "golden_tiny")

pytestmark = pytest.mark.integration

# the trajectory tags of tests/test_golden.py (port metric -> reference tag)
CHECK_TAGS = {
    "mse": "train/mse",
    "psnr": "train/PSNR",
    "img_d_loss": "train/img_d_loss",
    "img_s_loss": "train/img_s_loss",
    "order_loss": "train/order_loss",
    "novel_order_loss": "train/novel_order_loss",
    "flow_f_loss": "train/flow_f_loss",
    "flow_b_loss": "train/flow_b_loss",
    "disp_f_loss": "train/disp_f_loss",
    "disp_b_loss": "train/disp_b_loss",
    "flow_f_s_loss": "train/flow_f_s_loss",
    "disp_b_s_loss": "train/disp_b_s_loss",
    "small_scene_flow_loss": "train/small_scene_flow_loss",
    "smooth_scene_flow_loss": "train/smooth_scene_flow_loss",
    "total_mono_depth_loss_dynamic": "train/total_mono_depth_loss_dynamic",
    "total_mono_depth_loss_static": "train/total_mono_depth_loss_static",
    "loss_distortion": "train/loss_distortion",
    "loss_distortion_static": "train/loss_distortion_static",
    "disp_smooth_loss": "train/disp_smooth_loss",
}

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def record():
    return np.load(os.path.join(OUT, "ref_record.npz"))


def test_trajectory_replay_matches_reference(record):
    trainer, _ = golden_trainer(REPO)
    trainer.sampler_override = lambda i: (record["ray_idx"][i], record["ray_idx_rand"][i])
    ref = json.load(open(os.path.join(OUT, "ref_scalars.json")))
    n, worst = 15, 0.0
    ours = {k: [] for k in CHECK_TAGS}
    for _ in range(n):
        metrics = trainer.run_step()
        for k in CHECK_TAGS:
            ours[k].append(float(metrics[k]))
    assert len(CHECK_TAGS) == 19
    for k, tag in CHECK_TAGS.items():
        ref_vals = dict((int(s), v) for s, v in ref[tag])
        for i in range(n):
            r, o = ref_vals[i], ours[k][i]
            rel = abs(r - o) / max(abs(r), abs(o), 1e-6)
            worst = max(worst, rel)
            assert rel < 5e-3, f"{tag} diverged at iter {i}: ref {r} vs ours {o}"
    print(f"worst trajectory relative error over {n} iterations: {worst:.3e}")


def test_first_step_gradients_match_reference(record):
    trainer, _ = golden_trainer(REPO)
    sc = {"iteration": 0, "focal_fixed": trainer.focal_fixed, **trainer.schedule.scalars(0)}
    grads, _ = trainer.step_fn.grads_and_metrics(
        trainer.params, trainer.aabb, trainer.data, torch.as_tensor(record["ray_idx"][0]),
        torch.as_tensor(record["ray_idx_rand"][0]), trainer.gen, sc)
    ours = {f"static/{k}": v for k, v in static_state_dict(grads["static"],
                                                           trainer.static_cfg).items()}
    ours.update({f"dynamic/{k}": v for k, v in dynamic_state_dict(grads["dynamic"],
                                                                   trainer.dynamic_cfg).items()})
    ours["pose"] = grads["pose"].numpy()
    ours["fov"] = grads["fov"].numpy()
    ref = np.load(os.path.join(OUT, "grads_ref.npz"))
    assert len(ref.files) == 72
    rel = {}
    for name in ref.files:
        assert name in ours, f"missing gradient {name}"
        r, o = ref[name], ours[name]
        assert r.shape == o.shape, name
        rel[name] = float(np.abs(r - o).max() / (np.abs(r).max() + 1e-12))
    worst = max(rel, key=rel.get)
    print(f"worst first-step gradient relative error: {rel[worst]:.3e} ({worst})")
    assert rel[worst] < 1e-3, f"gradient mismatch {worst}: rel {rel[worst]:.2e}"


def test_th_render_matches_reference_pngs():
    params, st, dy, aabb, poses, focal, alpha = _load_reference_th_pair(
        os.path.join(EXP, "golden_tiny.th"))
    assert alpha is None
    # the reference's evaluation samples int(diag / step) + 1 points per ray
    render_chunk = make_chunk_renderer(st, dy, "ndc", st.n_samples(aabb), st.step_size(aabb))
    params = params_from_numpy(params, "cpu")
    ts = np.linspace(-1.0, 1.0, 4)
    for i in range(4):
        maps = render_image(render_chunk, params, torch.as_tensor(aabb), poses[i], focal,
                            float(ts[i]), 24, 32, "ndc", chunk=1024)
        ref = read_png(os.path.join(EXP, "imgs_test_all", f"{i:03d}.png")).astype(np.float32)
        p = psnr(maps["rgb"], ref / 255.0)
        print(f"frame {i}: {p:.2f} dB")
        assert p >= 50.0, f"frame {i}: {p:.2f} dB"


def test_th_evaluation_scores_reference_mean(tmp_path):
    rep = main(["--config", os.path.join(REPO, "golden", "tiny.txt"),
                "--datadir", os.path.join(OUT, "fixture"), "--basedir", str(tmp_path),
                "--render_only", "1", "--render_test", "1",
                "--ckpt", os.path.join(EXP, "golden_tiny.th")], device="cpu")
    ref_mean = float(np.loadtxt(os.path.join(EXP, "imgs_test_all", "mean.txt"))[0])
    ours = float(np.loadtxt(tmp_path / "golden_tiny" / "imgs_test_all" / "mean.txt")[0])
    assert abs(ref_mean - 15.890) < 1e-3
    assert abs(float(np.mean(rep["psnrs"])) - ours) < 1e-9
    assert abs(ours - ref_mean) <= 0.01, f"{ours} vs the reference's {ref_mean}"
