"""`correct` on tiny copies of the cells, on the CPU: a sound run of the
program is correct, and the lower-precision control and each fault a cell
can have are not (the exchange between chips is absent: every cell runs on
one chip). -s prints the readings."""

import time

import pytest

from portbench.lib import compare, controls
from portbench.lib.harness import execute
from portbench.lib.spec import load_cell

SEED = 3000000011
TRAIN = ["tiny.nvidia_no_poses.train", "tiny.davis.train"]
RENDER = ["tiny.nvidia_no_poses.render", "tiny.davis.render"]


def _run(root, cell):
    res, checks, _ = execute(cell, SEED, 0.1, False, "cpu", time.perf_counter(), root=root)
    print(cell, {k: v[0] for k, v in checks.items()})
    return res


@pytest.mark.parametrize("cell", TRAIN + RENDER)
def test_sound_run_is_correct(tiny_root, cell):
    res = _run(tiny_root, cell)
    assert res["correct"] and res["failed"] == 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell", TRAIN + RENDER)
def test_tf32_control_is_not_correct(tiny_root, cell):
    c = load_cell(cell, tiny_root)
    nums = (controls.control_train(c, SEED, "cpu") if c.traffic["loop"] == "train"
            else controls.control_render(c, SEED, "cpu"))
    print(cell, "control", nums)
    assert not compare.judge(nums, c.limits)


@pytest.mark.parametrize("cell", TRAIN)
def test_half_batch_fault_is_not_correct(tiny_root, cell):
    c = load_cell(cell, tiny_root)
    nums = controls.control_train(c, SEED, "cpu", keep=0.5, matmul="float32")
    print(cell, "half batch", nums)
    assert not compare.judge(nums, c.limits)


def _state_unchanged(monkeypatch):
    import rodynrf_tpu_torch.train.step as step

    monkeypatch.setattr(step, "apply_updates", lambda params, opt_state, sc: None)


def _half_batch(monkeypatch):
    import rodynrf_tpu_torch.train.step as step

    orig = step.TrainStep.grads_and_metrics

    def half(self, params, aabb, data, ray_idx, ray_idx_rand, gen, sc):
        n = ray_idx.shape[0] // 2
        return orig(self, params, aabb, data, ray_idx[:n], ray_idx_rand[:n], gen, sc)

    monkeypatch.setattr(step.TrainStep, "grads_and_metrics", half)


def _loss_altered(monkeypatch):
    import rodynrf_tpu_torch.train.step as step

    orig = step.train_loss

    def altered(*a, **k):
        total, metrics = orig(*a, **k)
        metrics["total_loss"] = metrics["total_loss"] * (1 + 1e-4)
        return total, metrics

    monkeypatch.setattr(step, "train_loss", altered)


def _frame_altered(monkeypatch):
    import rodynrf_tpu_torch.render.renderer as R

    orig = R.render_image
    count = {"n": 0}

    def altered(*a, **k):
        maps = orig(*a, **k)
        count["n"] += 1
        if count["n"] == 2:  # the first frame of the window
            maps["rgb"] = maps["rgb"] + 1e-3
        return maps

    monkeypatch.setattr(R, "render_image", altered)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _loss_altered])
@pytest.mark.parametrize("cell", TRAIN)
def test_train_fault_is_not_correct(tiny_root, cell, fault, monkeypatch):
    fault(monkeypatch)
    res = _run(tiny_root, cell)
    assert not res["correct"] and res["failed"] > 0


@pytest.mark.parametrize("cell", RENDER)
def test_render_fault_is_not_correct(tiny_root, cell, monkeypatch):
    _frame_altered(monkeypatch)
    res = _run(tiny_root, cell)
    assert not res["correct"]
