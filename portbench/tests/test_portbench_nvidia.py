"""`correct` on the tiny copy of nvidia.train_300 (tiny.nvidia.train, made
by conftest.make_tiny from the cell's workload file), on the CPU: the
fixed-camera step, five field passes, TV on every table. A sound run is
correct; the TF32 control, the half-batch reference and the program faults
(an unchanged state, half of each batch, an altered loss) are not. -s prints
the readings."""

import pytest
from test_portbench_correct import _half_batch, _loss_altered, _run, _state_unchanged

from portbench.lib import compare, controls
from portbench.lib.spec import load_cell

SEED = 3000000019
CELL = "tiny.nvidia.train"


def test_the_tiny_cell_is_the_fixed_camera_recipe(tiny_root):
    recipe = load_cell(CELL, tiny_root)
    assert recipe.config["recipe"]["with_GT_poses"] == 1
    assert recipe.config["recipe"]["optimize_poses"] == 0
    assert "optimize_focal_length" not in recipe.config["recipe"]
    assert recipe.config["micro_batches"] == 1


def test_sound_run_is_correct(tiny_root):
    res = _run(tiny_root, CELL)
    assert res["correct"] and res["failed"] == 0


@pytest.mark.parametrize("control", ["tf32", "half_batch"])
def test_control_is_not_correct(tiny_root, control):
    c = load_cell(CELL, tiny_root)
    nums = (controls.control_train(c, SEED, "cpu") if control == "tf32"
            else controls.control_train(c, SEED, "cpu", keep=0.5, matmul="float32"))
    print(CELL, control, nums)
    assert not compare.judge(nums, c.limits)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_batch, _loss_altered])
def test_fault_is_not_correct(tiny_root, fault, monkeypatch):
    fault(monkeypatch)
    res = _run(tiny_root, CELL)
    assert not res["correct"] and res["failed"] > 0
