"""The recipe with SfM poses (configs/Nvidia.txt: with_GT_poses 1,
optimize_poses 0, TV 1.0 on density and appearance) in the port, on the CPU
at tiny shapes.

- Its benchmark cell (portbench/workloads/nvidia.train_300.json), cut to a
  tiny grid and scene as portbench/tests/conftest.make_tiny cuts every
  cell, runs through the harness against the plain reference: a sound run
  is `correct`, a run whose optimizers leave the state unchanged is not.
- With the tracer on, a fixed-camera step opens one `train.pass` span for
  each of its five field passes (A-E) and one `train.regularizers` span
  around each field's grid regularizers; a step that optimises the cameras
  opens nine passes. With the tracer off a step records nothing.
"""

import time
from collections import Counter

import pytest
import torch

from rodynrf_tpu_torch.testing import tiny_cmd, tiny_scene, torch_threads
from rodynrf_tpu_torch.train import Trainer, parse_cmd, step
from rodynrf_tpu_torch.utils import profiling as P

SEED = 3000000023
CELL = "tiny.nvidia.train"
# the recipe's own switches over the tiny shapes (the last flag wins)
GT_POSES = " --with_GT_poses 1 --TV_weight_density 1.0 --TV_weight_app 1.0" \
           " --distortion_weight_static 0.0"


@pytest.fixture(autouse=True, scope="module")
def two_torch_threads():
    with torch_threads(2):
        yield


@pytest.fixture(autouse=True)
def tracer_off():
    P.disable()
    P.take()
    yield
    P.disable()
    P.take()


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    from portbench.tests.conftest import make_tiny

    return make_tiny(tmp_path_factory.mktemp("portbench"))


def _execute(root):
    from portbench.lib.harness import execute

    res, checks, _ = execute(CELL, SEED, 0.1, False, "cpu", time.perf_counter(), root=root)
    return res, {k: v[0] for k, v in checks.items()}


@pytest.mark.parametrize("state_unchanged", [False, True], ids=["sound", "state_unchanged"])
def test_the_cell_is_correct_and_an_unchanged_state_is_not(tiny_root, monkeypatch, state_unchanged):
    from portbench.lib.spec import load_cell

    cfg = load_cell(CELL, tiny_root).config
    assert (cfg["recipe"]["with_GT_poses"], cfg["recipe"]["optimize_poses"]) == (1, 0)
    if state_unchanged:
        monkeypatch.setattr(step, "apply_updates", lambda params, opt_state, sc: None)
    res, nums = _execute(tiny_root)
    if state_unchanged:
        assert not res["correct"], nums
        assert nums["change_gap"] == 1.0 and nums["grad_gap"] == 1.0
    else:
        assert res["correct"] and res["failed"] == 0, nums
        assert nums["loss_gap.1"] == 0.0  # the step's first loss bit for bit


def _step_spans(optimize: int, extra: str = ""):
    tr = Trainer(parse_cmd(tiny_cmd("ndc", optimize) + extra), tiny_scene("ndc"), device="cpu")
    P.enable()
    m = tr.run_step()
    P.disable()
    return m, P.take()


def _ancestors(spans, s):
    ids = {x.id: x for x in spans}
    out, p = [], s.parent
    while p is not None:
        out.append(ids[p].name)
        p = ids[p].parent
    return out


def test_a_fixed_camera_step_opens_five_passes_and_a_regularizer_span_a_field():
    m, spans = _step_spans(0, GT_POSES)
    passes = [s for s in spans if s.name == "train.pass"]
    assert sorted(s.attrs["name"] for s in passes) == ["A", "B", "C", "D", "E"]
    for s in passes:
        assert s.attrs == {"name": s.attrs["name"], "grad": s.attrs["name"] == "E"}
        assert _ancestors(spans, s)[:2] == ["train.forward", "train.step"]
    # the fields run inside the passes: E's static evaluation, A's and B's
    # reuse of it, the dynamic field in A-D
    n = Counter(_ancestors(spans, s)[0] for s in spans if s.name.startswith("field."))
    assert n["train.pass"] == sum(1 for s in spans if s.name.startswith("field."))

    # each field's TV (density, the dynamic field's blending, appearance)
    # and L1 terms, the dynamic field's before pass E's losses and the
    # static field's after them, as in the reference's order
    regs = [s for s in spans if s.name == "train.regularizers"]
    assert [s.attrs for s in regs] == [{"field": "dynamic"}, {"field": "static"}]
    for s in regs:
        assert _ancestors(spans, s)[0] == "train.forward"
    assert not {"reg_tv_density", "reg_tv_app_static", "loss_reg_L1_density_s"} - set(m)


def test_a_step_that_optimises_the_cameras_opens_nine_passes():
    _, spans = _step_spans(1)
    names = Counter(s.attrs["name"] for s in spans if s.name == "train.pass")
    assert names == {n: 1 for n in ("A", "B", "C", "D", "E", "F", "G", "FF", "BB")}
    grad = {s.attrs["name"]: s.attrs["grad"] for s in spans if s.name == "train.pass"}
    assert {n for n, g in grad.items() if not g} == {"A", "B", "C", "D"}


def test_with_the_tracer_off_a_step_records_nothing():
    tr = Trainer(parse_cmd(tiny_cmd("ndc", 0) + GT_POSES), tiny_scene("ndc"), device="cpu")
    m = tr.run_step()
    assert torch.isfinite(m["total_loss"])
    assert P.take() == []
