"""Data-parallel training through the port's command line on the CPU:
`cli.main([... "--n_devices", "2"], device="cpu")` spawns two gloo ranks
(parallel/launch.py) that train golden/tiny.txt on the committed fixture
for 4 iterations; rank 0 saves, evaluates and reports.

- It trains and writes what one process writes, with the same losses (to
  1e-5 relative: float32 gradient sums taken in another order) and the
  same checkpoint parameters to 1e-4 of each leaf's scale (Adam divides
  each gradient element by its own running magnitude, so an element whose
  gradient is near 0 carries the reordering into its update: 2.4e-5 of
  scale on a density plane after 4 steps). The bytes are
  not the same: the run is float32 (the CLI has no float64 mode) and the
  two ranks' gradients reach the parameters through another summation
  order; tests/test_torch_parallel.py holds the step to one process in
  float64 at 1e-10.
- With `--shard_grids 1` the checkpoint is byte for byte the replicated
  2-rank run's.
- With bf16 merged tables (the default path's dynamic field) each rank
  rounds its table gradient to bf16 before the average, where one process
  rounds the sum once (test_torch_parallel.py holds the step to
  test_torch_step_merged.py's bf16 bounds). The first loss, before any
  update, is one process's; later ones part from it by ~1e-4 as Adam's
  updates follow the gradients' signs, where float32 stays within 1e-5
  (printed with -s; chip_smoke.py phase 13c reads both paths on the cards).
"""

import os
import shutil

import numpy as np
import pytest

from rodynrf_tpu_torch.cli import main
from rodynrf_tpu_torch.testing import torch_threads

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
FIXTURE = os.path.join(REPO, "golden", "out", "fixture")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cli_parallel")
    shutil.copytree(FIXTURE, tmp / "data")
    out = {}
    bf16 = ("--bf16", "1", "--vm_layout", "merged")
    for name, extra in (("one", ("--n_devices", "1")), ("two", ("--n_devices", "2")),
                        ("sharded", ("--n_devices", "2", "--shard_grids", "1")),
                        ("one_bf16", ("--n_devices", "1", *bf16)),
                        ("two_bf16", ("--n_devices", "2", *bf16))):
        argv = ["--config", os.path.join(REPO, "golden", "tiny.txt"),
                "--datadir", str(tmp / "data"), "--basedir", str(tmp / "log"),
                "--n_iters", "4", "--progress_refresh_rate", "1", "--no_tensorboard", "1",
                "--expname", name, *extra]
        rep = main(argv, device="cpu")
        with np.load(rep["ckpt"]) as z:
            params = {k: z[k] for k in z.files if k != "__meta__"}
        with open(rep["ckpt"], "rb") as f:
            out[name] = dict(rep=rep, params=params, bytes=f.read())
    return out


def test_two_ranks_train_like_one_process(runs):
    one, two = runs["one"], runs["two"]
    assert one["rep"]["n_devices"] == 1 and two["rep"]["n_devices"] == 2
    assert len(two["rep"]["losses"]) == 4 and all(np.isfinite(two["rep"]["losses"]))
    np.testing.assert_allclose(two["rep"]["losses"], one["rep"]["losses"], rtol=1e-5)
    assert len(two["rep"]["psnrs"]) == 4 and all(np.isfinite(two["rep"]["psnrs"]))
    assert set(one["params"]) == set(two["params"])
    for k, ref in one["params"].items():
        scale = max(float(np.abs(ref).max()), 1e-30)
        assert float(np.abs(two["params"][k] - ref).max()) / scale <= 1e-4, k
    exp = os.path.dirname(two["rep"]["ckpt"])
    assert os.path.isfile(os.path.join(exp, "imgs_test_all", "mean.txt"))


def test_sharded_grids_write_the_replicated_checkpoint(runs):
    two, sharded = runs["two"], runs["sharded"]
    assert sharded["rep"]["n_devices"] == 2
    assert sharded["rep"]["losses"] == two["rep"]["losses"]
    assert sharded["bytes"] == two["bytes"]


def _loss_rel(a, b):
    return [abs(x - y) / abs(x) for x, y in zip(a["rep"]["losses"], b["rep"]["losses"])]


def test_bf16_merged_ranks_agree_before_the_first_update(runs):
    one, two = runs["one_bf16"], runs["two_bf16"]
    rel, rel_f32 = _loss_rel(one, two), _loss_rel(runs["one"], runs["two"])
    print(f"2 ranks against one process, loss by step: bf16 merged {rel}, float32 {rel_f32}")
    assert len(rel) == 4 and all(np.isfinite(two["rep"]["losses"]))
    assert rel[0] <= 1e-6
