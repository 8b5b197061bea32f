"""`--shard_grids 1` on 2 gloo ranks against the replicated run on 2 ranks
(tests/torch_parallel_ranks.shard_grids_run), f32 strided TINY trainers
from the same seed, through `Trainer.run_step`:

- the plane grids are sharded at rest: each rank holds 1/2 of the axis
  `grid_sharded` chose, and so do its Adam moments (checked on every rank,
  before and after the upsample);
- the losses, the whole gradients and the whole parameters agree after 2
  Adam steps, after the step that ends in the first upsample and after one
  more step (an average by reduce-scatter on two ranks adds the same two
  numbers as an all-reduce, and Adam is elementwise: bit for bit);
- the checkpoint `save_full` writes is byte for byte the replicated run's,
  and a run resumed from it, sharded again, continues with the loss of the
  run that went on.
"""

import numpy as np
import pytest

from rodynrf_tpu_torch.parallel.launch import run_ranks
from rodynrf_tpu_torch.testing import torch_threads
from torch_parallel_ranks import shard_grids_run


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return run_ranks(shard_grids_run, 2, "cpu", (str(tmp_path_factory.mktemp("shard")),))


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def test_planes_are_sharded_at_rest(runs):
    rep, sh = runs["replicated"], runs["sharded"]
    assert rep["dims"] == [] and rep["resumed_dims"] == []
    assert sh["dims"] and all(dim in (0, 1, 2) for _, dim in sh["dims"])
    assert all("plane" in str(path) for path, _ in sh["dims"])
    assert sh["resumed_dims"]


@pytest.mark.parametrize("what", ["losses", "grads", "params"])
def test_sharded_run_equals_replicated(runs, what):
    rep, sh = runs["replicated"], runs["sharded"]
    assert len(rep[what]) == len(sh[what]) == 4
    if what == "losses":
        assert all(np.isfinite(rep[what]))
        assert rep[what] == sh[what]
        return
    for step, (a, b) in enumerate(zip(rep[what], sh[what])):
        a, b = dict(_leaves(a)), dict(_leaves(b))
        assert set(a) == set(b)
        for path in a:
            np.testing.assert_array_equal(b[path], a[path], err_msg=f"{what} {path} step {step}")


def test_checkpoint_bytes_and_resume(runs):
    rep, sh = runs["replicated"], runs["sharded"]
    assert sh["ckpt"] == rep["ckpt"]
    for r in (rep, sh):
        assert r["resumed_loss"] == r["continued_loss"]
    assert sh["continued_loss"] == rep["continued_loss"]
