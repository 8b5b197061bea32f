"""The port's RAFT and DPT (rodynrf_tpu_torch/preprocess/{raft,dpt}.py)
against the JAX package's on the same weights, carried across by
rodynrf_tpu_torch/train/convert.py, on the CPU.

- RAFT at 64×80, 2 refinements, against `raft_forward`: max EPE <= 1e-3 px
  (the random weights' ≥2-D tensors halved, as
  tests/test_weight_conversion.py does, so that the GRU stays finite).
  The port's state dict, saved with DataParallel `module.` keys, loads into
  the port (`load_raft`, strict) and through the JAX package's
  `load_raft_torch_checkpoint`, and both give the same flow: a file in the
  official layout is read the same by both packages.
- The narrow DPT of tests/test_preprocess.py:93 at 96×128 and 64×96 (pos-
  embed grids 6×8 and 4×6 resized from 24×24) against `dpt_forward`:
  relative error <= 1e-4 of max|depth|; its state dict, saved with a
  classifier head as the official file has, loads (`load_dpt`, strict
  after dropping the head) and through `load_dpt_torch_checkpoint` to the
  same depth.
- DPT-Large: the keys and shapes the port's module declares equal the JAX
  package's `init_dpt_params` tree through the carrier, compared on the
  meta device (`jax.eval_shape`; nothing of 1.3 GB is allocated).
"""

import jax
import numpy as np
import pytest
import torch

from rodynrf_tpu.preprocess import dpt as jdpt
from rodynrf_tpu.preprocess import raft as jraft
from rodynrf_tpu_torch.preprocess import dpt as pdpt
from rodynrf_tpu_torch.preprocess import raft as praft
from rodynrf_tpu_torch.testing import torch_threads
from rodynrf_tpu_torch.train.convert import dpt_state_from_jax, raft_state_from_jax

NARROW = dict(dim=64, heads=4, blocks=4, hooks=(0, 1, 2, 3), reassemble=(16, 32, 64, 64),
              features=32)  # tests/test_preprocess.py:93
EPE_PX = 1e-3
DPT_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def _numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def raft_pair():
    params = jax.tree_util.tree_map(lambda a: a * 0.5 if a.ndim > 1 else a,
                                    _numpy(jraft.init_raft_params(jax.random.PRNGKey(0))))
    rng = np.random.default_rng(3)
    img1 = rng.uniform(0, 255, (1, 64, 80, 3)).astype(np.float32)
    img2 = np.clip(img1 + rng.normal(0, 8, img1.shape), 0, 255).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, a, b: jraft.raft_forward(p, a, b, iters=2))(
        params, img1, img2))
    return params, img1, img2, ref


def _port_flow(model, img1, img2):
    with torch.inference_mode():
        flow = model(torch.from_numpy(img1).permute(0, 3, 1, 2),
                     torch.from_numpy(img2).permute(0, 3, 1, 2), iters=2)
    return flow.permute(0, 2, 3, 1).numpy()


def test_raft_matches_jax(raft_pair):
    params, img1, img2, ref = raft_pair
    model = praft.RAFT()
    model.load_state_dict(raft_state_from_jax(params), strict=True)
    got = _port_flow(model, img1, img2)
    assert np.isfinite(ref).all() and np.abs(ref).max() > 0
    assert np.linalg.norm(got - ref, axis=-1).max() <= EPE_PX


def test_raft_checkpoint_loads_in_both_packages(raft_pair, tmp_path):
    params, img1, img2, _ = raft_pair
    model = praft.RAFT()
    model.load_state_dict(raft_state_from_jax(params), strict=True)
    path = str(tmp_path / "raft.pth")
    torch.save({"module." + k: v for k, v in model.state_dict().items()}, path)
    port = _port_flow(praft.load_raft(path, "cpu"), img1, img2)
    jax_params = jraft.load_raft_torch_checkpoint(path)
    ref = np.asarray(jax.jit(lambda p, a, b: jraft.raft_forward(p, a, b, iters=2))(
        jax_params, img1, img2))
    np.testing.assert_array_equal(port, _port_flow(model, img1, img2))
    assert np.linalg.norm(port - ref, axis=-1).max() <= EPE_PX


@pytest.fixture(scope="module")
def narrow_dpt():
    jcfg, pcfg = jdpt.DPTConfig(**NARROW), pdpt.DPTConfig(**NARROW)
    params = _numpy(jdpt.init_dpt_params(jax.random.PRNGKey(0), jcfg))
    model = pdpt.DPTDepthModel(pcfg)
    model.load_state_dict(dpt_state_from_jax(params, pcfg), strict=True)
    return params, jcfg, model


def _port_depth(model, img):
    with torch.inference_mode():
        return model(torch.from_numpy(img).permute(0, 3, 1, 2)).numpy()


@pytest.mark.parametrize("hw", [(96, 128), (64, 96)])
def test_dpt_matches_jax(narrow_dpt, hw, tmp_path):
    params, jcfg, model = narrow_dpt
    img = np.random.default_rng(hw[1]).uniform(0, 1, (1, *hw, 3)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, x: jdpt.dpt_forward(p, x, jcfg))(params, img))
    got = _port_depth(model, img)
    assert got.shape == ref.shape == (1, *hw) and np.isfinite(ref).all()
    assert np.abs(got - ref).max() <= DPT_RTOL * np.abs(ref).max()
    if hw == (96, 128):  # the official layout, classifier included, read by both packages
        sd = dict(model.state_dict())
        sd["pretrained.model.head.weight"] = torch.zeros(1000, NARROW["dim"])
        sd["pretrained.model.head.bias"] = torch.zeros(1000)
        path = str(tmp_path / "dpt.pt")
        torch.save(sd, path)
        np.testing.assert_array_equal(
            _port_depth(pdpt.load_dpt(path, "cpu", model.cfg), img), got)
        jax_params = _load_dpt_subset(path, jcfg)
        again = np.asarray(jax.jit(lambda p, x: jdpt.dpt_forward(p, x, jcfg))(jax_params, img))
        np.testing.assert_array_equal(again, ref)


def _load_dpt_subset(path, jcfg):
    """load_dpt_torch_checkpoint reads DPT-Large's 24 blocks; a narrow file
    has `jcfg.blocks`, so its block loop is bounded for the read."""
    saved = jdpt.VIT_BLOCKS
    jdpt.VIT_BLOCKS = jcfg.blocks
    try:
        return jdpt.load_dpt_torch_checkpoint(path)
    finally:
        jdpt.VIT_BLOCKS = saved


def test_dpt_large_declares_the_jax_tree():
    shapes = jax.eval_shape(lambda k: jdpt.init_dpt_params(k, jdpt.DPT_LARGE),
                            jax.random.PRNGKey(0))
    meta = jax.tree_util.tree_map(lambda s: torch.empty(s.shape, device="meta"), shapes)
    carried = dpt_state_from_jax(meta, pdpt.DPT_LARGE)
    with torch.device("meta"):
        model = pdpt.DPTDepthModel(pdpt.DPT_LARGE)
    declared = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert declared == {k: tuple(v.shape) for k, v in carried.items()}
    # ViT 4 + 12 per block + final norm 2, reassemble 22, scratch 4 + 4 x 10 + 6
    assert len(declared) == 4 + 12 * 24 + 2 + 22 + 4 + 4 * 10 + 6
    n = sum(int(np.prod(s)) for s in declared.values())
    assert 340e6 < n < 345e6  # ViT-L/16 with DPT's reassemble, fusion and head
