"""The port's LPIPS network (rodynrf_tpu_torch/eval/lpips.py) against the
JAX package's `lpips` (rodynrf_tpu/eval/lpips_jax.py), on the CPU.

No LPIPS weights are in the repository, so both run seeded random weights:
- JAX `init_lpips_params` carried to the port by `lpips_state_from_jax`,
  and a torch dump in the `lpips` package's layout (scaling layer, the
  backbone slices at torchvision's indices, the `lin{k}` heads) loaded by
  the port strictly and by the JAX package's `convert_lpips_state_dict`:
  alex at 64×80 (two pairs) and vgg at 48×64 (one pair) agree to 1e-5
  relative (f32 convolutions in another order);
- the distance of an image to itself is 0;
- `rgb_lpips` scores with $LPIPS_WEIGHTS_ALEX on device="cpu" as the JAX
  package's does, accepts a full `lpips.LPIPS().state_dict()` dump (its
  `lins.{k}` copies included), and refuses without a card when weights are
  given and no device is passed.
"""

import numpy as np
import pytest
import torch

import jax
from rodynrf_tpu.eval import metrics as jmetrics
from rodynrf_tpu.eval.lpips_jax import PLANS, convert_lpips_state_dict, init_lpips_params
from rodynrf_tpu.eval.lpips_jax import lpips as jlpips
from rodynrf_tpu_torch.eval import metrics
from rodynrf_tpu_torch.eval.lpips import LPIPS, _SLICES
from rodynrf_tpu_torch.testing import torch_threads
from rodynrf_tpu_torch.train.convert import lpips_state_from_jax

RTOL = 1e-5
CASES = {"alex": ((64, 80), 2), "vgg": ((48, 64), 1)}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(autouse=True)
def no_weights_env(monkeypatch):
    for k in ("LPIPS_WEIGHTS_ALEX", "LPIPS_WEIGHTS_VGG", "LPIPS_WEIGHTS_DIR"):
        monkeypatch.delenv(k, raising=False)


def random_lpips_dump(net, seed=0):
    """Random weights in the `lpips` layout (torch tensors), as
    tests/test_lpips.py writes them."""
    g = torch.Generator().manual_seed(seed)
    plan, taps = PLANS[net]
    sd = {"scaling_layer.shift": torch.tensor([-0.030, -0.088, -0.188]).view(1, 3, 1, 1),
          "scaling_layer.scale": torch.tensor([0.458, 0.448, 0.450]).view(1, 3, 1, 1)}
    convs = [(s, i) for s, idxs in enumerate(_SLICES[net], 1) for i in idxs]
    for (s, i), (k, _, _, cin, cout, _) in zip(convs, plan):
        bound = 1.0 / np.sqrt(k * k * cin)
        sd[f"net.slice{s}.{i}.weight"] = torch.empty(cout, cin, k, k).uniform_(-bound, bound,
                                                                               generator=g)
        sd[f"net.slice{s}.{i}.bias"] = torch.empty(cout).uniform_(-bound, bound, generator=g)
    for li, t in enumerate(taps):
        sd[f"lin{li}.model.1.weight"] = torch.empty(1, plan[t][4], 1, 1).uniform_(0.0, 0.1,
                                                                                  generator=g)
    return sd


def _pair(net, seed=4):
    (H, W), n = CASES[net]
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (n, H, W, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


def _port(model, a, b):
    with torch.no_grad():
        return model(torch.from_numpy(a.transpose(0, 3, 1, 2)),
                     torch.from_numpy(b.transpose(0, 3, 1, 2))).numpy()


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_matches_jax_on_carried_weights(net):
    params = jax.tree_util.tree_map(np.asarray, init_lpips_params(jax.random.PRNGKey(0), net))
    model = LPIPS(net)
    model.load_state_dict(lpips_state_from_jax(params, net), strict=True)
    a, b = _pair(net)
    ref = np.asarray(jlpips(params, a, b, net))
    ours = _port(model, a, b)
    print(f"{net}: port {ours}, JAX {ref}")
    assert (ref > 0).all()
    np.testing.assert_allclose(ours, ref, rtol=RTOL, atol=0)


@pytest.mark.parametrize("net", ["alex", "vgg"])
def test_lpips_dump_loads_strictly_and_matches_jax(net, tmp_path):
    sd = random_lpips_dump(net)
    torch.save(sd, tmp_path / "dump.pth")
    model = LPIPS(net)
    model.load_state_dict(torch.load(tmp_path / "dump.pth"), strict=True)
    assert set(model.state_dict()) == set(sd)
    params = convert_lpips_state_dict({k: v.numpy() for k, v in sd.items()}, net)
    a, b = _pair(net, seed=5)
    np.testing.assert_allclose(_port(model, a, b), np.asarray(jlpips(params, a, b, net)),
                               rtol=RTOL, atol=0)
    # the carrier back: the JAX tree of the dump gives the dump's tensors
    back = lpips_state_from_jax(jax.tree_util.tree_map(np.asarray, params), net)
    assert set(back) == set(sd) and all(torch.equal(back[k], sd[k]) for k in sd)


def test_lpips_identity_is_zero():
    model = LPIPS("alex")
    model.load_state_dict(random_lpips_dump("alex"), strict=True)
    a, _ = _pair("alex")
    assert float(np.abs(_port(model, a, a)).max()) == 0.0


def test_rgb_lpips_with_weights_on_the_cpu(tmp_path, monkeypatch):
    sd = random_lpips_dump("alex")
    path = tmp_path / "lpips_alex.pth"
    torch.save(sd, path)
    monkeypatch.setenv("LPIPS_WEIGHTS_ALEX", str(path))
    rng = np.random.default_rng(7)
    gt = rng.uniform(0, 1, (32, 40, 3)).astype(np.float32)
    im = rng.uniform(0, 1, (32, 40, 3)).astype(np.float32)
    ours = metrics.rgb_lpips(gt, im, "alex", device="cpu")
    jmetrics._LPIPS_CACHE.clear()
    try:
        ref = jmetrics.rgb_lpips(gt, im, "alex")
    finally:
        jmetrics._LPIPS_CACHE.clear()
    assert ours is not None and np.isfinite(ours) and ours > 0
    np.testing.assert_allclose(ours, ref, rtol=RTOL)
    assert metrics.rgb_lpips(gt, im, "vgg", device="cpu") is None  # no vgg weights

    # a full lpips.LPIPS().state_dict() also holds each head as lins.{k}
    full = dict(sd, **{f"lins.{k[3]}{k[4:]}": v for k, v in sd.items() if k.startswith("lin")})
    torch.save(full, tmp_path / "full.pth")
    monkeypatch.setenv("LPIPS_WEIGHTS_ALEX", str(tmp_path / "full.pth"))
    assert metrics.rgb_lpips(gt, im, "alex", device="cpu") == ours


def test_rgb_lpips_refuses_without_a_card(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    torch.save(random_lpips_dump("alex"), tmp_path / "lpips_alex.pth")
    monkeypatch.setenv("LPIPS_WEIGHTS_DIR", str(tmp_path))
    img = np.zeros((16, 16, 3), np.float32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        metrics.rgb_lpips(img, img, "alex")
