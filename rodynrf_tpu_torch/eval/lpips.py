"""The LPIPS perceptual distance, AlexNet and VGG16 backbones (port of
rodynrf_tpu/eval/lpips_jax.py; Zhang et al. 2018, version 0.1; the
reference scores it through the `lpips` package, utils.py:68-84).

`LPIPS(net)` names its tensors as `lpips.LPIPS(net=...).state_dict()` does:
`scaling_layer.shift/scale` (buffers), `net.slice{s}.{i}` at torchvision's
feature indices (ReLUs and pools included, so the conv indices match) and
`lin{k}.model.1.weight` behind an inactive dropout. A dump of those keys
loads with `load_state_dict(strict=True)`; `load_lpips` also takes a full
`lpips` dump, whose `lins.{k}` entries repeat `lin{k}`.

The pools are the JAX package's: 3×3 with stride 2 before conv 2 and 3 of
AlexNet (as torchvision's) and before conv 2, 4, 7 and 10 of VGG16, where
torchvision's VGG16 pools 2×2 with stride 2. With the official `vgg.pth`
the `lpips_vgg` column would therefore differ from the `lpips` package's
in both packages (ROADMAP.md queue 3); the port keeps the JAX semantics,
which its tests hold it to.
"""

from __future__ import annotations

import torch
from torch import nn

# torchvision feature index of each conv, by slice, and the indices with a
# max-pool before them (lpips's slices keep torchvision's numbering)
_SLICES = {
    "alex": [[0], [3], [6], [8], [10]],
    "vgg": [[0, 2], [5, 7], [10, 12, 14], [17, 19, 21], [24, 26, 28]],
}
_POOLS = {"alex": (2, 5), "vgg": (4, 9, 16, 23)}
_CHANNELS = {
    "alex": [(3, 64, 11, 4, 2), (64, 192, 5, 1, 2), (192, 384, 3, 1, 1),
             (384, 256, 3, 1, 1), (256, 256, 3, 1, 1)],
    "vgg": [(cin, cout, 3, 1, 1) for cin, cout in
            zip([3, 64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512],
                [64, 64, 128, 128, 256, 256, 256, 512, 512, 512, 512, 512, 512])],
}
# the scaling layer's constants (ImageNet statistics over [-1, 1] inputs)
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


class ScalingLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.register_buffer("shift", torch.tensor(SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(SCALE).view(1, 3, 1, 1))

    def forward(self, x):
        return (x - self.shift) / self.scale


class Backbone(nn.Module):
    """`slice1` … `slice5`, each ending at one tapped ReLU."""

    def __init__(self, net: str):
        super().__init__()
        convs = iter(_CHANNELS[net])
        for s, idxs in enumerate(_SLICES[net], 1):
            seq = nn.Sequential()
            for i in idxs:
                if i - 1 in _POOLS[net]:
                    seq.add_module(str(i - 1), nn.MaxPool2d(kernel_size=3, stride=2))
                cin, cout, k, stride, pad = next(convs)
                seq.add_module(str(i), nn.Conv2d(cin, cout, k, stride=stride, padding=pad))
                seq.add_module(str(i + 1), nn.ReLU())
            setattr(self, f"slice{s}", seq)

    def forward(self, x):
        taps = []
        for s in range(1, 6):
            x = getattr(self, f"slice{s}")(x)
            taps.append(x)
        return taps


class NetLinLayer(nn.Module):
    """The learned non-negative 1×1 weighting of one tap."""

    def __init__(self, channels: int):
        super().__init__()
        self.model = nn.Sequential(nn.Dropout(), nn.Conv2d(channels, 1, 1, bias=False))

    def forward(self, x):
        return self.model(x)


def _unit_normalize(f: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """Channel unit L2 norm (lpips normalize_tensor: eps outside the sqrt)."""
    return f / (torch.sqrt(torch.sum(f * f, dim=1, keepdim=True)) + eps)


class LPIPS(nn.Module):
    """LPIPS distance of NCHW images in [0, 1] -> [N]. Built in eval mode."""

    def __init__(self, net: str = "alex"):
        super().__init__()
        if net not in _SLICES:
            raise ValueError(f"LPIPS net {net!r}: 'alex' or 'vgg'")
        self.scaling_layer = ScalingLayer()
        self.net = Backbone(net)
        n_convs = 0
        for k, idxs in enumerate(_SLICES[net]):  # one head on each slice's last conv
            n_convs += len(idxs)
            setattr(self, f"lin{k}", NetLinLayer(_CHANNELS[net][n_convs - 1][1]))
        self.eval()

    def forward(self, img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
        f0 = self.net(self.scaling_layer(2.0 * img0 - 1.0))
        f1 = self.net(self.scaling_layer(2.0 * img1 - 1.0))
        total = 0.0
        for k, (a, b) in enumerate(zip(f0, f1)):
            diff = (_unit_normalize(a) - _unit_normalize(b)) ** 2
            total = total + getattr(self, f"lin{k}")(diff).mean(dim=(2, 3))
        return total[:, 0]


def _from_lpips_dump(raw: dict) -> dict:
    """An `lpips` dump -> the keys of `LPIPS`: a full
    `lpips.LPIPS().state_dict()` repeats each `lin{k}` as `lins.{k}`
    (dropped once checked equal); without the scaling layer's buffers the
    package's constants are filled in."""
    sd = {k: v for k, v in raw.items() if not k.startswith("lins.")}
    for k, v in raw.items():
        if k.startswith("lins.") and not torch.equal(v, raw.get(f"lin{k[5:]}", v)):
            raise ValueError(f"{k} differs from lin{k[5:]}")
    sd.setdefault("scaling_layer.shift", torch.tensor(SHIFT).view(1, 3, 1, 1))
    sd.setdefault("scaling_layer.scale", torch.tensor(SCALE).view(1, 3, 1, 1))
    return sd


def load_lpips(path: str, net: str, device) -> LPIPS:
    """An `lpips` state-dict dump at `path` (tensors only) -> `LPIPS(net)` on
    `device`, loaded strictly."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    model = LPIPS(net)
    model.load_state_dict(_from_lpips_dump(raw), strict=True)
    return model.to(device)
