"""RAFT optical flow as torch modules (port of rodynrf_tpu/preprocess/raft.py;
reference scripts/RAFT/raft.py:26-147, extractor.py:8-180,
update.py:8-141, corr.py:14-62, utils/utils.py:59-84).

NCHW throughout, with the reference's module names, so that an official
checkpoint (raft-things.pth, DataParallel `module.` prefixes stripped) loads
with `load_state_dict(strict=True)`: `fnet`/`cnet` BasicEncoders (instance
norm without affine / batch norm in eval mode; a strided residual block
registers its third norm twice, as `norm3` and `downsample.1`, as the
reference does), `update_block.{encoder,gru,flow_head,mask}`.

As in the JAX package: the all-pairs correlation is one batched matmul
scaled by 1/sqrt(C), pooled 2×2 into a 4-level pyramid; the radius-4 lookup
gathers the four bilinear corners of each of the 81 window offsets at each
level, with taps outside the level reading 0, and the window's offsets
ordered as the JAX package orders them (x offset minor); the refinement is
a plain loop over `iters` with the coordinates detached, and the convex
upsampling mask is computed once, at the last iteration (the only one whose
mask is used).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..train.step import check_device


class ResidualBlock(nn.Module):
    """(reference: extractor.py:8-59)."""

    def __init__(self, in_planes: int, planes: int, norm_fn: str, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, padding=1, stride=stride)
        self.conv2 = nn.Conv2d(planes, planes, 3, padding=1)
        self.relu = nn.ReLU()
        norm = nn.InstanceNorm2d if norm_fn == "instance" else nn.BatchNorm2d
        self.norm1 = norm(planes)
        self.norm2 = norm(planes)
        self.downsample = None
        if stride != 1:
            self.norm3 = norm(planes)
            self.downsample = nn.Sequential(
                nn.Conv2d(in_planes, planes, 1, stride=stride), self.norm3)

    def forward(self, x):
        y = self.relu(self.norm1(self.conv1(x)))
        y = self.relu(self.norm2(self.conv2(y)))
        if self.downsample is not None:
            x = self.downsample(x)
        return self.relu(x + y)


class BasicEncoder(nn.Module):
    """7×7/2 stem, three residual stages (64, 96, 128; strides 1, 2, 2), 1×1
    head: output stride 8 (reference: extractor.py:120-180)."""

    def __init__(self, output_dim: int, norm_fn: str):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, stride=2, padding=3)
        self.norm1 = nn.InstanceNorm2d(64) if norm_fn == "instance" else nn.BatchNorm2d(64)
        self.relu1 = nn.ReLU()
        stages, cin = [], 64
        for dim, stride in ((64, 1), (96, 2), (128, 2)):
            stages.append(nn.Sequential(ResidualBlock(cin, dim, norm_fn, stride),
                                        ResidualBlock(dim, dim, norm_fn, 1)))
            cin = dim
        self.layer1, self.layer2, self.layer3 = stages
        self.conv2 = nn.Conv2d(128, output_dim, 1)

    def forward(self, x):
        x = self.relu1(self.norm1(self.conv1(x)))
        return self.conv2(self.layer3(self.layer2(self.layer1(x))))


class BasicMotionEncoder(nn.Module):
    """(reference: update.py:84-102)."""

    def __init__(self, cor_planes: int):
        super().__init__()
        self.convc1 = nn.Conv2d(cor_planes, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(2, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - 2, 3, padding=1)

    def forward(self, flow, corr):
        cor = F.relu(self.convc2(F.relu(self.convc1(corr))))
        flo = F.relu(self.convf2(F.relu(self.convf1(flow))))
        out = F.relu(self.conv(torch.cat([cor, flo], 1)))
        return torch.cat([out, flow], 1)


class SepConvGRU(nn.Module):
    """Horizontal (1×5) then vertical (5×1) GRU (reference: update.py:35-63)."""

    def __init__(self, hidden_dim: int = 128, input_dim: int = 256):
        super().__init__()
        c = hidden_dim + input_dim
        for axis, k, p in (("1", (1, 5), (0, 2)), ("2", (5, 1), (2, 0))):
            for gate in "zrq":
                setattr(self, f"conv{gate}{axis}", nn.Conv2d(c, hidden_dim, k, padding=p))

    def forward(self, h, x):
        for axis in "12":
            hx = torch.cat([h, x], 1)
            z = torch.sigmoid(getattr(self, f"convz{axis}")(hx))
            r = torch.sigmoid(getattr(self, f"convr{axis}")(hx))
            q = torch.tanh(getattr(self, f"convq{axis}")(torch.cat([r * h, x], 1)))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self, input_dim: int = 128, hidden_dim: int = 256):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, 2, 3, padding=1)
        self.relu = nn.ReLU()

    def forward(self, x):
        return self.conv2(self.relu(self.conv1(x)))


class BasicUpdateBlock(nn.Module):
    """(reference: update.py:117-141)."""

    def __init__(self, radius: int = 4, levels: int = 4, hidden_dim: int = 128):
        super().__init__()
        self.encoder = BasicMotionEncoder(levels * (2 * radius + 1) ** 2)
        self.gru = SepConvGRU(hidden_dim, 128 + hidden_dim)
        self.flow_head = FlowHead(hidden_dim, 256)
        self.mask = nn.Sequential(nn.Conv2d(128, 256, 3, padding=1), nn.ReLU(),
                                  nn.Conv2d(256, 64 * 9, 1))

    def forward(self, net, inp, corr, flow, need_mask: bool):
        motion = self.encoder(flow, corr)
        net = self.gru(net, torch.cat([inp, motion], 1))
        delta_flow = self.flow_head(net)
        mask = 0.25 * self.mask(net) if need_mask else None
        return net, mask, delta_flow


def build_corr_pyramid(fmap1, fmap2, num_levels: int = 4):
    """[N, C, H, W] × 2 -> [N·H·W, H, W] / sqrt(C), then 2×2 average pools
    (odd rows and columns dropped) (reference: corr.py:14-62)."""
    N, C, H, W = fmap1.shape
    corr = torch.matmul(fmap1.reshape(N, C, H * W).transpose(1, 2), fmap2.reshape(N, C, H * W))
    corr = (corr / torch.sqrt(torch.tensor(float(C), device=corr.device))).reshape(
        N * H * W, 1, H, W)
    pyramid = [corr]
    for _ in range(num_levels - 1):
        corr = F.avg_pool2d(corr, 2, stride=2)
        pyramid.append(corr)
    return [c[:, 0] for c in pyramid]


def _bilinear_lookup(vol, xy):
    """vol [M, H, W], xy [M, K, 2] pixel coordinates -> [M, K]; each corner
    outside the volume reads 0."""
    M, H, W = vol.shape
    x, y = xy[..., 0], xy[..., 1]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx, wy = x - x0, y - y0
    flat = vol.reshape(M, H * W)

    def gather(xi, yi):
        inb = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        idx = yi.clamp(0, H - 1).long() * W + xi.clamp(0, W - 1).long()
        return torch.gather(flat, 1, idx) * inb

    return (gather(x0, y0) * (1 - wx) * (1 - wy) + gather(x0 + 1, y0) * wx * (1 - wy)
            + gather(x0, y0 + 1) * (1 - wx) * wy + gather(x0 + 1, y0 + 1) * wx * wy)


def lookup_corr(pyramid, coords, radius: int = 4):
    """coords [N, H, W, 2] (x, y) -> correlation features [N, L·(2r+1)², H,
    W]; window offset k = i·(2r+1) + j moves x by j - r and y by i - r."""
    N, H, W, _ = coords.shape
    d = torch.arange(-radius, radius + 1, dtype=coords.dtype, device=coords.device)
    ddy, ddx = torch.meshgrid(d, d, indexing="ij")
    delta = torch.stack([ddx, ddy], -1).reshape(1, -1, 2)
    flat = coords.reshape(N * H * W, 1, 2)
    feats = [_bilinear_lookup(vol, flat / 2**i + delta) for i, vol in enumerate(pyramid)]
    return torch.cat(feats, -1).reshape(N, H, W, -1).permute(0, 3, 1, 2)


def convex_upsample(flow, mask):
    """[N, 2, H, W], [N, 576, H, W] -> [N, 2, 8H, 8W]: each fine pixel a
    softmax-weighted mix of its coarse 3×3 neighbourhood (reference:
    raft.py:76-88)."""
    N, _, H, W = flow.shape
    mask = torch.softmax(mask.reshape(N, 1, 9, 8, 8, H, W), dim=2)
    up = F.unfold(8 * flow, [3, 3], padding=1).reshape(N, 2, 9, 1, 1, H, W)
    up = torch.sum(mask * up, dim=2)  # [N, 2, 8, 8, H, W]
    return up.permute(0, 1, 4, 2, 5, 3).reshape(N, 2, 8 * H, 8 * W)


class RAFT(nn.Module):
    """The full RAFT model (reference: raft.py:26-147), inference only: the
    module starts in eval mode (batch norm on its running statistics)."""

    def __init__(self):
        super().__init__()
        self.fnet = BasicEncoder(256, "instance")
        self.cnet = BasicEncoder(256, "batch")
        self.update_block = BasicUpdateBlock()
        self.eval()

    def forward(self, image1, image2, iters: int = 20, radius: int = 4):
        """images [N, 3, H, W] in 0-255 (H, W multiples of 8) -> flow
        [N, 2, H, W] from image1 to image2."""
        x1 = 2.0 * (image1 / 255.0) - 1.0
        x2 = 2.0 * (image2 / 255.0) - 1.0
        N = x1.shape[0]
        fmaps = self.fnet(torch.cat([x1, x2], 0))  # instance norm: per image
        pyramid = build_corr_pyramid(fmaps[:N], fmaps[N:])
        net, inp = torch.split(self.cnet(x1), [128, 128], dim=1)
        net, inp = torch.tanh(net), torch.relu(inp)

        _, _, H8, W8 = net.shape
        ys, xs = torch.meshgrid(torch.arange(H8, dtype=x1.dtype, device=x1.device),
                                torch.arange(W8, dtype=x1.dtype, device=x1.device),
                                indexing="ij")
        coords0 = torch.stack([xs, ys], -1)[None].expand(N, H8, W8, 2)
        coords1 = coords0
        mask = None
        for it in range(iters):
            coords1 = coords1.detach()
            corr = lookup_corr(pyramid, coords1, radius)
            flow = (coords1 - coords0).permute(0, 3, 1, 2)
            net, mask, delta = self.update_block(net, inp, corr, flow, it == iters - 1)
            coords1 = coords1 + delta.permute(0, 2, 3, 1)
        return convex_upsample((coords1 - coords0).permute(0, 3, 1, 2), mask)


def load_raft(path: str, device="cuda") -> RAFT:
    """An official RAFT checkpoint (e.g. raft-things.pth; `module.` prefixes
    of DataParallel stripped) in a RAFT module on `device` (the card unless
    the caller passes the CPU; refuses without a card), strict.

    Known limitation, shared with the JAX package: `lookup_corr` orders the
    81 offsets of a correlation level with the x offset minor, where the
    reference's corr.py moves x with the major index. With the official
    weights `update_block.encoder.convc1` then reads its 324 channels
    permuted and the flow is wrong without an error. Both packages keep
    this order until the real weights are in the repository to check the
    swap against (ROADMAP.md, queue 3)."""
    device = check_device(device)
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]
    with torch.device("meta"):
        model = RAFT()
    model.load_state_dict({k.removeprefix("module."): v for k, v in raw.items()}, strict=True,
                          assign=True)
    return model.to(device)
