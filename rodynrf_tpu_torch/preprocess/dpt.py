"""DPT monocular depth (ViT-L/16 backbone) as torch modules (port of
rodynrf_tpu/preprocess/dpt.py; reference scripts/midas/dpt_depth.py:28-123,
vit.py:185-493, blocks.py:233-343; config vitl16_384, hooks 5/11/17/23,
reassemble widths 256/512/1024/1024, 256 scratch features, the 'project'
readout).

The modules carry the official checkpoint's names
(dpt_large-midas-2f21e586.pt): `pretrained.model.{patch_embed.proj,
cls_token, pos_embed, blocks.{i}.{norm1,attn.qkv,attn.proj,norm2,mlp.fc1,
mlp.fc2}, norm}`, `pretrained.act_postprocess{1-4}.{0.project.0, 3, 4}`,
`scratch.layer{1-4}_rn`, `scratch.refinenet{1-4}.{resConfUnit1,
resConfUnit2,out_conv}`, `scratch.output_conv.{0,2,4}`. The ViT's final
norm is declared (the checkpoint has it) but the depth forward reads only
the hooked blocks, as the reference does. `load_dpt` drops the ViT's
ImageNet classifier (`pretrained.model.head.*`), which no depth path reads,
and loads the rest strictly.

Attention is written as the JAX function writes it: einsum, softmax,
einsum. The image is normalised with mean = std = 0.5 inside the forward
(the reference normalises outside the model, generate_DPT.py:60).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..device import check_device


@dataclass(frozen=True)
class DPTConfig:
    dim: int = 1024
    heads: int = 16
    blocks: int = 24
    hooks: tuple = (5, 11, 17, 23)
    patch: int = 16
    reassemble: tuple = (256, 512, 1024, 1024)
    features: int = 256
    pretrain_grid: int = 24  # the pos-embed grid: 384 / 16


DPT_LARGE = DPTConfig()


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        N, T, C = x.shape
        qkv = self.qkv(x).reshape(N, T, 3, self.heads, C // self.heads)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        attn = torch.einsum("nthd,nshd->nhts", q, k) / math.sqrt(C // self.heads)
        attn = torch.softmax(attn, dim=-1)
        return self.proj(torch.einsum("nhts,nshd->nthd", attn, v).reshape(N, T, C))


class Mlp(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x)))


class Block(nn.Module):
    """Pre-norm attention and MLP, LayerNorm eps 1e-6 (timm's ViT block)."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim)

    def forward(self, x):
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, dim: int, patch: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)


class VisionTransformer(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.cfg = cfg
        g = cfg.pretrain_grid
        self.patch_embed = PatchEmbed(cfg.dim, cfg.patch)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, cfg.dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + g * g, cfg.dim))
        self.blocks = nn.ModuleList(Block(cfg.dim, cfg.heads) for _ in range(cfg.blocks))
        self.norm = nn.LayerNorm(cfg.dim, eps=1e-6)

    def forward(self, x):
        """[N, 3, H, W] (normalised) -> the hooked blocks' tokens [N, 1+hw, C]
        (reference: vit.py forward_flex)."""
        cfg = self.cfg
        N, _, H, W = x.shape
        gh, gw = H // cfg.patch, W // cfg.patch
        tokens = self.patch_embed.proj(x).flatten(2).transpose(1, 2)
        pos = self.pos_embed
        g0 = int(math.sqrt(pos.shape[1] - 1))
        grid = pos[:, 1:]
        if (gh, gw) != (g0, g0):  # (reference: vit.py:103-117 _resize_pos_embed)
            grid = F.interpolate(grid.reshape(1, g0, g0, -1).permute(0, 3, 1, 2), size=(gh, gw),
                                 mode="bilinear", align_corners=False)
            grid = grid.permute(0, 2, 3, 1).reshape(1, gh * gw, -1)
        x = torch.cat([self.cls_token.expand(N, -1, -1), tokens], 1) + torch.cat(
            [pos[:, :1], grid], 1)
        outs = []
        for i, blk in enumerate(self.blocks):
            x = blk(x)
            if i in cfg.hooks:
                outs.append(x)
        return outs


class ProjectReadout(nn.Module):
    """Concatenate the cls token to every patch token and project back
    (reference: vit.py:36-56)."""

    def __init__(self, dim: int):
        super().__init__()
        self.project = nn.Sequential(nn.Linear(2 * dim, dim), nn.GELU())

    def forward(self, tokens):
        patches = tokens[:, 1:]
        return self.project(torch.cat([patches, tokens[:, :1].expand_as(patches)], -1))


class Backbone(nn.Module):
    """`pretrained`: the ViT and its four reassemble stages
    (act_postprocess1-4: readout, [transpose, unflatten], 1×1 conv, then a
    ×4 / ×2 transposed conv, nothing, or a 3×3/2 conv)."""

    def __init__(self, cfg: DPTConfig):
        super().__init__()
        self.model = VisionTransformer(cfg)
        for i, ch in enumerate(cfg.reassemble):
            mods = [ProjectReadout(cfg.dim), nn.Identity(), nn.Identity(),
                    nn.Conv2d(cfg.dim, ch, 1)]
            if i == 0:
                mods.append(nn.ConvTranspose2d(ch, ch, 4, stride=4))
            elif i == 1:
                mods.append(nn.ConvTranspose2d(ch, ch, 2, stride=2))
            elif i == 3:
                mods.append(nn.Conv2d(ch, ch, 3, stride=2, padding=1))
            setattr(self, f"act_postprocess{i + 1}", nn.Sequential(*mods))

    def forward(self, x):
        cfg = self.model.cfg
        N, _, H, W = x.shape
        gh, gw = H // cfg.patch, W // cfg.patch
        layers = []
        for i, tokens in enumerate(self.model(x)):
            post = getattr(self, f"act_postprocess{i + 1}")
            y = post[0](tokens).transpose(1, 2).reshape(N, cfg.dim, gh, gw)
            for mod in post[3:]:
                y = mod(y)
            layers.append(y)
        return layers


class ResidualConvUnit(nn.Module):
    """(reference: blocks.py:233-290, no batch norm)."""

    def __init__(self, features: int):
        super().__init__()
        self.conv1 = nn.Conv2d(features, features, 3, padding=1)
        self.conv2 = nn.Conv2d(features, features, 3, padding=1)

    def forward(self, x):
        return self.conv2(F.relu(self.conv1(F.relu(x)))) + x


class FeatureFusionBlock(nn.Module):
    """(reference: blocks.py:293-343, align_corners=True)."""

    def __init__(self, features: int):
        super().__init__()
        self.resConfUnit1 = ResidualConvUnit(features)
        self.resConfUnit2 = ResidualConvUnit(features)
        self.out_conv = nn.Conv2d(features, features, 1)

    def forward(self, x, skip=None):
        if skip is not None:
            x = x + self.resConfUnit1(skip)
        x = self.resConfUnit2(x)
        x = F.interpolate(x, size=(2 * x.shape[2], 2 * x.shape[3]), mode="bilinear",
                          align_corners=True)
        return self.out_conv(x)


class Interpolate(nn.Module):
    def forward(self, x):
        return F.interpolate(x, size=(2 * x.shape[2], 2 * x.shape[3]), mode="bilinear",
                             align_corners=True)


class Scratch(nn.Module):
    def __init__(self, cfg: DPTConfig):
        super().__init__()
        f = cfg.features
        for i, ch in enumerate(cfg.reassemble):
            setattr(self, f"layer{i + 1}_rn", nn.Conv2d(ch, f, 3, padding=1, bias=False))
            setattr(self, f"refinenet{i + 1}", FeatureFusionBlock(f))
        self.output_conv = nn.Sequential(
            nn.Conv2d(f, f // 2, 3, padding=1), Interpolate(),
            nn.Conv2d(f // 2, 32, 3, padding=1), nn.ReLU(), nn.Conv2d(32, 1, 1), nn.ReLU())


class DPTDepthModel(nn.Module):
    """DPT with the MiDaS depth head (reference: dpt_depth.py:69-123),
    inference only (starts in eval mode)."""

    def __init__(self, cfg: DPTConfig = DPT_LARGE):
        super().__init__()
        self.cfg = cfg
        self.pretrained = Backbone(cfg)
        self.scratch = Scratch(cfg)
        self.eval()

    def forward(self, image):
        """[N, 3, H, W] in [0, 1] (H, W multiples of 32) -> inverse depth
        [N, H, W]."""
        x = (image - 0.5) / 0.5
        s = self.scratch
        rn = [getattr(s, f"layer{i + 1}_rn")(y) for i, y in enumerate(self.pretrained(x))]
        path = s.refinenet4(rn[3])
        path = s.refinenet3(path, rn[2])
        path = s.refinenet2(path, rn[1])
        path = s.refinenet1(path, rn[0])
        return s.output_conv(path)[:, 0]


def load_dpt(path: str, device="cuda", cfg: DPTConfig = DPT_LARGE) -> DPTDepthModel:
    """An official DPT checkpoint (dpt_large-midas-2f21e586.pt) in a
    DPTDepthModel on `device` (the card unless the caller passes the CPU;
    refuses without a card): strict, after dropping the ViT's classifier."""
    device = check_device(device)
    raw = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(raw, dict) and "state_dict" in raw:
        raw = raw["state_dict"]
    sd = {k: v for k, v in raw.items() if not k.startswith("pretrained.model.head.")}
    with torch.device("meta"):  # no random initialisation of 340M parameters
        model = DPTDepthModel(cfg)
    model.load_state_dict(sd, strict=True, assign=True)
    return model.to(device)
