"""The inputs of a run, made from its seed on the device: the scene (frames,
flows, disparities, motion masks, cameras) and the initial parameters.

The scene follows the semantics of the port's synthetic fixture: a coloured
blob moving across a gradient background, its forward and backward flow,
a disparity map and the blob's motion mask, cameras translating along x.
The seed sets the blob's colour, path, size and the cameras' baseline;
every seed gives the same sizes.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..reference import model as M
from .spec import NEAR_FAR, scene_box


def _gen(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63))
    return g


def make_scene(cfg: dict, seed: int, device, arrays: bool = True):
    """(the program's SceneData with host arrays, the poses [T, 3, 4]
    float32 numpy); without `arrays` only the poses (and None)."""
    from rodynrf_tpu_torch.data.scene import SceneData

    sc = cfg["scene"]
    T, H, W = int(sc["frames"]), int(sc["height"]), int(sc["width"])
    ray = cfg["recipe"]["ray_type"]
    g = _gen(seed, device)
    u = torch.rand(8, generator=g, device=device, dtype=torch.float64).cpu().numpy()
    colour = torch.tensor([0.6 + 0.35 * u[0], 0.1 + 0.3 * u[1], 0.05 + 0.3 * u[2]],
                          device=device)
    x0, x1 = W * (0.15 + 0.2 * u[3]), W * (0.65 + 0.2 * u[4])
    cy = H * (0.35 + 0.3 * u[5])
    r = min(H, W) * (0.1 + 0.1 * u[6])
    baseline = 0.01 + 0.03 * u[7]
    poses = np.zeros((T, 3, 4), np.float32)
    poses[:, 0, 0] = poses[:, 1, 1] = poses[:, 2, 2] = 1.0
    poses[:, 0, 3] = np.linspace(-baseline, baseline, T)
    if not arrays:
        return None, poses

    yy = torch.arange(H, dtype=torch.float32, device=device)[:, None].expand(H, W)
    xx = torch.arange(W, dtype=torch.float32, device=device)[None, :].expand(H, W)
    cx = torch.linspace(x0, x1, T, dtype=torch.float32, device=device)
    blob = torch.exp(-(((xx[None] - cx[:, None, None]) ** 2 + (yy[None] - cy) ** 2)
                       / (2 * r * r)))  # [T, H, W]
    base = torch.stack([xx / W * 0.5 + 0.25, yy / H * 0.5 + 0.25, torch.full_like(xx, 0.4)], -1)
    rgbs = base[None] * (1 - blob[..., None]) + blob[..., None] * colour
    moving = (blob > 0.1).to(torch.float32)
    dx_f = torch.cat([cx[1:], cx[-1:]]) - cx
    dx_b = torch.cat([cx[:1], cx[:-1]]) - cx
    zeros = torch.zeros_like(blob)
    flows_f = torch.stack([dx_f[:, None, None] * moving, zeros], -1)
    flows_b = torch.stack([dx_b[:, None, None] * moving, zeros], -1)
    dev = {
        "rgbs": rgbs.reshape(-1, 3),
        "ts": torch.linspace(-1.0, 1.0, T, device=device).repeat_interleave(H * W),
        "flows_f": flows_f.reshape(-1, 2),
        "flow_masks_f": torch.ones(T * H * W, device=device),
        "flows_b": flows_b.reshape(-1, 2),
        "flow_masks_b": torch.ones(T * H * W, device=device),
        "disps": (0.5 + 0.3 * (yy / H)[None] + 0.4 * blob).reshape(-1),
        "fg_masks": (blob > 0.4).to(torch.float32).reshape(-1),
    }
    host = {k: v.cpu().numpy() for k, v in dev.items()}
    scene = SceneData(
        **host, img_wh=(W, H), n_frames=T, scene_bbox=scene_box(ray), near_far=NEAR_FAR[ray],
        focal=max(H, W) / 2.0 * math.sqrt(3.0), poses=poses, white_bg=False, rgbs_stack=None)
    return scene, poses


def make_params(model: M.Model, poses: np.ndarray, seed: int, device):
    """{path: tensor} of every leaf, made on the device in two draws (one
    normal, one uniform) and cut into leaves; the cameras from the scene's
    poses (6D rotation + translation) and a 30-degree field of view."""
    specs = M.param_specs(model)
    g = _gen(seed + 1, device)
    n_normal = sum(math.prod(s) for _, s, k, _ in specs if k == "normal")
    n_uniform = sum(math.prod(s) for _, s, k, _ in specs if k == "uniform")
    normal = torch.randn(n_normal, generator=g, device=device)
    unif = torch.rand(n_uniform, generator=g, device=device)
    out, i_n, i_u = {}, 0, 0
    for path, shape, kind, bound in specs:
        n = math.prod(shape)
        if kind == "normal":
            out[path] = (normal[i_n:i_n + n] * bound).reshape(shape)
            i_n += n
        elif kind == "uniform":
            out[path] = (unif[i_u:i_u + n] * (2 * bound) - bound).reshape(shape)
            i_u += n
        else:
            out[path] = torch.zeros(shape, device=device)
    pose = np.zeros((poses.shape[0], 9), np.float32)
    pose[:, 0:3], pose[:, 3:6], pose[:, 6:9] = poses[:, :, 0], poses[:, :, 1], poses[:, :, 3]
    out[("pose",)] = torch.as_tensor(pose, device=device)
    out[("fov",)] = torch.full((1, 1), 30.0 / 180.0 * math.pi, device=device)
    return out


def fill(tree, params) -> None:
    """Copy the benchmark's parameters into a parameter tree, leaf by leaf
    by path; refuses a tree whose leaves differ from the configuration's."""
    got = dict(M.leaves(tree))
    if set(got) != set(params):
        raise ValueError(f"the parameter tree differs from the configuration's: "
                         f"{sorted(map(str, set(got) ^ set(params)))[:6]}")
    with torch.no_grad():
        for path, t in got.items():
            if tuple(t.shape) != tuple(params[path].shape):
                raise ValueError(f"{path}: shape {tuple(t.shape)}, the configuration's "
                                 f"{tuple(params[path].shape)}")
            t.copy_(params[path])


def fresh_tree(params, device, requires_grad: bool = True):
    """A new parameter tree of leaf copies of {path: tensor}."""
    items = [(p, t.detach().to(device).clone().requires_grad_(requires_grad))
             for p, t in params.items()]
    return M.build_tree(items)
