"""Volume-rendering compositors, single- and dual-field (port of
rodynrf_tpu/ops/compositing.py; reference models/tensorBase.py:22-34 and
renderer.py:173-315). Dense over [rays, samples] with cumulative products.

The white-fill coin of training is a Python bool (or None for no fill):
the trainer draws it from its own generator, or golden mode fixes it. The
batched passes give a bool tensor [R] instead, each pass's coin over its
rows.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils.profiling import span


def _exclusive_transmittance(alpha: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """T_i = prod_{j<i} (1 - alpha_j + eps); shape preserved [R, S]."""
    shifted = torch.cat([torch.ones_like(alpha[:, :1]), 1.0 - alpha[:, :-1] + eps], dim=-1)
    return torch.cumprod(shifted, dim=-1)


def raw2alpha(sigma: torch.Tensor, dist: torch.Tensor):
    """sigma, dist [R, S] -> (alpha, weights, bg_weight [R, 1])
    (reference: tensorBase.py:22-34)."""
    alpha = 1.0 - torch.exp(-sigma * dist)
    T = _exclusive_transmittance(alpha)
    weights = alpha * T
    bg_weight = T[:, -1:] * (1.0 - alpha[:, -1:] + 1e-10)
    return alpha, weights, bg_weight


def _any_white(white) -> bool:
    """Whether a white fill can apply: `white` is a bool or None (one coin
    for every row) or a bool tensor [R] (one coin per row)."""
    return torch.is_tensor(white) or bool(white)


def _white_fill(rgb_map, rest, white):
    """rgb_map + rest on the rows whose coin says white."""
    if torch.is_tensor(white):
        return torch.where(white[:, None], rgb_map + rest, rgb_map)
    return rgb_map + rest


def _depth_tail(depth, acc, rays, ray_type, relu=False):
    rest = torch.relu(1.0 - acc) if relu else 1.0 - acc
    if ray_type == "ndc":
        return depth + rest * (rays[..., 2] + rays[..., -1])
    if ray_type == "contract":
        return depth + rest * 256.0
    return depth


def static_side_outputs(rgb_s, sigma_s, dists, z_vals, rays, *, is_train: bool = False,
                        ray_type: str = "ndc", white=None):
    """The static-side subset of raw2outputs: (rgb_map_s, depth_s, acc_s,
    weights_s) with exactly its formulas, eps and white fill."""
    alpha_s = 1.0 - torch.exp(-sigma_s * dists)
    weights_s = alpha_s * _exclusive_transmittance(alpha_s)
    rgb_map_s = torch.sum(weights_s[..., None] * rgb_s, -2)
    acc_s = torch.sum(weights_s, -1)
    if is_train and _any_white(white):
        rgb_map_s = _white_fill(rgb_map_s, 1.0 - acc_s[..., None], white)
    depth_s = _depth_tail(torch.sum(weights_s * z_vals, -1), acc_s, rays, ray_type)
    return torch.clamp(rgb_map_s, 0.0, 1.0), depth_s, acc_s, weights_s


def dynamic_side_weights(sigma_d: torch.Tensor, dists: torch.Tensor) -> torch.Tensor:
    """raw2outputs' normalized dynamic weights (the only compositor output the
    flow-warped neighbor passes consume). max(sum, eps) instead of the
    reference's sum + eps: an all-empty ray must not divide 0/0."""
    alpha_d = 1.0 - torch.exp(-sigma_d * dists)
    weights_d = alpha_d * _exclusive_transmittance(alpha_d)
    return weights_d / torch.clamp(torch.sum(weights_d, -1, keepdim=True), min=1e-10)


class RenderOutputs(NamedTuple):
    """Outputs of the dual-field compositor (order mirrors renderer.py:301-315)."""

    rgb_full: torch.Tensor
    depth_full: torch.Tensor
    acc_full: torch.Tensor
    weights_full: torch.Tensor
    rgb_s: torch.Tensor
    depth_s: torch.Tensor
    acc_s: torch.Tensor
    weights_s: torch.Tensor
    rgb_d: torch.Tensor
    depth_d: torch.Tensor
    acc_d: torch.Tensor
    weights_d: torch.Tensor
    dynamicness: torch.Tensor


def raw2outputs(rgb_s, sigma_s, rgb_d, sigma_d, dists, blending, z_vals, rays, *,
                is_train: bool = False, ray_type: str = "ndc",
                white=None) -> RenderOutputs:
    """Dual-field compositing (reference: renderer.py:173-315).

    rgb_s/rgb_d [R, S, 3]; sigma_s/sigma_d/dists/blending/z_vals [R, S];
    rays [R, 6]. `white` (training only) white-fills the unoccupied ray
    remainder, the reference's stochastic background (renderer.py:269-272);
    a bool tensor [R] gives each row its own coin.
    """
    with span("compositor"):
        alpha_d = 1.0 - torch.exp(-sigma_d * dists)
        alpha_s = 1.0 - torch.exp(-sigma_s * dists)

        T_d = _exclusive_transmittance(alpha_d)
        T_s = _exclusive_transmittance(alpha_s)
        alpha_mix = (1.0 - alpha_d * blending) * (1.0 - alpha_s * (1.0 - blending))
        T_full = torch.cumprod(
            torch.cat([torch.ones_like(alpha_d[:, :1]), alpha_mix[:, :-1] + 1e-10], -1), dim=-1
        )

        weights_d = alpha_d * T_d
        weights_s = alpha_s * T_s
        weights_d = weights_d / torch.clamp(torch.sum(weights_d, -1, keepdim=True), min=1e-10)
        weights_full = (alpha_d * blending + alpha_s * (1.0 - blending)) * T_full

        rgb_map_d = torch.sum(weights_d[..., None] * rgb_d, -2)
        rgb_map_s = torch.sum(weights_s[..., None] * rgb_s, -2)
        rgb_map_full = torch.sum(
            (T_full * alpha_d * blending)[..., None] * rgb_d
            + (T_full * alpha_s * (1.0 - blending))[..., None] * rgb_s,
            -2,
        )

        acc_d = torch.sum(weights_d, -1)
        acc_s = torch.sum(weights_s, -1)
        acc_full = torch.sum(weights_full, -1)

        if is_train and _any_white(white):
            rgb_map_d = _white_fill(rgb_map_d, 1.0 - acc_d[..., None], white)
            rgb_map_s = _white_fill(rgb_map_s, 1.0 - acc_s[..., None], white)
            rgb_map_full = _white_fill(rgb_map_full, torch.relu(1.0 - acc_full[..., None]), white)

        depth_d = _depth_tail(torch.sum(weights_d * z_vals, -1), acc_d, rays, ray_type)
        depth_s = _depth_tail(torch.sum(weights_s * z_vals, -1), acc_s, rays, ray_type)
        depth_full = _depth_tail(torch.sum(weights_full * z_vals, -1), acc_full, rays, ray_type,
                                 relu=True)

        return RenderOutputs(
            torch.clamp(rgb_map_full, 0.0, 1.0),
            depth_full,
            acc_full,
            weights_full,
            torch.clamp(rgb_map_s, 0.0, 1.0),
            depth_s,
            acc_s,
            weights_s,
            torch.clamp(rgb_map_d, 0.0, 1.0),
            depth_d,
            acc_d,
            weights_d,
            torch.sum(weights_full * blending, -1),
        )
