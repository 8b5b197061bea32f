"""Shading MLP heads and small-MLP building blocks (port of
rodynrf_tpu/fields/mlps.py; reference models/tensorBase.py:37-278).

Parameters are plain dicts of tensors in the JAX package's layout: a linear
layer is {"w": [fan_in, fan_out], "b": [fan_out]} applied as x @ w + b.
Initialization mirrors `torch.nn.Linear` defaults (U(±1/√fan_in) for weight
and bias) with the final layer's bias zeroed where the reference does.
Init draws from a `torch.Generator` on the CPU; the trainer moves the
parameters to the device.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..core.encoding import positional_encoding


def uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    return torch.rand(shape, generator=gen, dtype=torch.float32) * (hi - lo) + lo


def linear_init(gen: torch.Generator, fan_in: int, fan_out: int, zero_bias: bool = False):
    bound = 1.0 / fan_in ** 0.5
    w = uniform(gen, (fan_in, fan_out), -bound, bound)
    b = torch.zeros(fan_out) if zero_bias else uniform(gen, (fan_out,), -bound, bound)
    return {"w": w, "b": b}


def linear(p, x):
    return x @ p["w"] + p["b"]


def mlp_init(gen: torch.Generator, dims: Sequence[int], zero_last_bias: bool = False):
    """Init a ReLU MLP with layer dims [d0, d1, ..., dn]."""
    n = len(dims) - 1
    return [
        linear_init(gen, dims[i], dims[i + 1], zero_bias=zero_last_bias and i == n - 1)
        for i in range(n)
    ]


def mlp_apply(layers, x):
    for i, p in enumerate(layers):
        x = linear(p, x)
        if i < len(layers) - 1:
            x = torch.relu(x)
    return x


def init_shading(gen, mode, app_dim, view_pe, fea_pe, pos_pe, featureC):
    if mode == "MLP_Fea":
        in_c = 2 * view_pe * 3 + 2 * fea_pe * app_dim + 3 + app_dim
        return {"mlp": mlp_init(gen, [in_c, featureC, featureC, 3], zero_last_bias=True)}
    if mode in ("MLP_Fea_TimeEmbedding", "MLP_Fea_late_view"):
        in_c = 2 * fea_pe * app_dim + app_dim
        if mode == "MLP_Fea_late_view":
            in_c += 2 * 10 * 3 + 3 + 2 * 8 * 1 + 1
        in_view = 2 * view_pe * 3 + 3
        return {
            "mlp": mlp_init(gen, [in_c, featureC, featureC]),
            "mlp_view": mlp_init(gen, [featureC + in_view, 3], zero_last_bias=True),
        }
    if mode == "MLP_Fea_woView":
        in_c = 2 * view_pe * 3 + 2 * fea_pe * app_dim + app_dim
        return {"mlp": mlp_init(gen, [in_c, featureC, featureC, 3], zero_last_bias=True)}
    if mode == "MLP_PE":
        in_c = (3 + 2 * view_pe * 3) + (3 + 2 * pos_pe * 3) + app_dim
        return {"mlp": mlp_init(gen, [in_c, featureC, featureC, 3], zero_last_bias=True)}
    if mode == "MLP":
        in_c = (3 + 2 * view_pe * 3) + app_dim
        return {"mlp": mlp_init(gen, [in_c, featureC, featureC, 3], zero_last_bias=True)}
    if mode == "RGB":
        if app_dim != 3:
            raise ValueError("shading mode RGB needs app_dim 3")
        return {}
    raise ValueError(f"Unrecognized shading mode {mode}")


def apply_shading(params, mode, view_pe, fea_pe, pos_pe, pts, viewdirs, feats, time):
    """Dispatch matching reference forward passes (tensorBase.py:101-278)."""
    if mode == "RGB":
        return feats

    if mode == "MLP_Fea":
        indata = [feats, viewdirs]
        if fea_pe > 0:
            indata.append(positional_encoding(feats, fea_pe))
        if view_pe > 0:
            indata.append(positional_encoding(viewdirs, view_pe))
        return torch.sigmoid(mlp_apply(params["mlp"], torch.cat(indata, -1)))

    if mode in ("MLP_Fea_TimeEmbedding", "MLP_Fea_late_view"):
        indata = [feats]
        if fea_pe > 0:
            indata.append(positional_encoding(feats, fea_pe))
        vd = viewdirs
        if mode == "MLP_Fea_late_view":
            vd = viewdirs.detach()  # reference detaches viewdirs here
            indata += [pts, positional_encoding(pts, 10), time, positional_encoding(time, 8)]
        indata_view = [vd]
        if view_pe > 0:
            indata_view.append(positional_encoding(vd, view_pe))
        inter = torch.relu(mlp_apply(params["mlp"], torch.cat(indata, -1)))
        view_in = torch.cat([inter] + indata_view, -1)
        return torch.sigmoid(mlp_apply(params["mlp_view"], view_in))

    if mode == "MLP_Fea_woView":
        indata = [feats]
        if fea_pe > 0:
            indata.append(positional_encoding(feats, fea_pe))
        return torch.sigmoid(mlp_apply(params["mlp"], torch.cat(indata, -1)))

    if mode == "MLP_PE":
        # raw pts is part of in_c at init; the reference's forward omits it
        # and crashes on a channel mismatch (tensorBase.py:165-199) — the JAX
        # package's fix, kept
        indata = [feats, viewdirs, pts]
        if pos_pe > 0:
            indata.append(positional_encoding(pts, pos_pe))
        if view_pe > 0:
            indata.append(positional_encoding(viewdirs, view_pe))
        return torch.sigmoid(mlp_apply(params["mlp"], torch.cat(indata, -1)))

    if mode == "MLP":
        indata = [feats, viewdirs]
        if view_pe > 0:
            indata.append(positional_encoding(viewdirs, view_pe))
        return torch.sigmoid(mlp_apply(params["mlp"], torch.cat(indata, -1)))

    raise ValueError(f"Unrecognized shading mode {mode}")
