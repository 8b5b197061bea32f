"""Carry parameters between the JAX package and the port.

The JAX `Trainer.params` pytree, as nested dicts/lists of numpy arrays
({"static", "dynamic", "pose", "fov"}), maps one to one onto the port's
parameter tree: the same keys, the same list order, the same layouts
([C, H, W] planes, [C, L] lines, [fan_in, fan_out] linear weights).
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device):
    """Nested dicts/lists of numpy arrays -> the port's parameters: f32 leaf
    tensors on `device` that require grad."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    return torch.tensor(np.asarray(tree, np.float32), device=device).requires_grad_(True)


def params_to_numpy(tree):
    """The port's parameters (or a gradient tree of the same shape) ->
    nested dicts/lists of numpy arrays (numpy leaves pass through)."""
    if isinstance(tree, dict):
        return {k: params_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_to_numpy(v) for v in tree]
    if isinstance(tree, np.ndarray):
        return tree
    return tree.detach().cpu().numpy()
