"""Sinusoidal positional encoding (port of rodynrf_tpu/core/encoding.py).

For input of last-dim D and F frequency bands the output is
``concat([sin(x_d * 2^f) for d,f in row-major (d,f) order], [cos(...)])``
with shape ``(..., 2*F*D)`` (reference: models/tensorBase.py:13-19).
"""

from __future__ import annotations

import torch


def positional_encoding(x: torch.Tensor, freqs: int) -> torch.Tensor:
    """Encode ``x`` (..., D) into (..., 2*freqs*D) sin/cos features."""
    freq_bands = 2.0 ** torch.arange(freqs, dtype=x.dtype, device=x.device)
    pts = (x[..., None] * freq_bands).reshape(*x.shape[:-1], freqs * x.shape[-1])
    return torch.cat([torch.sin(pts), torch.cos(pts)], dim=-1)
