"""Distortion loss (DVGO / mip-NeRF-360) in O(S) prefix-sum form (port of
rodynrf_tpu/ops/distortion.py; the reference calls the CUDA package
torch_efficient_distloss.flatten_eff_distloss, train.py:19-23)."""

from __future__ import annotations

import torch


def eff_distloss(w: torch.Tensor, m: torch.Tensor, interval) -> torch.Tensor:
    """Distortion loss summed over rays: w [R, S] weights, m [R, S] sorted
    midpoints, interval scalar or [R, S]. Equals
    Σ_r [ Σ_{i<j} 2 w_i w_j (m_j - m_i) + (1/3) Σ_i interval w_i² ]."""
    loss_uni = (1.0 / 3.0) * torch.sum(interval * w * w)
    wm = w * m
    w_cumsum = torch.cumsum(w, dim=-1)
    wm_cumsum = torch.cumsum(wm, dim=-1)
    loss_bi_terms = wm[:, 1:] * w_cumsum[:, :-1] - w[:, 1:] * wm_cumsum[:, :-1]
    return 2.0 * torch.sum(loss_bi_terms) + loss_uni
