"""Fixed-bucket sample compaction: per-ray top-K selection (port of
rodynrf_tpu/ops/compaction.py).

The reference skips its appearance MLP on samples failing `app_mask =
weight > rm_weight_mask_thre` (reference: tensorBase.py:774-804), a
data-dependent boolean compaction. Here a fixed per-ray bucket keeps the K
highest-weight samples of each ray, evaluates appearance only on those and
zero-fills the rest: the reference's result whenever a ray's
above-threshold count is <= K.

Both directions are flat row operations, each the other's backward:

  compact_rows  [R,S,C] -> [R,K,C]   forward: row gather
                                     backward: row scatter into zeros
  expand_rows   [R,K,C] -> [R,S,C]   forward: row scatter into zeros
                                     backward: row gather

topk yields per-row unique sample indices, so the flattened row indices are
globally unique and the scatter is a plain copy (no accumulation).
"""

from __future__ import annotations

import torch


def topk_select(weight: torch.Tensor, k: int, thres: float):
    """Indices of the K highest-weight samples per ray, weight [R, S] (the
    per-field volume-rendering weight, tensorBase.py:774). Returns (idx
    [R, K] int64, keep [R, K] in weight's dtype) where keep applies the
    reference's `weight > thres` zeroing in compacted space. The selection
    is detached, as the reference's boolean mask is."""
    vals, idx = torch.topk(weight.detach(), k, dim=1)
    return idx, (vals > thres).to(weight.dtype)


def _flat_idx(idx: torch.Tensor, s: int) -> torch.Tensor:
    # [R, K] per-row sample indices -> [R*K] row indices into [R*S, C]
    r = idx.shape[0]
    return (torch.arange(r, dtype=idx.dtype, device=idx.device)[:, None] * s + idx).reshape(-1)


def _gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    r, s, c = x.shape
    return x.reshape(r * s, c).index_select(0, _flat_idx(idx, s)).reshape(r, idx.shape[1], c)


def _scatter_rows(x_k: torch.Tensor, idx: torch.Tensor, s: int) -> torch.Tensor:
    r, k, c = x_k.shape
    out = x_k.new_zeros((r * s, c))
    out.index_copy_(0, _flat_idx(idx, s), x_k.reshape(r * k, c))
    return out.reshape(r, s, c)


class _CompactRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.s = x.shape[1]
        return _gather_rows(x, idx)

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        return _scatter_rows(ct.contiguous(), idx, ctx.s), None


class _ExpandRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_k, idx, s):
        ctx.save_for_backward(idx)
        return _scatter_rows(x_k.contiguous(), idx, s)

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        return _gather_rows(ct.contiguous(), idx), None, None


def compact_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows idx [R, K] of x [R, S, C] -> [R, K, C] (bit-exact)."""
    return _CompactRows.apply(x, idx)


def expand_rows(x_k: torch.Tensor, idx: torch.Tensor, s: int) -> torch.Tensor:
    """x_k [R, K, C] zero-filled into [R, S, C] at positions idx [R, K]."""
    return _ExpandRows.apply(x_k, idx, s)
