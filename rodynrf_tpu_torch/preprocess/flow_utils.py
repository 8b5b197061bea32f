"""Flow post-processing: backward warping and forward/backward consistency
masks (port of rodynrf_tpu/preprocess/flow_utils.py; reference
scripts/generate_flow.py:50-88), on torch tensors so that they run where
the flow is. The warp is cv2's cubic remap with a zero border
(data/imageio.remap_cubic).
"""

from __future__ import annotations

import torch

from ..data.imageio import remap_cubic


def warp_flow(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """Backward-warp `img` [H, W(, C)] by `flow` [H, W, 2]: the value at
    p + flow(p), cubic, zero outside (reference: generate_flow.py:50-63)."""
    h, w = flow.shape[:2]
    grid = torch.stack(torch.meshgrid(torch.arange(w, dtype=torch.float32, device=flow.device),
                                      torch.arange(h, dtype=torch.float32, device=flow.device),
                                      indexing="xy"), -1)
    return remap_cubic(img, flow.float() + grid)


def compute_fwdbwd_mask(fwd_flow: torch.Tensor, bwd_flow: torch.Tensor):
    """Consistency masks ‖f + w(b)‖ < α1(‖f‖ + ‖w(b)‖) + α2 with α1 = α2 =
    0.5, for both directions (reference: generate_flow.py:65-88): bool
    [H, W] each."""
    alpha_1, alpha_2 = 0.5, 0.5

    def mask(a, b):
        b2a = warp_flow(b, a)
        err = torch.linalg.vector_norm(a + b2a, dim=-1)
        bound = alpha_1 * (torch.linalg.vector_norm(a, dim=-1)
                           + torch.linalg.vector_norm(b2a, dim=-1)) + alpha_2
        return err < bound

    return mask(fwd_flow, bwd_flow), mask(bwd_flow, fwd_flow)
