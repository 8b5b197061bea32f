"""Preprocessing of a video into the priors RoDynRF trains on (port of
rodynrf_tpu/preprocess/ and scripts/generate_{flow,depth,mask}.py): RAFT
optical flow with its consistency masks, DPT disparity, and epipolar motion
masks, each a command of `python -m rodynrf_tpu_torch.preprocess`."""

from .flow_utils import compute_fwdbwd_mask, warp_flow
from .motion_masks import (
    compute_sampson_error,
    epipolar_error_map,
    generate_motion_masks,
    get_uv_grid,
    motion_mask_for_frame,
)


def main(argv, device="cuda"):
    """Dispatch `flow | depth | mask` and its arguments to that command's
    main; returns its report."""
    from . import generate_depth, generate_flow, generate_mask

    commands = {"flow": generate_flow.main, "depth": generate_depth.main,
                "mask": generate_mask.main}
    if not argv or argv[0] not in commands:
        raise SystemExit(f"usage: python -m rodynrf_tpu_torch.preprocess "
                         f"{{{','.join(commands)}}} --dataset_path DIR ...")
    return commands[argv[0]](argv[1:], device)
