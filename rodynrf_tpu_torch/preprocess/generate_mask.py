"""Motion-mask preprocessing on the card (port of scripts/generate_mask.py;
reference scripts/generate_mask.py:150-302).

    python -m rodynrf_tpu_torch.preprocess mask --dataset_path <dir>

Reads the flow sidecars (run the flow command first) and writes
epipolar_error_png/%0Nd.png from the Sampson error of an LMedS fundamental
matrix (preprocess/motion_masks.py). `main(argv, device="cuda")` runs on the
card and refuses without one unless the caller passes device="cpu".
"""

from __future__ import annotations

import argparse

from .motion_masks import generate_motion_masks


def parse_args(argv=None):
    parser = argparse.ArgumentParser(prog="python -m rodynrf_tpu_torch.preprocess mask")
    parser.add_argument("--dataset_path", type=str, required=True)
    parser.add_argument("--zfill", type=int, default=5)
    return parser.parse_args(argv)


def main(argv=None, device="cuda") -> dict:
    """Write the motion masks of a scene; returns generate_motion_masks's
    report (seconds per frame, mask shares, F accepted per map)."""
    args = parse_args(argv)
    return generate_motion_masks(args.dataset_path, zfill=args.zfill, device=device)
