"""Optical-flow preprocessing with RAFT on the card (port of
scripts/generate_flow.py; reference scripts/generate_flow.py:91-169).

    python -m rodynrf_tpu_torch.preprocess flow --dataset_path <dir> --model raft-things.pth

For each adjacent pair of images/*.png: both frames resized with cv2's
INTER_AREA to --long_side on the longer side and edge-padded to multiples of
8, RAFT run in both directions as one batch of 2 (--iters refinements), the
padding cropped, the flows resized to the frames' size (data/llff.
resize_flow), the forward/backward consistency masks computed, and
flow/%0Nd_{fwd,bwd}.npz (flow, mask) and flow_png/%0Nd_{fwd,bwd}.png
written. `main(argv, device="cuda")` runs on the card and refuses without
one unless the caller passes device="cpu".
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np
import torch
import torch.nn.functional as F

from ..data.imageio import read_image_rgb, resize_area, write_png
from ..data.llff import resize_flow
from ..train.step import check_device
from ..utils.flow_viz import flow_to_image
from .flow_utils import compute_fwdbwd_mask
from .raft import load_raft


def parse_args(argv=None):
    parser = argparse.ArgumentParser(prog="python -m rodynrf_tpu_torch.preprocess flow")
    parser.add_argument("--dataset_path", type=str, required=True)
    parser.add_argument("--model", type=str, required=True, help="RAFT torch checkpoint")
    parser.add_argument("--iters", type=int, default=20)
    parser.add_argument("--long_side", type=int, default=768)
    parser.add_argument("--zfill", type=int, default=5)
    return parser.parse_args(argv)


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None, device="cuda") -> dict:
    """Write the flow sidecars of a scene. Returns the seconds of each
    pair's RAFT forward (synchronised) and of each whole pair, and whether
    every flow is finite."""
    args = parse_args(argv)
    dev = check_device(device)
    model = load_raft(args.model, dev)
    images = sorted(glob.glob(os.path.join(args.dataset_path, "images", "*.png"))
                    + glob.glob(os.path.join(args.dataset_path, "images", "*.jpg")))
    out_path = os.path.join(args.dataset_path, "flow")
    img_path = os.path.join(args.dataset_path, "flow_png")
    os.makedirs(out_path, exist_ok=True)
    os.makedirs(img_path, exist_ok=True)

    H0, W0 = read_image_rgb(images[0]).shape[:2]
    scale = args.long_side / max(H0, W0)
    Hs, Ws = int(round(H0 * scale)), int(round(W0 * scale))
    ph, pw = (8 - Hs % 8) % 8, (8 - Ws % 8) % 8

    def load(path):  # [3, Hs + ph, Ws + pw] in 0-255, edge-padded
        img = torch.from_numpy(read_image_rgb(path)).to(dev).float()
        img = resize_area(img, (Ws, Hs)).permute(2, 0, 1)
        return F.pad(img[None], (0, pw, 0, ph), mode="replicate")[0]

    z = args.zfill
    report = {"raft_s": [], "pair_s": [], "finite": True, "size": [Hs, Ws]}
    nxt = load(images[0])
    for i in range(len(images) - 1):
        t0 = time.perf_counter()
        cur, nxt = nxt, load(images[i + 1])
        sync(dev)
        t1 = time.perf_counter()
        with torch.inference_mode():
            flows = model(torch.stack([cur, nxt]), torch.stack([nxt, cur]), iters=args.iters)
        sync(dev)
        report["raft_s"].append(time.perf_counter() - t1)
        flows = flows[:, :, :Hs, :Ws].permute(0, 2, 3, 1).cpu().numpy()
        flow_fwd, flow_bwd = (resize_flow(np.ascontiguousarray(f), H0, W0) for f in flows)
        report["finite"] &= bool(np.isfinite(flow_fwd).all() and np.isfinite(flow_bwd).all())
        masks = compute_fwdbwd_mask(torch.from_numpy(flow_fwd).to(dev),
                                    torch.from_numpy(flow_bwd).to(dev))
        mask_fwd, mask_bwd = (m.cpu().numpy() for m in masks)
        np.savez(os.path.join(out_path, f"%0{z}d_fwd.npz" % i), flow=flow_fwd, mask=mask_fwd)
        np.savez(os.path.join(out_path, f"%0{z}d_bwd.npz" % (i + 1)), flow=flow_bwd,
                 mask=mask_bwd)
        write_png(os.path.join(img_path, f"%0{z}d_fwd.png" % i), flow_to_image(flow_fwd))
        write_png(os.path.join(img_path, f"%0{z}d_bwd.png" % (i + 1)), flow_to_image(flow_bwd))
        report["pair_s"].append(time.perf_counter() - t0)
        print(f"[{i + 1}/{len(images) - 1}] flow pair done")
    return report
