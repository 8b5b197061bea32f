"""Monocular-depth preprocessing with DPT on the card (port of
scripts/generate_depth.py; reference scripts/generate_DPT.py:39-160).

    python -m rodynrf_tpu_torch.preprocess depth --dataset_path <dir> --model dpt_large-midas-2f21e586.pt

Each frame of images/ is resized with cv2's INTER_CUBIC to its lower-bound
size (smaller side 384, both sides multiples of 32, aspect kept), run
through DPT, and the inverse depth resized back with INTER_CUBIC:
<out_dir>/%0Nd.npy, and a 16-bit PNG of it stretched to 0-65535 in
<out_dir>_png/. `main(argv, device="cuda")` runs on the card and refuses
without one unless the caller passes device="cpu".
"""

from __future__ import annotations

import argparse
import glob
import os
import time

import numpy as np
import torch

from ..data.imageio import read_frames, resize_cubic, write_png
from ..device import check_device
from .dpt import DPT_LARGE, load_dpt
from .generate_flow import sync


def lower_bound_size(H: int, W: int, target: int = 384, mult: int = 32):
    """Smaller side >= target, aspect kept, both multiples of `mult`
    (reference: generate_DPT.py:55-75, Resize lower_bound)."""
    scale = target / min(H, W)
    h = max(target, int(np.ceil(H * scale / mult) * mult))
    w = max(target, int(np.ceil(W * scale / mult) * mult))
    return h, w


def parse_args(argv=None):
    parser = argparse.ArgumentParser(prog="python -m rodynrf_tpu_torch.preprocess depth")
    parser.add_argument("--dataset_path", type=str, required=True)
    parser.add_argument("--model", type=str, required=True, help="DPT torch checkpoint")
    parser.add_argument("--out_dir", type=str, default="disp")
    parser.add_argument("--zfill", type=int, default=3)
    return parser.parse_args(argv)


def main(argv=None, device="cuda", cfg=DPT_LARGE) -> dict:
    """Write the disparity sidecars of a scene. Returns the seconds of
    reading the frames (one batch, decoded on the command's device), of each
    frame's DPT forward (synchronised) and whether every map is finite.
    (`cfg` is the checkpoint's DPTConfig: DPT-Large, or a narrow one in the
    CPU rehearsal.)"""
    args = parse_args(argv)
    dev = check_device(device)
    model = load_dpt(args.model, dev, cfg)
    images = sorted(glob.glob(os.path.join(args.dataset_path, "images", "*")))
    out_path = os.path.join(args.dataset_path, args.out_dir)
    png_path = os.path.join(args.dataset_path, args.out_dir + "_png")
    os.makedirs(out_path, exist_ok=True)
    os.makedirs(png_path, exist_ok=True)

    z = args.zfill
    t0 = time.perf_counter()
    frames = read_frames(images, dev)  # one batch, each frame decoded once
    sync(dev)
    report = {"read_s": time.perf_counter() - t0, "dpt_s": [], "finite": True}
    for idx, frame in enumerate(frames):
        img = frame.float() / 255.0
        H, W = img.shape[:2]
        h, w = lower_bound_size(H, W)
        report["size"] = [h, w]
        inp = resize_cubic(img, (w, h)).permute(2, 0, 1)[None]
        sync(dev)
        t0 = time.perf_counter()
        with torch.inference_mode():
            pred = model(inp)[0]
        sync(dev)
        report["dpt_s"].append(time.perf_counter() - t0)
        disp = resize_cubic(pred, (W, H)).cpu().numpy()
        report["finite"] &= bool(np.isfinite(disp).all())
        np.save(os.path.join(out_path, f"%0{z}d.npy" % idx), disp)
        d16 = (65535 * (disp - disp.min()) / (np.ptp(disp) + 1e-8)).astype(np.uint16)
        write_png(os.path.join(png_path, f"%0{z}d.png" % idx), d16)
        print(f"[{idx + 1}/{len(images)}] depth done")
    return report
