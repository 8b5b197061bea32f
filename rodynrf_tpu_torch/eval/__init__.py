"""Evaluation: metrics, test-set evaluation, novel-view paths, mesh export."""
from .metrics import psnr, rgb_ssim, rgb_lpips, visualize_depth_numpy
from .evaluation import evaluate, export_poses_bounds, write_video
from .paths import generate_path, generate_follow_spiral, evaluation_path
