"""Host-side training schedules: per-group learning rates and the ray
sampler (port of rodynrf_tpu/train/schedule.py without the upsample part,
which comes with the upsample slice).

Replicates the reference's learning-rate state machine (reference:
train.py:924-1009 setup, 2350-2351 per-step decay, 2608-2610 the half-time
pose/focal freeze) as per-iteration learning rates that the train step
writes into its optimizer groups.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np


@dataclass
class LrSchedule:
    """Mutable host state for all four learning-rate groups."""

    lr_init: float  # spatial (plane/line) lr, args.lr_init
    lr_basis: float  # network lr, args.lr_basis
    lr_factor: float  # per-iter exp decay (train.py:926-930)
    n_iters: int
    upsamp_list: List[int]
    optimize_poses: bool
    optimize_focal: bool
    lr_pose_init: float = 3e-3  # (train.py:992)
    lr_pose_end: float = 1e-5

    def __post_init__(self):
        self.main_mult = 1.0
        self.lr_pose = self.lr_pose_init if self.optimize_poses else 0.0
        # focal optimizer starts at lr 0 and only activates at the
        # upsamp_list[3] reset (train.py:1003, 2594-2595)
        self.lr_focal = 0.0
        span = max(self.n_iters // 2 - self.upsamp_list[-1], 1)
        self.pose_gamma = (self.lr_pose_end / self.lr_pose_init) ** (1.0 / span)

    def scalars(self, iteration: int) -> dict:
        """lr values in effect for this iteration's update."""
        return {
            "lr_spatial": self.lr_init * self.main_mult,
            "lr_network": self.lr_basis * self.main_mult,
            "lr_pose": self.lr_pose,
            "lr_focal": self.lr_focal,
        }

    def after_step(self, iteration: int):
        """Post-step decay (train.py:2350-2351 main, 2322/2325 schedulers)."""
        self.main_mult *= self.lr_factor
        if self.optimize_poses:
            self.lr_pose *= self.pose_gamma
        if self.optimize_focal:
            self.lr_focal *= self.pose_gamma
        if iteration > self.n_iters // 2:
            # (train.py:2608-2610; reference crashes here when
            # optimize_poses=0 — fixed by just zeroing our scalars)
            self.lr_pose = 0.0
            self.lr_focal = 0.0


class PermutationSampler:
    """Shuffled epoch sampler (reference: train.py:81-93 SimpleSampler)."""

    def __init__(self, total: int, batch: int, seed: int = 20211202):
        self.total = total
        self.batch = batch
        self.curr = total
        self.ids = None
        self.rng = np.random.default_rng(seed)

    def nextids(self) -> np.ndarray:
        self.curr += self.batch
        if self.curr + self.batch > self.total:
            self.ids = self.rng.permutation(self.total)
            self.curr = 0
        return self.ids[self.curr : self.curr + self.batch]
