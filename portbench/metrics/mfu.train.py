"""The training step's share of the card's float32 peak: the recipe's
operations a step (portbench/lib/flops.train_step_ops, from the
configuration's shapes) over the untraced steps' wall time a step times
67 TFLOP/s, the H100 SXM's float32 rate outside the tensor cores (the port
runs its matmuls in float32 with TF32 off; the card's power limit is
printed beside each measurement)."""

from portbench.lib.flops import FP32_FLOP_PER_S, train_step_ops

UNIT = "%"
LAYER = "step: train/step.py"
MOVES = "train_rays_per_s"
BETTER = "higher"


def read(run):
    if run.kind != "train" or run.unit_s <= 0 or run.stretch is None:
        return None
    return 100.0 * train_step_ops(run.recipe) / (run.unit_s * FP32_FLOP_PER_S)
