"""Rendering's share of the card's float32 peak: a frame's forward
operations (portbench/lib/flops.render_frame_ops, from the configuration's
shapes) over the untraced frames' wall time a frame times 67 TFLOP/s."""

from portbench.lib.flops import FP32_FLOP_PER_S, render_frame_ops

UNIT = "%"
LAYER = "renderer: render/renderer.py, render/pipeline.py, fields/"
MOVES = "render_rays_per_s"
BETTER = "higher"


def read(run):
    if run.kind != "render" or run.unit_s <= 0 or run.stretch is None:
        return None
    return 100.0 * render_frame_ops(run.model) / (run.unit_s * FP32_FLOP_PER_S)
