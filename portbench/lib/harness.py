"""One run of one cell: the loop its traffic names, the metrics, and the
result line with every compared number beside its limit."""

from __future__ import annotations

import sys
from pathlib import Path
from typing import Dict, Tuple

import torch

from . import compare, trace
from .loops import LOOPS, Run
from .spec import ROOT, load_cell

# top-level module names a run may not hold: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "rodynrf_tpu")


def forbidden_loaded(modules=None):
    """The forbidden top-level names among the loaded modules, compared whole
    (so rodynrf_tpu_torch passes)."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def device_info(device, run: Run) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda":
        out = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1}
    else:
        out = {"platform": "cpu", "kind": "cpu", "count": 1}
    out["memory_peak_bytes"] = int(run.peak_bytes)
    if run.stretch is not None:
        out["busy_s"] = run.stretch.busy_s()
        out["window_s"] = run.stretch.end - run.stretch.start
    return out


def execute(cell_name: str, seed: int, seconds: float, trace_on: bool, device, t_start: float,
            root: Path = ROOT, matmul: str = "float32") -> Tuple[dict, Dict[str, list], Run]:
    """(the result object, {number: [value, limit]}, the run)."""
    cell = load_cell(cell_name, root)
    run = LOOPS[cell.traffic["loop"]](cell, seed, seconds, trace_on, device, t_start, matmul)
    correct = compare.judge(run.numbers, cell.limits)
    if trace_on:
        metrics = {}
        for name, mod in cell.metrics.items():
            v = mod.read(run)
            if v is not None:
                metrics[name] = {"value": float(v), "unit": mod.UNIT}
    else:
        metrics = {cell.rate_metric: {"value": run.work / run.window_s,
                                      "unit": cell.traffic["rate_unit"]},
                   "setup_s": {"value": run.setup_s, "unit": "s"}}
    checks = compare.report(run.numbers, cell.limits)
    compared = int(cell.traffic.get("compared_steps", 0)) or run.units
    result = {"correct": bool(correct), "attempted": run.units,
              "failed": 0 if correct else compared, "metrics": metrics,
              "device": device_info(device, run)}
    if run.stretch is not None:
        result["breakdown"] = trace.breakdown(run.stretch, run.host_stretch)
    result["checks"] = checks
    return result, checks, run
