"""The numbers that decide `correct`, each against its limit.

Training (the first three steps of the timed object, against the plain
reference run from the same parameters, batches and draws):
  loss_gap.<k>  |loss_k - ref| / |ref| of step k's total loss (k = 1, 2, 3)
  grad_gap      the worst leaf's | |g| - |g_ref| | / max(|g_ref|, median
                leaf's |g_ref|), the program's g worked out from its Adam
                state after step 1 (exp_avg / (1 - beta1))
  change_gap    the same of each leaf's change after step 3, over the leaves
                whose reference gradient is at least 1e-3 of the median
                leaf's (the others move under Adam by round-off alone)
Rendering (sampled rays of frames rendered in the window):
  rgb_gap       max |program - reference| over rgb, rgb_s, rgb_d, blending
  depth_gap     max |program - reference| of depth, depth_s, depth_d over
                the reference's median |depth|
  warp_gap      the same of delta_xyz over its median
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

GRAD_FLOOR = 1e-3  # of the median leaf's reference gradient norm


def _norm(a) -> float:
    return float(np.linalg.norm(np.asarray(a, np.float64).ravel()))


def leaf_gaps(prog: Dict, ref: Dict, keep=None) -> Dict:
    """{leaf: | |prog| - |ref| | / max(|ref|, the median leaf's |ref|)}."""
    names = [k for k in ref if keep is None or k in keep]
    rn = {k: _norm(ref[k]) for k in names}
    med = float(np.median(list(rn.values())))
    return {k: abs(_norm(prog[k]) - rn[k]) / max(rn[k], med, 1e-30) for k in names}


def worst_leaf_gap(prog: Dict, ref: Dict, keep=None) -> float:
    return max(leaf_gaps(prog, ref, keep).values())


def _kept(ref_grads: Dict) -> set:
    """The leaves whose reference gradient is at least GRAD_FLOOR of the
    median leaf's."""
    gn = {k: _norm(v) for k, v in ref_grads.items()}
    floor = GRAD_FLOOR * float(np.median(list(gn.values())))
    return {k for k, v in gn.items() if v >= floor}


def widest_leaves(grads, ref_grads, change, ref_change, n: int = 3) -> Dict[str, list]:
    """The n leaves with the widest gradient and change gaps: [gap, leaf]."""
    top = lambda d: [[v, "/".join(map(str, k))] for v, k in
                     sorted(((v, k) for k, v in d.items()), reverse=True)[:n]]
    return {"grad": top(leaf_gaps(grads, ref_grads)),
            "change": top(leaf_gaps(change, ref_change, _kept(ref_grads)))}


def train_numbers(losses: List[float], ref_losses: List[float], grads: Dict, ref_grads: Dict,
                  change: Dict, ref_change: Dict) -> Dict[str, float]:
    out = {f"loss_gap.{k + 1}": abs(a - b) / max(abs(b), 1e-30)
           for k, (a, b) in enumerate(zip(losses, ref_losses))}
    out["grad_gap"] = worst_leaf_gap(grads, ref_grads)
    out["change_gap"] = worst_leaf_gap(change, ref_change, keep=_kept(ref_grads))
    return out


def render_numbers(prog: Dict[str, np.ndarray], ref: Dict[str, np.ndarray]) -> Dict[str, float]:
    def gap(keys, scale=None):
        d = max(float(np.max(np.abs(prog[k].astype(np.float64) - ref[k]))) for k in keys)
        if scale is None:
            return d
        s = float(np.median(np.abs(np.concatenate([ref[k].ravel() for k in scale]))))
        return d / max(s, 1e-30)

    depth = ("depth", "depth_s", "depth_d")
    return {"rgb_gap": gap(("rgb", "rgb_s", "rgb_d", "blending")),
            "depth_gap": gap(depth, depth), "warp_gap": gap(("delta_xyz",), ("delta_xyz",))}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number within its limit, and every limit read (a number that is
    missing or not finite fails)."""
    return all(k in numbers and np.isfinite(numbers[k]) and numbers[k] <= lim
               for k, lim in limits.items())


def report(numbers: Dict[str, float], limits: Dict[str, float]) -> Dict[str, list]:
    """{name: [number, limit]} in the limits' order, then any number without one."""
    out = {k: [numbers.get(k, float("nan")), v] for k, v in limits.items()}
    out.update({k: [v, None] for k, v in numbers.items() if k not in limits})
    return out
