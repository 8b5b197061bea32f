"""Operation and byte counts of the recipes' work, from the configuration's
shapes alone (the reference's widths), and the card's published peaks.

The counts are of the work the recipe needs, not of how the program splits
it: every field evaluation once (no recomputation), a backward twice its
forward, the plane-table gradient written once a step.
"""

from __future__ import annotations

from ..reference import model as M

# NVIDIA H100 SXM data sheet, dense, at the 700 W limit
FP32_FLOP_PER_S = 67e12     # float32 outside the tensor cores (TF32 is off)
HBM_BYTES_PER_S = 3.35e12

# per channel of a VM sample: 4 products and 3 sums of the bilinear plane
# value, 2 and 1 of the linear line value, 1 product of the two
VM_OPS_PER_CHANNEL = 11
# per sample: the dual compositor (both alphas, transmittances, the mixed
# weights, rgb and depth maps), the static-side and the dynamic-side subsets
DUAL_COMPOSITE_OPS, SIDE_COMPOSITE_OPS = 48, 16
BACKWARD_FACTOR = 2.0  # a backward's operations over its forward's


def mlp_ops(dims) -> int:
    return sum(2 * a * b + b for a, b in zip(dims[:-1], dims[1:]))


def shading_ops(spec: M.FieldSpec) -> int:
    dims = M.shading_dims(spec.shading_mode, spec.app_dim, spec.view_pe, spec.fea_pe,
                          spec.pos_pe, spec.featureC)
    return sum(mlp_ops(d) for d in dims.values())


def static_eval_ops(spec: M.FieldSpec) -> int:
    """Forward operations of one static-field sample."""
    c = sum(spec.density_n_comp) + sum(spec.app_n_comp)
    return (VM_OPS_PER_CHANNEL * c + sum(spec.density_n_comp)
            + 2 * sum(spec.app_n_comp) * spec.app_dim + shading_ops(spec))


def dynamic_eval_ops(spec: M.FieldSpec) -> int:
    """Forward operations of one dynamic-field sample: the warp, three
    multiscale grids, the density and blending heads, the basis, shading."""
    n_s = len(M.DYN_STRIDES)
    c = (2 * sum(spec.density_n_comp) + sum(spec.app_n_comp)) * n_s
    warp = mlp_ops([17, 64, 30]) + mlp_ops([3 + 60 + 30, 64, 64, 3])
    heads = 2 * mlp_ops([M.head_in(spec), 64, 1])
    basis = 2 * sum(spec.app_n_comp) * n_s * spec.app_dim
    return warp + VM_OPS_PER_CHANNEL * c + heads + basis + shading_ops(spec)


SCENE_FLOW_OPS = mlp_ops([36, 64, 64, 64, 6])


def train_step_ops(recipe) -> float:
    """Operations of one training step: per ray and sample, the static
    field with a gradient in E (and F, G, FF, BB with pose optimisation),
    the dynamic field with a gradient in A, B, C, D, the scene flow at A's
    points, the compositors of A, B (dual), E, F, G (static side) and C, D
    (dynamic side); each forward and its backward."""
    m = recipe.model
    n_static = 5 if recipe.optimize_poses else 1
    n_side = 3 if recipe.optimize_poses else 1
    per_sample = (n_static * static_eval_ops(m.static) + 4 * dynamic_eval_ops(m.dynamic)
                  + SCENE_FLOW_OPS + 2 * DUAL_COMPOSITE_OPS + (n_side + 2) * SIDE_COMPOSITE_OPS)
    return recipe.batch_size * m.n_samples * per_sample * (1.0 + BACKWARD_FACTOR)


def render_frame_ops(model: M.Model) -> float:
    """Forward operations of one frame: every pixel's samples through both
    fields and the dual compositor."""
    per_sample = static_eval_ops(model.static) + dynamic_eval_ops(model.dynamic) \
        + DUAL_COMPOSITE_OPS
    return model.H * model.W * model.n_samples * per_sample


def plane_grad_bound_s(recipe, out_bytes: int = 2) -> float:
    """Least time of a step's plane-table gradients: per field, orientation
    and stride, each gradient-carrying sample's row id (4 B), corner weights
    (16 B) and feature cotangent (4 B a channel) read once, 8 operations a
    channel, the table's gradient ([channels, Hs, Ws] in the gather dtype)
    written once; the larger of bytes over the memory rate and operations
    over the float32 rate, summed."""
    m = recipe.model
    fields = (
        (m.static, 5 if recipe.optimize_poses else 1, (1,),
         [m.static.density_n_comp[o] + m.static.app_n_comp[o] for o in range(3)]),
        (m.dynamic, 4, M.DYN_STRIDES,
         [2 * m.dynamic.density_n_comp[o] + m.dynamic.app_n_comp[o] for o in range(3)]),
    )
    total = 0.0
    for spec, n_evals, strides, chans in fields:
        samples = recipe.batch_size * m.n_samples * n_evals
        for o in range(3):
            m0, m1 = M.MAT_MODE[o]
            for s in strides:
                texels = -(-spec.grid[m1] // s) * -(-spec.grid[m0] // s)
                c = chans[o]
                nbytes = samples * (4 + 16 + 4 * c) + texels * c * out_bytes
                total += max(nbytes / HBM_BYTES_PER_S, samples * 8 * c / FP32_FLOP_PER_S)
    return total
