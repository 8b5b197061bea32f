from .sampling import sample_xyz, sample_ray_ndc, sample_ray_world, sample_ray_contracted
from .pipeline import eval_static_field, eval_dynamic_field, FieldEval
from .flow import induce_flow, render_3d_point
