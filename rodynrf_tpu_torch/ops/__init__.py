from .grid_sample import (
    sample_plane,
    sample_line,
    sample_vm,
    sample_vm_sum,
    sample_vm_sum_fused,
    vm_axis_sum,
    sample_grid3d,
    resize_bilinear_align_corners,
    resize_line_align_corners,
    MAT_MODE,
    VEC_MODE,
)
from .coalesced import planes_sample, merged_sample, coalesce_table_grad, coalesce_table_grad_plain
from .segsum import (segment_rows_sum, sorted_segment_rows_sum, segment_rows_sum_plain,
                     segment_rows_sum_factored, segment_rows_sum_factored_plain)
from .fused_vm import pack_vm, sample_vm_fused, PackedVM
from .compositing import raw2alpha, raw2outputs, RenderOutputs
from .distortion import eff_distloss
from .regularizers import tv_loss_plane, tv_loss_line, tv_loss_vm, vm_outer_l1, line_orthogonality
