"""The plane-table gradient's share of its roofline: the least time of a
step's plane-table gradients (portbench/lib/flops.plane_grad_bound_s, from
the configuration's shapes: samples with a gradient, channels, texels)
over the device time of the kernels that compute them in the traced
stretch, per step. Those kernels are csrc/segreduce.cuh's (names with
"segreduce") and the port's CUB radix sort (names with "DeviceRadixSort"
outside PyTorch's own "at_cuda_detail" copy of CUB), launched by
ops/coalesced.py (csrc/coalesce.cu) and ops/segsum.py (csrc/segsum.cu)."""

from portbench.lib.flops import plane_grad_bound_s

UNIT = "%"
LAYER = "kernels: csrc/coalesce.cu, csrc/segsum.cu"
MOVES = "train_rays_per_s"
BETTER = "higher"


def is_table_grad(name: str) -> bool:
    return "segreduce" in name or ("DeviceRadixSort" in name and "at_cuda_detail" not in name)


def read(run):
    st = run.stretch
    if run.kind != "train" or st is None:
        return None
    busy = st.kernel_seconds(is_table_grad)
    if busy <= 0:
        return None
    return 100.0 * plane_grad_bound_s(run.recipe) * st.units / busy
