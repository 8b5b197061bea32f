"""The harness's arithmetic against hand-computed values at tiny shapes."""

import time

import pytest

from portbench.lib import flops, trace
from portbench.lib.loops import Run, _window
from portbench.reference import model as M


def test_rate_is_all_work_over_all_time():
    run = Run(cell=None, seed=0, kind="train", recipe=None)
    calls = []

    def call():
        calls.append(1)
        time.sleep(0.01)

    _window(run, 0.2, call, 1024, 1, False, lambda: None)
    assert run.units == len(calls) >= 10
    assert run.work == 1024 * len(calls)
    # the rate counts every call and the whole window, the last call included
    assert run.window_s >= 0.2 and run.window_s >= 0.01 * len(calls)
    assert len(run.host_ms) == len(calls)
    assert run.unit_s == pytest.approx(run.window_s / len(calls))


def test_traced_window_profiles_once_even_past_its_end():
    run = Run(cell=None, seed=0, kind="render", recipe=None)
    _window(run, 0.01, lambda: time.sleep(0.05), 10, 1, True, lambda: None)
    # one untraced call, then the profiled call twice (device and host stretch)
    assert run.stretch is not None and run.stretch.units == 1 and run.units == 3
    assert run.host_stretch is not None and run.host_stretch.units == 1
    assert run.unit_s == pytest.approx(0.05, rel=0.5)


def test_union_and_idle_of_overlapping_kernels():
    spans = [("a", 0.0, 2.0), ("b", 1.0, 3.0), ("c", 5.0, 6.0), ("Memcpy HtoD", 5.5, 7.0)]
    st = trace.Stretch(units=2, kernels=spans,
                       host_ops=[("aten::mul", 2.5, 4.0), ("aten::add", 7.5, 9.5)],
                       start=0.0, end=10.0)
    assert st.busy_s() == pytest.approx(3.0 + 2.0)   # [0, 3] and [5, 7]
    assert st.launches == 3                           # the copy is not a launch
    gaps = trace.idle_gaps([(s, e) for _, s, e in spans], 0.0, 10.0)
    assert gaps == [(3.0, 5.0), (7.0, 10.0)]
    labels = trace.label_gaps(gaps, st.host_ops)
    # the second gap begins before aten::add: nothing was open on the host
    assert labels == {"aten::mul": pytest.approx(2.0), "host": pytest.approx(3.0)}
    b = trace.breakdown(st, st)
    assert b["device_ops"][0] == ["a", 2.0] or b["device_ops"][0][1] == 2.0
    assert sum(v for _, v in b["idle_gaps"]) == pytest.approx(5.0)


def test_device_stretch_lies_between_its_markers():
    acts = [("k2", 3.0, 4.0), ("marker", 0.0, 0.5), ("k1", 1.0, 2.5), ("marker", 6.0, 6.2)]
    st = trace.between_markers(acts, units=1)
    assert (st.start, st.end) == (0.5, 6.0)
    assert [k[0] for k in st.kernels] == ["k1", "k2"]
    assert st.busy_s() == pytest.approx(2.5)
    assert trace.between_markers(acts[:1], units=1).kernels == []


def _spec(grid=(8, 6, 4)):
    return M.FieldSpec(grid=grid, density_n_comp=(2, 1, 1), app_n_comp=(3, 1, 1), app_dim=4,
                       shading_mode="MLP_Fea", fea_pe=0, view_pe=0, pos_pe=0, featureC=5,
                       density_shift=0.0, fea2dense_act="relu", distance_scale=1.0,
                       ray_march_weight_thres=0.0, bf16=True)


def test_operation_counts_by_hand():
    s = _spec()
    # MLP_Fea with no encodings: [3 + 4, 5, 5, 3]
    shading = (2 * 7 * 5 + 5) + (2 * 5 * 5 + 5) + (2 * 5 * 3 + 3)
    assert flops.shading_ops(s) == shading
    # VM: (2+1+1 + 3+1+1) channels x 11, the density sum 4, the basis 2*5*4
    assert flops.static_eval_ops(s) == 9 * 11 + 4 + 40 + shading
    m = M.Model(static=s, dynamic=s, ray_type="ndc", near_far=(0, 1), n_samples=3,
                step_size=0.1, H=2, W=5, T=2)
    per = flops.static_eval_ops(s) + flops.dynamic_eval_ops(s) + flops.DUAL_COMPOSITE_OPS
    assert flops.render_frame_ops(m) == 2 * 5 * 3 * per


def test_plane_gradient_bound_by_hand():
    s = _spec()
    m = M.Model(static=s, dynamic=s, ray_type="ndc", near_far=(0, 1), n_samples=3,
                step_size=0.1, H=2, W=5, T=2)

    class R:
        model, batch_size, optimize_poses = m, 4, False

    want = 0.0
    for spec_evals, strides, chans in ((1, (1,), [5, 2, 2]), (4, (1, 2, 4), [7, 3, 3])):
        samples = 4 * 3 * spec_evals
        for o, (m0, m1) in enumerate(M.MAT_MODE):
            for st in strides:
                texels = -(-s.grid[m1] // st) * -(-s.grid[m0] // st)
                c = chans[o]
                nbytes = samples * (4 + 16 + 4 * c) + 2 * texels * c
                want += max(nbytes / 3.35e12, samples * 8 * c / 67e12)
    assert flops.plane_grad_bound_s(R) == pytest.approx(want)


def test_shares_from_a_run_by_hand(tiny_root):
    from portbench.lib.spec import all_metrics, load_cell, reference_recipe

    metrics = all_metrics(tiny_root)
    cell = load_cell("tiny.davis.train", tiny_root)
    run = Run(cell=cell, seed=0, kind="train", recipe=reference_recipe(cell.config, 0))
    run.unit_s, run.host_ms = 0.5, [400.0, 420.0]
    run.stretch = trace.Stretch(units=2, kernels=[
        ("void segreduce::zero_and_walk<x>", 0.0, 0.001), ("cub::DeviceRadixSortOnesweepKernel", 0.1, 0.102),
        ("at_cuda_detail::cub::DeviceRadixSortOnesweepKernel", 0.2, 0.3), ("gemm", 0.3, 0.6)],
        host_ops=[], start=0.0, end=1.0)
    assert metrics["entry_host_ms.train"].read(run) == pytest.approx(410.0)
    assert metrics["launches_per_step.train"].read(run) == pytest.approx(2.0)
    assert metrics["mfu.train"].read(run) == pytest.approx(
        100 * flops.train_step_ops(run.recipe) / (0.5 * 67e12))
    assert metrics["table_grad_roofline.train"].read(run) == pytest.approx(
        100 * flops.plane_grad_bound_s(run.recipe) * 2 / 0.003)
    # busy 0.001 + 0.002 + 0.4 over the stretch's 1.0 s
    assert metrics["device_idle_share.train"].read(run) == pytest.approx(100 * (1 - 0.403))
    assert metrics["peak_gib.train"].read(run) is None   # nothing to read
    assert metrics["launches_per_chunk.render"].read(run) is None
