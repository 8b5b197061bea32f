"""Data parallelism over rays (rodynrf_tpu_torch/parallel/, the mesh path of
train/step.py and train/trainer.py) on the CPU: gloo ranks spawned by
`parallel.launch.run_ranks`, each importing only the port
(tests/torch_parallel_ranks.py).

- The host rules against the JAX package's: the sharded axis of a plane
  grid (`grid_sharded`), each rank's span of a batch (`process_span`), the
  device count and message for a batch that does not divide the devices,
  and the micro-batch count with the mesh factor.
- The gradient rule on its own (collectives.gather_rows): a term that flows
  through the gathered rows and a term every rank computes in full each
  come out once after the average.
- The flat bucket's global first-N rule (pipeline._flat_index with row
  offsets): two ranks' halves keep what one process keeps, with overflow.
- The train step on 2 ranks against the same step in one process (the same
  weights, batch and draws, golden_det, iteration 25): float64 losses to
  1e-12 relative and gradients to 1e-10 of scale (strided, compacted on an
  overflowing flat bucket, and that with batched passes, whose bucket spans
  several passes' rows); float32 (strided, with
  grad_accum 2, with batched passes, and compacted on a flat bucket with
  and without overflow) losses to 1e-6 and gradients to 1e-5 of scale, or
  to twice the leaf's own float32 error where that is larger (the one
  process's float32 gradient against its float64 one: the pose and fov
  scalars sum many cancelling terms, and with grad_accum 2 the fov's own
  float32 error is 9.5e-6 of scale, so a reordered sum cannot meet 1e-5);
  the
  bf16 merged tables at test_torch_step_merged.py's bounds (each rank's
  table gradient rounds to bf16 before the average): losses 1e-4, plane and
  line leaves 3e-2 of scale, other leaves 1e-3. With the TV weights
  doubled, the change of every gradient (the TV gradient) and the pose
  gradient come out as in one process: counted once.
"""

import warnings

import numpy as np
import pytest
import torch

from rodynrf_tpu.parallel.mesh import grid_sharded as jgrid_sharded
from rodynrf_tpu.parallel.mesh import make_mesh as jmake_mesh
from rodynrf_tpu_torch.parallel import grid_sharded, process_span
from rodynrf_tpu_torch.parallel.launch import run_ranks
from rodynrf_tpu_torch.parallel.mesh import resolve_devices
from rodynrf_tpu_torch.render.pipeline import _flat_index
from rodynrf_tpu_torch.testing import torch_threads
from torch_parallel_ranks import step_cases, step_grads

F32_CASES = ("f32", "accum2", "fused", "flat", "flat_overflow")
F64_CASES = ("f32", "flat_overflow", "fused_flat_overflow", "tv2")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (i,))
    else:
        yield prefix, tree


def _rel(a, ref):
    return float(np.abs(a - ref).max()) / max(float(np.abs(ref).max()), 1e-30)


# ---------------------------------------------------------------------------
# host rules against the JAX package
# ---------------------------------------------------------------------------

SHAPES = [(16, 33, 30), (8, 31, 29), (3, 5, 7), (48, 369, 411), (4, 12, 9), (2, 7, 8)]


@pytest.mark.parametrize("n", [2, 4, 8])
def test_grid_sharded_axis_matches_jax(n):
    mesh = jmake_mesh(n)
    for shape in SHAPES:
        spec = tuple(jgrid_sharded(mesh, shape).spec)
        want = spec.index("data") if "data" in spec else None
        assert grid_sharded(n, shape) == want, (shape, spec)


@pytest.mark.parametrize("world", [2, 4, 8])
def test_process_span_matches_jax(world):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = jmake_mesh(world)
    sharding = NamedSharding(mesh, P("data"))
    for n in (64, 60, 1024, 6, 3):
        try:
            index_map = sharding.devices_indices_map((n,))
        except ValueError:
            with pytest.raises(ValueError):
                process_span(n, 0, world)
            continue
        for r, dev in enumerate(mesh.devices.flat):
            (sl,) = index_map[dev]
            assert process_span(n, r, world) == (sl.start or 0, sl.stop or n), (n, r)
    assert jax.device_count() >= world
    if world > 2:  # one process holding ranks 0 and 2 does not feed one span
        with pytest.raises(ValueError, match="contiguous"):
            process_span(64, [0, 2], world)
        assert process_span(64, [1, 2], world) == (64 // world, 3 * 64 // world)


def test_non_divisible_batch_rule_matches_jax(capsys):
    """batch 60 on 8 devices: 4 ranks, with the JAX trainer's warning
    (rodynrf_tpu/train/trainer.py:117-141) word for word; a batch that
    divides says nothing."""
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        assert resolve_devices(60, 8) == 4
        assert resolve_devices(64, 8) == 8
    assert [str(x.message) for x in w] == [
        "[parallel] batch_size 60 does not divide 8 devices; sharding rays over 4 device(s)"
        " — 4 of 8 devices will sit IDLE. Pick a batch_size divisible by the device count."]
    assert capsys.readouterr().out == ""


@pytest.mark.parametrize("batch,n_final,world,want", [
    (1024, 640 ** 3, 1, 4), (1024, 640 ** 3, 8, 4), (1024, 300 ** 3, 8, 1),
    (60, 640 ** 3, 4, 5), (60, 300 ** 3, 4, 1), (96, 640 ** 3, 16, 6),
])
def test_grad_accum_with_the_mesh_factor_matches_jax(batch, n_final, world, want):
    """The auto micro-batch count keeps micro-batches divisible over the
    mesh: the port's Trainer._grad_accum against the JAX trainer's."""
    from types import SimpleNamespace

    from rodynrf_tpu.train.trainer import Trainer as JTrainer
    from rodynrf_tpu_torch.train.trainer import Trainer as TTrainer

    args = SimpleNamespace(grad_accum=0, N_voxel_final=n_final, batch_size=batch)
    jt = SimpleNamespace(args=args, mesh=SimpleNamespace(size=world) if world > 1 else None)
    tt = SimpleNamespace(args=args, mesh=SimpleNamespace(size=lambda: world)
                         if world > 1 else None)
    assert JTrainer._grad_accum(jt) == TTrainer._grad_accum(tt) == want


# ---------------------------------------------------------------------------
# the gradient rule and the flat bucket's first-N rule
# ---------------------------------------------------------------------------

def test_flat_index_offsets_keep_the_batchs_first_n():
    """A [R, S] occupancy over two ranks' halves, with each half's row
    offsets into the whole batch's order: together the halves keep exactly
    the samples one process keeps, with and without overflow, and each
    half's slots are a prefix."""
    g = torch.Generator().manual_seed(3)
    R, S = 12, 10
    occ = torch.rand((R, S), generator=g) < 0.4
    occ[:6] |= torch.rand((6, S), generator=g) < 0.5  # the first rank holds more
    total = int(occ.sum())
    for N in (total + 5, total // 2, 3):
        idx, _, _ = _flat_index(occ, N)
        kept = set(int(i) for i in idx if i < R * S)
        got = set()
        for r in range(2):
            half = occ[6 * r:6 * (r + 1)]
            base = torch.full((6,), int(occ[:6 * r].sum()), dtype=torch.int64)
            idx_r, _, _ = _flat_index(half, N, base)
            used = idx_r < 6 * S
            assert used.sum() == used[:int(used.sum())].sum()  # a prefix of the slots
            got |= set(int(i) + 6 * S * r for i in idx_r[used])
        assert got == kept, N
        assert len(kept) == min(N, total)


# ---------------------------------------------------------------------------
# the step: 2 ranks against one process
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def steps():
    """(one process, 2 ranks, whether a rank loaded JAX), each {(case,
    f64): step_grads}; the one process also runs every float32 case in
    float64 for the leaves' own float32 error."""
    names = [(n, False) for n in F32_CASES + ("bf16",)] + [(n, True) for n in F64_CASES]
    two, loaded = run_ranks(step_cases, 2, "cpu", (names,))
    one = {n: step_grads(n[0], None, n[1])
           for n in set(names) | {(n, True) for n in F32_CASES}}
    return one, two, loaded


def test_ranks_import_no_jax(steps):
    assert steps[2] is False


def _compare(steps, name, loss_tol, grad_tol, table_tol=None, f64=False):
    (g1, m1, f1), (g2, m2, f2) = steps[0][(name, f64)], steps[1][(name, f64)]
    noise = {}
    if (name, True) in steps[0] and not f64:
        noise = {p: _rel(v, dict(_leaves(steps[0][(name, True)][0]))[p]) for p, v in _leaves(g1)}
    assert f1 == f2
    assert set(m1) == set(m2) and len(m1) > 30
    for k in m1:
        np.testing.assert_allclose(m2[k], m1[k], rtol=loss_tol, atol=1e-12, err_msg=k)
    a, b = dict(_leaves(g1)), dict(_leaves(g2))
    assert set(a) == set(b) and {p[0] for p in a} == {"static", "dynamic", "pose", "fov"}
    worst = 0.0
    for path in a:
        tol = table_tol if table_tol and any("plane" in str(p) or "line" in str(p)
                                             for p in path) else grad_tol
        tol = max(tol, 2.0 * noise.get(path, 0.0))
        rel = _rel(b[path], a[path])
        worst = max(worst, rel)
        assert rel <= tol, (path, rel)
    print(f"{name}: worst gradient difference {worst:.3e} of scale")


@pytest.mark.parametrize("name", F64_CASES[:3])
def test_float64_step_matches_one_process(steps, name):
    _compare(steps, name, 1e-12, 1e-10, f64=True)


@pytest.mark.parametrize("name", F32_CASES)
def test_float32_step_matches_one_process(steps, name):
    _compare(steps, name, 1e-6, 1e-5)


def test_bf16_merged_step_matches_one_process(steps):
    _compare(steps, "bf16", 1e-4, 1e-3, table_tol=3e-2)


def test_flat_bucket_overflowed(steps):
    """The overflow case drops samples (its losses differ from the bucket
    that holds them all), so its agreement shows the global first-N rule."""
    (_, m_all, f_all), (_, m_over, f_over) = (steps[0][("flat", False)],
                                              steps[0][("flat_overflow", False)])
    assert f_over < f_all
    assert abs(m_all["mse"] - m_over["mse"]) > 1e-4 * abs(m_all["mse"])


@pytest.mark.parametrize("leaf", ["tv", "pose"])
def test_gradient_rule_counts_each_term_once(steps, leaf):
    """TV acts on the parameters only, so every rank computes its gradient
    in full; the pose gradient mixes the rows' share with the full ray math.
    Each comes out as in one process, not W times (float64: the TV
    gradient is the difference of two steps' gradients)."""
    if leaf == "tv":
        d1, d2 = ({p: v - dict(_leaves(st[("f32", True)][0]))[p]
                   for p, v in _leaves(st[("tv2", True)][0])} for st in steps[:2])
        planes = [p for p in d1 if "plane" in str(p) and np.abs(d1[p]).max() > 0]
        assert planes
        for p in planes:
            assert _rel(d2[p], d1[p]) <= 1e-6, (p, _rel(d2[p], d1[p]))
    else:
        g1, g2 = (st[("f32", False)][0]["pose"] for st in steps[:2])
        assert np.abs(g1).max() > 0 and _rel(g2, g1) <= 1e-5


def test_gradient_rule_unit():
    """loss = sum(gather_rows(x_local²)) + sum(x)³ with x replicated: after
    the average the gradient equals one process's 2x + 3 sum(x)², not W
    times either term."""
    from torch_parallel_ranks import gradient_rule_rank

    got, want = run_ranks(gradient_rule_rank, 2, "cpu")
    np.testing.assert_allclose(got, want, rtol=1e-12)


def test_an_ungathered_output_makes_the_loss_non_finite():
    """On a data mesh only the compositor outputs the losses read are
    gathered (step._READ); the others are NaN placeholders. Leaving any one
    of the dual pass's outputs out of the gather turns the loss non-finite,
    so a loss that reads an output the gather misses cannot train on zeros."""
    from torch_parallel_ranks import read_guard_rank

    losses = run_ranks(read_guard_rank, 2, "cpu")
    assert len(losses) >= 5 and not any(np.isfinite(v) for v in losses.values()), losses
