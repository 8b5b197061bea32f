"""The port's tracer (rodynrf_tpu_torch/utils/profiling.py) on the CPU.

- Off (the default) `span` hands out one shared no-op context and records
  nothing; a training step runs with `torch.profiler.record_function` made
  to raise, under a recording profiler, so the off path opens no region.
- On, spans nest: each records its parent on its own thread and the root
  open in the process, also when it opens in a custom autograd Function's
  backward or on a second Python thread; twelve threads at once lose none.
- Under torch.profiler a span opens a region of its name, and its stamps,
  moved by `trace_offset_ns`, contain the profile's own interval of the
  matmul it encloses.
- A tiny trainer's step with spans on gives one `train.step` root holding one
  `train.adam` and a `train.forward` and `train.backward` per micro-batch;
  the sampler, fields and compositor run inside `train.forward`, the
  table-gradient wrappers inside `train.backward`; its loss and parameters
  equal bit for bit those of the same step with spans off.
- `render_image` gives one `render.frame` root and one sampler, static and
  dynamic field and compositor span per chunk.
"""

import sys
import threading
from collections import Counter

import numpy as np
import pytest
import torch

from rodynrf_tpu_torch.core.se3 import pose_to_mtx
from rodynrf_tpu_torch.render import renderer as R
from rodynrf_tpu_torch.testing import TINY, tiny_cmd, tiny_scene, torch_threads
from rodynrf_tpu_torch.train import Trainer, parse_cmd
from rodynrf_tpu_torch.train.step import named_leaves
from rodynrf_tpu_torch.utils import profiling as P

CMD = tiny_cmd("ndc", 1) + " --grad_accum 2"


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    with torch_threads(1):
        yield


@pytest.fixture(autouse=True)
def tracer_off():
    P.disable()
    P.take()
    yield
    P.disable()
    P.take()


def _trainer():
    return Trainer(parse_cmd(CMD), tiny_scene("ndc"), device="cpu")


def _by_id(spans):
    return {s.id: s for s in spans}


def _inside(spans, s, name):
    """Whether span s has an ancestor called `name` on its thread."""
    ids = _by_id(spans)
    p = s.parent
    while p is not None:
        if ids[p].name == name:
            return True
        p = ids[p].parent
    return False


def test_off_path_is_one_shared_no_op_and_opens_no_region(monkeypatch):
    assert P.span("sampler") is P.span("train.step", iteration=3)
    with P.span("sampler"):
        pass
    assert P.take() == []

    def refuse(*a, **k):
        raise AssertionError("record_function entered with the tracer off")

    tr = _trainer()
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        m = tr.run_step()
    assert np.isfinite(float(m["total_loss"]))
    assert P.take() == []


class _Twice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return 2 * x

    @staticmethod
    def backward(ctx, g):
        with P.span("in.backward"):
            return 2 * g


def test_on_path_nests_and_shares_the_root_across_threads():
    P.enable()
    got = {}

    def other():
        with P.span("other.outer"):
            with P.span("other.inner"):
                got["thread"] = threading.get_ident()

    with P.span("train.step", iteration=7):
        with P.span("train.backward"):
            x = torch.ones(3, requires_grad=True)
            _Twice.apply(x).sum().backward()
        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=30)
        assert not t.is_alive()
    with P.span("render.frame"):
        pass
    spans = {s.name: s for s in P.take()}
    root = spans["train.step"]
    assert root.parent is None and root.root == root.id and root.attrs == {"iteration": 7}
    bw, inb = spans["train.backward"], spans["in.backward"]
    assert bw.parent == root.id and bw.root == root.id
    # on the CPU the engine runs the backward on the caller's thread
    assert inb.root == root.id and inb.parent == bw.id and inb.thread == bw.thread
    outer, inner = spans["other.outer"], spans["other.inner"]
    assert outer.thread == inner.thread == got["thread"] != root.thread
    assert outer.parent is None and inner.parent == outer.id
    assert outer.root == inner.root == root.id
    frame = spans["render.frame"]
    assert frame.root == frame.id != root.id
    for s in spans.values():
        assert s.start_ns <= s.end_ns
    assert root.start_ns <= bw.start_ns <= inb.start_ns <= inb.end_ns <= bw.end_ns <= root.end_ns


def test_many_threads_lose_no_span():
    """Threads opening nested spans at once, with the interpreter switching
    threads often: every span is kept, ids are unique, and each one's
    parent and root hold."""
    n_threads, n_spans = 12, 200
    P.enable()

    def work():
        for _ in range(n_spans):
            with P.span("outer"):
                with P.span("inner"):
                    pass

    before = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with P.span("train.step"):
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(before)
    spans = P.take()
    assert len(spans) == 2 * n_threads * n_spans + 1
    ids = _by_id(spans)
    assert len(ids) == len(spans)
    (root,) = [s for s in spans if s.name == "train.step"]
    for s in spans:
        assert s.root == root.id
        if s.name == "inner":
            assert ids[s.parent].name == "outer" and ids[s.parent].thread == s.thread
        elif s.name == "outer":
            assert s.parent is None


def test_span_stamps_sit_on_the_profile_clock():
    x = torch.randn(512, 512)
    P.enable()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with P.span("matmul"):
            (x @ x).sum()
    (s,) = P.take()
    off = P.trace_offset_ns(prof)
    lo, hi = (s.start_ns + off) / 1e3, (s.end_ns + off) / 1e3  # µs on the trace
    events = prof.events()
    assert [e.name for e in events].count("matmul") == 1  # the span's region
    mm = [e for e in events if e.name == "aten::mm"]
    assert mm
    for e in mm:
        assert lo <= e.time_range.start <= e.time_range.end <= hi, (lo, hi, e.time_range)


def test_a_traced_step_is_the_untraced_step_with_its_spans():
    off, on = _trainer(), _trainer()
    m_off = off.run_step()
    P.enable()
    m_on = on.run_step()
    P.disable()
    spans = P.take()
    assert float(m_on["total_loss"]) == float(m_off["total_loss"])
    leaves = dict(named_leaves(off.params))
    for path, t in named_leaves(on.params):
        assert torch.equal(t, leaves[path]), path

    n = Counter(s.name for s in spans)
    assert n["train.step"] == 1 and n["train.adam"] == 1
    assert n["train.forward"] == n["train.backward"] == 2  # --grad_accum 2
    (root,) = [s for s in spans if s.name == "train.step"]
    assert root.attrs == {"iteration": 0}
    assert all(s.root == root.id for s in spans)
    for name in ("train.forward", "train.backward", "train.adam"):
        assert all(s.parent == root.id for s in spans if s.name == name)
    for name in ("sampler", "field.static", "field.dynamic", "compositor"):
        assert n[name] > 0
        assert all(_inside(spans, s, "train.forward") for s in spans if s.name == name), name
    assert n["ops.table_grad"] > 0
    assert all(_inside(spans, s, "train.backward") for s in spans if s.name == "ops.table_grad")


def test_render_image_gives_a_frame_and_four_spans_a_chunk():
    tr = _trainer()
    params = {k: tr.params[k] for k in ("static", "dynamic")}
    step = tr.static_cfg.step_size(np.asarray(tr.scene.scene_bbox))
    chunk_fn = R.make_chunk_renderer(tr.static_cfg, tr.dynamic_cfg, "ndc", tr.n_samples, step)
    c2w = np.asarray(pose_to_mtx(tr.params["pose"].detach()))[1]
    H, W = TINY["H"], TINY["W"]
    chunk = 96
    P.enable()
    maps = R.render_image(chunk_fn, params, tr.aabb, c2w, 20.0, -0.25, H, W, "ndc", chunk=chunk)
    spans = P.take()
    assert maps["rgb"].shape == (H, W, 3)
    n_chunks = -(-H * W // chunk)
    n = Counter(s.name for s in spans)
    assert n == {"render.frame": 1, "sampler": n_chunks, "field.static": n_chunks,
                 "field.dynamic": n_chunks, "compositor": n_chunks}
    (frame,) = [s for s in spans if s.name == "render.frame"]
    assert frame.attrs == {"t": -0.25}
    assert all(s.root == frame.id and s.parent == frame.id for s in spans if s is not frame)
