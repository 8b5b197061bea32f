"""The port's CUDA kernels (coalesce, segment sum in its upd and factored
forms, the bit-limited radix sort, the JPEG decoder's baseline and
progressive entropy decodes, IDCT and colour pass) against their plain
PyTorch versions.

Imports torch and numpy only, so it runs on a machine with a card:

    python -m pytest tests/test_torch_kernels.py

Without a card the kernel cases skip (a CUDA kernel has no CPU mode); the
CPU-route cases run everywhere. Tolerance: 1e-4 of max|plain| (f32 sums of
up to thousands of terms, taken in another order). A bf16 output is the f32
sum rounded once, so it equals the f32 output `.to(torch.bfloat16)` bit for
bit.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rodynrf_tpu_torch.ops import coalesced as tco
from rodynrf_tpu_torch.ops import segsum as tseg

REPO = Path(__file__).resolve().parents[1]


def _inputs(seed, M, R, C, pattern):
    rng = np.random.default_rng(seed)
    if pattern == "hot":  # stride-4 style duplication hot spots
        rows = rng.integers(0, R, M)
        rows[: M // 3] = rng.integers(0, max(R // 40, 2), M // 3)
    elif pattern == "one_row":  # every entry on one row: many chunks per row
        rows = np.full(M, R // 2)
    elif pattern == "blocks":  # a few far-apart clusters, long empty gaps
        rows = np.concatenate([rng.integers(0, 10, M // 3),
                               rng.integers(R // 2, R // 2 + 10, M // 3),
                               rng.integers(R - 5, R, M - 2 * (M // 3))])
    else:
        rows = rng.integers(0, R, M)
    w4 = rng.uniform(0, 1, (M, 4)).astype(np.float32)
    ct = rng.standard_normal((M, C)).astype(np.float32)
    return rows.astype(np.int32), w4, ct


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("M,R,C,pattern", [
    (3000, 257, 12, "hot"),
    (2048, 64, 80, "uniform"),
    (600, 4096, 8, "blocks"),
    (5000, 33, 20, "one_row"),
    (50, 1000, 1, "uniform"),
    (4097, 500, 128, "hot"),
    (1, 7, 16, "uniform"),
    # the narrow layout: 32 / (C / 4) entries per warp step
    (3000, 257, 1, "hot"),
    (5000, 33, 1, "one_row"),
    (600, 4096, 1, "blocks"),
    (3000, 257, 16, "hot"),
    (5000, 33, 16, "one_row"),
    (600, 4096, 16, "blocks"),
    (3000, 257, 20, "hot"),
    (600, 4096, 20, "blocks"),
    (2000, 300, 6, "hot"),
])
def test_coalesce_kernel_matches_plain(M, R, C, pattern):
    dev = _card()
    rows, w4, ct = (torch.from_numpy(a).to(dev) for a in _inputs(M + C, M, R, C, pattern))
    before = tco.coalesce_table_grad.launches
    got = tco.coalesce_table_grad(rows, w4, ct, R)
    again = tco.coalesce_table_grad(rows, w4, ct, R)
    got_bf16 = tco.coalesce_table_grad(rows, w4, ct, R, torch.bfloat16)
    torch.cuda.synchronize()
    assert tco.coalesce_table_grad.launches == before + 3
    want = tco.coalesce_table_grad_plain(rows, w4, ct, R)
    scale = float(want.abs().max())
    assert got.dtype == torch.float32 and got.shape == (R, 4 * C)
    assert float((got - want).abs().max()) <= 1e-4 * scale
    assert torch.equal(got, again)  # deterministic: no atomics
    assert got_bf16.dtype == torch.bfloat16
    assert torch.equal(got_bf16.view(torch.int16), got.to(torch.bfloat16).view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("bad_row", [-1, 50, 64, 1000])
def test_coalesce_kernel_asserts_on_rows_out_of_range(bad_row):
    """A row outside [0, R) trips the kernel's device-side assert, which
    leaves the CUDA context unusable: run it in a process of its own. The
    sort orders only the 6 bits that R - 1 = 49 needs, so 64 and 1000 sort
    among the small rows: the walk checks every key it reads."""
    _card()
    code = (
        "import torch\n"
        "from rodynrf_tpu_torch.ops.coalesced import coalesce_table_grad\n"
        "rows = torch.arange(700, device='cuda', dtype=torch.int32) % 50\n"
        f"rows[::7] = {bad_row}\n"
        "w4 = torch.rand(700, 4, device='cuda')\n"
        "ct = torch.randn(700, 12, device='cuda')\n"
        "coalesce_table_grad(rows, w4, ct, 50)\n"
        "torch.cuda.synchronize()\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode != 0
    assert "assert" in (proc.stdout + proc.stderr).lower()


@pytest.mark.cuda
def test_coalesce_kernel_with_no_entries_gives_zeros():
    dev = _card()
    before = tco.coalesce_table_grad.launches
    rows = torch.empty(0, dtype=torch.int32, device=dev)
    got = tco.coalesce_table_grad(rows, torch.empty(0, 4, device=dev),
                                  torch.empty(0, 12, device=dev), 30)
    assert got.shape == (30, 48) and not bool(got.any())
    assert tco.coalesce_table_grad.launches == before


@pytest.mark.cuda
def test_coalesce_kernel_refuses_what_it_does_not_take():
    dev = _card()
    rows, w4, ct = (torch.from_numpy(a).to(dev) for a in _inputs(1, 64, 16, 4, "uniform"))
    with pytest.raises(TypeError):
        tco.coalesce_table_grad(rows, w4.double(), ct, 16)
    with pytest.raises(ValueError):
        tco.coalesce_table_grad(rows, w4, torch.randn(64, 200, device=dev), 16)
    with pytest.raises(ValueError):
        tco.coalesce_table_grad(rows, w4.t().contiguous().t(), ct, 16)


def test_cpu_route_takes_the_plain_version_and_counts_nothing():
    rows, w4, ct = (torch.from_numpy(a) for a in _inputs(2, 300, 40, 6, "hot"))
    before = tco.coalesce_table_grad.launches
    got = tco.coalesce_table_grad(rows, w4, ct, 40)
    assert tco.coalesce_table_grad.launches == before
    np.testing.assert_array_equal(got.numpy(),
                                  tco.coalesce_table_grad_plain(rows, w4, ct, 40).numpy())


def _segsum_inputs(seed, M, R, C, pattern, dtype):
    rows, _, _ = _inputs(seed, M, R, 1, pattern)
    if pattern == "trash":  # entries on the trash bin n_rows are dropped
        rows[::3] = R
    upd = np.random.default_rng(seed + 1).standard_normal((M, C)).astype(np.float32)
    return torch.from_numpy(rows), torch.from_numpy(upd).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,R,C,pattern", [
    (3000, 257, 960, "hot"),
    (2048, 64, 240, "uniform"),
    (600, 4096, 8, "blocks"),
    (5000, 33, 264, "one_row"),
    (700, 90, 16, "trash"),
    (1, 7, 24, "uniform"),
])
def test_segsum_kernel_matches_plain(M, R, C, pattern, dtype):
    dev = _card()
    idx, upd = (t.to(dev) for t in _segsum_inputs(M + C, M, R, C, pattern, dtype))
    before = tseg.sorted_segment_rows_sum.launches
    got = tseg.segment_rows_sum(idx, upd, R)
    again = tseg.segment_rows_sum(idx, upd, R)
    keys, perm = torch.sort(idx, stable=True)
    in_order = tseg.sorted_segment_rows_sum(keys, upd[perm].contiguous(), R)
    torch.cuda.synchronize()
    assert tseg.sorted_segment_rows_sum.launches == before + 3
    want = tseg.segment_rows_sum_plain(idx, upd, R)
    scale = float(want.abs().max())
    for g in (got, in_order):
        assert g.dtype == torch.float32 and g.shape == (R, C)
        assert float((g - want).abs().max()) <= 1e-4 * scale
    assert torch.equal(got, again)  # deterministic: no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("bad_row", [-1, 51, 64, 1000])
def test_segsum_kernel_asserts_on_rows_out_of_range(bad_row):
    """An index outside [0, n_rows] (n_rows = 50 is the trash bin) trips the
    kernel's device-side assert: run it in a process of its own. 64 and 1000
    lie past the 6 bits the sort orders."""
    _card()
    code = (
        "import torch\n"
        "from rodynrf_tpu_torch.ops.segsum import segment_rows_sum\n"
        "idx = torch.arange(700, device='cuda', dtype=torch.int32) % 50\n"
        f"idx[::7] = {bad_row}\n"
        "upd = torch.randn(700, 16, device='cuda')\n"
        "segment_rows_sum(idx, upd, 50)\n"
        "torch.cuda.synchronize()\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode != 0
    assert "assert" in (proc.stdout + proc.stderr).lower()


@pytest.mark.cuda
def test_segsum_kernel_edge_cases_and_refusals():
    dev = _card()
    before = tseg.sorted_segment_rows_sum.launches
    got = tseg.segment_rows_sum(torch.empty(0, dtype=torch.int32, device=dev),
                                torch.empty(0, 16, device=dev), 30)
    assert got.shape == (30, 16) and not bool(got.any())
    assert tseg.sorted_segment_rows_sum.launches == before
    idx = torch.zeros(64, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        tseg.segment_rows_sum(idx, torch.randn(64, 16, device=dev).double(), 4)
    with pytest.raises(ValueError):  # a 12-value bf16 row is not 16-byte aligned
        tseg.segment_rows_sum(idx, torch.randn(64, 12, device=dev).bfloat16(), 4)
    with pytest.raises(ValueError):
        tseg.sorted_segment_rows_sum(idx, torch.randn(16, 64, device=dev).t(), 4)


def test_segsum_cpu_route_takes_the_plain_version_and_counts_nothing():
    idx, upd = _segsum_inputs(3, 300, 40, 8, "trash", torch.bfloat16)
    before = tseg.sorted_segment_rows_sum.launches
    got = tseg.segment_rows_sum(idx, upd, 40)
    assert tseg.sorted_segment_rows_sum.launches == before
    np.testing.assert_array_equal(got.numpy(), tseg.segment_rows_sum_plain(idx, upd, 40).numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_segsum_kernel_bf16_output_is_the_f32_output_rounded(dtype):
    dev = _card()
    idx, upd = (t.to(dev) for t in _segsum_inputs(5, 3000, 257, 240, "hot", dtype))
    got = tseg.segment_rows_sum(idx, upd, 257)
    got_bf16 = tseg.segment_rows_sum(idx, upd, 257, torch.bfloat16)
    torch.cuda.synchronize()
    assert got_bf16.dtype == torch.bfloat16 and got_bf16.shape == (257, 240)
    assert torch.equal(got_bf16.view(torch.int16), got.to(torch.bfloat16).view(torch.int16))


def _factored_inputs(seed, M, R, nS, C, pattern):
    rows, _, _ = _inputs(seed, M, R, 1, pattern)
    if pattern == "trash":
        rows[::3] = R
    rng = np.random.default_rng(seed + 1)
    w = rng.uniform(0, 1, (M, nS, 4)).astype(np.float32)
    ct = rng.standard_normal((M, nS, C)).astype(np.float32)
    return torch.from_numpy(rows), torch.from_numpy(w), torch.from_numpy(ct)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("M,R,C,pattern", [
    (3000, 257, 80, "hot"),
    (3000, 257, 20, "hot"),
    (5000, 33, 20, "one_row"),
    (600, 4096, 80, "blocks"),
    (700, 90, 20, "trash"),
    (1, 7, 20, "uniform"),
    (2000, 300, 6, "hot"),  # 2 channels a slot
    (900, 50, 3, "blocks"),  # 1 channel a slot
])
def test_segsum_factored_kernel_matches_plain(M, R, C, pattern, dtype):
    """The factored form (products rounded to the table dtype in registers)
    against its plain version: the f32 output within 1e-4 of scale, the
    table-dtype output the f32 output rounded, bit for bit; deterministic."""
    dev = _card()
    nS = 3
    idx, w, ct = (t.to(dev) for t in _factored_inputs(M + C, M, R, nS, C, pattern))
    before = tseg.segment_rows_sum_factored.launches
    got32 = tseg.segment_rows_sum_factored(idx, w, ct, R, dtype, torch.float32)
    again = tseg.segment_rows_sum_factored(idx, w, ct, R, dtype, torch.float32)
    got = tseg.segment_rows_sum_factored(idx, w, ct, R, dtype)
    torch.cuda.synchronize()
    assert tseg.segment_rows_sum_factored.launches == before + 3
    want = tseg.segment_rows_sum_factored_plain(idx, w, ct, R, dtype, torch.float32)
    scale = float(want.abs().max())
    assert got32.shape == (R, nS * 4 * C) and got.dtype == dtype
    assert float((got32 - want).abs().max()) <= 1e-4 * scale
    assert torch.equal(got32, again)
    assert torch.equal(got, got32.to(dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_segsum_factored_kernel_equals_upd_form_bit_for_bit(dtype):
    """At C = 80, nS = 3 (the merged o0 width) both forms walk one entry a
    step in chunks of 64, so each output element is summed in the same
    order: the factored form equals forming u, the upd form in f32 and
    the cast, bit for bit."""
    dev = _card()
    idx, w, ct = (t.to(dev) for t in _factored_inputs(9, 4000, 300, 3, 80, "hot"))
    got = tseg.segment_rows_sum_factored(idx, w, ct, 300, dtype)
    u = tseg.factored_update(w, ct, dtype)
    old = tseg.segment_rows_sum(idx, u, 300).to(dtype)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16) if dtype == torch.bfloat16 else got,
                       old.view(torch.int16) if dtype == torch.bfloat16 else old)


@pytest.mark.cuda
@pytest.mark.parametrize("R,pattern", [
    (1, "uniform"), (256, "uniform"), (257, "uniform"), (2 ** 17, "uniform"),
    (2 ** 17 + 1, "hot"), (1000, "equal"),
])
def test_bit_limited_sort_is_the_stable_sort(R, pattern):
    """sort_rows sorts only the bits R - 1 needs (or R, with a trash bin),
    with an int32 iota as values: keys and permutation equal torch's stable
    sort, at R = 2^k and 2^k + 1, R = 1 and all keys equal; the kernels
    built on it match their plain versions there."""
    dev = _card()
    M = 5000
    rows, w4, ct = _inputs(R, M, R, 16, "hot" if pattern == "hot" else "uniform")
    if pattern == "equal":
        rows[:] = R - 1
    rows, w4, ct = (torch.from_numpy(a).to(dev) for a in (rows, w4, ct))
    for lib, max_key in ((tco._lib(), R - 1), (tseg._lib(), R)):
        keys, perm = tseg.sort_rows(lib, rows, max_key)
        want_keys, want_perm = torch.sort(rows, stable=True)
        assert keys.dtype == perm.dtype == torch.int32
        assert torch.equal(keys, want_keys) and torch.equal(perm.long(), want_perm)
    got = tco.coalesce_table_grad(rows, w4, ct, R)
    want = tco.coalesce_table_grad_plain(rows, w4, ct, R)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())
    got = tseg.segment_rows_sum(rows, ct, R)
    want = tseg.segment_rows_sum_plain(rows, ct, R)
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("bad_row", [-1, 51, 64])
def test_segsum_factored_kernel_asserts_on_rows_out_of_range(bad_row):
    _card()
    code = (
        "import torch\n"
        "from rodynrf_tpu_torch.ops.segsum import segment_rows_sum_factored\n"
        "idx = torch.arange(700, device='cuda', dtype=torch.int32) % 50\n"
        f"idx[::7] = {bad_row}\n"
        "w = torch.rand(700, 3, 4, device='cuda')\n"
        "ct = torch.randn(700, 3, 20, device='cuda')\n"
        "segment_rows_sum_factored(idx, w, ct, 50, torch.bfloat16)\n"
        "torch.cuda.synchronize()\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode != 0
    assert "assert" in (proc.stdout + proc.stderr).lower()


@pytest.mark.cuda
def test_segsum_factored_kernel_edge_cases_and_refusals():
    dev = _card()
    before = tseg.segment_rows_sum_factored.launches
    got = tseg.segment_rows_sum_factored(torch.empty(0, dtype=torch.int32, device=dev),
                                         torch.empty(0, 3, 4, device=dev),
                                         torch.empty(0, 3, 20, device=dev), 30, torch.bfloat16)
    assert got.shape == (30, 240) and got.dtype == torch.bfloat16 and not bool(got.any())
    assert tseg.segment_rows_sum_factored.launches == before
    idx = torch.zeros(64, dtype=torch.int32, device=dev)
    w = torch.rand(64, 3, 4, device=dev)
    with pytest.raises(ValueError):
        tseg.segment_rows_sum_factored(idx, w, torch.randn(64, 6, 3, device=dev).transpose(1, 2),
                                       4, torch.float32)
    with pytest.raises(TypeError):
        tseg.segment_rows_sum_factored(idx, w.double(), torch.randn(64, 3, 8, device=dev).double(),
                                       4, torch.float32)
    with pytest.raises(TypeError):
        tseg.segment_rows_sum_factored(idx, w, torch.randn(64, 3, 8, device=dev), 4,
                                       torch.float16)


@pytest.mark.cuda
@pytest.mark.parametrize("restart", [0, 2])
def test_jpeg_kernels_match_their_plain_versions(restart, tmp_path):
    """The three JPEG kernels (csrc/jpeg_entropy.cu, csrc/jpeg_idct.cu) on the
    committed fixtures and on write_jpeg frames of every subsampling, with
    and without restart markers, equal their plain versions bit for bit:
    blocks, status words, planes and pixels."""
    from rodynrf_tpu_torch.data import jpeg as J
    from rodynrf_tpu_torch.ops import jpeg as K
    from rodynrf_tpu_torch.testing import write_jpeg

    dev = _card()
    rng = np.random.default_rng(restart)
    paths = [str(p) for p in sorted((REPO / "tests" / "data" / "jpeg").glob("*.jpg"))
             if "progressive" not in p.name]
    for i, (sub, (h, w)) in enumerate([("444", (17, 23)), ("422", (33, 9)), ("420", (40, 56)),
                                       ("440", (31, 45)), ("gray", (24, 24))]):
        img = rng.integers(0, 256, (h, w) if sub == "gray" else (h, w, 3), dtype=np.uint8)
        paths.append(str(tmp_path / f"{i}.jpg"))
        write_jpeg(paths[-1], img, 75, "444" if sub == "gray" else sub, restart)
    host = J.pack([J.read_jpeg(p) for p in paths])
    card = host.to(dev)
    coef_p, st_p = K.jpeg_entropy(host)
    planes_p = K.jpeg_idct(coef_p, host)
    rgb_p = K.jpeg_color(planes_p, host)
    before = (K.jpeg_entropy.launches, K.jpeg_idct.launches, K.jpeg_color.launches)
    coef, st = K.jpeg_entropy(card)
    planes = K.jpeg_idct(coef, card)
    rgb = K.jpeg_color(planes, card)
    torch.cuda.synchronize()
    assert (K.jpeg_entropy.launches, K.jpeg_idct.launches, K.jpeg_color.launches) == tuple(
        n + 1 for n in before)
    assert not st_p.any()
    for got, want in ((coef, coef_p), (st, st_p), (planes, planes_p), (rgb, rgb_p)):
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("restart", [0, 2])
def test_jpeg_progressive_kernel_matches_its_plain_version(restart, tmp_path):
    """csrc/jpeg_progressive.cu on the committed fixtures (baseline and
    progressive in one batch) and on progressive write_jpeg frames of every
    subsampling under the writer's three scan scripts, with and without
    restart markers: one launch per round; once every round has run, the
    blocks and the status words equal the plain version's bit for bit, and
    so do the pixels that the IDCT and colour kernels make of them."""
    from rodynrf_tpu_torch.data import jpeg as J
    from rodynrf_tpu_torch.ops import jpeg as K
    from rodynrf_tpu_torch.testing import write_jpeg

    dev = _card()
    rng = np.random.default_rng(10 + restart)
    paths = [str(p) for p in sorted((REPO / "tests" / "data" / "jpeg").glob("*.jpg"))]
    for i, (sub, (h, w)) in enumerate([("444", (17, 23)), ("422", (33, 9)), ("420", (40, 56)),
                                       ("440", (31, 45)), ("gray", (24, 24))]):
        img = rng.integers(0, 256, (h, w) if sub == "gray" else (h, w, 3), dtype=np.uint8)
        for script in (True, "spectral", "dc_sa"):
            paths.append(str(tmp_path / f"{i}_{script}.jpg"))
            write_jpeg(paths[-1], img, 75, "444" if sub == "gray" else sub, restart,
                       progressive=script)
    host = J.pack([J.read_jpeg(p) for p in paths])
    card = host.to(dev)
    coef_p, _ = K.jpeg_entropy(host)
    pst_p = K.jpeg_progressive(coef_p, host)
    rgb_p = K.jpeg_color(K.jpeg_idct(coef_p, host), host)
    before = K.jpeg_progressive.launches
    coef, _ = K.jpeg_entropy(card)
    pst = K.jpeg_progressive(coef, card)
    rgb = K.jpeg_color(K.jpeg_idct(coef, card), card)
    torch.cuda.synchronize()
    assert K.jpeg_progressive.launches == before + len(host.rounds) == before + 10
    assert not pst_p.any()
    for got, want in ((coef, coef_p), (pst, pst_p), (rgb, rgb_p)):
        assert torch.equal(got.cpu(), want)
