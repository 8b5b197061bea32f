"""The port's CUDA kernels against their plain PyTorch versions.

Imports torch and numpy only, so it runs on a machine with a card:

    python -m pytest tests/test_torch_kernels.py

Without a card the kernel cases skip (a CUDA kernel has no CPU mode); the
CPU-route cases run everywhere. Tolerance: 1e-4 of max|plain| (f32 sums of
up to thousands of terms, taken in another order).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from rodynrf_tpu_torch.ops import coalesced as tco

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
])
def test_coalesce_kernel_matches_plain(M, R, C, pattern):
    dev = _card()
    rows, w4, ct = (torch.from_numpy(a).to(dev) for a in _inputs(M + C, M, R, C, pattern))
    before = tco.coalesce_table_grad.launches
    got = tco.coalesce_table_grad(rows, w4, ct, R)
    again = tco.coalesce_table_grad(rows, w4, ct, R)
    torch.cuda.synchronize()
    assert tco.coalesce_table_grad.launches == before + 2
    want = tco.coalesce_table_grad_plain(rows, w4, ct, R)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-4 * scale
    assert torch.equal(got, again)  # deterministic: no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("bad_row", [-1, 50])
def test_coalesce_kernel_asserts_on_rows_out_of_range(bad_row):
    """A row outside [0, R) trips the kernel's device-side assert, which
    leaves the CUDA context unusable: run it in a process of its own."""
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
