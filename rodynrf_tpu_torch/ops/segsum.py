"""Segment row-sum with a hand-written CUDA kernel (port of
rodynrf_tpu/ops/pallas_segsum.py).

`segment_rows_sum(idx, upd, n_rows)` computes `out[r] = Σ_{idx[k]=r} upd[k]`
in f32: the table gradient of the merged-layout gather
(`ops/coalesced.merged_sample`). On the card it is a stable sort of the
indices and the CUDA kernel `csrc/segsum.cu` (the port of the Pallas kernel
`_kernel`), which reads the update rows through the sort permutation; on the
CPU it is the plain `index_add_` version.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import cuda_build


def segment_rows_sum_plain(idx: torch.Tensor, upd: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The plain PyTorch version: index_add_ in f32, with one extra row that
    takes the trash-bin index n_rows and is dropped."""
    out = torch.zeros((n_rows + 1, upd.shape[1]), dtype=torch.float32, device=upd.device)
    return out.index_add_(0, idx.long(), upd.float())[:n_rows]


def _check(idx, upd, perm):
    if upd.dim() != 2 or idx.dim() != 1:
        raise ValueError(f"idx must be [M] and upd [M, C], got {tuple(idx.shape)}, "
                         f"{tuple(upd.shape)}")
    n = upd.shape[0] if perm is None else perm.shape[0]
    if idx.shape[0] != n or (perm is not None and perm.dim() != 1):
        raise ValueError(f"idx {tuple(idx.shape)} does not match the update rows")
    devs = {idx.device, upd.device} | ({perm.device} if perm is not None else set())
    if len(devs) != 1:
        raise ValueError("idx, upd (and perm) must be on one device")
    if idx.dtype != torch.int32 or (perm is not None and perm.dtype != torch.int32):
        raise TypeError(f"indices must be int32, got {idx.dtype}")


def sorted_segment_rows_sum(idx_sorted: torch.Tensor, upd: torch.Tensor, n_rows: int,
                            perm: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[r, :] = Σ_{k: idx_sorted[k] = r} upd[perm[k], :]  ->  [n_rows, C] f32.

    idx_sorted [M] int32 ascending in [0, n_rows] (n_rows is a trash bin:
    those entries are dropped); upd [*, C] bf16 or f32; perm [M] int32 the
    update row of each sorted entry, or None for upd in key order. Rows no
    entry reaches are zero.

    CPU tensors take the plain version. CUDA tensors launch the kernel
    (csrc/segsum.cu) or raise; each launch adds one to
    `sorted_segment_rows_sum.launches`. Indices outside [0, n_rows] raise in
    the plain version and trip a device-side assert in the kernel (a
    host-side check would cost a device sync per call).
    """
    _check(idx_sorted, upd, perm)
    if upd.device.type == "cpu":
        rows = upd if perm is None else upd.index_select(0, perm.long())
        return segment_rows_sum_plain(idx_sorted, rows, n_rows)
    if upd.device.type != "cuda":
        raise ValueError(f"sorted_segment_rows_sum: unsupported device {upd.device}")
    M, C = idx_sorted.shape[0], upd.shape[1]
    if upd.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the kernel takes bf16 or f32 updates, got {upd.dtype}")
    tensors = (idx_sorted, upd) + ((perm,) if perm is not None else ())
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("the kernel takes contiguous idx, upd and perm")
    if (C * upd.element_size()) % 16 or upd.data_ptr() % 16:
        raise ValueError(f"the kernel reads 16-byte vectors: a row of {C} {upd.dtype} "
                         "values must be a multiple of 16 bytes, 16-byte aligned")
    if M >= 2 ** 31 or n_rows >= 2 ** 31 or upd.shape[0] >= 2 ** 31:
        raise ValueError("M and n_rows must fit int32")
    if M == 0 or n_rows == 0:  # nothing to reduce: no kernel to launch
        return torch.zeros((n_rows, C), dtype=torch.float32, device=upd.device)
    lib = _lib()
    out = torch.empty((n_rows, C), dtype=torch.float32, device=upd.device)
    n_chunks = -(-M // lib.rodynrf_segsum_chunk())
    head = torch.empty((n_chunks, C), dtype=torch.float32, device=upd.device)
    tail = torch.empty_like(head)
    err = lib.rodynrf_segsum(
        idx_sorted.data_ptr(), perm.data_ptr() if perm is not None else None, upd.data_ptr(),
        upd.element_size(), out.data_ptr(), head.data_ptr(), tail.data_ptr(), M, n_rows, C,
        torch.cuda.current_stream(upd.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"segsum kernel launch failed: cudaError_t {err}")
    sorted_segment_rows_sum.launches += 1
    return out


sorted_segment_rows_sum.launches = 0


def segment_rows_sum(idx: torch.Tensor, upd: torch.Tensor, n_rows: int) -> torch.Tensor:
    """Unsorted form: out[r, :] = Σ_{k: idx[k] = r} upd[k, :] -> [n_rows, C]
    f32, the drop-in for `zeros(n_rows, C).index_add_(0, idx, upd)` with f32
    accumulation. On the card: a stable sort of idx, then the kernel reading
    upd through the permutation (no sorted copy of upd is made)."""
    _check(idx, upd, None)
    if upd.device.type == "cpu":
        return segment_rows_sum_plain(idx, upd, n_rows)
    keys, perm = torch.sort(idx, stable=True)
    return sorted_segment_rows_sum(keys, upd, n_rows, perm.to(torch.int32))


def _lib():
    """The kernel's library, built and loaded on first use."""
    lib = cuda_build.load("segsum")
    lib.rodynrf_segsum_chunk.argtypes = []
    lib.rodynrf_segsum_chunk.restype = ctypes.c_int
    fn = lib.rodynrf_segsum
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib
