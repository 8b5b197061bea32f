"""Corner-packed plane sampling with hand-written table-gradient kernels
(port of rodynrf_tpu/ops/coalesced.py).

`planes_sample` (strided layout) and `merged_sample` (merged-stride layout)
are the hot primitives of the train step: gather one table row per sample
and weight its bilinear corners. Their backward re-gathers the rows for the
weight cotangent (the gathered block is never saved for backward) and
computes the table cotangent with a kernel:

- `planes_sample`: `coalesce_table_grad`, the CUDA kernel `csrc/coalesce.cu`
  on the card (the port of the Pallas kernel `_coalesce_kernel`);
- `merged_sample`: `ops/segsum.segment_rows_sum_factored`, the CUDA kernel
  `csrc/segsum.cu` (the port of the Pallas segment-sum kernel) in its
  factored form, which forms u = w·ct in registers.

Both kernels sum in f32 and store the sum rounded once to the table dtype,
so the backward makes no cast pass. On the CPU each takes its plain
PyTorch version.
"""

from __future__ import annotations

import ctypes

import torch

from ..utils.profiling import span
from . import cuda_build
from .segsum import (OUT_DTYPES, bind_common, current_stream, data_ptr, key_bits,
                     scratch_bytes, segment_rows_sum_factored, workspace)


def _fwd_math(table: torch.Tensor, rows: torch.Tensor, w4: torch.Tensor) -> torch.Tensor:
    M = rows.shape[0]
    C = table.shape[1] // 4
    vals = table.index_select(0, rows).to(w4.dtype).view(M, 4, C)
    return (
        vals[:, 0] * w4[:, 0, None]
        + vals[:, 1] * w4[:, 1, None]
        + vals[:, 2] * w4[:, 2, None]
        + vals[:, 3] * w4[:, 3, None]
    )


class _PlanesSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, rows, w4):
        ctx.save_for_backward(table, rows, w4)
        return _fwd_math(table, rows, w4)

    @staticmethod
    def backward(ctx, ct):
        table, rows, w4 = ctx.saved_tensors
        ct = ct.contiguous()
        ct_table = ct_w4 = None
        if ctx.needs_input_grad[2]:
            # re-gather instead of storing the [M, 4, C] activation block
            M, C = ct.shape
            vals = table.index_select(0, rows).to(w4.dtype).view(M, 4, C)
            ct_w4 = torch.einsum("mc,mkc->mk", ct, vals)
        if ctx.needs_input_grad[0]:
            with span("ops.table_grad"):
                ct_table = coalesce_table_grad(rows, w4, ct, table.shape[0], table.dtype)
        return ct_table, None, ct_w4


def planes_sample(table: torch.Tensor, rows: torch.Tensor, w4: torch.Tensor) -> torch.Tensor:
    """feats[m] = Σ_k w4[m,k] · table[rows[m], k·C:(k+1)·C]  ->  [M, C] f32.

    table [R, 4C] corner-packed rows (ops/fused_vm.pack_vm layout), f32 or
    bf16; rows [M] int32 row ids in range; w4 [M, 4] f32 corner weights
    (already × valid). Differentiable w.r.t. table and w4.

    The table cotangent is accumulated in f32 whatever the table dtype (the
    f32 cotangent goes into the kernel, which rounds the sum once to the
    table dtype):
    the JAX package's `impl='pallas'` contract. Its default `'auto'` route
    casts the cotangent to bf16 before an XLA scatter and so accumulates a
    bf16 table's gradient in bf16.
    """
    return _PlanesSample.apply(table, rows, w4)


def _merged_fwd_math(table: torch.Tensor, rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    M, nS = w.shape[0], w.shape[1]
    C = table.shape[1] // (nS * 4)
    vals = table.index_select(0, rows).view(M, nS, 4, C)
    return (
        vals[:, :, 0].float() * w[:, :, 0, None]
        + vals[:, :, 1].float() * w[:, :, 1, None]
        + vals[:, :, 2].float() * w[:, :, 2, None]
        + vals[:, :, 3].float() * w[:, :, 3, None]
    )


class _MergedSample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, rows, w):
        ctx.save_for_backward(table, rows, w)
        return _merged_fwd_math(table, rows, w)

    @staticmethod
    def backward(ctx, ct):
        table, rows, w = ctx.saved_tensors
        ct = ct.contiguous()
        M, nS, C = ct.shape
        ct_table = ct_w = None
        if ctx.needs_input_grad[2]:
            # re-gather instead of storing the [M, nS, 4, C] block; one
            # corner at a time keeps the f32 copy to [M, nS, C]
            vals = table.index_select(0, rows).view(M, nS, 4, C)
            ct_w = torch.stack([(ct * vals[:, :, k].float()).sum(-1) for k in range(4)], -1)
        if ctx.needs_input_grad[0]:
            # u[m, (s, k, c)] = w[m, s, k] · ct[m, s, c], formed in f32 and
            # rounded once to the table dtype (what autodiff of the JAX
            # package's inline merged take produces), summed per row in f32
            # and rounded to the table dtype; on the card u stays in registers
            with span("ops.table_grad"):
                ct_table = segment_rows_sum_factored(rows.contiguous(), w.contiguous(), ct,
                                                     table.shape[0], table.dtype)
        return ct_table, None, ct_w


def merged_sample(table: torch.Tensor, rows: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Merged-layout corner sampling -> [M, nS, C] per-stride features, f32.

    table [R, nS·4·C] merged-stride corner rows (channel blocks [stride:
    corner: C], ops/fused_vm merged layout), f32 or bf16; rows [M] int32
    merged-cell row ids in range; w [M, nS, 4] f32 per-stride corner weights
    (× valid). The forward's FMA order is the strided path's, so f32 merged
    features equal strided ones bit for bit. Autograd keeps only (table,
    rows, w). Differentiable w.r.t. table and w.
    """
    return _MergedSample.apply(table, rows, w)


# ---------------------------------------------------------------------------
# table gradient: kernel + plain version
# ---------------------------------------------------------------------------


def coalesce_table_grad_plain(rows, w4, ct, R: int, out_dtype=None) -> torch.Tensor:
    """The plain PyTorch version: index_add_ of the materialised [M, K·C]
    corner outer product, in ct's dtype (f32 on the train step), cast to
    out_dtype (default: ct's dtype)."""
    M, C = ct.shape
    K = w4.shape[1]
    upd = (w4[:, :, None].to(ct.dtype) * ct[:, None, :]).reshape(M, K * C)
    out = torch.zeros((R, K * C), dtype=ct.dtype, device=ct.device)
    return out.index_add_(0, rows.long(), upd).to(out_dtype or ct.dtype)


def _check_shapes(rows, w4, ct, R):
    M, C = ct.shape
    if rows.shape != (M,) or w4.shape != (M, 4):
        raise ValueError(f"shapes rows {tuple(rows.shape)}, w4 {tuple(w4.shape)}, "
                         f"ct {tuple(ct.shape)} do not agree (K must be 4)")
    if not (rows.device == w4.device == ct.device):
        raise ValueError("rows, w4 and ct must be on one device")
    if rows.dtype != torch.int32:
        raise TypeError(f"rows must be int32, got {rows.dtype}")


def coalesce_table_grad(rows, w4, ct, R: int, out_dtype=None) -> torch.Tensor:
    """grad[r, k·C+c] = Σ_{m: rows[m]=r} w4[m,k] · ct[m,c]  ->  [R, 4C] in
    out_dtype (default: ct's dtype), summed in ct's dtype (f32) and rounded
    once.

    CPU tensors take the plain version. CUDA tensors (f32 w4/ct, f32 or
    bf16 out) launch the kernel library (csrc/coalesce.cu: the radix sort of
    the rows, then the reduction), or raise; each launch adds one to
    `coalesce_table_grad.launches`.
    The kernel writes every row of the output, zeros where no sample lands.
    Rows must lie in [0, R): the plain version raises on others, the kernel
    trips a device-side assert (as index_add_ does on the card; a host-side
    check would cost a device sync per call).
    """
    _check_shapes(rows, w4, ct, R)
    if rows.device.type == "cpu":
        return coalesce_table_grad_plain(rows, w4, ct, R, out_dtype)
    if rows.device.type != "cuda":
        raise ValueError(f"coalesce_table_grad: unsupported device {rows.device}")
    M, C = ct.shape
    out_dtype = out_dtype or ct.dtype
    if w4.dtype != torch.float32 or ct.dtype != torch.float32:
        raise TypeError(f"the kernel takes f32 w4/ct, got {w4.dtype}, {ct.dtype}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"the kernel writes f32 or bf16, not {out_dtype}")
    if not (rows.is_contiguous() and w4.is_contiguous() and ct.is_contiguous()):
        raise ValueError("the kernel takes contiguous rows, w4 and ct")
    if w4.data_ptr() % 16:
        raise ValueError("the kernel reads w4 rows as float4: 16-byte alignment needed")
    if not (C <= 32 or (C <= 64 and C % 2 == 0) or (C <= 128 and C % 4 == 0)):
        raise ValueError(f"the kernel takes C <= 32, even C <= 64 or C <= 128 a multiple "
                         f"of 4 channels, got {C}")
    if M >= 2 ** 31 or R >= 2 ** 31:
        raise ValueError("M and R must fit int32")
    if M == 0 or R == 0:  # nothing to reduce: no kernel to launch
        return torch.zeros((R, 4 * C), dtype=out_dtype, device=ct.device)
    return _launch(_lib(), w4, ct, R, out_dtype, rows=rows)


coalesce_table_grad.launches = 0


def _launch(lib, w4, ct, R, out_dtype, rows=None, keys=None, perm=None, stages=15,
            scratch=None, out=None):
    """The kernel: sorts `rows` itself (the radix sort of `sort_rows`), or
    takes sorted `keys` with their `perm`. stages, scratch, out: see
    csrc/segreduce.cuh `Call` (one launch at a time, for timing)."""
    M, C = ct.shape
    bits = key_bits(R - 1) if rows is not None else 0
    stream = current_stream(ct.device)
    if scratch is None:
        scratch = workspace(scratch_bytes(lib, M, bits, 4 * C), ct.device, stream)
    if out is None:
        out = torch.empty((R, 4 * C), dtype=out_dtype, device=ct.device)
    err = lib.rodynrf_coalesce_table_grad(
        data_ptr(rows), data_ptr(keys), data_ptr(perm), w4.data_ptr(), ct.data_ptr(),
        out.data_ptr(), int(out_dtype == torch.bfloat16), scratch.data_ptr(), scratch.numel(),
        bits, M, R, C, stages, stream,
    )
    if err != 0:
        raise RuntimeError(f"coalesce kernel launch failed: cudaError_t {err}")
    coalesce_table_grad.launches += 1
    return out


def _lib():
    """The kernel's library, built, loaded and bound on first use."""
    lib = cuda_build.load("coalesce")
    if getattr(lib, "bound", False):
        return lib
    bind_common(lib)
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rodynrf_coalesce_table_grad.argtypes = [P, P, P, P, P, P, I, P, LL, I, I, I, I, I, P]
    lib.rodynrf_coalesce_table_grad.restype = I
    lib.bound = True
    return lib
