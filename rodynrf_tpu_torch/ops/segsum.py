"""Segment row-sum with a hand-written CUDA kernel (port of
rodynrf_tpu/ops/pallas_segsum.py).

`segment_rows_sum(idx, upd, n_rows)` computes `out[r] = Σ_{idx[k]=r} upd[k]`
in f32: the contract of the Pallas kernel `_kernel`.
`segment_rows_sum_factored(idx, w, ct, n_rows, dtype)` is the same sum with
the update in its factored form `upd[m, (s, k, c)] = (w[m,s,k] ·
ct[m,s,c]).to(dtype)`: the table gradient of the merged-layout gather
(`ops/coalesced.merged_sample`), whose [M, nS·4·C] update is never formed in
memory on the card. On the card both are a stable radix sort of the
indices (`sort_rows`) and the CUDA kernel `csrc/segsum.cu`, which reads the
inputs through the sort permutation and stores the f32 sums rounded once to
the output dtype; on the CPU each is its plain `index_add_` version.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from . import cuda_build

OUT_DTYPES = (torch.float32, torch.bfloat16)


def segment_rows_sum_plain(idx: torch.Tensor, upd: torch.Tensor, n_rows: int,
                           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The plain PyTorch version: index_add_ in f32, with one extra row that
    takes the trash-bin index n_rows and is dropped, cast to out_dtype."""
    out = torch.zeros((n_rows + 1, upd.shape[1]), dtype=torch.float32, device=upd.device)
    return out.index_add_(0, idx.long(), upd.float())[:n_rows].to(out_dtype)


def factored_update(w: torch.Tensor, ct: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """u[m, (s, k, c)] = w[m, s, k] · ct[m, s, c] formed in ct's dtype and
    rounded once to `dtype`: [M, nS·4·C]."""
    return (w[:, :, :, None] * ct[:, :, None, :]).to(dtype).reshape(w.shape[0], -1)


def segment_rows_sum_factored_plain(idx: torch.Tensor, w: torch.Tensor, ct: torch.Tensor,
                                    n_rows: int, dtype: torch.dtype,
                                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """The plain version of the factored form: form u, index_add_ in f32,
    cast to out_dtype (default: dtype)."""
    return segment_rows_sum_plain(idx, factored_update(w, ct, dtype), n_rows,
                                  out_dtype or dtype)


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


def _check_card(tensors, n_rows, out_dtype, name):
    if tensors[0].device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {tensors[0].device}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"the kernel writes f32 or bf16, not {out_dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name}: the kernel takes contiguous inputs")
    if max(t.shape[0] for t in tensors) >= 2 ** 31 or n_rows >= 2 ** 31:
        raise ValueError("M and n_rows must fit int32")


def _check_rows(upd):
    C = upd.shape[1]
    if upd.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"the kernel takes bf16 or f32 updates, got {upd.dtype}")
    if (C * upd.element_size()) % 16 or upd.data_ptr() % 16:
        raise ValueError(f"the kernel reads 16-byte vectors: a row of {C} {upd.dtype} "
                         "values must be a multiple of 16 bytes, 16-byte aligned")


def sorted_segment_rows_sum(idx_sorted: torch.Tensor, upd: torch.Tensor, n_rows: int,
                            perm: Optional[torch.Tensor] = None,
                            out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """out[r, :] = Σ_{k: idx_sorted[k] = r} upd[perm[k], :]  ->  [n_rows, C].

    idx_sorted [M] int32 ascending in [0, n_rows] (n_rows is a trash bin:
    those entries are dropped); upd [*, C] bf16 or f32; perm [M] int32 the
    update row of each sorted entry, or None for upd in key order. Sums in
    f32, rounded once to out_dtype (f32 or bf16). Rows no entry reaches are
    zero.

    CPU tensors take the plain version. CUDA tensors launch the kernel
    (csrc/segsum.cu) or raise; each launch adds one to
    `sorted_segment_rows_sum.launches`. Indices outside [0, n_rows] raise in
    the plain version and trip a device-side assert in the kernel (a
    host-side check would cost a device sync per call).
    """
    _check(idx_sorted, upd, perm)
    if upd.device.type == "cpu":
        rows = upd if perm is None else upd.index_select(0, perm.long())
        return segment_rows_sum_plain(idx_sorted, rows, n_rows, out_dtype)
    _check_card((idx_sorted, upd) + ((perm,) if perm is not None else ()), n_rows, out_dtype,
                "sorted_segment_rows_sum")
    M, C = idx_sorted.shape[0], upd.shape[1]
    _check_rows(upd)
    if M == 0 or n_rows == 0:  # nothing to reduce: no kernel to launch
        return torch.zeros((n_rows, C), dtype=out_dtype, device=upd.device)
    return _launch_rows(_lib(), upd, n_rows, out_dtype, keys=idx_sorted, perm=perm)


sorted_segment_rows_sum.launches = 0


def segment_rows_sum(idx: torch.Tensor, upd: torch.Tensor, n_rows: int,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Unsorted form: out[r, :] = Σ_{k: idx[k] = r} upd[k, :] -> [n_rows, C],
    the drop-in for `zeros(n_rows, C).index_add_(0, idx, upd)` with f32
    accumulation, rounded once to out_dtype. On the card: `sort_rows` of
    idx, then the kernel reading upd through the permutation (no sorted copy
    of upd is made)."""
    _check(idx, upd, None)
    if upd.device.type == "cpu":
        return segment_rows_sum_plain(idx, upd, n_rows, out_dtype)
    _check_rows(upd)
    _check_card((idx, upd), n_rows, out_dtype, "segment_rows_sum")
    if idx.shape[0] == 0 or n_rows == 0:
        return torch.zeros((n_rows, upd.shape[1]), dtype=out_dtype, device=upd.device)
    return _launch_rows(_lib(), upd, n_rows, out_dtype, rows=idx)


def segment_rows_sum_factored(idx: torch.Tensor, w: torch.Tensor, ct: torch.Tensor,
                              n_rows: int, dtype: torch.dtype,
                              out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """out[r, (s, k, c)] = Σ_{m: idx[m] = r} (w[m,s,k] · ct[m,s,c]).to(dtype)
    -> [n_rows, nS·4·C] in out_dtype (default: dtype).

    idx [M] int32 in [0, n_rows] (n_rows a trash bin); w [M, nS, 4] and ct
    [M, nS, C] f32. Each product is rounded to `dtype` (the table dtype, f32
    or bf16), as merged_sample's backward rounds u, then summed in f32 and
    rounded once to out_dtype. CPU tensors take the plain version
    (`segment_rows_sum_factored_plain`). CUDA tensors: the radix sort of
    idx, then the kernel forming each product in registers, or raise; each
    launch adds one to `segment_rows_sum_factored.launches`.
    """
    out_dtype = out_dtype or dtype
    M = idx.shape[0]
    if (idx.dim() != 1 or w.dim() != 3 or ct.dim() != 3 or w.shape != (M, ct.shape[1], 4)
            or ct.shape[0] != M):
        raise ValueError(f"shapes idx {tuple(idx.shape)}, w {tuple(w.shape)}, ct "
                         f"{tuple(ct.shape)} do not agree (w is [M, nS, 4], ct [M, nS, C])")
    if not (idx.device == w.device == ct.device):
        raise ValueError("idx, w and ct must be on one device")
    if idx.dtype != torch.int32:
        raise TypeError(f"indices must be int32, got {idx.dtype}")
    if idx.device.type == "cpu":
        return segment_rows_sum_factored_plain(idx, w, ct, n_rows, dtype, out_dtype)
    _check_card((idx, w, ct), n_rows, out_dtype, "segment_rows_sum_factored")
    nS, C = ct.shape[1], ct.shape[2]
    if dtype not in OUT_DTYPES:
        raise TypeError(f"the kernel rounds the products to f32 or bf16, not {dtype}")
    if w.dtype != torch.float32 or ct.dtype != torch.float32:
        raise TypeError(f"the kernel takes f32 w and ct, got {w.dtype}, {ct.dtype}")
    if w.data_ptr() % 16:
        raise ValueError("the kernel reads w as float4 vectors: 16-byte alignment needed")
    if M == 0 or n_rows == 0:  # nothing to reduce: no kernel to launch
        return torch.zeros((n_rows, nS * 4 * C), dtype=out_dtype, device=ct.device)
    return _launch_factored(_lib(), w, ct, n_rows, dtype, out_dtype, rows=idx)


segment_rows_sum_factored.launches = 0


# ---------------------------------------------------------------------------
# the card: scratch, sort, launches, library
# ---------------------------------------------------------------------------

_SCRATCH_BYTES: Dict[Tuple[str, int, int, int], int] = {}
_WORKSPACE: Dict[Tuple[int, int], torch.Tensor] = {}


def key_bits(max_key: int) -> int:
    """The bits the radix sort orders for keys in [0, max_key]."""
    return max(1, int(max_key).bit_length())


def scratch_bytes(lib: ctypes.CDLL, M: int, bits: int, W: int) -> int:
    """Bytes of one call's scratch (sorted keys, permutation, the walk's
    partials of rows of W values, the sort's own storage; csrc/segreduce.cuh
    `carve`) for M entries and `bits` sort bits (0: sorted keys given),
    asked of the library once per shape."""
    key = (lib._name, M, bits, W)
    n = _SCRATCH_BYTES.get(key)
    if n is None:
        n = _SCRATCH_BYTES[key] = lib.rodynrf_scratch_bytes(M, bits, W)
        if n < 0:
            raise RuntimeError(f"scratch size query failed for M={M}, bits={bits}, W={W}")
    return n


def new_scratch(lib: ctypes.CDLL, M: int, bits: int, W: int, device) -> torch.Tensor:
    """A scratch buffer of its own for one call (uint8)."""
    return torch.empty(scratch_bytes(lib, M, bits, W), dtype=torch.uint8, device=device)


def workspace(nbytes: int, device: torch.device, stream: int) -> torch.Tensor:
    """The calls' shared scratch on one stream, grown to the largest call
    seen: the kernels of successive calls on a stream run one after the
    other, so one buffer serves them all and a call allocates only its
    output. A buffer dropped when it grows goes back to PyTorch's caching
    allocator, which orders its reuse on the stream after these kernels."""
    key = (device.index, stream)
    buf = _WORKSPACE.get(key)
    if buf is None or buf.numel() < nbytes:
        buf = _WORKSPACE[key] = torch.empty(nbytes, dtype=torch.uint8, device=device)
    return buf


def current_stream(device: torch.device) -> int:
    """The handle of PyTorch's current stream on the device (the kernels
    launch on it)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def sort_rows(lib: ctypes.CDLL, rows: torch.Tensor, max_key: int):
    """The kernels' sort alone: stable sort of rows [M] int32 (contiguous,
    on the card) in [0, max_key] by CUB's radix sort over the bits max_key
    needs, with an int32 iota as the values. Returns (keys, perm), both
    int32 [M], keys[i] == rows[perm[i]]. `lib` is either kernel library.
    Rows outside [0, 2^bits) land anywhere: the kernels' range assert
    catches them."""
    M = rows.shape[0]
    if rows.dtype != torch.int32 or not rows.is_contiguous() or M == 0:
        raise ValueError("sort_rows takes contiguous int32 rows, at least one")
    bits = key_bits(max_key)
    buf = new_scratch(lib, M, bits, 0, rows.device)
    kb = -(-4 * M // 256) * 256
    keys, perm = buf[:4 * M].view(torch.int32), buf[kb:kb + 4 * M].view(torch.int32)
    err = lib.rodynrf_sort_rows(
        rows.data_ptr(), keys.data_ptr(), perm.data_ptr(), buf.data_ptr() + 2 * kb,
        buf.data_ptr() + 3 * kb, buf.numel() - 3 * kb, M, bits,
        current_stream(rows.device))
    if err != 0:
        raise RuntimeError(f"radix sort failed: cudaError_t {err}")
    return keys, perm


def data_ptr(t: Optional[torch.Tensor]):
    """The tensor's address for the kernels' C interface, None for no tensor."""
    return t.data_ptr() if t is not None else None


def _launch_rows(lib, upd, n_rows, out_dtype, rows=None, keys=None, perm=None, stages=15,
                 scratch=None, out=None):
    """The upd-form kernel: sorts `rows` itself, or takes sorted `keys` (and
    `perm`, None for upd in key order). stages, scratch, out: see
    csrc/segreduce.cuh `Call` (one launch at a time, for timing)."""
    M, C = (rows if rows is not None else keys).shape[0], upd.shape[1]
    bits = key_bits(n_rows) if rows is not None else 0
    stream = current_stream(upd.device)
    if scratch is None:
        scratch = workspace(scratch_bytes(lib, M, bits, C), upd.device, stream)
    if out is None:
        out = torch.empty((n_rows, C), dtype=out_dtype, device=upd.device)
    err = lib.rodynrf_segsum(
        data_ptr(rows), data_ptr(keys), data_ptr(perm), upd.data_ptr(), upd.element_size(),
        out.data_ptr(), int(out_dtype == torch.bfloat16), scratch.data_ptr(), scratch.numel(),
        bits, M, n_rows, C, stages, stream,
    )
    if err != 0:
        raise RuntimeError(f"segsum kernel launch failed: cudaError_t {err}")
    sorted_segment_rows_sum.launches += 1
    return out


def _launch_factored(lib, w, ct, n_rows, dtype, out_dtype, rows=None, keys=None, perm=None,
                     stages=15, scratch=None, out=None):
    """The factored-form kernel; arguments as `_launch_rows`."""
    M, nS, C = ct.shape
    W = nS * 4 * C
    bits = key_bits(n_rows) if rows is not None else 0
    stream = current_stream(ct.device)
    if scratch is None:
        scratch = workspace(scratch_bytes(lib, M, bits, W), ct.device, stream)
    if out is None:
        out = torch.empty((n_rows, W), dtype=out_dtype, device=ct.device)
    err = lib.rodynrf_segsum_factored(
        data_ptr(rows), data_ptr(keys), data_ptr(perm), w.data_ptr(), ct.data_ptr(), nS, C,
        int(dtype == torch.bfloat16), out.data_ptr(), int(out_dtype == torch.bfloat16),
        scratch.data_ptr(), scratch.numel(), bits, M, n_rows, stages, stream,
    )
    if err != 0:
        raise RuntimeError(f"segsum kernel launch failed: cudaError_t {err}")
    segment_rows_sum_factored.launches += 1
    return out


def bind_common(lib: ctypes.CDLL) -> None:
    """The ctypes signatures of the scratch-size and sort functions that
    both kernel libraries carry (csrc/segreduce.cuh)."""
    lib.rodynrf_scratch_bytes.argtypes = [ctypes.c_int] * 3
    lib.rodynrf_scratch_bytes.restype = ctypes.c_longlong
    lib.rodynrf_sort_rows.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong]
                                      + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.rodynrf_sort_rows.restype = ctypes.c_int


def _lib():
    """The kernel's library, built, loaded and bound on first use."""
    lib = cuda_build.load("segsum")
    if getattr(lib, "bound", False):
        return lib
    bind_common(lib)
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rodynrf_segsum.argtypes = [P, P, P, P, I, P, I, P, LL, I, I, I, I, I, P]
    lib.rodynrf_segsum.restype = I
    lib.rodynrf_segsum_factored.argtypes = [P, P, P, P, P, I, I, I, P, I, P, LL, I, I, I, I, P]
    lib.rodynrf_segsum_factored.restype = I
    lib.bound = True
    return lib
