"""The fused VM sampler's forward in one hand-written kernel launch.

`vm_sample(packed, xyz)` computes `ops/fused_vm.sample_vm_fused(packed,
xyz)` bit for bit, for every orientation, stride and grid of the pack, in
one launch of `csrc/vm_sample.cu`: each sample's plane rows and line taps
are read once and its features written once, with no gathered corner
block, f32 copy or concatenation in device memory. It has no backward:
`sample_vm_fused` takes it for CUDA inputs when nothing needs a gradient
(rendering, evaluation, the train step's detached passes), and the autograd
path otherwise. `layout(packed)` is the pack's static facts as the kernel
takes them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from . import cuda_build

MAX_STRIDES = 8   # csrc/vm_sample.cu kMaxStrides
MAX_GRIDS = 4     # kMaxGrids
BLOCK = 256       # threads a block at most
DTYPES = (torch.float32, torch.bfloat16)


class Layout(NamedTuple):
    """The pack's static facts as the kernel takes them (csrc/vm_sample.cu
    `VmArgs`)."""

    merged: bool
    n_strides: int
    n_grids: int
    vec: int                      # channels a thread: divides every C_{g,o}
    unit_start: Tuple[int, ...]   # first thread (unit) of each orientation, then the total
    cp: Tuple[int, ...]           # Cp_o
    dims: tuple                   # [o][si] (Hs, Ws)
    line_dims: tuple              # [o][si] Ls
    row_offsets: tuple            # [o][si], strided layout
    seg_lx: Tuple[int, ...]       # [o], merged layout
    c0: tuple                     # [o][g] first channel of grid g in Cp_o, then Cp_o
    col_base: tuple               # [o][g] sum_{o' < o} C_{g,o'}
    pitch: Tuple[int, ...]        # [g] sum_o C_{g,o}

    @property
    def units(self) -> int:
        return self.unit_start[3]

    def widths(self) -> List[int]:
        """F_g: each grid's output width."""
        return [self.n_strides * p for p in self.pitch]


@functools.lru_cache(maxsize=64)
def _layout(key: tuple, itemsize: int) -> Layout:
    meta = dict(key)
    nS, G = len(meta["strides"]), meta["n_grids"]
    splits = meta["c_splits"]
    widths = [c for o in range(3) for c in splits[o]]
    vec = 16 // itemsize
    while any(c % vec for c in widths):
        vec //= 2
    cp = tuple(sum(splits[o]) for o in range(3))
    starts = [0]
    for o in range(3):
        starts.append(starts[-1] + cp[o] // vec)
    merged = meta["layout"] == "merged"
    return Layout(
        merged=merged, n_strides=nS, n_grids=G, vec=vec, unit_start=tuple(starts), cp=cp,
        dims=meta["dims"], line_dims=meta["line_dims"],
        row_offsets=meta.get("row_offsets", ((0,) * nS,) * 3),
        seg_lx=tuple(meta["seg_dims"][o][1] for o in range(3)) if merged else (0, 0, 0),
        c0=tuple(tuple(int(v) for v in np.cumsum((0,) + tuple(splits[o]))) for o in range(3)),
        col_base=tuple(tuple(sum(splits[q][g] for q in range(o)) for g in range(G))
                       for o in range(3)),
        pitch=tuple(sum(splits[o][g] for o in range(3)) for g in range(G)),
    )


def layout(packed) -> Layout:
    """The kernel's view of `packed` (ops/fused_vm.PackedVM)."""
    return _layout(tuple(sorted(packed.meta.items())), packed.tables[0].element_size())


# ---------------------------------------------------------------------------
# the kernel
# ---------------------------------------------------------------------------


class VmArgs(ctypes.Structure):
    """csrc/vm_sample.cu `VmArgs`, field for field."""

    _fields_ = [
        ("tables", ctypes.c_void_p * 3),
        ("lines", ctypes.c_void_p * (3 * MAX_STRIDES)),
        ("out", ctypes.c_void_p * MAX_GRIDS),
        ("xyz", ctypes.c_void_p),
        ("n", ctypes.c_longlong),
        ("xyz_stride", ctypes.c_longlong),
        ("merged", ctypes.c_int), ("bf16", ctypes.c_int), ("n_strides", ctypes.c_int),
        ("n_grids", ctypes.c_int), ("vec", ctypes.c_int), ("units", ctypes.c_int),
        ("unit_start", ctypes.c_int * 4),
        ("cp", ctypes.c_int * 3),
        ("dims", ctypes.c_int * (3 * MAX_STRIDES * 2)),
        ("line_dims", ctypes.c_int * (3 * MAX_STRIDES)),
        ("row_offsets", ctypes.c_int * (3 * MAX_STRIDES)),
        ("seg_lx", ctypes.c_int * 3),
        ("c0", ctypes.c_int * (3 * (MAX_GRIDS + 1))),
        ("col_base", ctypes.c_int * (3 * MAX_GRIDS)),
        ("pitch", ctypes.c_int * MAX_GRIDS),
    ]


def _fill(arr, rows, width):
    """Write nested rows into a flat ctypes array of `width` a row."""
    for i, row in enumerate(rows):
        for j, v in enumerate(row):
            arr[i * width + j] = int(v)


def _args(L: Layout, packed, xyz, outs) -> VmArgs:
    a = VmArgs()
    for o in range(3):
        a.tables[o] = packed.tables[o].data_ptr()
        for si in range(L.n_strides):
            a.lines[o * MAX_STRIDES + si] = packed.line_tables[o][si].data_ptr()
        for si, (h, w) in enumerate(L.dims[o]):
            a.dims[(o * MAX_STRIDES + si) * 2] = h
            a.dims[(o * MAX_STRIDES + si) * 2 + 1] = w
    for g, t in enumerate(outs):
        a.out[g] = t.data_ptr()
    a.xyz, a.n, a.xyz_stride = xyz.data_ptr(), xyz.shape[0], xyz.stride(0)
    a.merged, a.bf16 = int(L.merged), int(packed.tables[0].dtype == torch.bfloat16)
    a.n_strides, a.n_grids, a.vec, a.units = L.n_strides, L.n_grids, L.vec, L.units
    _fill(a.unit_start, [L.unit_start], 4)
    _fill(a.cp, [L.cp], 3)
    _fill(a.line_dims, L.line_dims, MAX_STRIDES)
    _fill(a.row_offsets, L.row_offsets, MAX_STRIDES)
    _fill(a.seg_lx, [L.seg_lx], 3)
    _fill(a.c0, L.c0, MAX_GRIDS + 1)
    _fill(a.col_base, L.col_base, MAX_GRIDS)
    _fill(a.pitch, [L.pitch], MAX_GRIDS)
    return a


def _check(packed, xyz, L: Layout):
    if xyz.device.type != "cuda":
        raise ValueError(f"vm_sample: unsupported device {xyz.device}")
    if xyz.dtype != torch.float32 or xyz.dim() != 2 or xyz.shape[1] != 3 or xyz.stride(1) != 1:
        raise ValueError(f"vm_sample takes f32 xyz [N, 3] with unit column stride, got "
                         f"{xyz.dtype} {tuple(xyz.shape)} strides {xyz.stride()}")
    tabs = list(packed.tables) + [t for lt in packed.line_tables for t in lt]
    dtype = tabs[0].dtype
    if dtype not in DTYPES or any(t.dtype != dtype for t in tabs):
        raise TypeError(f"vm_sample takes f32 or bf16 tables of one dtype, got "
                        f"{sorted({str(t.dtype) for t in tabs})}")
    if any(t.device != xyz.device for t in tabs):
        raise ValueError("vm_sample: the tables and xyz must be on one device")
    if not all(t.is_contiguous() for t in tabs):
        raise ValueError("vm_sample takes contiguous tables")
    if any(t.data_ptr() % (L.vec * t.element_size()) for t in tabs):
        raise ValueError(f"vm_sample reads {L.vec} channels a load: tables must be "
                         f"{L.vec * tabs[0].element_size()}-byte aligned")
    if L.n_strides > MAX_STRIDES or L.n_grids > MAX_GRIDS or L.units > BLOCK:
        raise ValueError(f"vm_sample takes at most {MAX_STRIDES} strides, {MAX_GRIDS} grids "
                         f"and {BLOCK} channel groups a sample, got {L.n_strides}, "
                         f"{L.n_grids}, {L.units}")
    if xyz.shape[0] >= 2 ** 31 * (BLOCK // L.units):
        raise ValueError("vm_sample: too many samples for one launch")


def vm_sample(packed, xyz: torch.Tensor) -> List[torch.Tensor]:
    """`sample_vm_fused(packed, xyz)` on the card in one launch, without a
    gradient: one [N, F_g] f32 tensor per grid, bit for bit the autograd
    path's forward. CUDA tensors only (f32 xyz [N, 3] with unit column
    stride; f32 or bf16 tables of one dtype, contiguous); raises on
    anything else. Each launch adds one to `vm_sample.launches`; N = 0
    launches nothing."""
    L = layout(packed)
    _check(packed, xyz, L)
    N = xyz.shape[0]
    outs = [torch.empty((N, f), dtype=torch.float32, device=xyz.device) for f in L.widths()]
    if N == 0:
        return outs
    tile = BLOCK // L.units
    block = -(-tile * L.units // 32) * 32
    args = _args(L, packed, xyz, outs)
    stream = torch.cuda.current_stream(xyz.device).cuda_stream
    err = _lib().rodynrf_vm_sample(ctypes.byref(args), tile, block, stream)
    if err != 0:
        raise RuntimeError(f"vm_sample kernel launch failed: cudaError_t {err}")
    vm_sample.launches += 1
    return outs


vm_sample.launches = 0


def _lib():
    """The kernel's library, built, loaded and bound on first use."""
    lib = cuda_build.load("vm_sample")
    if getattr(lib, "bound", False):
        return lib
    lib.rodynrf_vm_sample.argtypes = [ctypes.POINTER(VmArgs), ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p]
    lib.rodynrf_vm_sample.restype = ctypes.c_int
    lib.rodynrf_vm_sample_args_bytes.restype = ctypes.c_int
    if lib.rodynrf_vm_sample_args_bytes() != ctypes.sizeof(VmArgs):
        raise RuntimeError("csrc/vm_sample.cu VmArgs and its ctypes mirror differ in size")
    lib.bound = True
    return lib

