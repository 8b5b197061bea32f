"""The JPEG decoder's kernels: bindings, launches and launch counts.

Four wrappers decode a batch of frames (`data/jpeg.JpegBatch`):

- `jpeg_entropy`: csrc/jpeg_entropy.cu, the Huffman decode of every
  baseline entropy-coded segment into int16 coefficient blocks by the
  self-synchronising parallel decode of csrc/jpeg_huff.cuh, in three
  launches (sync, scan, write), with a status word per segment;
- `jpeg_progressive`: csrc/jpeg_progressive.cu, the progressive frames'
  scans into the same blocks, round after round (`JpegBatch.rounds`: each
  round's scans touch disjoint coefficients and follow every scan they
  share a coefficient with): a round's first scans by the same three
  launches, its DC refinements by one, its AC refinements by one (one warp
  a segment); a status word per segment;
- `jpeg_idct`: csrc/jpeg_idct.cu `idct_kernel`, dequantisation + islow IDCT
  into uint8 component planes, one CTA a run of blocks along a block row
  (`JpegBatch.idct_runs`), in 32 bits where that is exact;
- `jpeg_color`: csrc/jpeg_idct.cu `color_kernel`, fancy upsampling +
  YCbCr -> RGB into the frames' [H, W, 3] uint8 pixels, one CTA an output
  tile (`JpegBatch.color_tiles`).

None has a TPU counterpart (the JAX package decodes through PIL on the
host). A batch on the CPU takes the plain versions of data/jpeg.py; on the
card each call launches its kernels (the library is built at first use by
ops/cuda_build.py) and adds one to its `launches` per kernel launch, or
raises: `jpeg_entropy` launches nothing for a batch without baseline
frames, `jpeg_progressive` nothing for one without progressive frames.
`subseq_bits` (a multiple of 32) is the length of the parallel decode's
subsequences, one decoder each.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..data.jpeg import (SUBSEQ_BITS, JpegBatch, color_plain, entropy_decode_plain, idct_plain,
                         progressive_decode_plain)
from . import cuda_build
from .segsum import current_stream

REC_WORDS, START_WORDS, CTL_WORDS = 10, 4, 8  # csrc/jpeg_huff.cuh
_INT_MAX = 2 ** 31 - 1


def _on_card(batch: JpegBatch, name: str) -> bool:
    dev = batch.data.device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    return True


def _aligned(t: torch.Tensor, name: str) -> int:
    """The pointer of a contiguous tensor that a kernel reads or writes in
    16-byte words; raises on one that is not 16-byte aligned."""
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    return t.data_ptr()


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def _tables(batch: JpegBatch, progressive: bool):
    """The pointers every entropy launch takes: the bytes, the segments,
    their scans and Huffman tables (the baseline or the progressive ones),
    the planes."""
    seg, scan, huff = ((batch.pseg, batch.pscan, batch.phuff) if progressive
                       else (batch.seg, batch.scan, batch.huff))
    return (batch.data.data_ptr(), seg.data_ptr(), scan.data_ptr(), huff.data_ptr(),
            batch.plane_block0.data_ptr(), batch.plane.data_ptr())


def _scratch(n_sub: int, dev):
    """The parallel decode's records (three rounds' worth) and each
    decoder's first block and DC predictors."""
    return (torch.empty(3 * n_sub * REC_WORDS, dtype=torch.int32, device=dev),
            torch.empty(n_sub * START_WORDS, dtype=torch.int32, device=dev))


def jpeg_entropy(batch: JpegBatch, subseq_bits: int = SUBSEQ_BITS):
    """(coef int16 [n_blocks, 64] in natural order, status int32 [segments])."""
    if not _on_card(batch, "jpeg_entropy"):
        return entropy_decode_plain(batch)
    dev = batch.data.device
    coef = torch.zeros((batch.n_blocks, 64), dtype=torch.int16, device=dev)
    nseg = batch.seg.shape[0]
    status = torch.zeros(nseg, dtype=torch.int32, device=dev)
    if nseg == 0:  # progressive frames only
        return coef, status
    tables = batch.subseq_tables(subseq_bits)
    sub0, subseg, host = tables["sub0"], tables["subseg"], tables["host_sub0"]
    n_sub, max_rounds = int(host[-1]), int(np.diff(host).max()) + 1
    rec, start = _scratch(n_sub, dev)
    ctl = torch.zeros(CTL_WORDS, dtype=torch.int32, device=dev)
    first_ev = torch.full((nseg,), _INT_MAX, dtype=torch.int32, device=dev)
    lib, tabs, stream = _lib("jpeg_entropy"), _tables(batch, False), current_stream(dev)
    _check(lib.rodynrf_jpeg_entropy_sync(*tabs, sub0.data_ptr(), subseg.data_ptr(), n_sub,
                                         max_rounds, subseq_bits, rec.data_ptr(), ctl.data_ptr(),
                                         stream), "jpeg_entropy sync")
    jpeg_entropy.launches += 1
    _check(lib.rodynrf_jpeg_entropy_scan(*tabs, sub0.data_ptr(), subseg.data_ptr(), n_sub,
                                         rec.data_ptr(), ctl.data_ptr(), start.data_ptr(),
                                         first_ev.data_ptr(), stream), "jpeg_entropy scan")
    jpeg_entropy.launches += 1
    _check(lib.rodynrf_jpeg_entropy_write(*tabs, sub0.data_ptr(), subseg.data_ptr(), n_sub,
                                          subseq_bits, rec.data_ptr(), ctl.data_ptr(),
                                          start.data_ptr(), first_ev.data_ptr(), coef.data_ptr(),
                                          status.data_ptr(), stream), "jpeg_entropy write")
    jpeg_entropy.launches += 1
    jpeg_entropy.last_ctl = ctl
    return coef, status


jpeg_entropy.launches = 0
jpeg_entropy.last_ctl = None  # the last call's control words: [5] + 1 sync rounds


def jpeg_progressive(coef: torch.Tensor, batch: JpegBatch,
                     subseq_bits: int = SUBSEQ_BITS) -> torch.Tensor:
    """Decode the progressive frames' scans into coef int16 [n_blocks, 64]
    (zeros in their blocks, as jpeg_entropy leaves them) in place, round
    after round on the current stream, so that a refinement scan reads what
    the earlier rounds wrote. Returns the status words int32 [progressive
    segments]."""
    if coef.shape != (batch.n_blocks, 64) or coef.dtype != torch.int16 \
            or not coef.is_contiguous():
        raise ValueError(f"coef must be contiguous int16 [{batch.n_blocks}, 64], got "
                         f"{coef.dtype} {tuple(coef.shape)}")
    if not _on_card(batch, "jpeg_progressive"):
        return progressive_decode_plain(coef, batch)
    dev = batch.data.device
    status = torch.zeros(batch.pseg.shape[0], dtype=torch.int32, device=dev)
    if not batch.rounds:
        return status
    tables = batch.subseq_tables(subseq_bits)
    psub0, psubseg, host = tables["psub0"], tables["psubseg"], tables["host_psub0"]
    firsts = [(s0, nf) for (s0, _), (nf, _, _) in zip(batch.rounds, batch.round_kinds) if nf]
    rec, start = _scratch(max([int(host[s0 + nf] - host[s0]) for s0, nf in firsts] or [0]), dev)
    ctl = torch.zeros((len(batch.rounds), CTL_WORDS), dtype=torch.int32, device=dev)
    first_ev = torch.full((batch.pseg.shape[0],), _INT_MAX, dtype=torch.int32, device=dev)
    lib, tabs, stream = _lib("jpeg_progressive"), _tables(batch, True), current_stream(dev)
    out = (coef.data_ptr(), status.data_ptr())
    for k, ((s0, _), (nf, ndc, nac)) in enumerate(zip(batch.rounds, batch.round_kinds)):
        if nf:
            n_sub = int(host[s0 + nf] - host[s0])
            max_rounds = int(np.diff(host[s0:s0 + nf + 1]).max()) + 1
            c, fe = ctl[k].data_ptr(), first_ev.data_ptr() + 4 * s0
            _check(lib.rodynrf_jpeg_progressive_sync(
                *tabs, s0, psub0.data_ptr(), psubseg.data_ptr(), n_sub, max_rounds,
                subseq_bits, rec.data_ptr(), c, stream), "jpeg_progressive sync")
            jpeg_progressive.launches += 1
            _check(lib.rodynrf_jpeg_progressive_scan(
                *tabs, s0, psub0.data_ptr(), psubseg.data_ptr(), n_sub, rec.data_ptr(), c,
                start.data_ptr(), fe, stream), "jpeg_progressive scan")
            jpeg_progressive.launches += 1
            _check(lib.rodynrf_jpeg_progressive_write(
                *tabs, s0, psub0.data_ptr(), psubseg.data_ptr(), n_sub, subseq_bits,
                rec.data_ptr(), c, start.data_ptr(), fe, *out, stream), "jpeg_progressive write")
            jpeg_progressive.launches += 1
        if ndc:
            _check(lib.rodynrf_jpeg_progressive_dc_refine(*tabs, s0 + nf, ndc, *out, stream),
                   "jpeg_progressive dc_refine")
            jpeg_progressive.launches += 1
        if nac:
            _check(lib.rodynrf_jpeg_progressive_ac_refine(*tabs, s0 + nf + ndc, nac, *out,
                                                          stream), "jpeg_progressive ac_refine")
            jpeg_progressive.launches += 1
    jpeg_progressive.last_ctl = ctl
    return status


jpeg_progressive.launches = 0
jpeg_progressive.last_ctl = None  # per round, as jpeg_entropy.last_ctl


def jpeg_idct(coef: torch.Tensor, batch: JpegBatch) -> torch.Tensor:
    """uint8 [n_plane_bytes]: every component plane's samples. On the card
    `coef` is read in 16-byte words: contiguous and 16-byte aligned, as
    jpeg_entropy returns it."""
    if coef.shape != (batch.n_blocks, 64) or coef.dtype != torch.int16:
        raise ValueError(f"coef must be int16 [{batch.n_blocks}, 64], got {coef.dtype} "
                         f"{tuple(coef.shape)}")
    if not _on_card(batch, "jpeg_idct"):
        return idct_plain(coef, batch)
    dev = batch.data.device
    out = torch.empty(batch.n_plane_bytes, dtype=torch.uint8, device=dev)
    _check(_lib("jpeg_idct").rodynrf_jpeg_idct(
        _aligned(coef, "coef"), batch.idct_runs.shape[0], batch.idct_runs.data_ptr(),
        _aligned(batch.quant, "quant"), out.data_ptr(), current_stream(dev)), "jpeg_idct")
    jpeg_idct.launches += 1
    return out


jpeg_idct.launches = 0


def jpeg_color(planes: torch.Tensor, batch: JpegBatch) -> torch.Tensor:
    """uint8 [n_pixels · 3]: the frames' RGB pixels back to back. On the card
    `planes` is read in 16-byte words: contiguous and 16-byte aligned, as
    jpeg_idct returns it."""
    if planes.shape != (batch.n_plane_bytes,) or planes.dtype != torch.uint8:
        raise ValueError(f"planes must be uint8 [{batch.n_plane_bytes}], got {planes.dtype} "
                         f"{tuple(planes.shape)}")
    if not _on_card(batch, "jpeg_color"):
        return color_plain(planes, batch)
    dev = batch.data.device
    out = torch.empty(batch.n_pixels * 3, dtype=torch.uint8, device=dev)
    _check(_lib("jpeg_idct").rodynrf_jpeg_color(
        _aligned(planes, "planes"), batch.color_tiles.shape[0], batch.color_tiles.data_ptr(),
        out.data_ptr(), current_stream(dev)), "jpeg_color")
    jpeg_color.launches += 1
    return out


jpeg_color.launches = 0


def _lib(name: str) -> ctypes.CDLL:
    """A kernel library, built, loaded and bound on first use."""
    lib = cuda_build.load(name)
    if getattr(lib, "bound", False):
        return lib
    P, I = ctypes.c_void_p, ctypes.c_int
    if name == "jpeg_entropy":
        lib.rodynrf_jpeg_entropy_sync.argtypes = [P] * 8 + [I, I, I, P, P, P]
        lib.rodynrf_jpeg_entropy_scan.argtypes = [P] * 8 + [I, P, P, P, P, P]
        lib.rodynrf_jpeg_entropy_write.argtypes = [P] * 8 + [I, I] + [P] * 7
        for fn in ("sync", "scan", "write"):
            getattr(lib, f"rodynrf_jpeg_entropy_{fn}").restype = I
    elif name == "jpeg_progressive":
        lib.rodynrf_jpeg_progressive_sync.argtypes = [P] * 6 + [I, P, P, I, I, I, P, P, P]
        lib.rodynrf_jpeg_progressive_scan.argtypes = [P] * 6 + [I, P, P, I, P, P, P, P, P]
        lib.rodynrf_jpeg_progressive_write.argtypes = [P] * 6 + [I, P, P, I, I] + [P] * 7
        for fn in ("dc_refine", "ac_refine"):
            getattr(lib, f"rodynrf_jpeg_progressive_{fn}").argtypes = [P] * 6 + [I, I, P, P, P]
        for fn in ("sync", "scan", "write", "dc_refine", "ac_refine"):
            getattr(lib, f"rodynrf_jpeg_progressive_{fn}").restype = I
    else:
        lib.rodynrf_jpeg_idct.argtypes = [P, I, P, P, P, P]
        lib.rodynrf_jpeg_color.argtypes = [P, I, P, P, P]
        for fn in ("idct", "color"):
            getattr(lib, f"rodynrf_jpeg_{fn}").restype = I
    lib.bound = True
    return lib
