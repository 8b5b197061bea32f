"""The JPEG decoder's kernels: bindings, launches and launch counts.

Three kernels decode a batch of baseline frames (`data/jpeg.JpegBatch`):

- `jpeg_entropy`: csrc/jpeg_entropy.cu, the Huffman decode of every
  entropy-coded segment into int16 coefficient blocks, one thread per
  segment, with a status word per segment;
- `jpeg_idct`: csrc/jpeg_idct.cu `idct_kernel`, dequantisation + islow IDCT
  into uint8 component planes;
- `jpeg_color`: csrc/jpeg_idct.cu `color_kernel`, fancy upsampling +
  YCbCr -> RGB into the frames' [H, W, 3] uint8 pixels.

None has a TPU counterpart (the JAX package decodes through PIL on the
host). A batch on the CPU takes the plain versions of data/jpeg.py; on the
card each call launches its kernel once (the library is built at first use
by ops/cuda_build.py) and adds one to its `launches`, or raises.
"""

from __future__ import annotations

import ctypes

import torch

from ..data.jpeg import JpegBatch, color_plain, entropy_decode_plain, idct_plain
from . import cuda_build
from .segsum import current_stream


def _on_card(batch: JpegBatch, name: str) -> bool:
    dev = batch.data.device
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    return True


def _check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")


def jpeg_entropy(batch: JpegBatch):
    """(coef int16 [n_blocks, 64] in natural order, status int32 [segments])."""
    if not _on_card(batch, "jpeg_entropy"):
        return entropy_decode_plain(batch)
    dev = batch.data.device
    coef = torch.zeros((batch.n_blocks, 64), dtype=torch.int16, device=dev)
    status = torch.empty(batch.seg.shape[0], dtype=torch.int32, device=dev)
    _check(_lib("jpeg_entropy").rodynrf_jpeg_entropy(
        batch.data.data_ptr(), batch.seg.data_ptr(), batch.seg.shape[0], batch.scan.data_ptr(),
        batch.huff.data_ptr(), batch.plane_block0.data_ptr(), batch.plane.data_ptr(),
        coef.data_ptr(), status.data_ptr(), current_stream(dev)), "jpeg_entropy")
    jpeg_entropy.launches += 1
    return coef, status


jpeg_entropy.launches = 0


def jpeg_idct(coef: torch.Tensor, batch: JpegBatch) -> torch.Tensor:
    """uint8 [n_plane_bytes]: every component plane's samples."""
    if coef.shape != (batch.n_blocks, 64) or coef.dtype != torch.int16:
        raise ValueError(f"coef must be int16 [{batch.n_blocks}, 64], got {coef.dtype} "
                         f"{tuple(coef.shape)}")
    if not _on_card(batch, "jpeg_idct"):
        return idct_plain(coef, batch)
    dev = batch.data.device
    out = torch.empty(batch.n_plane_bytes, dtype=torch.uint8, device=dev)
    _check(_lib("jpeg_idct").rodynrf_jpeg_idct(
        coef.contiguous().data_ptr(), batch.n_blocks, batch.plane_block0.data_ptr(),
        batch.plane.shape[0], batch.plane.data_ptr(), batch.plane_pix0.data_ptr(),
        batch.quant.data_ptr(), out.data_ptr(), current_stream(dev)), "jpeg_idct")
    jpeg_idct.launches += 1
    return out


jpeg_idct.launches = 0


def jpeg_color(planes: torch.Tensor, batch: JpegBatch) -> torch.Tensor:
    """uint8 [n_pixels · 3]: the frames' RGB pixels back to back."""
    if planes.shape != (batch.n_plane_bytes,) or planes.dtype != torch.uint8:
        raise ValueError(f"planes must be uint8 [{batch.n_plane_bytes}], got {planes.dtype} "
                         f"{tuple(planes.shape)}")
    if not _on_card(batch, "jpeg_color"):
        return color_plain(planes, batch)
    dev = batch.data.device
    out = torch.empty(batch.n_pixels * 3, dtype=torch.uint8, device=dev)
    _check(_lib("jpeg_idct").rodynrf_jpeg_color(
        planes.contiguous().data_ptr(), batch.n_pixels, batch.frame_pix0.data_ptr(),
        batch.frame.shape[0], batch.frame.data_ptr(), batch.plane.data_ptr(),
        batch.plane_pix0.data_ptr(), out.data_ptr(), current_stream(dev)), "jpeg_color")
    jpeg_color.launches += 1
    return out


jpeg_color.launches = 0


def _lib(name: str) -> ctypes.CDLL:
    """A kernel library, built, loaded and bound on first use."""
    lib = cuda_build.load(name)
    if getattr(lib, "bound", False):
        return lib
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    if name == "jpeg_entropy":
        lib.rodynrf_jpeg_entropy.argtypes = [P, P, I, P, P, P, P, P, P, P]
        lib.rodynrf_jpeg_entropy.restype = I
    else:
        lib.rodynrf_jpeg_idct.argtypes = [P, LL, P, I, P, P, P, P, P]
        lib.rodynrf_jpeg_idct.restype = I
        lib.rodynrf_jpeg_color.argtypes = [P, LL, P, I, P, P, P, P, P]
        lib.rodynrf_jpeg_color.restype = I
    lib.bound = True
    return lib
