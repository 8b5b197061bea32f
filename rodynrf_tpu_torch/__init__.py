"""rodynrf_tpu_torch — the PyTorch + CUDA port of rodynrf_tpu for NVIDIA Hopper.

The module tree and names mirror the JAX package (`core/`, `data/`,
`fields/`, `ops/`, `render/`, `train/`), which stays the reference each
slice of the port is tested against. Plain tensor code is PyTorch; the
two plane-table gradients that the JAX package wrote as Pallas TPU kernels
are CUDA kernels for sm_90a (`csrc/coalesce.cu`, bound in
`ops/coalesced.py`; `csrc/segsum.cu`, bound in `ops/segsum.py`), built on
first use into `build/rodynrf_tpu_torch/`.

Entry points run on the card (`device="cuda"`) unless the caller asks for the
CPU; on CPU tensors every kernel wrapper takes its plain PyTorch version.

Data parallelism over rays (`parallel/`) runs one process per card on
NCCL where the JAX package runs one process over all devices under GSPMD:
`python -m rodynrf_tpu_torch` spawns them, torchrun starts them across
nodes, and the CPU tests run the same code over gloo processes.
"""

import torch

# Camera math (6D-rotation poses, ray generation, NDC) corrupts under
# reduced-precision matmuls; keep float32 products in full float32 on the card.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"
