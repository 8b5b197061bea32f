"""Joining a multi-process job and feeding it the global batch (port of
rodynrf_tpu/parallel/multihost.py).

The JAX package runs one process per host over all of its devices; the port
runs one process per card. Every process loads the full (small) dataset and
runs the SAME permutation sampler from the same seed, so the global batch is
agreed upon without communication; each rank then keeps its contiguous span
of it for the per-ray work (`process_span`).
"""

from __future__ import annotations

import os
from typing import Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

from .launch import TIMEOUT
from .mesh import make_mesh


def global_mesh(device: str = "cuda"):
    """The 1-D data mesh over every rank of a job started by `torchrun` (or
    anything that sets RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR and
    MASTER_PORT): joins the job's process group (NCCL on the card, gloo on
    the CPU) unless it is up already, and pins this process to its
    LOCAL_RANK's card."""
    if not dist.is_initialized():
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
                   if k not in os.environ]
        if missing:
            raise RuntimeError(f"global_mesh: not started by torchrun ({', '.join(missing)} "
                               "unset)")
        if device == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if device == "cuda" else "gloo",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]), timeout=TIMEOUT)
    return make_mesh(dist.get_world_size(), device=device)


def process_span(n_global: int, rank: Union[int, Sequence[int]], world: int) -> tuple:
    """The [start, end) rows of a length-n_global batch that `rank` holds when
    the batch is split evenly over `world` ranks in rank order. `rank` may be
    the list of ranks one process holds; they must be consecutive, since a
    process feeds one contiguous span. Raises ValueError where the JAX
    package's sharding does: a batch that does not divide `world`, or a
    non-contiguous set of ranks."""
    if n_global % world:
        raise ValueError(f"a batch of {n_global} rows does not split evenly over {world} ranks")
    ranks = sorted([rank] if isinstance(rank, (int, np.integer)) else list(rank))
    if not ranks or ranks[0] < 0 or ranks[-1] >= world:
        raise ValueError(f"ranks {ranks} are not in [0, {world})")
    if ranks != list(range(ranks[0], ranks[0] + len(ranks))):
        raise ValueError(f"process's ranks {ranks} are not contiguous in the global batch; "
                         "multi-process feeding requires a contiguous span")
    n = n_global // world
    return ranks[0] * n, (ranks[-1] + 1) * n


def global_batch_from_local(mesh, global_idx):
    """This rank's span of the global [B] ray-index batch. `global_idx` is
    the full batch every rank computed identically (same sampler, same
    seed)."""
    start, end = process_span(len(global_idx), mesh.get_local_rank(), mesh.size())
    return global_idx[start:end]
