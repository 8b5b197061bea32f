"""One process per device: the port's counterpart of the JAX package's one
process over all devices.

`run_ranks(fn, world, device, args)` starts `world` fresh processes (spawn),
joins them in one process group (NCCL on the cards, one card per rank;
gloo on the CPU, one intra-op thread per rank) over a file store in a
temporary directory, calls `fn(rank, *args)` in each, and returns rank 0's
result. A rank that raises makes the call raise. `fn` must be importable in
the child by its module name, so it lives in a module that imports neither
JAX nor a test module that does.

`python -m rodynrf_tpu_torch` trains through it (cli.py); under `torchrun`
every process joins the job's group instead (multihost.global_mesh).
"""

from __future__ import annotations

import datetime
import os
import pickle
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# a rank waits this long in a collective (rank 0's TensorBoard renders hold
# the others in the next step's)
TIMEOUT = datetime.timedelta(minutes=60)


def _entry(rank: int, world: int, device: str, init_method: str, fn, args, out: str):
    if device == "cuda":
        torch.cuda.set_device(rank)
    else:
        torch.set_num_threads(1)
    kw = {"device_id": torch.device("cuda", rank)} if device == "cuda" else {}
    dist.init_process_group("nccl" if device == "cuda" else "gloo", init_method=init_method,
                            rank=rank, world_size=world, timeout=TIMEOUT, **kw)
    try:
        result = fn(rank, *args)
        if rank == 0:
            with open(out, "wb") as f:
                pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def run_ranks(fn, world: int, device: str = "cuda", args=()):
    """fn(rank, *args) on `world` spawned ranks of one process group; rank
    0's return value."""
    if device == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} ranks need {world} cards; "
                           f"{torch.cuda.device_count()} are visible")
    with tempfile.TemporaryDirectory(prefix="rodynrf_ranks_") as tmp:
        out = os.path.join(tmp, "rank0.pkl")
        mp.start_processes(_entry, args=(world, device, f"file://{tmp}/store", fn, tuple(args),
                                         out),
                           nprocs=world, join=True, start_method="spawn")
        with open(out, "rb") as f:
            return pickle.load(f)
