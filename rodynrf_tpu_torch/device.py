"""The device an entry point of the port runs on."""

from __future__ import annotations

import torch


def check_device(device) -> torch.device:
    """The card unless the caller asks for the CPU; RuntimeError, and no
    fallback, when the card is asked for and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run on the CPU")
    return dev
