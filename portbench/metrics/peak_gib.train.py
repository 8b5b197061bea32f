"""Peak device memory of the window: torch.cuda.max_memory_allocated after
a reset at the window's start, in GiB."""

UNIT = "GiB"
LAYER = "device"
MOVES = "train_rays_per_s"
BETTER = "lower"


def read(run):
    if run.kind != "train" or run.peak_window_bytes <= 0:
        return None
    return run.peak_window_bytes / 2 ** 30
