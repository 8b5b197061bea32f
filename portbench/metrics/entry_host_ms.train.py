"""Host milliseconds of one Trainer.run_step call, from the call to its
return (no synchronise), the mean over the run's untraced steps: the
entry layer's time, train/trainer.py."""

UNIT = "ms"
LAYER = "entry: train/trainer.py Trainer.run_step"
MOVES = "train_rays_per_s"
BETTER = "lower"


def read(run):
    if run.kind != "train" or not run.host_ms:
        return None
    return sum(run.host_ms) / len(run.host_ms)
