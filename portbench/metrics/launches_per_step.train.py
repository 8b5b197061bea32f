"""Device kernel launches a training step, from the profiler over the
traced stretch (copies and sets left out), over its steps: the step
layer, train/step.py."""

UNIT = "launches"
LAYER = "step: train/step.py"
MOVES = "train_rays_per_s"
BETTER = "lower"


def read(run):
    st = run.stretch
    if run.kind != "train" or st is None or st.launches == 0:
        return None
    return st.launches / st.units
