"""The device's idle share over the traced device stretch (trace.py): 1 -
the union of every device activity's interval (kernels, copies, sets;
overlaps counted once) over the stretch's length, both from the trace,
the stretch running from one idle-device marker kernel to the next."""

UNIT = "%"
LAYER = "device"
MOVES = "render_rays_per_s"
BETTER = "lower"


def read(run):
    st = run.stretch
    if run.kind != "render" or st is None or not st.kernels or st.end <= st.start:
        return None
    return 100.0 * (1.0 - st.busy_s() / (st.end - st.start))
