"""Device kernel launches per 8192-ray chunk of a frame, from the profiler
over the traced frames (copies and sets left out): the renderer layer,
render/renderer.py, render/pipeline.py and fields/."""

UNIT = "launches"
LAYER = "renderer: render/renderer.py, render/pipeline.py, fields/"
MOVES = "render_rays_per_s"
BETTER = "lower"


def read(run):
    st = run.stretch
    if run.kind != "render" or st is None or st.launches == 0:
        return None
    return st.launches / (st.units * run.chunks_per_unit)
