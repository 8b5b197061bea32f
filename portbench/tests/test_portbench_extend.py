"""A configuration, a traffic mix, a cell and a per-layer metric are added
as new files alone: the harness finds them by name."""

import json
import shutil
import time

from conftest import BENCH


def test_new_files_alone_add_a_cell_and_a_metric(tiny_root, tmp_path):
    from portbench.lib.harness import execute
    from portbench.lib.spec import load_cell

    root = tmp_path / "copy"
    shutil.copytree(tiny_root, root)
    before = {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()}
    cfg = json.loads((root / "configs" / "tiny_davis.json").read_text())
    cfg["name"] = "tiny_dummy"
    cfg["recipe"]["n_lamb_sh"] = [24, 6, 6]
    (root / "configs" / "tiny_dummy.json").write_text(json.dumps(cfg))
    traffic = json.loads((BENCH / "traffic" / "render.json").read_text())
    traffic.update(name="render_dummy", compared_rays_per_frame=64)
    (root / "traffic" / "render_dummy.json").write_text(json.dumps(traffic))
    (root / "workloads" / "tiny_dummy.render_dummy.json").write_text(json.dumps(
        {"config": "tiny_dummy", "traffic": "render_dummy", "why": "dummy",
         "limits": {"rgb_gap": 2e-4}}))
    (root / "metrics" / "frames_seen.render.py").write_text(
        'UNIT = "frames"\nLAYER = "renderer"\nMOVES = "render_rays_per_s"\n'
        'BETTER = "higher"\n\n\ndef read(run):\n    return run.units if run.stretch else None\n')
    after = {p.relative_to(root): p.read_bytes() for p in root.rglob("*") if p.is_file()}
    assert all(after[k] == v for k, v in before.items())  # nothing edited

    cell = load_cell("tiny_dummy.render_dummy", root)
    # the new metric and every existing metric that moves the cell's rate
    render = {p.name[:-3] for p in (BENCH / "metrics").glob("*.render.py")}
    assert set(cell.metrics) == render | {"frames_seen.render"}
    res, checks, _ = execute("tiny_dummy.render_dummy", 7, 0.1, True, "cpu", time.perf_counter(),
                          root=root)
    assert res["correct"], checks
    assert res["metrics"]["frames_seen.render"]["unit"] == "frames"
    # an existing metric reports in the new cell (the others read the card)
    assert res["metrics"]["mfu.render"]["value"] > 0
