"""CPU tests of the benchmark harness (python -m pytest portbench/tests):
tiny copies of the cells, made in a temporary directory, run the whole
harness on the CPU with the program's plain versions."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

BENCH = REPO / "portbench"

# a tiny scene and grid for each published configuration; the limits are
# set from this size's readings (portbench/tests/test_portbench_correct.py
# prints them with -s): the program reads 0 on the loss of step 1 and
# ~1e-3 on the gradient norms (bf16 rounding), the TF32 control ~5e-6 to
# 5e-5 on the loss of step 1, the half-batch fault ~0.1 and up
TINY = {"frames": 4, "height": 24, "width": 32}
TINY_LIMITS = {
    "train": {"loss_gap.1": 1e-6, "loss_gap.2": 0.02, "loss_gap.3": 0.02, "grad_gap": 0.02,
              "change_gap": 0.08},
    "render": {"rgb_gap": 2e-4, "depth_gap": 2e-4, "warp_gap": 2e-4},
}


def make_tiny(root: Path) -> Path:
    """A copy of the benchmark's data files under `root` with a tiny cell
    per published cell: tiny.<config>.<traffic>."""
    for sub in ("configs", "traffic", "workloads", "metrics"):
        shutil.copytree(BENCH / sub, root / sub)
    for path in sorted((BENCH / "workloads").glob("*.json")):
        w = json.loads(path.read_text())
        c = json.loads((BENCH / "configs" / f"{w['config']}.json").read_text())
        name = f"tiny_{w['config']}"
        c["name"] = name
        c["recipe"].update(N_voxel_t=TINY["frames"], batch_size=64)
        accum = 2 if c["micro_batches"] > 1 else 1
        c["run"] = {"dataset_name": "synthetic", "N_voxel_init": 32768, "N_voxel_final": 32768,
                    "grad_accum": accum}
        c["micro_batches"] = accum
        c["scene"] = dict(TINY)
        (root / "configs" / f"{name}.json").write_text(json.dumps(c))
        (root / "workloads" / f"tiny.{w['config']}.{w['traffic']}.json").write_text(json.dumps(
            {"config": name, "traffic": w["traffic"], "why": "tiny",
             "limits": TINY_LIMITS[w["traffic"]]}))
    return root


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    import torch

    torch.set_num_threads(2)
    return make_tiny(tmp_path_factory.mktemp("portbench"))
