"""Import hygiene of the port: importing every module of rodynrf_tpu_torch
(the kernel modules ops/coalesced.py and ops/segsum.py among them), and what
chip_smoke.py imports, loads no JAX and nothing of the JAX package, and
neither builds nor needs nvcc (kernels build on first launch only)."""

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PROBE = r"""
import importlib, json, pkgutil, subprocess, sys
started = []
class NoProcess:
    def __init__(self, *a, **k):
        started.append(a[0] if a else k.get("args"))
        raise RuntimeError("a subprocess was started at import")
subprocess.Popen = NoProcess
import rodynrf_tpu_torch
names = ["rodynrf_tpu_torch"]
for m in pkgutil.walk_packages(rodynrf_tpu_torch.__path__, "rodynrf_tpu_torch."):
    importlib.import_module(m.name)
    names.append(m.name)
import chip_smoke  # its module-level imports; main() is not run
from rodynrf_tpu_torch.ops import cuda_build
bad = sorted(n for n in sys.modules
             if n == "jax" or n.startswith(("jax.", "jaxlib", "rodynrf_tpu."))
             or n == "rodynrf_tpu")
print(json.dumps({"modules": names, "bad": bad, "started": started,
                  "loaded_libs": sorted(cuda_build._loaded)}))
"""


def test_port_imports_no_jax_and_builds_nothing():
    env = dict(os.environ, PATH="/usr/bin:/bin", CUDA_HOME=str(ROOT / "no-cuda-here"))
    env["PYTHONPATH"] = str(ROOT)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    expected = {"rodynrf_tpu_torch.ops.coalesced", "rodynrf_tpu_torch.ops.fused_vm",
                "rodynrf_tpu_torch.ops.segsum", "rodynrf_tpu_torch.train.step",
                "rodynrf_tpu_torch.train.trainer", "rodynrf_tpu_torch.fields.alpha_mask",
                "rodynrf_tpu_torch.ops.compaction", "rodynrf_tpu_torch.preprocess.raft",
                "rodynrf_tpu_torch.preprocess.dpt", "rodynrf_tpu_torch.preprocess.motion_masks",
                "rodynrf_tpu_torch.preprocess.generate_flow",
                "rodynrf_tpu_torch.preprocess.generate_depth",
                "rodynrf_tpu_torch.preprocess.generate_mask", "rodynrf_tpu_torch.data.colmap",
                "rodynrf_tpu_torch.utils.profiling", "rodynrf_tpu_torch.eval.mesh",
                "rodynrf_tpu_torch.eval.lpips", "rodynrf_tpu_torch.core.rays_extra",
                "rodynrf_tpu_torch.parallel.collectives", "rodynrf_tpu_torch.parallel.mesh",
                "rodynrf_tpu_torch.parallel.multihost", "rodynrf_tpu_torch.parallel.sample_shard",
                "rodynrf_tpu_torch.parallel.launch", "rodynrf_tpu_torch.device",
                "rodynrf_tpu_torch.tools.export_alpha", "rodynrf_tpu_torch.tools.quality_run",
                "rodynrf_tpu_torch.tools.quality_full"}
    assert expected <= set(res["modules"])
    assert res["bad"] == []
    assert res["started"] == []
    assert res["loaded_libs"] == []


def test_port_sources_name_no_jax():
    """No source file of the port, nor chip_smoke.py, imports jax or the JAX
    package (a static check beside the runtime one above)."""
    files = sorted((ROOT / "rodynrf_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    for f in files:
        for line in f.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                assert not (mod == "jax" or mod.startswith(("jax.", "jaxlib"))), (f, line)
                assert not (mod == "rodynrf_tpu" or mod.startswith("rodynrf_tpu.")), (f, line)
