"""The run refuses without a card, outside a checkout of the program, and
never holds JAX or the JAX package."""

import os
import shutil
import subprocess
import sys

from conftest import BENCH, REPO


def _run(cwd, *extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "portbench/run.py", "--workload",
                           "nvidia_no_poses.train_640", "--seed", "3000000007", "--seconds", "1",
                           "--trace", "0", *extra], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_refuses_without_a_card():
    p = _run(REPO)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "CUDA card" in p.stderr


def test_refuses_with_only_the_benchmark_files(tmp_path):
    shutil.copytree(BENCH, tmp_path / "portbench")
    shutil.copy(REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_a_run_holds_no_jax(tiny_root):
    code = f"""
import sys, time
sys.path.insert(0, {str(REPO)!r})
from pathlib import Path
import torch
torch.set_num_threads(2)
from portbench.lib.harness import execute, forbidden_loaded
res, _, _ = execute("tiny.nvidia_no_poses.render", 5, 0.1, False, "cpu", time.perf_counter(),
                 root=Path({str(tiny_root)!r}))
print(forbidden_loaded(), res["correct"])
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[] True"


def test_forbidden_names_compare_whole():
    from portbench.lib.harness import forbidden_loaded

    assert forbidden_loaded(["rodynrf_tpu_torch.train", "jaxtyping", "numpy"]) == []
    assert forbidden_loaded(["rodynrf_tpu.train", "jax.numpy"]) == ["jax", "rodynrf_tpu"]
