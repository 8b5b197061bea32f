#!/usr/bin/env python3
"""The benchmark of rodynrf_tpu_torch: one run of one cell on one card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout. The cell is portbench/workloads/<cell>.json;
its configuration, traffic mix and per-layer metrics are found by name.
Prints the numbers compared with the plain reference, each beside its
limit, as the last lines of standard error, and one JSON result as the last
line of standard output. Exits non-zero, printing no result, without a CUDA
card, when the program cannot be imported from this checkout, or when JAX or
the JAX package is loaded once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parents[1]


def _fail(msg: str, code: int) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return code


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    # every build and kernel cache inside the checkout, at fixed paths
    build = CHECKOUT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    sys.path.insert(0, str(CHECKOUT))

    import torch

    cell = CHECKOUT / "portbench" / "workloads" / f"{a.workload}.json"
    if not cell.is_file():
        return _fail(f"no cell {a.workload} ({cell})", 2)
    chips = 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        return _fail(f"needs {chips} CUDA card(s); torch sees "
                     f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", 2)
    try:
        import rodynrf_tpu_torch
    except ImportError as e:
        return _fail(f"the program is not in this checkout: {e}", 2)
    if CHECKOUT not in Path(rodynrf_tpu_torch.__file__).resolve().parents:
        return _fail(f"rodynrf_tpu_torch was imported from {rodynrf_tpu_torch.__file__}, "
                     f"outside the checkout {CHECKOUT}", 2)

    from portbench.lib.harness import execute, forbidden_loaded

    result, checks, run = execute(a.workload, a.seed, a.seconds, bool(a.trace), "cuda", T_START)
    bad = forbidden_loaded()
    if bad:
        return _fail(f"forbidden modules loaded: {bad}", 3)
    hm = sorted(run.host_ms)
    if hm:
        print(f"window: {len(hm)} untraced calls, host ms min {hm[0]:.1f} median "
              f"{hm[len(hm) // 2]:.1f} max {hm[-1]:.1f}", file=sys.stderr)
    for name, (value, limit) in checks.items():
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
