"""The benchmark's files agree with BENCHMARK.json and with each other."""

import ast
import json
import re

import pytest

from conftest import BENCH, REPO

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "rodynrf_tpu"}


def _metrics():
    from portbench.lib.spec import all_metrics

    return all_metrics()


def load_cell(name):
    from portbench.lib.spec import load_cell

    return load_cell(name)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_workload_names_existing_config_and_traffic(cell):
    w = json.loads((BENCH / "workloads" / f"{cell}.json").read_text())
    entry = next(e for e in SPEC["workloads"] if e["name"] == cell)
    assert (w["config"], w["traffic"]) == (entry["config"], entry["traffic"])
    assert (BENCH / "configs" / f"{w['config']}.json").is_file()
    t = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
    assert t["loop"] in ("train", "render")
    rate = next(m for m in SPEC["end_to_end"] if m["name"] == t["rate_metric"])
    assert t["rate_unit"] == rate["unit"] and cell in rate["workloads"]
    assert w["limits"] and all(v > 0 for v in w["limits"].values())
    assert entry["why"] == w["why"] and len(w["why"]) <= 200


def test_every_metric_file_declares_its_layer_and_moves():
    metrics = _metrics()
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    listed = {m["name"]: m for m in SPEC["per_layer"]}
    assert set(metrics) == set(listed)
    for name, mod in metrics.items():
        entry = listed[name]
        assert (mod.UNIT, mod.LAYER, mod.MOVES, mod.BETTER) == (
            entry["unit"], entry["layer"], entry["moves"], entry["better"]), name
        assert mod.MOVES in e2e
        # the harness reads a metric in every cell that reports the metric it
        # moves, so those are the cells BENCHMARK.json lists for it
        cells = e2e[mod.MOVES].get("workloads", [w["name"] for w in SPEC["workloads"]])
        assert entry["workloads"] == cells, name
        for cell in cells:
            assert name in load_cell(cell).metrics, (name, cell)


def test_names_and_keys_follow_the_contract():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    names = [e["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for e in SPEC[k]]
    assert all(NAME.match(n) for n in names)
    assert len(set(n for n in names)) == len(names)
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for c in SPEC["configs"]:
        assert (REPO / c["file"]).is_file()
        cfg = json.loads((REPO / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"] and cfg["source"] == c["source"]
        changed = {k for k, v in cfg.get("run", {}).items() if cfg["recipe"].get(k) != v}
        assert changed <= set(c["reduced"]), changed


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(p.relative_to(BENCH).as_posix()
                                        for p in BENCH.rglob("*.py")))
def test_no_module_imports_jax_or_the_jax_package(path):
    names = set(_imports(BENCH / path))
    assert not names & FORBIDDEN, names & FORBIDDEN
    if path.startswith("reference/"):
        assert "rodynrf_tpu_torch" not in names
