"""``BENCHMARK.json`` against the benchmark's contract, and the discovery
of cells, configurations, mixes and metrics by name."""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys

import pytest

from h100bench import bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def man():
    return bench.manifest()


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_and_paths(man):
    assert set(man) == TOP
    assert 1 <= len(man["paths"]) <= 16
    for p in man["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
        assert (bench.CHECKOUT / p).is_dir()
    cmd = man["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert all(not w.startswith("/") and ".." not in w for w in cmd)
    assert 1 <= man["run_seconds"] <= 51 and isinstance(man["run_seconds"], int)
    assert len(json.dumps(man)) <= 64 * 1024


def test_names_units_and_keys(man):
    seen = set()
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        assert any(c["file"].startswith(p + "/") for p in man["paths"])
        assert (bench.CHECKOUT / c["file"]).is_file()
        file = bench.read_json(bench.CHECKOUT / c["file"])
        assert file["reduced"] == c["reduced"] and file["source"] == c["source"]
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert w["config"] in {c["name"] for c in man["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in man["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in man["end_to_end"] + man["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        seen.add(m["name"])
    for group in ("configs", "workloads"):
        names = [x["name"] for x in man[group]]
        assert len(names) == len(set(names))
    assert len(seen) == len(man["end_to_end"]) + len(man["per_layer"])


def test_metrics_and_bounds(man):
    cells = {w["name"] for w in man["workloads"]}
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in man["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in man["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert (bench.HERE / "metrics" / f"{m['name']}.py").is_file()
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", cells)
    for cell in cells:
        c = bench.load_cell(cell, man)
        names = {m["name"] for m in c.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert c.per_layer


@pytest.mark.parametrize("cell", [w["name"] for w in bench.manifest()["workloads"]])
def test_each_cell_has_its_files(cell):
    c = bench.load_cell(cell)
    assert c.spec["name"] == cell
    assert (bench.HERE / "drivers" / f"{c.spec['driver']}.py").is_file()
    assert c.traffic["generator"] in ("words", "prompts")
    assert all(v is not None for v in c.spec["limits"].values())


def test_a_new_cell_is_found_by_name(tmp_path):
    """A cell, configuration, mix and metric added as files only."""
    root = tmp_path / "h100bench"
    for d in ("workloads", "configs", "traffic", "metrics"):
        shutil.copytree(bench.HERE / d, root / d)
    man = bench.manifest()
    man["configs"].append({"name": "dummy-config", "source": "x",
                           "file": "h100bench/configs/dummy-config.json",
                           "reduced": [], "why": "x"})
    man["workloads"].append({"name": "dummy-cell", "config": "dummy-config",
                             "traffic": "dummy-mix", "chips": 1, "why": "x"})
    man["end_to_end"][0]["workloads"].append("dummy-cell")
    man["per_layer"].append({"name": "dummy.metric", "unit": "ms",
                             "better": "lower", "source": "host_clock",
                             "layer": "serve",
                             "moves": man["end_to_end"][0]["name"],
                             "workloads": ["dummy-cell"]})
    (root / "configs" / "dummy-config.json").write_text('{"size": 3}')
    (root / "traffic" / "dummy-mix.json").write_text('{"generator": "words"}')
    (root / "workloads" / "dummy-cell.json").write_text(
        '{"name": "dummy-cell", "driver": "sorted_packed", "limits": {}}')
    (root / "metrics" / "dummy.metric.py").write_text(
        "def read(records):\n    return records.get('calls')\n")
    cell = bench.load_cell("dummy-cell", man, root=root)
    assert cell.config == {"size": 3} and cell.traffic["generator"] == "words"
    assert [m["name"] for m in cell.per_layer] == ["dummy.metric"]
    assert {m["name"] for m in cell.end_to_end} == \
        {man["end_to_end"][0]["name"], "setup_s"}
    assert bench.load_metric("dummy.metric", root=root)({"calls": 7}) == 7
    with pytest.raises(KeyError):
        bench.load_cell("no-such-cell", man, root=root)


_PROBE = """
import sys
sys.path[:0] = [{root!r}, {src!r}]
import importlib, pkgutil
import h100bench
for m in pkgutil.walk_packages(h100bench.__path__, "h100bench."):
    if ".tests" not in m.name:
        importlib.import_module(m.name)
{body}
from h100bench.run import forbidden_modules
print(sorted({{m.split('.')[0] for m in sys.modules}} & {{'repro_torch'}}),
      forbidden_modules())
"""


def _probe(body: str = "") -> str:
    code = _PROBE.format(root=str(bench.CHECKOUT),
                         src=str(bench.CHECKOUT / "src"), body=body)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=bench.CHECKOUT)
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_no_module_loads_jax_or_the_reference_package():
    """Importing every module of the harness loads neither the JAX
    package nor ``jax``; the references and traffic load no ``repro_torch``
    either (the harness imports the port only when it runs)."""
    assert _probe() == "[] []"


def test_a_run_on_the_cpu_loads_no_jax():
    """A whole run of a small sort cell on the CPU: the port is loaded,
    ``jax``, ``jaxlib``, ``flax`` and ``repro`` are not (compared by whole
    top-level names)."""
    body = """
import copy, time, torch
from h100bench import bench, run
c = bench.load_cell("ds2x8-oneshot")
c.traffic = dict(c.traffic, words=500, pool=2)
assert run.run_cell(c, 5, 0.05, False, torch.device("cpu"), time.perf_counter())["correct"]
"""
    assert _probe(body) == "['repro_torch'] []"
