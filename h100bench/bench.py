"""The files of the benchmark, found by name, and the measured window.

``load_cell(name)`` reads the cell's entry in ``BENCHMARK.json`` and the
files it names: ``workloads/<cell>.json``, ``configs/<config>.json`` and
``traffic/<traffic>.json``. A driver is the module ``drivers/<driver>.py``;
a per-layer metric the file ``metrics/<metric>.py`` with a ``read(records)``
function. Adding a cell, a configuration, a mix or a metric is adding files
and entries; nothing here names one.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import time
from dataclasses import dataclass, field
from pathlib import Path

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
MANIFEST = CHECKOUT / "BENCHMARK.json"


def read_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def manifest(path: Path = MANIFEST) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return read_json(path)


@dataclass
class Cell:
    """One cell: the manifest's entry, its workload, configuration and
    traffic files, and the metrics it reports."""
    name: str
    entry: dict
    spec: dict
    config: dict
    traffic: dict
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def _for_cell(metric: dict, cell: str, reported: set | None = None) -> bool:
    """Whether ``cell`` reports ``metric``: it is listed in the metric's
    ``workloads``, or, where the metric has none, it reports the metric the
    per-layer one moves (``reported``; every cell for an end-to-end one)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric.get("moves") in reported


def load_cell(name: str, man: dict | None = None, root: Path = HERE) -> Cell:
    man = manifest() if man is None else man
    entries = {w["name"]: w for w in man["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(entries)})")
    entry = entries[name]
    spec = read_json(root / "workloads" / f"{name}.json")
    config = read_json(root / "configs" / f"{entry['config']}.json")
    traffic = read_json(root / "traffic" / f"{entry['traffic']}.json")
    e2e = [m for m in man["end_to_end"] if _for_cell(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in man["per_layer"] if _for_cell(m, name, reported)]
    return Cell(name, entry, spec, config, traffic, e2e, per_layer)


def load_driver(name: str):
    return importlib.import_module(f"h100bench.drivers.{name}")


def load_metric(name: str, root: Path = HERE):
    """The reader of the per-layer metric ``name``: ``metrics/<name>.py``'s
    ``read``, loaded by its path (a metric's name may hold dots)."""
    path = root / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"h100bench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) of ``values``, linear between the
    closest ranks (numpy's default)."""
    xs = sorted(values)
    if not xs:
        raise ValueError("no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


class Spans:
    """The benchmark's own host spans: ``(label, start_ns, end_ns)`` on the
    wall clock the profiler's trace uses (``time.time_ns``). Off, a span
    costs one branch."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.items: list = []

    def add(self, label: str, start_ns: int, end_ns: int):
        if self.enabled:
            self.items.append((label, start_ns, end_ns))


class Window:
    """The measured window: iterate it for unit indices until ``seconds``
    have passed (the unit running at the close finishes). Where ``tracer``
    is given, it traces the first ``tracer.units`` units. ``seconds``
    afterwards holds the window's length."""

    def __init__(self, seconds: float, tracer=None):
        self.limit = seconds
        self.tracer = tracer
        self.start = None
        self.seconds = None
        self.units = 0

    def __iter__(self):
        if self.tracer is not None:
            self.tracer.start()
        self.start = time.perf_counter()
        try:
            while True:
                yield self.units
                self.units += 1
                if self.tracer is not None and \
                        self.units == self.tracer.units:
                    self.tracer.stop()
                if time.perf_counter() - self.start >= self.limit:
                    break
        finally:
            self.seconds = time.perf_counter() - self.start
            if self.tracer is not None:
                self.tracer.stop()
